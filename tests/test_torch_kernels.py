"""Kernel K1 of the PyTorch port (pcr_tpu_torch.engine.kernels), on torch-CPU.

On the CPU the K1 wrapper runs its plain PyTorch version. Its parity with
the JAX package's Pallas kernel is checked on the JAX package's own packed
buffer (TpuEngine.prepare_point, which ladder-pads nsub and carries dead
entries), run through build_sorted_splat_pallas in interpret mode. The two
add the same float32 values in different orders, hence atol = rtol = 1e-5;
cells no live entry reaches must keep their input bits in both.
"""

import os

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port_pkg
from conftest import make_grid_config
from pcr_tpu.engine.tpu_backend import PALLAS_BLOCK, TpuEngine
from pcr_tpu_torch.engine import _build, kernels
from pcr_tpu_torch.engine.torch_backend import (TorchEngine, layout_tiles,
                                                layout_tiles_numpy)
from test_torch_cuda import k1_plan
from test_torch_pipeline import like

RT = ref.ReductionType
TOL = 1e-5


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (TOL + TOL * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


def points(gc, n=3000, seed=0):
    """Cells with ~10% invalid points (off-grid or filtered)."""
    rng = np.random.default_rng(seed)
    col = rng.integers(-20, gc.width + 20, n).astype(np.int32)
    row = rng.integers(-20, gc.height + 20, n).astype(np.int32)
    valid = ((col >= 0) & (col < gc.width) & (row >= 0) & (row < gc.height)
             & (rng.uniform(size=n) > 0.02))
    values = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n)).astype(
        np.float32)
    weights = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return col, row, valid, values, weights


def jax_staged(monkeypatch, gc, rtype, pts):
    """The JAX package's K1 buffer and its Pallas (interpret) update."""
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    spec = ref.ReductionSpec(value_channel="v", type=rtype)
    eng = TpuEngine(gc, [(spec, ref.get_reduction_info(rtype))])
    col, row, valid, values, weights = pts
    (chunk,) = eng.prepare_point(0, None, valid, values, weights,
                                 col=col, row=row)
    kind, _, nsub, block, th, with_f1 = chunk.key
    assert kind == "pallas_point2d" and block == PALLAS_BLOCK
    buf = np.asarray(chunk.buf)
    nseg = 3 + int(with_f1)
    params = buf[: nseg * nsub * block].reshape(nsub, nseg, block)
    bids = buf[nseg * nsub * block:]
    return eng, chunk, params, bids, th, with_f1


@pytest.mark.parametrize("init", ["zeros", "random"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average, RT.Count,
                                   RT.WeightedAverage])
def test_plain_matches_pallas_on_jax_buffer(monkeypatch, rtype, init):
    gc = make_grid_config(w=600.0, h=150.0)   # 2 row blocks x 3 col tiles
    pts = points(gc)
    eng, chunk, params, bids, th, with_f1 = jax_staged(monkeypatch, gc,
                                                       rtype, pts)
    # the buffer carries ladder-pad sub-chunks that extend the last run,
    # and dead entries (icy == -1)
    assert bids[-1] == bids[-2] and (np.diff(bids) >= 0).all()
    assert (params[-1, 1] == -1).all() and (params[:, 1] == -1).any()
    rng = np.random.default_rng(1)
    init_states = [
        (rng.normal(0, 1, s.shape) if init == "random"
         else np.zeros(s.shape)).astype(np.float32)
        for s in eng._states[0]]
    import jax.numpy as jnp
    want = chunk.builder()(tuple(jnp.asarray(s) for s in init_states),
                           chunk.buf)
    got = [torch.from_numpy(s.copy()) for s in init_states]
    kernels.sorted_splat_point(got, torch.from_numpy(params.copy()),
                               torch.from_numpy(bids.copy()), th=th,
                               wt=kernels.col_tile(gc.width), with_f1=with_f1)
    # cells reached by a live entry
    col, row, valid = pts[0], pts[1], pts[2]
    hit = np.zeros(init_states[0].shape, bool)
    hit[row[valid], col[valid]] = True
    for g, w, s0 in zip(got, want, init_states):
        g, w = g.numpy(), np.asarray(w)
        assert_close(g, w)
        assert np.array_equal(g[~hit].view(np.int32), s0[~hit].view(np.int32))
        assert np.array_equal(w[~hit].view(np.int32), s0[~hit].view(np.int32))


def test_port_layout_is_the_jax_layout_without_ladder_padding(monkeypatch):
    gc = make_grid_config(w=600.0, h=150.0)
    pts = points(gc, n=20000)
    _, _, jparams, jbids, _, _ = jax_staged(monkeypatch, gc, RT.Average, pts)
    spec = ref.ReductionSpec(value_channel="v", type=RT.Average)
    port = TorchEngine(like(port_pkg, gc),
                       [(like(port_pkg, spec),
                         port_pkg.get_reduction_info(RT.Average))],
                       torch.device("cpu"))
    col, row, valid, values, weights = pts
    (st,) = port.prepare_point(0, None, valid, values, weights,
                               col=col, row=row)
    nsub = st.params.shape[0]
    assert nsub < len(jbids)
    assert np.array_equal(st.params.numpy(), jparams[:nsub])
    assert np.array_equal(st.bids.numpy(), jbids[:nsub])
    assert (jparams[nsub:, 1] == -1).all() and (jbids[nsub:] == jbids[-1]).all()


def test_native_and_numpy_layouts_agree():
    rng = np.random.default_rng(3)
    n, nblocks = 9000, 12
    eb = rng.integers(0, nblocks, n).astype(np.int32)
    eb[eb == 5] = 4                      # an empty tile
    segs = [(rng.integers(0, 100, n).astype(np.int32), -1),
            (rng.normal(size=n).astype(np.float32), 0)]
    a, na = layout_tiles(eb, nblocks, segs)
    b, nb = layout_tiles_numpy(eb, nblocks, segs)
    assert na == nb and np.array_equal(a, b)


def reference_splat(states, params, bids, th, wt, with_f1):
    """Loop reference of K1's contract in numpy."""
    out = [s.copy() for s in states]
    h_pad, w_pad = out[0].shape
    ncb = w_pad // wt
    for j, bid in enumerate(bids):
        if not 0 <= bid < h_pad // th * ncb:
            continue
        r0, c0 = bid // ncb * th, bid % ncb * wt
        icx, icy = params[j, 0], params[j, 1]
        live = (icx >= c0) & (icx < c0 + wt) & (icy >= r0) & (icy < r0 + th)
        cells = (icy * w_pad + icx)[live]
        np.add.at(out[0].reshape(-1), cells, params[j, 2].view(np.float32)[live])
        if len(out) == 2:
            f1 = (params[j, 3].view(np.float32)[live] if with_f1
                  else np.ones(len(cells), np.float32))
            np.add.at(out[1].reshape(-1), cells, f1)
    return out


@pytest.mark.parametrize("th,wt", [(8, 64), (32, 128), (128, 256)])
@pytest.mark.parametrize("nf,with_f1", [(1, False), (2, False), (2, True)])
def test_plain_matches_contract_at_any_tile(th, wt, nf, with_f1):
    """Out-of-tile entries and runs outside [0, nb_total) drop."""
    rng = np.random.default_rng(th + wt + nf)
    h_pad, w_pad, block = 2 * th, 3 * wt, 64
    nb_total = 6
    bids = np.sort(rng.integers(-1, nb_total + 1, 10)).astype(np.int32)
    bids[0] = -1
    nseg = 3 + int(with_f1)
    params = np.empty((len(bids), nseg, block), np.int32)
    for j, bid in enumerate(bids):
        tile = min(max(bid, 0), nb_total - 1)   # skipped runs aim in-grid
        r0, c0 = tile // 3 * th, tile % 3 * wt
        params[j, 0] = c0 + rng.integers(-2, wt + 2, block)
        params[j, 1] = r0 + rng.integers(-2, th + 2, block)
    params[:, 1, :5] = -1
    params[:, 2:] = rng.normal(size=(len(bids), nseg - 2, block)).astype(
        np.float32).view(np.int32)
    states = [rng.normal(size=(h_pad, w_pad)).astype(np.float32)
              for _ in range(nf)]
    want = reference_splat(states, params, bids, th, wt, with_f1)
    got = [torch.from_numpy(s.copy()) for s in states]
    kernels.sorted_splat_point(got, torch.from_numpy(params),
                               torch.from_numpy(bids), th=th, wt=wt,
                               with_f1=with_f1)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def _k1_inputs():
    states = [torch.zeros(256, 256), torch.zeros(256, 256)]
    params = torch.zeros(2, 3, 2048, dtype=torch.int32)
    bids = torch.zeros(2, dtype=torch.int32)
    return states, params, bids


@pytest.mark.parametrize("bad", [
    "params_dtype", "nseg", "bids_len", "state_dtype", "strided_state",
    "state_shapes", "f1_needs_two_fields", "ragged_tiles", "meta_device"])
def test_wrapper_rejects_bad_inputs(bad):
    states, params, bids = _k1_inputs()
    kw = dict(th=128, wt=256, with_f1=False)
    if bad == "params_dtype":
        params = params.float()
    elif bad == "nseg":
        kw["with_f1"] = True
    elif bad == "bids_len":
        bids = bids[:1]
    elif bad == "state_dtype":
        states = [s.double() for s in states]
    elif bad == "strided_state":
        states = [torch.zeros(256, 512)[:, ::2]] * 2
    elif bad == "state_shapes":
        states = [states[0], torch.zeros(128, 256)]
    elif bad == "f1_needs_two_fields":
        states = states[:1]
        params = torch.zeros(2, 4, 2048, dtype=torch.int32)
        kw["with_f1"] = True
    elif bad == "ragged_tiles":
        kw["th"] = 96
    else:
        states = [s.to("meta") for s in states]
        params, bids = params.to("meta"), bids.to("meta")
    before = kernels.sorted_splat_point.launches
    with pytest.raises(ValueError):
        kernels.sorted_splat_point(states, params, bids, **kw)
    assert kernels.sorted_splat_point.launches == before


def test_cpu_path_never_counts_a_launch():
    states, params, bids = _k1_inputs()
    before = kernels.sorted_splat_point.launches
    kernels.sorted_splat_point(states, params, bids, th=128, wt=256,
                               with_f1=False)
    assert kernels.sorted_splat_point.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolchain is an error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_name_tracks_sources():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$@" >> "$NVCC_LOG"
case "$*" in *bad.cu*) echo "bad.cu: error" >&2; exit 1;; esac
: > "$out"
"""


@pytest.mark.parametrize("broken", [False, True], ids=["ok", "one_fails"])
def test_build_compiles_each_source_then_links(monkeypatch, tmp_path,
                                               broken):
    """One nvcc per source (-c), then one link (-shared); a failed source
    raises with its command and leaves neither objects nor a library."""
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    names = ["a.cu", "b.cu"] + (["bad.cu"] if broken else [])
    for name in names:
        (csrc / name).write_text("// kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("NVCC_LOG", str(tmp_path / "calls"))
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    out = _build.library_path()
    if broken:
        with pytest.raises(RuntimeError, match="bad.cu"):
            _build._compile(out)
    else:
        _build._compile(out)
    calls = (tmp_path / "calls").read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) \
        == sorted(names)
    assert all("sm_90a" in c for c in calls)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == (0 if broken else 1)
    left = sorted(os.listdir(tmp_path / "build"))
    assert not [f for f in left if f.endswith(".o")]
    assert os.path.exists(out) != broken
    assert left == sorted([os.path.basename(out)] * (not broken)
                          + [os.path.basename(out)[:-3] + ".log"])


def plan_bids(pattern, seed=0):
    """Ascending bids: long runs (few tiles), short runs (many tiles), one
    run, and runs with skipped ids (-1 and past nb_total = 40)."""
    rng = np.random.default_rng(seed)
    if pattern == "few_tiles":
        return np.repeat([0, 1], [613, 611]).astype(np.int32)
    if pattern == "many_tiles":
        return np.repeat(np.arange(40), rng.integers(1, 9, 40)).astype(
            np.int32)
    if pattern == "one_run":
        return np.full(97, 3, np.int32)
    return np.sort(rng.integers(-1, 42, 300)).astype(np.int32)


@pytest.mark.parametrize("group", [None, 1, 3, 16])
@pytest.mark.parametrize("pattern", ["few_tiles", "many_tiles", "one_run",
                                     "skipped"])
def test_k1_plan_covers_every_subchunk_once_within_its_run(pattern, group):
    bids = plan_bids(pattern)
    nsub, nb_total = len(bids), 40
    g = group or kernels.k1_group_size(nsub)
    first, end, slot = k1_plan(bids, nb_total, group)
    covered = np.zeros(nsub, int)
    for a, b in zip(first, end):
        covered[a:b] += 1
        assert (bids[a:b] == bids[a]).all()          # never crosses a run
        assert b - a <= g and (a % g == 0 or bids[a - 1] != bids[a])
    live = (bids >= 0) & (bids < nb_total)
    assert np.array_equal(covered, live.astype(int))  # each live one once
    runs = {}
    for a, s in zip(first, slot):
        runs.setdefault(int(bids[a]), []).append(int(s))
    for slots in runs.values():                       # -1 iff a run's only
        assert (slots == [-1]) or (len(slots) > 1 and min(slots) >= 0)
    used = slot[slot >= 0]
    assert len(set(used)) == len(used) and (used < 2 * -(-nsub // g)).all()


def test_k1_plan_depends_on_bids_alone():
    """Two layouts with other entries but the same tile runs give the same
    bids and so the same plan; the group size follows nsub alone."""
    gc = like(port_pkg, make_grid_config(w=300.0, h=300.0))
    spec = port_pkg.ReductionSpec(value_channel="v", type=RT.Sum)
    eng = TorchEngine(gc, [(spec, port_pkg.get_reduction_info(RT.Sum))],
                      torch.device("cpu"))
    counts = [20_000, 15_000, 5_000]             # points per row block
    layouts = []
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        n = sum(counts)
        row = np.repeat([0, 128, 256], counts) + rng.integers(0, 44, n)
        col = rng.integers(0, 256, n)
        (st,) = eng.prepare_point(
            0, None, np.ones(n, bool), rng.normal(size=n).astype(np.float32),
            col=col.astype(np.int32), row=row.astype(np.int32))
        layouts.append(st)
    a, b = layouts
    assert not torch.equal(a.params, b.params)
    assert torch.equal(a.bids, b.bids)
    for x, y in zip(k1_plan(a.bids.numpy(), 6),
                    k1_plan(b.bids.numpy(), 6)):
        assert np.array_equal(x, y)
    assert kernels.k1_group_size(1) == kernels.GROUP_MIN
    assert kernels.k1_group_size(100 * kernels.GROUP_TARGET) == 100


def grouped_splat(states, params, bids, th, wt, with_f1, group):
    """K1's two passes as the kernel runs them, on the CPU: each group sums
    its sub-chunks into the state (a run's only group) or into its zeroed
    scratch slot; then, for each run with more than one group, the block
    where it starts adds its slots in group order."""
    h_pad, w_pad = states[0].shape
    ncb, nsub = w_pad // wt, len(bids)
    nb_total = h_pad // th * ncb
    scratch = np.full((2 * -(-nsub // group), len(states), th, wt), np.nan,
                      np.float32)
    for a, b, slot in zip(*k1_plan(bids, nb_total, group)):
        r0, c0 = bids[a] // ncb * th, bids[a] % ncb * wt
        if slot >= 0:
            scratch[slot] = 0
            tile = [scratch[slot, f] for f in range(len(states))]
        else:
            tile = [s[r0:r0 + th, c0:c0 + wt] for s in states]
        sub = params[a:b].copy()
        sub[:, 0] -= c0
        sub[:, 1] -= r0
        got = reference_splat([t.copy() for t in tile], sub,
                              np.zeros(b - a, np.int32), th, wt, with_f1)
        for t, g in zip(tile, got):
            t[...] = g
    for blk in range(-(-nsub // group)):
        first, last = blk * group, min(blk * group + group, nsub) - 1
        bid = bids[last]
        if (not 0 <= bid < nb_total or last + 1 >= nsub
                or bids[last + 1] != bid
                or (first > 0 and bids[first - 1] == bid)):
            continue
        run_end = np.searchsorted(bids, bid, side="right")
        slots = [2 * blk + int(bids[first] != bid)] + [
            2 * bb for bb in range(blk + 1, (run_end - 1) // group + 1)]
        acc = scratch[slots[0]].copy()
        for s in slots[1:]:
            acc += scratch[s]
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for f, st in enumerate(states):
            st[r0:r0 + th, c0:c0 + wt] += acc[f]
    return states


@pytest.mark.parametrize("group", [1, 2, 5])
@pytest.mark.parametrize("nf,with_f1", [(1, False), (2, False), (2, True)])
def test_k1_grouped_passes_match_the_contract(nf, with_f1, group):
    """The kernel's grouping and merge walk, run on the CPU, give the
    contract's sums (to float32 order) for any group size."""
    rng = np.random.default_rng(nf + group)
    th, wt, block, nb_total = 8, 16, 64, 6
    bids = np.sort(np.r_[rng.integers(0, nb_total, 30), [-1, nb_total]]
                   ).astype(np.int32)
    nseg = 3 + int(with_f1)
    params = np.empty((len(bids), nseg, block), np.int32)
    for j, bid in enumerate(bids):
        tile = min(max(bid, 0), nb_total - 1)
        r0, c0 = tile // 3 * th, tile % 3 * wt
        params[j, 0] = c0 + rng.integers(-2, wt + 2, block)
        params[j, 1] = r0 + rng.integers(-2, th + 2, block)
    params[:, 2:] = rng.normal(size=(len(bids), nseg - 2, block)).astype(
        np.float32).view(np.int32)
    states = [rng.normal(size=(2 * th, 3 * wt)).astype(np.float32)
              for _ in range(nf)]
    want = reference_splat(states, params, bids, th, wt, with_f1)
    got = grouped_splat([s.copy() for s in states], params, bids, th, wt,
                        with_f1, group)
    for g, w in zip(got, want):
        assert_close(g, w)

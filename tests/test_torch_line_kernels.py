"""Kernels K3 (the rect splat of Line runs) and K6 (the rot-expand probe) of
the PyTorch port, on torch-CPU, where each wrapper runs its plain version.

K3: the JAX package's Line layout (TpuEngine.prepare_line under
PCR_PALLAS=interpret, with its ladder-padded nsub and empty-interval
padding) goes through its Pallas builder in interpret mode and through the
port's plain version, on the same bytes; the port's own layout is that
buffer without the ladder padding. Tolerance atol = rtol = 1e-5: the two
add the same float32 terms in different orders. Cells no rectangle reaches
keep their input bits in both.

K6: the plain version against the TPU probe
(benchmarks/profile_rot_expand.py::build, interpret mode) at the probe's
bar, rtol = 1e-4 (its np.allclose) with atol = rot_expand.atol(...).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port_pkg
from conftest import make_grid_config
from pcr_tpu.engine import routing
from pcr_tpu.engine.pallas_kernels import rect_col_tile
from pcr_tpu.engine.tpu_backend import PALLAS_BLOCK, TpuEngine
from pcr_tpu_torch.engine import line_kernels as lk
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from pcr_tpu_torch.probes import rot_expand as k6
from test_torch_pipeline import like

RT = ref.ReductionType
TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    excess = np.abs(got - want) - (TOL + TOL * np.abs(want))
    assert float(excess.max(initial=0.0)) <= 0


def line_inputs(gc, direction, n=3000, seed=0, channels=False):
    """Routed LineParams of n points, some off-grid or filtered, with
    values of mixed signs and magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, gc.width + 5, n)
    y = rng.uniform(-5, gc.height + 5, n)
    col, row, valid = routing.assign(gc, x, y)
    valid &= rng.uniform(size=n) > 0.05
    spec = ref.line_splat_spec("v", default_direction=direction,
                               default_half_length=5.0,
                               max_radius_cells=8.0)
    dirs = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    hls = rng.uniform(0.5, 9.0, n).astype(np.float32)
    lp = routing.line_params(spec.glyph, gc, x, y,
                             dirs if channels else None,
                             hls if channels else None)
    values = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n)).astype(
        np.float32)
    return lp, valid, values, col, row


def engines(monkeypatch, gc, rtype):
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    spec = ref.line_splat_spec("v")
    spec.type = rtype
    plans = [(spec, ref.get_reduction_info(rtype))]
    return TpuEngine(gc, plans), TorchEngine(
        like(port_pkg, gc), [(like(port_pkg, spec),
                              port_pkg.get_reduction_info(rtype))],
        torch.device("cpu"))


def jax_rect(jeng, inp):
    """The JAX package's rect chunk: (chunk, params (nsub, 5, block),
    bids, th)."""
    (chunk,) = jeng.prepare_line(0, *inp)
    kind, _, nsub, block, th = chunk.key
    assert kind == "pallas_rect" and block == PALLAS_BLOCK
    buf = np.asarray(chunk.buf)
    params = buf[: 5 * nsub * block].reshape(nsub, 5, block)
    return chunk, params, buf[5 * nsub * block:], th


def hit_cells(params, bids, shape, th, wt):
    """Cells some live rectangle reaches, cut to its tile (numpy)."""
    hit = np.zeros(shape, bool)
    ncb = shape[1] // wt
    for j, bid in enumerate(bids):
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for ax, bx, ay, by in params[j, :4].T:
            y0, x0 = max(ay, r0), max(ax, c0)
            hit[y0:max(min(by, r0 + th - 1) + 1, y0),
                x0:max(min(bx, c0 + wt - 1) + 1, x0)] = True
    return hit


@pytest.mark.parametrize("init", ["zeros", "random"])
@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average], ids=["nf1", "nf2"])
def test_k3_plain_matches_pallas(monkeypatch, rtype, tile, init):
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    jeng, _ = engines(monkeypatch, gc, rtype)
    chunk, params, bids, th = jax_rect(jeng, line_inputs(gc, 0.7))
    assert (params[:, 0] > params[:, 1]).any()          # padding entries
    rng = np.random.default_rng(1)
    init_states = [
        (rng.normal(0, 1, s.shape) if init == "random"
         else np.zeros(s.shape)).astype(np.float32)
        for s in jeng._states[0]]
    import jax.numpy as jnp
    want = chunk.builder()(tuple(jnp.asarray(s) for s in init_states),
                           chunk.buf)
    got = [torch.from_numpy(s.copy()) for s in init_states]
    wt = rect_col_tile(gc.width)
    lk.rect_splat(got, torch.from_numpy(params.copy()),
                  torch.from_numpy(bids.copy()), th=th, wt=wt)
    hit = hit_cells(params, bids, init_states[0].shape, th, wt)
    assert hit.any()
    for g, w, s0 in zip(got, want, init_states):
        g, w = g.numpy(), np.asarray(w)
        assert_close(g, w)
        assert np.array_equal(g[~hit].view(np.int32), s0[~hit].view(np.int32))
        assert np.array_equal(w[~hit].view(np.int32), s0[~hit].view(np.int32))


@pytest.mark.parametrize("channels", [False, True], ids=["scalar",
                                                         "per_point"])
@pytest.mark.parametrize("direction", [0.0, 0.7])
@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
def test_port_layout_is_the_jax_layout_without_ladder_padding(
        monkeypatch, tile, direction, channels):
    """K3 takes the JAX package's bytes (Sum: f0 is the value in both): the
    same sub-chunks in the same order, less the ladder padding at the end
    and the all-padding sub-chunk the JAX layout gives each empty tile."""
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    jeng, port = engines(monkeypatch, gc, RT.Sum)
    inp = line_inputs(gc, direction, n=6000, channels=channels)
    _, jp, jb, _ = jax_rect(jeng, inp)
    (st,) = port.prepare_line(0, *like(port_pkg, inp))
    assert st.kind == "rect" and st.npoints == len(inp[0].ix0)
    pp, pb = st.params.numpy(), st.bids.numpy()
    keep = np.isin(jb, pb)
    assert (jp[~keep][:, 0] == 1).all() and (jp[~keep][:, 1] == 0).all()
    assert np.array_equal(jb[keep][: len(pb)], pb)
    assert np.array_equal(jp[keep][: len(pb)], pp)
    tail = jp[keep][len(pb):]
    assert (tail[:, 0] == 1).all() and (jb[keep][len(pb):] == pb[-1]).all()


def test_count_layout_adds_one_per_cell(monkeypatch):
    """Count's f0 is 1.0 in every entry, whatever the values (the oracle's
    weight; the JAX rect path stages the value there)."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    _, port = engines(monkeypatch, gc, RT.Count)
    (st,) = port.prepare_line(0, *like(port_pkg, line_inputs(gc, 0.7)))
    p = st.params.numpy()
    live = p[:, 0] <= p[:, 1]
    assert live.any()
    assert (p[:, 4][live].view(np.float32) == 1.0).all()


def reference_rect(states, params, bids, th, wt):
    """Loop reference of K3's contract in numpy, entry by entry."""
    out = [s.copy() for s in states]
    h_pad, w_pad = out[0].shape
    ncb = w_pad // wt
    for j, bid in enumerate(bids):
        if not 0 <= bid < h_pad // th * ncb:
            continue
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for e in range(params.shape[2]):
            ax, bx, ay, by = params[j, :4, e]
            f0 = params[j, 4, e:e + 1].view(np.float32)[0]
            y0, x0 = max(ay, r0), max(ax, c0)
            ys = slice(y0, max(min(by, r0 + th - 1) + 1, y0))
            xs = slice(x0, max(min(bx, c0 + wt - 1) + 1, x0))
            out[0][ys, xs] += f0
            if len(out) == 2:
                out[1][ys, xs] += np.float32(1.0)
    return out


@pytest.mark.parametrize("th,wt", [(8, 64), (32, 128), (128, 256)])
@pytest.mark.parametrize("nf", [1, 2])
def test_plain_matches_contract_at_any_tile(th, wt, nf):
    """Rectangles crossing their tile's edges are cut to it; padding and
    runs outside [0, nb_total) drop."""
    rng = np.random.default_rng(th + wt + nf)
    h_pad, w_pad, block = 2 * th, 3 * wt, 64
    nb_total = 6
    bids = np.sort(rng.integers(-1, nb_total + 1, 10)).astype(np.int32)
    bids[0] = -1
    params = np.empty((len(bids), 5, block), np.int32)
    for j, bid in enumerate(bids):
        tile = min(max(bid, 0), nb_total - 1)   # skipped runs aim in-grid
        r0, c0 = tile // 3 * th, tile % 3 * wt
        ax = c0 + rng.integers(-6, wt + 2, block)
        ay = r0 + rng.integers(-6, th + 2, block)
        horizontal = rng.uniform(size=block) < 0.5
        params[j, 0] = ax
        params[j, 1] = ax + np.where(horizontal, rng.integers(0, 9, block), 0)
        params[j, 2] = ay
        params[j, 3] = ay + np.where(horizontal, 0, rng.integers(0, 9, block))
    params[:, :4, :5] = np.array([1, 0, 1, 0])[:, None]     # padding
    params[:, 4] = rng.normal(size=(len(bids), block)).astype(
        np.float32).view(np.int32)
    states = [rng.normal(size=(h_pad, w_pad)).astype(np.float32)
              for _ in range(nf)]
    want = reference_rect(states, params, bids, th, wt)
    got = [torch.from_numpy(s.copy()) for s in states]
    lk.rect_splat(got, torch.from_numpy(params), torch.from_numpy(bids),
                  th=th, wt=wt)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def test_plain_budget_splits_keep_entry_order(monkeypatch):
    """A budget far below the cells of one launch gives the same bits: the
    chunks follow entry order."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    _, port = engines(monkeypatch, gc, RT.Average)
    (st,) = port.prepare_line(0, *like(port_pkg, line_inputs(gc, 0.7)))
    whole = [torch.zeros_like(s) for s in port._states[0]]
    lk.rect_splat(whole, st.params, st.bids, th=st.th, wt=st.wt)
    monkeypatch.setitem(lk._PLAIN_BUDGET, "cpu", 7)
    split = [torch.zeros_like(s) for s in port._states[0]]
    lk.rect_splat(split, st.params, st.bids, th=st.th, wt=st.wt)
    for a, b in zip(whole, split):
        assert a.any()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_dead_runs_are_skipped(monkeypatch):
    """Runs with bids outside [0, nb_total) change nothing, whatever their
    entries hold."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    _, port = engines(monkeypatch, gc, RT.Average)
    (st,) = port.prepare_line(0, *like(port_pkg, line_inputs(gc, 0.0)))
    nb_total = (port.H_pad // st.th) * (port.W_state // st.wt)
    want = [torch.zeros_like(s) for s in port._states[0]]
    lk.rect_splat(want, st.params, st.bids, th=st.th, wt=st.wt)
    live = st.params[:2]
    params = torch.cat([live, st.params, live]).contiguous()
    bids = torch.cat([torch.full((2,), -1, dtype=torch.int32), st.bids,
                      torch.full((2,), nb_total, dtype=torch.int32)])
    got = [torch.zeros_like(s) for s in port._states[0]]
    lk.rect_splat(got, params, bids, th=st.th, wt=st.wt)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_lines_with_no_run_stage_only_padding(monkeypatch):
    """A cloud whose points are all invalid stages one padding sub-chunk,
    which changes nothing."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    _, port = engines(monkeypatch, gc, RT.Average)
    lp, valid, values, col, row = line_inputs(gc, 0.7, n=50)
    (st,) = port.prepare_line(0, like(port_pkg, lp), np.zeros_like(valid),
                              values, col, row)
    assert st.params.shape[0] == 1
    assert (st.params[0, 0] == 1).all() and (st.params[0, 1] == 0).all()
    port.commit(0, [st])
    assert not any(s.any() for s in port._states[0])


def _k3_inputs():
    states = [torch.zeros(256, 256), torch.zeros(256, 256)]
    params = torch.zeros(2, 5, 2048, dtype=torch.int32)
    params[:, 0] = 1                                   # padding only
    bids = torch.zeros(2, dtype=torch.int32)
    return states, params, bids


@pytest.mark.parametrize("bad", ["params_dtype", "nseg", "bids_len",
                                 "state_dtype", "ragged_tiles", "meta_device"])
def test_k3_wrapper_rejects_bad_inputs(bad):
    states, params, bids = _k3_inputs()
    th = 128
    if bad == "params_dtype":
        params = params.float()
    elif bad == "nseg":
        params = params[:, :-1].contiguous()
    elif bad == "bids_len":
        bids = bids[:1]
    elif bad == "state_dtype":
        states = [s.double() for s in states]
    elif bad == "ragged_tiles":
        th = 96
    else:
        states = [s.to("meta") for s in states]
        params, bids = params.to("meta"), bids.to("meta")
    before = lk.rect_splat.launches
    with pytest.raises(ValueError):
        lk.rect_splat(states, params, bids, th=th, wt=128)
    assert lk.rect_splat.launches == before


def test_k3_cpu_path_never_counts_a_launch():
    states, params, bids = _k3_inputs()
    before = lk.rect_splat.launches
    lk.rect_splat(states, params, bids, th=128, wt=128)
    assert lk.rect_splat.launches == before
    assert not any(s.any() for s in states)


# -- K6 ------------------------------------------------------------------------

def _tpu_probe():
    spec = importlib.util.spec_from_file_location(
        "profile_rot_expand",
        os.path.join(REPO, "benchmarks", "profile_rot_expand.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["jrepeat", "loop"])
@pytest.mark.parametrize("nsub,block,nq", [(2, 256, 3), (3, 128, 9)])
def test_k6_plain_matches_tpu_probe(variant, nsub, block, nq):
    import jax
    params = np.random.default_rng(0).standard_normal((nq, block),
                                                      dtype=np.float32)
    want = np.asarray(jax.jit(_tpu_probe().build(variant, nsub, nq, block,
                                                 True))(params))
    for v in k6.VARIANTS:      # on the CPU every variant is the plain one
        got = k6.rot_expand(torch.from_numpy(params), nsub, v).numpy()
        assert got.shape == want.shape == (1, 128)
        assert np.allclose(got, want, rtol=1e-4,
                           atol=k6.atol(nsub, nq, block))
    assert len(np.unique(want)) <= 4         # one value per lane quarter


@pytest.mark.parametrize("bad", ["variant", "dtype", "ragged_block", "nsub",
                                 "meta_device"])
def test_k6_wrapper_rejects_bad_inputs(bad):
    p, nsub, variant = torch.zeros(3, 256), 2, "smem"
    if bad == "variant":
        variant = "repeat"
    elif bad == "dtype":
        p = p.double()
    elif bad == "ragged_block":
        p = torch.zeros(3, 254)
    elif bad == "nsub":
        nsub = 0
    else:
        p = p.to("meta")
    before = k6.rot_expand.launches
    with pytest.raises(ValueError):
        k6.rot_expand(p, nsub, variant)
    assert k6.rot_expand.launches == before


def test_k6_cli_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = k6.rot_expand.launches
    assert k6.main(["--nsub", "2", "--block", "256", "--nq", "3"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        k6.run(2, 256, 3)
    assert k6.rot_expand.launches == before

"""Kernels K3 (the rect splat of Line runs) and K6 (the rot-expand probe) of
the PyTorch port, on torch-CPU, where each wrapper runs its plain version.

K3: the JAX package's Line layout (TpuEngine.prepare_line under
PCR_PALLAS=interpret, with its ladder-padded nsub and empty-interval
padding) goes through its Pallas builder in interpret mode and through the
port's plain version, on the same bytes. Tolerance atol = rtol = 1e-5: the
two add the same float32 terms in different orders. Cells no rectangle
reaches keep their input bits in both. The port lays Line entries out by
tiles of RECT_BAND_ROWS rows, the band one K3 CTA owns: each band's run is
the 128-row tile run of the JAX layout (and of the port's own layout at a
128-row tile) less the entries that miss the band, in order, and every
cell takes the same terms in the same order.

K6: the plain version against the TPU probe
(benchmarks/profile_rot_expand.py::build, interpret mode) at the probe's
bar, rtol = 1e-4 (its np.allclose) with atol = rot_expand.atol(...).
"""

import importlib.util
import math
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
from pcr_tpu_torch.engine import device_prep, torch_backend
from pcr_tpu_torch.engine import line_kernels as lk
from pcr_tpu_torch.engine.kernels import BLOCK
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


def line_inputs(gc, direction, n=3000, seed=0, channels=False,
                half_length=5.0):
    """Routed LineParams of n points, some off-grid or filtered, with
    values of mixed signs and magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, gc.width + 5, n)
    y = rng.uniform(-5, gc.height + 5, n)
    col, row, valid = routing.assign(gc, x, y)
    valid &= rng.uniform(size=n) > 0.05
    spec = ref.line_splat_spec("v", default_direction=direction,
                               default_half_length=half_length,
                               max_radius_cells=max(8.0, half_length))
    dirs = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    hls = rng.uniform(0.5, 9.0, n).astype(np.float32)
    lp = routing.line_params(spec.glyph, gc, x, y,
                             dirs if channels else None,
                             hls if channels else None)
    values = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n)).astype(
        np.float32)
    return lp, valid, values, col, row


def port_engine(gc, rtype):
    spec = port_pkg.line_splat_spec("v")
    spec.type = rtype
    return TorchEngine(like(port_pkg, gc),
                       [(spec, port_pkg.get_reduction_info(rtype))],
                       torch.device("cpu"))


def engines(monkeypatch, gc, rtype):
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    spec = ref.line_splat_spec("v")
    spec.type = rtype
    plans = [(spec, ref.get_reduction_info(rtype))]
    return TpuEngine(gc, plans), port_engine(gc, rtype)


def jax_rect(jeng, inp):
    """The JAX package's rect chunk: (chunk, params (nsub, 5, block),
    bids, th)."""
    (chunk,) = jeng.prepare_line(0, *inp)
    kind, _, nsub, block, th = chunk.key
    assert kind == "pallas_rect" and block == PALLAS_BLOCK
    buf = np.asarray(chunk.buf)
    params = buf[: 5 * nsub * block].reshape(nsub, 5, block)
    return chunk, params, buf[5 * nsub * block:], th


def band_runs(params, bids, th, wt, ncb, rows):
    """{(row band, col block): live entries (k, 5)} of a K3 layout over
    (th, wt) tiles, each tile's run cut into bands of `rows` rows: the
    entries whose rows meet the band, in run order (numpy)."""
    params, bids = np.asarray(params), np.asarray(bids)
    out = {}
    for bid in np.unique(bids[bids >= 0]):
        p = params[bids == bid].transpose(0, 2, 1).reshape(-1, 5)
        p = p[(p[:, 0] <= p[:, 1]) & (p[:, 2] <= p[:, 3])]
        rb, cb = divmod(int(bid), ncb)
        for lo in range(rb * th, (rb + 1) * th, rows):
            keep = (p[:, 2] <= lo + rows - 1) & (p[:, 3] >= lo)
            if keep.any():
                out[(lo // rows, cb)] = p[keep]
    return out


def assert_same_runs(got, want):
    assert got.keys() == want.keys() and len(got) > 0
    for key, entries in want.items():
        assert np.array_equal(got[key], entries), key


def assert_band_layout(params, bids, th, wt, ncb):
    """Each run of the layout holds only entries that meet its tile, then
    under BLOCK entries of padding (1, 0, 1, 0, 0): no tile runs empty."""
    params, bids = np.asarray(params), np.asarray(bids)
    r0, c0 = (bids // ncb * th)[:, None], (bids % ncb * wt)[:, None]
    live = (params[:, 0] <= params[:, 1]) & (params[:, 2] <= params[:, 3])
    meets = ((params[:, 0] <= c0 + wt - 1) & (params[:, 1] >= c0)
             & (params[:, 2] <= r0 + th - 1) & (params[:, 3] >= r0))
    assert live.any() and (meets | ~live).all()
    for bid in np.unique(bids):
        run = live[bids == bid].reshape(-1)
        k = int(run.sum())
        assert 0 < k and run[:k].all() and len(run) - k < BLOCK
    pad = params.transpose(0, 2, 1)[~live]
    assert (pad == [1, 0, 1, 0, 0]).all()


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


def without_native(monkeypatch, *natives):
    """Put the given packages' native modules on their numpy routes, as if
    no library had been found."""
    for nat in natives:
        monkeypatch.setattr(nat, "_LIB", None)
        monkeypatch.setattr(nat, "_TRIED", True)


@pytest.mark.parametrize("route", ["numpy", "native"])
@pytest.mark.parametrize("channels", [False, True], ids=["scalar",
                                                         "per_point"])
@pytest.mark.parametrize("direction", [0.0, 0.7])
@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
def test_port_layout_is_the_jax_layout_without_ladder_padding(
        monkeypatch, tile, direction, channels, route):
    """K3 takes the JAX package's entries (Sum: f0 is the value in both):
    each of the port's runs, over tiles of RECT_BAND_ROWS rows, is the JAX
    layout's 128-row tile run cut to the band, the entries that miss it
    removed, in the same order; the port pads each run to whole
    sub-chunks and stages no empty tile (the JAX layout adds its ladder
    padding and an all-padding sub-chunk a tile).

    The two routes of the port's routing.line_rects give the same arrays:
    both drop every run the home-tile or grid clip empties. The JAX
    package's native route keeps an empty rectangle (1, 0, 1, 0) for each,
    so the bytes are held against the JAX package's only with both
    packages on their numpy routes, whatever libraries they found; and the
    port's native layout is held against the port's own numpy layout, byte
    for byte, as are the rectangles field by field."""
    from pcr_tpu import native as ref_native
    from pcr_tpu_torch import native as port_native
    from pcr_tpu_torch.engine import routing as port_routing
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    jeng, port = engines(monkeypatch, gc, RT.Sum)
    inp = line_inputs(gc, direction, n=6000, channels=channels)
    pinp = like(port_pkg, inp)

    if route == "native":
        (st,) = port.prepare_line(0, *pinp)     # with whatever was found
        rects = port_routing.line_rects(pinp[0], port.cfg, pinp[1],
                                        *pinp[3:])
        without_native(monkeypatch, port_native)
        (want,) = port.prepare_line(0, *pinp)
        assert st.kind == want.kind == "rect"
        assert (st.th, st.wt, st.npoints) == (want.th, want.wt, want.npoints)
        assert (want.params[:, 0] <= want.params[:, 1]).any()
        assert torch.equal(st.bids, want.bids)
        assert torch.equal(st.params, want.params)
        ref_rects = port_routing.line_rects(pinp[0], port.cfg, pinp[1],
                                            *pinp[3:])
        assert len(ref_rects.owner) > 0
        for name in ("ax", "bx", "ay", "by", "owner"):
            got, ref_arr = getattr(rects, name), getattr(ref_rects, name)
            assert got.dtype == ref_arr.dtype
            assert np.array_equal(got, ref_arr)
        assert (rects.ax <= rects.bx).all() and (rects.ay <= rects.by).all()
        return

    without_native(monkeypatch, ref_native, port_native)
    _, jp, jb, jth = jax_rect(jeng, inp)
    (st,) = port.prepare_line(0, *pinp)
    assert st.kind == "rect" and st.npoints == len(inp[0].ix0)
    assert (jth, st.th) == (128, lk.RECT_BAND_ROWS)
    ncb = port.W_state // st.wt
    pp, pb = st.params.numpy(), st.bids.numpy()
    assert_band_layout(pp, pb, st.th, st.wt, ncb)
    assert_same_runs(band_runs(pp, pb, st.th, st.wt, ncb, st.th),
                     band_runs(jp, jb, jth, st.wt, ncb, st.th))


@pytest.mark.parametrize("route", ["found", "numpy"])
def test_lines_clipped_away_leave_no_entry(monkeypatch, route):
    """Lines whose every run lies outside their home tile stage nothing:
    no rectangle comes back empty, every entry lies in a tile its
    rectangle meets, the layout holds nothing but those and the sub-chunk
    padding, and tile 0's run is no longer than the numpy route's."""
    from pcr_tpu_torch import native as port_native
    from pcr_tpu_torch.engine import routing as port_routing
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    _, port = engines(monkeypatch, gc, RT.Sum)
    lp, valid, values, col, row = like(
        port_pkg, line_inputs(gc, 0.7, n=6000))
    # two lines in three keep their home tile but lie a tile away from it
    away = np.arange(len(col)) % 3 != 0
    for name, shift in (("ix0", 64), ("ix1", 64), ("iy0", 64), ("iy1", 64)):
        arr = getattr(lp, name)
        setattr(lp, name, np.where(away, arr + shift, arr).astype(arr.dtype))
    if route == "numpy":
        without_native(monkeypatch, port_native)
    rects = port_routing.line_rects(lp, port.cfg, valid, col, row)
    assert (rects.ax <= rects.bx).all() and (rects.ay <= rects.by).all()
    assert 0 < len(np.unique(rects.owner)) < valid.sum() / 2
    (st,) = port.prepare_line(0, lp, valid, values, col, row)
    without_native(monkeypatch, port_native)
    (want,) = port.prepare_line(0, lp, valid, values, col, row)
    assert (st.bids == 0).sum() <= (want.bids == 0).sum()
    p, b = st.params.numpy(), st.bids.numpy()
    ncb = port.W_state // st.wt
    th = st.th
    r0, c0 = (b // ncb * th)[:, None], (b % ncb * st.wt)[:, None]
    live = p[:, 0] <= p[:, 1]
    meets = ((p[:, 0] <= c0 + st.wt - 1) & (p[:, 1] >= c0)
             & (p[:, 2] <= r0 + th - 1) & (p[:, 3] >= r0))
    assert live.any() and (meets | ~live).all()
    # what is not live is sub-chunk padding: under BLOCK entries a tile
    per_tile = np.bincount(b, weights=live.sum(1), minlength=b.max() + 1)
    subs = np.bincount(b, minlength=b.max() + 1)
    assert ((subs * BLOCK - per_tile < BLOCK) | (subs == 0)).all()
    pad = p.transpose(0, 2, 1)[~live]
    assert (pad[:, :4] == [1, 0, 1, 0]).all()


HEADINGS = {"0": 0.0, "pi6": math.pi / 6, "0.7": 0.7, "pi2": math.pi / 2,
            "2.5": 2.5}


def band_and_tall(monkeypatch, gc, heading, route):
    """One cloud of Lines of half length 16 (Sum) staged by `route` as the
    port lays it out, over tiles of RECT_BAND_ROWS rows, and over 128-row
    tiles (the layout K3 took before its bands became tiles). Returns
    (engine, band chunk, 128-row chunk)."""
    port = port_engine(gc, RT.Sum)
    inp = like(port_pkg, line_inputs(gc, heading, half_length=16.0))
    expanded = []
    real = device_prep.line_runs_device
    monkeypatch.setattr(device_prep, "line_runs_device",
                        lambda *a, **k: expanded.append(1) or real(*a, **k))
    cheap = route == "device"
    (band,) = port.prepare_line(0, *inp, wire_cheap=cheap)
    monkeypatch.setattr(torch_backend, "RECT_BAND_ROWS", 128)
    (tall,) = port.prepare_line(0, *inp, wire_cheap=cheap)
    assert bool(expanded) == cheap
    return port, band, tall


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("heading", list(HEADINGS.values()),
                         ids=list(HEADINGS))
def test_band_layout_is_the_tall_layout_cut_into_bands(monkeypatch, heading,
                                                       tile, route):
    """Every entry's rectangle meets the band its bid names; each band's
    run is the 128-row tile's run less the entries that miss the band, in
    order; so the plain version gives the same bits on either, with one
    field or two, from a random state."""
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    port, band, tall = band_and_tall(monkeypatch, gc, heading, route)
    assert (band.th, tall.th, band.wt) == (lk.RECT_BAND_ROWS, 128, tall.wt)
    assert lk.rect_plan(band.th, band.wt).slices == 1
    ncb = port.W_state // band.wt
    bp, bb = band.params.numpy(), band.bids.numpy()
    assert_band_layout(bp, bb, band.th, band.wt, ncb)
    assert_same_runs(band_runs(bp, bb, band.th, band.wt, ncb, band.th),
                     band_runs(tall.params.numpy(), tall.bids.numpy(), 128,
                               band.wt, ncb, band.th))
    rng = np.random.default_rng(7)
    init = [torch.from_numpy(rng.normal(size=(port.H_pad, port.W_state))
                             .astype(np.float32)) for _ in range(2)]
    for nf in (1, 2):
        got, want = ([s.clone() for s in init[:nf]] for _ in range(2))
        lk.rect_splat_plain(got, band.params, band.bids, th=band.th,
                            wt=band.wt)
        lk.rect_splat_plain(want, tall.params, tall.bids, th=tall.th,
                            wt=tall.wt)
        for g, w, s0 in zip(got, want, init):
            assert not torch.equal(g, s0)
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("heading", [0.3, math.pi / 2],
                         ids=["x_major", "y_major"])
def test_line_chunks_stay_inside_the_entry_budget(monkeypatch, heading,
                                                  route):
    """_line_ranges follows each run's axis: an x-major line's runs are
    one row and span column tiles, a y-major line's one column (33 rows
    here, up to three bands) and span row tiles. No chunk of either stages
    more entries than tiling.WIRE_ENTRY_BUDGET."""
    budget = 4000
    monkeypatch.setattr(torch_backend, "WIRE_ENTRY_BUDGET", budget)
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    port = port_engine(gc, RT.Sum)
    inp = like(port_pkg, line_inputs(gc, heading, half_length=16.0))
    chunks = port.prepare_line(0, *inp, wire_cheap=route == "device")
    assert len(chunks) > 2
    assert sum(c.npoints for c in chunks) == len(inp[0].ix0)
    for c in chunks:
        p = c.params.numpy()
        live = int(((p[:, 0] <= p[:, 1]) & (p[:, 2] <= p[:, 3])).sum())
        assert 0 < live <= budget


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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th,wt,nf", [(16, 128, 2), (32, 256, 1),
                                      (128, 64, 2), (20, 192, 2)])
def test_plain_slice_by_slice_gives_the_same_bits(th, wt, nf, seed):
    """What the card's kernel rests on: a cell takes its terms in entry
    order whoever owns it, so folding each entry's part in one 8-row x
    128-column slice of its tile at a time, the slices in any order, gives
    the bits of one call (mixed-sign values on a random initial state)."""
    rng = np.random.default_rng(1000 * seed + th + wt + nf)
    h_pad, w_pad, block = 2 * th, 2 * wt, 96
    bids = np.sort(rng.integers(0, 4, 9)).astype(np.int32)
    r0, c0 = (bids // 2 * th)[:, None], (bids % 2 * wt)[:, None]
    ax = c0 + rng.integers(-6, wt + 2, (len(bids), block))
    ay = r0 + rng.integers(-6, th + 2, (len(bids), block))
    horizontal = rng.uniform(size=ax.shape) < 0.5
    long = rng.integers(0, 40, ax.shape)
    params = np.stack([ax, ax + np.where(horizontal, long, 0), ay,
                       ay + np.where(horizontal, 0, long),
                       (rng.normal(size=ax.shape)
                        * 10.0 ** rng.integers(-3, 4, ax.shape)).astype(
                            np.float32).view(np.int32)], 1).astype(np.int32)
    params[:, :4, :3] = np.array([1, 0, 1, 0])[:, None]          # padding
    states = [rng.normal(size=(h_pad, w_pad)).astype(np.float32)
              for _ in range(nf)]
    whole = [torch.from_numpy(s.copy()) for s in states]
    lk.rect_splat_plain(whole, torch.from_numpy(params),
                        torch.from_numpy(bids), th=th, wt=wt)
    sliced = [torch.from_numpy(s.copy()) for s in states]
    slices = [(i, k) for i in range(-(-th // 8)) for k in range(-(-wt // 128))]
    for n in rng.permutation(len(slices)):
        i, k = slices[n]
        cut = params.copy()
        cut[:, 0] = np.maximum(params[:, 0], c0 + 128 * k)
        cut[:, 1] = np.minimum(params[:, 1], c0 + 128 * k + 127)
        cut[:, 2] = np.maximum(params[:, 2], r0 + 8 * i)
        cut[:, 3] = np.minimum(params[:, 3], r0 + 8 * i + 7)
        lk.rect_splat_plain(sliced, torch.from_numpy(cut),
                            torch.from_numpy(bids), th=th, wt=wt)
    for a, b, s0 in zip(whole, sliced, states):
        assert not torch.equal(a, torch.from_numpy(s0))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


@pytest.mark.parametrize("th,wt,slices", [(128, 128, 16), (128, 64, 16),
                                          (128, 256, 32), (24, 192, 6),
                                          (5, 300, 3), (8, 128, 1)])
def test_rect_plan_takes_any_tile(th, wt, slices):
    """One CTA of 128 threads a band of 8 rows x 128 columns, ragged bands
    included: one a tile of the Line layout; 512 entries, four a thread,
    staged at a time."""
    assert (lk.RECT_BAND_ROWS, lk.RECT_PIECE) == (8, 512)
    plan = lk.rect_plan(th, wt)
    assert plan.slices == slices and plan.grid(7) == (7, slices)
    assert plan.threads == 128 and plan.smem_bytes == 9 * 4 * 512
    with pytest.raises(ValueError):
        lk.rect_plan(0, 128)


@pytest.mark.parametrize("th,wt", [(lk.RECT_BAND_ROWS, 128), (8, 64),
                                   (128, 128), (24, 192)])
def test_rect_staged_counts_each_run_once_a_band(th, wt):
    """rect_staged against a loop over the runs: each run on the grid is
    staged whole, padding included, by every band of its tile; a run
    outside [0, nb_total) by none."""
    nb_total = 5
    bids = np.sort(np.random.default_rng(th + wt).integers(
        -1, nb_total + 2, 40)).astype(np.int32)
    bands = -(-th // lk.RECT_BAND_ROWS) * -(-wt // 128)
    want = 0
    for bid in np.unique(bids):
        if 0 <= bid < nb_total:
            want += int((bids == bid).sum()) * BLOCK * bands
    assert want > 0
    got = lk.rect_staged(torch.from_numpy(bids), th, wt, nb_total)
    assert int(got) == want


@pytest.mark.parametrize("th,wt", [(128, 128), (24, 192)])
def test_rect_walk_counts_match_a_loop(th, wt):
    """Records: the bands of RECT_BAND_ROWS rows x 128 columns an entry's
    rectangle meets inside its tile; hits: its rows there times the
    32-column blocks it meets."""
    rng = np.random.default_rng(th + wt)
    block, ncb, nb_total = 48, 2, 4
    bids = np.sort(rng.integers(-1, nb_total + 1, 8)).astype(np.int32)
    tile = np.clip(bids, 0, nb_total - 1)
    r0, c0 = (tile // ncb * th)[:, None], (tile % ncb * wt)[:, None]
    ax = c0 + rng.integers(-6, wt + 2, (len(bids), block))
    ay = r0 + rng.integers(-6, th + 2, (len(bids), block))
    horizontal = rng.uniform(size=ax.shape) < 0.5
    long = rng.integers(0, 70, ax.shape)
    params = np.stack([ax, ax + np.where(horizontal, long, 0), ay,
                       ay + np.where(horizontal, 0, long),
                       np.zeros_like(ax)], 1).astype(np.int32)
    params[:, :4, :3] = np.array([1, 0, 1, 0])[:, None]
    records = hits = 0
    for j, bid in enumerate(bids):
        if not 0 <= bid < nb_total:
            continue
        for x0, x1, y0, y1 in params[j, :4].T:
            cj, rj = c0[j, 0], r0[j, 0]
            x0, x1 = max(x0, cj) - cj, min(x1, cj + wt - 1) - cj
            y0, y1 = max(y0, rj) - rj, min(y1, rj + th - 1) - rj
            if x0 > x1 or y0 > y1:
                continue
            band = lk.RECT_BAND_ROWS
            records += ((y1 // band - y0 // band + 1)
                        * (x1 // 128 - x0 // 128 + 1))
            hits += (y1 - y0 + 1) * (x1 // 32 - x0 // 32 + 1)
    assert records > 0
    assert lk.rect_walk_counts(torch.from_numpy(params),
                               torch.from_numpy(bids), th, wt, ncb,
                               nb_total) == (records, hits)


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


@pytest.mark.parametrize("nsub,nq,block,split,chain", [
    (64, 9, 2048, 2, 72),       # the defaults: two CTAs a step
    (1, 9, 2048, 8, 18),        # few steps: eight CTAs share one
    (700, 2, 4, 1, 2),          # more steps than SMs, one g
    (5, 7, 2044, 8, 14),        # ragged shares
])
def test_k6_plan(nsub, nq, block, split, chain):
    """The launch's split of a step's g's over CTAs, and the longest chain
    of dependent adds it leaves a thread."""
    assert k6.split_of(nsub, block) == split
    assert k6.longest_chain(nsub, nq, block) == chain


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

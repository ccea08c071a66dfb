"""Kernels K2, K4 and K5 of the PyTorch port (pcr_tpu_torch.engine.
gauss_kernels), on torch-CPU, where each wrapper runs its plain version.

The JAX package's Gaussian layouts (TpuEngine.prepare_gaussian, with its
ladder-padded nsub and dead entries) go through its Pallas builders in
interpret mode and through the port:

  * K2 and K4 on the JAX package's own packed buffer, which is also the
    port's layout without the ladder padding;
  * K5 on each package's own layout (the TPU's quad-major wire is not
    carried over), so only the results are compared.

K4's and K5's first two planes differ: the JAX package carries the
centre offset -(icx + sub_cx), -(icy + sub_cy), rounded at the cell's
absolute coordinate, the port the sub-cell offsets sub_cx, sub_cy (the
kernels form (w - icx) - sub_cx, as the oracle does). The layout twin holds
the identity between them; a JAX K4 buffer goes through the port's K4 with
those planes in the port's form (`as_port_k4`), every other plane as it
is.

Tolerance atol = rtol = 1e-5 on the raw state sums: the two add the same
float32 terms in different orders (and K4/K5 round the distance to the
centre and the completed square in another order, which moves a term by
~1e-6 relative at these coordinates). The footprint (cells that received
any weight) must be the same.
"""

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port_pkg
from conftest import make_grid_config
from pcr_tpu.engine import routing
from pcr_tpu.engine.tpu_backend import PALLAS_BLOCK, TpuEngine
from pcr_tpu_torch.engine import gauss_kernels as gk
from pcr_tpu_torch.engine.gauss_kernels import GaussGeom
from pcr_tpu_torch.engine.torch_backend import (TorchEngine, halo_copies,
                                                layout_tiles,
                                                layout_tiles_numpy)
from pcr_tpu_torch.ops.reduction import gauss_state_flush
from test_torch_pipeline import like

RT = ref.ReductionType
TOL = 1e-5
GLYPHS = {
    "s4": dict(default_sigma=4.0),                       # K2
    "s1": dict(default_sigma=1.0),                       # K2 + cutoff
    "rot8": dict(default_sigma_x=8.0, default_sigma_y=3.0,
                 default_rotation=0.6),                   # K4 (r = 24)
    "rot4": dict(default_sigma_x=4.0, default_sigma_y=1.5,
                 default_rotation=0.6),                   # K5 (r = 12)
}
ROUTE = {"s4": "pallas_gauss2d", "s1": "pallas_gauss2d", "rot8": "pallas_rot2",
         "rot4": "pallas_rotp"}
NSEG = {"pallas_gauss2d": 8, "pallas_rot2": 9}


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(got == 0, want == 0)          # the footprint
    excess = np.abs(got - want) - (TOL + TOL * np.abs(want))
    assert float(excess.max(initial=0.0)) <= 0


def spec_of(glyph, rtype):
    s = ref.gaussian_splat_spec("v", **GLYPHS[glyph])
    s.type = rtype
    return s


def inputs(gc, spec, n=1500, seed=0):
    """Routed Gaussian params of n points, some off-grid or filtered."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, gc.width + 5, n)
    y = rng.uniform(-5, gc.height + 5, n)
    _, _, valid = routing.assign(gc, x, y)
    valid &= rng.uniform(size=n) > 0.05
    gp = routing.gaussian_params(spec.glyph, gc, x, y, None, None, None)
    values = rng.uniform(0, 10, n).astype(np.float32)
    return gp, valid, values


def engines(monkeypatch, gc, spec):
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    plans = [(spec, ref.get_reduction_info(spec.type))]
    return TpuEngine(gc, plans), TorchEngine(
        like(port_pkg, gc), [(like(port_pkg, spec),
                              port_pkg.get_reduction_info(spec.type))],
        torch.device("cpu"))


def jax_chunk(jeng, glyph, inp):
    (chunk,) = jeng.prepare_gaussian(0, *inp)
    assert chunk.key[0] == ROUTE[glyph]
    return chunk


def jax_params(chunk):
    """(params (nsub, nseg, block), bids) of a K2 or K4 JAX buffer."""
    nseg = NSEG[chunk.key[0]]
    nsub, block = chunk.key[2], chunk.key[3]
    buf = np.asarray(chunk.buf)
    params = buf[: nseg * nsub * block].reshape(nsub, nseg, block)
    if chunk.key[0] == "pallas_rot2":
        params = params.view(np.float32)
    return params, buf[nseg * nsub * block:]


def as_port_k4(jp, jb, pp, pb):
    """A JAX K4 buffer (jp, jb) with planes 0 and 1 in the port's form:
    the sub-cell offsets, from the port's layout (pp, pb) of the same
    points, which is the JAX layout less its padding
    (test_port_layout_is_the_jax_layout_without_ladder_padding); padding
    takes the port's fill, 0. Checks the identity JAX plane ==
    float32(-(ic + sub)) on the way."""
    rows = np.flatnonzero(np.isin(jb, pb))[: len(pb)]
    assert np.array_equal(jb[rows], pb)
    assert np.array_equal(jp[rows, 2:].view(np.int32),
                          pp[:, 2:].view(np.int32))
    assert np.array_equal(jp[rows, :2], -(pp[:, 6:8] + pp[:, :2]))
    out = jp.copy()
    out[:, :2] = 0.0
    out[rows, :2] = pp[:, :2]
    return out


def run_jax(chunk, states):
    import jax.numpy as jnp
    out = chunk.builder()(tuple(jnp.asarray(s) for s in states), chunk.buf)
    return [np.asarray(o) for o in out]


def zero_states(eng):
    return [np.zeros(s.shape, np.float32) for s in eng._states[0]]


@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average], ids=["nf1", "nf2"])
@pytest.mark.parametrize("glyph", ["s4", "s1"], ids=["plain", "corr"])
def test_k2_plain_matches_pallas(monkeypatch, glyph, rtype, tile):
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    spec = spec_of(glyph, rtype)
    jeng, _ = engines(monkeypatch, gc, spec)
    chunk = jax_chunk(jeng, glyph, inputs(gc, spec))
    _, _, _, block, th, wt, corr = chunk.key
    assert bool(corr) == (glyph == "s1") and block == PALLAS_BLOCK
    params, bids = jax_params(chunk)
    assert (params[-1, 6] == -1).all()               # ladder pad: dead
    want = run_jax(chunk, zero_states(jeng))
    got = [torch.from_numpy(s) for s in zero_states(jeng)]
    gk.sorted_splat_gauss(got, torch.from_numpy(params.copy()),
                          torch.from_numpy(bids.copy()), th=th, wt=wt,
                          cut=bool(corr), geom=GaussGeom.of(gc))
    for g, w in zip(got, want):
        assert w.any()
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("rtype", [RT.Count, RT.Average], ids=["nf1", "nf2"])
def test_k4_plain_matches_pallas(monkeypatch, rtype, tile):
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    spec = spec_of("rot8", rtype)
    jeng, port = engines(monkeypatch, gc, spec)
    inp = inputs(gc, spec, n=600)
    chunk = jax_chunk(jeng, "rot8", inp)
    params, bids = jax_params(chunk)
    (st,) = port.prepare_gaussian(0, *like(port_pkg, inp))
    params = as_port_k4(params, bids, st.params.numpy(), st.bids.numpy())
    want = run_jax(chunk, zero_states(jeng))
    got = [torch.from_numpy(s) for s in zero_states(jeng)]
    gk.rot_splat_dense(got, torch.from_numpy(params),
                       torch.from_numpy(bids.copy()), th=chunk.key[4],
                       wt=128, geom=GaussGeom.of(gc))
    for g, w in zip(got, want):
        assert w.any()
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.WeightedAverage],
                         ids=["nf1", "nf2"])
def test_k5_plain_matches_pallas(monkeypatch, rtype, tile):
    """Each package on its own layout; the results agree."""
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    spec = spec_of("rot4", rtype)
    jeng, port = engines(monkeypatch, gc, spec)
    inp = inputs(gc, spec)
    want = run_jax(jax_chunk(jeng, "rot4", inp), zero_states(jeng))
    (st,) = port.prepare_gaussian(0, *like(port_pkg, inp))
    assert st.kind == "rotp" and st.params.dtype == torch.float32
    port.commit(0, [st])
    for g, w in zip(port._states[0], want):
        assert w.any()
        assert_close(g.numpy(), w)


def port_chunk(monkeypatch, glyph, gc=None):
    gc = gc or make_grid_config(w=200.0, h=150.0, tile=64)
    spec = spec_of(glyph, RT.Average)
    jeng, port = engines(monkeypatch, gc, spec)
    inp = inputs(gc, spec)
    (st,) = port.prepare_gaussian(0, *like(port_pkg, inp))
    return jeng, port, inp, st


def splat(port, st, states, params, bids):
    kw = dict(th=st.th, wt=st.wt)
    if st.kind == "gauss":
        gk.sorted_splat_gauss(states, params, bids, cut=st.cut,
                              geom=port.geom, **kw)
    elif st.kind == "rot":
        gk.rot_splat_dense(states, params, bids, geom=port.geom, **kw)
    else:
        gk.rot_splat_packed(states, params, bids, **kw)


@pytest.mark.parametrize("glyph", ["s1", "rot8", "rot4"])
def test_dead_runs_are_skipped(monkeypatch, glyph):
    """Runs with bids outside [0, nb_total) change nothing, whatever
    their entries hold."""
    _, port, _, st = port_chunk(monkeypatch, glyph)
    nb_total = (port.H_pad // st.th) * (port.W_state // st.wt)
    want = [torch.zeros_like(s) for s in port._states[0]]
    splat(port, st, want, st.params, st.bids)
    live = st.params[:2]
    params = torch.cat([live, st.params, live])
    bids = torch.cat([torch.full((2,), -1, dtype=torch.int32), st.bids,
                      torch.full((2,), nb_total, dtype=torch.int32)])
    got = [torch.zeros_like(s) for s in port._states[0]]
    splat(port, st, got, params.contiguous(), bids)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("glyph", ["s4", "s1", "rot8"])
def test_port_layout_is_the_jax_layout_without_ladder_padding(monkeypatch,
                                                              glyph):
    """K2 / K4 take the JAX package's bytes: the same sub-chunks in the
    same order, less the ladder padding at the end and the one all-dead
    sub-chunk the JAX layout gives each empty tile. K4's planes 0 and 1
    are the sub-cell offsets where the JAX package has -(ic + sub), the
    identity float32(-(ic + sub)) == JAX's plane holding entry by entry;
    every other plane is the JAX package's bit for bit."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    jeng, port, inp, st = port_chunk(monkeypatch, glyph, gc)
    jp, jb = jax_params(jax_chunk(jeng, glyph, inp))
    pp, pb = st.params.numpy(), st.bids.numpy()
    if glyph == "rot8":
        pp = pp.view(np.float32)
    dead = -1 if glyph != "rot8" else np.float32(-1)
    r_seg = 6 if glyph != "rot8" else 8
    keep = np.isin(jb, pb)
    assert (jp[~keep][:, r_seg] == dead).all()         # empty tiles' fill
    assert np.array_equal(jb[keep][: len(pb)], pb)
    if glyph == "rot8":
        as_port_k4(jp, jb, pp, pb)
    else:
        assert np.array_equal(jp[keep][: len(pb)].view(np.int32),
                              pp.view(np.int32))
    tail = jp[keep][len(pb):]
    assert (tail[:, r_seg] == dead).all() and (jb[keep][len(pb):]
                                                == pb[-1]).all()


def test_native_and_numpy_layouts_agree_with_halo_copies():
    rng = np.random.default_rng(3)
    n, ncb = 4000, 4
    rb0 = rng.integers(0, 3, n)
    cb0 = rng.integers(0, ncb, n)
    rb1 = rb0 + rng.integers(-1, 2, n)           # -1: no copy at all
    cb1 = np.minimum(cb0 + rng.integers(0, 2, n), ncb - 1)
    idx, eb = halo_copies(rb0, rb1, cb0, cb1, ncb)
    assert len(idx) == int((np.maximum(rb1 - rb0 + 1, 0)
                            * (cb1 - cb0 + 1)).sum())
    segs = [(rng.integers(0, 100, n).astype(np.int32), -1),
            (rng.normal(size=n).astype(np.float32), 0.5)]
    a, na = layout_tiles(eb, 4 * ncb, segs, idx)
    b, nb = layout_tiles_numpy(eb, 4 * ncb, segs, idx)
    assert na == nb and np.array_equal(a, b)


def _inputs(kind):
    """Two sub-chunks of dead entries (r = -1, or an empty K5 window)."""
    states = [torch.zeros(256, 256), torch.zeros(256, 256)]
    dtype = torch.int32 if kind == "gauss" else torch.float32
    nseg, dead = {"gauss": (8, 6), "rot": (9, 8), "rotp": (12, 6)}[kind]
    params = torch.zeros(2, nseg, 2048, dtype=dtype)
    params[:, dead] = 1 if kind == "rotp" else -1
    return states, params, torch.zeros(2, dtype=torch.int32)


def _call(kind, states, params, bids, th=32, wt=128):
    geom = GaussGeom(200, 200)
    if kind == "gauss":
        gk.sorted_splat_gauss(states, params, bids, th=th, wt=wt, cut=False,
                              geom=geom)
    elif kind == "rot":
        gk.rot_splat_dense(states, params, bids, th=th, wt=wt, geom=geom)
    else:
        gk.rot_splat_packed(states, params, bids, th=th, wt=wt)


KERNELS = {"gauss": gk.sorted_splat_gauss, "rot": gk.rot_splat_dense,
           "rotp": gk.rot_splat_packed}


@pytest.mark.parametrize("bad", ["params_dtype", "nseg", "bids_len",
                                 "state_dtype", "ragged_tiles", "meta_device"])
@pytest.mark.parametrize("kind", ["gauss", "rot", "rotp"])
def test_wrappers_reject_bad_inputs(kind, bad):
    states, params, bids = _inputs(kind)
    th = 32
    if bad == "params_dtype":
        params = params.double()
    elif bad == "nseg":
        params = params[:, :-1].contiguous()
    elif bad == "bids_len":
        bids = bids[:1]
    elif bad == "state_dtype":
        states = [s.double() for s in states]
    elif bad == "ragged_tiles":
        th = 96
        states = [torch.zeros(128, 256)] * 2
    else:
        states = [s.to("meta") for s in states]
        params, bids = params.to("meta"), bids.to("meta")
    before = KERNELS[kind].launches
    with pytest.raises(ValueError):
        _call(kind, states, params, bids, th=th)
    assert KERNELS[kind].launches == before


@pytest.mark.parametrize("kind", ["gauss", "rot", "rotp"])
def test_cpu_path_never_counts_a_launch(kind):
    states, params, bids = _inputs(kind)
    before = KERNELS[kind].launches
    _call(kind, states, params, bids)
    assert KERNELS[kind].launches == before
    assert not any(s.any() for s in states)          # dead entries only


@pytest.mark.parametrize("rtype", [RT.Sum, RT.Count, RT.Average,
                                   RT.WeightedAverage], ids=lambda t: t.name)
@pytest.mark.parametrize("glyph", ["gaussian", "point"])
def test_state_flush_matches_jax(rtype, glyph):
    from pcr_tpu.engine.tpu_backend import gauss_state_flush as jax_flush
    spec = (spec_of("s4", rtype) if glyph == "gaussian"
            else ref.ReductionSpec(value_channel="v", type=rtype))
    info = ref.get_reduction_info(rtype)
    port_spec, port_info = like(port_pkg, spec), port_pkg.get_reduction_info(
        rtype)
    rng = np.random.default_rng(4)
    fields = [(rng.uniform(0, 2e-6, (30, 40))
               * rng.integers(0, 2, (30, 40))).astype(np.float32)
              for _ in range(info.state_floats)]
    want = jax_flush(spec, info, [f.copy() for f in fields], np)
    got = gauss_state_flush(port_spec, port_info,
                            [torch.from_numpy(f) for f in fields])
    for g, w, f in zip(got, want, fields):
        assert np.array_equal(np.asarray(g), w)
    if glyph == "gaussian" and rtype != RT.Sum:
        assert not np.array_equal(want[0], fields[0])


# -- the window-aware walk's host side ---------------------------------------

def tile_shapes(kind):
    """Every (th, wt) the engine can hand the kernel `kind`."""
    from pcr_tpu_torch.engine import tiling
    if kind == "rot":
        return {(tiling.ROT_ROW_BLOCK, tiling.ROT_COL_TILE)}
    if kind == "rotp":
        return {(tiling.ROTP_ROW_BLOCK, 128)}
    return {(tiling.gauss_row_block(W, r), tiling.gauss_col_tile(W, r))
            for W in (1, 100, 128, 129, 200, 1000, 8192) for r in range(41)}


@pytest.mark.parametrize("kind", ["gauss", "rot", "rotp"])
def test_splat_plan_covers_every_tile_within_shared_memory(kind):
    """The slices of a plan tile the (th, wt) tile exactly (each cell one
    owner), the grid is one column of slices per sub-chunk, and a staged
    piece with its windows and records fits Hopper's 227 KB; K2's, the
    larger of its two walks' (one with a factor table), fits eight CTAs on
    an SM (228 KB, 1 KB of it kept for each CTA)."""
    shapes = tile_shapes(kind)
    if kind == "gauss":
        assert {th for th, _ in shapes} == {32, 64, 128}
        assert {wt for _, wt in shapes} == {128, 256}
    # per entry: its segments, 4 window words, then K2's column record,
    # column range and 8 wy, or K4 / K5's two records and 8 dy; K2 with
    # factor tables: its segments, its column and row records, its first
    # slot, its walk record and 8 wy, then a float and a 4-byte descriptor
    # a table slot, and a slot and a live-entry count a warp
    words = {"gauss": 8 + 4 + 4 + 2 + 8, "rot": 9 + 4 + 4 + 4 + 8,
             "rotp": 12 + 4 + 4 + 4 + 8}[kind]
    table = ((8 + 8 + 1 + 4 + 8) * gk.GAUSS_PIECE * 4 + 8 * gk.GAUSS_TABLE
             + 2 * 4 * 4)
    for th, wt in shapes:
        plan = gk.splat_plan(kind, th, wt)
        assert plan.slices * gk.SLICE_ROWS * gk.SLICE_COLS == th * wt
        assert plan.threads == gk.SLICE_COLS == 4 * gk.WARP_COLS
        assert plan.grid(77) == (77, plan.slices)
        if kind == "gauss":
            assert plan.smem_bytes == max(table, words * gk.PIECE * 4)
        else:
            assert plan.smem_bytes == words * gk.PIECE * 4
        assert plan.smem_bytes <= gk.SMEM_LIMIT == 227 * 1024
        if kind == "gauss":
            assert 8 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert gk.BLOCK % gk.PIECE == 0 and gk.PIECE % 32 == 0
    assert gk.GAUSS_PIECE == gk.THREADS <= 128     # one a thread, 7 bits
    assert gk.GAUSS_TABLE >= 8 + gk.SLICE_COLS      # any one entry a round


@pytest.mark.parametrize("th,wt", [(0, 128), (12, 128), (32, 64), (32, 192),
                                   (8 * 65536, 128)])
@pytest.mark.parametrize("kind", ["gauss", "rot", "rotp"])
def test_splat_plan_refuses_tiles_the_kernel_cannot_slice(kind, th, wt):
    with pytest.raises(ValueError):
        gk.splat_plan(kind, th, wt)


def k2_mask_oracle(icx, icy, r, g, hs, ws):
    """The TPU kernel's K2 masks without the factor test, cell by cell
    (numpy): rows (E, nh) and columns (E, nw)."""
    icx, icy, r = (a[:, None] for a in (icx, icy, r))
    my = (np.abs(hs - icy) <= r) & (hs < g.H)
    mx = (np.abs(ws - icx) <= r) & (ws < g.W)
    if g.multi_tile:
        gh = g.global_h or g.H
        rs = (np.clip(icy + g.row_offset, 0, gh - 1) // g.tile_h * g.tile_h
              - g.row_offset)
        re = np.minimum(rs + g.row_offset + g.tile_h, gh) - g.row_offset
        my &= (hs >= rs) & (hs < re)
        cs = np.clip(icx, 0, g.W - 1) // g.tile_w * g.tile_w
        mx &= (ws >= cs) & (ws < np.minimum(cs + g.tile_w, g.W))
    return my, mx


def k4_mask_oracle(icx, icy, r, g, hs, ws):
    """The TPU kernel's rot masks, cell by cell (numpy float32)."""
    icx, icy, r = (a[:, None].astype(np.float32) for a in (icx, icy, r))
    hs, ws = hs.astype(np.float32), ws.astype(np.float32)
    mx = (np.abs(ws - icx) <= r) & (ws < g.W)
    rlo, rhi = icy - r, icy + r
    if g.multi_tile:
        cs = np.floor(np.clip(icx, 0, g.W - 1) / g.tile_w) * g.tile_w
        mx &= (ws >= cs) & (ws < np.minimum(cs + g.tile_w, g.W))
        off, hg1 = g.row_offset, (g.global_h or g.H) - 1
        rs = np.floor(np.clip(icy + off, 0, hg1) / g.tile_h) * g.tile_h
        rlo = np.maximum(rlo, rs - off)
        rhi = np.minimum(rhi, np.minimum(rs + g.tile_h - 1, hg1) - off)
    else:
        rhi = np.minimum(rhi, g.H - 1)
    return (hs >= rlo) & (hs <= rhi), mx


GEOMS = {
    "one_tile": GaussGeom(150, 200),
    "tiles64": GaussGeom(150, 200, True, 64, 64, 0, 150),
    "row_offset": GaussGeom(70, 200, True, 64, 48, 40, 150),
}


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("kind", ["gauss", "rot"])
def test_windows_are_the_tpu_masks(kind, geom):
    """The clipped window the kernel forms once per entry covers exactly
    the cells the TPU kernel's masks pass, dead entries none."""
    g = GEOMS[geom]
    rng = np.random.default_rng(5)
    n = 400
    icx = rng.integers(-3, g.W + 3, n)
    icy = rng.integers(-3, g.H + 3, n)
    r = rng.integers(-1, 33, n)
    hs = np.arange(-40, g.H + 40)[None, :]
    ws = np.arange(-40, g.W + 40)[None, :]
    if kind == "gauss":
        my, mx = k2_mask_oracle(icx, icy, r, g, hs, ws)
        win = gk.gauss_windows(*(torch.from_numpy(a) for a in (icx, icy, r)),
                               g)
    else:
        my, mx = k4_mask_oracle(icx, icy, r, g, hs, ws)
        win = gk.rot_dense_windows(*(torch.from_numpy(a.astype(np.float32))
                                     for a in (icx, icy, r)), g)
    lo_x, hi_x, lo_y, hi_y = (w.numpy()[:, None] for w in win)
    got = (((hs >= lo_y) & (hs <= hi_y))[:, :, None]
           & ((ws >= lo_x) & (ws <= hi_x))[:, None, :])
    want = my[:, :, None] & mx[:, None, :]
    assert want[r >= 0].any() and not want[r < 0].any()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("th,wt", [(32, 128), (64, 128), (128, 128),
                                   (128, 256), (16, 128)])
def test_block_hits_is_the_cell_oracle(th, wt):
    """An entry hits a warp's 8 x 32 block exactly when its window shares
    a cell with it: windows that straddle slice and block borders, lie
    outside their tile, or are empty, against a cell-by-cell oracle."""
    rng = np.random.default_rng(6)
    nsub, block, nrb, ncb = 6, 64, 3, 2
    bids = torch.from_numpy(np.sort(rng.integers(0, nrb * ncb, nsub))
                            .astype(np.int32))
    H, W = nrb * th, ncb * wt
    lo_x = rng.integers(-20, W + 20, (nsub, block))
    lo_y = rng.integers(-20, H + 20, (nsub, block))
    hi_x = lo_x + rng.integers(-2, 70, (nsub, block))
    hi_y = lo_y + rng.integers(-2, 70, (nsub, block))
    # some on the borders of the first sub-chunk's tile: one cell at a
    # block's corner, one block exactly, the whole tile
    r0, c0 = int(bids[0]) // ncb * th, int(bids[0]) % ncb * wt
    lo_x[0, :4] = c0 + np.array([31, 32, 32, 0])
    hi_x[0, :4] = c0 + np.array([31, 32, 63, wt - 1])
    lo_y[0, :4] = r0 + np.array([7, 8, 8, 0])
    hi_y[0, :4] = r0 + np.array([7, 8, 15, th - 1])
    win = [torch.from_numpy(a) for a in (lo_x, hi_x, lo_y, hi_y)]
    got = gk.block_hits(win, bids, th, wt, ncb).numpy()
    assert got.shape == (nsub, block, th // 8, wt // 32)
    rows, cols = np.arange(H), np.arange(W)
    want = np.zeros_like(got)
    for j, b in enumerate(bids.numpy()):
        r0, c0 = b // ncb * th, b % ncb * wt
        for e in range(block):
            cells = np.zeros((H, W), bool)
            cells[np.ix_((rows >= lo_y[j, e]) & (rows <= hi_y[j, e]),
                         (cols >= lo_x[j, e]) & (cols <= hi_x[j, e]))] = True
            tile = cells[r0:r0 + th, c0:c0 + wt]
            want[j, e] = tile.reshape(th // 8, 8, wt // 32, 32).any((1, 3))
    assert np.array_equal(got, want)
    hits = got.reshape(nsub * block, -1).sum(1)
    assert (hits == 0).any() and (hits >= 4).any()
    assert list(hits[:4]) == [1, 1, 1, (th // 8) * (wt // 32)]


BORDER_X = [0.2, 31.5, 32.0, 32.5, 63.9, 64.1, 127.5, 128.2, 199.7]
BORDER_Y = [0.1, 7.5, 8.0, 8.5, 31.9, 32.1, 63.5, 64.4, 127.9, 128.1, 149.8]
WALK_GLYPHS = dict(GLYPHS, s16=dict(default_sigma=16.0))   # th 128


def border_inputs(gc, spec, n=300, seed=7):
    """Routed Gaussian params of points on the borders of the walk's
    8-row slices and 32-column blocks and of the tiles, then n random
    ones, some off-grid or filtered."""
    rng = np.random.default_rng(seed)
    bx, by = np.meshgrid(BORDER_X, BORDER_Y)
    x = np.concatenate([bx.ravel(), rng.uniform(-5, gc.width + 5, n)])
    y = np.concatenate([by.ravel(), rng.uniform(-5, gc.height + 5, n)])
    _, _, valid = routing.assign(gc, x, y)
    valid &= rng.uniform(size=len(x)) > 0.05
    gp = routing.gaussian_params(spec.glyph, gc, x, y, None, None, None)
    values = rng.normal(0, 1, len(x)) * 10.0 ** rng.integers(-1, 2, len(x))
    if spec.glyph.default_rotation:
        # K4 rounds the completed square in another order than the TPU
        # kernel (~1e-6 a term), which a sum that cancels would magnify
        values = np.abs(values)
    return gp, valid, values.astype(np.float32)


@pytest.mark.parametrize("tile", [4096, 64], ids=["one_tile", "tiles64"])
@pytest.mark.parametrize("glyph,th", [("s1", 32), ("s4", 64), ("s16", 128),
                                      ("rot8", 32)])
def test_plain_matches_pallas_on_the_walks_borders(monkeypatch, glyph, th,
                                                   tile):
    """K2 (th 32 / 64 / 128) and K4 on points at the borders of slices,
    blocks and tiles (K2: values of mixed sign): the layout holds entries whose
    window straddles slices and blocks, entries that hit no block (their
    home-tile clip is empty in this tile), and a sub-chunk of dead
    entries; plain against the Pallas kernel in interpret mode."""
    gc = make_grid_config(w=200.0, h=150.0, tile=tile)
    spec = ref.gaussian_splat_spec("v", **WALK_GLYPHS[glyph])
    spec.type = RT.Average
    jeng, port = engines(monkeypatch, gc, spec)
    inp = border_inputs(gc, spec)
    (chunk,) = jeng.prepare_gaussian(0, *inp)
    kind = chunk.key[0]
    assert kind == ("pallas_rot2" if glyph == "rot8" else "pallas_gauss2d")
    assert chunk.key[4] == th
    wt = 128 if kind == "pallas_rot2" else chunk.key[5]
    params, bids = jax_params(chunk)
    if kind == "pallas_rot2":
        (st,) = port.prepare_gaussian(0, *like(port_pkg, inp))
        params = as_port_k4(params, bids, st.params.numpy(),
                            st.bids.numpy())
    p, b = torch.from_numpy(params.copy()), torch.from_numpy(bids.copy())
    geom = GaussGeom.of(gc)
    if kind == "pallas_rot2":
        win = gk.rot_dense_windows(p[:, 6], p[:, 7], p[:, 8], geom)
        dead = params[:, 8] < 0
    else:
        win = gk.gauss_windows(p[:, 0], p[:, 1], p[:, 6], geom)
        dead = params[:, 6] < 0
    ncb = jeng._states[0][0].shape[1] // wt
    hits = gk.block_hits(win, b, th, wt, ncb).numpy()
    assert (hits.sum(2).astype(bool).sum(2) >= 2).any()   # >= 2 column blocks
    assert (hits.sum(3).astype(bool).sum(2) >= 2).any()   # >= 2 row slices
    assert dead.all(1).any()                        # a dead sub-chunk
    assert not hits[dead].any()
    if tile == 64:
        assert (~hits.any((2, 3)) & ~dead).any()    # alive, hits no block
    want = run_jax(chunk, zero_states(jeng))
    got = [torch.from_numpy(s) for s in zero_states(jeng)]
    if kind == "pallas_rot2":
        gk.rot_splat_dense(got, p, b, th=th, wt=wt, geom=geom)
    else:
        gk.sorted_splat_gauss(got, p, b, th=th, wt=wt, cut=bool(chunk.key[6]),
                              geom=geom)
    for g, w in zip(got, want):
        assert w.any()
        assert_close(g.numpy(), w)

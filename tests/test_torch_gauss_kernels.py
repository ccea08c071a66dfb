"""Kernels K2, K4 and K5 of the PyTorch port (pcr_tpu_torch.engine.
gauss_kernels), on torch-CPU, where each wrapper runs its plain version.

The JAX package's Gaussian layouts (TpuEngine.prepare_gaussian, with its
ladder-padded nsub and dead entries) go through its Pallas builders in
interpret mode and through the port:

  * K2 and K4 on the JAX package's own packed buffer, which is also the
    port's layout without the ladder padding;
  * K5 on each package's own layout (the TPU's quad-major wire is not
    carried over), so only the results are compared.

Tolerance atol = rtol = 1e-5 on the raw state sums: the two add the same
float32 terms in different orders (and K4/K5 round the completed square in
another order, which moves a term by ~1e-6 relative at these coordinates).
The footprint (cells that received any weight) must be the same.
"""

import numpy as np
import pytest
import torch

import pcr_tpu as ref
from conftest import make_grid_config
from pcr_tpu.engine import routing
from pcr_tpu.engine.tpu_backend import PALLAS_BLOCK, TpuEngine
from pcr_tpu_torch.engine import gauss_kernels as gk
from pcr_tpu_torch.engine.gauss_kernels import GaussGeom
from pcr_tpu_torch.engine.torch_backend import (TorchEngine, halo_copies,
                                                layout_tiles,
                                                layout_tiles_numpy)
from pcr_tpu_torch.ops.reduction import gauss_state_flush

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
    return TpuEngine(gc, plans), TorchEngine(gc, plans, torch.device("cpu"))


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
    jeng, _ = engines(monkeypatch, gc, spec)
    chunk = jax_chunk(jeng, "rot8", inputs(gc, spec, n=600))
    params, bids = jax_params(chunk)
    want = run_jax(chunk, zero_states(jeng))
    got = [torch.from_numpy(s) for s in zero_states(jeng)]
    gk.rot_splat_dense(got, torch.from_numpy(params.copy()),
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
    (st,) = port.prepare_gaussian(0, *inp)
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
    (st,) = port.prepare_gaussian(0, *inp)
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
    sub-chunk the JAX layout gives each empty tile."""
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
    nseg, dead = {"gauss": (8, 6), "rot": (9, 8), "rotp": (10, 6)}[kind]
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
    rng = np.random.default_rng(4)
    fields = [(rng.uniform(0, 2e-6, (30, 40))
               * rng.integers(0, 2, (30, 40))).astype(np.float32)
              for _ in range(info.state_floats)]
    want = jax_flush(spec, info, [f.copy() for f in fields], np)
    got = gauss_state_flush(spec, info, [torch.from_numpy(f) for f in fields])
    for g, w, f in zip(got, want, fields):
        assert np.array_equal(np.asarray(g), w)
    if glyph == "gaussian" and rtype != RT.Sum:
        assert not np.array_equal(want[0], fields[0])

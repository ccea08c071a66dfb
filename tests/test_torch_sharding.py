"""The port's mesh library (pcr_tpu_torch/parallel/sharding.py) against
pcr_tpu's (pcr_tpu/parallel/sharding.py) and the numpy oracle.

pcr_tpu's steps are shard_map programs on the 8 virtual CPU devices
tests/conftest.py forces, over a (dp 4, sp 2) mesh; the port's are torch
ops over a (4, 2) mesh of eight CPU devices, one process driving them.
The same seeded inputs go through both: sum fields within 1e-5 of the
oracle (2e-5 for Gaussians, as tests/test_sharding.py holds pcr_tpu) and
of pcr_tpu, max / min / MostRecent exact. Last, ShardedTorchEngine built
directly on a tiled grid, which serves it with its row shards.
"""

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu.engine import cpu_backend as cpu
from pcr_tpu.engine import routing
from pcr_tpu.parallel import sharding as jsh
from pcr_tpu_torch.parallel import sharding as tsh
from pcr_tpu_torch.parallel.engine import ShardedTorchEngine
from test_sharding import H, W, oracle, point_data
from test_torch_pipeline import like

RT = ref.ReductionType
CPU_DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    return jsh.make_mesh(dp=4, sp=2), tsh.make_mesh([CPU_DEV] * 8, dp=4,
                                                    sp=2)


def info_of(pkg, rtype):
    return pkg.get_reduction_info(like(pkg, rtype))


def port_step(build, rtype, inputs, meshes, *args, steps=1, **kw):
    """The port's step over its mesh from the identity, `steps` times on
    the same inputs; (H, W) numpy fields."""
    mesh = meshes[1]
    info = info_of(port, rtype)
    step = build(info, H, W, mesh, *args, **kw)
    states = tsh.replicate_state(mesh, info.init_state((H, W)), H, W)
    for _ in range(steps):
        states = step(states, *tsh.shard_points(mesh, *inputs))
    return [g.numpy() for g in tsh.gather_state(states)]


def jax_step(build, rtype, inputs, meshes, *args, **kw):
    mesh = meshes[0]
    info = ref.get_reduction_info(rtype)
    step = build(info, H, W, mesh, *args, **kw)
    states = jsh.replicate_state(mesh, info.init_state((H, W)), H, W)
    states = step(states, *jsh.shard_points(mesh, *inputs))
    return [np.asarray(s) for s in states]


def agree(got, jax_fields, want, kind, atol=1e-5):
    for g, j, w in zip(got, jax_fields, want):
        if kind == "sum":
            np.testing.assert_allclose(g, w, atol=atol)
            np.testing.assert_allclose(g, j, atol=atol)
        else:
            assert np.array_equal(g, w, equal_nan=True)
            assert np.array_equal(g, j, equal_nan=True)


@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average, RT.Count,
                                   RT.WeightedAverage, RT.Max, RT.Min,
                                   RT.MostRecent])
def test_point_step_matches_oracle(meshes, rtype):
    data = point_data()
    want = oracle(rtype, *data)
    got = port_step(tsh.sharded_point_step, rtype, data, meshes)
    jax_fields = jax_step(jsh.sharded_point_step, rtype, data, meshes)
    agree(got, jax_fields, want, ref.get_reduction_info(rtype).scatter_kind)


def test_point_step_accumulates_across_steps(meshes):
    info = info_of(port, RT.Sum)
    mesh = meshes[1]
    step = tsh.sharded_point_step(info, H, W, mesh)
    states = tsh.replicate_state(mesh, info.init_state((H, W)), H, W)
    total = np.zeros((H, W), np.float32)
    for seed in range(3):
        data = point_data(seed)
        total += oracle(RT.Sum, *data)[0]
        states = step(states, *tsh.shard_points(mesh, *data))
    np.testing.assert_allclose(tsh.gather_state(states)[0].numpy(), total,
                               atol=1e-5)


def gauss_inputs(seed, glyph, rtype):
    """(routed inputs, oracle fields) of 2048 Gaussians on the H x W grid."""
    gc = make_grid_config(w=float(W), h=float(H))
    rng = np.random.default_rng(seed)
    n = 2048
    x, y = rng.uniform(0, W, n), rng.uniform(0, H, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    spec = ref.GlyphSpec(type=ref.GlyphType.Gaussian, **glyph)
    info = ref.get_reduction_info(rtype)
    state = info.init_state((H, W))
    col, row, _ = routing.assign(gc, x, y)
    cpu.accumulate_gaussian_cpu(spec, rtype, gc, state, x, y, values, None,
                                None, None, col, row)
    gp = routing.gaussian_params(spec, gc, x, y, None, None, None)
    return gp, values, state


def test_gaussian_step_matches_oracle(meshes):
    gp, values, want = gauss_inputs(
        3, dict(default_sigma_x=1.5, default_sigma_y=1.5,
                max_radius_cells=6.0), RT.WeightedAverage)
    inputs = (gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx, gp.sy, gp.r,
              np.ones(len(values), bool), values)
    got = port_step(tsh.sharded_gaussian_step, RT.WeightedAverage, inputs,
                    meshes, block=512)
    jax_fields = jax_step(jsh.sharded_gaussian_step, RT.WeightedAverage,
                          inputs, meshes, block=512)
    agree(got, jax_fields, want, "sum", atol=2e-5)


def test_gaussian_rotated_step_matches_oracle(meshes):
    """The rotated step, which pcr_tpu's tests do not hold, against the
    oracle and pcr_tpu's step."""
    gp, values, want = gauss_inputs(
        5, dict(default_sigma_x=2.0, default_sigma_y=0.8,
                default_rotation=0.6, max_radius_cells=7.0), RT.Average)
    assert gp.rotated
    rmax = int(gp.r.max())
    inputs = (gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx, gp.sy,
              gp.cos_rot, gp.sin_rot, gp.r, np.ones(len(values), bool),
              values)
    got = port_step(tsh.sharded_gaussian_rotated_step, RT.Average, inputs,
                    meshes, rmax)
    jax_fields = jax_step(jsh.sharded_gaussian_rotated_step, RT.Average,
                          inputs, meshes, rmax)
    agree(got, jax_fields, want, "sum", atol=2e-5)


def line_inputs(seed=4):
    gc = make_grid_config(w=float(W), h=float(H))
    rng = np.random.default_rng(seed)
    n = 2048
    x, y = rng.uniform(0, W, n), rng.uniform(0, H, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    dirs = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    spec = ref.GlyphSpec(type=ref.GlyphType.Line, default_half_length=4.0,
                         max_radius_cells=8.0)
    state = ref.get_reduction_info(RT.Sum).init_state((H, W))
    col, row, valid = routing.assign(gc, x, y)
    cpu.accumulate_line_cpu(spec, RT.Sum, gc, state, x, y, values, dirs,
                            None, col, row)
    rects = routing.line_rects(routing.line_params(spec, gc, x, y, dirs,
                                                   None), gc, valid, col, row)
    m = len(rects.ax)
    pad = (-m) % (512 * 8)

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])
    inputs = (padded(rects.ax, 1), padded(rects.bx, 0), padded(rects.ay, 1),
              padded(rects.by, 0), padded(np.ones(m, bool), False),
              padded(values[rects.owner], 0.0))
    return inputs, state


def test_line_step_matches_oracle(meshes):
    inputs, want = line_inputs()
    got = port_step(tsh.sharded_line_step, RT.Sum, inputs, meshes, block=512)
    jax_fields = jax_step(jsh.sharded_line_step, RT.Sum, inputs, meshes,
                          block=512)
    agree(got, jax_fields, want, "sum")


@pytest.mark.parametrize("which", ["point", "gaussian", "rotated", "line"])
def test_steps_rerun_bit_identical(meshes, which):
    """Every sum scatter adds a cell's terms in order and the dp merge
    folds the cells in order: two runs give the same bits."""
    if which == "point":
        args = (tsh.sharded_point_step, RT.WeightedAverage, point_data(7))
        kw = {}
    elif which == "line":
        args = (tsh.sharded_line_step, RT.Sum, line_inputs(8)[0])
        kw = dict(block=512)
    else:
        rotated = which == "rotated"
        gp, values, _ = gauss_inputs(9, dict(
            default_sigma_x=2.0, default_sigma_y=0.8 if rotated else 2.0,
            default_rotation=0.6 if rotated else 0.0,
            max_radius_cells=7.0), RT.Average)
        valid = np.ones(len(values), bool)
        if rotated:
            args = (tsh.sharded_gaussian_rotated_step, RT.Average,
                    (gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx, gp.sy,
                     gp.cos_rot, gp.sin_rot, gp.r, valid, values),
                    int(gp.r.max()))
            kw = {}
        else:
            args = (tsh.sharded_gaussian_step, RT.Average,
                    (gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx, gp.sy,
                     gp.r, valid, values))
            kw = dict(block=512)
    build, rtype, inputs, *extra = args
    a = port_step(build, rtype, inputs, meshes, *extra, steps=2, **kw)
    b = port_step(build, rtype, inputs, meshes, *extra, steps=2, **kw)
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


def test_block_and_height_contracts(meshes):
    """A per-cell count that is not a whole number of blocks, and a height
    that sp does not divide, raise ValueError, as in pcr_tpu."""
    mesh = meshes[1]
    info = info_of(port, RT.Sum)
    with pytest.raises(ValueError, match="not divisible by sp"):
        tsh.sharded_point_step(info, H + 1, W, mesh)
    step = tsh.sharded_line_step(info, H, W, mesh, block=512)
    states = tsh.replicate_state(mesh, info.init_state((H, W)), H, W)
    n = 4 * 500
    with pytest.raises(ValueError, match="not divisible by block"):
        step(states, *tsh.shard_points(
            mesh, np.ones(n, np.int32), np.zeros(n, np.int32),
            np.ones(n, np.int32), np.zeros(n, np.int32), np.ones(n, bool),
            np.ones(n, np.float32)))
    # empty intervals (ax > bx) are inert
    n = 4 * 512
    step(states, *tsh.shard_points(
        mesh, np.ones(n, np.int32), np.zeros(n, np.int32),
        np.ones(n, np.int32), np.zeros(n, np.int32), np.ones(n, bool),
        np.ones(n, np.float32)))
    assert not tsh.gather_state(states)[0].any()


def test_mesh_shapes(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    devs = tsh.available_devices(8)
    m = tsh.make_mesh(devs)
    assert m.shape["dp"] == 8 and m.shape["sp"] == 1
    m = tsh.make_mesh(devs, sp=4)
    assert m.shape["dp"] == 2 and m.shape["sp"] == 4
    assert m.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        tsh.make_mesh(devs, dp=3)
    assert tsh.make_mesh().shape == {"dp": 1, "sp": 1}


@pytest.mark.parametrize("glyph", ["point", "gaussian", "rotated", "line"])
def test_dense_engine_branches_match_oracle(glyph, monkeypatch):
    """ShardedTorchEngine built directly on a grid of several tiles (where
    pcr_tpu's runs its dense steps) serves it with the same row shards as
    on one tile, home-tile clips in the whole grid's frame, and matches
    the oracle; the Pipeline takes PartitionedTorchEngine there."""
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    gc = make_grid_config(w=70.0, h=61.0, tile=32)
    rng = np.random.default_rng(11)
    n = 1500
    x, y = rng.uniform(-2, 72, n), rng.uniform(-2, 63, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    col, row, valid = routing.assign(gc, x, y)
    if glyph == "point":
        specs = [ref.ReductionSpec(value_channel="v", type=t)
                 for t in (RT.Average, RT.Max, RT.MostRecent)]
    elif glyph == "line":
        specs = [ref.line_splat_spec("v", default_direction=0.7,
                                     default_half_length=5.0)]
    else:
        specs = [ref.gaussian_splat_spec(
            "v", default_sigma_x=2.0,
            default_sigma_y=0.8 if glyph == "rotated" else 2.0,
            default_rotation=0.6 if glyph == "rotated" else 0.0,
            max_radius_cells=7.0)]
    ts = rng.integers(0, 5, n).astype(np.float32)
    pgc = like(port, gc)
    plans = [(s, port.get_reduction_info(s.type)) for s in like(port, specs)]
    eng = ShardedTorchEngine(pgc, plans, devices=[CPU_DEV] * 8, dp=4, sp=2)
    assert (eng.dp, eng.nshards, eng.local_rows) == (4, 2, 31)
    for i, spec in enumerate(specs):
        info = ref.get_reduction_info(spec.type)
        want = info.init_state((gc.height, gc.width))
        v = valid
        if glyph == "point":
            cpu.accumulate_point_cpu(
                info, want, row[v].astype(np.int64) * gc.width + col[v],
                values[v], None, ts[v])
            eng.ingest_point(i, row.astype(np.int64) * gc.width + col,
                             valid, values, None, ts)
        elif glyph == "line":
            cpu.accumulate_line_cpu(spec.glyph, spec.type, gc, want, x[v],
                                    y[v], values[v], None, None, col[v],
                                    row[v])
            lp = routing.line_params(spec.glyph, gc, x, y, None, None)
            eng.ingest_line(i, like(port, lp), valid, values, col, row)
        else:
            cpu.accumulate_gaussian_cpu(spec.glyph, spec.type, gc, want,
                                        x[v], y[v], values[v], None, None,
                                        None, col[v], row[v])
            gp = routing.gaussian_params(spec.glyph, gc, x, y, None, None,
                                         None)
            eng.ingest_gaussian(i, like(port, gp), valid, values)
        got = eng.fetch_state(i)
        for g, w in zip(got, want):
            if info.scatter_kind == "sum":
                np.testing.assert_allclose(g, w, atol=2e-5)
            else:
                assert np.array_equal(g, w, equal_nan=True)
        band = eng.finalize_to_host(i)[0]
        assert band.shape == (gc.height, gc.width)

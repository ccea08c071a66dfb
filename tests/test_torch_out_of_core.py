"""Out-of-core banding on the port's device path (OutOfCoreTorchEngine).

With a small `gpu_memory_budget` the port keeps the full state on the host
and accumulates row bands through one band-shaped TorchEngine. On the CPU
(PCR_TORCH_DEVICE=cpu, every kernel on its plain version) a cell's terms
arrive in the same order banded or resident, so the banded band must equal
the port's resident band bit for bit, for every glyph and by both layout
routes (PCR_WIRE_CHEAP=0 and 1). Each test of tests/test_out_of_core_tpu.py
has a twin here that also holds the port's banded band within 1e-5 (abs +
rel per cell, exact NaN footprint; Max / MostRecent exact) of pcr_tpu's
OutOfCoreTpuEngine and of the numpy oracle; the Gaussian twins use
positive values (with mixed signs the 1e-5 bar is relative to a cell's
sum of |terms|, PERF.md section 2). The grid_merge twins hold the
port's engine/grid_merge.py against pcr_tpu's, on numpy and on torch.
"""

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_cloud, make_grid_config
from pcr_tpu.engine.out_of_core import OutOfCoreTpuEngine
from pcr_tpu.engine.out_of_core import pick_band_rows as ref_pick_band_rows
from pcr_tpu_torch.engine.out_of_core import (OutOfCoreTorchEngine,
                                              pick_band_rows)
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_torch_pipeline import assert_bands, assert_close, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
HYBRID = ref.ExecutionMode.Hybrid


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def run(pkg, gc, specs, clouds, budget=0, mode=GPU, staged=False, **kw):
    p = pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, gc), reductions=like(pkg, specs),
        exec_mode=like(pkg, mode), gpu_memory_budget=budget, **kw))
    for c in like(pkg, clouds):
        p.ingest(p.stage(c) if staged else c)
    p.finalize()
    return p, [p.result().band_array(i).copy() for i in range(len(specs))]


def bits(bands):
    return [b.view(np.int32) for b in bands]


def same_bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(bits(a), bits(b)))


def twin(gc, specs, clouds, budget, **kw):
    """The port banded: an OutOfCoreTorchEngine with several bands, bit for
    bit the port's resident band, within 1e-5 of pcr_tpu's banded band and
    of the oracle. Returns the port's banded pipeline and bands."""
    p, got = run(port, gc, specs, clouds, budget, **kw)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.nbands > 1 and p._engine.stats["swaps"] >= 1
    q, res = run(port, gc, specs, clouds, **kw)
    assert isinstance(q._engine, TorchEngine)
    assert same_bits(got, res)
    j, jax_bands = run(ref, gc, specs, clouds, budget, **kw)
    assert isinstance(j._engine, OutOfCoreTpuEngine)
    assert_bands(got, jax_bands, specs)
    _, oracle = run(ref, gc, specs, clouds, mode=CPU,
                    **{k: v for k, v in kw.items() if k != "chunk_size"})
    assert_bands(got, oracle, specs)
    return p, got


def positive_cloud(n, seed, w, h):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    for name in ("v", "w"):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, rng.uniform(0.5, 2.0, n)
                                .astype(np.float32))
    return c


def tiled():
    return make_grid_config(w=512.0, h=512.0, tile=128)


def untiled_grid(n=600.0):
    gc = make_grid_config(w=n, h=n)
    gc.tile_width = gc.tile_height = 8192   # single tile covers the grid
    gc.compute_dimensions()
    assert gc.total_tiles() == 1
    return gc


# -- twins of tests/test_out_of_core_tpu.py ---------------------------------

def test_budget_engages_banding():
    gc = tiled()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, gpu_memory_budget=1 << 20))
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.band_rows % gc.tile_height == 0
    assert p._engine.device.type == "cpu"
    # ample budget -> resident engine
    p2 = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, gpu_memory_budget=1 << 30))
    assert isinstance(p2._engine, TorchEngine)


@pytest.mark.parametrize("rtype", [RT.Average, RT.Sum, RT.Max,
                                   RT.MostRecent], ids=lambda t: t.name)
def test_point_banded_matches_resident_exactly(rtype):
    specs = [ref.ReductionSpec(value_channel="v", type=rtype,
                               timestamp_channel="t")]
    clouds = [make_cloud(8000, seed=s, w=512.0, h=512.0,
                         channels=("v", "t")) for s in (0, 1)]
    twin(tiled(), specs, clouds, 1 << 20)


def test_gaussian_banded_matches_resident_exactly():
    spec = ref.gaussian_splat_spec("v", default_sigma=2.0,
                                   max_radius_cells=8.0)
    twin(tiled(), [spec], [positive_cloud(4000, 2, 512.0, 512.0)], 1 << 20)


def test_gaussian_rotated_banded_matches_resident():
    gc = make_grid_config(w=256.0, h=256.0, tile=64)
    spec = ref.gaussian_splat_spec("v", default_sigma_x=2.5,
                                   default_sigma_y=1.0,
                                   default_rotation=0.8,
                                   max_radius_cells=8.0)
    twin(gc, [spec], [positive_cloud(1500, 3, 256.0, 256.0)], 1 << 18)


def test_line_banded_matches_resident_exactly():
    spec = ref.line_splat_spec("v", direction_channel="d",
                               default_half_length=6.0,
                               max_radius_cells=10.0)
    spec.type = RT.Sum
    twin(tiled(), [spec], [make_cloud(3000, seed=4, w=512.0, h=512.0,
                                      channels=("v", "d"))], 1 << 20)


def test_multi_reduction_banded_with_resume(tmp_path):
    """The banded engine through the whole lifecycle, PCRT checkpoint
    included: a second banded pipeline resumes the first one's state, in
    the port as in pcr_tpu."""
    gc = tiled()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average),
             ref.ReductionSpec(value_channel="v", type=RT.Max)]
    c1 = make_cloud(5000, seed=5, w=512.0, h=512.0)
    c2 = make_cloud(5000, seed=6, w=512.0, h=512.0)
    _, want = run(port, gc, specs, [c1, c2])
    results = {}
    for pkg in (port, ref):
        sd = str(tmp_path / pkg.__name__)
        run(pkg, gc, specs, [c1], 1 << 20, state_dir=sd)
        p2, got = run(pkg, gc, specs, [c2], 1 << 20, state_dir=sd,
                      resume=True)
        assert p2._engine.nbands > 1
        results[pkg] = got
    assert same_bits(results[port], want)
    assert_bands(results[port], results[ref], specs)
    _, oracle = run(ref, gc, specs, [c1, c2], mode=CPU)
    assert_bands(results[port], oracle, specs)


def test_big_grid_small_budget_matches_cpu_oracle():
    """8192^2 grid under a 32 MiB budget, a sparse cloud: the port's
    banded band equals the CPU oracle (the resident engine is left out:
    its state alone would be 0.5 GB on this host)."""
    gc = make_grid_config(w=8192.0, h=8192.0, tile=512)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(20000, seed=7, w=8192.0, h=8192.0)]
    p, got = run(port, gc, specs, clouds, 32 << 20)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.nbands > 1
    _, oracle = run(ref, gc, specs, clouds, mode=CPU)
    assert_close(got[0], oracle[0])


def test_chunk_size_honored():
    """config.chunk_size slices banded ingest as it slices resident
    ingest (declared-unused in the reference, pipeline.h:67)."""
    gc = tiled()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    cloud = make_cloud(10000, seed=8, w=512.0, h=512.0)
    p, got = twin(gc, specs, [cloud], 1 << 20, chunk_size=3000)
    _, whole = run(port, gc, specs, [cloud])
    assert_close(got[0], whole[0])


def test_untiled_budget_engages_banding():
    gc = untiled_grid()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, gpu_memory_budget=1 << 20))
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.untiled and p._engine.nbands > 1
    # a band engine's rows pad to nothing: padding never meets a band
    assert p._engine._exec.H_pad == p._engine.band_rows


def test_untiled_point_banded_matches_resident_exactly():
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(8000, seed=s, w=600.0, h=600.0,
                         channels=("v",)) for s in (0, 1)]
    twin(untiled_grid(), specs, clouds, 1 << 20)


def test_untiled_gaussian_cross_band_footprints_match_resident():
    """Gaussian footprints (sigma=4 -> r=12) span band boundaries on an
    untiled grid; the duplicated entries reproduce the resident band."""
    spec = ref.gaussian_splat_spec("v", default_sigma=4.0)
    twin(untiled_grid(), [spec], [positive_cloud(4000, 7, 600.0, 600.0)],
         1 << 20)


def test_untiled_line_cross_band_matches_resident():
    spec = ref.line_splat_spec("v", default_half_length=10.0,
                               direction_channel="d")
    twin(untiled_grid(), [spec],
         [make_cloud(4000, seed=9, w=600.0, h=600.0, channels=("v", "d"))],
         1 << 20)


# -- the port's own ------------------------------------------------------------

@pytest.mark.parametrize("budget", [1 << 14, 1 << 18, 1 << 20, 32 << 20,
                                    1 << 30])
@pytest.mark.parametrize("grid", ["tiled", "untiled", "big"])
def test_pick_band_rows_is_pcr_tpus(grid, budget):
    """Both packages pick the same band height (the port's row quantum on
    untiled grids, kernels.TH, is pcr_tpu's GAUSS_ROW_BLOCK)."""
    gc = {"tiled": tiled, "untiled": untiled_grid,
          "big": lambda: make_grid_config(w=8192.0, h=8192.0,
                                          tile=512)}[grid]()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average),
             ref.ReductionSpec(value_channel="v", type=RT.Max)]
    plans = [(s, ref.get_reduction_info(s.type)) for s in specs]
    pplans = [(like(port, s), port.get_reduction_info(s.type))
              for s in specs]
    assert (pick_band_rows(like(port, gc), pplans, budget)
            == ref_pick_band_rows(gc, plans, budget))


GLYPHS = {
    "point": lambda: ref.ReductionSpec(value_channel="v",
                                       type=RT.WeightedAverage,
                                       weight_channel="w"),
    "gauss": lambda: ref.gaussian_splat_spec("v", default_sigma=3.0),
    "rotp": lambda: ref.gaussian_splat_spec("v", default_sigma_x=4.0,
                                            default_sigma_y=1.5,
                                            default_rotation=0.6),
    "rot": lambda: ref.gaussian_splat_spec("v", default_sigma_x=8.0,
                                           default_sigma_y=3.0,
                                           default_rotation=0.6),
    "line": lambda: ref.line_splat_spec("v", default_direction=0.7,
                                        default_half_length=9.0),
}


@pytest.mark.parametrize("wire", ["0", "1"])
@pytest.mark.parametrize("grid", ["tiled", "untiled"])
@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_banded_is_resident_by_both_routes(glyph, grid, wire, monkeypatch):
    """Every glyph on a 64-cell-tiled grid and on an untiled one (where
    entries are copied into the bands below their centres, with negative
    band-local centre rows), through the host layout (PCR_WIRE_CHEAP=0) and
    the device layout: the banded band is the resident band bit for bit,
    host-sourced and staged."""
    monkeypatch.setenv("PCR_WIRE_CHEAP", wire)
    gc = (make_grid_config(w=300.0, h=260.0, tile=64) if grid == "tiled"
          else untiled_grid(300.0))
    specs = [GLYPHS[glyph]()]
    n = {"point": 3000, "gauss": 1500, "rotp": 500, "rot": 250,
         "line": 1000}[glyph]          # the plain rotated splats are slow
    clouds = [positive_cloud(n, 11, 300.0, 260.0 if grid == "tiled"
                             else 300.0)]
    _, res = run(port, gc, specs, clouds)
    for staged in (False, True) if wire == "1" else (False,):
        p, got = run(port, gc, specs, clouds, 1 << 16, staged=staged)
        assert isinstance(p._engine, OutOfCoreTorchEngine)
        assert p._engine.nbands > 1
        assert same_bits(got, res)


@pytest.mark.parametrize("wire", ["0", "1"])
@pytest.mark.parametrize("glyph", ["gauss", "rotp", "rot"])
def test_lower_edge_centres_keep_their_footprint_in_a_partial_last_band(
        glyph, wire, monkeypatch):
    """A Gaussian centred exactly on the grid's lower edge has its centre
    row at H, one past the last row; the resident engine clamps its home
    tile to the last tile row. On a grid of whole tiles whose last band is
    partial (320 rows of 64-cell tiles in 128-row bands), the band's
    row-offset view clamps it there too, by both layout routes: the
    footprint is kept, bit for bit the resident band's, within 1e-5 of
    the oracle."""
    monkeypatch.setenv("PCR_WIRE_CHEAP", wire)
    gc = make_grid_config(w=300.0, h=320.0, tile=64)
    specs = [GLYPHS[glyph]()]
    n = {"gauss": 600, "rotp": 300, "rot": 150}[glyph]
    c = positive_cloud(n, 12, 300.0, 320.0)
    y = c.y_array().copy()
    y[: n // 3] = gc.bounds.min_y          # centre row H
    c.set_y_array(y)
    _, res = run(port, gc, specs, [c])
    assert not np.isnan(res[0][-1]).all()  # the edge rows are covered
    p, got = run(port, gc, specs, [c], 1 << 21)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.band_rows == 128 and p._engine.nbands == 3
    assert same_bits(got, res)
    _, oracle = run(ref, gc, specs, [c], mode=CPU)
    assert_bands(got, oracle, specs)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_hybrid_workers_equal_gpu_mode_banded(workers):
    """Hybrid's workers stage (band, chunks) lists at once; at one
    chunk_size the banded bands are GPU mode's, bit for bit."""
    gc = make_grid_config(w=300.0, h=260.0, tile=64)
    specs = [GLYPHS["gauss"](), GLYPHS["point"]()]
    clouds = [positive_cloud(3000, 12, 300.0, 260.0)]
    _, want = run(port, gc, specs, clouds, 1 << 16, chunk_size=1000)
    p, got = run(port, gc, specs, clouds, 1 << 16, mode=HYBRID,
                 chunk_size=1000, hybrid_cpu_threads=workers)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert same_bits(got, want)


def test_state_carries_from_pcr_tpus_banded_engine():
    """Host state written by pcr_tpu's OutOfCoreTpuEngine (fetch_state)
    and loaded into the port's banded engine (load_state) accumulates on
    as pcr_tpu's does."""
    gc = tiled()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    c1 = make_cloud(5000, seed=13, w=512.0, h=512.0)
    c2 = make_cloud(5000, seed=14, w=512.0, h=512.0)
    cfg = dict(grid=gc, reductions=specs, exec_mode=GPU,
               gpu_memory_budget=1 << 20)
    j = ref.Pipeline.create(ref.PipelineConfig(**cfg))
    j.ingest(c1)
    assert isinstance(j._engine, OutOfCoreTpuEngine)
    fields = [np.asarray(f).copy() for f in j._engine.fetch_state(0)]
    t = port.Pipeline.create(port.PipelineConfig(**like(port, cfg)))
    t._engine.load_state(0, fields)
    for a, b in zip(t._engine.fetch_state(0), fields):
        assert np.array_equal(a, b, equal_nan=True)
    for pkg, p in ((ref, j), (port, t)):
        p.ingest(like(pkg, c2))
        p.finalize()
    assert_close(t.result().band_array(0), j.result().band_array(0))


def test_band_swap_flushes_gaussian_residues():
    """A Gaussian weight sum under GAUSS_WMIN left in a band is zeroed
    when the band leaves the card (TorchEngine.fetch_state's flush), not
    only at the end."""
    gc = like(port, tiled())
    spec = like(port, ref.gaussian_splat_spec("v", default_sigma=2.0))
    spec.type = port.ReductionType.Average
    plans = [(spec, port.get_reduction_info(spec.type))]
    eng = OutOfCoreTorchEngine(gc, plans, 128, torch.device("cpu"))
    fields = [np.zeros((512, 512), np.float32) for _ in range(2)]
    fields[0][5, 5], fields[1][5, 5] = 1e-7, 1e-7      # a residue, band 0
    fields[0][6, 6], fields[1][6, 6] = 3.0, 1.5        # data, band 0
    eng.load_state(0, fields)
    rng = np.random.default_rng(15)
    x = rng.uniform(100, 512, 200)              # far from the residue
    y = rng.uniform(0, 120, 200)                      # band 0 ...
    y[100:] += 384                                    # ... and band 3
    from pcr_tpu_torch.engine import routing
    gp = routing.gaussian_params(spec.glyph, gc, x, y, None, None, None)
    staged = eng.prepare_gaussian(0, gp, np.ones(200, bool),
                                  np.ones(200, np.float32))
    assert [b for b, _ in staged] == [0, 3]
    eng.commit(0, staged)
    assert eng._cur == 3 and eng.stats["swaps"] == 2
    host = eng._host[0]                  # band 0 left the card once
    assert host[0][5, 5] == 0.0 and host[1][5, 5] == 0.0
    assert host[1][6, 6] >= 1.5


def test_prepare_writes_nothing_on_the_engine():
    """prepare_* run on Hybrid's worker threads: staging leaves the band
    on the card, the host state and the counters as they were."""
    gc = like(port, tiled())
    spec = like(port, ref.ReductionSpec(value_channel="v", type=RT.Sum))
    eng = OutOfCoreTorchEngine(
        gc, [(spec, port.get_reduction_info(spec.type))], 128,
        torch.device("cpu"))
    before = (eng._cur, eng._dirty, dict(eng.stats),
              [f.copy() for f in eng._host[0]])
    rng = np.random.default_rng(16)
    col = rng.integers(0, 512, 1000).astype(np.int32)
    row = rng.integers(0, 512, 1000).astype(np.int32)
    staged = eng.prepare_point(0, None, np.ones(1000, bool),
                               np.ones(1000, np.float32), wire_cheap=True,
                               col=col, row=row)
    assert [b for b, _ in staged] == [0, 1, 2, 3]
    assert (eng._cur, eng._dirty, eng.stats) == before[:3]
    assert all(np.array_equal(a, b) for a, b in zip(eng._host[0],
                                                    before[3]))
    assert eng.prepare_gaussian_raw(0, None, None, None, None, None) is None
    assert eng.prepare_line_raw(0, None, None, None, None, None, None,
                                None) is None


# -- grid_merge (twins of tests/test_out_of_core.py::TestGridMerge) --------

MERGE_TYPES = (RT.Sum, RT.Average, RT.Max, RT.Min, RT.WeightedAverage,
               RT.MostRecent)


@pytest.mark.parametrize("on", ["numpy", "torch"])
@pytest.mark.parametrize("rtype", MERGE_TYPES, ids=lambda t: t.name)
def test_merge_matches_joint_accumulation(rtype, on):
    """Merging two halves' states equals accumulating both at once, and
    equals pcr_tpu's grid_merge bit for bit, on numpy arrays and on torch
    tensors."""
    from pcr_tpu.engine import cpu_backend as ref_cpu
    from pcr_tpu.engine import grid_merge as ref_gm
    from pcr_tpu_torch.engine import cpu_backend as cpu
    from pcr_tpu_torch.engine import grid_merge as gm
    rng = np.random.default_rng(0)
    info = port.get_reduction_info(rtype)
    cells = rng.integers(0, 64, 500)
    vals = rng.normal(0, 1, 500).astype(np.float32)
    w = rng.uniform(0.1, 1, 500).astype(np.float32)
    ts = rng.uniform(0, 9, 500).astype(np.float32)
    joint = gm.init_state(rtype, (8, 8))
    cpu.accumulate_point_cpu(info, joint, cells, vals, w, ts)
    a = gm.init_state(rtype, (8, 8))
    b = gm.init_state(rtype, (8, 8))
    cpu.accumulate_point_cpu(info, a, cells[:250], vals[:250], w[:250],
                             ts[:250])
    cpu.accumulate_point_cpu(info, b, cells[250:], vals[250:], w[250:],
                             ts[250:])
    ra, rb = (ref_gm.init_state(rtype, (8, 8)) for _ in range(2))
    rinfo = ref.get_reduction_info(rtype)
    ref_cpu.accumulate_point_cpu(rinfo, ra, cells[:250], vals[:250],
                                 w[:250], ts[:250])
    ref_cpu.accumulate_point_cpu(rinfo, rb, cells[250:], vals[250:],
                                 w[250:], ts[250:])
    want = ref_gm.finalize_state(rtype, ref_gm.merge_state(rtype, ra, rb))
    if on == "torch":
        a = [torch.from_numpy(f) for f in a]
        b = [torch.from_numpy(f) for f in b]
        fresh = gm.init_state(rtype, (8, 8), device="cpu")
        assert all(isinstance(f, torch.Tensor) for f in fresh)
        assert all(np.array_equal(f.numpy(), g, equal_nan=True) for f, g in
                   zip(fresh, gm.init_state(rtype, (8, 8))))
    merged = gm.merge_state(rtype, a, b)
    out_m = np.asarray(gm.finalize_state(rtype, merged))
    out_j = np.asarray(gm.finalize_state(rtype, joint))
    np.testing.assert_allclose(np.where(np.isnan(out_m), 0, out_m),
                               np.where(np.isnan(out_j), 0, out_j),
                               atol=1e-5, err_msg=str(rtype))
    assert np.array_equal(out_m, np.asarray(want), equal_nan=True)


@pytest.mark.parametrize("on", ["numpy", "torch"])
def test_shape_mismatch_raises(on):
    from pcr_tpu_torch.engine import grid_merge as gm
    dev = "cpu" if on == "torch" else None
    a = gm.init_state(RT.Sum, (4, 4), device=dev)
    b = gm.init_state(RT.Sum, (4, 5), device=dev)
    with pytest.raises(ValueError):
        gm.merge_state(RT.Sum, a, b)
    with pytest.raises(ValueError):
        gm.merge_state(RT.Average, a, a)       # state_floats mismatch

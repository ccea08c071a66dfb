"""Multi-device meshes of the PyTorch port (pcr_tpu_torch/parallel/engine.py)
against pcr_tpu's mesh engines and the numpy oracle.

pcr_tpu runs its meshes on the 8 virtual CPU devices tests/conftest.py
forces, its Pallas kernels off or in interpret mode as its own mesh tests
run them; the port runs `mesh_devices=8` as 8 row shards on torch-CPU
(PCR_TORCH_DEVICE=cpu), where K1-K5 take their plain versions. The same
seeded clouds go through both and through the oracle:

  * sum-family bands within 1e-5 (absolute, plus 1e-5 of the oracle's
    value) of the oracle, with an exact NaN footprint, and within the
    absolute bar pcr_tpu's own test sets (1e-5, 2e-5 for Gaussians) of
    pcr_tpu; Max, Min, MostRecent and Median exact against the oracle;
  * the fuzz cases at tests/test_fuzz_parity.py's bar (2e-5 + 2e-5 |x|).

The first block twins each test of tests/test_pipeline_sharded.py (same
name); the rest holds what the port's design adds: dp merges in a fixed
order (bit-identical reruns, a cell every dp cell hits, MostRecent ties),
Hybrid workers, staging from many threads, device lists and the Gaussian
flush at the state exits.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_cloud, make_grid_config
from pcr_tpu_torch.engine import pipeline as port_pipeline
from pcr_tpu_torch.engine import routing as port_routing
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from pcr_tpu_torch.parallel import sharding
from pcr_tpu_torch.parallel.engine import (PartitionedTorchEngine,
                                           ShardedTorchEngine,
                                           resolve_mesh_devices)
from test_fuzz_parity import MESH_POINT_TYPES, fuzz_cloud, random_spec
from test_torch_pipeline import like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
TOL = 1e-5
SUM_FAMILY = (RT.Sum, RT.Average, RT.Count, RT.WeightedAverage)


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def run(pkg, mode, gc, specs, clouds, staged=False, twice=False, **cfg):
    p = pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, gc), reductions=like(pkg, specs),
        exec_mode=like(pkg, mode), **cfg))
    for c in like(pkg, clouds):
        src = p.stage(c) if staged else c
        p.ingest(src)
        if twice:
            p.ingest(src)       # staged chunks are reusable
    p.finalize()
    return p, [p.result().band_array(i).copy() for i in range(len(specs))]


def mesh(sp=2, **cfg):
    return dict(mesh_devices=8, mesh_sp=sp, **cfg)


def near(got, want, atol, rtol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (atol + rtol * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


def hold(got, jax_bands, oracle, specs, atol=TOL):
    """The port's bands against the oracle (1e-5, exact where the op is
    order-free) and against pcr_tpu's mesh at pcr_tpu's own bar."""
    for g, j, o, s in zip(got, jax_bands, oracle, specs):
        if s.type in SUM_FAMILY:
            near(g, o, TOL)
            near(g, j, atol, rtol=0.0)
        else:
            assert np.array_equal(g, o, equal_nan=True)
            assert np.array_equal(g, j, equal_nan=True)


def twin(gc, specs, clouds, atol=TOL, staged=False, **cfg):
    """The port's mesh pipeline, held against pcr_tpu's and the oracle;
    returns the port's pipeline and bands."""
    p, got = run(port, GPU, gc, specs, clouds, staged, **cfg)
    _, jax_bands = run(ref, GPU, gc, specs, clouds, staged, **cfg)
    _, oracle = run(ref, CPU, gc, specs, clouds)
    hold(got, jax_bands, oracle, specs, atol)
    return p, got


def point_specs():
    return [ref.ReductionSpec(value_channel="v", type=RT.Average),
            ref.ReductionSpec(value_channel="v", type=RT.Max),
            ref.ReductionSpec(value_channel="v", type=RT.MostRecent,
                              timestamp_channel="t")]


def gauss(**kw):
    return ref.gaussian_splat_spec("v", **kw)


def line(**kw):
    return ref.line_splat_spec("v", **kw)


ROT = dict(default_sigma_x=2.0, default_sigma_y=0.8, default_rotation=0.6,
           max_radius_cells=7.0)


def line_sum():
    s = line(direction_channel="d", default_half_length=4.0,
             max_radius_cells=8.0)
    s.type = RT.Sum
    return s


# name: (grid kwargs, specs, clouds, mesh kwargs, pcr_tpu's atol, Pallas)
CASES = {
    "point_glyph_all_families_match_cpu": (
        {}, point_specs,
        lambda: [make_cloud(5000, seed=s, channels=("v", "t"))
                 for s in (0, 1)], {}, TOL, None),
    "gaussian_glyph_matches_cpu": (
        {}, lambda: [gauss(default_sigma=1.5, max_radius_cells=6.0)],
        lambda: [make_cloud(3000, seed=2)], {}, 2e-5, None),
    "gaussian_rotated_matches_cpu": (
        {}, lambda: [gauss(**ROT)], lambda: [make_cloud(1500, seed=3)], {},
        2e-5, None),
    "gaussian_rotated_pallas_interpret_matches_cpu": (
        {}, lambda: [gauss(**ROT)], lambda: [make_cloud(1500, seed=3)], {},
        2e-5, "interpret"),
    "line_glyph_matches_cpu": (
        {}, lambda: [line_sum()],
        lambda: [make_cloud(2000, seed=4, channels=("v", "d"))], {}, TOL,
        None),
    "multi_tile_home_clip_matches_cpu": (
        dict(tile=32), lambda: [gauss(default_sigma=2.0, max_radius_cells=8.0),
                                line(default_direction=0.7,
                                     default_half_length=5.0)],
        lambda: [make_cloud(2500, seed=5)], {}, 2e-5, None),
    "multi_tile_point_families_match_cpu": (
        dict(tile=32), point_specs,
        lambda: [make_cloud(5000, seed=20, channels=("v", "t"))], {}, TOL,
        None),
    "multi_tile_pallas_interpret_matches_cpu": (
        dict(tile=32), lambda: [gauss(default_sigma=2.0, max_radius_cells=8.0),
                                gauss(**ROT),
                                line(default_direction=0.7,
                                     default_half_length=5.0)],
        lambda: [make_cloud(1500, seed=22)], {}, 2e-5, "interpret"),
    "more_devices_than_rows": (
        dict(w=64.0, h=5.0, tile=2),
        lambda: [ref.ReductionSpec(value_channel="v", type=RT.Average)],
        lambda: [make_cloud(500, seed=26, w=64.0, h=5.0)], {}, TOL, None),
    "odd_grid_height_pads_rows": (
        dict(w=64.0, h=37.0),
        lambda: [ref.ReductionSpec(value_channel="v", type=RT.Sum)],
        lambda: [make_cloud(2000, seed=6, w=64.0, h=37.0)], dict(sp=4), TOL,
        None),
    "collective_free_sp_only_mesh_matches_cpu": (
        {}, lambda: [ref.ReductionSpec(value_channel="v", type=RT.Average),
                     gauss(default_sigma=1.5, max_radius_cells=6.0),
                     line(default_direction=0.7, default_half_length=4.0,
                          max_radius_cells=8.0)],
        lambda: [make_cloud(4000, seed=11)], dict(sp=8), 2e-5, None),
    "median_on_mesh_matches_cpu": (
        {}, lambda: [ref.ReductionSpec(value_channel="v", type=RT.Median),
                     ref.ReductionSpec(value_channel="v", type=RT.Average)],
        lambda: [make_cloud(3000, seed=12), make_cloud(1000, seed=13)], {},
        TOL, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_sharded_twin(name, monkeypatch):
    """tests/test_pipeline_sharded.py::test_<name> on both packages."""
    grid_kw, specs, clouds, mesh_kw, atol, pallas = CASES[name]
    if pallas:
        monkeypatch.setenv("PCR_PALLAS", pallas)
    gc = make_grid_config(**grid_kw)
    p, _ = twin(gc, specs(), clouds(), atol, **mesh(**mesh_kw))
    want = ShardedTorchEngine if gc.total_tiles() == 1 else \
        PartitionedTorchEngine
    assert type(p._engine) is want


def test_sharded_pipeline_uses_sharded_engine():
    gc = make_grid_config()
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, point_specs()),
        exec_mode=port.ExecutionMode.GPU, **mesh()))
    assert isinstance(p._engine, ShardedTorchEngine)
    assert p._engine.mesh.shape == {"dp": 4, "sp": 2}
    assert all(d == torch.device("cpu") for d in p._engine.mesh.devices.flat)


def test_multi_tile_uses_partitioned_engine():
    """Engine choice by total_tiles(), and a shard stages only the entries
    its rows hold: a bottom-rows-only cloud stages on the last shard."""
    gc = make_grid_config(tile=32)
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, point_specs()),
        exec_mode=port.ExecutionMode.GPU, **mesh()))
    eng = p._engine
    assert isinstance(eng, PartitionedTorchEngine) and eng.nshards == 8
    staged = eng.prepare_point(
        0, np.zeros(4, np.int64) + (gc.height - 1) * gc.width,
        np.ones(4, bool), np.ones(4, np.float32))
    assert [s for s, _ in staged] == [eng.nshards - 1]


def test_memory_budget_with_mesh_raises_typed_error():
    gc = make_grid_config()
    with pytest.raises(port.PcrError) as e:
        port.Pipeline.create(port.PipelineConfig(
            grid=like(port, gc), reductions=like(port, point_specs()),
            exec_mode=port.ExecutionMode.GPU, gpu_memory_budget=1 << 20,
            **mesh()))
    assert e.value.status.code == port.StatusCode.InvalidArgument
    assert "mesh" in str(e.value)


@pytest.mark.parametrize("tile", [4096, 32], ids=["one_tile", "multi_tile"])
def test_staged_ingest_matches_cpu(tile):
    """stage() -> ingest over the mesh (test_staged_ingest_matches_cpu);
    on the tiled grid each staged cloud twice (test_multi_tile_staged_
    ingest_matches_cpu: staged chunks are reusable)."""
    gc = make_grid_config(tile=tile)
    if tile == 4096:
        twin(gc, [ref.ReductionSpec(value_channel="v", type=RT.Average)],
             [make_cloud(4000, seed=7)], staged=True, **mesh())
        return
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Sum)]
    cloud = make_cloud(3000, seed=25)
    _, got = run(port, GPU, gc, specs, [cloud], staged=True, twice=True,
                 **mesh())
    _, jax_bands = run(ref, GPU, gc, specs, [cloud], staged=True,
                       twice=True, **mesh())
    _, oracle = run(ref, CPU, gc, specs, [cloud, cloud])
    hold(got, jax_bands, oracle, specs, 2e-5)


def test_multi_tile_resume_roundtrip(tmp_path):
    gc = make_grid_config(tile=32)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Max)]
    c1, c2 = make_cloud(2000, seed=23), make_cloud(2000, seed=24)
    _, oracle = run(ref, CPU, gc, specs, [c1, c2])
    state = str(tmp_path / "state")
    run(port, GPU, gc, specs, [c1], **mesh(state_dir=state))
    p, got = run(port, GPU, gc, specs, [c2], **mesh(state_dir=state,
                                                    resume=True))
    assert isinstance(p._engine, PartitionedTorchEngine)
    assert np.array_equal(got[0], oracle[0], equal_nan=True)


def test_resume_and_geotiff_roundtrip(tmp_path):
    """ingest -> checkpoint -> a new mesh pipeline resumes -> finalize ->
    GeoTIFF, against the one-shot oracle and pcr_tpu's mesh doing the
    same; the port resumes pcr_tpu's checkpoint too."""
    gc = make_grid_config()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average),
             ref.ReductionSpec(value_channel="v", type=RT.Max)]
    c1, c2 = make_cloud(3000, seed=8), make_cloud(3000, seed=9)
    _, oracle = run(ref, CPU, gc, specs, [c1, c2])
    bands = {}
    for name, pkg in (("port", port), ("jax", ref)):
        state = str(tmp_path / name / "state")
        tif = str(tmp_path / name / "out.tif")
        run(pkg, GPU, gc, specs, [c1], **mesh(state_dir=state))
        _, bands[name] = run(pkg, GPU, gc, specs, [c2], **mesh(
            state_dir=state, resume=True, output_path=tif))
        for i, band in enumerate(bands[name]):
            assert np.array_equal(ref.read_geotiff_band(tif, i), band,
                                  equal_nan=True)
    hold(bands["port"], bands["jax"], oracle, specs)
    state = str(tmp_path / "jax_c1")
    run(ref, GPU, gc, specs, [c1], **mesh(state_dir=state))
    _, across = run(port, GPU, gc, specs, [c2], **mesh(state_dir=state))
    hold(across, bands["jax"], oracle, specs)


def test_progress_and_stats_on_mesh():
    gc = make_grid_config()
    seen = []
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc),
        reductions=like(port, [ref.ReductionSpec(value_channel="v",
                                                 type=RT.Sum)]),
        exec_mode=port.ExecutionMode.GPU, **mesh()))
    p.set_progress_callback(lambda info: (seen.append(info), True)[1])
    p.ingest(like(port, make_cloud(1000, seed=10)))
    assert seen and seen[0].points_processed == 1000


def straddlers(n=400, seed=31):
    """A 64 x 1024 grid of 32-cell tiles and centres just below the borders
    of 128-row shards (global rows 128 k + 0.2 ... 4), so every footprint
    reaches into the shard above."""
    bbox = ref.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, 64.0, 1024.0
    gc = ref.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.tile_width = gc.tile_height = 32
    gc.crs = ref.CRS.from_epsg(3857)
    gc.compute_dimensions()
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, 64, n))
    rows = rng.integers(1, 8, n) * 128 + rng.uniform(0.2, 4.0, n)
    c.set_y_array(1024.0 - rows)
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", rng.normal(0, 1, n).astype(np.float32))
    return gc, c


def test_rotp_shard_boundary_straddler(monkeypatch):
    """Rotated Gaussians whose home tile lies in the shard below a border
    stage as dead windows in the shard above (K5's layout, both routes),
    never clamped into it: the mesh's band is the resident engine's bit
    for bit, and both packages' meshes hold the oracle's band within
    pcr_tpu's mesh bar, 2e-5 (rows near 1000, sigma 0.7, values of both
    signs). Before K4 / K5 formed the distance to the centre from the
    integer row difference, the port read 1.65e-4 here (pcr_tpu's
    resident K5 4.3e-4: a float32 centre offset rounded near row 1000)
    and was held to 2e-4 (ROADMAP Queue 3, repaired)."""
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    gc, c = straddlers()
    spec = gauss(default_sigma_x=1.2, default_sigma_y=0.7,
                 default_rotation=0.5, max_radius_cells=4.0)
    p, (got,) = run(port, GPU, gc, [spec], [c], **mesh())
    _, (resident,) = run(port, GPU, gc, [spec], [c])
    _, (jax_band,) = run(ref, GPU, gc, [spec], [c], **mesh())
    _, (oracle,) = run(ref, CPU, gc, [spec], [c])
    assert np.array_equal(got.view(np.int32), resident.view(np.int32))
    near(jax_band, oracle, 2e-5, rtol=0.0)
    near(got, oracle, 2e-5, rtol=0.0)
    eng = p._engine
    assert eng.local_rows == 128
    # every shard but the first holds centres in its top rows, and every
    # shard but the last the straddlers whose footprints reach up into it:
    # each live K5 window there has its centre in the shard's own rows
    gp = port_routing.gaussian_params(like(port, spec).glyph, eng.cfg,
                                      c.x_array(), c.y_array(), None, None,
                                      None)
    for wire_cheap in (False, True):
        staged = eng.prepare_gaussian(0, gp, np.ones(c.count(), bool),
                                      np.ones(c.count(), np.float32),
                                      wire_cheap=wire_cheap)
        assert [s for s, _ in staged] == list(range(8))
        for s, chunks in staged:
            for ch in chunks:
                assert ch.kind == "rotp"
                live = ch.params[:, 6] <= ch.params[:, 7]
                cy = (ch.params[:, 11] + ch.params[:, 1])[live]  # icy + sub
                assert bool(((cy > -1) & (cy < 128)).all()), s


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_one_tile_shard_view_is_the_resident_engine(dp, sp):
    """A one-tile grid's shard view clips a footprint to the shard's rows
    only (pcr_tpu makes each shard its own tile); footprints that cross
    the borders of 32-row shards give the resident engine's band, bit for
    bit at dp = 1 on the CPU (a cell's terms arrive in the same order),
    within 1e-5 with dp > 1, both routes."""
    gc = make_grid_config(w=96.0, h=128.0)
    specs = [gauss(default_sigma=3.0, max_radius_cells=10.0),
             gauss(default_sigma_x=4.0, default_sigma_y=1.5,
                   default_rotation=0.6, max_radius_cells=16.0),
             gauss(default_sigma_x=8.0, default_sigma_y=3.0,
                   default_rotation=0.6, max_radius_cells=24.0),
             line(default_direction=1.2, default_half_length=12.0)]
    for s in specs:
        s.type = RT.Average
    clouds = [make_cloud(1500, seed=41, w=96.0, h=128.0)]
    _, resident = run(port, GPU, gc, specs, clouds)
    for staged in (False, True):
        p, got = run(port, GPU, gc, specs, clouds, staged,
                     mesh_devices=["cpu"] * dp * sp, mesh_dp=dp, mesh_sp=sp)
        assert p._engine.local_rows == 128 // sp
        for g, r in zip(got, resident):
            if dp == 1:
                assert np.array_equal(g.view(np.int32), r.view(np.int32))
            else:
                near(g, r, TOL)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_mesh_pipeline(seed):
    """tests/test_fuzz_parity.py::test_fuzz_mesh_pipeline on the port: the
    same random grid, spec mix, clouds and (dp, sp) split, against the
    oracle and pcr_tpu's mesh at the fuzz bar."""
    rng = np.random.default_rng(3000 + seed)
    w = float(rng.integers(40, 130))
    h = float(rng.integers(40, 130))
    tile = int(rng.choice([4096, 32, 48]))
    gc = make_grid_config(w=w, h=h, tile=tile)
    specs = []
    for _ in range(int(rng.integers(1, 4))):
        if rng.random() < 0.4:
            t = MESH_POINT_TYPES[rng.integers(len(MESH_POINT_TYPES))]
            specs.append(ref.ReductionSpec(
                value_channel="v", type=t,
                timestamp_channel="ts" if t == RT.MostRecent else ""))
        else:
            specs.append(random_spec(rng))
    clouds = [fuzz_cloud(rng, w, h, int(rng.integers(800, 3000)))
              for _ in range(int(rng.integers(1, 3)))]
    dp, sp = [(1, 8), (2, 4), (4, 2), (8, 1)][seed % 4]
    kw = dict(mesh_devices=8, mesh_dp=dp, mesh_sp=sp)
    _, got = run(port, GPU, gc, specs, clouds, **kw)
    _, jax_bands = run(ref, GPU, gc, specs, clouds, **kw)
    _, oracle = run(ref, CPU, gc, specs, clouds)
    for g, j, o in zip(got, jax_bands, oracle):
        near(g, o, 2e-5, 2e-5)
        near(g, j, 2e-5, 2e-5)


def adversarial(n=6000, seed=51, w=64.0, h=64.0):
    """Values over eight decades and both signs, integer timestamps with
    ties (tests/test_determinism.py's kind of cloud)."""
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    for name, arr in (("v", rng.normal(0, 1, n)
                       * 10.0 ** rng.integers(-4, 5, n)),
                      ("t", rng.integers(0, 6, n))):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def test_reruns_are_bit_identical():
    """dp = 4, sp = 2: every dp merge folds the cells in dp order, so two
    runs give the same bits (tests/test_determinism.py's bar)."""
    gc = make_grid_config(w=64.0, h=64.0)
    specs = point_specs() + [gauss(default_sigma=2.0, max_radius_cells=8.0),
                             line(default_direction=0.4,
                                  default_half_length=6.0)]
    clouds = [adversarial()]
    kw = dict(mesh_devices=8, mesh_dp=4, mesh_sp=2)
    _, a = run(port, GPU, gc, specs, clouds, **kw)
    _, b = run(port, GPU, gc, specs, clouds, staged=True, **kw)
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


def test_a_cell_every_dp_cell_hits():
    """800 points in one cell, split over 8 dp cells: each cell's delta
    holds 100 of them, and the merge gives the oracle's sum, max and
    MostRecent (ties across dp cells: the earliest point wins)."""
    gc = make_grid_config(w=16.0, h=16.0)
    rng = np.random.default_rng(61)
    n = 800
    c = ref.PointCloud.create(n)
    c.set_x_array(np.full(n, 5.5))
    c.set_y_array(np.full(n, 9.5))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", rng.normal(0, 1, n).astype(np.float32))
    c.add_channel("t", ref.DataType.Float32)
    c.set_channel_array_f32("t", rng.integers(0, 3, n).astype(np.float32))
    specs = point_specs() + [ref.ReductionSpec(value_channel="v",
                                               type=RT.Sum)]
    kw = dict(mesh_devices=8, mesh_dp=8, mesh_sp=1)
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, **kw))
    (step,) = p.stage(like(port, c)).per_spec[0]
    assert [len(per_d) for per_d in step.cells] == [8]
    assert all(chunks for chunks in step.cells[0])
    twin(gc, specs, [c], **kw)


def test_most_recent_ties_across_dp_cells_and_the_state():
    """MostRecent and PriorityMerge with timestamps of few values: ties
    inside a dp cell (earliest point), across dp cells (lowest dp index,
    i.e. the earliest point again) and against the state of an earlier
    cloud (the state wins), exact against the oracle."""
    gc = make_grid_config(w=24.0, h=24.0)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.MostRecent,
                               timestamp_channel="t"),
             ref.ReductionSpec(value_channel="v", type=RT.PriorityMerge,
                               priority_channel="t")]
    clouds = [adversarial(3000, seed=s, w=24.0, h=24.0) for s in (71, 72)]
    for dp, sp in ((8, 1), (4, 2), (2, 4)):
        twin(gc, specs, clouds, mesh_devices=8, mesh_dp=dp, mesh_sp=sp)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_hybrid_workers_give_gpu_mode_bits(workers):
    """Hybrid mode with 1, 2 or 4 workers stages chunks on worker threads
    while the mesh commits; at one chunk_size its bands are GPU mode's bit
    for bit."""
    gc = make_grid_config()
    specs = point_specs() + [gauss(default_sigma=1.5, max_radius_cells=6.0),
                             line(default_direction=0.7,
                                  default_half_length=4.0)]
    clouds = [make_cloud(4000, seed=81, channels=("v", "t"))]
    kw = dict(mesh_devices=8, mesh_dp=2, mesh_sp=4, chunk_size=700)
    _, want = run(port, GPU, gc, specs, clouds, **kw)
    _, got = run(port, ref.ExecutionMode.Hybrid, gc, specs, clouds,
                 hybrid_cpu_threads=workers, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("tile", [4096, 32], ids=["sharded", "partitioned"])
def test_staging_from_many_threads_shares_nothing(tile):
    """Twelve threads staging their own clouds through one mesh engine at
    once, the interpreter switching often, get the chunks a lone thread
    gets (the mesh engines' routing writes nothing on the engine)."""
    gc = make_grid_config(tile=tile)
    specs = point_specs() + [gauss(default_sigma=1.5, max_radius_cells=6.0),
                             gauss(**ROT), line(default_half_length=3.0)]
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.Hybrid,
        mesh_devices=8, mesh_dp=2, mesh_sp=4))
    clouds = [like(port, make_cloud(500, seed=90 + k, channels=("v", "t")))
              for k in range(12)]

    def flat(staged):
        out = []
        for item in staged:
            groups = item.cells if hasattr(item, "cells") else [[item[1]]]
            for per_d in groups:
                for chunks in per_d:
                    out += [(ch.kind, ch.params.clone(), None
                             if ch.bids is None else ch.bids.clone())
                            for ch in chunks]
        return out

    def stage(c):
        return [flat(per) for per in p.stage(c).per_spec]

    want = [stage(c) for c in clouds]
    got, errors = [None] * len(clouds), []

    def work(k):
        try:
            for _ in range(2):
                got[k] = stage(clouds[k])
        except Exception as e:                   # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(clouds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            assert len(gs) == len(ws) and gs
            for (gk, gp, gb), (wk, wp, wb) in zip(gs, ws):
                assert gk == wk and torch.equal(gp.view(torch.int32),
                                                wp.view(torch.int32))
                assert (gb is None) == (wb is None)
                assert gb is None or torch.equal(gb, wb)


def test_device_lists(monkeypatch):
    """An int takes the first n CUDA devices and raises past the count; the
    PCR_TORCH_DEVICE device serves any count; an explicit list may repeat
    a device (several shards on one card); dp * sp must be the count."""
    assert resolve_mesh_devices(None) is None
    assert resolve_mesh_devices(3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="at least one"):
        resolve_mesh_devices(0)
    assert resolve_mesh_devices(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    monkeypatch.delenv("PCR_TORCH_DEVICE")
    monkeypatch.setattr(sharding, "cuda_device_count", lambda: 1)
    assert resolve_mesh_devices(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="only 1 devices"):
        resolve_mesh_devices(2)
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    gc = make_grid_config()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(2000, seed=95)]
    _, oracle = run(ref, CPU, gc, specs, clouds)
    p, got = run(port, GPU, gc, specs, clouds, mesh_devices=["cpu"] * 6,
                 mesh_dp=3)
    assert p._engine.mesh.shape == {"dp": 3, "sp": 2}
    near(got[0], oracle[0], TOL)
    with pytest.raises(ValueError, match="dp"):
        run(port, GPU, gc, specs, clouds, mesh_devices=6, mesh_dp=4)
    # dp and sp with no list: dp * sp devices
    p, _ = run(port, GPU, gc, specs, clouds, mesh_dp=2, mesh_sp=2)
    assert p._engine.mesh.shape == {"dp": 2, "sp": 2}


def test_no_card_raises_cuda_error(monkeypatch):
    """A mesh on the device path without a card raises CudaError, like
    every other device mode."""
    monkeypatch.delenv("PCR_TORCH_DEVICE")
    monkeypatch.setattr(port_pipeline, "cuda_device_available", lambda: False)
    with pytest.raises(port.PcrError) as e:
        run(port, GPU, make_grid_config(),
            [ref.ReductionSpec(value_channel="v", type=RT.Average)], [],
            **mesh())
    assert e.value.status.code == port.StatusCode.CudaError


@pytest.mark.parametrize("dp", [1, 2])
def test_fetch_state_flushes_gaussian_residues(dp):
    """A Gaussian weight sum under GAUSS_WMIN in a shard's state is zeroed
    at every state exit (fetch_state, finalize), and a dp merge is not one:
    the owner's state keeps the residue after a merge."""
    gc = like(port, make_grid_config(w=64.0, h=64.0))
    spec = like(port, gauss(default_sigma=1.0, max_radius_cells=3.0))
    spec.type = port.ReductionType.Average
    plans = [(spec, port.get_reduction_info(spec.type))]
    eng = ShardedTorchEngine(gc, plans, devices=["cpu"] * 2 * dp, dp=dp,
                             sp=2)
    fields = [np.zeros((64, 64), np.float32) for _ in range(2)]
    fields[0][40, 5], fields[1][40, 5] = 1e-7, 1e-7     # a residue, shard 1
    fields[0][41, 6], fields[1][41, 6] = 3.0, 1.5       # data, shard 1
    eng.load_state(0, fields)
    rng = np.random.default_rng(96)
    x, y = rng.uniform(30, 64, 200), rng.uniform(0, 64, 200)
    gp = port_routing.gaussian_params(spec.glyph, gc, x, y, None,
                                             None, None)
    eng.commit(0, eng.prepare_gaussian(0, gp, np.ones(200, bool),
                                       np.ones(200, np.float32)))
    raw = eng.owners[1].states(0)
    assert float(raw[1][40 - 32, 5]) == np.float32(1e-7)
    got = eng.fetch_state(0)
    assert got[0][40, 5] == 0.0 and got[1][40, 5] == 0.0
    assert got[1][41, 6] >= 1.5
    band = eng.finalize_to_host(0)[0]
    assert np.isnan(band[40, 5]) and band[41, 6] > 0


def test_cell_engines_share_one_arena_per_device():
    """Shards on one device share its staging arena (pinned buffers and a
    copy stream): 2 x 4 cells on one device, one arena."""
    gc = like(port, make_grid_config())
    plans = [(s, port.get_reduction_info(s.type))
             for s in like(port, point_specs())]
    eng = ShardedTorchEngine(gc, plans, devices=["cpu"] * 8, dp=2, sp=4)
    arenas = {id(e._arena) for row in eng.cells for e in row}
    arenas |= {id(e._arena) for e in eng.owners}
    assert len(arenas) == 1
    assert all(isinstance(e, TorchEngine) for e in eng.owners)
    assert eng.cells[1][0] is not eng.owners[0]


def test_cpu_mode_ignores_the_mesh():
    """ExecutionMode.CPU runs the numpy oracle whatever the mesh settings,
    as pcr_tpu does."""
    gc = make_grid_config()
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(2000, seed=97)]
    p, got = run(port, CPU, gc, specs, clouds, mesh_sp=2)
    _, want = run(ref, CPU, gc, specs, clouds, mesh_sp=2)
    assert p._engine is None
    assert np.array_equal(got[0], want[0], equal_nan=True)

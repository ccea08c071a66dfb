"""tests/test_pipeline.py on the port: exact values, the lifecycle,
validation, corrupt state, Hybrid mode, PriorityMerge, warmup and a
multi-chunk ingest.

The same inputs (four points with known cells on a 10 x 10 grid, and
seeded clouds) go through the port and through pcr_tpu. The exact values
hold in CPU mode and on the device path (the port's on torch-CPU,
PCR_TORCH_DEVICE=cpu; pcr_tpu's on the JAX CPU backend), and the two
packages' bands are equal; validation raises PcrError with the same
message in both. pcr_tpu's multi-chunk test holds its fused jit commit,
which the port does not carry over: its twin is an ingest that
`chunk_size` cuts into at least three chunks, against the oracle.
"""

import os

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_cloud, make_grid_config
from test_torch_parity import bands, devices, make  # noqa: F401
from test_torch_pipeline import assert_close, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
MODES = pytest.mark.parametrize("mode", [CPU, GPU], ids=["CPU", "GPU"])


def known_cloud():
    """4 points with known cells on a 10x10 grid (cell 1.0, north-up):
    (1.5, 9.5) and (1.7, 9.2) -> cell (1, 0); (5.5, 5.5) -> (5, 4);
    (9.5, 0.5) -> (9, 9)."""
    c = ref.PointCloud.create(4)
    c.set_x_array(np.array([1.5, 1.7, 5.5, 9.5]))
    c.set_y_array(np.array([9.5, 9.2, 5.5, 0.5]))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", np.array([2.0, 4.0, 10.0, -1.0], np.float32))
    return c


def sum_spec(rtype=RT.Sum, **kw):
    return ref.ReductionSpec(value_channel="v", type=rtype, **kw)


def both(mode, specs, clouds, gc=None, **cfg):
    """The port's pipeline and pcr_tpu's, each run on `clouds`; their
    bands must be equal."""
    gc = gc or make_grid_config(w=10.0, h=10.0)
    out = []
    for pkg in (port, ref):
        p = make(pkg, mode, specs, gc, **cfg)
        for c in like(pkg, clouds):
            p.ingest(c)
        p.finalize()
        out.append(p)
    for i in range(len(specs)):
        assert np.array_equal(out[0].result().band_array(i),
                              out[1].result().band_array(i), equal_nan=True)
    return out


@MODES
def test_sum_exact(mode):
    for p in both(mode, [sum_spec()], [known_cloud()]):
        band = p.result().band_array(0)
        assert band[0, 1] == 6.0          # 2 + 4
        assert band[4, 5] == 10.0
        assert band[9, 9] == -1.0
        assert band[0, 0] == 0.0          # empty cell of a touched tile


@MODES
def test_sum_untouched_tiles_nan(mode):
    c = ref.PointCloud.create(1)
    c.set_x_array(np.array([1.5]))
    c.set_y_array(np.array([9.5]))        # cell (1, 0): tile (0, 0)
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", np.array([2.0], np.float32))
    for p in both(mode, [sum_spec()], [c],
                  make_grid_config(w=10.0, h=10.0, tile=5)):
        band = p.result().band_array(0)
        assert band[0, 1] == 2.0 and band[0, 0] == 0.0
        assert np.isnan(band[9, 9]) and np.isnan(band[0, 7])


@MODES
def test_average_exact(mode):
    for p in both(mode, [sum_spec(RT.Average)], [known_cloud()]):
        band = p.result().band_array(0)
        assert band[0, 1] == 3.0 and np.isnan(band[5, 5])


@MODES
def test_multi_reduction(mode):
    specs = [sum_spec(), sum_spec(RT.Max),
             sum_spec(RT.Count, output_band_name="npts")]
    for p in both(mode, specs, [known_cloud()]):
        g = p.result()
        assert g.num_bands() == 3
        assert g.band_desc(0).name == f"v_{int(RT.Sum)}"
        assert g.band_desc(2).name == "npts"
        assert [g.band_array(i)[0, 1] for i in range(3)] == [6.0, 4.0, 2.0]


@MODES
def test_multi_cloud_accumulation(mode):
    for p in both(mode, [sum_spec()], [known_cloud(), known_cloud()]):
        assert p.result().band_array(0)[0, 1] == 12.0
        assert p.stats().collections_processed == 2
        assert p.stats().points_processed == 8


@MODES
def test_out_of_bounds_points_dropped(mode):
    c = ref.PointCloud.create(2)
    c.set_x_array(np.array([50.0, 5.0]))
    c.set_y_array(np.array([5.0, 5.0]))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", np.array([1.0, 1.0], np.float32))
    for p in both(mode, [sum_spec(RT.Count)], [c]):
        assert p.stats().points_processed == 1
        assert np.nansum(p.result().band_array(0)) == 1.0


def test_result_none_before_finalize():
    for pkg in (port, ref):
        p = make(pkg, GPU, [sum_spec()], make_grid_config(w=10.0, h=10.0))
        assert p.result() is None
        p.ingest(like(pkg, known_cloud()))
        assert p.result() is None


def test_run_convenience():
    for pkg in (port, ref):
        p = make(pkg, GPU, [sum_spec()], make_grid_config(w=10.0, h=10.0))
        p.run(like(pkg, [known_cloud(), known_cloud()]))
        assert p.result().band_array(0)[0, 1] == 12.0


def test_geotiff_output(tmp_path):
    out = {}
    for pkg in (port, ref):
        path = str(tmp_path / f"{pkg.__name__}.tif")
        p = make(pkg, GPU, [sum_spec()], make_grid_config(w=10.0, h=10.0),
                 output_path=path)
        p.ingest(like(pkg, known_cloud()))
        p.finalize()
        assert port.read_geotiff_band(path, 0)[0, 1] == 6.0
        w, h, nb, crs, _ = port.read_geotiff_info(path)
        assert (w, h, nb) == (10, 10, 1) and crs.epsg == 3857
        out[pkg] = ref.read_geotiff_band(path, 0)
    # the codecs differ where a package lacks its native helper (DEFLATE
    # then), so the files are compared by their bands, not their bytes
    assert np.array_equal(out[port], out[ref], equal_nan=True)


def test_progress_callback():
    counts = []
    for pkg in (port, ref):
        p = make(pkg, GPU, [sum_spec()], make_grid_config(w=10.0, h=10.0))
        seen = []
        p.set_progress_callback(lambda info: (seen.append(info), True)[1])
        p.ingest(like(pkg, known_cloud()))
        p.ingest(like(pkg, known_cloud()))
        assert all(s.elapsed_seconds >= 0.0 for s in seen)
        counts.append([(s.collections_processed, s.points_processed,
                        s.tiles_active) for s in seen])
    assert counts[0] == counts[1]
    assert [c[:2] for c in counts[0]] == [(1, 4), (2, 8)]


def test_cancellation():
    for pkg in (port, ref):
        p = make(pkg, GPU, [sum_spec()], make_grid_config(w=10.0, h=10.0))
        p.set_progress_callback(lambda info: False)
        for _ in range(2):      # the first refusal, and every later one
            with pytest.raises(pkg.PcrError, match="cancelled"):
                p.ingest(like(pkg, known_cloud()))


def glyph_max():
    s = sum_spec(RT.Max)
    s.glyph.type = ref.GlyphType.Gaussian
    return s


# case: (a valid grid?, specs, the message PcrError must match)
VALIDATION = {
    "no_reductions": (True, [], "no reductions"),
    "invalid_grid": (False, [sum_spec()], None),
    "unregistered_reduction": (True, [sum_spec(RT.Custom)], "unregistered"),
    "glyph_with_unsupported_reduction": (True, [glyph_max()], "glyph"),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_create_validation(case):
    """Pipeline.create refuses the config with the same PcrError in both
    packages."""
    valid_grid, specs, msg = VALIDATION[case]
    gc = make_grid_config(w=10.0, h=10.0) if valid_grid else ref.GridConfig()
    messages = []
    for pkg in (port, ref):
        with pytest.raises(pkg.PcrError, match=msg) as e:
            make(pkg, GPU, specs, gc)
        messages.append((e.value.status.code.name, e.value.status.message))
    assert messages[0] == messages[1]


def test_missing_value_channel():
    messages = []
    for pkg in (port, ref):
        p = make(pkg, GPU, [ref.ReductionSpec(value_channel="nope",
                                              type=RT.Sum)],
                 make_grid_config(w=10.0, h=10.0))
        with pytest.raises(pkg.PcrError, match="not found") as e:
            p.ingest(like(pkg, known_cloud()))
        messages.append(e.value.status.message)
    assert messages[0] == messages[1]


@MODES
def test_count_without_value_channel_ok(mode):
    for p in both(mode, [ref.ReductionSpec(type=RT.Count)], [known_cloud()]):
        assert p.result().band_array(0)[0, 1] == 2.0


def test_corrupt_state_reinitialized(tmp_path):
    gc = make_grid_config(w=10.0, h=10.0)
    out = []
    for pkg in (port, ref):
        sd = str(tmp_path / pkg.__name__)
        p1 = make(pkg, GPU, [sum_spec()], gc, state_dir=sd)
        p1.ingest(like(pkg, known_cloud()))
        p1.finalize()
        for root, _, names in os.walk(sd):
            for n in names:
                with open(os.path.join(root, n), "wb") as f:
                    f.write(b"garbage")
        p2 = make(pkg, GPU, [sum_spec()], gc, state_dir=sd)
        p2.ingest(like(pkg, known_cloud()))
        p2.finalize()
        out.append(p2.result().band_array(0))
        assert out[-1][0, 1] == 6.0     # fresh, not resumed
    assert np.array_equal(out[0], out[1], equal_nan=True)


@pytest.mark.parametrize("workers", [0, 2])
def test_hybrid_matches_gpu_mode(workers):
    """Hybrid prepares chunks on the host while the device commits; its
    band is GPU mode's bit for bit, and pcr_tpu's Hybrid band within
    1e-5 (and the oracle's)."""
    gc = make_grid_config(w=50.0, h=50.0)
    clouds = [make_cloud(3000, seed=5, w=50.0, h=50.0), known_cloud()]
    specs = [sum_spec(), sum_spec(RT.Average)]
    kw = dict(hybrid_cpu_threads=workers, chunk_size=1000)
    gpu = bands(port, GPU, specs, clouds, gc, **kw)
    hybrid = bands(port, ref.ExecutionMode.Hybrid, specs, clouds, gc, **kw)
    jax_hybrid = bands(ref, ref.ExecutionMode.Hybrid, specs, clouds, gc)
    oracle = bands(ref, CPU, specs, clouds, gc)
    for g, h, j, o in zip(gpu, hybrid, jax_hybrid, oracle):
        assert np.array_equal(g.view(np.int32), h.view(np.int32))
        assert_close(h, j)
        assert_close(h, o)


def test_multichunk_ingest_matches_oracle():
    """chunk_size cuts a 10k-point cloud into 3+ chunks; staged and
    ingested twice, the band matches the oracle and pcr_tpu's device
    path (its fused multi-chunk commit)."""
    gc = make_grid_config(w=100.0, h=80.0)
    rng = np.random.default_rng(3)
    n = 10_000
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(-2, 102, n))
    c.set_y_array(rng.uniform(-2, 82, n))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", rng.normal(0, 1, n).astype(np.float32))
    specs = [sum_spec(RT.Average)]
    p = make(port, GPU, specs, gc, chunk_size=4096)
    staged = p.stage(like(port, c))
    assert len(staged.per_spec[0]) >= 3
    p.ingest(staged)
    p.ingest(staged)
    p.finalize()
    got = p.result().band_array(0)
    assert_close(got, bands(ref, CPU, specs, [c, c], gc)[0])
    assert_close(got, bands(ref, GPU, specs, [c, c], gc)[0])


@MODES
def test_priority_merge(mode):
    """The highest priority wins a cell; a tie keeps the first point."""
    c = ref.PointCloud.create(6)
    #                       cell0 cell0 cell1 cell1 cell2 cell2 (tie)
    c.set_x_array(np.array([0.5, 0.5, 1.5, 1.5, 2.5, 2.5]))
    c.set_y_array(np.full(6, 0.5))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", np.array([1, 2, 3, 4, 5, 6], np.float32))
    c.add_channel("prio", ref.DataType.Float32)
    c.set_channel_array_f32("prio", np.array([9, 1, 2, 8, 5, 5], np.float32))
    spec = sum_spec(RT.PriorityMerge, priority_channel="prio")
    for p in both(mode, [spec], [c], make_grid_config(w=4.0, h=1.0)):
        band = p.result().band_array(0)[0]
        assert list(band[:3]) == [1.0, 4.0, 5.0] and np.isnan(band[3])


def test_warmup_is_side_effect_free(tmp_path):
    """warmup() builds and starts what the device path needs without
    touching the pipeline's state, output or stats."""
    gc = make_grid_config()
    out = str(tmp_path / "warm.tif")
    spec = ref.gaussian_splat_spec("v", default_sigma=1.5)
    p = make(port, GPU, [spec], gc, output_path=out)
    p.warmup(chunk_points=64)
    assert p.stats().points_processed == 0
    assert not os.path.exists(out)
    cloud = make_cloud(500, seed=4, channels=("v",))
    p.ingest(like(port, cloud))
    p.finalize()
    cold = bands(port, GPU, [spec], [cloud], gc)[0]
    assert np.array_equal(p.result().band_array(0), cold, equal_nan=True)
    assert_close(cold, bands(ref, GPU, [spec], [cloud], gc)[0])

"""The port's own host layers against pcr_tpu's, of which they are copies.

The same seeded inputs, each built from its package's own types, go through
both packages: the numpy CPU oracle (Point, Gaussian and Line specs) gives
bit-identical bands; a GeoTIFF or a PCRT tile state written by one package
is read, or resumed, by the other with the same bytes; routing, the tiling
constants, the reduction registry, the native helpers and point-cloud I/O
agree; the port's Grid keeps Device bands in torch tensors; and the
test-data generators, raster comparison, rendering, rasterio bridge and
phase timer agree, with the port's trace() on torch.profiler.
"""

import os

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu.engine import routing as ref_routing
from pcr_tpu.engine.pallas_kernels import (col_tile, gauss_col_tile,
                                           gauss_row_block, padded_width,
                                           rect_col_tile)
from pcr_tpu.engine.tpu_backend import (GAUSS_WMIN, ROT_COL_TILE,
                                        ROT_ROW_BLOCK, ROTP_RMAX,
                                        ROTP_ROW_BLOCK, TpuEngine,
                                        gauss_corr_offsets,
                                        gauss_product_cutoff_bites)
from pcr_tpu_torch.engine import routing as port_routing
from pcr_tpu_torch.engine import tiling
from test_torch_pipeline import like

RT = ref.ReductionType
CPU = ref.ExecutionMode.CPU
PACKAGES = {"jax": ref, "torch": port}
OTHER = {"jax": port, "torch": ref}


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def grid():
    return make_grid_config(w=120.0, h=90.0, tile=64)


def cloud(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(-3, 123, n))
    c.set_y_array(rng.uniform(-3, 93, n))
    for name, arr in (("v", rng.normal(0, 10, n)), ("w", rng.uniform(.1, 2, n)),
                      ("ts", rng.integers(0, 9, n)),
                      ("dir", rng.uniform(-np.pi, np.pi, n)),
                      ("hl", rng.uniform(0.5, 6.0, n)),
                      ("sig", rng.uniform(0.5, 3.0, n))):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def spec(case):
    if case.startswith("point_"):
        rtype = RT[case[len("point_"):]]
        s = ref.ReductionSpec(value_channel="v", type=rtype,
                              weight_channel="w", timestamp_channel="ts",
                              priority_channel="ts")
    elif case == "gauss_rotated":
        s = ref.gaussian_splat_spec("v", default_sigma_x=2.0,
                                    default_sigma_y=0.8, default_rotation=0.5)
    elif case == "gauss_channels":
        s = ref.gaussian_splat_spec("v", sigma_x_channel="sig",
                                    sigma_y_channel="sig")
        s.type = RT.Sum
    elif case == "line_channels":
        s = ref.line_splat_spec("v", direction_channel="dir",
                                half_length_channel="hl")
        s.type = RT.Average
    else:
        s = ref.line_splat_spec("v", default_direction=0.7,
                                default_half_length=4.0)
        s.type = RT.Count
    return s


def run(pkg, specs, clouds, **cfg):
    p = pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, grid()), reductions=like(pkg, specs),
        exec_mode=like(pkg, CPU), **cfg))
    for c in like(pkg, clouds):
        p.ingest(c)
    p.finalize()
    return p, [p.result().band_array(i).copy() for i in range(len(specs))]


@pytest.mark.parametrize("case", [
    "point_Sum", "point_Average", "point_WeightedAverage", "point_Count",
    "point_Max", "point_Min", "point_MostRecent", "point_PriorityMerge",
    "point_Median", "gauss_rotated", "gauss_channels", "line_channels",
    "line_count"])
def test_oracles_agree_bit_for_bit(case):
    specs = [spec(case)]
    clouds = [cloud(seed=1), cloud(seed=2)]
    (_, a), (_, b) = run(ref, specs, clouds), run(port, specs, clouds)
    assert np.array_equal(a[0], b[0], equal_nan=True)
    assert np.isfinite(a[0]).any()


@pytest.mark.parametrize("compress,cog", [("LZW", False), ("DEFLATE", False),
                                          ("NONE", False), ("LZW", True)])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_geotiff_crosses_packages(writer, compress, cog, tmp_path):
    """The two writers give the same bytes; the other package reads them
    back to the same band."""
    specs = [spec("point_Average"), spec("point_Max")]
    _, bands = run(ref, specs, [cloud(seed=3)])
    files = {}
    for name, pkg in PACKAGES.items():
        gc = like(pkg, grid())
        g = pkg.Grid.create(gc.width, gc.height,
                            [pkg.BandDesc(name=f"b{i}") for i in range(2)])
        for i, band in enumerate(bands):
            g.set_band_array(i, band)
        files[name] = str(tmp_path / f"{name}.tif")
        st = pkg.write_geotiff(files[name], g, gc, pkg.GeoTiffOptions(
            compress=compress, cloud_optimized=cog))
        assert st.ok()
    with open(files["jax"], "rb") as a, open(files["torch"], "rb") as b:
        assert a.read() == b.read()
    reader = OTHER[writer]
    for i, band in enumerate(bands):
        assert np.array_equal(reader.read_geotiff_band(files[writer], i),
                              band, equal_nan=True)
    info = reader.read_geotiff_info(files[writer])
    assert info is not None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pcrt_state_written_by_one_is_resumed_by_the_other(writer, tmp_path):
    """A CPU run of one package flushes its PCRT tiles; the other package
    resumes from them, ingests on and agrees with one uninterrupted run."""
    specs = [spec("point_Average"), spec("point_Max"), spec("point_Sum")]
    c1, c2 = cloud(seed=4), cloud(seed=5)
    state_dir = str(tmp_path / "state")
    first = PACKAGES[writer]
    run(first, specs, [c1], state_dir=state_dir)
    files = sorted(os.listdir(os.path.join(state_dir, "red0_3")))
    assert files and all(f.endswith(".pcrt") for f in files)
    second = OTHER[writer]
    q = second.Pipeline.create(second.PipelineConfig(
        grid=like(second, grid()), reductions=like(second, specs),
        exec_mode=like(second, CPU), state_dir=state_dir))
    q.ingest(like(second, c2))
    q.finalize()
    _, want = run(ref, specs, [c1, c2])
    for i in range(len(specs)):
        np.testing.assert_allclose(q.result().band_array(i), want[i],
                                   rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tile_state_files_cross_packages(writer, tmp_path):
    rng = np.random.default_rng(6)
    body = rng.normal(size=(2, 7, 5)).astype(np.float32)
    pkg, other = PACKAGES[writer], OTHER[writer]
    mod = {"jax": ref.io.tile_state_io, "torch": port.io.tile_state_io}
    w, r = mod[writer], mod["torch" if writer == "jax" else "jax"]
    tile = pkg.TileIndex(row=2, col=3)
    path = w.tile_state_filename(str(tmp_path), tile)
    assert path == r.tile_state_filename(str(tmp_path),
                                         other.TileIndex(row=2, col=3))
    assert w.write_tile_state(path, tile, 5, 7, 2, pkg.ReductionType.Average,
                              body).ok()
    out, st = r.read_tile_state(path)
    assert st.ok()
    assert tuple(out[1:5]) == (5, 7, 2, int(RT.Average))
    assert np.array_equal(out[5].reshape(2, 7, 5), body)


def test_routing_is_the_same():
    gc = grid()
    pgc = like(port, gc)
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-5, 125, 3000), rng.uniform(-5, 95, 3000)
    for a, b in zip(ref_routing.assign(gc, x, y),
                    port_routing.assign(pgc, x, y)):
        assert np.array_equal(a, b)
    c = cloud(seed=8)
    for case in ("gauss_rotated", "line_channels"):
        s = spec(case)
        if case.startswith("gauss"):
            a = ref_routing.gaussian_params(s.glyph, gc, c.x_array(),
                                            c.y_array(), None, None, None)
            b = port_routing.gaussian_params(like(port, s.glyph), pgc,
                                             c.x_array(), c.y_array(), None,
                                             None, None)
        else:
            d, h = c.channel_array_f32("dir"), c.channel_array_f32("hl")
            a = ref_routing.line_params(s.glyph, gc, c.x_array(),
                                        c.y_array(), d, h)
            b = port_routing.line_params(like(port, s.glyph), pgc,
                                         c.x_array(), c.y_array(), d, h)
        for f in vars(a):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f


@pytest.mark.parametrize("w", [1, 100, 128, 200, 300, 1000, 8192])
def test_tiling_is_the_same(w):
    assert tiling.col_tile(w) == col_tile(w)
    assert tiling.padded_width(w) == padded_width(w)
    assert tiling.rect_col_tile(w) == rect_col_tile(w)
    for r in (0, 3, 12, 32, 48):
        assert tiling.gauss_col_tile(w, r) == gauss_col_tile(w, r)
        assert tiling.gauss_row_block(w, r) == gauss_row_block(w, r)


def test_gauss_routing_constants_are_the_same():
    assert (tiling.GAUSS_WMIN, tiling.ROT_ROW_BLOCK, tiling.ROT_COL_TILE,
            tiling.ROTP_ROW_BLOCK, tiling.ROTP_RMAX) == (
        GAUSS_WMIN, ROT_ROW_BLOCK, ROT_COL_TILE, ROTP_ROW_BLOCK, ROTP_RMAX)
    for r, sx, sy in ((3, 1.0, 1.0), (12, 4.0, 1.5), (5, 0.6, 2.0),
                      (32, 16.0, 16.0)):
        assert tiling.gauss_corr_offsets(r, sx, sy) == gauss_corr_offsets(
            r, sx, sy)
        assert tiling.gauss_product_cutoff_bites(
            [r], [sx], [sy]) == gauss_product_cutoff_bites([r], [sx], [sy])
    c = cloud(seed=9)
    gp = ref_routing.gaussian_params(spec("gauss_rotated").glyph, grid(),
                                     c.x_array(), c.y_array(), None, None,
                                     None)
    f0 = c.channel_array_f32("v")
    jax_segs = TpuEngine._rot_quadratic_segs(gp, f0)
    port_segs = tiling.rot_quadratic_segs(gp, f0)
    # the coefficients bit for bit; the centre: the port carries the
    # sub-cell offsets, pcr_tpu float32(-(ic + sub)) (ROADMAP Queue 3)
    for a, b in zip(jax_segs[2:], port_segs[2:]):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    for a, b, ic, sub in zip(jax_segs[:2], port_segs[:2], (gp.icx, gp.icy),
                             (gp.sub_cx, gp.sub_cy)):
        assert np.array_equal(b, sub)
        assert np.array_equal(a, -(ic.astype(np.float32) + sub))


@pytest.mark.parametrize("rtype", list(RT))
def test_registry_is_the_same(rtype):
    a, b = ref.get_reduction_info(rtype), port.get_reduction_info(rtype)
    if a is None:
        assert b is None
        return
    assert (a.state_floats, a.scatter_kind, a.uses_weight, a.uses_timestamp,
            a.builtin) == (b.state_floats, b.scatter_kind, b.uses_weight,
                           b.uses_timestamp, b.builtin)
    assert np.array_equal(a.identity, b.identity, equal_nan=True)
    rng = np.random.default_rng(int(rtype))
    fields = [rng.normal(size=(6, 7)).astype(np.float32)
              for _ in range(a.state_floats)]
    assert np.array_equal(np.asarray(a.finalize_arrays(fields)),
                          np.asarray(b.finalize_arrays(fields)),
                          equal_nan=True)


def test_native_libraries_are_separate_and_agree():
    from pcr_tpu import native as ref_native
    from pcr_tpu_torch import native as port_native
    if not (ref_native.available() and port_native.available()):
        pytest.skip("no C++ compiler for the native helpers")
    a, b = ref_native.lib()._name, port_native.lib()._name
    assert os.path.realpath(a) != os.path.realpath(b)
    assert os.path.dirname(b).endswith(os.path.join("pcr_tpu_torch",
                                                    "_build"))
    data = np.random.default_rng(10).integers(0, 8, 5000).astype(
        np.uint8).tobytes()
    assert ref_native.lzw_encode(data) == port_native.lzw_encode(data)


@pytest.mark.parametrize("ext", ["csv", "pcrp"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_point_cloud_files_cross_packages(writer, ext, tmp_path):
    path = str(tmp_path / f"cloud.{ext}")
    pkg = PACKAGES[writer]
    c = like(pkg, cloud(n=300, seed=11))
    assert pkg.write_point_cloud(path, c, pkg.PointCloudFormat.Auto).ok()
    got = OTHER[writer].read_point_cloud(path)
    assert got.count() == 300
    tol = 1e-6 if ext == "csv" else 0      # CSV holds decimal text
    np.testing.assert_allclose(got.x_array(), c.x_array(), rtol=tol)
    np.testing.assert_allclose(got.channel_array_f32("v"),
                               c.channel_array_f32("v"), rtol=tol)


def test_device_grid_holds_torch_tensors():
    """Grid's Device bands are torch tensors on an explicit device (the
    card by default; here the CPU); to(Host) and back keeps the values."""
    band = np.arange(12, dtype=np.float32).reshape(3, 4)
    band[1, 2] = np.nan
    g = port.Grid.create(4, 3, [port.BandDesc(name="a")],
                         port.MemoryLocation.Device, device="cpu")
    assert isinstance(g.band_array(0), torch.Tensor)
    g.set_band_array(0, band)
    assert isinstance(g.band_array(0), torch.Tensor)
    h = g.to(port.MemoryLocation.Host)
    assert isinstance(h.band_array(0), np.ndarray)
    assert np.array_equal(h.band_array(0), band, equal_nan=True)
    assert np.array_equal(g.valid_mask(0), ~np.isnan(band))
    d = h.to(port.MemoryLocation.Device, device="cpu")
    assert torch.equal(d.band_array(0).isnan(), torch.from_numpy(
        np.isnan(band)))
    assert d.fill(2.5).ok() and bool((d.band_array(0) == 2.5).all())
    assert d.copy_from(h).ok()
    assert np.array_equal(d.to(port.MemoryLocation.Host).band_array(0), band,
                          equal_nan=True)
    band[0, 0] = 99.0                   # the grid never aliases the input
    assert float(g.band_array(0)[0, 0]) == 0.0


# -- testing/, utils/ and io/rasterio_bridge.py --------------------------------

from pcr_tpu.testing import generators as _ref_generators  # noqa: E402

GENERATORS = [g for g in _ref_generators.__all__ if g.startswith("generate_")]


def _flat(obj):
    """The arrays and numbers of a generator's result, in order."""
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _flat(o)]
    if hasattr(obj, "x_array"):
        return [obj.x_array(), obj.y_array()] + [
            obj.channel_array(n) for n in obj.channel_names()]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in [k] + _flat(obj[k])]
    return [np.asarray(obj)]


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_are_the_same(name):
    import pcr_tpu.testing as ref_testing
    import pcr_tpu_torch.testing as port_testing
    outs = []
    for mod in (ref_testing, port_testing):
        gc = mod.generators.make_grid_config(64, 48, tile=32)
        outs.append(_flat(getattr(mod.generators, name)(gc)))
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        a, b = np.asarray(a), np.asarray(b)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def test_generated_raster_through_the_port_device_path():
    """A checkerboard from the port's generators, rasterized by the port's
    device path (torch-CPU here), matches its analytic raster by the
    port's own comparison."""
    import pcr_tpu_torch.testing as port_testing
    gen = port_testing.generators
    gc = gen.make_grid_config(64, 48, tile=32)
    c, want = gen.generate_checkerboard(gc)
    p = port.Pipeline.create(port.PipelineConfig(
        grid=gc, reductions=[port.ReductionSpec(value_channel="value",
                                                type=RT.Average)],
        exec_mode=port.ExecutionMode.GPU))
    p.ingest(c)
    p.finalize()
    port_testing.assert_rasters_match(p.result().band_array(0), want,
                                      label="checkerboard")


def test_compare_is_the_same():
    import pcr_tpu.testing as ref_testing
    import pcr_tpu_torch.testing as port_testing
    rng = np.random.default_rng(4)
    a = rng.normal(size=(20, 30)).astype(np.float32)
    b = a + rng.normal(scale=2e-5, size=a.shape).astype(np.float32)
    b[3, 4] = np.nan
    for x, y in ((a, a), (a, b), (a, a[:, :29])):
        r = ref_testing.compare_rasters(x, y)
        t = port_testing.compare_rasters(x, y)
        assert (r.ok, r.max_diff, r.num_different, r.nan_mismatch,
                r.cells_compared) == (t.ok, t.max_diff, t.num_different,
                                      t.nan_mismatch, t.cells_compared)
        assert str(r) == str(t)
    with pytest.raises(AssertionError):
        port_testing.assert_rasters_match(a, b, label="b")


@pytest.mark.parametrize("cmap", ["viridis", "gray"])
def test_visualization_is_the_same(cmap, tmp_path):
    from pcr_tpu.utils import visualization as ref_vis
    from pcr_tpu_torch.utils import visualization as port_vis
    band = np.linspace(-1, 3, 600, dtype=np.float32).reshape(20, 30)
    band[::7, ::5] = np.nan
    assert ref_vis.coverage(band) == port_vis.coverage(band)
    for kw in ({}, dict(vmin=0.0, vmax=1.0)):
        assert np.array_equal(ref_vis.render_band(band, cmap, **kw),
                              port_vis.render_band(band, cmap, **kw))
    pytest.importorskip("PIL")
    for mod, name in ((ref_vis, "a.png"), (port_vis, "b.png")):
        mod.save_png(str(tmp_path / name), band, cmap)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_rasterio_bridge_is_the_same():
    from pcr_tpu.io import rasterio_bridge as ref_rb
    from pcr_tpu_torch.io import rasterio_bridge as port_rb
    gc = grid()
    a = ref_rb.grid_profile(gc, 3)
    b = port_rb.grid_profile(like(port, gc), 3)
    assert np.isnan(a.pop("nodata")) and np.isnan(b.pop("nodata"))
    assert a == b
    assert ref_rb.rasterio_available() == port_rb.rasterio_available()
    if not port_rb.rasterio_available():
        g = port.Grid.create(4, 3, [port.BandDesc(name="a")])
        with pytest.raises(port.PcrError) as e:
            port_rb.to_rasterio("x.tif", g, like(port, gc))
        assert e.value.status.code == port.StatusCode.NotImplemented
        with pytest.raises(port.PcrError):
            port_rb.from_rasterio("x.tif")


def test_phase_timer_is_the_same():
    from pcr_tpu.utils import PhaseTimer as RefTimer
    from pcr_tpu_torch.utils import PhaseTimer
    for cls in (RefTimer, PhaseTimer):
        t = cls()
        for _ in range(3):
            with t.phase("ingest"):
                pass
        with t.phase("finalize"):
            pass
        assert t.counts["ingest"] == 3 and t.seconds("ingest") >= 0.0
        assert t.seconds("nothing") == 0.0
        assert sorted(t.summary()) == ["finalize", "ingest"]
        assert t.summary()["ingest"]["calls"] == 3
        assert "ingest" in t.report() and '"calls": 3' in t.to_json()


def test_trace_on_torch_profiler(tmp_path):
    """trace() records the block with torch.profiler and writes a Chrome
    trace; without a log_dir it records nothing."""
    import json
    from pcr_tpu_torch.utils import trace
    with trace(None) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).add_(1.0).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::add_" in names
    (path,) = (tmp_path / "tr").iterdir()
    assert "traceEvents" in json.loads(path.read_text())

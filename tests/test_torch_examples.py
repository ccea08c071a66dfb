"""The port's user examples (pcr_tpu_torch/examples) against the same
inputs through pcr_tpu in CPU mode (its numpy oracle).

Each example runs small through its `main(...)` on the port's device path
(PCR_TORCH_DEVICE=cpu: the kernels' plain versions on torch-CPU); the
same arrays, made by the example's own `inputs`, go through pcr_tpu's
Pipeline with ExecutionMode.CPU, or for the mesh example through
pcr_tpu's numpy oracle. Bands agree at atol = rtol = 1e-5 with the exact
NaN footprint (the engines add the same float32 terms in another order).
Without a card and without PCR_TORCH_DEVICE the examples raise CudaError.
"""

import os

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from pcr_tpu.engine import cpu_backend as ref_cpu
from pcr_tpu.engine import routing as ref_routing
from pcr_tpu_torch.examples import (custom_reduction, glyph_splatting,
                                    multichip, quickstart, smiley_face,
                                    streaming_resume)
from test_torch_pipeline import like  # noqa: F401  (spends the first exp)

TOL = 1e-5
CPU = ref.ExecutionMode.CPU


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def near(got, want, atol=TOL, rtol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (atol + rtol * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


def ref_grid(extent, cells=None):
    cell = extent / cells if cells else 1.0
    gc = ref.GridConfig()
    gc.bounds = ref.BBox()
    gc.bounds.min_x = gc.bounds.min_y = 0.0
    gc.bounds.max_x = gc.bounds.max_y = float(extent)
    gc.cell_size_x, gc.cell_size_y = cell, -cell
    gc.crs = ref.CRS.from_epsg(3857)
    gc.compute_dimensions()
    return gc


def ref_cloud(x, y, **channels):
    c = ref.PointCloud.create(len(x))
    c.set_x_array(np.asarray(x, np.float64))
    c.set_y_array(np.asarray(y, np.float64))
    for name, arr in channels.items():
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, np.asarray(arr, np.float32))
    return c


def ref_band(gc, spec, cloud, **cfg):
    p = ref.Pipeline.create(ref.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=CPU, **cfg))
    p.ingest(cloud)
    p.finalize()
    return p.result().band_array(0).copy()


def avg_spec(channel, rtype=ref.ReductionType.Average):
    s = ref.ReductionSpec()
    s.value_channel = channel
    s.type = rtype
    return s


def test_quickstart(tmp_path):
    band = quickstart.main(n=20_000, size=120, out=str(tmp_path / "q.tif"))
    x, y, v = quickstart.inputs(20_000, 120)
    near(band, ref_band(ref_grid(120), avg_spec("value"),
                        ref_cloud(x, y, value=v)))
    back = port.read_geotiff_band(str(tmp_path / "q.tif"), 0)
    assert np.array_equal(np.isnan(back), np.isnan(band))


def test_glyph_splatting(tmp_path):
    bands = glyph_splatting.main(n=400, size=80, out_dir=str(tmp_path))
    arrays = glyph_splatting.inputs(400, 80)
    cloud = ref_cloud(**arrays)
    specs = {"gaussian": ref.gaussian_splat_spec(
                 "value", sigma_x_channel="sigma", sigma_y_channel="sigma"),
             "line": ref.line_splat_spec(
                 "value", direction_channel="direction",
                 half_length_channel="half_length")}
    assert set(bands) == set(specs)
    for label, spec in specs.items():
        assert np.isfinite(bands[label]).any()
        near(bands[label], ref_band(ref_grid(80), spec, cloud))
        assert os.path.exists(tmp_path / f"pcr_{label}.tif")


def test_streaming_resume(tmp_path):
    first, second = streaming_resume.main(
        n=4_000, size=40, state_dir=str(tmp_path / "port"))
    state_dir = str(tmp_path / "ref")
    want = []
    for seed in (1, 2):
        x, y, v = streaming_resume.inputs(seed, 4_000, 40)
        want.append(ref_band(ref_grid(40), avg_spec("v", ref.ReductionType.Sum),
                             ref_cloud(x, y, v=v), state_dir=state_dir))
    near(first, want[0])
    near(second, want[1])
    assert np.nansum(second) == pytest.approx(8_000)   # both clouds


def test_custom_reduction():
    band = custom_reduction.main(n=6_000, size=50)
    assert port.get_reduction_info(port.ReductionType.Custom) is None
    x, y, v = custom_reduction.inputs(6_000, 50)
    ref.register_custom_reduction(
        state_floats=2, identity=(0.0, 0.0), scatter_kind="sum",
        fields=lambda v, w, t: [v * v, v * 0 + 1.0],
        merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
        finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5)
    try:
        want = ref_band(ref_grid(50), ref.ReductionSpec(
            value_channel="v", type=ref.ReductionType.Custom),
            ref_cloud(x, y, v=v))
    finally:
        ref.unregister_reduction(ref.ReductionType.Custom)
    near(band, want)


def test_smiley_face(tmp_path):
    face = smiley_face.main(points=6_000, size=96,
                            out=str(tmp_path / "s.tif"),
                            png=str(tmp_path / "s.png"))
    arrays = smiley_face.inputs(6_000)
    cloud = ref_cloud(**arrays)
    gc = ref_grid(smiley_face.WORLD, 96)
    want = np.zeros((96, 96), np.float32)
    for name, code, spec in (
            ("outline", 0.0, ref.line_splat_spec(
                "value", direction_channel="direction",
                half_length_channel="half_length")),
            ("eyes", 1.0, ref.gaussian_splat_spec(
                "value", sigma_x_channel="sigma", sigma_y_channel="sigma")),
            ("smile", 2.0, ref.line_splat_spec(
                "value", direction_channel="direction",
                half_length_channel="half_length"))):
        filt = ref.FilterSpec()
        filt.add("part", ref.CompareOp.Equal, code)
        band = ref_band(gc, spec, cloud, filter=filt)
        m = np.isfinite(band)
        want[m] = np.maximum(want[m], band[m])
    assert (face > 0).mean() > 0.02
    near(face, want)
    assert os.path.exists(tmp_path / "s.tif")


def test_multichip():
    assert multichip.mesh_devices() == [torch.device("cpu")] * 4
    point, gauss = multichip.main(n=4_096, size=64)
    x, y, values = multichip.inputs(4_096, 64)
    gc = ref_grid(64)
    col, row, valid = ref_routing.assign(gc, x, y)
    info = ref.get_reduction_info(ref.ReductionType.Average)
    want = info.init_state((64, 64))
    flat = row[valid].astype(np.int64) * 64 + col[valid].astype(np.int64)
    ref_cpu.accumulate_point_cpu(info, want, flat, values[valid],
                                 np.ones(valid.sum(), np.float32),
                                 np.zeros(valid.sum(), np.float32))
    for g, w in zip(point, want):
        near(g, w)
    spec = ref.GlyphSpec(type=ref.GlyphType.Gaussian, **multichip.GAUSS)
    info_g = ref.get_reduction_info(ref.ReductionType.Sum)
    want_g = info_g.init_state((64, 64))
    ref_cpu.accumulate_gaussian_cpu(spec, ref.ReductionType.Sum, gc, want_g,
                                    x[valid], y[valid], values[valid], None,
                                    None, None, col[valid], row[valid])
    near(gauss[0], want_g[0])


def test_without_a_card_the_examples_raise(monkeypatch):
    """No card and no PCR_TORCH_DEVICE: CudaError, no fallback."""
    monkeypatch.delenv("PCR_TORCH_DEVICE")
    for run in (lambda: multichip.mesh_devices(),
                lambda: quickstart.main(n=100, size=10)):
        with pytest.raises(port.PcrError) as e:
            run()
        assert e.value.status.code == port.StatusCode.CudaError

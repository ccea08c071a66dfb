"""The axes of tests/test_parity.py that no other twin covers, on the port:
Line per-point channels, glyph clipping on small tiles, a filtered ingest,
non-square cells, and the UTM-offset extents (the Point families, the
glyphs and a tiled grid at absolute coordinates of 3.9e5 / 4.3e6).

Each case builds its inputs once with pcr_tpu's own builders (seeded numpy)
and runs them through three pipelines: the port's device path on torch-CPU
(PCR_TORCH_DEVICE=cpu), pcr_tpu's device path (GPU mode on the JAX CPU
backend, as its own tests run it) and pcr_tpu's numpy CPU oracle. The port
must meet test_parity's bar against both: |got - want| <= 1e-5 + 1e-5 *
|want| per cell for the sum family, exact for order statistics, and the
exact NaN footprint.

The helpers here serve the other twins of pcr_tpu's pipeline tests.
"""

import copy

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
import test_parity
from test_parity import glyph_cloud
from test_torch_pipeline import assert_bands, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def make(pkg, mode, specs, gc, **cfg):
    """A pipeline of `pkg` on inputs built from pcr_tpu's types (copied,
    so no pipeline sees another's objects)."""
    return pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, copy.deepcopy(gc)),
        reductions=like(pkg, copy.deepcopy(specs)),
        exec_mode=like(pkg, mode),
        **{k: like(pkg, copy.deepcopy(v)) for k, v in cfg.items()}))


def bands(pkg, mode, specs, clouds, gc, **cfg):
    p = make(pkg, mode, specs, gc, **cfg)
    for c in like(pkg, clouds):
        p.ingest(c)
    p.finalize()
    return [p.result().band_array(i).copy() for i in range(len(specs))]


def assert_twin(specs, clouds, gc, **cfg):
    """The port's device path against pcr_tpu's device path and its
    oracle. Returns the port's bands."""
    got = bands(port, GPU, specs, clouds, gc, **cfg)
    oracle = bands(ref, CPU, specs, clouds, gc, **cfg)
    jax_bands = bands(ref, GPU, specs, clouds, gc, **cfg)
    assert_bands(got, oracle, specs)
    assert_bands(got, jax_bands, specs)
    return got


def test_line_per_point_channels():
    spec = ref.line_splat_spec("v", direction_channel="dir",
                               half_length_channel="hl",
                               max_radius_cells=8.0)
    assert_twin([spec], [glyph_cloud()], make_grid_config())


def test_glyph_clipping_small_tiles():
    sg = ref.gaussian_splat_spec("v", default_sigma=2.0,
                                 max_radius_cells=8.0)
    sl = ref.line_splat_spec("v", direction_channel="dir",
                             half_length_channel="hl", max_radius_cells=8.0)
    assert_twin([sg, sl], [glyph_cloud()], make_grid_config(tile=32))


@pytest.mark.parametrize("op,threshold", [("Greater", 1.0),
                                          ("LessEqual", 0.7)])
def test_filtered_ingest(op, threshold):
    filt = ref.FilterSpec().add("w", getattr(ref.CompareOp, op), threshold)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average),
             ref.ReductionSpec(value_channel="v", type=RT.Max)]
    cloud = glyph_cloud()
    got = assert_twin(specs, [cloud], make_grid_config(), filter=filt)
    unfiltered = bands(port, GPU, specs, [cloud], make_grid_config())
    assert not np.array_equal(got[0], unfiltered[0], equal_nan=True)


def test_non_square_cells():
    spec = ref.gaussian_splat_spec("v", default_sigma=1.0,
                                   max_radius_cells=8.0)
    assert_twin([spec], [glyph_cloud(n=5000)], make_grid_config(cell=0.5))


UTM = test_parity.TestLargeExtentParity()


@pytest.mark.parametrize("case", ["point", "glyphs", "tiled"])
def test_utm_offset_extents(case):
    """f64 host coordinates, f32 device offsets: the engine subtracts the
    origin on the host, so no cell shears at 3.9e5 m east / 4.3e6 m north
    (a quarter of the points sit within 1e-3 of a cell edge)."""
    if case == "point":
        specs = [ref.ReductionSpec(value_channel="v", type=t)
                 for t in (RT.Sum, RT.Average, RT.Max)]
    elif case == "glyphs":
        specs = [
            ref.gaussian_splat_spec("v", default_sigma=2.0,
                                    max_radius_cells=8.0),
            ref.gaussian_splat_spec("v", default_sigma_x=2.0,
                                    default_sigma_y=0.8,
                                    default_rotation=0.6,
                                    max_radius_cells=7.0),
            ref.line_splat_spec("v", direction_channel="dir",
                                half_length_channel="hl",
                                max_radius_cells=8.0)]
    else:
        specs = [ref.gaussian_splat_spec("v", default_sigma=2.0,
                                         max_radius_cells=8.0)]
    gc = UTM._grid(tile=256 if case == "tiled" else 4096)
    assert (gc.total_tiles() > 1) == (case == "tiled")
    assert_twin(specs, [UTM._cloud()], gc)

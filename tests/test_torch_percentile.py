"""tests/test_percentile.py on the port: Median and Percentile, the
collect-based order statistics.

The port's `compute_percentile_band` is held against pcr_tpu's and against
the expected values; the pipelines (Median end to end, Percentile 0.9 over
two ingests, mixed with the sum family and Max) run in CPU mode and on the
device path (torch-CPU, PCR_TORCH_DEVICE=cpu), each against pcr_tpu's
pipeline in the same mode and against numpy's lower-interpolated quantile
of every cell, exactly.
"""

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu.ops.reduction import compute_percentile_band as ref_band
from pcr_tpu_torch.ops.reduction import compute_percentile_band as port_band
from test_torch_parity import bands, devices  # noqa: F401
from test_torch_pipeline import assert_bands

RT = ref.ReductionType
MODES = [ref.ExecutionMode.CPU, ref.ExecutionMode.GPU]


def both(cells, vals, shape, q):
    a = port_band(cells, vals, shape, q)
    b = ref_band(cells, vals, shape, q)
    assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return a


def test_exact_median():
    cells = np.array([0, 0, 0, 5, 5], np.int64)
    vals = np.array([3.0, 1.0, 2.0, 10.0, 20.0], np.float32)
    band = both(cells, vals, (2, 4), 0.5)
    assert band[0, 0] == 2.0          # median of {1, 2, 3}
    assert band[1, 1] == 10.0         # lower interpolation of {10, 20}
    assert np.isnan(band[0, 1])


@pytest.mark.parametrize("q,expect", [(0.0, 0.0), (0.5, 4.0), (1.0, 9.0),
                                      (0.25, 2.0)])
def test_quantiles(q, expect):
    band = both(np.zeros(10, np.int64), np.arange(10, dtype=np.float32),
                (1, 1), q)
    assert band[0, 0] == expect


def test_matches_numpy_quantile_lower():
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 50, 5000).astype(np.int64)
    vals = rng.normal(0, 1, 5000).astype(np.float32)
    band = both(cells, vals, (5, 10), 0.3).ravel()
    for c in range(50):
        sel = vals[cells == c]
        assert band[c] == np.float32(np.quantile(sel, 0.3, method="lower"))


def cloud(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, 20, n))
    c.set_y_array(rng.uniform(0, 20, n))
    c.add_channel("v", ref.DataType.Float32)
    c.set_channel_array_f32("v", rng.normal(0, 1, n).astype(np.float32))
    return c


def quantile_band(gc, clouds, q):
    """numpy's lower-interpolated q-quantile of every cell's values."""
    x = np.concatenate([c.x_array() for c in clouds])
    y = np.concatenate([c.y_array() for c in clouds])
    v = np.concatenate([c.channel_array_f32("v") for c in clouds])
    col, row, valid = gc.world_to_cell_array(x, y)
    flat = row[valid].astype(np.int64) * gc.width + col[valid]
    v = v[valid]
    band = np.full(gc.height * gc.width, np.nan, np.float32)
    for c in np.unique(flat):
        band[c] = np.quantile(v[flat == c], q, method="lower")
    return band.reshape(gc.height, gc.width)


def percentile(q):
    s = ref.ReductionSpec(value_channel="v", type=RT.Percentile)
    s.percentile = q
    return s


CASES = {
    "median": ([ref.ReductionSpec(value_channel="v", type=RT.Median)], 1,
               [0.5]),
    "percentile_multi_ingest": ([percentile(0.9)], 2, [0.9]),
    "mixed": ([ref.ReductionSpec(value_channel="v", type=RT.Average),
               ref.ReductionSpec(value_channel="v", type=RT.Median),
               ref.ReductionSpec(value_channel="v", type=RT.Count),
               percentile(0.9),
               ref.ReductionSpec(value_channel="v", type=RT.Max)], 2,
              [None, 0.5, None, 0.9, None]),
}


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_percentile(case, mode):
    specs, nclouds, qs = CASES[case]
    gc = make_grid_config(w=20.0, h=20.0)
    clouds = [cloud(seed=s) for s in range(1, nclouds + 1)]
    got = bands(port, mode, specs, clouds, gc)
    jax_bands = bands(ref, mode, specs, clouds, gc)
    assert_bands(got, jax_bands, specs)
    for band, q in zip(got, qs):
        if q is not None:
            assert np.array_equal(band, quantile_band(gc, clouds, q),
                                  equal_nan=True)
    if case == "mixed":
        # the order statistics are finite exactly where Count is
        assert (np.isfinite(got[1]) == np.isfinite(got[2])).all()
        assert (np.isfinite(got[3]) == np.isfinite(got[2])).all()

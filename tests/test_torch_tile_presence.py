"""Touched-tile tracking of the port's Pipeline (`_track_tiles`,
`_tiles_of`).

The native presence pass (`native.tile_presence`, router.cpp
`pcr_tile_presence`) gives exactly the set of tiles that the numpy
version of `_tiles_of` gives, on seeded clouds, whichever of the two
`_tiles_of` takes; and a pipeline that stops scanning once every tile is
known gives the same bands with the native library and without it, and
counts its skips and scanned points.
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch import native
from pcr_tpu_torch.engine import pipeline as pipeline_mod
from pcr_tpu_torch.engine import routing
from pcr_tpu_torch.engine.filter import evaluate_filter_mask
from pcr_tpu_torch.utils import profiling

RT = pcr.ReductionType
NATIVE_MIN = pipeline_mod._NATIVE_MIN_POINTS


def grid(width, height, tile_w, tile_h):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, float(width), float(height)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile_w, tile_height=tile_h,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    return gc


def cloud(n, x_range, y_range, seed):
    """n points uniform over x_range x y_range; channel "v" is x."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(*x_range, n)
    c = pcr.PointCloud.create(n)
    c.set_x_array(x)
    c.set_y_array(rng.uniform(*y_range, n))
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v", x.astype(np.float32))
    c.set_crs(pcr.CRS.from_epsg(3857))
    return c


# case: (grid, points, x range, y range, filter or None); the ranges reach
# past the grid so that some points fall outside it (invalid)
CASES = {
    "one_tile": ((300, 200, 4096, 4096), 100_000, (-10, 310), (-5, 205),
                 None),
    "two_by_two": ((800, 600, 400, 300), 100_000, (-10, 810), (-5, 605),
                   None),
    # 3183 x 107 cells in tiles of 50 x 40: 64 x 3 tiles, the last column
    # and row partial; the points leave the right third of the grid empty
    "ragged_64x3": ((3183, 107, 50, 40), 100_000, (0, 2000), (-5, 112),
                    None),
    "all_invalid": ((800, 600, 400, 300), 100_000, (900, 1000), (0, 600),
                    None),
    "empty": ((800, 600, 400, 300), 0, (0, 800), (0, 600), None),
    # the filter drops every point right of x = 390: the right-hand tiles
    # hold valid cells that the mask takes out
    "filtered": ((800, 600, 400, 300), 100_000, (0, 800), (0, 600),
                 ("v", pcr.CompareOp.Less, 390.0)),
    "below_native_size": ((800, 600, 400, 300), NATIVE_MIN - 1, (0, 800),
                          (0, 310), None),
    "at_native_size": ((800, 600, 400, 300), NATIVE_MIN, (0, 800),
                       (0, 310), None),
    "above_native_size": ((800, 600, 400, 300), NATIVE_MIN + 1, (0, 800),
                          (0, 310), None),
    "native_off": ((800, 600, 400, 300), 100_000, (0, 800), (0, 310), None),
}


def make_pipeline(gc, filt=None, mode=pcr.ExecutionMode.CPU):
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Average)]
    c.exec_mode = mode
    if filt is not None:
        c.filter = pcr.FilterSpec().add(*filt)
    return pcr.Pipeline.create(c)


def numpy_tiles(p, col, row, valid, monkeypatch):
    """`_tiles_of` by its numpy version, the oracle."""
    with monkeypatch.context() as m:
        m.setattr(pipeline_mod, "_NATIVE_MIN_POINTS", 1 << 62)
        return p._tiles_of(col, row, valid)


def native_off(monkeypatch):
    """The process as under PCR_NATIVE=0: no native library."""
    monkeypatch.setenv("PCR_NATIVE", "0")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)


@pytest.mark.parametrize("case", list(CASES))
def test_native_presence_is_the_numpy_set(case, monkeypatch):
    (w, h, tw, th), n, xr, yr, filt = CASES[case]
    gc = grid(w, h, tw, th)
    c = cloud(n, xr, yr, seed=len(case))
    p = make_pipeline(gc, filt)
    col, row, valid = routing.assign(gc, c.x_array(), c.y_array())
    if filt is not None:
        keep = evaluate_filter_mask(c, p.config.filter)
        assert (valid & ~keep).any()
        valid = valid & keep
    want = numpy_tiles(p, col, row, valid, monkeypatch)

    if case == "native_off":
        native_off(monkeypatch)
        assert not native.available()
    elif not native.available():
        pytest.skip("no C++ compiler for the native helpers")
    calls = []
    if native.available():
        real = native.tile_presence
        monkeypatch.setattr(native, "tile_presence",
                            lambda *a: calls.append(len(a[0])) or real(*a))
    got = p._tiles_of(col, row, valid)
    assert got == want

    ntiles = gc.tiles_x * gc.tiles_y
    engaged = native.available() and ntiles > 1 and n >= NATIVE_MIN
    assert calls == ([n] if engaged else [])
    if native.available():
        # the pass itself on every grid, the one-tile grid included
        present = native.tile_presence(col, row, valid, gc.tile_width,
                                       gc.tile_height, gc.tiles_x, ntiles)
        assert present.dtype == np.uint8 and present.shape == (ntiles,)
        assert [(int(t) // gc.tiles_x, int(t) % gc.tiles_x)
                for t in np.flatnonzero(present)] == want

    expect = {"one_tile": 1, "two_by_two": 4, "all_invalid": 0, "empty": 0,
              "filtered": 2, "below_native_size": 4, "at_native_size": 4,
              "above_native_size": 4, "native_off": 4}
    if case == "ragged_64x3":
        assert (gc.tiles_x, gc.tiles_y) == (64, 3)
        assert 0 < len(want) < ntiles and (2, 39) in want
    else:
        assert len(want) == expect[case]


@pytest.mark.parametrize("d", [1, 3, 7, 4095, 4096, 4097, 65537,
                               1_000_003, 3 << 24, (1 << 30) + 1,
                               (3 << 29) - 1, (1 << 31) - 1])
def test_presence_divides_exactly(d):
    """The pass's multiply-and-shift division gives v // d for cells v
    around multiples of d up to the int32 limit: cell i of the call lies
    in row i of one-row tiles, so its tile is i * tiles + v // d."""
    if not native.available():
        pytest.skip("no C++ compiler for the native helpers")
    top = (1 << 31) - 1
    tiles = min(top // d, 4095) + 1
    rng = np.random.default_rng(d)
    qs = {0, 1, 2, tiles // 2, tiles - 2, tiles - 1}
    qs |= set(rng.integers(0, tiles, 200).tolist())
    vals = {q * d + e for q in qs for e in (-1, 0, 1)} | {top}
    vals = sorted(v for v in vals if 0 <= v <= top and v // d < tiles)
    present = native.tile_presence(np.array(vals, np.int32),
                                   np.arange(len(vals), dtype=np.int32),
                                   None, d, 1, tiles, len(vals) * tiles)
    assert np.flatnonzero(present).tolist() == [
        i * tiles + v // d for i, v in enumerate(vals)]


def test_presence_refuses_what_it_cannot_read():
    if not native.available():
        pytest.skip("no C++ compiler for the native helpers")
    col = np.zeros(10, np.int32)
    with pytest.raises(ValueError):
        native.tile_presence(col, col[:9], None, 4, 4, 2, 4)
    with pytest.raises(ValueError):
        native.tile_presence(col, col, np.ones(9, bool), 4, 4, 2, 4)
    with pytest.raises(ValueError):
        native.tile_presence(col, col, None, 0, 4, 2, 4)
    assert native.tile_presence(col, col, None, 4, 4, 2, 4).tolist() == \
        [1, 0, 0, 0]


# A 3 x 3-tile grid of 300 x 300 cells fed in five calls of 70000 points
# each. "partial": the calls cover the first two tile rows only, so three
# tiles never hold a point and every call scans. "filling": each of the
# first three calls adds one tile row, so the last two calls are skipped.
JOBS = {
    "partial": [(0, 200)] * 5,
    "filling": [(0, 100), (100, 200), (200, 300), (0, 300), (0, 300)],
}
CALL_POINTS = 70_000


def stream_job(rows):
    p = make_pipeline(grid(300, 300, 100, 100), mode=pcr.ExecutionMode.GPU)
    for s, (lo, hi) in enumerate(rows):
        # y grows upward and rows downward: row band [lo, hi) is y in
        # (300 - hi, 300 - lo]
        y = (300 - hi + 0.5, 300 - lo - 0.5)
        p.ingest(cloud(CALL_POINTS, (0, 300), y, seed=100 + s))
    p.finalize()
    return p.result().band_array(0), sorted(p._touched_tiles)


@pytest.mark.parametrize("job", list(JOBS))
def test_stream_skips_once_every_tile_is_known(job, monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    rows = JOBS[job]
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            band_on, tiles_on = stream_job(rows)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    native_off(monkeypatch)
    band_off, tiles_off = stream_job(rows)

    assert tiles_on == tiles_off
    assert np.array_equal(np.isnan(band_on), np.isnan(band_off))
    assert np.array_equal(band_on.view(np.int32), band_off.view(np.int32))
    tile_nan = np.isnan(band_on).reshape(3, 100, 3, 100).all(axis=(1, 3))
    if job == "partial":
        assert len(tiles_on) == 6 and tile_nan[2].all()
        assert not tile_nan[:2].any()
        skips = 0
    else:
        assert len(tiles_on) == 9 and not tile_nan.any()
        skips = 2
    assert counters.get("tiles_skips", 0) == skips
    assert counters["tiles_scan_points"] == CALL_POINTS * (len(rows) - skips)

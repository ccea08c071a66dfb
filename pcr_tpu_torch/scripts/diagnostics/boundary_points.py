"""
Boundary-point diagnostic: points exactly on the bbox's edges and corners
and on a tile seam must land in the clamped edge cells identically on the
CPU and on the card.

    python -m pcr_tpu_torch.scripts.diagnostics.boundary_points

The counterpart of scripts/diagnostics/boundary_points.py: the same twelve
points (four corners, three edge midpoints, the seam and the seam +-1e-9,
two out of bounds) on a 512 x 512 grid in 256-cell tiles, Count. PASS
means the two bands are bit-identical, NaN footprint included, and each
counts the 10 points in bounds. Exit codes: 0 PASS, 1 FAIL, 2 no card.
"""

from __future__ import annotations

import argparse

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.scripts.diagnostics import (NO_CARD, NO_CARD_EXIT,
                                               probe_device)

IN_BOUNDS = 10


def build_cloud(gc) -> pcr.PointCloud:
    b = gc.bounds
    tile_x = b.min_x + gc.tile_width * gc.cell_size_x
    tile_y = b.min_y - gc.tile_height * gc.cell_size_y
    xs = [b.min_x, b.max_x, b.min_x, b.max_x,           # corners
          (b.min_x + b.max_x) / 2, b.min_x, b.max_x,    # edge midpoints
          tile_x, tile_x - 1e-9, tile_x + 1e-9,         # tile seam
          b.min_x - 1.0, b.max_x + 1.0]                 # out of bounds
    ys = [b.min_y, b.min_y, b.max_y, b.max_y,
          b.min_y, (b.min_y + b.max_y) / 2, (b.min_y + b.max_y) / 2,
          tile_y, tile_y, tile_y,
          b.min_y, b.max_y + 1.0]
    c = pcr.PointCloud.create(len(xs))
    c.set_x_array(np.asarray(xs, np.float64))
    c.set_y_array(np.asarray(ys, np.float64))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", np.ones(len(xs), np.float32))
    return c


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args(argv)
    if probe_device() is None:
        print(NO_CARD)
        return NO_CARD_EXIT
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0, 0, 512, 512
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.tile_width = gc.tile_height = 256
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    cloud = build_cloud(gc)
    bands, counted = {}, []
    for mode in (pcr.ExecutionMode.CPU, pcr.ExecutionMode.GPU):
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="value",
                                            type=pcr.ReductionType.Count)]
        cfg.exec_mode = mode
        p = pcr.Pipeline.create(cfg)
        p.ingest(cloud)
        p.finalize()
        bands[mode] = p.result().band_array(0).copy()
        touched = int(np.count_nonzero(np.isfinite(bands[mode])))
        total = float(np.nansum(bands[mode]))
        counted.append(total == IN_BOUNDS)
        print(f"{mode.name}: {touched} cells touched, count sum {total:g} "
              f"(expected {IN_BOUNDS} in-bounds points)")
    a, b = bands.values()
    same = (np.isnan(a) == np.isnan(b)).all() and np.array_equal(
        a[~np.isnan(a)], b[~np.isnan(b)])
    ok = bool(same and all(counted))
    print("PASS" if ok else "FAIL",
          "- backends agree" if same else "- backend mismatch at boundaries",
          "" if all(counted) else f"(a band does not count {IN_BOUNDS})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

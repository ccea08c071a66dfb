"""
Grid-size sweep diagnostic: odd, tiny, non-tile-aligned and large grids
must all ingest and finalize correctly; prints each size's wall and its
cell-count sanity check.

    python -m pcr_tpu_torch.scripts.diagnostics.grid_sizes [--mode {CPU,GPU,Auto}] [--points N]

The counterpart of scripts/diagnostics/grid_sizes.py, with its eight
sizes and its Count spec. A size passes when the band's count is the
number of points. The default mode is Auto, which takes the card (the JAX
script's default is its CPU oracle; ask for that with --mode CPU). Exit
codes: 0 every size passed, 1 one did not, 2 no card for a device mode.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.scripts.diagnostics import (NO_CARD, NO_CARD_EXIT,
                                               probe_device, synchronize)

SIZES = [(1, 1), (7, 3), (100, 100), (129, 257), (1000, 1000),
         (1, 4096), (4096, 1), (3001, 1999)]


def grid_config(w: int, h: int) -> pcr.GridConfig:
    """A w x h grid of 1-unit cells over [0, w] x [0, h], EPSG:3857."""
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0, 0, float(w), float(h)
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    return gc


def make_cloud(w: int, h: int, n: int, seed: int = 0) -> pcr.PointCloud:
    """n uniform points over the grid, a "value" channel in [0, 1)."""
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", rng.uniform(0, 1, n).astype(np.float32))
    return c


def run_size(w: int, h: int, n: int, mode) -> bool:
    gc = grid_config(w, h)
    c = make_cloud(w, h, n)
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [pcr.ReductionSpec(value_channel="value",
                                        type=pcr.ReductionType.Count)]
    cfg.exec_mode = mode
    t0 = time.perf_counter()
    p = pcr.Pipeline.create(cfg)
    p.ingest(c)
    p.finalize()
    if mode != pcr.ExecutionMode.CPU:
        synchronize(probe_device())
    dt = time.perf_counter() - t0
    total = float(np.nansum(p.result().band_array(0)))
    ok = total == n
    print(f"{w:>6}x{h:<6} n={n:<8} {mode.name:4s} {dt:7.2f}s "
          f"count={total:.0f} {'OK' if ok else 'MISMATCH'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--mode", default="Auto", choices=["CPU", "GPU", "Auto"])
    ap.add_argument("--points", type=int, default=100_000)
    args = ap.parse_args(argv)
    mode = getattr(pcr.ExecutionMode, args.mode)
    if mode != pcr.ExecutionMode.CPU and probe_device() is None:
        print(NO_CARD)
        return NO_CARD_EXIT
    ok = [run_size(w, h, args.points, mode) for w, h in SIZES]
    print("PASS" if all(ok) else "FAIL")
    return 0 if all(ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())

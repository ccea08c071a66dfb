"""
DC-LiDAR-shaped tiles in memory: a copy of the port's LAS synthesizer
(pcr_tpu_torch/scripts/run_lidar_pipeline.py `synthesize`, itself the
JAX harness's), changed only to return arrays instead of writing LAS files
and to draw from the run's seed instead of seed 0.

A rolling terrain surface with buildings and canopy; with skew > 0 the
tiles' point counts follow a truncated power law peaked at the grid's
centre, and a skew-sized share of each tile's points piles into
building-scale clusters (normal, 8 m), giving hot tiles and deep per-cell
stacks. The tiles lie side by side in a square layout over the grid, in
order, so runs of consecutive points arrive as a LiDAR reader streams its
files. The value is the return height `z`.

params: count (points in all), tiles (a square number), skew.
"""

from __future__ import annotations

import numpy as np

from ..points import Points, rng


def generate(params: dict, grid, seed: int) -> Points:
    r = rng(seed)
    n_files = int(params["tiles"])
    pts_per_file = int(params["count"]) // n_files
    skew = float(params["skew"])
    side = int(np.ceil(np.sqrt(n_files)))
    tile_w = grid.extent_x / side
    if skew > 0:
        # density ~ (1 + d/L)^-2 around the core, renormalized
        txs = np.arange(n_files) % side
        tys = np.arange(n_files) // side
        d = np.hypot(txs - side / 2.0, tys - side / 2.0)
        w = (1.0 + d / max(side / 4.0, 1.0)) ** -2.0
        counts = np.maximum(
            (w / w.sum() * n_files * pts_per_file).astype(np.int64), 1000)
    else:
        counts = np.full(n_files, pts_per_file, np.int64)
    xs, ys, zs = [], [], []
    for i in range(n_files):
        tx, ty = i % side, i // side
        n = int(counts[i])
        x = r.uniform(tx * tile_w, (tx + 1) * tile_w, n)
        y = r.uniform(ty * tile_w, (ty + 1) * tile_w, n)
        if skew > 0:
            # pile a skew-fraction of the tile's points into hot clusters
            nh = int(n * min(skew, 0.9))
            k = max(2, int(tile_w // 200))
            cx = r.uniform(tx * tile_w, (tx + 1) * tile_w, k)
            cy = r.uniform(ty * tile_w, (ty + 1) * tile_w, k)
            pick = r.integers(0, k, nh)
            x[:nh] = np.clip(cx[pick] + r.normal(0, 8.0, nh),
                             tx * tile_w, (tx + 1) * tile_w)
            y[:nh] = np.clip(cy[pick] + r.normal(0, 8.0, nh),
                             ty * tile_w, (ty + 1) * tile_w)
        # terrain + structures
        ground = (40 + 8 * np.sin(x / 300.0) + 6 * np.cos(y / 260.0))
        z = ground + r.normal(0, 0.05, n)
        cls = np.full(n, 2, np.float32)          # ground
        nb = max(3, int(tile_w // 120))
        for _ in range(nb):                      # buildings
            bx, by = r.uniform(tx * tile_w, (tx + 1) * tile_w), \
                r.uniform(ty * tile_w, (ty + 1) * tile_w)
            w_, h, ht = r.uniform(15, 60), r.uniform(15, 60), \
                r.uniform(5, 40)
            sel = (np.abs(x - bx) < w_ / 2) & (np.abs(y - by) < h / 2)
            z[sel] = ground[sel] + ht + r.normal(0, 0.03, sel.sum())
            cls[sel] = 6
        veg = (cls == 2) & (r.random(n) < 0.15)   # canopy returns
        z[veg] += r.uniform(2, 20, int(veg.sum()))
        xs.append(grid.min_x + x)
        ys.append(grid.min_y + y)
        zs.append(z.astype(np.float32))
    return Points(np.concatenate(xs), np.concatenate(ys), np.concatenate(zs))

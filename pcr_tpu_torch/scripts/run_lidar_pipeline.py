"""
Streaming LiDAR harness on the port: streams a directory of LAS / PCRP /
CSV tiles through one Pipeline with per-phase timing (io_read_s /
ingest_s / drain_s / finalize_s), coverage, and a stats JSON and CSV. The
counterpart of scripts/data/run_lidar_pipeline.py, the reference's
de-facto large-scale integration test (scripts/data/test_dc_lidar.py).

    python -m pcr_tpu_torch.scripts.run_lidar_pipeline --input DIR \\
        --synthesize 40 --pts-per-file 500000 --extent 8192 --skew 0.5 \\
        --modes gpu hybrid cpu --stats-json stats.json

--synthesize N writes N LiDAR-like LAS 1.2 tiles into DIR first (the same
bytes as the JAX harness from the same seed), so the streaming path runs
without a dataset. Modes: gpu (the card), hybrid (the card, with host
workers preparing chunks ahead) and cpu (the numpy oracle).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.utils.profiling import PhaseTimer

MODE_MAP = {
    "cpu": pcr.ExecutionMode.CPU,
    "gpu": pcr.ExecutionMode.GPU,
    "hybrid": pcr.ExecutionMode.Hybrid,
}


def synthesize(directory, n_files, pts_per_file=500_000, extent=4000.0,
               skew=0.0):
    """Write LiDAR-like LAS 1.2 tiles: a rolling terrain surface plus
    building-footprint clusters with ground / building / vegetation
    classifications and return-intensity structure, shaped like the DC
    dataset the reference validates on.

    skew > 0 adds the density skew of urban scans: per-file point counts
    follow a truncated power law peaked at the grid's centre tiles, and
    within each file a skew-sized fraction of the points piles into a few
    building-scale hot clusters, giving hot tiles and deep per-cell
    stacks. Total points stay about n_files * pts_per_file."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    side = int(np.ceil(np.sqrt(n_files)))
    tile_w = extent / side
    origin = (389_000.0, 124_000.0)   # EPSG:32110-ish coordinates
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
    for i in range(n_files):
        tx, ty = i % side, i // side
        n = int(counts[i])
        x = rng.uniform(tx * tile_w, (tx + 1) * tile_w, n)
        y = rng.uniform(ty * tile_w, (ty + 1) * tile_w, n)
        if skew > 0:
            # pile a skew-fraction of the tile's points into hot clusters
            nh = int(n * min(skew, 0.9))
            k = max(2, int(tile_w // 200))
            cx = rng.uniform(tx * tile_w, (tx + 1) * tile_w, k)
            cy = rng.uniform(ty * tile_w, (ty + 1) * tile_w, k)
            pick = rng.integers(0, k, nh)
            x[:nh] = np.clip(cx[pick] + rng.normal(0, 8.0, nh),
                             tx * tile_w, (tx + 1) * tile_w)
            y[:nh] = np.clip(cy[pick] + rng.normal(0, 8.0, nh),
                             ty * tile_w, (ty + 1) * tile_w)
        # terrain + structures
        ground = (40 + 8 * np.sin(x / 300.0) + 6 * np.cos(y / 260.0))
        z = ground + rng.normal(0, 0.05, n)
        cls = np.full(n, 2, np.float32)          # ground
        nb = max(3, int(tile_w // 120))
        for _ in range(nb):                      # buildings
            bx, by = rng.uniform(tx * tile_w, (tx + 1) * tile_w), \
                rng.uniform(ty * tile_w, (ty + 1) * tile_w)
            w, h, ht = rng.uniform(15, 60), rng.uniform(15, 60), \
                rng.uniform(5, 40)
            sel = (np.abs(x - bx) < w / 2) & (np.abs(y - by) < h / 2)
            z[sel] = ground[sel] + ht + rng.normal(0, 0.03, sel.sum())
            cls[sel] = 6
        veg = (cls == 2) & (rng.random(n) < 0.15)   # canopy returns
        z[veg] += rng.uniform(2, 20, int(veg.sum()))
        cls[veg] = 5
        c = pcr.PointCloud.create(n)
        c.set_x_array(origin[0] + x)
        c.set_y_array(origin[1] + y)
        c.add_channel("z", pcr.DataType.Float32)
        c.set_channel_array_f32("z", z.astype(np.float32))
        c.add_channel("intensity", pcr.DataType.Float32)
        inten = np.where(cls == 6, rng.uniform(800, 2000, n),
                         rng.uniform(100, 900, n))
        c.set_channel_array_f32("intensity", inten.astype(np.float32))
        c.add_channel("classification", pcr.DataType.Float32)
        c.set_channel_array_f32("classification", cls)
        c.set_crs(pcr.CRS.from_epsg(32110))
        pcr.write_point_cloud(
            os.path.join(directory, f"tile_{i:04d}.las"), c,
            pcr.PointCloudFormat.LAS)
    return extent


def scan_bounds(files):
    """First pass: the union of the files' bounds (from the headers where
    they hold them) and their total point count."""
    bbox = pcr.BBox()
    total = 0
    for path in files:
        info = pcr.read_point_cloud_info(path)
        total += info.num_points
        if info.bounds.valid():
            bbox.expand(info.bounds)
        else:
            cloud = pcr.read_point_cloud(path)
            bbox.expand(float(cloud.x_array().min()),
                        float(cloud.y_array().min()))
            bbox.expand(float(cloud.x_array().max()),
                        float(cloud.y_array().max()))
    return bbox, total


def run_mode(mode, files, gc, spec, chunk, out):
    """Stream every file through one Pipeline in `mode`; returns (per-phase
    stats, band)."""
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [spec]
    cfg.exec_mode = MODE_MAP[mode]
    cfg.output_path = out
    pipe = pcr.Pipeline.create(cfg)

    buf = pcr.PointCloud.create(chunk)
    warm_s = 0.0
    if mode != "cpu":
        # one-time device costs (the kernels' build, CUDA start-up),
        # reported apart from the run
        t0 = time.perf_counter()
        pipe.warmup(chunk_points=chunk)
        warm_s = time.perf_counter() - t0

    timer = PhaseTimer()
    t_start = time.perf_counter()
    done = 0
    for path in files:
        reader = pcr.PointCloudReader.open(path)
        while not reader.eof():
            with timer.phase("io_read"):
                n = reader.read_chunk(buf, chunk)
            if n == 0:
                break
            with timer.phase("ingest"):
                pipe.ingest(buf)
            done += n
        elapsed = time.perf_counter() - t_start
        print(f"[{mode}] {os.path.basename(path):20s} "
              f"total {done / 1e6:7.1f}M  "
              f"lib {done / max(timer.seconds('ingest'), 1e-9) / 1e6:7.2f} "
              f"Mpts/s  wall {done / elapsed / 1e6:6.2f} Mpts/s", flush=True)

    # The card runs the kernels asynchronously; without a drain their tail
    # would land in finalize_s and flatter the ingest-only library rate.
    with timer.phase("drain"):
        dev = getattr(getattr(pipe, "_engine", None), "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with timer.phase("finalize"):
        pipe.finalize()

    band = pipe.result().band_array(0)
    coverage = 100.0 * float(np.isfinite(band).mean())
    wall = time.perf_counter() - t_start
    ingest_total = timer.seconds("ingest") + timer.seconds("drain")
    return {
        "mode": mode, "points": done, "wall_s": round(wall, 3),
        "warmup_s": round(warm_s, 3),
        "io_read_s": round(timer.seconds("io_read"), 3),
        "ingest_s": round(timer.seconds("ingest"), 3),
        "drain_s": round(timer.seconds("drain"), 3),
        "finalize_s": round(timer.seconds("finalize"), 3),
        "library_mpts_per_s": round(done / max(ingest_total, 1e-9) / 1e6,
                                    2),
        "wall_mpts_per_s": round(done / wall / 1e6, 2),
        "coverage_pct": round(coverage, 1),
    }, band


def input_files(directory):
    return sorted(sum((glob.glob(os.path.join(directory, pat))
                       for pat in ("*.las", "*.laz", "*.pcrp", "*.csv")),
                      []))


def make_grid(bbox, cell):
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = cell, -cell
    gc.crs = pcr.CRS.from_epsg(32110)
    gc.compute_dimensions()
    return gc


def make_spec(glyph, value_channel, reduction, sigma):
    if glyph == "gauss":
        return pcr.gaussian_splat_spec(value_channel, default_sigma=sigma)
    spec = pcr.ReductionSpec()
    spec.value_channel = value_channel
    spec.type = getattr(pcr.ReductionType, reduction)
    return spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--synthesize", type=int, default=0)
    ap.add_argument("--pts-per-file", type=int, default=500_000)
    ap.add_argument("--skew", type=float, default=0.0,
                    help="density skew fraction (0 = uniform; 0.5 = half "
                         "of each tile's points in hot clusters, with a "
                         "power-law core across tiles)")
    ap.add_argument("--extent", type=float, default=4000.0)
    ap.add_argument("--cell", type=float, default=1.0)
    ap.add_argument("--synthesize-only", action="store_true",
                    help="generate the dataset and exit (no pipeline run)")
    ap.add_argument("--modes", nargs="+", default=["gpu"],
                    choices=list(MODE_MAP))
    ap.add_argument("--value-channel", default="z")
    ap.add_argument("--reduction", default="Average")
    ap.add_argument("--glyph", default="point", choices=["point", "gauss"])
    ap.add_argument("--sigma", type=float, default=3.0)
    ap.add_argument("--chunk", type=int, default=2_000_000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "pcr_lidar.tif"))
    ap.add_argument("--stats-json", default="")
    ap.add_argument("--csv", default="",
                    help="write a mode_comparison.csv-style table")
    args = ap.parse_args(argv)

    if args.synthesize:
        synthesize(args.input, args.synthesize,
                   pts_per_file=args.pts_per_file, skew=args.skew,
                   extent=args.extent)
    if args.synthesize_only:
        return 0

    files = input_files(args.input)
    if not files:
        print(f"no point cloud files in {args.input}", file=sys.stderr)
        return 2

    bbox, total_pts = scan_bounds(files)
    print(f"{len(files)} files, {total_pts / 1e6:.1f}M points, "
          f"bounds [{bbox.min_x:.0f},{bbox.min_y:.0f}]-"
          f"[{bbox.max_x:.0f},{bbox.max_y:.0f}]")
    gc = make_grid(bbox, args.cell)
    print(f"grid {gc.width}x{gc.height} = "
          f"{gc.total_cells() / 1e6:.1f}M cells")
    spec = make_spec(args.glyph, args.value_channel, args.reduction,
                     args.sigma)

    rows, bands = [], {}
    for mode in args.modes:
        stats, band = run_mode(mode, files, gc, spec, args.chunk, args.out)
        rows.append(stats)
        bands[mode] = band
        print(f"[{mode}] wall {stats['wall_s']}s  io {stats['io_read_s']}s"
              f"  ingest {stats['ingest_s']}s  drain {stats['drain_s']}s  "
              f"finalize {stats['finalize_s']}s  "
              f"coverage {stats['coverage_pct']}%")

    base = rows[0]["wall_s"]
    for r in rows:
        r["speedup_vs_first"] = round(base / r["wall_s"], 2)
    if len(bands) > 1:
        ms = list(bands)
        a, b = bands[ms[0]], bands[ms[1]]
        agree = bool(np.allclose(a, b, atol=1e-5, rtol=1e-5,
                                 equal_nan=True))
        print(f"modes {ms[0]} vs {ms[1]} agree at 1e-5: {agree}")

    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump({"files": len(files), "grid": [gc.width, gc.height],
                       "modes": rows}, f, indent=2)
        print(f"wrote {args.stats_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""
Smoke test of the PyTorch / CUDA port (pcr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

It stops at the first failure with a nonzero exit and prints no result.
Phases:
  (a) environment: the card's name and power limit (nvidia-smi), torch and
      CUDA versions, and the nvcc build of every kernel under
      pcr_tpu_torch/csrc (with ptxas's register / shared-memory report);
  (b) kernel K1 against its plain PyTorch version on the card, on the
      layouts of 5M uniform points on a 1000x1000 grid (Average and
      WeightedAverage) and of the main path's 160x160 grid: atol = rtol =
      1e-5 (the two add the same float32 values in different orders), the
      same touched footprint, bit-identical kernel reruns, and both times
      from CUDA events after a warm-up; beside them the two one-call
      rivals over the precomputed live cells (index_add_, atomic, and
      index_put_(accumulate=True) under deterministic algorithms) and
      K1's byte bound;
  (c) the main path, the bench's primary harness: 160x160 grid, 1 m cells,
      EPSG:32610, 5M points, Average, state_dir + output_path, stage ->
      ingest(staged) -> finalize; band against the numpy CPU oracle, the
      GeoTIFF read back, and a resume from state_dir;
  (d) the README quickstart: 1000x1000 grid, 1M host-sourced points,
      Average + Max + Min + MostRecent on one pipeline;
  (e) DC-LiDAR scale: 8192x8192 grid (64M cells), 20M staged points,
      Average;
  (f) kernels K2 (separable Gaussian), K4 (dense rotated) and K5 (windowed
      rotated) against their plain PyTorch versions on the card, on the
      layouts of the glyph suite: 5M uniform points on a 1000x1000 grid,
      Average, sigma 1 (K2 with the product cutoff), 4 and 16 (K2),
      rotated 4 x 1.5 (K5) and 8 x 3 (K4); the same touched footprint,
      bit-identical kernel reruns, a tolerance that grows with the terms
      per cell (see gauss_rtol), and both times from CUDA events; then K4
      and K2 on 200k points of mixed sign on the same grid cut into
      256-cell tiles (the home-tile clip);
  (g) Gaussian pipelines on the 1000x1000 grid against the numpy oracle
      (1e-5 per cell, exact NaN footprint): sigma 4 Average 1M staged with
      state_dir + GeoTIFF + resume, sigma 1 WeightedAverage 1M, rotated
      4 x 1.5 Average 1M host-sourced, rotated 8 x 3 Count + Sum 250k and
      sigma 16 Average 250k (the oracle's per-offset loop keeps the wide
      windows small); then the walls of the sigma 4, 5M staged path;
  (h) kernel K3 (the rect splat of Line runs) against its plain PyTorch
      version on the card, on the Line layouts of the glyph suite: a
      1000x1000 grid, half length 1, 4 and 16 at direction 0 with 5M points
      and half length 16 at direction 0.7 (multi-run staircases) with 1M,
      each with two fields (WeightedAverage) and one (Sum); the same
      touched footprint, bit-identical kernel reruns, atol = rtol = 1e-5
      (the same terms in another order), and both times from CUDA events;
      each row with its live entries, the dead ones inside a tile's run
      (none: both Line routes drop the runs a clip empties), the longest
      and the mean tile run in sub-chunks, and the walk's records and hits;
  (i) Line pipelines on the 1000x1000 grid against the numpy oracle (1e-5
      per cell, exact NaN footprint): half length 4 WeightedAverage 1M
      staged with state_dir + GeoTIFF + resume, half length 16 direction
      0.7 Sum 1M host-sourced, per-point direction and half length Average
      1M, Count with a value channel 1M (the oracle adds 1 per cell), a
      multi-tile grid (256-cell tiles, the home-tile clip); then the walls
      of the half length 16, 5M staged path;
  (j) kernel K6 (the rot-expand probe) through its entry point at the
      probe's defaults (nsub 64, block 2048, nq 9), then against its plain
      version, both times from CUDA events; beside its bound the floor its
      design allows: one launch (timed here on one empty step) plus the
      longest chain of dependent adds at the card's top clock;
  (k) host-sourced ingest, where the card lays the chunks out itself
      (engine/device_prep.py): for Point Average (160x160 and 1000x1000,
      5M), Gaussian sigma 4, rotated 8 x 3 and 4 x 1.5 (5M), Line half
      length 16 at direction 0 (5M) and 0.7 (1M), the same cloud staged
      (Pipeline.stage, one chunk) by the host route (PCR_WIRE_CHEAP=0) and
      by the device route must give equal params and bids on the card (the
      script fails otherwise); each row with its entries, both routes'
      stage seconds, and, three times, the device route's ms by CUDA
      events from the end of the upload (device_prep.timeline), split into
      expand (decode, halo copies or runs), sort (the stable sort by tile)
      and finish (counts, planes, the scatter into sub-chunks), and its
      peak device memory. Then, per row, pipelines by every way in, each
      three times: stage by the host route (the reference band), stage by
      the device route, ingest(cloud) in GPU mode and in Hybrid mode with 1
      worker, every band bit-identical to the reference; then GPU mode
      with chunks of tiling.INGEST_CHUNK_POINTS and Hybrid mode with 2 and
      4 workers, which cuts a cloud so, bit-identical to each other and
      within 1e-5 of the reference; the launch counters read, and the best
      stage / ingest / finalize walls of the three. One Hybrid 1M row of
      each glyph is held against the oracle in (d), (g) and (i). Last,
      pageable against pinned upload rates and the card's busy share over
      one Hybrid ingest (torch.profiler);
  (l) out-of-core bands (gpu_memory_budget, engine/out_of_core.py): Point
      Average on a 16384x16384 grid (268M cells, 1 m, EPSG:32610, 512-cell
      tiles) with 20M uniform points under 1 GiB (8 bands of 2048 rows),
      against the resident engine and the numpy oracle, with state_dir +
      GeoTIFF read back and a banded resume; on an 8192x8192 grid with
      512-cell tiles under 64 MiB, Gaussian sigma 4 Average 5M (K2),
      rotated 8 x 3 Average 1M (K4) and Line half length 16 Average 5M
      (K3); on a 4096x4096 grid of one tile (footprints cross the bands)
      Gaussian sigma 4 Average 1M under 96 MiB, also against the oracle.
      Each row: the resident engine (stage, ingest(staged)), the banded
      engine the same way and host-sourced; the banded band within 1e-5 of
      the resident one (and whether its bits are equal), banded reruns
      bit-identical; on the middle band's and the last band's staged
      chunks, the row's kernel against its plain version on a fresh band
      state (K2 / K4 at the tolerance of (f), K1 and K3 at 1e-5), reruns
      bit-identical; the bands and swaps, the bytes each way and their
      GB/s (pageable copies), the walls; the band state, which must stay
      under the budget (gpu_memory_budget bounds it), what ingest(staged)
      and finalize add beside the staged cloud, which must stay under the
      budget plus the largest band's layout, and the peak device memory of
      the staged and of the host-sourced run, which must stay under the
      budget plus the staged layout plus the resident engine's staging
      scratch (its staging peak less its layout, measured in the same
      row);
  (m) Custom reductions on the quickstart grid (1000x1000, 1M host-sourced
      points) against the oracle: RMS (K = 2, one K1 launch a chunk), a
      K = 3 sum op (two launches), a max-kind op (exact, the torch
      scatter), and the K = 3 op under a 12 MiB budget that bands it
      (two launches a band); reruns bit-identical;
  (n) multi-device meshes (pcr_tpu_torch/parallel), four shards on the one
      card (mesh_devices = [cuda:0] * 4): on a 4096x4096 grid of one tile
      (ShardedTorchEngine) 20M points, Average + Max + MostRecent, at
      (dp, sp) = (2, 2) and (1, 4), then Gaussian sigma 4 and Line half
      length 16 Average 5M at sp = 4 (footprints cross the shard borders);
      on tiled grids (PartitionedTorchEngine) (e)'s 8192x8192 20M Average
      with state_dir + GeoTIFF read back + a resume, and rotated 8 x 3 (K4)
      and 4 x 1.5 (K5) Average 1M on 4096x4096 in 512-cell tiles, every
      centre within r rows of a shard border; each against the resident
      engine's band of the same cloud (Average within 1e-5, Gaussians at
      gauss_rtol, Max and MostRecent exactly); (d)'s quickstart at
      (2, 2) against its oracle bands; the library steps of
      parallel/sharding.py on 1000x1000 against the resident engine's
      state (the rotated step against the oracle's, whose algebra it
      shares), each run twice, bit-identical. Each mesh row: three runs
      (staged, then one host-sourced run more, bits equal), the engine,
      its shards, the launches of K1-K5, the best walls and the peak
      device memory of one run beside the resident engine's, and the
      row's kernel against its plain version on the middle and last
      shards' staged chunks (K2 and K4 at gauss_rtol, K1, K3 and K5 at the
      row's tolerance), reruns bit-identical;
  (o) K4 and K5 far from the origin: on an 8192x8192 grid in 512-cell
      tiles, rotated 8 x 3 (K4, 25k points) and 4 x 1.5 (K5, 100k points)
      Average, each cloud with centres in rows and columns [7680, 8192)
      and the same cloud shifted into [0, 512) (points cut so the oracle's
      loop stays short; the extent is the DC-LiDAR grid's). The pipeline
      band against the numpy oracle: each block within 1e-5 relative to
      the cell's sum of |terms| (positive values: the band), the exact NaN
      footprint, and the far block's largest error at most 1.5x the near
      block's (the kernels form the distance to the centre from the integer
      difference, so it does not drift as rows and columns grow); then the
      kernel against its plain version on the far block's sub-chunks
      (gauss_rtol), reruns bit-identical;
  (p) the user entry points (pcr_tpu_torch.examples and .scripts): the six
      examples at their defaults on the card against the same example with
      ExecutionMode.CPU (1e-5 per cell, exact NaN footprint; smiley_face's
      eye cells, ~1.3e4 float32 terms of the value 3 each, card and CPU
      alike against the exact Average 3), the multichip example's mesh on
      [cuda:0] * 4 against the resident engine's bands; the LiDAR harness
      at DC-LiDAR scale (--synthesize 40 --pts-per-file 500000 --extent
      8192 --skew 0.5: 20M points, 8192x8192, Point Average) in gpu,
      hybrid and cpu mode (gpu within 1e-5 of cpu, hybrid bit for bit
      gpu), then --glyph gauss --sigma 3 on the first 4 files, gpu against
      cpu at gauss_rtol of each cell's term count (cell_rtol: the hot
      clusters pile up to ~1.5e4 terms in a cell), each mode's io_read_s /
      ingest_s / drain_s / finalize_s / library_mpts_per_s printed; the
      glyph patterns, scenes 01-08 in gpu and cpu mode, every raster
      PASSing the comparator. The LiDAR gpu Point row's finalize is split
      on the host's clock (finalize_split): the device finalize and its
      copy to the host, the touched-tile masking of each strip, and on
      the writer's thread the GeoTIFF's tile codec, its file writes and
      its tile copies;
  (q) the diagnostics and the quick validation
      (pcr_tpu_torch.scripts.diagnostics, .quick_validation), in this
      process: device_health (quick validation's section 1: the probes,
      K1 against its plain version, 2 GB on the card), boundary_points
      (PASS: bit-identical to the CPU, 10 points counted) and
      transfer_sizes, each exiting 0, with the pinned 256 MB H2D rate
      beside (k)'s upload_rates; grid_sizes --mode GPU at its defaults
      (eight sizes, 1x1 to 3001x1999, 100k points, Count); the same eight
      sizes on the card against CPU mode with Count (exactly), sigma 4
      Gaussian (K2) and Line half length 4 (K3) Average (1e-5, or
      gauss_rtol of a cell's terms, cell_rtol, where the one-cell and
      one-row grids pile up to 1e5 terms); then quick validation's
      quickstart (a process of its own) and ladder (CPU and Auto each sum
      1000 ones, Auto on the card).
The card's SM clock, temperature, power draw and active clock-limit
reasons are printed ("card state") after the build and after each phase
that times a kernel ((b), (f), (h), (j)), and beside the kernels line, so
a slow run shows whether the card was held back.
Every pipeline runs with gpu_require_strict and must run on a TorchEngine
on the card (an OutOfCoreTorchEngine of several bands where (l) and (m)
set a budget, a mesh engine with every shard on the card where (n) sets
a mesh), through its kernels: each path is driven with the launch
counters set to 0 just before it and read just after; the kernels line
counts the launches of the main paths and of (l)-(q). Nothing of
pcr_tpu or jax may be imported (checked at the end). The line before last is a JSON
summary of the kernels, each with its bound: the larger of the bytes it
must move (each input read once, each output written once) over 3.35 TB/s
and the float32 operations its data needs over 67 TFLOP/s (the H100 SXM's
data-sheet peaks); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260101
TOL = 1e-5
ORACLE_S = []           # the CPU oracle's ingest walls, for the last report
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_FLOP_S = 67e12      # H100 SXM float32 peak outside the tensor cores
SM_CLOCK_HZ = 1.98e9    # H100 SXM top SM clock; a float32 add takes 4 clocks


SMI_STATE = ("clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
             "power.limit")


def card_state(where):
    """Print the card's SM clock (and its maximum), temperature, power
    draw and limit and the active clock-limit reasons, as nvidia-smi reads
    them now; nvidia-smi names the reasons clocks_event_reasons in newer
    drivers and clocks_throttle_reasons in older ones."""
    for reasons in ("clocks_event_reasons.active",
                    "clocks_throttle_reasons.active"):
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_STATE},{reasons}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0:
            print(f"card state {where}: {SMI_STATE},{reasons} = "
                  f"{smi.stdout.strip().splitlines()[0]}")
            return
    print(f"card state {where}: nvidia-smi could not read it: "
          f"{smi.stdout.strip()} {smi.stderr.strip()}")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def close(got, want, what, atol=TOL, rtol=TOL):
    """Same NaN footprint, and |got - want| <= atol + rtol * |want|."""
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != "
                                   f"{want.shape}")
    check(np.array_equal(np.isnan(got), np.isnan(want)),
          f"{what}: NaN footprints differ")
    m = ~np.isnan(want)
    err = float(np.abs(got[m] - want[m]).max()) if m.any() else 0.0
    excess = (np.abs(got[m] - want[m]) - (atol + rtol * np.abs(want[m]))
              if m.any() else np.zeros(1))
    check(float(excess.max()) <= 0, f"{what}: max |diff| {err} over "
                                    f"atol={atol} rtol={rtol}")
    return err


def grid(pcr, size, epsg, tile=None):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, size, size
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(epsg)
    if tile:
        gc.tile_width = gc.tile_height = tile
    gc.compute_dimensions()
    return gc


def cloud(pcr, n, lo, hi, vmax, seed, ts=False, line_channels=False):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(lo, hi, n))
    c.set_y_array(rng.uniform(lo, hi, n))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value",
                            rng.uniform(0, vmax, n).astype(np.float32))
    if ts:
        c.add_channel("ts", pcr.DataType.Float32)
        c.set_channel_array_f32("ts", rng.integers(0, 1000, n)
                                .astype(np.float32))
    if line_channels:
        for name, arr in (("dir", rng.uniform(-np.pi, np.pi, n)),
                          ("hl", rng.uniform(0.5, 16.0, n))):
            c.add_channel(name, pcr.DataType.Float32)
            c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def run_pipeline(pcr, gc, specs, c, mode, staged=False, state_dir="",
                 output_path="", workers=0, chunk_size=0, budget=0,
                 mesh=None):
    """One pipeline lifecycle; returns (pipeline, bands, walls). With a
    `budget` the pipeline must band (an OutOfCoreTorchEngine of more than
    one band); with a `mesh` ({"mesh_devices": ..., "mesh_dp": ...,
    "mesh_sp": ...}) it must run a mesh engine, every shard on the card;
    without either it must run resident."""
    import torch
    cfg = pcr.PipelineConfig()
    for k, v in (mesh or {}).items():
        setattr(cfg, k, v)
    cfg.gpu_memory_budget = budget
    cfg.hybrid_cpu_threads = workers
    cfg.chunk_size = chunk_size
    cfg.grid = gc
    cfg.reductions = specs
    cfg.exec_mode = mode
    cfg.gpu_require_strict = True
    cfg.state_dir = state_dir
    cfg.output_path = output_path
    t0 = time.perf_counter()
    p = pcr.Pipeline.create(cfg)
    t1 = time.perf_counter()
    src = p.stage(c) if staged else c
    t2 = time.perf_counter()
    p.ingest(src)
    if p._engine is not None:
        p._engine.block_until_ready()
    t3 = time.perf_counter()
    p.finalize()
    t4 = time.perf_counter()
    if mode != pcr.ExecutionMode.CPU and mesh:
        from pcr_tpu_torch.parallel.engine import (PartitionedTorchEngine,
                                                   ShardedTorchEngine)
        eng = p._engine
        check(isinstance(eng, (ShardedTorchEngine, PartitionedTorchEngine))
              and all(e.device.type == "cuda" for e in eng.owners),
              f"the mesh pipeline runs on {eng!r}, not a mesh engine with "
              f"every shard on the card")
        torch.cuda.synchronize()
    elif mode != pcr.ExecutionMode.CPU:
        eng = p._engine
        from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
        from pcr_tpu_torch.engine.torch_backend import TorchEngine
        want = OutOfCoreTorchEngine if budget else TorchEngine
        check(isinstance(eng, want) and eng.device.type == "cuda"
              and (not budget or eng.nbands > 1),
              f"the device pipeline runs on {eng!r}, not a CUDA "
              f"{want.__name__}" + (" of several bands" if budget else ""))
        torch.cuda.synchronize()
    walls = {"create": t1 - t0, "stage": t2 - t1, "ingest": t3 - t2,
             "finalize": t4 - t3}
    if mode == pcr.ExecutionMode.CPU:
        ORACLE_S.append(t3 - t2)
    return p, [p.result().band_array(i) for i in range(len(specs))], walls


def hybrid_vs_oracle(pcr, gc, specs, c, oracle, label, fns, exact=()):
    """One host-sourced Hybrid pipeline (2 workers, 250k-point chunks, so
    the pool has chunks to prepare ahead) against oracle bands computed
    before; bands listed in `exact` must match bit for bit."""
    for f in fns:
        f.launches = 0
    _, bands, w = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.Hybrid,
                               workers=2, chunk_size=250_000)
    check(all(f.launches >= 1 for f in fns),
          f"{label}: Hybrid mode never launched a kernel of its path")
    errs = [0.0]
    for i, (g, o) in enumerate(zip(bands, oracle)):
        if i in exact:
            check(np.array_equal(g, o, equal_nan=True),
                  f"{label}: Hybrid band {i} differs from the oracle")
        else:
            errs.append(close(g, o, f"{label}: Hybrid band {i} vs oracle"))
    print(f"{label}, Hybrid 2 workers host-sourced: {fmt(w)} launches="
          f"{[f.launches for f in fns]} max_abs_err={max(errs)!r}")


def fmt(walls):
    return " ".join(f"{k}={v:.4f}s" for k, v in walls.items())


def bound(nbytes, nops):
    """(bound_ms, bound_by): the least time for `nbytes` of device memory
    traffic and `nops` float32 operations, whichever is larger."""
    b, o = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def io_bytes(params, bids, states):
    """A splat's bytes: params and bids read once, the states read and
    written once."""
    return (params.numel() * params.element_size() + bids.numel() * 4
            + 2 * sum(s.numel() * 4 for s in states))


def window_cells(torch, bids, th, wt, ncb, x0, x1, y0, y1):
    """Cells of each entry's inclusive rectangle [x0, x1] x [y0, y1]
    ((nsub, block) tensors) inside its sub-chunk's (th, wt) tile, summed:
    the cells this run's data needs evaluated."""
    b = bids.long()[:, None]
    c0, r0 = (b % ncb * wt).double(), (b // ncb * th).double()
    nx = (torch.minimum(x1.double(), c0 + wt - 1)
          - torch.maximum(x0.double(), c0) + 1).clamp(min=0)
    ny = (torch.minimum(y1.double(), r0 + th - 1)
          - torch.maximum(y0.double(), r0) + 1).clamp(min=0)
    return float((nx * ny).sum())


def k1_case(torch, kernels, eng, staged, with_f1, label, reps):
    """K1 against its plain version on one staged layout, then against the
    one-call rivals and its bound. Returns a dict of the row's numbers."""
    p, b = staged.params, staged.bids
    shape = eng._states[0][0].shape
    kw = dict(th=kernels.TH, wt=eng.WT, with_f1=with_f1)

    def fresh():
        return [torch.zeros(shape, device=eng.device) for _ in range(2)]

    got, ref, again = fresh(), fresh(), fresh()
    kernels.sorted_splat_point(got, p, b, **kw)
    kernels.sorted_splat_point_plain(ref, p, b, **kw)
    kernels.sorted_splat_point(again, p, b, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
              for x, y in zip(got, again)),
          f"K1 {label}: reruns are not bit-identical")
    check(torch.equal(got[1] > 0, ref[1] > 0),
          f"K1 {label}: touched footprints differ")
    err = max(close(g.cpu().numpy(), r.cpu().numpy(), f"K1 {label}")
              for g, r in zip(got, ref))

    scratch = fresh()
    ms, plain_ms, t = time_turns(
        torch, lambda: kernels.sorted_splat_point(scratch, p, b, **kw),
        lambda: kernels.sorted_splat_point_plain(scratch, p, b, **kw),
        reps=reps, plain_reps=reps)
    print(f"(b) K1 {label}: nsub={p.shape[0]} max_abs_err={err!r} "
          f"kernel_ms={ms!r} plain_ms={plain_ms!r} (turns: {t})")

    # the rivals: one PyTorch call per field over the precomputed live
    # cells and their values (what the plain version reduces to)
    h_pad, w_pad = shape
    ncb = w_pad // eng.WT
    bid = b.long()[:, None]
    c0, r0 = bid % ncb * eng.WT, bid // ncb * kernels.TH
    icx, icy = p[:, 0].long(), p[:, 1].long()
    live = ((bid >= 0) & (bid < h_pad // kernels.TH * ncb)
            & (icx >= c0) & (icx < c0 + eng.WT)
            & (icy >= r0) & (icy < r0 + kernels.TH))
    cells = (icy * w_pad + icx)[live]
    vals = [p[:, 2].view(torch.float32)[live],
            (p[:, 3].view(torch.float32)[live] if with_f1
             else torch.ones(cells.shape, device=cells.device))]

    def index_add():
        for s, v in zip(scratch, vals):
            s.view(-1).index_add_(0, cells, v)

    def index_put():
        torch.use_deterministic_algorithms(True)
        for s, v in zip(scratch, vals):
            s.view(-1).index_put_((cells,), v, accumulate=True)
        torch.use_deterministic_algorithms(False)

    rivals = {}
    for name, fn in (("index_add_", index_add),
                     ("index_put_ deterministic", index_put)):
        k_ms, r_ms, t = time_turns(
            torch, lambda: kernels.sorted_splat_point(scratch, p, b, **kw),
            fn, reps=reps, plain_reps=reps)
        rivals[name] = r_ms
        print(f"(b) K1 {label}: {name} over {cells.numel()} live cells "
              f"rival_ms={r_ms!r} kernel_ms={k_ms!r} (turns: {t})")
    bms, by = bound(io_bytes(p, b, scratch), live.sum().item() * 2)
    print(f"(b) K1 {label}: bound_ms={bms!r} ({by}) group="
          f"{kernels.k1_group_size(p.shape[0])}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=rivals["index_add_"],
                rival_ms=rivals["index_put_ deterministic"])


def time_turns(torch, kern, plain, reps, plain_reps):
    """Mean CUDA-event ms of kern and plain over the turns plain, kernel,
    kernel, plain, after one warm-up call of each."""
    def time_ms(fn, k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k

    plain()
    kern()
    t = {"plain": [], "kernel": []}
    for name, fn, k in (("plain", plain, plain_reps), ("kernel", kern, reps),
                        ("kernel", kern, reps), ("plain", plain, plain_reps)):
        t[name].append(time_ms(fn, k))
    return float(np.mean(t["kernel"])), float(np.mean(t["plain"])), t


def gauss_rtol(n, size, r):
    """Tolerance of a raw Gaussian state sum, kernel vs plain. Both sum
    the same K ~ (points per cell) x (2r + 1)^2 positive float32 terms per
    cell in different orders; the difference of two such sums has a
    standard deviation of about sqrt(K) * 2^-24 relative, so 8 of those
    (a 5-sigma maximum over a million cells, with room) is the bar, and
    never below the repo's 1e-5. At sigma 16 (K ~ 2e4) it is ~9e-5."""
    k = n / (size * size) * (2 * r + 1) ** 2
    return max(TOL, 8.0 * np.sqrt(k) * 2.0 ** -24)


def cell_rtol(gc, x, y, r):
    """gauss_rtol cell by cell: each cell's K is the number of points whose
    centre lies within r cells of it on both axes (an upper bound of the
    terms a Gaussian of radius r adds there), from a box sum of the
    centres' histogram. Where a cloud piles into hot clusters, a cell
    can sum 1e4 terms, and two orders of them (the card's and the numpy
    oracle's, both float32) differ by more than 1e-5."""
    from pcr_tpu_torch.engine import routing
    col, row, ok = routing.assign(gc, x, y)
    H, W, k = gc.height, gc.width, 2 * r + 1
    hist = np.bincount(row[ok].astype(np.int64) * W + col[ok],
                       minlength=H * W).reshape(H, W)
    cs = np.pad(hist, ((r + 1, r), (r + 1, r))).cumsum(0).cumsum(1)
    terms = cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]
    return np.maximum(TOL, 8.0 * np.sqrt(terms) * 2.0 ** -24), terms


def walk_hits(torch, gk, chunk, geom, ncb):
    """(entry, block) hits of a K2 / K4 / K5 chunk's walk: how often a warp
    evaluates an entry over its 8 x 32 block (gauss_kernels.block_hits)."""
    pr, total = chunk.params, 0
    for a in range(0, pr.shape[0], 256):
        p = pr[a:a + 256]
        if chunk.kind == "rotp":
            win = (p[:, 6], p[:, 7], p[:, 8], p[:, 9])
        elif chunk.kind == "rot":
            win = gk.rot_dense_windows(p[:, 6], p[:, 7], p[:, 8], geom)
        else:
            win = gk.gauss_windows(p[:, 0], p[:, 1], p[:, 6], geom)
        total += int(gk.block_hits(win, chunk.bids[a:a + 256], chunk.th,
                                   chunk.wt, ncb).sum())
    return total


def gauss_case(torch, pcr, gk, size, n, label, glyph, want_kind, seed,
               tile=None, mixed=False):
    """(f): one Gaussian layout of n uniform points, staged through the
    port's Pipeline, held kernel against plain. `mixed` gives the values
    both signs; the tolerance is then relative to each cell's sum of
    |terms| (the plain version on |f0|), which bounds what another order
    of the same terms can move."""
    gc = grid(pcr, size, 3857, tile=tile)
    spec = pcr.gaussian_splat_spec("value", **glyph)
    spec.type = pcr.ReductionType.Average
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True))
    c = cloud(pcr, n, 0.0, float(size), 100.0, seed)
    if mixed:
        rng = np.random.default_rng(seed + 1)
        c.set_channel_array_f32("value", (
            rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n)).astype(
                np.float32))
    (chunk,) = p.stage(c).per_spec[0]
    check(chunk.kind == want_kind, f"{label}: routed to {chunk.kind}, not "
                                   f"{want_kind}")
    eng = p._engine
    kern, plain, kw = eng.splat_fns(chunk)
    pr, b = chunk.params, chunk.bids
    shape = eng._states[0][0].shape

    def fresh():
        return [torch.zeros(shape, device=eng.device) for _ in range(2)]

    got, ref, again = fresh(), fresh(), fresh()
    kern(got, pr, b, **kw)
    plain(ref, pr, b, **kw)
    kern(again, pr, b, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
              for x, y in zip(got, again)),
          f"{label}: reruns are not bit-identical")
    check(torch.equal(got[1] > 0, ref[1] > 0),
          f"{label}: touched footprints differ")
    r = int(min(np.ceil(3 * glyph.get("default_sigma_x",
                                      glyph.get("default_sigma", 1.0))),
                32))
    rtol = gauss_rtol(n, size, r)
    if mixed:
        f0 = 7 if chunk.kind == "gauss" else 5
        pa = pr.clone()
        pa[:, f0] = pa[:, f0].view(torch.float32).abs().view(pa.dtype)
        scale = fresh()
        plain(scale, pa, b, **kw)
        err = 0.0
        for g, w, sc in zip(got, ref, scale):
            d = (g - w).abs()
            check(bool((d <= rtol + rtol * sc).all()),
                  f"{label}: max |diff| {float(d.max())} over rtol={rtol} "
                  f"of the cells' sums of |terms|")
            err = max(err, float(d.max()))
    else:
        err = max(close(g.cpu().numpy(), w.cpu().numpy(), label, rtol, rtol)
                  for g, w in zip(got, ref))
    scratch = fresh()
    ms, plain_ms, turns = time_turns(
        torch, lambda: kern(scratch, pr, b, **kw),
        lambda: plain(scratch, pr, b, **kw), reps=3, plain_reps=1)
    # the bound: the cells of each entry's window inside its tile, each a
    # weight (K2: wy * wx, 1 op; K4/K5: the completed square and exp2, 5
    # ops) and one FMA a field
    ncb = shape[1] // chunk.wt
    seg = lambda i: pr[:, i].float()
    if chunk.kind == "rotp":
        win = (seg(6), seg(7), seg(8), seg(9))
    else:
        cx, cy, r = ((seg(0), seg(1), seg(6)) if chunk.kind == "gauss"
                     else (seg(6), seg(7), seg(8)))
        win = (cx - r, cx + r, cy - r, cy + r)
    cells = window_cells(torch, b, chunk.th, chunk.wt, ncb, *win)
    per_cell = (1 if chunk.kind == "gauss" else 5) + 2 * len(scratch)
    bms, by = bound(io_bytes(pr, b, scratch), cells * per_cell)
    plan = gk.splat_plan(chunk.kind, chunk.th, chunk.wt)
    print(f"(f) {label}: {chunk.kind} th={chunk.th} wt={chunk.wt} "
          f"cut={chunk.cut} nsub={pr.shape[0]} slices={plan.slices} "
          f"smem={plan.smem_bytes} walk_hits="
          f"{walk_hits(torch, gk, chunk, eng.geom, ncb)} rtol={rtol:.3g} "
          f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
          f"window_cells={cells:.0f} bound_ms={bms!r} ({by}) "
          f"(turns: {turns})")
    return err, ms, plain_ms, (bms, by)


def gauss_pipeline(pcr, gk, gc, specs, c, label, kinds, staged=False,
                   state_dir="", output_path="", hybrid=False):
    """(g): one Gaussian pipeline on the card against the numpy oracle,
    with the launch counters of `kinds` set to 0 just before it and read
    just after. Returns (pipeline, bands, walls, launches)."""
    _, oracle, ow = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.CPU)
    fns = {"gauss": gk.sorted_splat_gauss, "rot": gk.rot_splat_dense,
           "rotp": gk.rot_splat_packed}
    for f in fns.values():
        f.launches = 0
    p, bands, w = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.GPU,
                               staged=staged, state_dir=state_dir,
                               output_path=output_path)
    launches = {k: f.launches for k, f in fns.items()}
    for k in kinds:
        check(launches[k] >= 1, f"(g) {label}: {k} was never launched")
    errs = [close(g, o, f"(g) {label} band {i} vs oracle")
            for i, (g, o) in enumerate(zip(bands, oracle))]
    print(f"(g) {label}: {fmt(w)} launches={launches} "
          f"max_abs_err={max(errs)!r} oracle: {fmt(ow)}")
    if hybrid:
        hybrid_vs_oracle(pcr, gc, specs, c, oracle, f"(g) {label}",
                         [fns[k] for k in kinds])
    return p, bands, w, launches


def lspec(pcr, rtype, name=None, **glyph):
    sp = pcr.line_splat_spec("value", output_band_name=name, **glyph)
    sp.type = rtype
    return sp


def rect_case(torch, pcr, lk, n, glyph, label, seed):
    """(h): K3 against its plain version on the Line layout of n uniform
    points on the 1000x1000 grid, staged through the port's Pipeline, with
    two fields (WeightedAverage) and one (Sum): a Line's f0 is its value
    in both, so the two share the layout. Returns {nf: (err, ms,
    plain_ms)}."""
    gc = grid(pcr, 1000, 3857)
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[lspec(pcr, pcr.ReductionType.WeightedAverage,
                                   **glyph)],
        exec_mode=pcr.ExecutionMode.GPU, gpu_require_strict=True))
    c = cloud(pcr, n, 0.0, 1000.0, 100.0, seed)
    t0 = time.perf_counter()
    (chunk,) = p.stage(c).per_spec[0]
    stage_s = time.perf_counter() - t0
    check(chunk.kind == "rect", f"{label}: routed to {chunk.kind}, not rect")
    pr, b, kw = chunk.params, chunk.bids, dict(th=chunk.th, wt=chunk.wt)
    shape = p._engine._states[0][0].shape
    ncb = shape[1] // chunk.wt
    nb_total = shape[0] // chunk.th * ncb
    # A tile's run is its live entries, then fill up to a whole sub-chunk.
    # An entry that is not live but has a live one after it in its run is
    # a dead rectangle the router kept: there must be none.
    alive = ((pr[:, 0] <= pr[:, 1]) & (pr[:, 2] <= pr[:, 3])).reshape(-1)
    pos = torch.arange(alive.numel(), device=alive.device)
    tile = b.long().repeat_interleave(pr.shape[2])
    last = torch.full((nb_total,), -1, device=alive.device).scatter_reduce(
        0, tile[alive], pos[alive], "amax")
    live = int(alive.sum())
    dead = int((~alive & (pos < last[tile])).sum())
    check(dead == 0, f"K3 {label}: {dead} dead rectangles inside tile runs")
    runs = torch.bincount(b.long(), minlength=nb_total)
    subs = int(runs.max())
    mean_subs = float(runs[runs > 0].float().mean())
    records, hits = lk.rect_walk_counts(pr, b, chunk.th, chunk.wt, ncb,
                                        nb_total)
    plan = lk.rect_plan(chunk.th, chunk.wt)
    del alive, pos, tile
    res = {}
    for nf in (2, 1):
        def fresh():
            return [torch.zeros(shape, device=p._engine.device)
                    for _ in range(nf)]

        got, ref, again = fresh(), fresh(), fresh()
        lk.rect_splat(got, pr, b, **kw)
        lk.rect_splat_plain(ref, pr, b, **kw)
        lk.rect_splat(again, pr, b, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in zip(got, again)),
              f"K3 {label} nf={nf}: reruns are not bit-identical")
        check(torch.equal(got[-1] != 0, ref[-1] != 0),
              f"K3 {label} nf={nf}: touched footprints differ")
        err = max(close(g.cpu().numpy(), r.cpu().numpy(),
                        f"K3 {label} nf={nf}") for g, r in zip(got, ref))
        scratch = fresh()
        ms, plain_ms, turns = time_turns(
            torch, lambda: lk.rect_splat(scratch, pr, b, **kw),
            lambda: lk.rect_splat_plain(scratch, pr, b, **kw), reps=5,
            plain_reps=2)
        # the bound: each run's cells inside its tile, one add a field
        cells = window_cells(torch, b, chunk.th, chunk.wt, ncb, pr[:, 0],
                             pr[:, 1], pr[:, 2], pr[:, 3])
        bms, by = bound(io_bytes(pr, b, scratch), cells * nf)
        print(f"(h) K3 {label} nf={nf}: nsub={pr.shape[0]} entries={live} "
              f"dead_entries={dead} max_subchunks_per_tile={subs} "
              f"mean_subchunks_per_tile={mean_subs:.1f} slices={plan.slices} "
              f"threads={plan.threads} smem={plan.smem_bytes} "
              f"records={records} walk_hits={hits} stage={stage_s:.4f}s "
              f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
              f"cells={cells:.0f} bound_ms={bms!r} ({by}) (turns: {turns})")
        res[nf] = (err, ms, plain_ms, (bms, by))
    return res


def line_pipeline(pcr, lk, gc, specs, c, label, staged=False, state_dir="",
                  output_path="", hybrid=False):
    """(i): one Line pipeline on the card against the numpy oracle, with
    K3's launch counter set to 0 just before it and read just after.
    Returns (pipeline, bands, walls, launches)."""
    _, oracle, ow = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.CPU)
    lk.rect_splat.launches = 0
    p, bands, w = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.GPU,
                               staged=staged, state_dir=state_dir,
                               output_path=output_path)
    launches = lk.rect_splat.launches
    check(launches >= 1, f"(i) {label}: K3 was never launched")
    errs = [close(g, o, f"(i) {label} band {i} vs oracle")
            for i, (g, o) in enumerate(zip(bands, oracle))]
    print(f"(i) {label}: {fmt(w)} K3 launches={launches} "
          f"max_abs_err={max(errs)!r} oracle: {fmt(ow)}")
    if hybrid:
        hybrid_vs_oracle(pcr, gc, specs, c, oracle, f"(i) {label}",
                         [lk.rect_splat])
    return p, bands, w, launches


def layout_split(marks):
    """(expand, sort, finish) ms of the chunks laid out inside one
    device_prep.timeline(): per chunk, from the last upload's mark to
    "layout", "sort0" to "sort1", and the rest up to "end"."""
    expand = sort = finish = 0.0
    up = None
    at = {}
    for name, ev in marks:
        if name == "uploaded":
            up = ev
            continue
        at[name] = ev
        if name == "end":
            expand += up.elapsed_time(at["layout"])
            sort += at["sort0"].elapsed_time(at["sort1"])
            finish += (at["layout"].elapsed_time(at["sort0"])
                       + at["sort1"].elapsed_time(ev))
    return expand, sort, finish


def both_routes(torch, pcr, gc, spec, c, label, reps=3):
    """(k): one cloud staged (`Pipeline.stage`, one chunk) by the host
    route and by the device route; fails unless params and bids are equal
    on the card. Prints the entries, each route's stage seconds, the
    device route's CUDA-event split (`reps` stages, each printed: the
    events follow the host's dispatch of some 40 launches, so they move
    with the host's load) and its peak device memory."""
    from pcr_tpu_torch.engine import device_prep as dp
    from pcr_tpu_torch.engine import routing
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True))
    t0 = time.perf_counter()
    routing.assign(gc, c.x_array(), c.y_array())
    assign_s = time.perf_counter() - t0

    def stage(wire):
        os.environ["PCR_WIRE_CHEAP"] = "1" if wire else "0"
        try:
            with dp.timeline() as marks:
                t0 = time.perf_counter()
                chunks = p.stage(c).per_spec[0]
                torch.cuda.synchronize()
                return chunks, time.perf_counter() - t0, marks
        finally:
            del os.environ["PCR_WIRE_CHEAP"]

    stage(True)                     # warm-up: pinned buffers, the allocator
    host, host_s, _ = stage(False)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = []
    for _ in range(reps):
        dev, dev_s, marks = stage(True)
        runs.append((dev_s, layout_split(marks)))
    peak = torch.cuda.max_memory_allocated() - base
    check(len(dev) == len(host) == 1,
          f"(k) {label}: {len(dev)} and {len(host)} chunks, not one")
    check([m[0] for m in marks] == ["uploaded", "layout", "sort0", "sort1",
                                    "end"],
          f"(k) {label}: the device route left marks "
          f"{[m[0] for m in marks]}")
    d, h = dev[0], host[0]
    check((d.kind, d.th, d.wt, d.cut) == (h.kind, h.th, h.wt, h.cut)
          and d.params.dtype == h.params.dtype
          and torch.equal(d.params.view(torch.int32),
                          h.params.view(torch.int32))
          and torch.equal(d.bids, h.bids),
          f"(k) {label}: the device route's bytes differ from the host "
          f"route's")
    pr = d.params
    if d.kind == "rect":
        live = (pr[:, 0] <= pr[:, 1]) & (pr[:, 2] <= pr[:, 3])
    elif d.kind == "point":
        live = pr[:, 1] >= 0
    elif d.kind == "rotp":
        live = pr[:, 6] <= pr[:, 7]
    else:
        live = pr[:, 8 if d.kind == "rot" else 6] >= 0
    split = "; ".join(
        f"stage {s:.4f}s, layout {sum(t):.3f} ms: expand={t[0]:.3f} "
        f"sort={t[1]:.3f} finish={t[2]:.3f}" for s, t in runs)
    print(f"(k) {label}: {d.kind} th={d.th} wt={d.wt} nsub={pr.shape[0]} "
          f"entries={int(live.sum())} layout_bytes="
          f"{pr.numel() * 4 + d.bids.numel() * 4} bytes equal; stage by the "
          f"host route {host_s:.4f}s; by the device route, {reps} times "
          f"({split}); peak_device_bytes={peak}; routing.assign alone "
          f"{assign_s:.4f}s")


def every_way_in(torch, pcr, gc, specs, c, label, fns, reps=3):
    """(k): one cloud through the pipeline by every way in, `reps` times
    each. Whole clouds first: the reference band comes from a stage by the
    host route, and the device-route stage, ingest(cloud) in GPU mode and
    in Hybrid mode with one worker must equal it bit for bit. Then cut
    clouds: Hybrid with 2 and 4 workers cuts a cloud into chunks of
    tiling.INGEST_CHUNK_POINTS, and must give the bits of GPU mode at that
    chunk_size (chunk boundaries show in a sum's last bits, so that band
    is held to the whole cloud's within 1e-5 only). Every kernel of `fns`
    must have been launched by every way. Prints the best walls of each."""
    from pcr_tpu_torch.engine.tiling import INGEST_CHUNK_POINTS as cut
    GPU, HYB = pcr.ExecutionMode.GPU, pcr.ExecutionMode.Hybrid
    ways = [("stage host route", GPU, True, False, 0, 0),
            ("stage device route", GPU, True, True, 0, 0),
            ("ingest GPU", GPU, False, True, 0, 0),
            ("ingest Hybrid 1 worker", HYB, False, True, 1, 0),
            (f"ingest GPU chunk_size {cut}", GPU, False, True, 0, cut),
            ("ingest Hybrid 2 workers", HYB, False, True, 2, 0),
            ("ingest Hybrid 4 workers", HYB, False, True, 4, 0)]
    want = whole = None
    for name, mode, staged, wire, workers, chunk_size in ways:
        if chunk_size:
            whole, want = want, None    # the cut clouds' own reference
        best, launches = None, None
        for _ in range(reps):
            os.environ["PCR_WIRE_CHEAP"] = "1" if wire else "0"
            for f in fns:
                f.launches = 0
            try:
                _, bands, w = run_pipeline(pcr, gc, specs, c, mode,
                                           staged=staged, workers=workers,
                                           chunk_size=chunk_size)
            finally:
                del os.environ["PCR_WIRE_CHEAP"]
            launches = [f.launches for f in fns]
            check(min(launches) >= 1,
                  f"(k) {label}, {name}: a kernel was never launched")
            if want is None:
                want = [b.view(np.int32).copy() for b in bands]
                if whole is not None:
                    for b, x in zip(bands, whole):
                        close(b, x.view(np.float32),
                              f"(k) {label}, {name} vs the whole cloud")
            check(all(np.array_equal(b.view(np.int32), x)
                      for b, x in zip(bands, want)),
                  f"(k) {label}, {name}: the band's bits differ from "
                  + ("GPU mode's at that chunk_size" if whole is not None
                     else "the host-route stage's"))
            best = w if best is None else {k: min(best[k], w[k])
                                           for k in w}
        print(f"(k) {label}, {name}: best of {reps}: {fmt(best)} "
              f"launches={launches} bits equal")


def upload_rates(torch, nbytes=256 << 20, reps=5):
    """(k): GB/s of one pageable upload (torch.from_numpy(a).to(device))
    against one pinned upload on a side stream, best of `reps`."""
    a = np.ones(nbytes // 4, np.int32)
    pinned = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = a
    dev = torch.empty(nbytes // 4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    best = {"pageable": 1e9, "pinned": 1e9}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(a).to("cuda")
        torch.cuda.synchronize()
        best["pageable"] = min(best["pageable"], time.perf_counter() - t0)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            dev.copy_(pinned, non_blocking=True)
        stream.synchronize()
        best["pinned"] = min(best["pinned"], time.perf_counter() - t0)
    rates = {k: nbytes / v / 1e9 for k, v in best.items()}
    print(f"(k) upload of {nbytes >> 20} MiB, best of {reps}: pageable "
          f"{rates['pageable']:.2f} GB/s, pinned on the copy stream "
          f"{rates['pinned']:.2f} GB/s")
    return rates


def busy_share(torch, pcr, gc, specs, c, label):
    """(k): the card's busy share over one Hybrid ingest(cloud): the sum of
    its kernels' and copies' device time (torch.profiler) over the
    ingest's wall."""
    from torch.profiler import ProfilerActivity, profile
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.Hybrid,
        gpu_require_strict=True))
    p.ingest(c)                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.ingest(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the rows of the card's own kernels and copies; an operator's row may
    # repeat the time of the kernels it launched
    from torch.autograd import DeviceType
    on_card = [(e.key, getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(t for _, t in on_card)
    check(dev_us > 0, f"(k) {label}: the profiler saw no device time")
    names = ", ".join(f"{k[:40]} {t / 1e3:.2f}ms" for k, t in sorted(
        on_card, key=lambda kt: -kt[1])[:5])
    print(f"(k) {label}: Hybrid ingest wall {wall:.4f}s under the profiler, "
          f"device time {dev_us / 1e6:.4f}s, busy share "
          f"{dev_us / 1e6 / wall:.3f}; most of it: {names}")


def phase_k(torch, pcr, kernels, gk, lk):
    """(k), see the module docstring."""
    RT = pcr.ReductionType
    avg = [pcr.ReductionSpec(value_channel="value", type=RT.Average)]

    def gspec(**glyph):
        sp = pcr.gaussian_splat_spec("value", **glyph)
        sp.type = RT.Average
        return [sp]

    g1000, g160 = grid(pcr, 1000, 3857), grid(pcr, 160, 32610)
    M = 1_000_000
    rows = [
        ("Point 160x160 5M Average", g160, avg, (5 * M, 0.5, 159.5),
         [kernels.sorted_splat_point]),
        ("Point 1000x1000 5M Average", g1000, avg, (5 * M, 0.0, 1000.0),
         [kernels.sorted_splat_point]),
        ("Gaussian sigma 4 5M Average", g1000, gspec(default_sigma=4.0),
         (5 * M, 0.0, 1000.0), [gk.sorted_splat_gauss]),
        ("Gaussian rotated 8x3 5M Average", g1000,
         gspec(default_sigma_x=8.0, default_sigma_y=3.0,
               default_rotation=0.6),
         (5 * M, 0.0, 1000.0), [gk.rot_splat_dense]),
        ("Gaussian rotated 4x1.5 5M Average", g1000,
         gspec(default_sigma_x=4.0, default_sigma_y=1.5,
               default_rotation=0.6),
         (5 * M, 0.0, 1000.0), [gk.rot_splat_packed]),
        ("Line hl 16 dir 0 5M WeightedAverage", g1000,
         [lspec(pcr, RT.WeightedAverage, default_half_length=16.0)],
         (5 * M, 0.0, 1000.0), [lk.rect_splat]),
        ("Line hl 16 dir 0.7 1M WeightedAverage", g1000,
         [lspec(pcr, RT.WeightedAverage, default_direction=0.7,
                default_half_length=16.0)],
         (M, 0.0, 1000.0), [lk.rect_splat]),
    ]
    for k, (label, gc, specs, (n, lo, hi), fns) in enumerate(rows):
        c = cloud(pcr, n, lo, hi, 100.0, SEED + 20 + k)
        both_routes(torch, pcr, gc, specs[0], c, label)
        every_way_in(torch, pcr, gc, specs, c, label, fns)
        if label.startswith("Gaussian sigma 4"):
            busy_share(torch, pcr, gc, specs, c, label)
        del c
    upload_rates(torch)


def staged_bytes(staged, band=None):
    """Device bytes of a StagedCloud's chunks (a banded engine's are
    (band, chunks) pairs), or of band `band`'s alone."""
    total = 0
    for chunks in staged.per_spec:
        for c in chunks:
            if band is not None and isinstance(c, tuple) and c[0] != band:
                continue
            for ch in (c[1] if isinstance(c, tuple) else [c]):
                total += ch.params.numel() * ch.params.element_size()
                total += 0 if ch.bids is None else ch.bids.numel() * 4
    return total


def staged_run(torch, pcr, gc, specs, c, budget=0, state_dir="",
               output_path=""):
    """stage -> ingest(staged) -> finalize on the card, resident or banded
    under `budget`, with the device bytes that staging adds beside the
    pipeline (its peak from after create, `stage_peak`), the staged
    layout's (`layout`, and its largest band's, `band_layout`), what
    ingest and finalize add beside the staged cloud (`commit_peak`) and
    the whole run's peak from after create (`peak`). Returns (pipeline,
    bands, walls, bytes, staged cloud)."""
    GPU = pcr.ExecutionMode.GPU
    cfg = pcr.PipelineConfig(grid=gc, reductions=specs, exec_mode=GPU,
                             gpu_require_strict=True,
                             gpu_memory_budget=budget, state_dir=state_dir,
                             output_path=output_path)
    t0 = time.perf_counter()
    p = pcr.Pipeline.create(cfg)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    staged = p.stage(c)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mem = {"stage_peak": torch.cuda.max_memory_allocated() - base,
           "layout": staged_bytes(staged),
           "band_layout": max(staged_bytes(staged, b) for b in {
               c[0] if isinstance(c, tuple) else 0
               for chunks in staged.per_spec for c in chunks})}
    stage_top = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    staged_base = torch.cuda.memory_allocated()
    p.ingest(staged)
    p._engine.block_until_ready()
    t3 = time.perf_counter()
    p.finalize()
    t4 = time.perf_counter()
    torch.cuda.synchronize()
    commit_top = torch.cuda.max_memory_allocated()
    mem["peak"] = max(stage_top, commit_top) - base
    mem["commit_peak"] = commit_top - staged_base
    walls = {"create": t1 - t0, "stage": t2 - t1, "ingest": t3 - t2,
             "finalize": t4 - t3}
    bands = [p.result().band_array(i) for i in range(len(specs))]
    return p, bands, walls, mem, staged


def band_kernels(torch, eng, staged, label, rtol):
    """(l): each kernel of a band's staged chunks against its plain version
    on a fresh band state, reruns bit-identical, for the middle band and
    the last (a partial band on a grid that does not split evenly; on one
    tile, entries copied in from the bands above, their centre rows
    negative). The kernels and their keywords are the band's view's
    (OutOfCoreTorchEngine.band_engine: the geometry of its row-offset
    view). Returns the largest difference."""
    per_band = dict(staged.per_spec[0])
    err, nsub = 0.0, 0
    for b in sorted({eng.nbands // 2, eng.nbands - 1}):
        view = eng.band_engine(b)
        shape = view._state_shape(True)
        nf = len(view._states[0])
        for chunk in per_band.get(b, []):
            kern, plain, kw = view.splat_fns(chunk)
            pr, bids = chunk.params, chunk.bids
            fresh = lambda: [torch.zeros(shape, device=eng.device)
                             for _ in range(nf)]
            got, ref, again = fresh(), fresh(), fresh()
            kern(got, pr, bids, **kw)
            plain(ref, pr, bids, **kw)
            kern(again, pr, bids, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                      for x, y in zip(got, again)),
                  f"(l) {label} band {b}: kernel reruns are not "
                  f"bit-identical")
            err = max([err] + [close(g.cpu().numpy(), r.cpu().numpy(),
                                     f"(l) {label} band {b} {chunk.kind} "
                                     f"kernel vs plain", rtol, rtol)
                               for g, r in zip(got, ref)])
            nsub += pr.shape[0]
    check(nsub > 0, f"(l) {label}: no staged chunk in the bands checked")
    print(f"(l) {label}: bands {sorted({eng.nbands // 2, eng.nbands - 1})} "
          f"kernel vs plain nsub={nsub} rtol={rtol:.3g} max_abs_err={err!r} "
          f"reruns_bit_identical=True")
    return err


def band_row(torch, pcr, label, gc, specs, c, budget, fns, rtol=TOL,
             oracle=None, state_dir="", output_path=""):
    """(l) one row: the resident engine (stage, ingest(staged)), then the
    banded engine the same way, each band's kernels against their plain
    versions (band_kernels), then the banded engine host-sourced
    (ingest(cloud)), whose band must carry the staged banded band's bits.
    gpu_memory_budget bounds the band's state: the band state must stay
    under the budget, and what ingest(staged) and finalize add beside the
    staged cloud under the budget plus the largest band's layout. Beside
    the budget come the staged layout and the staging of one band's chunk,
    which needs no more than the resident engine's staging of the whole
    cloud (its peak less its layout, measured here): the peaks of both
    banded runs must stay under the budget plus those two. The launch
    counters of `fns` are set to 0 before the banded runs and read after;
    every one must move. Returns (banded pipeline, bands, launches)."""
    GPU = pcr.ExecutionMode.GPU
    rp, res, rw, rmem, rstaged = staged_run(torch, pcr, gc, specs, c)
    del rp, rstaged
    scratch = rmem["stage_peak"] - rmem["layout"]
    for f in fns:
        f.launches = 0
    p, bands, bw, mem, staged = staged_run(torch, pcr, gc, specs, c, budget,
                                           state_dir, output_path)
    eng = p._engine
    from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
    check(isinstance(eng, OutOfCoreTorchEngine) and eng.nbands > 1
          and eng.device.type == "cuda",
          f"(l) {label}: no banded engine of several bands on the card")
    state = sum(t.numel() * 4 for st in eng.band_engine(0)._states
                if st is not None for t in st)
    check(state <= budget, f"(l) {label}: the band state {state} is over "
                           f"the budget {budget}")
    st = dict(eng.stats)
    launches = [f.launches for f in fns]
    check(all(n >= 1 for n in launches),
          f"(l) {label}: the banded run never launched {fns}")
    check(mem["commit_peak"] <= budget + mem["band_layout"],
          f"(l) {label}: ingest(staged) and finalize add {mem['commit_peak']}"
          f" device bytes, over the budget {budget} + the largest band's "
          f"layout {mem['band_layout']}")
    limit = budget + mem["layout"] + scratch
    check(mem["peak"] <= limit,
          f"(l) {label}: peak device bytes {mem['peak']} over the budget "
          f"{budget} + the layout {mem['layout']} + the resident staging "
          f"scratch {scratch}")
    kerr = band_kernels(torch, eng, staged, label, rtol)
    del staged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, again, hw = run_pipeline(pcr, gc, specs, c, GPU, budget=budget)
    host_peak = torch.cuda.max_memory_allocated() - base
    check(host_peak <= limit,
          f"(l) {label}: host-sourced peak device bytes {host_peak} over "
          f"the budget {budget} + the layout {mem['layout']} + the "
          f"resident staging scratch {scratch}")
    check(all(np.array_equal(a.view(np.int32), b.view(np.int32))
              for a, b in zip(bands, again)),
          f"(l) {label}: the banded reruns are not bit-identical")
    errs = [close(b, r, f"(l) {label} banded vs resident band {i}")
            for i, (b, r) in enumerate(zip(bands, res))]
    same = all(np.array_equal(b.view(np.int32), r.view(np.int32))
               for b, r in zip(bands, res))
    oerr = None
    if oracle is not None:
        oerr = max(close(b, o, f"(l) {label} banded vs oracle band {i}")
                   for i, (b, o) in enumerate(zip(bands, oracle)))
    gbs = lambda n, t: n / t / 1e9 if t else float("nan")
    print(f"(l) {label}: bands={eng.nbands} band_rows={eng.band_rows} "
          f"swaps={st['swaps']} bytes_in={st['bytes_in']} "
          f"bytes_out={st['bytes_out']} in_GBs="
          f"{gbs(st['bytes_in'], st['seconds_in'])!r} out_GBs="
          f"{gbs(st['bytes_out'], st['seconds_out'])!r} swap_s="
          f"{st['seconds_in'] + st['seconds_out']!r}")
    print(f"(l) {label}: banded staged {fmt(bw)}; banded host-sourced "
          f"{fmt(hw)}; resident staged {fmt(rw)}; ingest banded/resident="
          f"{bw['ingest'] / rw['ingest']!r} launches={launches} "
          f"max_abs_err={max(errs)!r} bits_equal_resident={same} "
          f"max_abs_err_oracle={oerr!r} kernel_vs_plain_err={kerr!r} "
          f"reruns_bit_identical=True band_state_bytes={state} "
          f"budget={budget} layout_bytes={mem['layout']} "
          f"resident_staging_scratch={scratch} "
          f"band_layout_bytes={mem['band_layout']} "
          f"commit_peak_device_bytes={mem['commit_peak']} "
          f"peak_device_bytes={mem['peak']} "
          f"peak_device_bytes_host_sourced={host_peak}")
    return p, bands, launches


def phase_l(torch, pcr, kernels, gk, lk, tmp):
    """(l), see the module docstring. Returns the launches of K1-K4."""
    RT = pcr.ReductionType
    M = 1_000_000
    avg = [pcr.ReductionSpec(value_channel="value", type=RT.Average)]
    out = {}
    gc = grid(pcr, 16384, 32610, tile=512)
    c = cloud(pcr, 20 * M, 0.0, 16384.0, 100.0, SEED + 40)
    _, oracle, ow = run_pipeline(pcr, gc, avg, c, pcr.ExecutionMode.CPU)
    print(f"(l) Point 16384x16384 20M oracle: {fmt(ow)}")
    state_dir = os.path.join(tmp, "l_state")
    tif = os.path.join(tmp, "l.tif")
    p, bands, (n,) = band_row(
        torch, pcr, "Point 16384x16384 20M Average 1 GiB", gc, avg, c,
        1 << 30, [kernels.sorted_splat_point], TOL, oracle, state_dir, tif)
    out["point"] = n
    del oracle, c
    check(np.array_equal(pcr.read_geotiff_band(tif, 0), bands[0],
                         equal_nan=True), "(l) GeoTIFF != band")
    resumed = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=avg, exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True, gpu_memory_budget=1 << 30,
        state_dir=state_dir))
    check(all(np.array_equal(a, b) for a, b in zip(
        resumed._engine.fetch_state(0), p._engine.fetch_state(0))),
        "(l) resume from state_dir does not reproduce the state")
    del p, resumed, bands
    shutil.rmtree(state_dir, ignore_errors=True)
    os.remove(tif)

    def gspec(**glyph):
        sp = pcr.gaussian_splat_spec("value", **glyph)
        sp.type = RT.Average
        return [sp]

    g8k = grid(pcr, 8192, 32610, tile=512)
    # kernel against plain: K2 and K4 at gauss_rtol (r = 3 sigma), K3 1e-5
    for key, label, specs, n, fn, rtol in (
            ("gauss", "Gaussian sigma 4 Average 5M",
             gspec(default_sigma=4.0), 5 * M, gk.sorted_splat_gauss,
             gauss_rtol(5 * M, 8192, 12)),
            ("rot", "Gaussian rotated 8x3 Average 1M",
             gspec(default_sigma_x=8.0, default_sigma_y=3.0,
                   default_rotation=0.6), M, gk.rot_splat_dense,
             gauss_rtol(M, 8192, 24)),
            ("rect", "Line hl 16 Average 5M",
             [lspec(pcr, RT.Average, default_half_length=16.0)], 5 * M,
             lk.rect_splat, TOL)):
        c = cloud(pcr, n, 0.0, 8192.0, 100.0, SEED + 41)
        _, _, (out[key],) = band_row(
            torch, pcr, f"8192x8192 512-cell tiles {label} 64 MiB", g8k,
            specs, c, 64 << 20, [fn], rtol)
        del c
    # one tile: footprints cross the bands, whose entries are copied
    g4k = grid(pcr, 4096, 32610, tile=4096)
    c = cloud(pcr, M, 0.0, 4096.0, 100.0, SEED + 42)
    specs = gspec(default_sigma=4.0)
    _, oracle, ow = run_pipeline(pcr, g4k, specs, c, pcr.ExecutionMode.CPU)
    print(f"(l) 4096x4096 one tile Gaussian sigma 4 1M oracle: {fmt(ow)}")
    _, _, (n,) = band_row(
        torch, pcr, "4096x4096 one tile Gaussian sigma 4 Average 1M 96 MiB",
        g4k, specs, c, 96 << 20, [gk.sorted_splat_gauss],
        gauss_rtol(M, 4096, 12), oracle)
    out["gauss"] += n
    return out


def phase_m(torch, pcr, kernels):
    """(m), see the module docstring. Returns K1's launches."""
    RT = pcr.ReductionType
    GPU, CPU = pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU
    FLT_MAX = float(np.finfo(np.float32).max)
    gc = grid(pcr, 1000, 3857)
    c = cloud(pcr, 1_000_000, 0.0, 1000.0, 100.0, SEED + 50)
    k3 = dict(state_floats=3, identity=(0.0, 0.0, 0.0), scatter_kind="sum",
              fields=lambda v, w, t: [v, v * v, v * 0 + 1.0],
              merge_arrays=lambda a, b: [x + y for x, y in zip(a, b)],
              finalize_arrays=lambda f: (f[0] + f[1]) / f[2])
    ops = [
        ("RMS (K = 2)", 1, 0, dict(
            state_floats=2, identity=(0.0, 0.0), scatter_kind="sum",
            fields=lambda v, w, t: [v * v, v * 0 + 1.0],
            merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
            finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5)),
        ("mean of v + v^2 (K = 3)", 2, 0, k3),
        ("max of 2v (max kind)", 0, 0, dict(
            state_floats=1, identity=(-FLT_MAX,), scatter_kind="max",
            fields=lambda v, w, t: [v * 2.0],
            merge_arrays=lambda a, b: [np.maximum(a[0], b[0])],
            finalize_arrays=lambda f: np.where(f[0] == -FLT_MAX, np.nan,
                                               f[0]))),
        ("mean of v + v^2 (K = 3) banded", 2, 12 << 20, k3),
    ]
    total = 0
    spec = [pcr.ReductionSpec(value_channel="value", type=RT.Custom,
                              output_band_name="custom")]
    for label, per_chunk, budget, op in ops:
        pcr.unregister_reduction(RT.Custom)
        pcr.register_custom_reduction(**op)
        exact = pcr.get_reduction_info(RT.Custom).scatter_kind != "sum"
        _, oracle, ow = run_pipeline(pcr, gc, spec, c, CPU)
        kernels.sorted_splat_point.launches = 0
        p, bands, w = run_pipeline(pcr, gc, spec, c, GPU, budget=budget)
        n = kernels.sorted_splat_point.launches
        chunks = p._engine.nbands if budget else 1
        check(n == per_chunk * chunks,
              f"(m) {label}: {n} K1 launches, not {per_chunk} a chunk")
        _, again, _ = run_pipeline(pcr, gc, spec, c, GPU, budget=budget)
        check(np.array_equal(bands[0].view(np.int32),
                             again[0].view(np.int32)),
              f"(m) {label}: reruns are not bit-identical")
        if exact:
            check(np.array_equal(bands[0], oracle[0], equal_nan=True),
                  f"(m) {label}: differs from the oracle")
            err = 0.0
        else:
            err = close(bands[0], oracle[0], f"(m) {label} vs oracle")
        total += n
        print(f"(m) custom {label} 1000x1000 1M host"
              + (f" {budget >> 20} MiB bands={p._engine.nbands}"
                 if budget else "")
              + f": {fmt(w)} K1 launches={n} max_abs_err={err!r} "
              f"reruns_bit_identical=True oracle: {fmt(ow)}")
    pcr.unregister_reduction(RT.Custom)
    return total


def best_walls(walls):
    return {k: min(w[k] for w in walls) for k in ("stage", "ingest",
                                                   "finalize")}


def peak_runs(torch, n, run):
    """`run()` n times, each from a fresh peak-memory count with nothing
    of the earlier runs left on the card; (first run's result, every run's
    walls, the largest peak device bytes)."""
    first, walls, peak = None, [], 0
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        walls.append(out[-1])
        peak = max(peak, torch.cuda.max_memory_allocated())
        first = first or out
        del out
    return first, walls, peak


def resident_ref(torch, pcr, gc, specs, c, reps=3, staged=True):
    """(n): the resident engine's bands of a cloud (staged, or
    host-sourced), its best walls of `reps` runs and its peak."""
    def run():
        _, bands, w = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.GPU,
                                   staged=staged)
        return bands, w
    (bands, _), walls, peak = peak_runs(torch, reps, run)
    return bands, best_walls(walls), peak


def mesh_row(torch, pcr, fns, label, gc, specs, c, mesh, want, resident,
             need, exact=(), rtol=TOL, reps=3, staged=True):
    """One row of (n): `reps` runs of a mesh pipeline (staged, then one
    host-sourced run more, or host-sourced), every rerun bit-identical to
    the first, with the launch counters of `fns` set to 0 just before and
    read just after (each kernel in `need` must have launched); each band
    against the bands `want` (the resident engine's, or the oracle's),
    exact where listed, else within atol = rtol = `rtol`. `resident` is
    the resident engine's (best walls, peak device bytes). Returns the
    launches."""
    for f in fns.values():
        f.launches = 0
    modes = [staged] * reps + ([False] if staged else [])

    seen = []

    def run():
        staged_ = modes.pop(0)
        p, bands, w = run_pipeline(pcr, gc, specs, c, pcr.ExecutionMode.GPU,
                                   staged=staged_, mesh=mesh)
        check(not seen or all(np.array_equal(a.view(np.int32),
                                             b.view(np.int32))
                              for a, b in zip(bands, seen[0])),
              f"(n) {label}: a rerun's bits differ")
        seen[:] = seen or [bands]
        eng = p._engine
        return (type(eng).__name__, getattr(eng, "dp", None),
                getattr(eng, "sp", None), eng.nshards, bands, w)
    first, walls, peak = peak_runs(torch, len(modes), run)
    launches = {k: f.launches for k, f in fns.items()}
    for k in need:
        check(launches[k] >= 1, f"(n) {label}: {k} never launched")
    name, dp, sp, nshards, bands, _ = first
    want_engine = ("ShardedTorchEngine" if gc.total_tiles() == 1
                   else "PartitionedTorchEngine")
    check(name == want_engine, f"(n) {label}: {name}, not {want_engine}")
    errs = [0.0]
    for i, (g, w) in enumerate(zip(bands, want)):
        if i in exact:
            check(np.array_equal(g, w, equal_nan=True),
                  f"(n) {label}: band {i} differs from the reference")
        else:
            errs.append(close(g, w, f"(n) {label} band {i} vs reference",
                              atol=rtol, rtol=rtol))
    cfg = pcr.PipelineConfig(grid=gc, reductions=specs,
                             exec_mode=pcr.ExecutionMode.GPU,
                             gpu_require_strict=True, **mesh)
    p = pcr.Pipeline.create(cfg)
    staged_ = p.stage(c)
    torch.cuda.synchronize()
    kerr, kinds = shard_kernels(torch, p._engine, staged_, label, rtol)
    check(set(need) <= kinds, f"(n) {label}: no {need} chunk in the shards "
                              f"checked")
    del p, staged_
    cells = f"(dp, sp)=({dp}, {sp}) " if dp else ""
    print(f"(n) {label}: {name} {cells}shards={nshards} launches={launches} "
          f"best of {reps} {'staged' if staged else 'host-sourced'}: "
          f"{fmt(best_walls(walls[:reps]))} resident: {fmt(resident[0])} "
          f"max_abs_err={max(errs)!r} kernel_vs_plain_err={kerr!r} "
          f"peak_device_bytes={peak} resident "
          f"{resident[1]}")
    return launches


def shard_kernels(torch, eng, staged, label, rtol):
    """(n): each kernel of the middle and last shards' staged chunks
    against its plain version on a fresh shard state, reruns bit-identical,
    as band_kernels does for bands: a shard is a row-offset view whose
    first row need not start a tile row, and windows whose home lies in
    another shard stage dead there. A Partitioned engine stages
    [(shard, chunks)], a Sharded one _MeshSteps whose cells[s][d] are
    chunk lists (run by eng.cells[d][s]). Returns (the largest
    difference, the kinds checked)."""
    shards = sorted({eng.nshards // 2, eng.nshards - 1})
    err, nsub, kinds = 0.0, 0, set()
    for i, steps in enumerate(staged.per_spec):
        if not isinstance(steps, list):
            continue
        info = eng.plans[i][1]
        work = []
        for step in steps:
            if isinstance(step, tuple):
                s, chunks = step
                if s in shards:
                    work += [(eng.engines[s], ch) for ch in chunks]
                continue
            for s in shards:
                for d, chunks in enumerate(step.cells[s]):
                    work += [(eng.cells[d][s], ch) for ch in chunks]
        for view, chunk in work:
            if chunk.kind in ("scatter", "fields"):
                continue
            kern, plain, kw = view.splat_fns(chunk)
            shape = view._state_shape(True)
            pr, bids = chunk.params, chunk.bids
            fresh = lambda: [torch.zeros(shape, device=view.device)
                             for _ in range(info.state_floats)]
            got, ref, again = fresh(), fresh(), fresh()
            kern(got, pr, bids, **kw)
            plain(ref, pr, bids, **kw)
            kern(again, pr, bids, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                      for x, y in zip(got, again)),
                  f"(n) {label}: a shard's kernel reruns are not "
                  f"bit-identical")
            err = max([err] + [close(g.cpu().numpy(), r.cpu().numpy(),
                                     f"(n) {label} shard {chunk.kind} "
                                     f"kernel vs plain", rtol, rtol)
                               for g, r in zip(got, ref)])
            nsub += pr.shape[0]
            kinds.add(chunk.kind)
    check(nsub > 0, f"(n) {label}: no staged chunk in the shards checked")
    print(f"(n) {label}: shards {shards} {sorted(kinds)} kernel vs plain "
          f"nsub={nsub} rtol={rtol:.3g} max_abs_err={err!r} "
          f"reruns_bit_identical=True")
    return err, kinds


def border_cloud(pcr, n, size, borders, r, seed):
    """n points whose rows lie within r of one of the `borders` rows."""
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0.0, size, n))
    rows = rng.choice(borders, n) + rng.uniform(-r, r, n)
    c.set_y_array(size - rows)
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value",
                            rng.uniform(0, 100.0, n).astype(np.float32))
    return c


def library_steps(torch, pcr, gc, c, label):
    """(n) row 4: parallel/sharding.py's four steps over a (2, 2) mesh of
    the one card, each run twice (bit-identical), against the resident
    pipeline's state of the same points; the rotated step against the
    oracle's, whose algebra it shares (its difference from the resident
    K5's completed square is printed)."""
    from pcr_tpu_torch.engine import routing
    from pcr_tpu_torch.parallel import sharding as sh
    RT = pcr.ReductionType
    mesh = sh.make_mesh(["cuda:0"] * 4, dp=2, sp=2)
    H, W = gc.height, gc.width
    x, y = c.x_array(), c.y_array()
    values = c.channel_array_f32("value")
    col, row, valid = routing.assign(gc, x, y)
    n = c.count()
    block = 2048

    def pad(a, fill):
        L = -(-len(a) // (2 * block)) * 2 * block
        return np.concatenate([a, np.full(L - len(a), fill, a.dtype)])

    def state(spec, cloud, mode=pcr.ExecutionMode.GPU):
        p, _, _ = run_pipeline(pcr, gc, [spec], cloud, mode)
        return (p._engine.fetch_state(0) if p._engine is not None
                else p._host_state[0])

    def gspec(**glyph):
        sp_ = pcr.gaussian_splat_spec("value", **glyph)
        sp_.type = RT.Average
        return sp_

    avg = pcr.ReductionSpec(value_channel="value", type=RT.Average)
    s4 = gspec(default_sigma=4.0)
    rot = gspec(default_sigma_x=2.0, default_sigma_y=0.8,
                default_rotation=0.6)
    hl16 = lspec(pcr, RT.Average, default_half_length=16.0)
    n_rot = 200_000
    c_rot = pcr.PointCloud.create(n_rot)
    c_rot.set_x_array(x[:n_rot])
    c_rot.set_y_array(y[:n_rot])
    c_rot.add_channel("value", pcr.DataType.Float32)
    c_rot.set_channel_array_f32("value", values[:n_rot])
    gp = routing.gaussian_params(s4.glyph, gc, x, y, None, None, None)
    gr = routing.gaussian_params(rot.glyph, gc, x[:n_rot], y[:n_rot], None,
                                 None, None)
    lp = routing.line_params(hl16.glyph, gc, x, y, None, None)
    rects = routing.line_rects(lp, gc, valid, col, row)
    cases = (
        ("point Average 1M", avg, c, sh.sharded_point_step, (), {},
         (row, col, valid, values, np.ones(n, np.float32),
          np.zeros(n, np.float32)), TOL),
        ("Gaussian sigma 4 Average 1M", s4, c, sh.sharded_gaussian_step, (),
         dict(block=block),
         tuple(pad(a, f) for a, f in (
             (gp.icx, 0), (gp.icy, 0), (gp.sub_cx, 0.0), (gp.sub_cy, 0.0),
             (gp.sx, 1.0), (gp.sy, 1.0), (gp.r, -1), (valid, False),
             (values, 0.0))), gauss_rtol(n, 1000, 12)),
        ("rotated 2x0.8 Average 200k", rot, c_rot,
         sh.sharded_gaussian_rotated_step, (int(gr.r.max()),), {},
         (gr.icx, gr.icy, gr.sub_cx, gr.sub_cy, gr.sx, gr.sy, gr.cos_rot,
          gr.sin_rot, gr.r, valid[:n_rot], values[:n_rot]),
         gauss_rtol(n_rot, 1000, 6)),
        ("Line hl 16 dir 0 Average 1M", hl16, c, sh.sharded_line_step, (),
         dict(block=block),
         tuple(pad(a, f) for a, f in (
             (rects.ax, 1), (rects.bx, 0), (rects.ay, 1), (rects.by, 0),
             (np.ones(len(rects.ax), bool), False),
             (values[rects.owner], 0.0))),
         TOL))
    for name, spec, cloud_, build, args, kw, inputs, rtol in cases:
        info = pcr.get_reduction_info(spec.type)
        want = state(spec, cloud_)
        ref = "resident"
        if build is sh.sharded_gaussian_rotated_step:
            resident = want
            want, ref = state(spec, cloud_, pcr.ExecutionMode.CPU), "oracle"
        outs, walls = [], []
        for _ in range(2):
            step = build(info, H, W, mesh, *args, **kw)
            states = sh.replicate_state(mesh, info.init_state((H, W)), H, W)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states = step(states, *sh.shard_points(mesh, *inputs))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            outs.append([g.numpy() for g in sh.gather_state(states)])
        check(all(np.array_equal(a.view(np.int32), b.view(np.int32))
                  for a, b in zip(*outs)), f"(n) {label} {name}: a rerun's "
                                           f"bits differ")
        errs = [close(g, w, f"(n) {label} {name} field {f} vs {ref}",
                      atol=rtol, rtol=rtol)
                for f, (g, w) in enumerate(zip(outs[0], want))]
        extra = ""
        if ref == "oracle":
            extra = (" max_abs_diff_vs_resident=" + repr(max(
                float(np.abs(g - w).max())
                for g, w in zip(outs[0], resident))))
        print(f"(n) {label} {name}: walls {[round(w, 4) for w in walls]}s "
              f"max_abs_err={max(errs)!r} vs {ref} tolerance={rtol!r}"
              f"{extra} reruns bit-identical")


def phase_n(torch, pcr, kernels, gk, lk, tmp, e_ref, d_ref):
    """(n) meshes on the one card: ShardedTorchEngine on a one-tile grid,
    PartitionedTorchEngine on tiled ones, against the resident engine, the
    oracle and each other; the library steps. Returns the launches of the
    mesh paths by kernel."""
    RT = pcr.ReductionType
    fns = {"point": kernels.sorted_splat_point,
           "gauss": gk.sorted_splat_gauss, "rot": gk.rot_splat_dense,
           "rotp": gk.rot_splat_packed, "rect": lk.rect_splat}
    total = dict.fromkeys(fns, 0)

    def row(label, gc, specs, c, mesh, want, resident, need, **kw):
        for k, v in mesh_row(torch, pcr, fns, label, gc, specs, c, mesh,
                             want, resident, need, **kw).items():
            total[k] += v

    four = ["cuda:0"] * 4
    avg = pcr.ReductionSpec(value_channel="value", type=RT.Average)

    # 1. one tile: ShardedTorchEngine
    gc = grid(pcr, 4096, 32610)
    c = cloud(pcr, 20_000_000, 0.0, 4096.0, 100.0, SEED + 20, ts=True)
    specs = [avg, pcr.ReductionSpec(value_channel="value", type=RT.Max),
             pcr.ReductionSpec(value_channel="value", type=RT.MostRecent,
                               timestamp_channel="ts")]
    want, *res = resident_ref(torch, pcr, gc, specs, c)
    for dp, sp in ((2, 2), (1, 4)):
        row("4096x4096 one tile 20M Average+Max+MostRecent", gc, specs, c,
            dict(mesh_devices=four, mesh_dp=dp, mesh_sp=sp), want, res,
            ("point",), exact=(1, 2))
    del c
    c5 = cloud(pcr, 5_000_000, 0.0, 4096.0, 100.0, SEED + 21)
    g4 = pcr.gaussian_splat_spec("value", default_sigma=4.0)
    g4.type = RT.Average
    for label, spec, need, rtol in (
            ("4096x4096 one tile 5M Gaussian sigma 4 Average", g4, "gauss",
             gauss_rtol(5_000_000, 4096, 12)),
            ("4096x4096 one tile 5M Line hl 16 Average",
             lspec(pcr, RT.Average, default_half_length=16.0), "rect", TOL)):
        want, *res = resident_ref(torch, pcr, gc, [spec], c5)
        row(label, gc, [spec], c5, dict(mesh_devices=four, mesh_sp=4), want,
            res, (need,), rtol=rtol)
    del c5

    # 2. several tiles: PartitionedTorchEngine. (e)'s grid, cloud and band
    gc, c20, e_band, _ = e_ref
    mesh = dict(mesh_devices=four)
    state_dir = os.path.join(tmp, "n_state")
    tif = os.path.join(tmp, "n.tif")
    for f in fns.values():
        f.launches = 0
    p, (band,), w = run_pipeline(pcr, gc, [avg], c20, pcr.ExecutionMode.GPU,
                                 state_dir=state_dir, output_path=tif,
                                 mesh=mesh)
    check(fns["point"].launches >= 1, "(n) 8192x8192: K1 never launched")
    total["point"] += fns["point"].launches
    err = close(band, e_band, "(n) 8192x8192 20M host vs resident (e)")
    check(np.array_equal(pcr.read_geotiff_band(tif, 0), band,
                         equal_nan=True), "(n) 8192x8192: GeoTIFF != band")
    resumed = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[avg], exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True, state_dir=state_dir, **mesh))
    check(all(np.array_equal(a, b) for a, b in zip(
        resumed._engine.fetch_state(0), p._engine.fetch_state(0))),
        "(n) 8192x8192: resume from state_dir does not reproduce the state")
    print(f"(n) 8192x8192 20M Average host-sourced with state_dir + GeoTIFF "
          f"+ resume: {type(p._engine).__name__} shards={p._engine.nshards} "
          f"K1 launches={fns['point'].launches} {fmt(w)} "
          f"max_abs_err={err!r}")
    del p, resumed, band
    _, *res = resident_ref(torch, pcr, gc, [avg], c20)
    row("8192x8192 20M Average vs (e)'s resident band", gc, [avg], c20,
        mesh, [e_band], res, ("point",))
    del c20, e_band

    gc = grid(pcr, 4096, 32610, tile=512)
    for label, glyph, need, r in (
            ("rotated 8x3", dict(default_sigma_x=8.0, default_sigma_y=3.0,
                                 default_rotation=0.6), "rot", 24),
            ("rotated 4x1.5", dict(default_sigma_x=4.0, default_sigma_y=1.5,
                                   default_rotation=0.6), "rotp", 12)):
        spec = pcr.gaussian_splat_spec("value", **glyph)
        spec.type = RT.Average
        c = border_cloud(pcr, 1_000_000, 4096.0, [1024, 2048, 3072], r,
                         SEED + 22)
        want, *res = resident_ref(torch, pcr, gc, [spec], c)
        row(f"4096x4096 512-cell tiles 1M {label} Average, centres within "
            f"{r} rows of the shard borders", gc, [spec], c, mesh, want, res,
            (need,), rtol=gauss_rtol(1_000_000, np.sqrt(3 * 2 * r * 4096.0),
                                     r))

    # 3. against the oracle: (d)'s quickstart, host-sourced
    gc, c1, specs, oracle, _ = d_ref
    _, *res = resident_ref(torch, pcr, gc, specs, c1, staged=False)
    row("quickstart 1000x1000 1M host-sourced Average+Max+Min+MostRecent "
        "vs (d)'s oracle bands", gc, specs, c1,
        dict(mesh_devices=four, mesh_dp=2, mesh_sp=2), oracle, res,
        ("point",), exact=(1, 2, 3), staged=False)

    # 4. the library steps
    library_steps(torch, pcr, gc, c1, "library steps 1000x1000 (dp, sp)="
                                      "(2, 2)")
    return total


def far_near_cloud(pcr, n, size, block, seed):
    """n points whose centres lie in rows and columns [size - block,
    size), then the same n shifted by size - block cells into [0, block):
    the same sub-cell offsets and values far from the origin and near it.
    Values in [1, 100) (a cell's terms are then its |terms|)."""
    rng = np.random.default_rng(seed)
    col = rng.uniform(size - block, size, n)
    row = rng.uniform(size - block, size, n)
    shift = float(size - block)
    c = pcr.PointCloud.create(2 * n)
    c.set_x_array(np.concatenate([col, col - shift]))
    c.set_y_array(size - np.concatenate([row, row - shift]))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", np.tile(rng.uniform(1.0, 100.0, n),
                                             2).astype(np.float32))
    return c


def block_errors(got, want, size, block):
    """The largest |got - want| / |want| (positive terms: relative to the
    cell's sum of |terms|) in the far block (rows and columns [size -
    block, size)) and in the near one ([0, block)), after the NaN
    footprints were found equal."""
    check(np.array_equal(np.isnan(got), np.isnan(want)),
          "NaN footprints differ")
    rel = np.where(np.isnan(want), 0.0,
                   np.abs(got - want) / np.where(np.isnan(want), 1.0,
                                                 np.abs(want)))
    return (float(rel[size - block:, size - block:].max()),
            float(rel[:block, :block].max()))


def phase_o(torch, pcr, gk, size=8192, block=512, points=(25_000, 100_000)):
    """(o), see the module docstring (a rehearsal on the CPU shrinks the
    grid, the blocks and the points). Returns the launches of K4 and K5."""
    gc = grid(pcr, size, 32610, tile=block)
    out = {}
    for kind, label, glyph, n, fn in (
            ("rot", "K4 rotated 8x3", dict(default_sigma_x=8.0,
                                           default_sigma_y=3.0,
                                           default_rotation=0.6),
             points[0], gk.rot_splat_dense),
            ("rotp", "K5 rotated 4x1.5", dict(default_sigma_x=4.0,
                                              default_sigma_y=1.5,
                                              default_rotation=0.6),
             points[1], gk.rot_splat_packed)):
        spec = pcr.gaussian_splat_spec("value", **glyph)
        spec.type = pcr.ReductionType.Average
        c = far_near_cloud(pcr, n, size, block, SEED + 50)
        _, (oracle,), ow = run_pipeline(pcr, gc, [spec], c,
                                        pcr.ExecutionMode.CPU)
        fn.launches = 0
        _, (band,), w = run_pipeline(pcr, gc, [spec], c,
                                     pcr.ExecutionMode.GPU)
        out[kind] = fn.launches
        check(out[kind] >= 1, f"(o) {label}: never launched")
        far, near = block_errors(band, oracle, size, block)
        check(far <= TOL and near <= TOL,
              f"(o) {label}: far {far!r} / near {near!r} over {TOL} of the "
              f"cells' sums of |terms|")
        check(far <= 1.5 * near, f"(o) {label}: the far block's error "
                                  f"{far!r} is over 1.5x the near one's "
                                  f"{near!r}")
        # the kernel against its plain version on the far block's chunks
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU,
            gpu_require_strict=True))
        eng = p._engine
        (chunk,) = p.stage(c).per_spec[0]
        check(chunk.kind == kind, f"(o) {label}: routed to {chunk.kind}")
        kern, plain, kw = eng.splat_fns(chunk)
        ncb = eng._states[0][0].shape[1] // chunk.wt
        b = chunk.bids.long()
        far_tiles = ((b // ncb * chunk.th >= size - block)
                     & (b % ncb * chunk.wt >= size - block))
        pr = chunk.params[far_tiles].contiguous()
        bids = chunk.bids[far_tiles].contiguous()
        shape = eng._states[0][0].shape
        fresh = lambda: [torch.zeros(shape, device=eng.device)
                         for _ in range(2)]
        got, ref, again = fresh(), fresh(), fresh()
        kern(got, pr, bids, **kw)
        plain(ref, pr, bids, **kw)
        kern(again, pr, bids, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in zip(got, again)),
              f"(o) {label}: far reruns are not bit-identical")
        rtol = gauss_rtol(n, block, int(np.ceil(3 * glyph["default_sigma_x"])))
        kerr = max(close(g.cpu().numpy(), r.cpu().numpy(),
                         f"(o) {label} far kernel vs plain", rtol, rtol)
                   for g, r in zip(got, ref))
        print(f"(o) {size}x{size} {block}-cell tiles {label} Average {2 * n} "
              f"({n} far, {n} near): launches={out[kind]} "
              f"max_rel_err far={far!r} near={near!r} "
              f"far/near={far / near if near else float('inf')!r} "
              f"far nsub={pr.shape[0]} kernel_vs_plain rtol={rtol:.3g} "
              f"max_abs_err={kerr!r} reruns_bit_identical=True; "
              f"{fmt(w)} oracle: {fmt(ow)}")
        del p, eng, chunk, pr, bids, got, ref, again, c
    return out


def kernel_fns(kernels, gk, lk):
    """The wrappers of K1-K5 by the names the phases count them under."""
    return {"point": kernels.sorted_splat_point,
            "gauss": gk.sorted_splat_gauss, "rot": gk.rot_splat_dense,
            "rotp": gk.rot_splat_packed, "rect": lk.rect_splat}


def counted(torch, fns, total, phase, label, run, need):
    """run() with the launch counters of `fns` set to 0 just before and
    read just after, added into `total`; each kernel in `need` must have
    launched. Returns (run's result, wall, the launches made)."""
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: f.launches for k, f in fns.items()}
    for k in need:
        check(got[k] >= 1, f"{phase} {label}: {k} was never launched")
    for k, n in got.items():
        total[k] = total.get(k, 0) + n
    return out, wall, {k: v for k, v in got.items() if v}


@contextlib.contextmanager
def finalize_split():
    """Host-clock seconds and calls of the parts of a device finalize that
    streams a GeoTIFF (Pipeline._finalize_streamed), summed over the
    block: the whole finalize; the device finalize and its copy to the
    host (TorchEngine.finalize_strips); the touched-tile masking of each
    strip on the main thread (Pipeline._mask_strip); and, on the writer's
    one thread, StreamingGeoTiffWriter._encode_strip, of which the tile
    codec (geotiff._compress) and the file writes (_TiffBuilder.write_raw)
    are parts (the rest copies each tile out of the strip), then the
    writer's close (the IFD). Yields (seconds, calls) by part; the
    functions are restored after. It measures and changes nothing."""
    from pcr_tpu_torch.engine.pipeline import Pipeline
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    from pcr_tpu_torch.io import geotiff
    parts = {"finalize": (Pipeline, "finalize"),
             "device_finalize_d2h": (TorchEngine, "finalize_strips"),
             "mask_strip": (Pipeline, "_mask_strip"),
             "encode_strip": (geotiff.StreamingGeoTiffWriter,
                              "_encode_strip"),
             "compress": (geotiff, "_compress"),
             "file_write": (geotiff._TiffBuilder, "write_raw"),
             "close": (geotiff.StreamingGeoTiffWriter, "close")}
    secs = dict.fromkeys(parts, 0.0)
    calls = dict.fromkeys(parts, 0)

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[name] += time.perf_counter() - t0
                calls[name] += 1
        return run

    saved = []
    try:
        for name, (owner, attr) in parts.items():
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, timed(name, fn))
        yield secs, calls
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def print_split(label, secs, calls):
    tile_copy = (secs["encode_strip"] - secs["compress"]
                 - secs["file_write"])
    main = secs["device_finalize_d2h"] + secs["mask_strip"]
    print(f"{label} finalize split (host clock, s): finalize="
          f"{secs['finalize']!r}; main thread: device finalize + D2H="
          f"{secs['device_finalize_d2h']!r} ({calls['device_finalize_d2h']} "
          f"calls), _mask_strip={secs['mask_strip']!r} "
          f"({calls['mask_strip']} strips), waiting for the writer="
          f"{secs['finalize'] - main - secs['close']!r}; writer thread: "
          f"_encode_strip={secs['encode_strip']!r} "
          f"({calls['encode_strip']} tile rows) of which codec="
          f"{secs['compress']!r} ({calls['compress']} tiles), file write="
          f"{secs['file_write']!r}, tile copies={tile_copy!r}; then on the "
          f"main thread close (IFD)={secs['close']!r}")


def phase_p(torch, pcr, kernels, gk, lk, tmp, lidar_size=(40, 500_000,
                                                          8192.0)):
    """(p), see the module docstring; `lidar_size` is the harness's
    (files, points a file, extent), which a rehearsal on the CPU shrinks.
    Returns the launches of K1-K5."""
    from pcr_tpu_torch.examples import (custom_reduction, glyph_splatting,
                                        multichip, quickstart, smiley_face,
                                        streaming_resume)
    from pcr_tpu_torch.scripts import compare_patterns
    from pcr_tpu_torch.scripts import generate_glyph_patterns as patterns
    from pcr_tpu_torch.scripts import run_lidar_pipeline as lidar
    GPU, CPU = pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU
    total = {}
    on_card = functools.partial(counted, torch, kernel_fns(kernels, gk, lk),
                                total, "(p)")

    def oracle(run):
        t0 = time.perf_counter()
        out = run()
        return out, time.perf_counter() - t0

    def same(label, got, want):
        if label != "smiley_face":
            return max(close(g, w, f"(p) {label} {i} card vs CPU")
                       for i, (g, w) in enumerate(zip(got, want)))
        # The eyes' cells sum ~1.3e4 float32 terms of the value 3 each,
        # whose Average is exactly 3: there two orders of the same terms
        # differ by more than the bar (the CPU oracle itself reads
        # 2.9999642), so those cells are held, card and CPU alike, to the
        # exact value; every other cell card against CPU.
        (g,), (w,) = got, want
        check(np.array_equal(np.isnan(g), np.isnan(w)),
              "(p) smiley_face: NaN footprints differ")
        eye = w > 2.5
        close(g[eye], np.full(int(eye.sum()), 3.0, np.float32),
              "(p) smiley_face eyes card vs the exact 3")
        close(w[eye], np.full(int(eye.sum()), 3.0, np.float32),
              "(p) smiley_face eyes CPU vs the exact 3")
        return close(g[~eye], w[~eye], "(p) smiley_face card vs CPU")

    # the six examples on the card in their default mode (Auto) and with
    # ExecutionMode.CPU, at their default sizes
    AUTO = pcr.ExecutionMode.Auto
    tif = lambda name: os.path.join(tmp, name)
    for label, run, need in (
            ("quickstart", lambda m: [quickstart.main(
                mode=m, out=tif(f"quickstart_{m.name}.tif"))], ["point"]),
            ("glyph_splatting", lambda m: list(glyph_splatting.main(
                mode=m, out_dir=tmp).values()), ["rotp", "rect"]),
            ("streaming_resume", lambda m: list(streaming_resume.main(
                mode=m, state_dir=tif(f"resume_{m.name}"))), ["point"]),
            ("custom_reduction", lambda m: [custom_reduction.main(mode=m)],
             ["point"]),
            ("smiley_face", lambda m: [smiley_face.main(
                mode=m.name.lower(), out=tif(f"smiley_{m.name}.tif"),
                png=tif(f"smiley_{m.name}.png"))], ["gauss", "rect"])):
        got, w, launches = on_card(label, lambda: run(AUTO), need)
        want, ow = oracle(lambda: run(CPU))
        err = same(label, got, want)
        print(f"(p) example {label}: card {w:.3f}s launches={launches} "
              f"CPU {ow:.3f}s max_abs_err={err!r}")

    # multichip: the mesh on ["cuda:0"] * 4 against the resident band
    check(multichip.mesh_devices() == [torch.device("cuda", 0)] * 4
          or torch.cuda.device_count() > 1, "(p) multichip: the mesh is "
                                           "not four shards of the card")
    (point, gauss), w, _ = on_card("multichip", multichip.main, [])
    x, y, v = multichip.inputs(1 << 16, 256)
    c = pcr.PointCloud.create(len(x))
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", v)
    gspec = pcr.gaussian_splat_spec("value", **multichip.GAUSS)
    gspec.type = pcr.ReductionType.Sum
    avg = pcr.ReductionSpec(value_channel="value",
                            type=pcr.ReductionType.Average)
    (_, (mean, gband), _), rw, _ = on_card("multichip resident", lambda: (
        run_pipeline(pcr, grid(pcr, 256, 3857), [avg, gspec], c, GPU)),
        ["point", "gauss"])
    occ = point[1] > 0
    mesh_mean = np.full(point[0].shape, np.nan, np.float32)
    mesh_mean[occ] = point[0][occ] / point[1][occ]
    err = close(mesh_mean, mean, "(p) multichip Average vs resident")
    m = np.isfinite(gband)
    check(np.all(np.abs(gauss[0][~m]) <= TOL), "(p) multichip Gaussian "
                                               "mass outside the footprint")
    err = max(err, close(gauss[0][m], gband[m],
                         "(p) multichip Gaussian Sum vs resident"))
    print(f"(p) example multichip: mesh of 4 on the card {w:.3f}s, "
          f"resident {rw:.3f}s, max_abs_err={err!r}")

    # the LiDAR harness at DC-LiDAR scale
    d = os.path.join(tmp, "lidar")
    t0 = time.perf_counter()
    nfiles, per_file, extent = lidar_size
    lidar.synthesize(d, nfiles, pts_per_file=per_file, extent=extent,
                     skew=0.5)
    files = lidar.input_files(d)
    bbox, npts = lidar.scan_bounds(files)
    print(f"(p) LiDAR: synthesized {len(files)} LAS files, {npts} points in "
          f"{time.perf_counter() - t0:.3f}s")
    keys = ("io_read_s", "ingest_s", "drain_s", "finalize_s",
            "library_mpts_per_s")
    for glyph, sub, modes in (("point", files, ("gpu", "hybrid", "cpu")),
                              ("gauss", files[:4], ("gpu", "cpu"))):
        bb, n_sub = lidar.scan_bounds(sub)
        gc = lidar.make_grid(bb, 1.0)
        spec = lidar.make_spec(glyph, "z", "Average", 3.0)
        bands = {}
        for mode in modes:
            def run(mode=mode):
                return lidar.run_mode(mode, sub, gc, spec, 2_000_000,
                                      os.path.join(tmp, f"lidar_{mode}.tif"))
            if mode == "cpu":
                (stats, bands[mode]), _ = oracle(run)
            elif (glyph, mode) == ("point", "gpu"):
                with finalize_split() as (secs, calls):
                    (stats, bands[mode]), _, launches = on_card(
                        f"LiDAR {glyph} {mode}", run, ["point"])
                print_split(f"(p) LiDAR point gpu {gc.width}x{gc.height}",
                            secs, calls)
            else:
                (stats, bands[mode]), _, launches = on_card(
                    f"LiDAR {glyph} {mode}", run,
                    ["point" if glyph == "point" else "gauss"])
            check(stats["points"] == n_sub, f"(p) LiDAR {mode}: "
                                             f"{stats['points']} points")
            print(f"(p) LiDAR {glyph} {gc.width}x{gc.height} {n_sub} points "
                  f"{mode}: " + " ".join(f"{k}={stats[k]!r}" for k in keys)
                  + f" wall_s={stats['wall_s']!r} coverage_pct="
                  f"{stats['coverage_pct']!r}")
        g, w = bands["gpu"], bands["cpu"]
        if glyph == "point":
            err = close(g, w, f"(p) LiDAR {glyph} gpu vs cpu")
            extra = ""
        else:
            # the hot clusters pile up to ~1.5e4 terms in a cell: each
            # cell at gauss_rtol of its own term count
            xs, ys = zip(*((cl.x_array(), cl.y_array()) for cl in
                           map(pcr.read_point_cloud, sub)))
            rtol, terms = cell_rtol(gc, np.concatenate(xs),
                                    np.concatenate(ys), 9)
            check(np.array_equal(np.isnan(g), np.isnan(w)),
                  "(p) LiDAR gauss: NaN footprints differ")
            m = ~np.isnan(w)
            diff = np.abs(g[m] - w[m])
            check(bool((diff <= rtol[m] + rtol[m] * np.abs(w[m])).all()),
                  "(p) LiDAR gauss gpu vs cpu: over gauss_rtol of a cell's "
                  "terms")
            err = float(diff.max())
            over = diff > TOL + TOL * np.abs(w[m])
            extra = (f" (cells over 1e-5: {int(over.sum())}, the most "
                     f"terms in a cell {int(terms.max())}, rtol there "
                     f"{float(rtol.max()):.3g})")
        if "hybrid" in bands:
            check(np.array_equal(bands["hybrid"].view(np.int32),
                                 bands["gpu"].view(np.int32)),
                  "(p) LiDAR hybrid band is not gpu's bit for bit")
        print(f"(p) LiDAR {glyph}: gpu vs cpu max_abs_err={err!r}{extra}"
              + (" hybrid bits equal gpu" if "hybrid" in bands else ""))
    shutil.rmtree(d, ignore_errors=True)

    # the glyph pattern pair
    pat = os.path.join(tmp, "patterns")
    _, w, launches = on_card("patterns", lambda: patterns.main(
        ["--out", pat, "--mode", "gpu"]), ["point", "gauss", "rot", "rect"])
    _, ow = oracle(lambda: patterns.main(["--out", pat, "--mode", "cpu"]))
    results, missing = compare_patterns.compare_dir(pat)
    check(not missing and len(results) == 32,
          f"(p) patterns: {len(results)} pairs, missing {missing}")
    failed = [n for n, (ok, _) in results.items() if not ok]
    check(not failed, f"(p) patterns FAIL: {failed}")
    worst = max(float(msg.split()[0].split("=")[1])
                for _, msg in results.values())
    print(f"(p) patterns: scenes 01-08 {len(results)} rasters PASS, "
          f"max_diff={worst!r}; card {w:.3f}s launches={launches}, "
          f"CPU {ow:.3f}s")
    return total


def phase_q(torch, pcr, kernels, gk, lk, points=100_000):
    """(q), see the module docstring; `points` is each grid's cloud, which
    a rehearsal on the CPU may shrink. Returns the launches of K1-K5."""
    from pcr_tpu_torch.scripts import quick_validation
    from pcr_tpu_torch.scripts.diagnostics import (boundary_points,
                                                   grid_sizes,
                                                   transfer_sizes)
    GPU, CPU = pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU
    total = {}
    on_card = functools.partial(counted, torch, kernel_fns(kernels, gk, lk),
                                total, "(q)")

    # the card probe (device_health, quick validation's section 1): its K1
    # launches compare the kernel with its plain version and are not
    # counted
    check(quick_validation.section_probe(), "(q) device_health failed")
    rc, w, launches = on_card("boundary_points",
                              lambda: boundary_points.main([]), ["point"])
    check(rc == 0, f"(q) boundary_points exit code {rc}")
    print(f"(q) boundary_points: PASS {w:.3f}s launches={launches}")
    check(transfer_sizes.main([]) == 0, "(q) transfer_sizes failed")
    mine = transfer_sizes.measure(256)
    theirs = upload_rates(torch)
    print(f"(q) pinned 256 MB H2D: transfer_sizes "
          f"{mine['h2d_pinned'] * 2**20 / 1e9:.2f} GB/s (CUDA events), "
          f"(k)'s upload_rates {theirs['pinned']:.2f} GB/s (host clock); "
          f"pageable {mine['h2d_pageable'] * 2**20 / 1e9:.2f} and "
          f"{theirs['pageable']:.2f} GB/s")
    rc, w, launches = on_card("grid_sizes", lambda: grid_sizes.main(
        ["--mode", "GPU"]), ["point"])
    check(rc == 0, f"(q) grid_sizes --mode GPU exit code {rc}")
    print(f"(q) grid_sizes --mode GPU: PASS {w:.3f}s launches={launches}")

    # the same eight sizes on the card against CPU mode: Count exactly,
    # sigma 4 Gaussian (K2) and Line hl 4 (K3) Average at 1e-5, or
    # gauss_rtol of a cell's terms past ~1e4 terms (cell_rtol)
    specs = {"point": (pcr.ReductionSpec(value_channel="value",
                                         type=pcr.ReductionType.Count), 0),
             "gauss": (pcr.gaussian_splat_spec("value", default_sigma=4.0),
                       12),
             "rect": (pcr.line_splat_spec("value", default_half_length=4.0),
                      4)}
    for k in ("gauss", "rect"):
        specs[k][0].type = pcr.ReductionType.Average
    t_sizes = time.perf_counter()
    for w_, h_ in grid_sizes.SIZES:
        gc = grid_sizes.grid_config(w_, h_)
        c = grid_sizes.make_cloud(w_, h_, points)
        for kind, (spec, r) in specs.items():
            label = f"{w_}x{h_} {points} {kind}"
            (_, (g,), wall), _, launches = on_card(
                label, lambda: run_pipeline(pcr, gc, [spec], c, GPU),
                [kind])
            _, (o,), ow = run_pipeline(pcr, gc, [spec], c, CPU)
            if kind == "point":
                check(np.array_equal(g, o, equal_nan=True),
                      f"(q) {label}: Count differs from CPU mode")
                check(float(np.nansum(g)) == points,
                      f"(q) {label}: Count sums {np.nansum(g)}")
                err, extra = 0.0, ""
            else:
                rtol, terms = cell_rtol(gc, c.x_array(), c.y_array(), r)
                check(np.array_equal(np.isnan(g), np.isnan(o)),
                      f"(q) {label}: NaN footprints differ")
                m = ~np.isnan(o)
                diff = np.abs(g[m] - o[m])
                check(bool((diff <= rtol[m] + rtol[m] * np.abs(o[m])).all()),
                      f"(q) {label}: over 1e-5 / gauss_rtol of a cell's "
                      f"terms (max |diff| {float(diff.max())})")
                err = float(diff.max()) if m.any() else 0.0
                extra = (f" most terms in a cell {int(terms.max())}, "
                         f"rtol there {float(rtol.max()):.3g}")
            print(f"(q) {label}: card {wall['ingest'] + wall['finalize']:.4f}s"
                  f" launches={launches} CPU {ow['ingest']:.4f}s "
                  f"max_abs_err={err!r}{extra}")
    print(f"(q) the eight sizes x 3 glyphs took "
          f"{time.perf_counter() - t_sizes:.1f}s")

    # quick validation's sections 3 (a process of its own) and 4
    check(quick_validation.section_quickstart(),
          "(q) quick validation: the quickstart failed")
    ok, w, launches = on_card("ladder", quick_validation.section_ladder,
                              ["point"])
    check(ok, "(q) quick validation: the ladder failed")
    print(f"(q) quick validation sections 1, 3, 4 passed; ladder "
          f"launches={launches}")
    return total


def k1_layout(pcr, torch, size, n, rtype, seed):
    """A TorchEngine on the card and its K1 layout of n uniform points
    (1% of them invalid) on a size x size grid."""
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    gc = grid(pcr, size, 3857)
    spec = pcr.ReductionSpec(value_channel="value", type=rtype)
    eng = TorchEngine(gc, [(spec, pcr.get_reduction_info(rtype))],
                      torch.device("cuda", 0))
    rng = np.random.default_rng(seed)
    col = rng.integers(0, gc.width, n).astype(np.int32)
    row = rng.integers(0, gc.height, n).astype(np.int32)
    valid = rng.uniform(size=n) >= 0.01
    values = rng.uniform(0, 100, n).astype(np.float32)
    weights = rng.uniform(0.1, 2.0, n).astype(np.float32)
    staged = eng.prepare_point(0, None, valid, values, weights,
                               col=col, row=row)
    check(len(staged) == 1, "K1 layout: one staged chunk expected")
    return eng, staged[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import pcr_tpu_torch as pcr
    from pcr_tpu_torch.engine import _build, gauss_kernels, kernels
    from pcr_tpu_torch.engine import line_kernels as lk
    from pcr_tpu_torch.probes import rot_expand as k6
    RT = pcr.ReductionType
    # the plain versions' matmuls in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"(a) python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels._lib()
    gauss_kernels._lib()
    lk._lib()
    k6._lib()
    print(f"(a) kernel library {os.path.relpath(_build.library_path())} "
          f"ready in {time.perf_counter() - t0:.2f}s")
    log = _build.library_path()[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    print("(a) ptxas:", line.strip())
    card_state("after (a)")

    # (b) K1 against its plain version
    errs = []
    for size, n, rtype, f1, label in (
            (1000, 5_000_000, RT.Average, False, "1000x1000 5M Average"),
            (1000, 5_000_000, RT.WeightedAverage, True,
             "1000x1000 5M WeightedAverage"),
            (160, 5_000_000, RT.Average, False, "160x160 5M Average")):
        eng, staged = k1_layout(pcr, torch, size, n, rtype, SEED)
        k1 = k1_case(torch, kernels, eng, staged, f1, label, reps=10)
        errs.append(k1["err"])
        del eng, staged
    # the row's numbers are the main path's shape: 160x160 (the last)
    card_state("after (b)")

    tmp = tempfile.mkdtemp(prefix="pcr_chip_smoke_")
    try:
        avg = [pcr.ReductionSpec(value_channel="value", type=RT.Average,
                                 output_band_name="mean_value")]

        # (c) the main path
        gc = grid(pcr, 160, 32610)
        c5 = cloud(pcr, 5_000_000, 0.5, 159.5, 100.0, SEED + 1)
        _, oracle, ow = run_pipeline(pcr, gc, avg, c5, pcr.ExecutionMode.CPU)
        state_dir = os.path.join(tmp, "c_state")
        tif = os.path.join(tmp, "c.tif")
        kernels.sorted_splat_point.launches = 0
        p, bands, w = run_pipeline(pcr, gc, avg, c5, pcr.ExecutionMode.GPU,
                                   staged=True, state_dir=state_dir,
                                   output_path=tif)
        launches = kernels.sorted_splat_point.launches
        check(launches >= 1, "(c) the main path never launched K1")
        err_c = close(bands[0], oracle[0], "(c) band vs oracle")
        check(np.array_equal(pcr.read_geotiff_band(tif, 0), bands[0],
                             equal_nan=True), "(c) GeoTIFF != band")
        cfg2 = pcr.PipelineConfig(grid=gc, reductions=avg,
                                  exec_mode=pcr.ExecutionMode.GPU,
                                  gpu_require_strict=True,
                                  state_dir=state_dir)
        resumed = pcr.Pipeline.create(cfg2)
        check(all(np.array_equal(a, b) for a, b in zip(
            resumed._engine.fetch_state(0), p._engine.fetch_state(0))),
            "(c) resume from state_dir does not reproduce the state")
        print(f"(c) main path 160x160 5M Average staged: {fmt(w)} "
              f"K1 launches={launches} max_abs_err={err_c!r} "
              f"oracle: {fmt(ow)}")
        del c5, p, resumed

        # (d) the README quickstart, host-sourced
        gc = grid(pcr, 1000, 3857)
        c1 = cloud(pcr, 1_000_000, 0.0, 1000.0, 1.0, SEED + 2, ts=True)
        specs = avg + [
            pcr.ReductionSpec(value_channel="value", type=RT.Max),
            pcr.ReductionSpec(value_channel="value", type=RT.Min),
            pcr.ReductionSpec(value_channel="value", type=RT.MostRecent,
                              timestamp_channel="ts")]
        _, oracle, ow = run_pipeline(pcr, gc, specs, c1,
                                     pcr.ExecutionMode.CPU)
        before = kernels.sorted_splat_point.launches
        _, bands, w = run_pipeline(
            pcr, gc, specs, c1, pcr.ExecutionMode.GPU,
            state_dir=os.path.join(tmp, "d_state"),
            output_path=os.path.join(tmp, "d.tif"))
        check(kernels.sorted_splat_point.launches > before,
              "(d) the quickstart never launched K1")
        err_d = close(bands[0], oracle[0], "(d) Average vs oracle")
        for i, name in ((1, "Max"), (2, "Min"), (3, "MostRecent")):
            check(np.array_equal(bands[i], oracle[i], equal_nan=True),
                  f"(d) {name} differs from the oracle")
        print(f"(d) quickstart 1000x1000 1M host Average+Max+Min+MostRecent: "
              f"{fmt(w)} max_abs_err(Average)={err_d!r} oracle: {fmt(ow)}")
        hybrid_vs_oracle(pcr, gc, specs, c1, oracle, "(d) quickstart",
                         [kernels.sorted_splat_point], exact=(1, 2, 3))
        d_ref = (gc, c1, specs, oracle, w)    # (n) runs it on a mesh
        del c1

        # (e) DC-LiDAR scale
        gc = grid(pcr, 8192, 32610)
        c20 = cloud(pcr, 20_000_000, 0.0, 8192.0, 100.0, SEED + 3)
        _, oracle, ow = run_pipeline(pcr, gc, avg, c20,
                                     pcr.ExecutionMode.CPU)
        before = kernels.sorted_splat_point.launches
        torch.cuda.reset_peak_memory_stats()
        _, bands, w = run_pipeline(pcr, gc, avg, c20, pcr.ExecutionMode.GPU,
                                   staged=True)
        check(kernels.sorted_splat_point.launches > before,
              "(e) the DC-LiDAR run never launched K1")
        err_e = close(bands[0], oracle[0], "(e) band vs oracle")
        print(f"(e) DC-LiDAR 8192x8192 20M Average staged: {fmt(w)} "
              f"max_abs_err={err_e!r} peak_device_bytes="
              f"{torch.cuda.max_memory_allocated()} oracle: {fmt(ow)}")
        e_ref = (gc, c20, bands[0], w)      # (n) runs it on a mesh
        del c20, oracle

        # (f) K2, K4, K5 against their plain versions
        s1 = dict(default_sigma=1.0)
        s4 = dict(default_sigma=4.0)
        s16 = dict(default_sigma=16.0)
        rot4 = dict(default_sigma_x=4.0, default_sigma_y=1.5,
                    default_rotation=0.6)
        rot8 = dict(default_sigma_x=8.0, default_sigma_y=3.0,
                    default_rotation=0.6)
        fres = {}
        for label, glyph, kind in (
                ("K2 sigma 1 (cut)", s1, "gauss"),
                ("K2 sigma 16", s16, "gauss"),
                ("K5 rotated 4x1.5", rot4, "rotp"),
                ("K4 rotated 8x3", rot8, "rot"),
                ("K2 sigma 4", s4, "gauss")):
            res = gauss_case(torch, pcr, gauss_kernels, 1000, 5_000_000,
                             f"1000x1000 5M Average {label}", glyph, kind,
                             SEED + 4)
            fres.setdefault(kind, []).append(res)
        # the home-tile clip of a multi-tile grid, which the rows above
        # never take, on values of both signs
        for label, glyph, kind in (("K4 rotated 8x3", rot8, "rot"),
                                   ("K2 sigma 4", s4, "gauss")):
            gauss_case(torch, pcr, gauss_kernels, 1000, 200_000,
                       f"1000x1000 256-cell tiles 200k mixed sign {label}",
                       glyph, kind, SEED + 11, tile=256, mixed=True)
        # the glyph suite's headline shapes: sigma 4 (K2), the rotated rows
        kstat = {k: (max(r[0] for r in v), v[-1][1], v[-1][2], v[-1][3])
                 for k, v in fres.items()}
        card_state("after (f)")

        # (g) Gaussian pipelines against the oracle
        gc = grid(pcr, 1000, 3857)
        c1 = cloud(pcr, 1_000_000, 0.0, 1000.0, 100.0, SEED + 5)
        c250 = cloud(pcr, 250_000, 0.0, 1000.0, 100.0, SEED + 6)

        def gspec(glyph, rtype, name=None):
            sp = pcr.gaussian_splat_spec("value", output_band_name=name,
                                         **glyph)
            sp.type = rtype
            return sp

        specs = [gspec(s4, RT.Average, "gauss_s4")]
        state_dir = os.path.join(tmp, "g_state")
        tif = os.path.join(tmp, "g.tif")
        p, bands, _, _ = gauss_pipeline(
            pcr, gauss_kernels, gc, specs, c1, "sigma 4 Average 1M staged",
            ["gauss"], staged=True, state_dir=state_dir, output_path=tif)
        check(np.array_equal(pcr.read_geotiff_band(tif, 0), bands[0],
                             equal_nan=True), "(g) GeoTIFF != band")
        resumed = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.GPU,
            gpu_require_strict=True, state_dir=state_dir))
        check(all(np.array_equal(a, b) for a, b in zip(
            resumed._engine.fetch_state(0), p._engine.fetch_state(0))),
            "(g) resume from state_dir does not reproduce the state")
        del p, resumed
        gauss_pipeline(pcr, gauss_kernels, gc,
                       [gspec(s1, RT.WeightedAverage)], c1,
                       "sigma 1 WeightedAverage 1M", ["gauss"], hybrid=True)
        _, _, _, l_rotp = gauss_pipeline(
            pcr, gauss_kernels, gc, [gspec(rot4, RT.Average)], c1,
            "rotated 4x1.5 Average 1M host", ["rotp"])
        _, _, _, l_rot = gauss_pipeline(
            pcr, gauss_kernels, gc,
            [gspec(rot8, RT.Count), gspec(rot8, RT.Sum)], c250,
            "rotated 8x3 Count+Sum 250k", ["rot"], hybrid=True)
        gauss_pipeline(pcr, gauss_kernels, gc, [gspec(s16, RT.Average)],
                       c250, "sigma 16 Average 250k", ["gauss"])
        del c1, c250

        # the slice's main path at the glyph suite's size: sigma 4, 5M
        c5 = cloud(pcr, 5_000_000, 0.0, 1000.0, 100.0, SEED + 7)
        gauss_kernels.sorted_splat_gauss.launches = 0
        _, bands, w = run_pipeline(pcr, gc, [gspec(s4, RT.Average)], c5,
                                   pcr.ExecutionMode.GPU, staged=True)
        l_gauss = gauss_kernels.sorted_splat_gauss.launches
        check(l_gauss >= 1, "(g) the sigma 4 5M path never launched K2")
        check(np.isfinite(bands[0]).all(), "(g) sigma 4 5M: empty cells "
                                           "on a fully covered grid")
        print(f"(g) sigma 4 Average 5M staged: {fmt(w)} K2 launches="
              f"{l_gauss}")
        del c5

        # (h) K3 against its plain version
        hres = {}
        for label, glyph, n in (
                ("hl 1 dir 0 5M", dict(default_half_length=1.0), 5_000_000),
                ("hl 4 dir 0 5M", dict(default_half_length=4.0), 5_000_000),
                ("hl 16 dir 0.7 1M", dict(default_direction=0.7,
                                          default_half_length=16.0),
                 1_000_000),
                ("hl 16 dir 0 5M", dict(default_half_length=16.0),
                 5_000_000)):
            hres[label] = rect_case(torch, pcr, lk, n, glyph, label,
                                    SEED + 8)
        # the glyph suite's headline shape: hl 16, direction 0, two fields
        k3_err = max(v[0] for r in hres.values() for v in r.values())
        _, k3_ms, k3_plain_ms, k3_bound = hres["hl 16 dir 0 5M"][2]
        card_state("after (h)")

        # (i) Line pipelines against the oracle
        WA = RT.WeightedAverage
        c1 = cloud(pcr, 1_000_000, 0.0, 1000.0, 100.0, SEED + 9,
                   line_channels=True)
        specs = [lspec(pcr, WA, "line_hl4", default_half_length=4.0)]
        state_dir = os.path.join(tmp, "i_state")
        tif = os.path.join(tmp, "i.tif")
        p, bands, _, _ = line_pipeline(
            pcr, lk, gc, specs, c1, "hl 4 WeightedAverage 1M staged",
            staged=True, state_dir=state_dir, output_path=tif)
        check(np.array_equal(pcr.read_geotiff_band(tif, 0), bands[0],
                             equal_nan=True), "(i) GeoTIFF != band")
        resumed = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.GPU,
            gpu_require_strict=True, state_dir=state_dir))
        check(all(np.array_equal(a, b) for a, b in zip(
            resumed._engine.fetch_state(0), p._engine.fetch_state(0))),
            "(i) resume from state_dir does not reproduce the state")
        del p, resumed
        line_pipeline(pcr, lk, gc,
                      [lspec(pcr, RT.Sum, default_direction=0.7,
                             default_half_length=16.0)],
                      c1, "hl 16 dir 0.7 Sum 1M host", hybrid=True)
        line_pipeline(pcr, lk, gc,
                      [lspec(pcr, RT.Average, direction_channel="dir",
                             half_length_channel="hl")],
                      c1, "per-point dir + hl Average 1M host", hybrid=True)
        _, bands, _, _ = line_pipeline(
            pcr, lk, gc, [lspec(pcr, RT.Count, default_direction=0.7,
                                default_half_length=4.0)],
            c1, "Count with a value channel dir 0.7 hl 4 1M host")
        check(np.nanmax(bands[0]) > 1 and np.nanmin(bands[0]) >= 1,
              "(i) Count: counts are not whole cells")
        line_pipeline(pcr, lk, grid(pcr, 1000, 3857, tile=256),
                      [lspec(pcr, WA, default_direction=0.3,
                             default_half_length=16.0)],
                      c1, "256-cell tiles hl 16 dir 0.3 WeightedAverage 1M "
                      "staged", staged=True)
        del c1

        # the slice's main path at the glyph suite's size: hl 16, 5M
        c5 = cloud(pcr, 5_000_000, 0.0, 1000.0, 100.0, SEED + 10)
        lk.rect_splat.launches = 0
        _, bands, w = run_pipeline(
            pcr, gc, [lspec(pcr, WA, default_half_length=16.0)], c5,
            pcr.ExecutionMode.GPU, staged=True)
        l_rect = lk.rect_splat.launches
        check(l_rect >= 1, "(i) the hl 16 5M path never launched K3")
        check(np.isfinite(bands[0]).all(), "(i) hl 16 5M: empty cells on "
                                           "a fully covered grid")
        print(f"(i) hl 16 WeightedAverage 5M staged: {fmt(w)} K3 launches="
              f"{l_rect}")
        del c5

        # (j) K6 through its entry point, then against its plain version
        k6.rot_expand.launches = 0
        rows = k6.run()
        l_k6 = k6.rot_expand.launches
        check(l_k6 >= 1, "(j) the probe never launched K6")
        for r in rows:
            print(f"(j) K6 probe {r}")
            check(r["ok"] and r["bit_identical"],
                  f"(j) K6 {r['variant']}: wrong or not bit-identical")
        nsub, nq, block = 64, 9, 2048
        pp = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (nq, block), dtype=np.float32)).cuda()
        got = k6.rot_expand(pp, nsub, "smem").cpu().numpy()
        want = k6.rot_expand_plain(pp, nsub).cpu().numpy()
        k6_err = close(got, want, "(j) K6 smem vs plain", rtol=1e-4,
                       atol=k6.atol(nsub, nq, block))
        k6_ms, k6_plain_ms, turns = time_turns(
            torch, lambda: k6.rot_expand(pp, nsub, "smem"),
            lambda: k6.rot_expand_plain(pp, nsub), reps=20, plain_reps=20)
        # the bound: the probe's out is nsub expansions of p, each
        # 128 outputs x nq x block / 4 adds; p read once, out written once
        k6_bound = bound(nq * block * 4 + 128 * 4, nsub * nq * block * 32)
        # the floor the design allows: one launch (one step with one add
        # a lane, through the same wrapper) plus a thread's longest chain
        # of dependent adds, 4 clocks each
        tiny = torch.zeros((1, 4), device="cuda")
        launch_ms, _, _ = time_turns(
            torch, lambda: k6.rot_expand(tiny, 1, "smem"),
            lambda: k6.rot_expand_plain(tiny, 1), reps=20, plain_reps=20)
        chain = k6.longest_chain(nsub, nq, block)
        floor_ms = launch_ms + chain * 4 / SM_CLOCK_HZ * 1e3
        print(f"(j) K6 smem vs plain: max_abs_err={k6_err!r} "
              f"kernel_ms={k6_ms!r} plain_ms={k6_plain_ms!r} "
              f"bound_ms={k6_bound[0]!r} ({k6_bound[1]}) "
              f"floor_ms={floor_ms!r} (one launch {launch_ms!r} + a chain "
              f"of {chain} adds; split={k6.split_of(nsub, block)}) "
              f"(turns: {turns})")

        card_state("after (j)")

        # (k) host-sourced ingest: the card lays the chunks out itself
        phase_k(torch, pcr, kernels, gauss_kernels, lk)

        # (l) out-of-core bands, (m) Custom reductions
        t_lm = time.perf_counter()
        l_out = phase_l(torch, pcr, kernels, gauss_kernels, lk, tmp)
        l_m = phase_m(torch, pcr, kernels)
        print(f"(l) + (m) took {time.perf_counter() - t_lm:.1f}s")
        launches += l_out["point"] + l_m
        l_gauss += l_out["gauss"]
        l_rot["rot"] += l_out["rot"]
        l_rect += l_out["rect"]

        # (n) meshes, several shards on the one card
        t_n = time.perf_counter()
        n_out = phase_n(torch, pcr, kernels, gauss_kernels, lk, tmp, e_ref,
                        d_ref)
        del e_ref, d_ref
        print(f"(n) took {time.perf_counter() - t_n:.1f}s")
        launches += n_out["point"]
        l_gauss += n_out["gauss"]
        l_rot["rot"] += n_out["rot"]
        l_rotp["rotp"] += n_out["rotp"]
        l_rect += n_out["rect"]

        # (o) K4 and K5 far from the origin
        t_o = time.perf_counter()
        o_out = phase_o(torch, pcr, gauss_kernels)
        print(f"(o) took {time.perf_counter() - t_o:.1f}s")
        l_rot["rot"] += o_out["rot"]
        l_rotp["rotp"] += o_out["rotp"]

        # (p) the user entry points
        t_p = time.perf_counter()
        p_out = phase_p(torch, pcr, kernels, gauss_kernels, lk, tmp)
        print(f"(p) took {time.perf_counter() - t_p:.1f}s")
        # (q) the diagnostics and the quick validation
        t_q = time.perf_counter()
        q_out = phase_q(torch, pcr, kernels, gauss_kernels, lk)
        print(f"(q) took {time.perf_counter() - t_q:.1f}s")
        for out in (p_out, q_out):
            launches += out["point"]
            l_gauss += out["gauss"]
            l_rot["rot"] += out["rot"]
            l_rotp["rotp"] += out["rotp"]
            l_rect += out["rect"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one PyTorch call computes K1's function (index_add_, and its
    # deterministic rival index_put_); none computes K2-K6's
    pk = "pcr_tpu/engine/pallas_kernels.py"
    rows = [("sorted_splat_point", "sorted_splat_point.cu", f"{pk}:321",
             launches, max(errs), k1["ms"], k1["plain_ms"],
             (k1["bound_ms"], k1["bound_by"]), k1["library_ms"],
             k1["rival_ms"]),
            ("sorted_splat_gauss", "sorted_splat_gauss.cu", f"{pk}:560",
             l_gauss, *kstat["gauss"], None, None),
            ("rot_splat_dense", "rot_splat.cu", f"{pk}:414",
             l_rot["rot"], *kstat["rot"], None, None),
            ("rot_splat_packed", "rot_splat.cu", f"{pk}:111",
             l_rotp["rotp"], *kstat["rotp"], None, None),
            ("rect_splat", "rect_splat.cu", f"{pk}:541", l_rect, k3_err,
             k3_ms, k3_plain_ms, k3_bound, None, None),
            ("rot_expand_probe", "rot_expand_probe.cu",
             "benchmarks/profile_rot_expand.py:27", l_k6, k6_err, k6_ms,
             k6_plain_ms, k6_bound, None, None)]
    leaked = [m for m in ("pcr_tpu", "pcr", "jax") if m in sys.modules]
    check(not leaked, f"the port imported {leaked}")
    print(f"every phase passed in {time.perf_counter() - t_start:.1f}s, "
          f"{sum(ORACLE_S):.1f}s of them the CPU oracle's ingest loops on "
          f"the host")
    print(f"card: {card}")
    card_state("at the end")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"pcr_tpu_torch/csrc/{src}",
        "replaces": rep, "launches": n, "max_abs_err": err, "ms": ms,
        "plain_ms": pms, "bound_ms": bnd[0], "bound_by": bnd[1],
        "library_ms": lib_ms, "rival_ms": rival}
        for name, src, rep, n, err, ms, pms, bnd, lib_ms, rival in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

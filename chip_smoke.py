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
      from CUDA events after a warm-up;
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
      per cell (see gauss_rtol), and both times from CUDA events;
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
  (i) Line pipelines on the 1000x1000 grid against the numpy oracle (1e-5
      per cell, exact NaN footprint): half length 4 WeightedAverage 1M
      staged with state_dir + GeoTIFF + resume, half length 16 direction
      0.7 Sum 1M host-sourced, per-point direction and half length Average
      1M, Count with a value channel 1M (the oracle adds 1 per cell), a
      multi-tile grid (256-cell tiles, the home-tile clip); then the walls
      of the half length 16, 5M staged path;
  (j) kernel K6 (the rot-expand probe) through its entry point at the
      probe's defaults (nsub 64, block 2048, nq 9), then against its plain
      version, both times from CUDA events.
Every pipeline runs with gpu_require_strict and must run on a TorchEngine
on the card, through its kernels: each path is driven with the launch
counters set to 0 just before it and read just after. The line before last
is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

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
                 output_path=""):
    """One pipeline lifecycle; returns (pipeline, bands, walls)."""
    import torch
    cfg = pcr.PipelineConfig()
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
    if mode != pcr.ExecutionMode.CPU:
        eng = p._engine
        from pcr_tpu_torch.engine.torch_backend import TorchEngine
        check(isinstance(eng, TorchEngine) and eng.device.type == "cuda",
              f"the device pipeline runs on {eng!r}, not a CUDA TorchEngine")
        torch.cuda.synchronize()
    walls = {"create": t1 - t0, "stage": t2 - t1, "ingest": t3 - t2,
             "finalize": t4 - t3}
    return p, [p.result().band_array(i) for i in range(len(specs))], walls


def fmt(walls):
    return " ".join(f"{k}={v:.4f}s" for k, v in walls.items())


def k1_case(torch, kernels, eng, staged, with_f1, label, reps):
    """K1 against its plain version on one staged layout."""
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
    return err, ms, plain_ms


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


def gauss_case(torch, pcr, size, n, label, glyph, want_kind, seed):
    """(f): one Gaussian layout of n uniform points, staged through the
    port's Pipeline, held kernel against plain."""
    gc = grid(pcr, size, 3857)
    spec = pcr.gaussian_splat_spec("value", **glyph)
    spec.type = pcr.ReductionType.Average
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True))
    c = cloud(pcr, n, 0.0, float(size), 100.0, seed)
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
    err = max(close(g.cpu().numpy(), w.cpu().numpy(), label, rtol, rtol)
              for g, w in zip(got, ref))
    scratch = fresh()
    ms, plain_ms, turns = time_turns(
        torch, lambda: kern(scratch, pr, b, **kw),
        lambda: plain(scratch, pr, b, **kw), reps=3, plain_reps=1)
    print(f"(f) {label}: {chunk.kind} th={chunk.th} wt={chunk.wt} "
          f"cut={chunk.cut} nsub={pr.shape[0]} rtol={rtol:.3g} "
          f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
          f"(turns: {turns})")
    return err, ms, plain_ms


def gauss_pipeline(pcr, gk, gc, specs, c, label, kinds, staged=False,
                   state_dir="", output_path=""):
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
    live = int((pr[:, 0] <= pr[:, 1]).sum())
    subs = int(torch.bincount(b.long()).max())
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
        print(f"(h) K3 {label} nf={nf}: nsub={pr.shape[0]} entries={live} "
              f"max_subchunks_per_tile={subs} stage={stage_s:.4f}s "
              f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
              f"(turns: {turns})")
        res[nf] = (err, ms, plain_ms)
    return res


def line_pipeline(pcr, lk, gc, specs, c, label, staged=False, state_dir="",
                  output_path=""):
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
    return p, bands, w, launches


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

    # (b) K1 against its plain version
    errs = []
    for size, n, rtype, f1, label in (
            (1000, 5_000_000, RT.Average, False, "1000x1000 5M Average"),
            (1000, 5_000_000, RT.WeightedAverage, True,
             "1000x1000 5M WeightedAverage"),
            (160, 5_000_000, RT.Average, False, "160x160 5M Average")):
        eng, staged = k1_layout(pcr, torch, size, n, rtype, SEED)
        err, ms, plain_ms = k1_case(torch, kernels, eng, staged, f1, label,
                                    reps=10)
        errs.append(err)
        del eng, staged
    main_ms, main_plain_ms = ms, plain_ms     # the main path's shape: 160x160

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
        del c20

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
            res = gauss_case(torch, pcr, 1000, 5_000_000,
                             f"1000x1000 5M Average {label}", glyph, kind,
                             SEED + 4)
            fres.setdefault(kind, []).append(res)
        # the glyph suite's headline shapes: sigma 4 (K2), the rotated rows
        kstat = {k: (max(e for e, _, _ in v), v[-1][1], v[-1][2])
                 for k, v in fres.items()}

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
                       "sigma 1 WeightedAverage 1M", ["gauss"])
        _, _, _, l_rotp = gauss_pipeline(
            pcr, gauss_kernels, gc, [gspec(rot4, RT.Average)], c1,
            "rotated 4x1.5 Average 1M host", ["rotp"])
        _, _, _, l_rot = gauss_pipeline(
            pcr, gauss_kernels, gc,
            [gspec(rot8, RT.Count), gspec(rot8, RT.Sum)], c250,
            "rotated 8x3 Count+Sum 250k", ["rot"])
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
        k3_err = max(e for r in hres.values() for e, _, _ in r.values())
        _, k3_ms, k3_plain_ms = hres["hl 16 dir 0 5M"][2]

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
                      c1, "hl 16 dir 0.7 Sum 1M host")
        line_pipeline(pcr, lk, gc,
                      [lspec(pcr, RT.Average, direction_channel="dir",
                             half_length_channel="hl")],
                      c1, "per-point dir + hl Average 1M host")
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
        print(f"(j) K6 smem vs plain: max_abs_err={k6_err!r} "
              f"kernel_ms={k6_ms!r} plain_ms={k6_plain_ms!r} "
              f"(turns: {turns})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    pk = "pcr_tpu/engine/pallas_kernels.py"
    rows = [("sorted_splat_point", "sorted_splat_point.cu", f"{pk}:321",
             launches, max(errs), main_ms, main_plain_ms),
            ("sorted_splat_gauss", "sorted_splat_gauss.cu", f"{pk}:560",
             l_gauss, *kstat["gauss"]),
            ("rot_splat_dense", "rot_splat.cu", f"{pk}:414",
             l_rot["rot"], *kstat["rot"]),
            ("rot_splat_packed", "rot_splat.cu", f"{pk}:111",
             l_rotp["rotp"], *kstat["rotp"]),
            ("rect_splat", "rect_splat.cu", f"{pk}:541", l_rect, k3_err,
             k3_ms, k3_plain_ms),
            ("rot_expand_probe", "rot_expand_probe.cu",
             "benchmarks/profile_rot_expand.py:27", l_k6, k6_err, k6_ms,
             k6_plain_ms)]
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"pcr_tpu_torch/csrc/{src}",
        "replaces": rep, "launches": n, "max_abs_err": err, "ms": ms,
        "plain_ms": pms} for name, src, rep, n, err, ms, pms in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
      Average.
Every pipeline runs with gpu_require_strict and must run on a TorchEngine
on the card, through K1. The line before last is a JSON summary of the
kernels; the last line is
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


def grid(pcr, size, epsg):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, size, size
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def cloud(pcr, n, lo, hi, vmax, seed, ts=False):
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
    kern = lambda: kernels.sorted_splat_point(scratch, p, b, **kw)
    plain = lambda: kernels.sorted_splat_point_plain(scratch, p, b, **kw)

    def time_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for fn in (plain, kern, plain, kern):       # warm-up
        fn()
    t = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                     ("plain", plain)):
        t[name].append(time_ms(fn))
    ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
    print(f"(b) K1 {label}: nsub={p.shape[0]} max_abs_err={err!r} "
          f"kernel_ms={ms!r} plain_ms={plain_ms!r} (turns: {t})")
    return err, ms, plain_ms


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
    from pcr_tpu_torch.engine import _build, kernels
    RT = pcr.ReductionType

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
    print(f"(a) kernel library {os.path.relpath(_build.library_path())} "
          f"ready in {time.perf_counter() - t0:.2f}s")
    log = _build.library_path()[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "sorted_splat_point", "route": "cuda",
        "source": "pcr_tpu_torch/csrc/sorted_splat_point.cu",
        "replaces": "pcr_tpu/engine/pallas_kernels.py:321",
        "launches": launches, "max_abs_err": max(errs),
        "ms": main_ms, "plain_ms": main_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

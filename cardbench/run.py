"""
One run of one cell: set-up, a window of whole jobs, the check of what
they returned, and one result line.

    python3 -m cardbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up is process start to the window's start: importing torch and the
port, starting the card, loading the port's kernels (built once per
checkout, in pcr_tpu_torch/_build/), generating the points from the seed,
the traffic's clouds or staged cloud, and one warm-up job. The window runs
jobs one after another (a closed loop) while it is open; the last job
started runs to its end and counts. With --trace 1 the window runs under
torch.profiler with the harness's spans, and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

After the window the program's state is freed, the plain reference
computes each reduction's raster again from the points, and the bands of
a sample of the window's jobs (drawn from the seed, the last job always
among them) are compared with it (`check`, which the calibration shares).
Then the run checks that nothing of JAX or of the JAX package was loaded,
prints each compared number beside its limit as the last lines of stderr,
and prints the result as the last line of stdout. Without a CUDA card,
with fewer than the cell asks for, or with the port's device set
elsewhere (PCR_TORCH_DEVICE), it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import random
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import compare, isolation, peaks, registry
from .grid import Grid
from .stats import percentile


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m cardbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Sample:
    """A uniform sample of k of the window's results (reservoir sampling
    from the seed), and the last one."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.kept, self.last, self.n = [], None, 0

    def offer(self, raster) -> None:
        if self.last is not None:
            if len(self.kept) < self.k:
                self.kept.append(self.last)
            else:
                j = self.rng.randrange(self.n)
                if j < self.k:
                    self.kept[j] = self.last
        self.last, self.n = raster, self.n + 1

    def rasters(self) -> list:
        return self.kept + ([self.last] if self.last is not None else [])


@dataclass
class Run:
    """What a run measured; every metric's `read(run)` takes it."""
    points_per_job: int
    setup_s: float
    window_start: float
    job_walls: list = field(default_factory=list)
    job_ends: list = field(default_factory=list)
    ingest_walls: list = field(default_factory=list)
    finalize_walls: list = field(default_factory=list)
    peak_window_bytes: int | None = None
    trace: object = None                 # trace.Summary, traced runs
    route_s: float | None = None         # host s inside routing.assign
    route_points: int = 0
    h2d_bytes: int = 0                   # uploaded through _Arena.put
    layout_s: float | None = None        # the device layout, CUDA events
    least_time_per_job_s: float | None = None   # peaks.least_time


def _say(*a) -> None:
    print("cardbench:", *a, file=sys.stderr, flush=True)


def _tail(name: str, walls: list) -> None:
    if walls:
        _say(f"{name}: median {percentile(walls, 50) * 1e3:.4f} ms, "
             f"p95 {percentile(walls, 95) * 1e3:.4f} ms, "
             f"{len(walls)} samples")


def _card_ok(torch, chips: int) -> bool:
    if not torch.cuda.is_available():
        _say("no CUDA card: torch.cuda.is_available() is false")
        return False
    if torch.cuda.device_count() < chips:
        _say(f"the cell asks for {chips} cards, "
             f"torch sees {torch.cuda.device_count()}")
        return False
    return True


def measure(cell, seed: int, seconds: float, traced: bool, t0: float,
            device):
    """Set-up and the window. Returns (run, points, sample, attempted,
    failed, setup peak bytes)."""
    import torch

    from . import glyphs, jobs, trace

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = cell.config
    grid = Grid.of(cfg)
    points = registry.cloud_generator(cfg["points"]["kind"])(
        cfg["points"], grid, seed)
    feed = jobs.Feed(cfg, cell.traffic, points)
    warm = jobs.job(feed, jobs.Walls())
    nbytes = sum(b.nbytes for b in warm)
    sample = Sample(max(1, min(16, (1 << 30) // max(nbytes, 1))), seed)
    del warm
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    walls = jobs.Walls()
    attempted = failed = 0
    prof = probe = None
    with contextlib.ExitStack() as stack:
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(
                activities=acts, record_shapes=False, with_stack=False,
                profile_memory=False))
            probe = stack.enter_context(jobs.hooks())
            stack.enter_context(
                torch.profiler.record_function(trace.SPAN + "window"))
        start = time.perf_counter()
        close = start + seconds
        while time.perf_counter() < close:
            attempted += 1
            try:
                bands = jobs.job(feed, walls, traced)
            except Exception:   # counted as failed; the window goes on
                failed += 1
                if failed == 1:
                    _say("a job failed:\n" + traceback.format_exc())
                continue
            sample.offer(bands)
            del bands
        sync()
    run = Run(points_per_job=feed.npoints, setup_s=start - t0,
              window_start=start, job_walls=walls.job, job_ends=walls.ends,
              ingest_walls=walls.ingest, finalize_walls=walls.finalize,
              peak_window_bytes=(torch.cuda.max_memory_allocated()
                                 if cuda else None))
    if traced:
        t = time.perf_counter()
        events = trace.from_kineto(prof)
        run.trace = trace.summarize(events)
        _say(f"trace: {len(events)} events read in "
             f"{time.perf_counter() - t:.2f} s")
        del events
        run.route_s, run.route_points = probe.route_s, probe.route_points
        run.h2d_bytes = probe.h2d_bytes
        run.layout_s = probe.layout_s()
        card = peaks.of(torch.cuda.get_device_name(device)) if cuda else None
        if card is not None:
            work = glyphs.job_work(points, grid, cfg["reductions"],
                                   feed.calls, device)
            run.least_time_per_job_s = peaks.least_time(work, card)
            _say(f"work a job: {work['bytes']} B, {work['flops']} float32 "
                 f"ops; least time {run.least_time_per_job_s * 1e3:.6f} ms")
    return run, points, sample, attempted, failed, setup_peak


def card(chips: int):
    """torch.device("cuda", 0), where the cell's cards are there and the
    port puts its state on the first; else None, having said why. The
    benchmark measures the card only: a port sent elsewhere by
    PCR_TORCH_DEVICE is no run."""
    import torch
    if not _card_ok(torch, chips):
        return None
    try:
        from pcr_tpu_torch.core.device import default_device
    except ImportError as e:
        _say(f"the program is missing: {e}")
        return None
    dev = default_device()
    if dev.type != "cuda" or (dev.index or 0) != 0:
        _say(f"the port's device is {dev} (PCR_TORCH_DEVICE), not cuda:0")
        return None
    torch.cuda.init()
    return torch.device("cuda", 0)


def check(config: dict, points, results, failed: int, device) -> tuple:
    """The check after a window, once the program's state is freed: the
    plain reference of the points, then compare.verdict of `results`.
    Returns (checks, limits, correct)."""
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs = compare.references(config, points, device)
    out = compare.verdict(config, results, failed, refs)
    del refs
    return out


def main(argv, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = registry.load_cell(args.workload)
    device = card(cell.chips)
    if device is None:
        return 2
    return execute(cell, args.seed, args.seconds, bool(args.trace), t0,
                   device)


def execute(cell, seed: int, seconds: float, traced: bool, t0: float,
            device) -> int:
    """A run of `cell` on `device` from set-up to the result line."""
    import torch
    run, points, sample, attempted, failed, setup_peak = measure(
        cell, seed, seconds, traced, t0, device)

    if traced:
        metrics = cell.per_layer
    else:
        metrics = cell.end_to_end
        _tail("ingest calls", run.ingest_walls)
        _tail("jobs", run.job_walls)
    values = {}
    for m in metrics:
        v = registry.metric_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else str(device),
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, run.peak_window_bytes or 0)}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s

    t = time.perf_counter()
    results = sample.rasters()
    del sample
    checks, limits, correct = check(cell.config, points, results, failed,
                                    device)
    _say(f"{len(run.job_ends)} jobs of {attempted} attempted, {failed} "
         f"failed; {len(results)} results checked in "
         f"{time.perf_counter() - t:.2f} s")

    found = isolation.forbidden(sys.modules)
    if found:
        _say("modules of JAX or of the JAX package were loaded: "
             + ", ".join(found))
        return 3
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": values, "device": dev}
    if traced:
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in sorted(checks)}
    for k in sorted(checks):
        _say(f"check {k} {checks[k]!r} limit {limits[k]!r}")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

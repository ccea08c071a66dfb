"""
Phase timing + observability helpers.

The reference has no tracer; its benchmarks wrap phases with wall-clock
timers (io_read_s / ingest_s / finalize_s columns,
scripts/data/test_dc_lidar.py, benchmark_results/mode_comparison.csv).
This module provides the same phase accounting as a reusable utility, plus
an optional torch.profiler trace context for device timelines.

The port's copy of pcr_tpu/utils/profiling.py: PhaseTimer as it is, and
`trace` on torch.profiler (with an NVTX range on a CUDA card) where
pcr_tpu's uses jax.profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["PhaseTimer", "trace"]


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("ingest"):
    ...     do_work()
    >>> t.seconds("ingest")
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def seconds(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def summary(self) -> dict:
        return {k: {"seconds": round(v, 6), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, secs in sorted(self.totals.items(),
                                 key=lambda kv: -kv[1]):
            lines.append(f"{name:20s} {secs:9.3f}s  "
                         f"{100 * secs / total:5.1f}%  "
                         f"({self.counts[name]} calls)")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def trace(log_dir: str | None = None, name: str = "pcr_tpu_torch"):
    """Optional device trace via torch.profiler: the block's host and (on
    a CUDA card) device activity, written as a Chrome trace JSON file into
    `log_dir` (view with Perfetto or chrome://tracing). On a card the block
    is also one NVTX range `name`, for external timelines. Yields the
    profiler (its key_averages() sum the block's operators), or None and
    records nothing when log_dir is None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.nvtx.range_pop()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}_{os.getpid()}_{time.time_ns()}.json"))

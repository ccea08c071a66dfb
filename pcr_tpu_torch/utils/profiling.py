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

The port's own spans and counters (`span`, `count`, `device_span`,
`snapshot`): the engine opens a span around each part of an ingest and a
finalize and counts bytes and host synchronisations where they happen.
They record only while a torch profiler records
(`torch.profiler.profile`, `trace` below, or
`torch.autograd.profiler.emit_nvtx` under Nsight Systems): a span is then a
`record_function` range named "pcr.<name>", on the profiler's clock in the
same trace as the kernels and copies, and its host seconds (total, self:
less the spans nested in it on the same thread, and its longest call) go
into one process-wide table that `snapshot` reads. Otherwise a span is one
flag check and a shared object that does nothing.

Beside the spans the table keeps one interval that is no span: the
between-job gap, row "job_gap" (`gap_open`, `gap_close`). It opens when a
copy to the host returns (torch_backend._to_host, the end of a finalize)
and closes at the next device work of an accumulate (the entry to
TorchEngine.commit or to _Arena.put, whichever comes first), so it holds
what the host does between one job's result and the next job's first
work for the card: the finalize's tail, the result, the next job's
`create` and its ingest up to the first upload or commit. The card has
nothing queued then but the next engine's state fill
(TorchEngine.__init__: a few microseconds on 1000², ~0.2 ms for two
268 MB planes on 8192²). The gap is on no thread's stack: it has no self
time and takes nothing from the spans it overlaps. Both ends show in a
trace, the end of "pcr.finalize.d2h" and the start of "pcr.ingest.commit"
or "pcr.ingest.upload".

The switch is the flag torch keeps for such checks
(`torch.autograd.profiler._is_profiler_enabled`), which every thread
reads, so the spans of Hybrid mode's worker threads go into the table too.
torch's profiler traces only the thread that started it: those spans do
not show in its trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["PhaseTimer", "trace", "span", "count", "device_span",
           "gap_open", "gap_close", "recording", "snapshot", "reset"]

PREFIX = "pcr."     # the port's spans in a trace


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
    is also one NVTX range `name`, for external timelines. The port's spans
    record inside the block (the "pcr." ranges of the trace, and
    `snapshot`). Yields the profiler (its key_averages() sum the block's
    operators), or None and records nothing when log_dir is None."""
    if not log_dir:
        yield None
        return
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


# -- the port's spans and counters --------------------------------------------

_lock = threading.Lock()
_local = threading.local()      # .stack: this thread's open spans
_spans: dict = {}               # name -> [total ns, self ns, calls, max ns]
_counters: dict = {}            # name -> int
_device_ms: dict = {}           # name -> CUDA-event ms, resolved
_pending: list = []             # (name, start event, end event)
_gap_t0 = None                  # host ns the open between-job gap began


def recording() -> bool:
    """Whether a torch profiler records, on any thread."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of a block nothing records: enter and exit do nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "t0", "child")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            _add(self.name, dt, dt - self.child)
        return self.range.__exit__(*exc)


def _add(name: str, dt: int, own: int) -> None:
    """One call of `dt` ns, `own` of them its self time, into `name`'s row.
    Called with _lock held."""
    rec = _spans.get(name)
    if rec is None:
        rec = _spans[name] = [0, 0, 0, 0]
    rec[0] += dt
    rec[1] += own
    rec[2] += 1
    if dt > rec[3]:
        rec[3] = dt


def span(name: str):
    """A context manager: while a torch profiler records, the block is the
    range "pcr.<name>" in its trace and adds its host seconds to `name`'s
    row of the table; otherwise it does nothing."""
    if not recording():
        return _OFF
    return _Span(name)


def gap_open() -> None:
    """Open the between-job gap now, while a torch profiler records; a gap
    already open opens again from now (the last copy of a finalize of
    several reductions opens it)."""
    global _gap_t0
    if recording():
        _gap_t0 = time.perf_counter_ns()


def gap_close() -> None:
    """Close the open between-job gap and add it to row "job_gap" (its
    seconds, calls and longest call; no self time). A close with no gap
    open records nothing, and a close while no profiler records drops the
    gap (one left open when the profiler stopped); `reset` drops it too."""
    global _gap_t0
    if _gap_t0 is None:
        return
    t1 = time.perf_counter_ns()
    with _lock:
        t0, _gap_t0 = _gap_t0, None
        if t0 is not None and recording():
            _add("job_gap", t1 - t0, 0)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, while a torch profiler records."""
    if recording():
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


class _DeviceSpan:
    __slots__ = ("name", "stream", "start")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        with _lock:
            _pending.append((self.name, self.start, end))
            _resolve(wait=False)
        return False


def device_span(name: str, device):
    """A context manager: while a torch profiler records and `device` is a
    CUDA device, CUDA events on its current stream around the block, whose
    elapsed time goes into `name`'s device seconds. The time is read off
    the events once they have completed (at the next device span, or by
    `snapshot`), so the block waits for nothing."""
    if not recording() or torch.device(device).type != "cuda":
        return _OFF
    return _DeviceSpan(name, device)


def _resolve(wait: bool) -> None:
    """Fold the completed device spans into the table (all of them, after
    waiting, with `wait`). Called with _lock held."""
    keep = []
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((name, start, end))
            continue
        _device_ms[name] = _device_ms.get(name, 0.0) + start.elapsed_time(end)
    _pending[:] = keep


def snapshot() -> dict:
    """The table since the process started (or the last `reset`), counting
    only blocks run while a profiler recorded: {"spans": {name: {"s",
    "self_s", "n", "max_s", "device_s"}}, "counters": {name: int}}.
    `max_s` is the longest single call; `device_s` is None for a span with
    no device span of its name. Row "job_gap" is the between-job gap."""
    with _lock:
        _resolve(wait=True)
        spans = {}
        for name in set(_spans) | set(_device_ms):
            total, own, n, longest = _spans.get(name, (0, 0, 0, 0))
            dev = _device_ms.get(name)
            spans[name] = {"s": total / 1e9, "self_s": own / 1e9, "n": n,
                           "max_s": longest / 1e9,
                           "device_s": None if dev is None else dev / 1e3}
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Empty the table and drop an open gap (for tests)."""
    global _gap_t0
    with _lock:
        _gap_t0 = None
        _spans.clear()
        _counters.clear()
        _device_ms.clear()
        _pending.clear()

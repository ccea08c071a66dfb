"""
Reading torch.profiler's timeline of a traced window.

The profiler's events are first made plain `Event`s (`from_kineto`), so
the arithmetic below runs on fixed inputs in the tests:

  * busy time: the union of the device's kernel, memcpy and memset
    intervals inside the window, so kernels and copies that overlap count
    once and the gaps between calls count as idle (chip_smoke.py's
    `busy_share` summed device times over one ingest's wall instead);
  * the accumulate's device time: every kernel launched while a
    `cardbench.commit` span was open, found through its launch's
    correlation id;
  * H2D: the device time of the `Memcpy HtoD` rows;
  * the breakdown: device time by operation name, and idle time by the
    harness span the host had open when the device went idle.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

SPAN = "cardbench."   # the prefix of the harness's own spans
DEVICE_KINDS = ("kernel", "memcpy", "memset")
NAME_CHARS = 120      # a kernel's C++ name is cut to this in the breakdown


@dataclass
class Event:
    name: str
    kind: str        # kernel | memcpy | memset | launch | span | op
    start: int       # ns, one clock for host and device
    end: int
    corr: int = 0    # launch <-> device correlation


_SYNC = re.compile(r" Sync$|^Stream Wait Event$")
_API = re.compile(r"^cu(da)?[A-Z]")


def _kind(name: str, device: bool, annotation: bool) -> str:
    """An event's kind from what every torch 2.x KinetoEvent has: its
    device type, name and whether it is a user annotation."""
    if device:
        if annotation or _SYNC.search(name):
            return "other"
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    if annotation:
        return "span"
    if _API.match(name):
        return "launch"
    return "op"


def from_kineto(prof) -> list:
    """The profiler's events as `Event`s (prof: torch.profiler.profile,
    after it has stopped). A memcpy's bytes are not among a KinetoEvent's
    fields; the harness counts the uploads' bytes itself."""
    out = []
    for e in prof.profiler.kineto_results.events():
        device = "cuda" in str(e.device_type()).lower()
        kind = _kind(e.name(), device, e.is_user_annotation())
        out.append(Event(e.name(), kind, e.start_ns(),
                         e.start_ns() + e.duration_ns(), e.correlation_id()))
    return out


def union(intervals) -> list:
    """Merged, sorted [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _inside(t: int, ranges_start: list, ranges: list) -> bool:
    """Is t inside one of `ranges` (sorted, disjoint [start, end])?"""
    i = bisect.bisect_right(ranges_start, t) - 1
    return i >= 0 and t <= ranges[i][1]


@dataclass
class Summary:
    window_s: float
    busy_s: float
    commit_kernel_s: float
    h2d_s: float
    device_ops: list = field(default_factory=list)   # [[name, s]]
    idle_gaps: list = field(default_factory=list)    # [[span, s]]


def summarize(events: list, top: int = 10) -> Summary:
    spans = [e for e in events if e.kind == "span"
             and e.name.startswith(SPAN)]
    windows = [e for e in spans if e.name == SPAN + "window"]
    if not windows:
        raise ValueError("trace: no cardbench.window span")
    w0, w1 = windows[0].start, windows[0].end
    dev = [e for e in events if e.kind in DEVICE_KINDS
           and e.end > w0 and e.start < w1]
    busy = union((max(e.start, w0), min(e.end, w1)) for e in dev)
    busy_ns = sum(e - s for s, e in busy)

    commits = union((e.start, e.end) for e in spans
                    if e.name == SPAN + "commit")
    starts = [s for s, _ in commits]
    launches = {e.corr: e for e in events if e.kind == "launch" and e.corr}
    kernels = [e for e in dev if e.kind == "kernel"]
    in_commit = [k for k in kernels if k.corr in launches
                 and _inside(launches[k.corr].start, starts, commits)]
    commit_ns = sum(k.end - k.start for k in in_commit)

    h2d = [e for e in dev if e.kind == "memcpy" and "htod" in e.name.lower()]
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        commit_kernel_s=commit_ns / 1e9,
        h2d_s=sum(e.end - e.start for e in h2d) / 1e9,
        device_ops=[[n[:NAME_CHARS], t / 1e9] for n, t in ops],
        idle_gaps=idle_by_span(busy, spans, w0, w1, top))


def idle_by_span(busy: list, spans: list, w0: int, w1: int,
                 top: int = 10) -> list:
    """Idle seconds of the device inside [w0, w1], each gap given to the
    innermost harness span open on the host at its middle ("window" is
    the loop between jobs): [[span, seconds]], most first."""
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    # sweep: span starts and ends, and gap middles, in time order; spans
    # of one thread nest, so the innermost open span is the top of a stack
    marks = []
    for e in spans:
        marks.append((e.start, 0, e.name[len(SPAN):]))
        marks.append((e.end, 2, e.name[len(SPAN):]))
    for a, b in gaps:
        marks.append(((a + b) // 2, 1, b - a))
    marks.sort(key=lambda m: (m[0], m[1]))
    stack, idle = [], {}
    for _, what, x in marks:
        if what == 0:
            stack.append(x)
        elif what == 2:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == x:
                    del stack[i]
                    break
        else:
            label = stack[-1] if stack else "outside"
            idle[label] = idle.get(label, 0) + x
    return [[k, v / 1e9] for k, v in
            sorted(idle.items(), key=lambda kv: -kv[1])[:top]]

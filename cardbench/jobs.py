"""
The system under test: whole jobs of pcr_tpu_torch.Pipeline. The only
module of the harness that imports the port.

A job is `Pipeline.create(config)` in ExecutionMode.GPU with
gpu_require_strict, the traffic's `ingest` calls, `finalize()`, and
`result()` with its bands as numpy arrays on the host. The
configuration's file sets the pipeline's options (`pipeline`: the
execution mode, strictness, a memory budget, any PipelineConfig field by
name) and its `reductions`, each built by its glyph's module. Host traffic
ingests PointClouds made in set-up, one per call; staged traffic ingests
one StagedCloud that set-up built with `Pipeline.stage` (the cloud
resident on the card before timing, the upstream's GPU-Device mode).

In traced runs the harness opens its own spans (torch.profiler
record_function ranges named `cardbench.<phase>`) around the job's phases
and around two calls inside the port: `routing.assign` (host routing,
whose seconds it also sums) and `TorchEngine.commit` (the accumulate). It
also counts the bytes each upload hands to the copy (`_Arena.put`, the
port's one way to the card), which the profiler's rows do not carry.
"""

from __future__ import annotations

import contextlib
import enum
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import device_prep, routing
from pcr_tpu_torch.engine.torch_backend import TorchEngine, _Arena

from . import registry
from .grid import Grid
from .trace import SPAN


def grid_config(grid: Grid) -> "pcr.GridConfig":
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y = grid.min_x, grid.min_y
    bbox.max_x, bbox.max_y = grid.max_x, grid.max_y
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = grid.cell, -grid.cell
    gc.tile_width = gc.tile_height = grid.tile
    gc.crs = pcr.CRS.from_epsg(grid.epsg)
    gc.compute_dimensions()
    return gc


def pipeline_config(config: dict):
    """The port's PipelineConfig: the grid, a spec a reduction from its
    glyph's module, and each option of `pipeline` by its field's name (an
    enum field by its member's name)."""
    cfg = pcr.PipelineConfig()
    cfg.grid = grid_config(Grid.of(config))
    cfg.reductions = [registry.glyph(r["glyph"]).spec(pcr, r)
                      for r in config["reductions"]]
    for key, value in config["pipeline"].items():
        if key in ("grid", "reductions") or not hasattr(cfg, key):
            raise ValueError(f"no pipeline option {key!r}")
        old = getattr(cfg, key)
        if isinstance(old, enum.Enum):
            value = type(old)[value]
        setattr(cfg, key, value)
    return cfg


def point_cloud(points, a: int, b: int, channels, epsg: int):
    """The points [a, b) as a host PointCloud; the one value a point is
    every channel in `channels`."""
    c = pcr.PointCloud.create(b - a)
    c.set_x_array(points.x[a:b])
    c.set_y_array(points.y[a:b])
    for channel in channels:
        c.add_channel(channel, pcr.DataType.Float32)
        c.set_channel_array_f32(channel, points.value[a:b])
    c.set_crs(pcr.CRS.from_epsg(epsg))
    return c


class Feed:
    """What each job ingests, made in set-up: host PointClouds, one per
    `ingest` call, or one StagedCloud staged on the card."""

    def __init__(self, config: dict, traffic: dict, points):
        self.cfg = pipeline_config(config)
        self.calls = points.chunks(int(traffic.get("chunk_points", 0)))
        channels = sorted({r["value_channel"]
                           for r in config["reductions"]})
        epsg = Grid.of(config).epsg
        clouds = [point_cloud(points, a, b, channels, epsg)
                  for a, b in self.calls]
        if traffic["source"] == "staged":
            pipe = pcr.Pipeline.create(self.cfg)
            self.inputs = [pipe.stage(c) for c in clouds]
        elif traffic["source"] == "host":
            self.inputs = clouds
        else:
            raise ValueError(f"traffic source {traffic['source']!r}")
        self.npoints = len(points)
        self.nbands = len(config["reductions"])


@dataclass
class Walls:
    """Host-clock seconds of the jobs of a window."""
    job: list = field(default_factory=list)
    ends: list = field(default_factory=list)
    ingest: list = field(default_factory=list)
    finalize: list = field(default_factory=list)


def _span(traced: bool, name: str):
    if traced:
        return torch.profiler.record_function(SPAN + name)
    return contextlib.nullcontext()


def job(feed: Feed, walls: Walls, traced: bool = False) -> tuple:
    """One whole job; returns its bands, one a reduction, and adds its
    walls."""
    clock = time.perf_counter
    t0 = clock()
    with _span(traced, "job"):
        with _span(traced, "create"):
            pipe = pcr.Pipeline.create(feed.cfg)
        for cloud in feed.inputs:
            t = clock()
            with _span(traced, "ingest"):
                pipe.ingest(cloud)
            walls.ingest.append(clock() - t)
        t = clock()
        with _span(traced, "finalize"):
            pipe.finalize()
        walls.finalize.append(clock() - t)
        with _span(traced, "result"):
            grid = pipe.result()
            bands = tuple(np.asarray(grid.band_array(i))
                          for i in range(feed.nbands))
        del pipe, grid
    end = clock()
    walls.job.append(end - t0)
    walls.ends.append(end)
    return bands


@dataclass
class Probe:
    """What the traced run's hooks gather inside the port."""
    route_s: float = 0.0
    route_points: int = 0
    h2d_bytes: int = 0
    marks: list = field(default_factory=list)

    def layout_s(self):
        """Seconds of the device layout, from the port's CUDA-event
        timeline: each chunk's "uploaded" to its "end" (a chunk laid out
        on the host has no "end" and is left out). None without marks."""
        total, start, n = 0.0, None, 0
        for name, ev in self.marks:
            if name == "uploaded":
                start = ev
            elif name == "end" and start is not None:
                total += start.elapsed_time(ev) / 1e3
                start, n = None, n + 1
        return total if n else None


@contextlib.contextmanager
def hooks():
    """Spans around routing.assign and TorchEngine.commit, the host seconds
    of routing, the bytes uploaded, and the port's device-layout timeline,
    for the block."""
    probe = Probe()
    assign, commit, put = routing.assign, TorchEngine.commit, _Arena.put

    def timed_assign(cfg, x, y, *a, **k):
        t = time.perf_counter()
        with torch.profiler.record_function(SPAN + "route"):
            out = assign(cfg, x, y, *a, **k)
        probe.route_s += time.perf_counter() - t
        probe.route_points += len(x)
        return out

    def spanned_commit(self, *a, **k):
        with torch.profiler.record_function(SPAN + "commit"):
            return commit(self, *a, **k)

    def counted_put(self, hb, nwords):
        probe.h2d_bytes += 4 * int(nwords)      # int32 words
        return put(self, hb, nwords)

    routing.assign, TorchEngine.commit = timed_assign, spanned_commit
    _Arena.put = counted_put
    try:
        with device_prep.timeline() as marks:
            probe.marks = marks
            yield probe
    finally:
        routing.assign, TorchEngine.commit = assign, commit
        _Arena.put = put

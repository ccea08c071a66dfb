"""
Point glyph: each point adds into the one cell it falls in.

`reference` is the plain float64 raster of an Average, written from the
semantics of the port's numpy oracle (pcr_tpu_torch/engine/cpu_backend.py
`accumulate_point_cpu`, ops/reduction.py's finalize): sum / count where a
cell has points, NaN where it has none. It imports nothing of the port
and takes only the generated points.

`work` is what any accumulate of a job must do, recounted from the points
(the copy of chip_smoke.py's `io_bytes` counted the port's own layout;
this counts the inputs, so it reads the same work whatever lays it out):
each point's value read once (4 B; its cell is `job_work`'s), each of
the 2 state planes (sum, count) of each cell a call touches read and
written once per `ingest` call, one float32 add per state plane per point.
"""

from __future__ import annotations

import numpy as np
import torch

from . import refuse_unknown

PLANES = 2   # sum, count
KEYS = ("glyph", "type", "value_channel")
TYPES = ("Average",)


def spec(pcr, red: dict):
    """The port's ReductionSpec: a Point glyph (the spec's default)."""
    refuse_unknown("point", red, KEYS, TYPES)
    s = pcr.ReductionSpec()
    s.value_channel = red["value_channel"]
    s.type = getattr(pcr.ReductionType, red["type"])
    return s


def _cells(points, grid, red):
    refuse_unknown("point", red, KEYS, TYPES)
    col, row, valid = grid.assign(points.x, points.y)
    return col, row, valid


def reference(points, grid, red, device, control=False) -> torch.Tensor:
    """(H, W) raster on `device`: float64, or with `control` the same sums
    taken from bfloat16 values in float32 (the step below the
    configuration's float32 that a later change might take)."""
    col, row, valid = _cells(points, grid, red)
    H, W = grid.height, grid.width
    flat = torch.from_numpy((row * W + col)[valid]).to(device)
    v = torch.from_numpy(points.value[valid]).to(device)
    dt = torch.float32 if control else torch.float64
    v = (v.to(torch.bfloat16) if control else v).to(dt)
    s = torch.zeros(H * W, dtype=dt, device=device).index_add_(0, flat, v)
    c = torch.zeros(H * W, dtype=dt, device=device).index_add_(
        0, flat, torch.ones_like(v))
    nan = torch.tensor(float("nan"), dtype=dt, device=device)
    return torch.where(c > 0, s / torch.where(c > 0, c, 1.0), nan).view(H, W)


def work(points, grid, red, calls, device="cpu") -> dict:
    """{"bytes", "flops"} of the reduction in one job whose `ingest` calls
    take the point ranges `calls` [(start, end)]."""
    col, row, valid = _cells(points, grid, red)
    flat = row * grid.width + col
    nbytes = flops = 0
    for a, b in calls:
        live = flat[a:b][valid[a:b]]
        touched = len(np.unique(live))
        nbytes += len(live) * 4 + touched * PLANES * 8
        flops += len(live) * PLANES
    return {"bytes": nbytes, "flops": flops}

"""
Line glyph: each point adds its value and 1 into every cell of a
one-cell-wide stroke, the dual-step Bresenham walk between two endpoints
`half_length` world units either side of the point along `direction`.

`reference` is the plain float64 raster, written from the upstream's walk
(glyph_kernels.cu:188-281), whose semantics the port's numpy oracle
(pcr_tpu_torch/engine/cpu_backend.py `accumulate_line_cpu`,
routing.line_params, ops/reduction.py's finalize) copies:

  * the fractional cell of each point in float64;
  * signed cell-unit half lengths hx = min(hl / cell, cap) and
    hy = min(hl / -cell, cap) in float32 (hy < 0 on a north-up grid, and
    the cap leaves it so);
  * the cosine and sine of the float32 direction, in float32;
  * endpoints (fc -+ hx cos, fr -+ hy sin) in float64, rounded half away
    from zero;
  * the walk, one step at a time from (ix0, iy0) with err = ddx - ddy:
    e2 = 2 err, a step in x where e2 > -ddy, in y where e2 < ddx; it stops
    on reaching (ix1, iy1) or after 2 (ddx + ddy) + 2 steps;
  * a cell outside the grid or outside the point's home tile (the tile of
    its clamped cell) gets nothing, and a point outside the grid draws
    nothing;
  * Average and WeightedAverage (the same for a glyph) = sum / count, NaN
    where the count is 0.

Departures from the oracle: it adds in float64 where the oracle adds in
float32, and it takes one step of every point's walk at a time in torch
where the oracle does so in numpy. It walks the cells one by one and never
cuts a line into runs (the port's device path folds the closed-form
staircase, routing.line_rects), so a comparison with it checks the port's
runs too. It imports nothing of the port and takes only the generated
points.

`work`: every kept (point, cell) pair costs 2 float32 operations (the
value's add and the count's); each point's value is read once (4 B; its
cell is `job_work`'s); each of the 2 state planes of each cell a call
touches is read and written once per `ingest` call. Recounted from the
points, never from the port's layout.

`spec` refuses per-point channels (a direction or half-length channel:
the harness's clouds carry only the value channel) and types other than
Average and WeightedAverage.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import refuse_unknown

OPS_PER_CELL = 2
KEYS = ("glyph", "type", "value_channel", "direction", "half_length",
        "max_radius_cells")
TYPES = ("Average", "WeightedAverage")


def spec(pcr, red: dict):
    """The port's ReductionSpec: `line_splat_spec` with the direction, the
    half length and the cap of `red`, and its type."""
    refuse_unknown("line", red, KEYS, TYPES)
    s = pcr.line_splat_spec(
        red["value_channel"], default_direction=red["direction"],
        default_half_length=red["half_length"],
        max_radius_cells=red["max_radius_cells"])
    s.type = getattr(pcr.ReductionType, red["type"])
    return s


def _round_half_away(a: np.ndarray) -> np.ndarray:
    return np.where(a >= 0.0, np.floor(a + 0.5), np.ceil(a - 0.5))


def endpoints(points, grid, red, sel=slice(None)):
    """(ix0, iy0, ix1, iy1) int64 cells of each point's stroke."""
    refuse_unknown("line", red, KEYS, TYPES)
    f32 = np.float32
    cap = f32(red["max_radius_cells"])
    hl = f32(red["half_length"])
    hx = np.minimum(hl * f32(1.0 / grid.cell), cap)
    hy = np.minimum(hl * f32(1.0 / -grid.cell), cap)
    d = f32(red["direction"])
    cos, sin = float(np.cos(d)), float(np.sin(d))    # float32 numbers
    fc, fr = grid.fractional(points.x[sel], points.y[sel])
    ex, ey = float(hx) * cos, float(hy) * sin
    return tuple(_round_half_away(e).astype(np.int64)
                 for e in (fc - ex, fr - ey, fc + ex, fr + ey))


def _walk(points, grid, red, device, sel=slice(None)):
    """Yield (flat cell, value) of the kept (point, cell) pairs, one step
    of every point's walk at a time."""
    x, y = points.x[sel], points.y[sel]
    col, row, valid = grid.assign(x, y)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    c0, r0, c1, r1 = (t(a) for a in grid.home_tile(col, row))
    ix0, iy0, ix1, iy1 = (t(a) for a in endpoints(points, grid, red, sel))
    v = t(points.value[sel])
    ddx, ddy = (ix1 - ix0).abs(), (iy1 - iy0).abs()
    sx = torch.where(ix0 < ix1, 1, -1)
    sy = torch.where(iy0 < iy1, 1, -1)
    last = 2 * (ddx + ddy) + 2
    err = ddx - ddy
    cx, cy = ix0.clone(), iy0.clone()
    active = t(valid)
    step = 0
    while bool(active.any()):
        active &= step <= last
        keep = active & (cx >= c0) & (cx < c1) & (cy >= r0) & (cy < r1)
        k = keep.nonzero().squeeze(1)
        yield cy[k] * grid.width + cx[k], v[k]
        active &= (cx != ix1) | (cy != iy1)
        e2 = 2 * err
        step_x = active & (e2 > -ddy)
        step_y = active & (e2 < ddx)
        err = err - torch.where(step_x, ddy, 0) + torch.where(step_y, ddx, 0)
        cx += torch.where(step_x, sx, 0)
        cy += torch.where(step_y, sy, 0)
        step += 1


def reference(points, grid, red, device, control=False) -> torch.Tensor:
    """(H, W) raster on `device`: float64, or with `control` each value
    rounded to bfloat16 and summed in float32 (the step below the
    configuration's float32 that a later change might take)."""
    H, W = grid.height, grid.width
    dt = torch.float32 if control else torch.float64
    s = torch.zeros(H * W, dtype=dt, device=device)
    c = torch.zeros(H * W, dtype=dt, device=device)
    for flat, v in _walk(points, grid, red, device):
        v = (v.to(torch.bfloat16) if control else v).to(dt)
        s.index_add_(0, flat, v)
        c.index_add_(0, flat, torch.ones_like(v))
    nan = torch.tensor(float("nan"), dtype=dt, device=device)
    return torch.where(c > 0, s / torch.where(c > 0, c, 1.0), nan).view(H, W)


def work(points, grid, red, calls, device="cpu") -> dict:
    """{"bytes", "flops"} of the reduction in one job whose `ingest` calls
    take the point ranges `calls` [(start, end)]. Says on stderr how many
    cells a point the strokes keep, to set beside the row hits the port's
    walk takes (rect_hits_per_entry)."""
    nbytes = pairs = live = 0
    for a, b in calls:
        hit = torch.zeros(grid.width * grid.height, dtype=torch.bool,
                          device=device)
        for flat, _ in _walk(points, grid, red, device, slice(a, b)):
            pairs += len(flat)
            hit[flat] = True
        _, _, valid = grid.assign(points.x[a:b], points.y[a:b])
        nbytes += int(valid.sum()) * 4 + int(hit.sum()) * 2 * 8
        live += int(valid.sum())
    print(f"cardbench: line: {pairs} kept (point, cell) pairs, "
          f"{pairs / max(live, 1):.2f} a point", file=sys.stderr, flush=True)
    return {"bytes": nbytes, "flops": pairs * OPS_PER_CELL}

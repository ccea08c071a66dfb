"""
Rotated Gaussian glyph: each point adds `w * value` and `w` into every cell
of its window, w = exp(-(rx'^2 / 2 sx^2 + ry'^2 / 2 sy^2)) of the cell's
offset (rx, ry) from the point turned by the glyph's one rotation.

`reference` is the plain float64 raster, a frozen copy of the semantics of
the port's numpy oracle (pcr_tpu_torch/engine/cpu_backend.py
`accumulate_gaussian_cpu`, routing.gaussian_params, ops/reduction.py
`gauss_state_flush` and the Average finalize), which copies the
upstream's glyph_kernels.cu:79-183:

  * signed cell-unit sigmas (sy < 0 on a north-up grid, so sx sets r);
    r = ceil(min(3 max(sx, sy), max_radius_cells));
  * the window is |dx|, |dy| <= r cells around the point's cell (floor of
    its fractional cell), rdx = dx - sub-cell column, rdy = dy - sub-cell
    row;
  * with cos and sin of -rotation, rdx' = rdx cos - rdy sin and
    rdy' = rdx sin + rdy cos; w = exp(-0.5 ((rdx' / sx)^2 + (rdy' / sy)^2));
  * a cell outside the grid or outside the point's home tile (the tile of
    its clamped cell) gets nothing, nor one whose weight falls under the
    product cutoff 1e-6;
  * a weight sum under GAUSS_WMIN = 5e-7 is a residue and zeroed, then
    Average (and WeightedAverage, the same for a glyph) = sum / weight,
    NaN where the weight is 0.

Departures from the oracle: it takes the sub-cell offsets, the cosine and
sine, the turned offsets and the weight in float32; this takes all of
them in float64. The glyph's parameters are the spec's float32 numbers
(sigma_x, sigma_y, the rotation and the radius cap rounded to float32, as
the spec holds them), and everything computed from them is float64. It
imports nothing of the port and takes only the generated points.

`work`: every (point, cell) pair the window, the clips and the cutoff keep
costs 9 float32 operations (the kernel table's count for the rotated
splats, against the separable glyph's 5); each point's value is read once
(4 B; its cell is `job_work`'s); each of the 2 state planes of each cell a
call touches is read and written once per `ingest` call. Recounted from
the points, never from the port's layout.

`spec` refuses a footprint that would not be rotated (a rotation of 0, or
|sigma_x| = |sigma_y|, which the port rightly routes to the separable
splat): those are gaussian.py's. The harness's cells are square, so the
test in world units is the port's in cell units.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from . import refuse_unknown
from .gaussian import GAUSS_WMIN, TYPES, WMIN

OPS_PER_CELL = 9
# one rotation and one pair of sigmas for every point: no per-point
# channels (the harness's clouds carry only the value channel)
KEYS = ("glyph", "type", "value_channel", "sigma_x", "sigma_y", "rotation",
        "max_radius_cells")


def _refuse(red: dict) -> None:
    refuse_unknown("gaussian_rot", red, KEYS, TYPES)
    f32 = np.float32
    if f32(red["rotation"]) == 0 or (abs(f32(red["sigma_x"]))
                                     == abs(f32(red["sigma_y"]))):
        raise ValueError("gaussian_rot glyph: the footprint is not rotated "
                         "(rotation 0 or |sigma_x| = |sigma_y|); that is "
                         "the gaussian glyph")


def spec(pcr, red: dict):
    """The port's ReductionSpec: `gaussian_splat_spec` with the sigmas, the
    rotation and the radius cap of `red`, and its type."""
    _refuse(red)
    s = pcr.gaussian_splat_spec(
        red["value_channel"], default_sigma_x=red["sigma_x"],
        default_sigma_y=red["sigma_y"], default_rotation=red["rotation"],
        max_radius_cells=red["max_radius_cells"])
    s.type = getattr(pcr.ReductionType, red["type"])
    return s


def _params(grid, red):
    """(sx, sy, cos, sin, r): the signed cell-unit sigmas, the cosine and
    sine of -rotation, float64 of the spec's float32 numbers, and r."""
    _refuse(red)
    f32 = np.float32
    sx = f32(red["sigma_x"]) * f32(1.0 / grid.cell)
    sy = f32(red["sigma_y"]) * f32(1.0 / -grid.cell)
    R = min(f32(3.0) * max(sx, sy), f32(red["max_radius_cells"]))
    rot = -float(f32(red["rotation"]))
    return float(sx), float(sy), math.cos(rot), math.sin(rot), \
        int(math.ceil(R))


def _terms(points, grid, red, device, sel=slice(None)):
    """Yield (flat cell, weight, value) of the kept (point, cell) pairs,
    one window offset at a time. Pairs not kept are left out, not sent to
    a spare cell: most of a thin ellipse's window falls under the cutoff,
    and the card's atomic adds into one cell would queue behind each
    other."""
    sx, sy, cos, sin, r = _params(grid, red)
    x, y = points.x[sel], points.y[sel]
    col, row, valid = grid.assign(x, y)
    fc, fr = grid.fractional(x, y)
    c0, r0, c1, r1 = grid.home_tile(col, row)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    keep = t(valid)
    ic, ir = np.floor(fc), np.floor(fr)
    sub_c, sub_r = t(fc - ic), t(fr - ir)
    ic, ir = t(ic.astype(np.int64)), t(ir.astype(np.int64))
    c0, r0, c1, r1 = t(c0), t(r0), t(c1), t(r1)
    v = t(points.value[sel])
    for dy in range(-r, r + 1):
        gy = ir + dy
        in_y = keep & (gy >= r0) & (gy < r1)
        rdy = dy - sub_r
        for dx in range(-r, r + 1):
            gx = ic + dx
            act = in_y & (gx >= c0) & (gx < c1)
            rdx = dx - sub_c
            qx = (rdx * cos - rdy * sin) / sx
            qy = (rdx * sin + rdy * cos) / sy
            w = torch.exp(-0.5 * (qx * qx + qy * qy))
            act &= w >= WMIN
            k = act.nonzero().squeeze(1)
            yield gy[k] * grid.width + gx[k], w[k], v[k]


def reference(points, grid, red, device, control=False) -> torch.Tensor:
    """(H, W) raster on `device`: float64, or with `control` each term's
    value and weight rounded to bfloat16 and summed in float32 (the step
    below the configuration's float32 that a later change might take)."""
    H, W = grid.height, grid.width
    dt = torch.float32 if control else torch.float64
    s = torch.zeros(H * W, dtype=dt, device=device)
    c = torch.zeros(H * W, dtype=dt, device=device)
    for flat, w, v in _terms(points, grid, red, device):
        if control:
            w = w.to(torch.bfloat16).to(dt)
            v = v.to(torch.bfloat16).to(dt)
        else:
            v = v.to(dt)
        s.index_add_(0, flat, v * w)
        c.index_add_(0, flat, w)
    keep = c >= GAUSS_WMIN
    s = torch.where(keep, s, 0.0)
    c = torch.where(keep, c, 0.0)
    nan = torch.tensor(float("nan"), dtype=dt, device=device)
    return torch.where(c > 0, s / torch.where(c > 0, c, 1.0), nan).view(H, W)


def work(points, grid, red, calls, device="cpu") -> dict:
    """{"bytes", "flops"} of the reduction in one job whose `ingest` calls
    take the point ranges `calls` [(start, end)]. Says on stderr how many
    (point, cell) pairs a point the ellipse keeps, to set beside the dense
    window the port walks (rot_cells_per_entry)."""
    nbytes = pairs = live = 0
    for a, b in calls:
        hit = torch.zeros(grid.width * grid.height, dtype=torch.bool,
                          device=device)
        for flat, _, _ in _terms(points, grid, red, device, slice(a, b)):
            pairs += len(flat)
            hit[flat] = True
        _, _, valid = grid.assign(points.x[a:b], points.y[a:b])
        nbytes += int(valid.sum()) * 4 + int(hit.sum()) * 2 * 8
        live += int(valid.sum())
    print(f"cardbench: gaussian_rot: {pairs} kept (point, cell) pairs, "
          f"{pairs / max(live, 1):.2f} a point", file=sys.stderr, flush=True)
    return {"bytes": nbytes, "flops": pairs * OPS_PER_CELL}

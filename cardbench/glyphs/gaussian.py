"""
Gaussian glyph: each point adds `w * value` and `w` into every cell of its
window, w = exp(-(rx^2 / 2 sx^2 + ry^2 / 2 sy^2)).

`reference` is the plain float64 raster, a frozen copy of the semantics of
the port's numpy oracle (pcr_tpu_torch/engine/cpu_backend.py
`accumulate_gaussian_cpu`, routing.gaussian_params, ops/reduction.py
`gauss_state_flush` and the Average finalize), which copies the
upstream's glyph_kernels.cu:79-183:

  * the window is +-r cells around the point's cell (floor of its
    fractional cell), r = ceil(min(3 max(sx, sy), max_radius_cells)) with
    the signed cell-unit sigmas (sy < 0 on a north-up grid, so sx sets r);
  * offsets are measured from the point (no rotation: the oracle's
    rotated form is the identity at rotation 0);
  * a cell outside the grid or outside the point's home tile (the tile of
    its clamped cell) gets nothing, nor one whose weight falls under the
    product cutoff 1e-6;
  * a weight sum under GAUSS_WMIN = 5e-7 is a residue and zeroed, then
    Average (and WeightedAverage, the same for a glyph) = sum / weight,
    NaN where the weight is 0.

The oracle takes the sub-cell offset and the weight in float32; this takes
both in float64. It imports nothing of the port and takes only the
generated points.

`work`: every (point, cell) pair the window, the clips and the cutoff keep
costs 5 float32 operations; each point's value is read once (4 B; its
cell is `job_work`'s); each of the 2 state planes of each cell a call touches is read
and written once per `ingest` call. Recounted from the points, never from
the port's layout, so it reads the same work whatever lays it out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import refuse_unknown

WMIN = 1e-6          # the product cutoff
GAUSS_WMIN = 5e-7    # a weight sum under it is a residue
OPS_PER_CELL = 5
# no rotation and no per-point sigma channels: the reference holds
# axis-aligned blobs of one sigma (a rotated glyph is a module of its own)
KEYS = ("glyph", "type", "value_channel", "sigma_x", "sigma_y",
        "max_radius_cells")
TYPES = ("Average", "WeightedAverage")


def spec(pcr, red: dict):
    """The port's ReductionSpec: `gaussian_splat_spec` with the sigmas and
    the radius cap of `red`, and its type."""
    refuse_unknown("gaussian", red, KEYS, TYPES)
    s = pcr.gaussian_splat_spec(
        red["value_channel"], default_sigma_x=red["sigma_x"],
        default_sigma_y=red["sigma_y"],
        max_radius_cells=red["max_radius_cells"])
    s.type = getattr(pcr.ReductionType, red["type"])
    return s


def _params(grid, red):
    refuse_unknown("gaussian", red, KEYS, TYPES)
    f32 = np.float32
    sx = f32(red["sigma_x"]) * f32(1.0 / grid.cell)
    sy = f32(red["sigma_y"]) * f32(1.0 / -grid.cell)
    R = min(f32(3.0) * max(sx, sy), f32(red["max_radius_cells"]))
    return float(sx), float(sy), int(math.ceil(R))


def _terms(points, grid, red, device, sel=slice(None)):
    """Yield (flat cell, weight, value) of the kept (point, cell) pairs,
    one window offset at a time; pairs not kept carry the cell H * W."""
    sx, sy, r = _params(grid, red)
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
    dump = grid.width * grid.height
    for dy in range(-r, r + 1):
        gy = ir + dy
        in_y = keep & (gy >= r0) & (gy < r1)
        rdy = dy - sub_r
        for dx in range(-r, r + 1):
            gx = ic + dx
            act = in_y & (gx >= c0) & (gx < c1)
            qx = (dx - sub_c) / sx
            qy = rdy / sy
            w = torch.exp(-0.5 * (qx * qx + qy * qy))
            act &= w >= WMIN
            yield torch.where(act, gy * grid.width + gx, dump), w, v


def reference(points, grid, red, device, control=False) -> torch.Tensor:
    """(H, W) raster on `device`: float64, or with `control` each term's
    value and weight rounded to bfloat16 and summed in float32 (the step
    below the configuration's float32 that a later change might take)."""
    H, W = grid.height, grid.width
    dt = torch.float32 if control else torch.float64
    s = torch.zeros(H * W + 1, dtype=dt, device=device)
    c = torch.zeros(H * W + 1, dtype=dt, device=device)
    for flat, w, v in _terms(points, grid, red, device):
        if control:
            w = w.to(torch.bfloat16).to(dt)
            v = v.to(torch.bfloat16).to(dt)
        else:
            v = v.to(dt)
        s.index_add_(0, flat, v * w)
        c.index_add_(0, flat, w)
    s, c = s[:-1], c[:-1]
    keep = c >= GAUSS_WMIN
    s = torch.where(keep, s, 0.0)
    c = torch.where(keep, c, 0.0)
    nan = torch.tensor(float("nan"), dtype=dt, device=device)
    return torch.where(c > 0, s / torch.where(c > 0, c, 1.0), nan).view(H, W)


def work(points, grid, red, calls, device="cpu") -> dict:
    """{"bytes", "flops"} of the reduction in one job whose `ingest` calls
    take the point ranges `calls` [(start, end)]."""
    dump = grid.width * grid.height
    nbytes = flops = 0
    for a, b in calls:
        hit = torch.zeros(dump + 1, dtype=torch.bool, device=device)
        pairs = 0
        for flat, _, _ in _terms(points, grid, red, device, slice(a, b)):
            pairs += int((flat != dump).sum())
            hit[flat] = True
        _, _, valid = grid.assign(points.x[a:b], points.y[a:b])
        nbytes += (int(valid.sum()) * 4
                   + int(hit[:dump].sum()) * 2 * 8)
        flops += pairs * OPS_PER_CELL
    return {"bytes": nbytes, "flops": flops}

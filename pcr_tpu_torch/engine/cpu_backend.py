"""
CPU backend — the vectorized numpy reference path (ExecutionMode.CPU).

The port's copy of pcr_tpu/engine/cpu_backend.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

This is the parity oracle for the TPU path and a faithful re-implementation
of the reference's CPU semantics:

  * Point glyph accumulate: registry unpack-combine-pack loop
    (reference: src/ops/reduction_registry.cpp:50-110) → np.add.at /
    np.maximum.at / np.minimum.at scatter.
  * Gaussian glyph: per-offset vectorized loop matching
    glyph_kernels.cu:79-183 cell-exactly (corner-sampled offsets, rotation
    by -rot, signed cell-unit sigmas, 1e-6 product-weight cutoff, per-point
    radius bound r_p).
  * Line glyph: vectorized Bresenham walk matching glyph_kernels.cu:188-281
    (round-half-away-from-zero endpoints, capped signed half-lengths,
    step cap 2*(ddx+ddy)+2).
  * Glyph footprints are clipped to the point's home tile (the tile of its
    clamped assigned center cell), matching the reference's per-tile batch
    routing. With the default 4096x4096 tiles, grids up to 4096 cells per
    side are a single tile and no clipping occurs.

Per-point preparation (assign / glyph params) is shared with the TPU engine
via engine/routing.py so both paths agree bit-for-bit on cell selection.
All accumulation happens into full-grid (H, W) float32 state fields; the
tiling/out-of-core layer above decides which region of state is resident.
"""

from __future__ import annotations

import numpy as np

from ..core.grid_config import GridConfig
from ..core.types import ReductionType, Status, StatusCode
from ..ops.reduction import ReductionInfo
from .glyph import GLYPH_SUPPORTED_REDUCTIONS, GlyphSpec
from . import routing

__all__ = [
    "accumulate_point_cpu", "accumulate_gaussian_cpu", "accumulate_line_cpu",
    "glyph_rtype_int", "check_glyph_reduction",
]


# ---------------------------------------------------------------------------
# Point glyph
# ---------------------------------------------------------------------------

def accumulate_point_cpu(
    info: ReductionInfo,
    state: list[np.ndarray],           # K arrays of shape (H, W), float32
    flat_cells: np.ndarray,            # int64 flat cell index per point
    values: np.ndarray,                # float32
    weights: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
) -> Status:
    """Scatter-accumulate one batch of points into full-grid state."""
    if len(flat_cells) == 0:
        return Status.success()
    fields = info.fields(values, weights, timestamps)
    kind = info.scatter_kind
    if kind == "sum":
        for f, fv in enumerate(fields):
            np.add.at(state[f].ravel(), flat_cells, fv.astype(np.float32))
    elif kind == "max":
        np.maximum.at(state[0].ravel(), flat_cells, fields[0].astype(np.float32))
    elif kind == "min":
        np.minimum.at(state[0].ravel(), flat_cells, fields[0].astype(np.float32))
    elif kind == "argmax_ts":
        _scatter_argmax_ts(state, flat_cells, fields[0], fields[1])
    else:
        return Status.error(StatusCode.NotImplemented,
                            f"scatter kind {kind!r}")
    return Status.success()


def _scatter_argmax_ts(state, flat_cells, values, ts):
    """MostRecent: per cell keep the value with the highest timestamp.

    Reference semantics (builtin_ops.h:114-116): strictly greater timestamp
    replaces, so among equal timestamps the earliest-processed point wins.
    Deterministic here by construction: sort (cell asc, ts asc, index desc)
    and take the last entry per cell, then apply the existing-state rule.
    """
    n = len(flat_cells)
    idx = np.arange(n)
    order = np.lexsort((-idx, ts, flat_cells))
    cells_sorted = flat_cells[order]
    last = np.ones(n, dtype=bool)
    last[:-1] = cells_sorted[:-1] != cells_sorted[1:]
    sel = order[last]
    c = flat_cells[sel]
    v = values[sel].astype(np.float32)
    t = ts[sel].astype(np.float32)
    cur_v = state[0].ravel()
    cur_t = state[1].ravel()
    replace = t > cur_t[c]
    upd = c[replace]
    cur_v[upd] = v[replace]
    cur_t[upd] = t[replace]


# ---------------------------------------------------------------------------
# Glyph state update rules (glyph_kernels.cu:9-16)
# ---------------------------------------------------------------------------

def _glyph_update(state, kind_int, flat, val, w):
    """kind_int: 0 = WeightedAverage/Average, 1 = Sum, 2 = Count."""
    if kind_int == 0:
        np.add.at(state[0].ravel(), flat, (val * w).astype(np.float32))
        np.add.at(state[1].ravel(), flat, w.astype(np.float32))
    elif kind_int == 1:
        np.add.at(state[0].ravel(), flat, (val * w).astype(np.float32))
    else:
        np.add.at(state[0].ravel(), flat, w.astype(np.float32))


def glyph_rtype_int(rtype: ReductionType) -> int:
    if rtype in (ReductionType.WeightedAverage, ReductionType.Average):
        return 0
    if rtype == ReductionType.Sum:
        return 1
    return 2  # Count


def check_glyph_reduction(rtype: ReductionType) -> Status:
    if ReductionType(rtype) not in GLYPH_SUPPORTED_REDUCTIONS:
        return Status.error(
            StatusCode.NotImplemented,
            "glyph splatting only supports WeightedAverage, Average, Sum, "
            "or Count reduction types")
    return Status.success()


# ---------------------------------------------------------------------------
# Gaussian glyph (reference: glyph_kernels.cu:79-183)
# ---------------------------------------------------------------------------

def accumulate_gaussian_cpu(
    spec: GlyphSpec,
    rtype: ReductionType,
    cfg: GridConfig,
    state: list[np.ndarray],
    x: np.ndarray, y: np.ndarray,       # world coords (float64), valid points
    values: np.ndarray,                 # float32
    sigma_x: np.ndarray | None,        # per-point channels (float32) or None
    sigma_y: np.ndarray | None,
    rotation: np.ndarray | None,
    col: np.ndarray, row: np.ndarray,  # clamped assigned cells (routing)
    region=None,                       # (cs, rs, cols, rows): write into a
                                       # tile-local state block (out-of-core)
) -> Status:
    st = check_glyph_reduction(rtype)
    if not st.ok():
        return st
    n = len(x)
    if n == 0:
        return Status.success()
    kind_int = glyph_rtype_int(rtype)

    gp = routing.gaussian_params(spec, cfg, x, y, sigma_x, sigma_y, rotation)
    icx = gp.icx.astype(np.int64)
    icy = gp.icy.astype(np.int64)
    rmax = int(gp.r.max()) if n else 0
    r_p = gp.r.astype(np.int64)

    col_s, row_s, col_e, row_e = routing.home_tile_ranges(cfg, col, row)
    if region is not None:
        off_c, off_r, W = region[0], region[1], region[2]
    else:
        off_c = off_r = 0
        W = cfg.width
    vals32 = values.astype(np.float32)

    for dy in range(-rmax, rmax + 1):
        gy = icy + dy
        in_y = (gy >= row_s) & (gy < row_e) & (np.abs(dy) <= r_p)
        if not in_y.any():
            continue
        rdy = np.float32(dy) - gp.sub_cy
        for dx in range(-rmax, rmax + 1):
            gx = icx + dx
            act = in_y & (gx >= col_s) & (gx < col_e) & (np.abs(dx) <= r_p)
            if not act.any():
                continue
            rdx = np.float32(dx) - gp.sub_cx
            rdx_rot = rdx * gp.cos_rot - rdy * gp.sin_rot
            rdy_rot = rdx * gp.sin_rot + rdy * gp.cos_rot
            qx = rdx_rot / gp.sx
            qy = rdy_rot / gp.sy
            w = np.exp(np.float32(-0.5) * (qx * qx + qy * qy))
            act = act & (w >= np.float32(1e-6))
            if not act.any():
                continue
            flat = (gy[act] - off_r) * W + (gx[act] - off_c)
            _glyph_update(state, kind_int, flat, vals32[act], w[act])

    return Status.success()


# ---------------------------------------------------------------------------
# Line glyph (reference: glyph_kernels.cu:188-281)
# ---------------------------------------------------------------------------

def accumulate_line_cpu(
    spec: GlyphSpec,
    rtype: ReductionType,
    cfg: GridConfig,
    state: list[np.ndarray],
    x: np.ndarray, y: np.ndarray,
    values: np.ndarray,
    direction: np.ndarray | None,
    half_length: np.ndarray | None,
    col: np.ndarray, row: np.ndarray,
    region=None,                       # (cs, rs, cols, rows) tile-local block
) -> Status:
    st = check_glyph_reduction(rtype)
    if not st.ok():
        return st
    n = len(x)
    if n == 0:
        return Status.success()
    kind_int = glyph_rtype_int(rtype)

    lp = routing.line_params(spec, cfg, x, y, direction, half_length)
    ix0 = lp.ix0.astype(np.int64)
    iy0 = lp.iy0.astype(np.int64)
    ix1 = lp.ix1.astype(np.int64)
    iy1 = lp.iy1.astype(np.int64)

    ddx = np.abs(ix1 - ix0)
    ddy = np.abs(iy1 - iy0)
    sx_step = np.where(ix0 < ix1, 1, -1).astype(np.int64)
    sy_step = np.where(iy0 < iy1, 1, -1).astype(np.int64)
    err = (ddx - ddy).astype(np.int64)
    cx = ix0.copy()
    cy = iy0.copy()
    max_steps = 2 * (ddx + ddy) + 2
    global_max = lp.max_steps

    col_s, row_s, col_e, row_e = routing.home_tile_ranges(cfg, col, row)
    if region is not None:
        off_c, off_r, W = region[0], region[1], region[2]
    else:
        off_c = off_r = 0
        W = cfg.width
    vals32 = values.astype(np.float32)
    ones = np.ones(n, dtype=np.float32)

    done = np.zeros(n, dtype=bool)
    for step in range(global_max + 1):
        active = ~done & (step <= max_steps)
        if not active.any():
            break
        hit = (active & (cx >= col_s) & (cx < col_e)
               & (cy >= row_s) & (cy < row_e))
        if hit.any():
            flat = (cy[hit] - off_r) * W + (cx[hit] - off_c)
            _glyph_update(state, kind_int, flat, vals32[hit], ones[hit])
        at_end = active & (cx == ix1) & (cy == iy1)
        done |= at_end
        adv = active & ~at_end
        e2 = 2 * err
        step_x = adv & (e2 > -ddy)
        step_y = adv & (e2 < ddx)
        err = err - np.where(step_x, ddy, 0) + np.where(step_y, ddx, 0)
        cx = cx + np.where(step_x, sx_step, 0)
        cy = cy + np.where(step_y, sy_step, 0)

    return Status.success()

"""
Routing — host-side per-point preparation shared by the CPU oracle and the
TPU engine.

The port's copy of pcr_tpu/engine/routing.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

The reference's TileRouter (tile_router.cpp:89-122 assign, :138-240 sort,
:253-366 extract_batches) routes points to tiles and sorts them so atomics
contend less. On TPU, scatter is contention-free, so routing reduces to the
light per-point math — done here on the host in float64 (geo precision) with
float32 derived quantities exactly where the reference uses float:

  * assign: world→cell floor+clamp+valid (grid_config.cpp:24-43)
  * Gaussian params: fractional cell, sub-cell offset, signed cell-unit
    sigmas, rotation trig, radius (glyph_kernels.cu:119-143)
  * Line endpoints: capped signed half-lengths, round-half-away endpoints
    (glyph_kernels.cu:219-250)
  * home-tile clip ranges (the reference clips glyph footprints to the
    point's home tile via per-tile batches)

The TPU device then only ever sees int32 cells and float32 payloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.grid_config import GridConfig
from .glyph import GlyphSpec

__all__ = ["assign", "gaussian_params", "line_params", "home_tile_ranges",
           "glyph_channel"]


def home_tile_ranges(cfg: GridConfig, col: np.ndarray, row: np.ndarray):
    """Per-point home-tile cell ranges (edge-clamped); end-exclusive.

    `cfg` may be a row-offset shard view (parallel.engine._LocalCfg):
    tile rows are computed in the GLOBAL frame and returned in the
    view's local rows (possibly outside [0, cfg.height) — callers clip
    against the local grid, so out-of-shard tiles become empty)."""
    off = getattr(cfg, "row_offset", 0)
    Hg = getattr(cfg, "global_height", cfg.height)
    tcol = col // cfg.tile_width
    trow = (row + off) // cfg.tile_height
    col_start = (tcol * cfg.tile_width).astype(np.int32)
    row_start = (trow * cfg.tile_height - off).astype(np.int32)
    col_end = np.minimum(col_start + cfg.tile_width, cfg.width).astype(np.int32)
    row_end = (np.minimum(trow * cfg.tile_height + cfg.tile_height, Hg)
               - off).astype(np.int32)
    return col_start, row_start, col_end, row_end


def assign(cfg: GridConfig, x: np.ndarray, y: np.ndarray):
    """world→cell assignment. Returns (col, row, valid).

    Uses the native fused OpenMP kernel when available (one memory pass
    instead of ~10 numpy passes; bit-identical semantics), else the numpy
    path."""
    from .. import native
    if native.available() and len(x) >= 65536:
        return native.assign(cfg, np.asarray(x, np.float64),
                             np.asarray(y, np.float64))
    return cfg.world_to_cell_array(x, y)


def glyph_channel(cloud, name: str):
    """Fetch a per-point glyph channel as float32, or None if unset/absent
    (reference: pipeline.cpp glyph channel copies — missing channels fall
    back to GlyphSpec defaults)."""
    if not name or not cloud.has_channel(name):
        return None
    return cloud.channel_array_f32(name)


@dataclass
class GaussianParams:
    icx: np.ndarray        # int32 center cell (unclamped floor of fcx)
    icy: np.ndarray
    sub_cx: np.ndarray     # float32 sub-cell offsets
    sub_cy: np.ndarray
    sx: np.ndarray         # float32 signed cell-unit sigma (sy < 0 north-up)
    sy: np.ndarray
    cos_rot: np.ndarray    # float32 cos(-rot), sin(-rot)
    sin_rot: np.ndarray
    r: np.ndarray          # int32 per-point radius
    rotated: bool          # any nonzero rotation in this batch


def gaussian_params(spec: GlyphSpec, cfg: GridConfig,
                    x: np.ndarray, y: np.ndarray,
                    sigma_x: np.ndarray | None,
                    sigma_y: np.ndarray | None,
                    rotation: np.ndarray | None) -> GaussianParams:
    n = len(x)
    inv_csx = 1.0 / cfg.cell_size_x
    inv_csy = 1.0 / cfg.cell_size_y
    fcx, fcy = cfg.fractional_cell_array(x, y)
    icx = np.floor(fcx)
    icy = np.floor(fcy)
    sub_cx = (fcx - icx).astype(np.float32)
    sub_cy = (fcy - icy).astype(np.float32)

    if sigma_x is not None:
        sxw = np.where(sigma_x > 0.0, sigma_x,
                       np.float32(spec.default_sigma_x)).astype(np.float32)
    else:
        sxw = np.full(n, spec.default_sigma_x, dtype=np.float32)
    if sigma_y is not None:
        syw = np.where(sigma_y > 0.0, sigma_y,
                       np.float32(spec.default_sigma_y)).astype(np.float32)
    else:
        syw = np.full(n, spec.default_sigma_y, dtype=np.float32)

    # Signed cell-unit sigmas. Reference-parity quirk: sy = sigma_y *
    # inv_cell_size_y is negative for north-up grids, so the radius
    # R = 3 * max(sx, sy) is driven by sx (glyph_kernels.cu:126-134).
    sx = sxw * np.float32(inv_csx)
    sy = syw * np.float32(inv_csy)

    rot = (np.asarray(rotation, dtype=np.float32) if rotation is not None
           else np.full(n, spec.default_rotation, dtype=np.float32))
    cos_rot = np.cos(-rot).astype(np.float32)
    sin_rot = np.sin(-rot).astype(np.float32)

    R = np.minimum(np.float32(3.0) * np.maximum(sx, sy),
                   np.float32(spec.max_radius_cells)).astype(np.float32)
    r = np.ceil(R).astype(np.int32)

    # Rotation is a geometric no-op for cell-isotropic footprints (the
    # rotated quadratic form collapses to (rdx^2 + rdy^2)/sigma^2), so only
    # batches with anisotropic rotated points need the dense rotated path.
    # Isotropy is judged in cell units — the rotation acts on cell offsets.
    rotated = bool(np.any((rot != 0.0) & (np.abs(sx) != np.abs(sy))))
    return GaussianParams(
        icx=icx.astype(np.int32), icy=icy.astype(np.int32),
        sub_cx=sub_cx, sub_cy=sub_cy, sx=sx, sy=sy,
        cos_rot=cos_rot, sin_rot=sin_rot, r=r, rotated=rotated)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C++ std::round semantics (round half away from zero)."""
    return np.where(x >= 0.0, np.floor(x + 0.5), np.ceil(x - 0.5))


@dataclass
class LineParams:
    ix0: np.ndarray
    iy0: np.ndarray
    ix1: np.ndarray
    iy1: np.ndarray
    max_steps: int          # global bound: max over points of 2(ddx+ddy)+2
    k_cells: int = 0        # exact iteration count: max(ddx, ddy) + 1
    # (the dual-step Bresenham advances the major axis every iteration, so
    # every line reaches its endpoint in exactly max(ddx, ddy) steps; the
    # 2(ddx+ddy)+2 bound is the reference's loop guard, not the path length)


def line_params(spec: GlyphSpec, cfg: GridConfig,
                x: np.ndarray, y: np.ndarray,
                direction: np.ndarray | None,
                half_length: np.ndarray | None) -> LineParams:
    n = len(x)
    inv_csx = 1.0 / cfg.cell_size_x
    inv_csy = 1.0 / cfg.cell_size_y
    fcx, fcy = cfg.fractional_cell_array(x, y)
    dirs = (np.asarray(direction, dtype=np.float32) if direction is not None
            else np.full(n, spec.default_direction, dtype=np.float32))
    hl = (np.asarray(half_length, dtype=np.float32) if half_length is not None
          else np.full(n, spec.default_half_length, dtype=np.float32))
    cap = np.float32(spec.max_radius_cells)
    # Signed cell-unit half lengths; hy < 0 for north-up grids and
    # min(negative, cap) keeps it negative (glyph_kernels.cu:229-236).
    hx = np.minimum(hl * np.float32(inv_csx), cap)
    hy = np.minimum(hl * np.float32(inv_csy), cap)
    cos_d = np.cos(dirs).astype(np.float32)
    sin_d = np.sin(dirs).astype(np.float32)
    # CPU reference keeps fcx/fcy double through the endpoint math
    x0 = fcx - hx.astype(np.float64) * cos_d.astype(np.float64)
    y0 = fcy - hy.astype(np.float64) * sin_d.astype(np.float64)
    x1 = fcx + hx.astype(np.float64) * cos_d.astype(np.float64)
    y1 = fcy + hy.astype(np.float64) * sin_d.astype(np.float64)
    ix0 = _round_half_away(x0).astype(np.int64)
    iy0 = _round_half_away(y0).astype(np.int64)
    ix1 = _round_half_away(x1).astype(np.int64)
    iy1 = _round_half_away(y1).astype(np.int64)
    ddx = np.abs(ix1 - ix0)
    ddy = np.abs(iy1 - iy0)
    max_steps = int((2 * (ddx + ddy) + 2).max()) if n else 0
    k_cells = int(np.maximum(ddx, ddy).max()) + 1 if n else 0
    return LineParams(ix0=ix0.astype(np.int32), iy0=iy0.astype(np.int32),
                      ix1=ix1.astype(np.int32), iy1=iy1.astype(np.int32),
                      max_steps=max_steps, k_cells=k_cells)


@dataclass
class LineRects:
    """A line decomposed into axis-aligned cell rectangles (runs).

    The dual-step Bresenham walk (glyph_kernels.cu:252-279) advances the
    major axis every iteration, so its visited cells form a staircase with
    the exact closed form  m(k) = max(0, ceil((2*k*d_min - d_maj) /
    (2*d_maj)))  (validated exhaustively against the walk in
    tests/test_accumulator.py). Each staircase step is a contiguous run —
    a 1-row (x-major) or 1-column (y-major) rectangle — so a line of C
    cells becomes min(ddx, ddy) + 1 rectangles instead of C points.

    Arrays are per-rectangle, clipped to the home tile and grid; empty
    rectangles are dropped. `owner` maps back to the source point index.
    """
    ax: np.ndarray      # int32 col interval [ax, bx] inclusive
    bx: np.ndarray
    ay: np.ndarray      # int32 row interval [ay, by] inclusive
    by: np.ndarray
    owner: np.ndarray   # int64 source point index


def _staircase_starts(j, dmaj, dmin):
    """First major-axis step k with m(k) == j (j >= 1)."""
    return (dmaj * (2 * j - 1)) // (2 * dmin) + 1


def line_rects(lp: LineParams, cfg: GridConfig, valid: np.ndarray,
               col: np.ndarray, row: np.ndarray) -> LineRects:
    """Decompose lines into clipped cell rectangles (see LineRects)."""
    from .. import native
    if native.available():
        cs, rs, ce, re = home_tile_ranges(cfg, np.asarray(col, np.int64),
                                          np.asarray(row, np.int64))
        # shard views can return tile rows outside the local grid —
        # intersect with it (no-op for plain GridConfigs)
        rs = np.clip(rs, 0, cfg.height).astype(np.int32)
        re = np.clip(re, 0, cfg.height).astype(np.int32)
        ax, bx, ay, by, owner = native.line_runs(
            lp.ix0, lp.iy0, lp.ix1, lp.iy1, valid, cs, rs, ce, re)
        return LineRects(ax=ax, bx=bx, ay=ay, by=by,
                         owner=owner.astype(np.int64))
    n = len(lp.ix0)
    ix0 = lp.ix0.astype(np.int64)
    iy0 = lp.iy0.astype(np.int64)
    ix1 = lp.ix1.astype(np.int64)
    iy1 = lp.iy1.astype(np.int64)
    ddx = np.abs(ix1 - ix0)
    ddy = np.abs(iy1 - iy0)
    sx = np.where(ix0 < ix1, 1, -1)
    sy = np.where(iy0 < iy1, 1, -1)
    xmaj = ddx >= ddy
    dmaj = np.where(xmaj, ddx, ddy)
    dmin = np.where(xmaj, ddy, ddx)
    nruns = np.where(valid, dmin + 1, 0).astype(np.int64)

    owner = np.repeat(np.arange(n, dtype=np.int64), nruns)
    starts = np.zeros(n, np.int64)
    np.cumsum(nruns[:-1], out=starts[1:])
    j = np.arange(len(owner), dtype=np.int64) - np.repeat(starts, nruns)

    o_dmaj = dmaj[owner]
    o_dmin = dmin[owner]
    # run j covers major steps [k0(j), k0(j+1) - 1]
    safe_dmin = np.maximum(o_dmin, 1)
    k0 = np.where(j > 0, _staircase_starts(j, o_dmaj, safe_dmin), 0)
    k1 = np.where(j < o_dmin,
                  _staircase_starts(j + 1, o_dmaj, safe_dmin) - 1, o_dmaj)

    o_xmaj = xmaj[owner]
    o_sx = sx[owner]
    o_sy = sy[owner]
    # major-axis endpoints of the run, in grid coords
    maj0 = np.where(o_xmaj, ix0[owner], iy0[owner])
    smaj = np.where(o_xmaj, o_sx, o_sy)
    p0 = maj0 + smaj * k0
    p1 = maj0 + smaj * k1
    lo = np.minimum(p0, p1)
    hi = np.maximum(p0, p1)
    # minor-axis coordinate of the run
    min0 = np.where(o_xmaj, iy0[owner], ix0[owner])
    smin = np.where(o_xmaj, o_sy, o_sx)
    minor = min0 + smin * j

    ax = np.where(o_xmaj, lo, minor)
    bx = np.where(o_xmaj, hi, minor)
    ay = np.where(o_xmaj, minor, lo)
    by = np.where(o_xmaj, minor, hi)

    # clip to the home tile (glyph footprints clip to the owner's tile)
    cs, rs, ce, re = home_tile_ranges(cfg, col[owner].astype(np.int64),
                                      row[owner].astype(np.int64))
    rs = np.clip(rs, 0, cfg.height)
    re = np.clip(re, 0, cfg.height)
    ax = np.maximum(ax, cs)
    bx = np.minimum(bx, ce - 1)
    ay = np.maximum(ay, rs)
    by = np.minimum(by, re - 1)
    keep = (ax <= bx) & (ay <= by)
    return LineRects(ax=ax[keep].astype(np.int32),
                     bx=bx[keep].astype(np.int32),
                     ay=ay[keep].astype(np.int32),
                     by=by[keep].astype(np.int32),
                     owner=owner[keep])

"""
Tile geometry and routing constants of the device path.

The port's copy of what the TorchEngine takes from the JAX package's
kernel and engine modules, so both packages tile, route and build
coefficients alike (the twin tests hold them bit for bit):

  * the column tiles and row blocks, from pcr_tpu/engine/pallas_kernels.py
    :43-108 (`W_TILE`, `round_up`, `col_tile`, `padded_width`,
    `rect_col_tile`, `gauss_col_tile`, `gauss_row_block`);
  * the Gaussian routing, from pcr_tpu/engine/tpu_backend.py: `GAUSS_WMIN`
    (:321), `ROT_*`/`ROTP_*` (:492-498), `gauss_product_cutoff_bites` and
    `gauss_corr_offsets` (:513-566), and `rot_quadratic_segs`
    (TpuEngine._rot_quadratic_segs, :1772-1806) as a plain function,
    which gives the centre's sub-cell offsets where the TPU gave
    -(ic + sub).

The sizes are constants here, at the JAX package's defaults; only the
Line tile width reads its environment variable (PCR_RECT_W_TILE), which
the card tests set to cover other K3 tiles. The sizes were tuned on a
TPU; ROADMAP Queue 2 re-derives them on Hopper. The chunking constants of
host-sourced ingest (WIRE_ENTRY_BUDGET, INGEST_CHUNK_POINTS,
WIRE_COORD_MAX, `chunk_ranges`) are the port's own.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["W_TILE", "round_up", "col_tile", "padded_width",
           "rect_col_tile", "gauss_col_tile", "gauss_row_block",
           "GAUSS_WMIN", "ROT_ROW_BLOCK", "ROT_COL_TILE", "ROTP_ROW_BLOCK",
           "ROTP_RMAX", "WIRE_ENTRY_BUDGET", "INGEST_CHUNK_POINTS",
           "WIRE_COORD_MAX", "chunk_ranges", "gauss_product_cutoff_bites",
           "gauss_corr_offsets", "rot_quadratic_segs"]

W_TILE = 256             # column tile width
GAUSS_NARROW_MAX = 65    # widest Gaussian window on the narrow tile
GAUSS_CORR_MAX = 8       # most corrected cells before the dense kernel


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def col_tile(W: int) -> int:
    """Column tile width: W_TILE, shrunk for narrow grids (lane-aligned)."""
    return min(W_TILE, round_up(W, 128))


def padded_width(W: int) -> int:
    """Grid width padded so it divides evenly into column tiles."""
    return round_up(W, col_tile(W))


def rect_col_tile(W: int) -> int:
    """Column tile for rect (Line-run) splats: 128 (PCR_RECT_W_TILE), never
    wider than col_tile(W). Always divides padded_width(W)."""
    return min(int(os.environ.get("PCR_RECT_W_TILE", 128)), col_tile(W))


def gauss_col_tile(W: int, rmax: int) -> int:
    """Column tile for Gaussian splats, radius-adaptive: windows up to
    GAUSS_NARROW_MAX cells wide take the narrow 128-column tile, wider ones
    col_tile(W)."""
    if 2 * rmax + 1 <= GAUSS_NARROW_MAX:
        return min(128, col_tile(W))
    return col_tile(W)


def gauss_row_block(W: int, rmax: int) -> int:
    """Row block height for Gaussian splats, radius-adaptive: the TH in
    {32, 64, 128} minimizing the cost model dup_r * dup_c * (TH + WT + c)
    of halo duplication against per-entry work (sigma 1 -> 32, sigma 4 ->
    64, sigma 16 -> 128). Every candidate divides H_pad (rounded to 128)."""
    w = 2 * rmax + 1
    wt = gauss_col_tile(W, rmax)
    best, bc = 128, float("inf")
    for th in (32, 64, 128):
        c = ((1 + (w - 1) / th) * (1 + (w - 1) / wt)
             * (th + wt + 30))
        if c < bc:
            best, bc = th, c
    return best


# Legit separable-splat deposits all carry weight >= 1e-6 (the
# reference's product cutoff, glyph_kernels.cu:160); anything below half
# of that in a Gaussian weight-sum field is a residue, never data.
GAUSS_WMIN = np.float32(5e-7)

# Rotated (dense) splat blocks: shorter rows cut the per-point tile area
# (the kernel evaluates TH*WT cells per point), narrower cols cut halo.
ROT_ROW_BLOCK = 32
ROT_COL_TILE = 128
# Windowed rotated splat (K5): short row blocks; the radius gate bounds
# halo duplication (copies ~ (1+2r/TH)(1+2r/32) per point).
ROTP_ROW_BLOCK = 16
ROTP_RMAX = 16

# Most layout entries (halo copies of points, or of Line runs) one staged
# chunk may hold, by the worst case of its glyph: the device layout sorts a
# chunk's entries at once and holds, for a while, about 100 B an entry
# beside the layout itself. The counterpart of the JAX package's
# PCR_WIRE_ENTRY_BUDGET (tpu_backend.py:1544), sized for the card's 80 GB
# and not its 16M: the 5M-point layouts of the glyph suite stay one chunk.
# Both layout routes split alike, so the route never shows in a band.
WIRE_ENTRY_BUDGET = 64 << 20
# Points per chunk of a cloud in Hybrid mode with more than one worker and
# no `chunk_size`: what the workers prepare ahead while the card commits
# (pipeline._staged_chunks). Every other mode takes such a cloud whole.
INGEST_CHUNK_POINTS = 1 << 20
# The device layout ships cell coordinates as int16 pairs: a chunk with a
# coordinate at or past this bound takes the host layout.
WIRE_COORD_MAX = 32000


def chunk_ranges(n: int, cap: int):
    """[(start, end)] splitting n items into runs of at most `cap`."""
    cap = max(int(cap), 1)
    return [(a, min(a + cap, n)) for a in range(0, n, cap)]


def gauss_product_cutoff_bites(r, sx, sy) -> bool:
    """True when the square +-r window can contain cells that the
    reference's PRODUCT weight cutoff (w >= 1e-6, glyph_kernels.cu's
    `if (weight < 1e-6f) continue`) drops: the separable factorization
    can only mask per axis (wx >= 1e-6 AND wy >= 1e-6), so window
    corners with qx^2 + qy^2 > -2 ln(1e-6) would survive it wrongly.
    Such chunks must use a dense quadratic-form kernel, whose cutoff
    IS the product cutoff. Worst case |dq| <= (r + 1)/sigma per axis
    (sub-cell offset < 1 cell); bites only for small sigma — the 3-sigma
    window stays inside the cutoff ellipse from about sigma >= 1.7."""
    qx = (np.asarray(r, np.float64) + 1.0) / np.maximum(
        np.abs(np.asarray(sx, np.float64)), 1e-30)
    qy = (np.asarray(r, np.float64) + 1.0) / np.maximum(
        np.abs(np.asarray(sy, np.float64)), 1e-30)
    return bool(np.any(qx * qx + qy * qy > 27.631021))


def gauss_corr_offsets(r, sx, sy, max_k: int | None = None):
    """Static (dxo, dyo) window offsets whose PRODUCT weight can dip below
    the reference's 1e-6 cutoff while both per-axis factors stay passable
    — the only cells where the separable factorization over-deposits.

    For mildly-small uniform sigmas this set is tiny (sigma=1: just the
    (-r,-r) corner), so the separable splat (K2, with its product cutoff)
    still serves. Returns () when no cell can bite (plain separable), a
    tuple of offsets when the set is small, or None when it is too large
    (dense kernel); max_k defaults to GAUSS_CORR_MAX.

    Worst case over the sub-cell offset in [0, 1): |d - sub| <= max(|d|,
    |d-1|); the axis can still pass the per-axis mask when min |d - sub|
    = |d| (d <= 0) / d-1 (d >= 1) stays under the cutoff."""
    if max_k is None:
        max_k = GAUSS_CORR_MAX
    r = int(r)
    d = np.arange(-r, r + 1, dtype=np.float64)
    qmax = np.maximum(np.abs(d), np.abs(d - 1.0))
    qmin = np.where(d <= 0, np.abs(d), d - 1.0)
    sx = max(abs(float(sx)), 1e-30)
    sy = max(abs(float(sy)), 1e-30)
    CUT = 27.631021
    bite = (((qmax / sx) ** 2)[:, None] + ((qmax / sy) ** 2)[None, :]
            > CUT)
    passable = ((((qmin / sx) ** 2) <= CUT)[:, None]
                & (((qmin / sy) ** 2) <= CUT)[None, :])
    cand = bite & passable
    k = int(cand.sum())
    if k == 0:
        return ()
    if k > max_k:
        return None
    return tuple((int(d[i]), int(d[j])) for i, j in np.argwhere(cand))


def rot_quadratic_segs(gp, f0):
    """Completed-square coefficients of the rotated-Gaussian quadratic
    form, shared bit-for-bit by the windowed (K5) and dense (K4) splat
    stagings. Same algebra as glyph_kernels.cu:145-176 (qx=(dx*cos
    - dy*sin)/sx, qy=(dx*sin + dy*cos)/sy): with c1=cos/sx, c2=-sin/sx,
    c3=sin/sy, c4=cos/sy (each carrying a 1/sqrt(2) fold so q2 IS the
    exponent),

        q2 = A dx^2 + 2B dx dy + C dy^2
           = (sqrt(A - B^2/C) dx)^2 + (sqrt(C) (dy + (B/C) dx))^2

    which splits per axis. sqrt(log2 e) rides the square-root coefficients
    so the kernel evaluates exp2(-q2') directly; the kernels scale their
    cutoff constant to ln(1e6)*log2e to match. Returns the first six seg
    arrays [sub_cx, sub_cy, B/C, sqrt(C)*s, sqrt(A-B^2/C)*s, f0]: the
    sub-cell offsets of the centre, not the TPU's -(icx + sub_cx) and
    -(icy + sub_cy). The kernels form a cell's distance to the centre as
    the oracle does, the exact integer difference (ws - icx) rounded once
    with - sub_cx, so the distance does not lose bits as rows and columns
    grow, and a row-offset view (its local icy) gives the same bits as
    the whole grid. The other four are the TPU's bit for bit."""
    inv_sx = np.float32(0.7071067811865476) / gp.sx
    inv_sy = np.float32(0.7071067811865476) / gp.sy
    c1 = gp.cos_rot * inv_sx
    c2 = -gp.sin_rot * inv_sx
    c3 = gp.sin_rot * inv_sy
    c4 = gp.cos_rot * inv_sy
    A = c1 * c1 + c3 * c3
    B = c1 * c2 + c3 * c4
    C = c2 * c2 + c4 * c4
    s_l2e = np.float32(1.2011224087864498)
    return [gp.sub_cx, gp.sub_cy,
            B / C,
            np.sqrt(C) * s_l2e,
            np.sqrt(np.maximum(A - B * B / C, 0.0)) * s_l2e,
            f0]

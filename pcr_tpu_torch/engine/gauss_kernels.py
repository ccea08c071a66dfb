"""
Kernels K2, K4 and K5 — the Gaussian splats: their wrappers, their plain
PyTorch versions and their launch counters.

  * K2 `sorted_splat_gauss` replaces the gauss mode of
    `pcr_tpu/engine/pallas_kernels.py::build_sorted_splat_pallas`
    (two_d=True, corr_offsets); source `csrc/sorted_splat_gauss.cu`.
    params (nsub, 8, BLOCK) int32 [icx | icy | sub_cx | sub_cy | sx | sy |
    r | f0]. `cut` turns on the reference's product cutoff (drop a
    cell-entry pair whose wy * wx < 1e-6), which the TPU expressed with its
    corr rows; the caller sets it where the TPU had corr offsets.
  * K4 `rot_splat_dense` replaces the rot mode of the same function
    (two_d=True); source `csrc/rot_splat.cu`. params (nsub, 9, BLOCK)
    float32 [sub_cx | sub_cy | s | sC | sA2 | f0 | icx | icy | r], masks
    computed in the kernel.
  * K5 `rot_splat_packed` replaces `build_rot_packed_pallas`; same source.
    params (nsub, 12, BLOCK) float32 [sub_cx | sub_cy | s | sC | sA2 | f0
    | wlo | whi | rlo | rhi | icx | icy], windows clipped on the host, in
    the port's own sub-chunk-major tile layout (not the TPU's quad-major
    one).

K4 and K5 form a cell's distance to the centre as the oracle does
(engine/cpu_backend.py): dx = float32(w - icx) - sub_cx, dy =
float32(h - icy) - sub_cy, the integer difference exact and one rounding.
The TPU's planes held -(icx + sub_cx), rounded at the cell's absolute
coordinate, which lost up to ~5e-4 of a cell at rows ~8000.

All three take ascending `bids` (tile id = row_block * ncb + col_block over
(th, wt) tiles of the (H_pad, W_pad) state fields), skip runs with bids
outside [0, nb_total), and update the states IN PLACE. The sources' header
comments have each design and what bounds it on the card. A wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises.

On the card all three walk windows (csrc/splat_walk.cuh): one CTA owns an
8-row x 128-column slice of a tile, each of its four warps a block of 8 x 32
cells, and a warp evaluates only the entries whose clipped window shares a
cell with its block. `splat_plan` is the launch's geometry, which the
wrappers hand to the kernels; `gauss_windows` / `rot_dense_windows` are the
clipped windows the kernels form once per entry (the plain versions mask
with the same ones), and `block_hits` is the walk's hit test.

`geom` (a GaussGeom) carries the grid the masks need: the logical (H, W),
the home-tile clip of multi-tile grids, and a row-offset view's frame.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .kernels import BLOCK

__all__ = ["GaussGeom", "ROT_CUT", "SplatPlan", "block_hits", "gauss_windows",
           "rot_dense_windows", "rot_distances", "rot_splat_dense",
           "rot_splat_dense_plain", "rot_splat_packed",
           "rot_splat_packed_plain", "sorted_splat_gauss",
           "sorted_splat_gauss_plain", "splat_plan"]

ROT_CUT = -19.931569        # -ln(1e6) * log2(e): the 1e-6 product cutoff
WMIN = 1e-6                 # the reference's weight cutoff
# elements of the widest intermediate a plain version builds at once
_PLAIN_BUDGET = {"cpu": 1 << 22, "cuda": 1 << 26}

# The walk's shapes (csrc/splat_walk.cuh): a CTA's slice of a tile, the
# block of a warp, the entries staged at a time, and Hopper's shared memory
# per CTA.
SLICE_ROWS, SLICE_COLS = 8, 128
WARP_COLS = 32
THREADS = 128
PIECE = 256
SMEM_LIMIT = 232_448
# words of shared memory per staged entry: its segments, its window for
# the ballot, and the records the walk reads (K2: the column record, the
# column range, 8 wy; K4 / K5: the column and row records, 8 dy)
_SMEM_WORDS = {"gauss": 8 + 4 + (4 + 2 + 8), "rot": 9 + 4 + (4 + 4 + 8),
               "rotp": 12 + 4 + (4 + 4 + 8)}


@dataclass(frozen=True)
class SplatPlan:
    """One launch of K2 / K4 / K5 over (th, wt) tiles: `slices` CTAs a
    tile run (grid = nsub x slices, only a run's first sub-chunk's CTAs
    work), `threads` a CTA, and `smem_bytes` of dynamic shared memory (one
    staged piece of the entries' segments, windows and records)."""
    slices: int
    threads: int
    smem_bytes: int

    def grid(self, nsub: int) -> tuple[int, int]:
        return (nsub, self.slices)


def splat_plan(kind: str, th: int, wt: int) -> SplatPlan:
    """The launch geometry of `kind` ("gauss": K2, "rot": K4, "rotp": K5)
    over (th, wt) tiles; raises where the kernel has none."""
    if th < SLICE_ROWS or th % SLICE_ROWS or wt < SLICE_COLS \
            or wt % SLICE_COLS:
        raise ValueError(f"{kind}: the kernel takes th % {SLICE_ROWS} == 0 "
                         f"and wt % {SLICE_COLS} == 0, got ({th}, {wt})")
    slices = (th // SLICE_ROWS) * (wt // SLICE_COLS)
    smem = _SMEM_WORDS[kind] * PIECE * 4
    if smem > SMEM_LIMIT or slices > 65_535:
        raise ValueError(f"{kind}: ({th}, {wt}) tiles need {smem} B of "
                         f"shared memory and {slices} slices")
    return SplatPlan(slices, THREADS, smem)


def _plan_args(name, kind, params, th, wt):
    """The plan's launch arguments for CUDA `params`."""
    plan = splat_plan(kind, th, wt)
    if params.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies params 16 bytes at a "
                         f"time and takes them 16-byte aligned")
    return [plan.slices, plan.smem_bytes]


def block_hits(win, bids: torch.Tensor, th: int, wt: int, ncb: int):
    """The walk's hit test. `win` = (lo_x, hi_x, lo_y, hi_y), each (nsub,
    block): the entries' clipped windows, inclusive, empty where lo > hi.
    Returns a bool (nsub, block, th // 8, wt // 32): entry e of sub-chunk j
    hits block (i, k) of its tile exactly when its window shares a cell
    with the block's 8 rows x 32 columns."""
    lo_x, hi_x, lo_y, hi_y = (w[:, :, None, None] for w in win)
    dev = bids.device
    b = bids.long()[:, None, None, None]
    r0 = b // ncb * th + SLICE_ROWS * torch.arange(
        th // SLICE_ROWS, device=dev)[None, None, :, None]
    c0 = b % ncb * wt + WARP_COLS * torch.arange(
        wt // WARP_COLS, device=dev)[None, None, None, :]
    alive = (lo_x <= hi_x) & (lo_y <= hi_y)
    return (alive & (lo_x <= c0 + WARP_COLS - 1) & (hi_x >= c0)
            & (lo_y <= r0 + SLICE_ROWS - 1) & (hi_y >= r0))


@dataclass(frozen=True)
class GaussGeom:
    """What the in-kernel masks read of the grid (GridConfig, or a
    row-offset view with row_offset / global_height)."""
    H: int
    W: int
    multi_tile: bool = False
    tile_w: int = 1
    tile_h: int = 1
    row_offset: int = 0
    global_h: int = 0

    @classmethod
    def of(cls, cfg) -> "GaussGeom":
        return cls(cfg.height, cfg.width, cfg.total_tiles() > 1,
                   cfg.tile_width, cfg.tile_height,
                   getattr(cfg, "row_offset", 0),
                   getattr(cfg, "global_height", cfg.height))

    def args(self):
        return [self.H, self.W, int(self.multi_tile), self.tile_w,
                self.tile_h, self.row_offset, self.global_h or self.H]


_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.pcr_sorted_splat_gauss.argtypes = (
            [vp, vp, i64, vp, vp] + [i32] * 16 + [vp])
        lib.pcr_rot_splat_dense.argtypes = (
            [vp, vp, i64, vp, vp] + [i32] * 15 + [vp])
        lib.pcr_rot_splat_packed.argtypes = (
            [vp, vp, i64, vp, vp] + [i32] * 8 + [vp])
        sizes = (lib.pcr_sorted_splat_gauss_block, lib.pcr_rot_splat_block,
                 lib.pcr_sorted_splat_gauss_piece, lib.pcr_rot_splat_piece)
        for fn in (lib.pcr_sorted_splat_gauss, lib.pcr_rot_splat_dense,
                   lib.pcr_rot_splat_packed, *sizes):
            fn.restype = i32
        for fn in sizes:
            fn.argtypes = []
        if [fn() for fn in sizes] != [BLOCK, BLOCK, PIECE, PIECE]:
            raise RuntimeError("gauss_kernels: the kernels' block or piece "
                               "size differs from BLOCK / PIECE")
        _BOUND = lib
    return _BOUND


def _check(name, states, params, bids, th, wt, nseg, dtype):
    if len(states) not in (1, 2):
        raise ValueError(f"{name}: 1 or 2 state fields expected")
    dev, shape = states[0].device, states[0].shape
    for s in states:
        if (s.dtype != torch.float32 or s.device != dev or s.shape != shape
                or s.dim() != 2 or not s.is_contiguous()):
            raise ValueError(f"{name}: states must be contiguous float32 "
                             f"(H_pad, W_pad) fields on one device")
    if shape[0] % th or shape[1] % wt:
        raise ValueError(f"{name}: state {tuple(shape)} is not a whole "
                         f"number of ({th}, {wt}) tiles")
    if (params.dtype != dtype or params.dim() != 3
            or params.shape[1] != nseg or not params.is_contiguous()
            or params.device != dev):
        raise ValueError(f"{name}: params must be contiguous {dtype} "
                         f"(nsub, {nseg}, block) on the states' device")
    if (bids.dtype != torch.int32 or bids.shape != (params.shape[0],)
            or not bids.is_contiguous() or bids.device != dev):
        raise ValueError(f"{name}: bids must be contiguous int32 (nsub,) "
                         f"on the states' device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev.type} tensors")
    if dev.type == "cuda" and params.shape[2] != BLOCK:
        raise ValueError(f"{name}: the kernel takes {BLOCK}-entry "
                         f"sub-chunks, got {params.shape[2]}")
    return dev


def _launch(name, fn, states, params, bids, args):
    dev = states[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.data_ptr(), bids.data_ptr(), params.shape[0],
                 states[0].data_ptr(),
                 states[1].data_ptr() if len(states) == 2 else None,
                 len(states), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed (cudaError {err})")


def _tiles(states, wt, th):
    h_pad, w_pad = states[0].shape
    ncb = w_pad // wt
    return h_pad, w_pad, ncb, h_pad // th * ncb


# -- K2 ---------------------------------------------------------------------

def sorted_splat_gauss(states, params: torch.Tensor, bids: torch.Tensor, *,
                       th: int, wt: int, cut: bool, geom: GaussGeom) -> None:
    """K2: fold every live entry's separable footprint into `states`, in
    place (1 field: Sum / Count; 2: Average / WeightedAverage)."""
    dev = _check("sorted_splat_gauss", states, params, bids, th, wt, 8,
                 torch.int32)
    if dev.type == "cpu":
        sorted_splat_gauss_plain(states, params, bids, th=th, wt=wt, cut=cut,
                                 geom=geom)
        return
    plan = _plan_args("sorted_splat_gauss", "gauss", params, th, wt)
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    _launch("sorted_splat_gauss", _lib().pcr_sorted_splat_gauss, states,
            params, bids, [int(cut), th, wt, ncb, nb_total, w_pad]
            + geom.args() + plan)
    sorted_splat_gauss.launches += 1


sorted_splat_gauss.launches = 0


def _entries(states, params, bids, th, wt, alive):
    """The entries of the live runs, flat in run and entry order: their
    params (E, nseg) and their tile's first row and column (E,), less the
    dead entries (`alive` of the params is False)."""
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    runs = (bids >= 0) & (bids < nb_total)
    p = params[runs].transpose(1, 2).reshape(-1, params.shape[1])
    b = bids[runs].long().repeat_interleave(params.shape[2])
    keep = alive(p)
    b = b[keep]
    return p[keep], b // ncb * th, b % ncb * wt


def _splat_windows(states, p, row0, col0, th, wt, y0, x0, ny, nx, weigh):
    """Add each entry's weights over its window of ny x nx cells from
    (y0, x0), cut to its tile, with `index_add_` into the flattened
    fields, in place. `weigh(p, h, w, row_in, col_in)` gives the cells'
    mask and the two fields' terms, each (E, ny, nx), for rows h (E, ny)
    and columns w (E, nx)."""
    w_pad = states[0].shape[1]
    dev = p.device
    step = max(1, _PLAIN_BUDGET[dev.type] // (ny * nx))
    for a in range(0, len(p), step):
        sl = slice(a, a + step)
        h = y0[sl, None] + torch.arange(ny, device=dev)
        w = x0[sl, None] + torch.arange(nx, device=dev)
        row_in = (h >= row0[sl, None]) & (h < row0[sl, None] + th)
        col_in = (w >= col0[sl, None]) & (w < col0[sl, None] + wt)
        mask, c0, c1 = weigh(p[sl], h, w, row_in, col_in)
        cells = (h[:, :, None] * w_pad + w[:, None, :])[mask]
        for st, c in zip(states, (c0, c1)):
            st.view(-1).index_add_(0, cells, c[mask])


def _axis_factor(x, ic, sub, s):
    """The TPU kernel's axis factor exp(-0.5 q^2), q = ((x - ic) - sub) / s,
    for coordinates x (E, k) of entries (E,)."""
    q = (x.float() - ic[:, None].float()) - sub[:, None]
    q = q / s[:, None]
    return torch.exp(-0.5 * q * q)


def gauss_windows(icx, icy, r, geom: GaussGeom):
    """K2's masked ranges (clo, chi, rlo, rhi) of entries with cell
    (icx, icy) and radius r (integer tensors of one shape), inclusive, as
    the kernel forms them once per entry: the +-r window cut to the grid
    and, on a multi-tile grid, to the home tile. A dead entry (r < 0) gets
    an empty column range."""
    g = geom
    icx, icy, r = icx.long(), icy.long(), r.long()
    clo, chi = icx - r, (icx + r).clamp(max=g.W - 1)
    rlo, rhi = icy - r, (icy + r).clamp(max=g.H - 1)
    if g.multi_tile:
        gh = g.global_h or g.H
        cs = icx.clamp(0, g.W - 1) // g.tile_w * g.tile_w
        clo = torch.maximum(clo, cs)
        chi = torch.minimum(chi, (cs + g.tile_w).clamp(max=g.W) - 1)
        rs = ((icy + g.row_offset).clamp(0, gh - 1)
              // g.tile_h * g.tile_h - g.row_offset)
        re = (rs + g.row_offset + g.tile_h).clamp(max=gh) - g.row_offset
        rlo = torch.maximum(rlo, rs)
        rhi = torch.minimum(rhi, re - 1)
    chi = torch.where(r < 0, clo - 1, chi)
    return clo, chi, rlo, rhi


def sorted_splat_gauss_plain(states, params: torch.Tensor,
                             bids: torch.Tensor, *, th: int, wt: int,
                             cut: bool, geom: GaussGeom) -> None:
    """K2's plain PyTorch version: every live entry's factors over its
    +-r window, cut to its tile and masked as the kernel masks them, added
    term by term with `index_add_`, in place."""
    p, row0, col0 = _entries(states, params, bids, th, wt,
                             lambda p: p[:, 6] >= 0)
    if not len(p):
        return
    r = p[:, 6].long()
    span = 2 * int(r.max()) + 1

    def weigh(p, h, w, row_in, col_in):
        f = p.view(torch.float32)
        icx, icy = p[:, 0].long(), p[:, 1].long()
        clo, chi, rlo, rhi = (a[:, None] for a in gauss_windows(
            icx, icy, p[:, 6], geom))
        wy = _axis_factor(h, icy, f[:, 3], f[:, 5])
        wx = _axis_factor(w, icx, f[:, 2], f[:, 4])
        my = row_in & (h >= rlo) & (h <= rhi) & (wy >= WMIN)
        mx = col_in & (w >= clo) & (w <= chi) & (wx >= WMIN)
        prod = wy[:, :, None] * wx[:, None, :]
        mask = my[:, :, None] & mx[:, None, :]
        if cut:
            mask &= prod >= WMIN
        c0 = wy[:, :, None] * (wx * f[:, 7, None])[:, None, :]
        return mask, c0, prod

    _splat_windows(states, p, row0, col0, th, wt, p[:, 1].long() - r,
                   p[:, 0].long() - r, span, span, weigh)


# -- K4 and K5 --------------------------------------------------------------

def rot_splat_dense(states, params: torch.Tensor, bids: torch.Tensor, *,
                    th: int, wt: int, geom: GaussGeom) -> None:
    """K4: fold every live entry's rotated footprint, evaluated over its
    whole tile, into `states`, in place."""
    dev = _check("rot_splat_dense", states, params, bids, th, wt, 9,
                 torch.float32)
    if dev.type == "cpu":
        rot_splat_dense_plain(states, params, bids, th=th, wt=wt, geom=geom)
        return
    plan = _plan_args("rot_splat_dense", "rot", params, th, wt)
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    _launch("rot_splat_dense", _lib().pcr_rot_splat_dense, states, params,
            bids, [th, wt, ncb, nb_total, w_pad] + geom.args() + plan)
    rot_splat_dense.launches += 1


rot_splat_dense.launches = 0


def rot_splat_packed(states, params: torch.Tensor, bids: torch.Tensor, *,
                     th: int, wt: int) -> None:
    """K5: fold every live entry's rotated footprint, inside its
    host-clipped window, into `states`, in place."""
    dev = _check("rot_splat_packed", states, params, bids, th, wt, 12,
                 torch.float32)
    if dev.type == "cpu":
        rot_splat_packed_plain(states, params, bids, th=th, wt=wt)
        return
    plan = _plan_args("rot_splat_packed", "rotp", params, th, wt)
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    _launch("rot_splat_packed", _lib().pcr_rot_splat_packed, states, params,
            bids, [th, wt, ncb, nb_total, w_pad] + plan)
    rot_splat_packed.launches += 1


rot_splat_packed.launches = 0


_LN2 = 0.6931471805599453


def _rot_plain(states, f, row0, col0, th, wt) -> None:
    """K4's and K5's plain body: entries f (E, 12) in K5's form [sub_cx |
    sub_cy | s | sC | sA2 | f0 | wlo | whi | rlo | rhi | icx | icy], each
    over its window cut to its tile, the completed-square weights in the
    kernels' formulas (csrc/rot_splat.cu), added term by term with
    `index_add_`, in place."""
    if not len(f):
        return
    ny = int((f[:, 9] - f[:, 8]).max()) + 1
    nx = int((f[:, 7] - f[:, 6]).max()) + 1

    def weigh(f, h, w, row_in, col_in):
        hs, ws = h.float(), w.float()
        dx, dy = rot_distances(f, h, w)
        u = dx * f[:, 4, None]
        gq = -(u * u)
        v = (dy[:, :, None] + (dx * f[:, 2, None])[:, None, :]) \
            * f[:, 3, None, None]
        q2n = gq[:, None, :] - v * v
        row_ok = row_in & (hs >= f[:, 8, None]) & (hs <= f[:, 9, None])
        col_ok = col_in & (ws >= f[:, 6, None]) & (ws <= f[:, 7, None])
        mask = row_ok[:, :, None] & col_ok[:, None, :] & (q2n >= ROT_CUT)
        # exp2(q) as exp(q ln 2): torch's CPU exp2 rounds a vector's
        # scalar tail otherwise than its body, so an entry's weight would
        # hang on its place in the tensor; exp rounds alike in both
        wgt = torch.exp(q2n * _LN2)
        return mask, f[:, 5, None, None] * wgt, wgt

    _splat_windows(states, f, row0, col0, th, wt, f[:, 8].long(),
                   f[:, 6].long(), ny, nx, weigh)


def rot_distances(f, h, w):
    """The distances to the centre (dx (E, nx), dy (E, ny)) that K4 and
    K5 form for entries f (E, 12) in K5's form at columns w (E, nx) and
    rows h (E, ny): dx = float32(w - icx) - sub_cx, dy = float32(h - icy)
    - sub_cy, the oracle's rdx / rdy (engine/cpu_backend.py). The integer
    differences are exact in float32, so each is one rounding."""
    return ((w.float() - f[:, 10, None]) - f[:, 0, None],
            (h.float() - f[:, 11, None]) - f[:, 1, None])


def rot_dense_windows(icx, icy, r, geom: GaussGeom):
    """K4's windows (wlo, whi, rlo, rhi) of entries with cell (icx, icy)
    and radius r (whole-numbered float tensors of one shape), inclusive, as
    the kernel forms them once per entry from the TPU kernel's masks:
    columns |w - icx| <= r, w < W and the home tile's; rows [icy - r,
    icy + r] cut to the grid or, on a multi-tile grid, to the home tile's
    rows. A dead entry (r < 0) gets an empty column range."""
    g = geom
    wlo, whi = icx - r, (icx + r).clamp(max=g.W - 1.0)
    rlo, rhi = icy - r, icy + r
    if g.multi_tile:
        cs = torch.floor(icx.clamp(0.0, g.W - 1.0) / g.tile_w) * g.tile_w
        wlo = torch.maximum(wlo, cs)
        whi = torch.minimum(whi, (cs + g.tile_w).clamp(max=float(g.W)) - 1.0)
        off, hg1 = float(g.row_offset), float((g.global_h or g.H) - 1)
        rs = torch.floor((icy + off).clamp(0.0, hg1) / g.tile_h) * g.tile_h
        rlo = torch.maximum(rlo, rs - off)
        rhi = torch.minimum(rhi, (rs + g.tile_h - 1.0).clamp(max=hg1) - off)
    else:
        rhi = rhi.clamp(max=float(g.H - 1))
    whi = torch.where(r < 0, wlo - 1.0, whi)
    return wlo, whi, rlo, rhi


def rot_splat_dense_plain(states, params: torch.Tensor, bids: torch.Tensor,
                          *, th: int, wt: int, geom: GaussGeom) -> None:
    """K4's plain PyTorch version: every live entry over the window the
    TPU kernel's masks leave it (rot_dense_windows: icx / icy / r, the
    grid and the home tile), cut to its tile, added term by term with
    `index_add_`, in place."""
    f, row0, col0 = _entries(states, params, bids, th, wt,
                             lambda f: f[:, 8] >= 0)
    win = torch.stack(rot_dense_windows(f[:, 6], f[:, 7], f[:, 8], geom), 1)
    keep = (win[:, 0] <= win[:, 1]) & (win[:, 2] <= win[:, 3])
    _rot_plain(states, torch.cat([f[:, :6], win, f[:, 6:8]], 1)[keep],
               row0[keep], col0[keep], th, wt)


def rot_splat_packed_plain(states, params: torch.Tensor, bids: torch.Tensor,
                           *, th: int, wt: int) -> None:
    """K5's plain PyTorch version: every live entry over its host-clipped
    window, cut to its tile, added term by term with `index_add_`, in
    place."""
    f, row0, col0 = _entries(states, params, bids, th, wt,
                             lambda f: (f[:, 6] <= f[:, 7])
                             & (f[:, 8] <= f[:, 9]))
    _rot_plain(states, f, row0, col0, th, wt)

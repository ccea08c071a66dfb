"""
Kernel K3 — the rect (Line-run) splat: its wrapper, its plain PyTorch
version and its launch counter.

K3 replaces the rect mode of
`pcr_tpu/engine/pallas_kernels.py::build_sorted_splat_pallas` (two_d=True;
the rect parts at :365-366, :541-545, :555-556, :683-685, :743-749), which
the TPU engine runs for every Line glyph. The CUDA source is
`csrc/rect_splat.cu`; its header comment has the design. In short:

  * Contract (unchanged from the TPU kernel): `params` (nsub, 5, BLOCK)
    int32 `[ax | bx | ay | by | f0 bits]`, one entry per Bresenham run,
    the inclusive cell rectangle [ax, bx] x [ay, by]; `bids` (nsub,) int32
    ascending tile ids `row_block * ncb + col_block` over (th, wt) tiles of
    the (H_pad, W_pad) state fields. The part of an entry's rectangle
    inside its tile adds f0 to field 0 and, with two fields (Average,
    WeightedAverage), 1.0 to field 1, each cell taking its terms in entry
    order, starting from the state's value. Padding is the empty interval
    ax = 1 > bx = 0; runs with bids outside [0, nb_total) are skipped.
  * What bounds it on the card: instruction issue and shared-memory
    latency in the walk of a tile run, which is serial per cell, so the
    longest run of a launch sets its time; bytes do not matter.
  * What the design does about it: it gives up the TPU's evaluation of
    every entry over the whole 128 x 128 tile (cheap only on the MXU). One
    CTA of 256 threads owns a band of RECT_BAND_ROWS = 16 rows x 128
    columns of a tile: two 8-row slices of csrc/splat_walk.cuh's shape
    (K2 / K4 / K5's), one a row of four warps; any th and wt, the ragged
    last bands masked. A thread keeps one column's 8 cells of each field
    in registers from the first load to the one store. The run streams
    through shared memory in pieces of RECT_PIECE entries by cp.async, the
    next piece in flight while this one is walked. One thread per entry
    cuts its rectangle to the band; what is left (one band in eight for a
    1-row run) is compacted in entry order into 16-byte records, and each
    warp walks, row by row, only the records that meet its 8 rows and 32
    columns. Each cell gets its terms in entry order from one thread, with
    no atomics, so the bits are those of the CPU's plain version and of
    the kernel's first version.

`rect_plan` is the launch's geometry, which the wrapper hands to the
kernel; `rect_walk_counts` recomputes what the walk does on given entries
(records kept, row hits walked).

The states are updated IN PLACE. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gauss_kernels import (_PLAIN_BUDGET, SLICE_COLS, SLICE_ROWS, THREADS,
                            WARP_COLS, SplatPlan, _check, _entries, _launch,
                            _tiles)
from .kernels import BLOCK

__all__ = ["RECT_BAND_ROWS", "RECT_PIECE", "rect_plan", "rect_splat",
           "rect_splat_plain", "rect_walk_counts"]

# csrc/rect_splat.cu's shapes: the rows of a tile one CTA owns (one 8-row
# slice a row of four warps) and the entries staged at a time
RECT_BAND_ROWS = 16
RECT_PIECE = 1024

_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.pcr_rect_splat.argtypes = [vp, vp, i64, vp, vp] + [i32] * 7 + [vp]
        lib.pcr_rect_splat.restype = i32
        sizes = (lib.pcr_rect_splat_block, lib.pcr_rect_splat_piece,
                 lib.pcr_rect_splat_band_rows)
        for fn in sizes:
            fn.argtypes = []
            fn.restype = i32
        if [fn() for fn in sizes] != [BLOCK, RECT_PIECE, RECT_BAND_ROWS]:
            raise RuntimeError("rect_splat: the kernel's block, piece or "
                               "band differs from BLOCK / RECT_PIECE / "
                               "RECT_BAND_ROWS")
        _BOUND = lib
    return _BOUND


def rect_plan(th: int, wt: int) -> SplatPlan:
    """One launch of K3 over (th, wt) tiles, whatever th and wt: a CTA per
    band of RECT_BAND_ROWS rows x 128 columns of a tile (the last of each
    kind ragged where th % 16 or wt % 128), and the dynamic shared memory
    of one staged piece and its records."""
    if th < 1 or wt < 1:
        raise ValueError(f"rect_splat: no ({th}, {wt}) tiles")
    slices = -(-th // RECT_BAND_ROWS) * -(-wt // SLICE_COLS)
    if slices > 65_535:
        raise ValueError(f"rect_splat: ({th}, {wt}) tiles need {slices} "
                         f"bands")
    threads = THREADS * RECT_BAND_ROWS // SLICE_ROWS
    return SplatPlan(slices, threads, (5 + 4) * RECT_PIECE * 4)


def rect_splat(states, params: torch.Tensor, bids: torch.Tensor, *, th: int,
               wt: int) -> None:
    """K3: fold every entry's rectangle, cut to its tile, into `states`, in
    place (1 field: Sum / Count; 2: Average / WeightedAverage)."""
    dev = _check("rect_splat", states, params, bids, th, wt, 5, torch.int32)
    if dev.type == "cpu":
        rect_splat_plain(states, params, bids, th=th, wt=wt)
        return
    plan = rect_plan(th, wt)
    if params.data_ptr() % 16:
        raise ValueError("rect_splat: the kernel copies params 16 bytes at "
                         "a time and takes them 16-byte aligned")
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    _launch("rect_splat", _lib().pcr_rect_splat, states, params, bids,
            [th, wt, ncb, nb_total, w_pad, plan.slices])
    rect_splat.launches += 1


rect_splat.launches = 0


def rect_splat_plain(states, params: torch.Tensor, bids: torch.Tensor, *,
                     th: int, wt: int) -> None:
    """K3's plain PyTorch version: every live entry's rectangle, cut to its
    tile, expanded to its cells (row-major) and added with `index_add_`,
    in place, at most _PLAIN_BUDGET cells at a time. On the CPU
    `index_add_` adds in index order, so each cell takes its terms in entry
    order, as the kernel does; on CUDA it is atomic and serves only as the
    reference the kernel is held against."""
    p, row0, col0 = _entries(states, params, bids, th, wt,
                             lambda p: (p[:, 0] <= p[:, 1])
                             & (p[:, 2] <= p[:, 3]))
    x0 = torch.maximum(p[:, 0].long(), col0)
    x1 = torch.minimum(p[:, 1].long(), col0 + wt - 1)
    y0 = torch.maximum(p[:, 2].long(), row0)
    y1 = torch.minimum(p[:, 3].long(), row0 + th - 1)
    keep = (x0 <= x1) & (y0 <= y1)
    x0, y0, f0 = x0[keep], y0[keep], p[keep, 4].view(torch.float32)
    nx = x1[keep] - x0 + 1
    k = nx * (y1[keep] - y0 + 1)                  # cells per entry
    if not len(k):
        return
    w_pad = states[0].shape[1]
    dev = p.device
    ends = torch.cumsum(k, 0)
    budget = _PLAIN_BUDGET[dev.type]
    a, done = 0, 0
    while a < len(k):
        # entries [a, b) hold at most `budget` cells (one entry at least)
        b = max(int(torch.searchsorted(ends, done + budget, right=True)),
                a + 1)
        kk = k[a:b]
        e = torch.repeat_interleave(torch.arange(a, b, device=dev), kk)
        starts = torch.cumsum(kk, 0) - kk
        o = (torch.arange(len(e), device=dev)
             - torch.repeat_interleave(starts, kk))
        cells = (y0[e] + o // nx[e]) * w_pad + x0[e] + o % nx[e]
        states[0].view(-1).index_add_(0, cells, f0[e])
        if len(states) == 2:
            states[1].view(-1).index_add_(
                0, cells, torch.ones(len(e), dtype=torch.float32, device=dev))
        a, done = b, int(ends[b - 1])


def rect_walk_counts(params: torch.Tensor, bids: torch.Tensor, th: int,
                     wt: int, ncb: int, nb_total: int) -> tuple[int, int]:
    """What K3's walk does on these entries: (records, hits). An entry
    leaves one record in every band of RECT_BAND_ROWS rows x 128 columns
    of its tile that its rectangle meets; a warp walks one hit per row of
    a record that meets its 32 columns."""
    b = bids.long()[:, None]
    run = (b >= 0) & (b < nb_total)
    r0, c0 = b // ncb * th, b % ncb * wt
    # the rectangle cut to its tile, relative to the tile's corner
    x0 = torch.maximum(params[:, 0].long(), c0) - c0
    x1 = torch.minimum(params[:, 1].long(), c0 + wt - 1) - c0
    y0 = torch.maximum(params[:, 2].long(), r0) - r0
    y1 = torch.minimum(params[:, 3].long(), r0 + th - 1) - r0
    live = run & (x0 <= x1) & (y0 <= y1)

    def spans(lo, hi, step):
        return torch.where(live, hi // step - lo // step + 1, 0)

    records = spans(y0, y1, RECT_BAND_ROWS) * spans(x0, x1, SLICE_COLS)
    hits = torch.where(live, y1 - y0 + 1, 0) * spans(x0, x1, WARP_COLS)
    return int(records.sum()), int(hits.sum())

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
    WeightedAverage), 1.0 to field 1. Padding is the empty interval
    ax = 1 > bx = 0; runs with bids outside [0, nb_total) are skipped.
  * What bounds it on the card: each warp scans every entry of its tile's
    run (a ballot per 32 entries) and walks its hits, each a dependent
    shared-memory read-modify-write per cell, so the time follows the
    entries per tile, not bytes.
  * What the design does about it: it gives up the TPU's evaluation of
    every entry over the whole 128 x 128 tile (cheap only on the MXU).
    Threads own fixed cells of a 32-row slice of the tile (one CTA per
    slice, so a tile fills 4 SMs), held in shared memory; a warp ballots
    32 entries at a time against its 32-column x 8-row block and adds
    only its hits. Each cell gets its terms in entry order from one
    thread, with no atomics.

The states are updated IN PLACE. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gauss_kernels import _PLAIN_BUDGET, _check, _entries, _launch, _tiles
from .kernels import BLOCK

__all__ = ["rect_splat", "rect_splat_plain"]

_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.pcr_rect_splat.argtypes = [vp, vp, i64, vp, vp] + [i32] * 6 + [vp]
        lib.pcr_rect_splat.restype = i32
        lib.pcr_rect_splat_block.argtypes = []
        lib.pcr_rect_splat_block.restype = i32
        if lib.pcr_rect_splat_block() != BLOCK:
            raise RuntimeError("rect_splat: kernel block size differs from "
                               "kernels.BLOCK")
        _BOUND = lib
    return _BOUND


def rect_splat(states, params: torch.Tensor, bids: torch.Tensor, *, th: int,
               wt: int) -> None:
    """K3: fold every entry's rectangle, cut to its tile, into `states`, in
    place (1 field: Sum / Count; 2: Average / WeightedAverage)."""
    dev = _check("rect_splat", states, params, bids, th, wt, 5, torch.int32)
    if dev.type == "cpu":
        rect_splat_plain(states, params, bids, th=th, wt=wt)
        return
    _, w_pad, ncb, nb_total = _tiles(states, wt, th)
    _launch("rect_splat", _lib().pcr_rect_splat, states, params, bids,
            [th, wt, ncb, nb_total, w_pad])
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

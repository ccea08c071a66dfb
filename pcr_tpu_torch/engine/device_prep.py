"""
Glyph expansion and tile layout on the device, for host-sourced ingest.

The counterpart of pcr_tpu/engine/device_prep.py. The host ships one
compact record per point (the "wire"; TorchEngine builds it) and these
functions build, from it, the kernel layout the host route builds with
`halo_copies` + `layout_tiles` (engine/torch_backend.py): a packed
(nsub, nseg, BLOCK) int32 `params` and its ascending tile ids `bids`. The
layout is the host route's byte for byte, padding included, so the band of
a device-laid chunk carries the same bits as the band of a host-laid one
and no caller can tell the routes apart.

What is carried over from the JAX module is what it computes: the halo
copies of each point over the (row block x column block) tiles its window
meets (`_halo_expand`, :187), the grouping by one stable sort by tile id
(`aligned_sorted_planes`, :112), the closed-form Bresenham runs of a line
from its integer endpoints and their clip to the grid and the home tile
(`line_wire_builder`, :551-622). What the TPU shaped is not: shapes are
dynamic here, so there is no static kmax expansion with dead slots, no
pad region, no power-of-two ladder and no scatter + cumsum stand-in for
gathers; each tile's run is rounded up to whole sub-chunks from a count of
its entries. The wire is exact (no u16 sub-cell offsets, no delta codes).

Everything here is a plain function on tensors of one device, the card's
or (under PCR_TORCH_DEVICE=cpu) the CPU's. Every step is a stable sort, an
integer prefix sum, an integer count, `repeat_interleave`, a gather, or a
scatter to distinct addresses: no float is added anywhere, so a rerun
gives the same bytes. The sizes that shape a tensor come back to the host
(`int(...)`): two synchronisations a Gaussian or Line chunk (entries,
sub-chunks) and one a Point chunk.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .kernels import BLOCK

__all__ = ["DEAD16", "pack16", "unpack16", "halo_expand", "device_layout",
           "point_entries", "gauss_entries", "gauss_finish", "rotp_finish",
           "line_runs_device", "line_finish", "timeline", "mark"]

DEAD16 = -32768    # the int16 that marks an invalid line (iy0)

_marks = None      # the open timeline's list, else None


@contextlib.contextmanager
def timeline():
    """Collect (name, CUDA event) marks of the chunks laid out on the card
    inside the block: "uploaded" when the current stream has been made to
    wait for a chunk's wire, "layout" / "sort0" / "sort1" / "end" around
    device_layout and its sort. From "uploaded" to "layout" is the
    expansion, "sort0" to "sort1" the sort, the rest the finish. For one
    thread that measures; nothing is recorded outside such a block."""
    global _marks
    _marks = marks = []
    try:
        yield marks
    finally:
        _marks = None


def mark(name: str, device) -> None:
    if _marks is not None and device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _marks.append((name, ev))


def pack16(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host side: two integer arrays in [-32768, 32767] as the high and
    low halves of one int32 word."""
    return (((np.asarray(hi).astype(np.int64) & 0xFFFF) << 16)
            | (np.asarray(lo).astype(np.int64) & 0xFFFF)).astype(
                np.uint32).view(np.int32)


def unpack16(w: torch.Tensor):
    """(high, low) halves of int32 words, sign-extended, as int64."""
    w = w.long()
    return w >> 16, ((w & 0xFFFF) ^ 0x8000) - 0x8000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _bits(t: torch.Tensor, fill):
    """An int32 view of an int32 or float32 plane, and its fill's bits."""
    if t.dtype == torch.float32:
        return t.view(torch.int32), int(np.float32(fill).view(np.int32))
    if t.dtype != torch.int32:
        raise ValueError(f"device_layout: plane of dtype {t.dtype}")
    return t, int(fill)


def halo_expand(rb0, rb1, cb0, cb1, ncb: int):
    """One entry per (row block, column block) tile of the inclusive
    ranges [rb0, rb1] x [cb0, cb1] of each item, row-major within an item,
    items in order (torch_backend.halo_copies on tensors). An item with an
    empty range gets no entry. Returns (idx, eb): the item and the tile id
    of every entry, int64."""
    dev = rb0.device
    kc = (cb1 - cb0 + 1).clamp(min=0)
    k = (rb1 - rb0 + 1).clamp(min=0) * kc
    total = int(k.sum())
    idx = torch.repeat_interleave(
        torch.arange(k.numel(), device=dev), k, output_size=total)
    o = torch.arange(total, device=dev) - (torch.cumsum(k, 0) - k)[idx]
    kc_e = kc[idx]
    eb = (rb0[idx] + _fdiv(o, kc_e)) * ncb + cb0[idx] + o % kc_e
    return idx, eb


def device_layout(eb, planes, nblocks: int, fills, idx=None):
    """Bucket entries by tile id `eb` (int64, in [0, nblocks)) into
    BLOCK-entry sub-chunks: each tile's run rounded up to whole sub-chunks
    and padded with the planes' fill values, tiles ascending, entry order
    kept within a tile (the sort is stable). Entry k takes plane values
    from item idx[k], or from item k when `idx` is None. `planes` are
    int32 or float32 tensors, `fills` one number each. An empty chunk is
    one sub-chunk of fills for tile 0.

    Returns (params (nsub, nseg, BLOCK) int32, bids (nsub,) int32): the
    bytes torch_backend.layout_tiles packs on the host."""
    dev = eb.device
    mark("layout", dev)
    nseg = len(planes)
    counts = torch.bincount(eb, minlength=nblocks)
    subs = _fdiv(counts + (BLOCK - 1), BLOCK)
    total = int(subs.sum())
    nsub = max(total, 1)
    mark("sort0", dev)
    tile, order = torch.sort(eb, stable=True)
    mark("sort1", dev)
    run0 = (torch.cumsum(subs, 0) - subs) * BLOCK   # first slot of a run
    start = torch.cumsum(counts, 0) - counts    # first sorted entry of it
    slot = (run0 - start)[tile] + torch.arange(eb.numel(), device=dev)
    # slot -> word of segment 0 in the sub-chunk-major buffer
    word = _fdiv(slot, BLOCK) * (nseg * BLOCK) + slot % BLOCK
    src = order if idx is None else idx[order]
    del tile, order, slot
    params = torch.empty((nsub, nseg, BLOCK), dtype=torch.int32, device=dev)
    flat = params.view(-1)
    for g, (plane, fill) in enumerate(zip(planes, fills)):
        bits, fill = _bits(plane, fill)
        params[:, g] = fill
        flat[word + g * BLOCK] = bits[src]
    if total:
        bids = torch.repeat_interleave(
            torch.arange(nblocks, dtype=torch.int32, device=dev), subs,
            output_size=total)
    else:
        bids = torch.zeros(1, dtype=torch.int32, device=dev)
    mark("end", dev)
    return params, bids


def point_entries(col, row, th: int, wt: int, ncb: int):
    """Tile id of each Point entry: one per point, invalid points
    (col = row = -1) in tile 0 (TorchEngine.prepare_point)."""
    return (_fdiv(row.long().clamp(min=0), th) * ncb
            + _fdiv(col.long().clamp(min=0), wt))


def gauss_entries(icx, icy, r, valid, th: int, wt: int, nrb: int, ncb: int):
    """Halo copies of Gaussian points over the (th, wt) tiles their +-r
    windows meet, clamped to the grid's tiles; an invalid point keeps one
    copy in tile 0 (TorchEngine.prepare_gaussian). icx, icy, r are int64.
    Returns halo_expand's (idx, eb)."""
    def rng(c, k, lim):
        return torch.where(valid, _fdiv(c, k).clamp(0, lim - 1), 0)
    return halo_expand(rng(icy - r, th, nrb), rng(icy + r, th, nrb),
                       rng(icx - r, wt, ncb), rng(icx + r, wt, ncb), ncb)


def gauss_finish(kind: str, icx, icy, sub_cx, sub_cy, sx, sy, r, f0, valid,
                 coef=None):
    """Per-point planes and fills of a K2 ("gauss") or K4 ("rot") chunk
    from the decoded wire: icx, icy, r int64; sub_cx, sub_cy, sx, sy, f0
    float32; `coef` the three completed-square coefficients every point of
    a K4 chunk shares (tiling.rot_quadratic_segs on the uniform shape).
    Invalid points keep their data and get r = -1."""
    r = torch.where(valid, r, -1)
    if kind == "gauss":
        return ([icx.int(), icy.int(), sub_cx, sub_cy, sx, sy, r.int(), f0],
                [0, 0, 0, 0, 1.0, 1.0, -1, 0])
    shared = [torch.full_like(sub_cx, float(c)) for c in coef]
    return ([sub_cx, sub_cy, *shared, f0, icx.float(), icy.float(),
             r.float()],
            [0.0] * 8 + [-1.0])


def rotp_finish(icx, icy, sub_cx, sub_cy, r, f0, valid, coef, W: int,
                H: int, tile_w: int, tile_h: int, multi_tile: bool, th: int,
                wt: int, ncb: int, row_offset: int = 0,
                global_h: int | None = None):
    """(eb, planes, fills, idx) of a K5 ("rotp") chunk from the decoded
    wire (TorchEngine._prepare_rotp on tensors): each point's +-r window
    clipped to the grid and, on a multi-tile grid, to its home tile (in
    the frame of a row-offset view: rows [row_offset, row_offset + H) of
    `global_h`, as TorchEngine._prepare_rotp); one entry per (th, wt) tile
    a live window meets, none for a dead one. `coef` as in gauss_finish;
    icx, icy, r int64 (icy in the view's rows)."""
    r = torch.where(valid, r, -1)
    W1, H1 = W - 1, H - 1
    wlo, whi = (icx - r).clamp(min=0), (icx + r).clamp(max=W1)
    rlo, rhi = (icy - r).clamp(min=0), (icy + r).clamp(max=H1)
    if multi_tile:
        cs = _fdiv(icx.clamp(0, W1), tile_w) * tile_w
        Hg1 = (global_h or H) - 1
        rs = _fdiv((icy + row_offset).clamp(0, Hg1), tile_h) * tile_h
        wlo = torch.maximum(wlo, cs)
        whi = torch.minimum(whi, (cs + tile_w - 1).clamp(max=W1))
        rlo = torch.maximum(rlo, rs - row_offset)
        rhi = torch.minimum(rhi, (rs + tile_h - 1).clamp(max=Hg1)
                            - row_offset)
    alive = (valid & (wlo <= whi) & (rlo <= rhi) & (rlo <= H1) & (rhi >= 0))
    rlo, rhi = rlo.clamp(0, H1), rhi.clamp(0, H1)
    idx, eb = halo_expand(_fdiv(rlo, th),
                          torch.where(alive, _fdiv(rhi, th), -1),
                          _fdiv(wlo, wt), _fdiv(whi, wt), ncb)
    shared = [torch.full_like(sub_cx, float(c)) for c in coef]
    planes = [sub_cx, sub_cy, *shared, f0, wlo.float(), whi.float(),
              rlo.float(), rhi.float(), icx.float(), icy.float()]
    fills = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    return eb, planes, fills, idx


def line_runs_device(e0, e1, nruns_total: int, W: int, H: int,
                     tile_w: int, tile_h: int, ctr=None):
    """The Bresenham runs of lines from their integer endpoints, clipped to
    the grid and each line's home tile: routing.line_rects on tensors.

    e0 = (ix0, iy0) and e1 = (ix1, iy1) are int16-pair words, iy0 = DEAD16
    marking an invalid line; `nruns_total` is the runs of the valid lines
    (the host counted them); `ctr` the owners' (col, row) words on a
    multi-tile grid, None where the grid is one tile. Returns (ax, bx, ay,
    by, owner, keep): every run in (line, staircase) order with its
    inclusive rectangle, int64, and `keep`, false where the clip left no
    cell (such a run gets no entry)."""
    dev = e0.device
    ix0, iy0 = unpack16(e0)
    ix1, iy1 = unpack16(e1)
    live = iy0 != DEAD16
    ddx, ddy = (ix1 - ix0).abs(), (iy1 - iy0).abs()
    nruns = torch.where(live, torch.minimum(ddx, ddy) + 1, 0)
    owner = torch.repeat_interleave(
        torch.arange(nruns.numel(), device=dev), nruns,
        output_size=nruns_total)
    j = (torch.arange(nruns_total, device=dev)
         - (torch.cumsum(nruns, 0) - nruns)[owner])
    ix0, iy0, ix1, iy1 = ix0[owner], iy0[owner], ix1[owner], iy1[owner]
    ddx, ddy = ddx[owner], ddy[owner]
    xmaj = ddx >= ddy
    dmaj = torch.where(xmaj, ddx, ddy)
    dmin = torch.where(xmaj, ddy, ddx)
    safe = dmin.clamp(min=1)
    # staircase run j covers the major steps [k0(j), k0(j + 1) - 1]
    k0 = torch.where(j > 0, _fdiv(dmaj * (2 * j - 1), 2 * safe) + 1, 0)
    k1 = torch.where(j < dmin, _fdiv(dmaj * (2 * j + 1), 2 * safe), dmaj)
    sx = torch.where(ix0 < ix1, 1, -1)
    sy = torch.where(iy0 < iy1, 1, -1)
    maj0 = torch.where(xmaj, ix0, iy0)
    smaj = torch.where(xmaj, sx, sy)
    p0, p1 = maj0 + smaj * k0, maj0 + smaj * k1
    lo, hi = torch.minimum(p0, p1), torch.maximum(p0, p1)
    minor = torch.where(xmaj, iy0, ix0) + torch.where(xmaj, sy, sx) * j
    ax, bx = torch.where(xmaj, lo, minor), torch.where(xmaj, hi, minor)
    ay, by = torch.where(xmaj, minor, lo), torch.where(xmaj, minor, hi)
    if ctr is None:
        cs = rs = 0
        ce, re = W, H
    else:
        ocol, orow = unpack16(ctr[owner])
        cs = _fdiv(ocol, tile_w) * tile_w
        ce = (cs + tile_w).clamp(max=W)
        rs = _fdiv(orow, tile_h) * tile_h
        re = (rs + tile_h).clamp(max=H).clamp(0, H)
        rs = rs.clamp(0, H)
    ax, bx = torch.clamp(ax, min=cs), torch.clamp(bx, max=ce - 1)
    ay, by = torch.clamp(ay, min=rs), torch.clamp(by, max=re - 1)
    return ax, bx, ay, by, owner, (ax <= bx) & (ay <= by)


def line_finish(ax, bx, ay, by, owner, keep, f0, th: int, wt: int, ncb: int):
    """(eb, planes, fills, idx) of a K3 chunk from line_runs_device's runs:
    one entry per (th, wt) tile a kept run spans; `f0` is per line. The
    fills make padding an empty interval (ax = 1 > bx = 0)."""
    rb0 = _fdiv(ay, th)
    rb1 = torch.where(keep, _fdiv(by, th), rb0 - 1)
    idx, eb = halo_expand(rb0, rb1, _fdiv(ax, wt), _fdiv(bx, wt), ncb)
    return (eb, [ax.int(), bx.int(), ay.int(), by.int(), f0[owner]],
            [1, 0, 1, 0, 0], idx)

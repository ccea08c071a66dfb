"""
Multi-device ingest over a ('dp', 'sp') mesh of torch devices — the port's
counterpart of pcr_tpu/parallel/sharding.py.

One process drives every device, as pcr_tpu's shard_map programs do; there
is no process group and no collective library. A mesh is a dp x sp grid of
`torch.device`s, and a device may fill several cells (one card then runs
them in turn), so a mesh of any shape runs on one card:

  * ``sp`` splits the grid state into row blocks. Block s lives on its
    owner, ``mesh.devices[0][s]``; cells are owned exclusively, so the sp
    axis needs no merge.
  * ``dp`` splits the points contiguously. Cell (d, s) accumulates its
    points' contributions to block s from the merge's identity on
    ``mesh.devices[d][s]``; `merge_deltas` then copies each result to the
    owner (`to_device`: an event on the source's stream orders the copy)
    and folds them in there in dp order: state + ((δ0 + δ1) + ...) for the
    sum family, elementwise max / min, and for MostRecent the greatest
    timestamp, the lowest dp index among equals and the existing state on
    ties.

State is a tuple, one entry per field, of lists of the sp row blocks
(`replicate_state`; `gather_state` joins them). pcr_tpu replicates every
block over dp; here the owner keeps the only copy, since every dp merge
lands there and nothing reads a replica.

The step builders are pcr_tpu's XLA programs as torch ops: the
contractions run torch.matmul in full float32 (never TF32), sum scatters
run `index_put_(accumulate=True)` with deterministic algorithms switched
on around the call (each cell's terms added in order; no float atomics),
max / min scatters `scatter_reduce`. Reruns are bit-identical. The
Pipeline's mesh engines (parallel/engine.py) run kernels K1-K5 per shard
instead; these steps are the library-level building blocks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.device import cuda_device_count, device_override
from ..core.types import ReductionType
from ..engine.torch_backend import _argmax_ts_update, _scatter_minmax
from ..ops.reduction import FLT_MAX, ReductionInfo

__all__ = ["Mesh", "available_devices", "make_mesh", "replicate_state",
           "gather_state", "shard_points", "to_device", "merge_deltas",
           "sharded_point_step", "sharded_gaussian_step",
           "sharded_gaussian_rotated_step", "sharded_line_step"]


class Mesh:
    """A (dp, sp) grid of torch devices: `devices[d][s]` runs mesh cell
    (d, s), `devices[0][s]` owns row block s; `shape` is
    {"dp": dp, "sp": sp}, as on a jax Mesh."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "sp": devices.shape[1]}


def available_devices(n: int | None = None) -> list[torch.device]:
    """The devices a mesh takes when the caller names none: every CUDA
    device, or, under PCR_TORCH_DEVICE, that device `n` times (once when
    `n` is None), as pcr_tpu's tests force 8 host devices."""
    ov = device_override()
    if ov is not None:
        return [ov] * (n or 1)
    return [torch.device("cuda", i) for i in range(cuda_device_count())]


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None):
    """A ('dp', 'sp') Mesh over `devices` (by default available_devices()),
    all on the dp axis unless `dp` / `sp` say otherwise; dp * sp must equal
    the device count."""
    devs = [torch.device(d) for d in (
        devices if devices is not None else available_devices())]
    n = len(devs)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) != devices({n})")
    arr = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devs):
        arr[i // sp, i % sp] = d
    return Mesh(arr)


def _local_rows(H: int, mesh: Mesh) -> int:
    sp = mesh.shape["sp"]
    if H % sp:
        raise ValueError(f"grid height {H} not divisible by sp={sp}")
    return H // sp


def replicate_state(mesh: Mesh, states, H: int, W: int):
    """Per field, the sp row blocks of an (H, W) array, block s on its
    owner mesh.devices[0][s] (float32 copies)."""
    lh = _local_rows(H, mesh)
    out = []
    for f in states:
        a = torch.as_tensor(np.asarray(f, np.float32).reshape(H, W))
        out.append([a[s * lh:(s + 1) * lh].to(mesh.devices[0][s], copy=True)
                    for s in range(mesh.shape["sp"])])
    return tuple(out)


def gather_state(states):
    """Per field, the (H, W) host tensor its row blocks make up."""
    return tuple(torch.cat([b.cpu() for b in blocks]) for blocks in states)


def shard_points(mesh: Mesh, *arrays):
    """Per array, its dp contiguous pieces (np.array_split), piece d on
    mesh.devices[d][0]; the steps move a piece to each cell that reads
    it."""
    dp = mesh.shape["dp"]
    return tuple(
        [torch.as_tensor(np.ascontiguousarray(p)).to(mesh.devices[d][0])
         for d, p in enumerate(np.array_split(np.asarray(a), dp))]
        for a in arrays)


def to_device(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """`t` on `dst`: the one place a merge crosses devices. On a card the
    copy is ordered after an event recorded on the source's current
    stream, which the destination's stream waits for; on the same device
    it is `t` itself. A copy to the host blocks: a non-blocking one would
    hand back pinned memory the card has not yet written."""
    if t.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        if dst.type == "cuda":
            torch.cuda.current_stream(dst).wait_event(ev)
    return t.to(dst, non_blocking=dst.type == "cuda")


def merge_deltas(kind: str, state, deltas) -> None:
    """Fold the dp cells' results `deltas` (each a list of fields, in dp
    order, on any device) into `state` (the owner's fields), in place:
    'sum' state + ((δ0 + δ1) + ...); 'max' / 'min' elementwise;
    'argmax_ts' (value, timestamp) pairs: the greatest timestamp wins, the
    lowest dp index among equals, and the state wins ties (pcr_tpu's
    `take = gm > cur_t`)."""
    owner = state[0].device
    moved = [[to_device(f, owner) for f in d] for d in deltas]
    if kind == "sum":
        for f, st in enumerate(state):
            acc = moved[0][f]
            for m in moved[1:]:
                acc = acc + m[f]
            st.add_(acc)
    elif kind in ("max", "min"):
        op = torch.maximum if kind == "max" else torch.minimum
        acc = moved[0][0]
        for m in moved[1:]:
            acc = op(acc, m[0])
        state[0].copy_(op(state[0], acc))
    elif kind == "argmax_ts":
        cur_v, cur_t = state
        gm = moved[0][1]
        for m in moved[1:]:
            gm = torch.maximum(gm, m[1])
        gv = torch.zeros_like(cur_v)
        won = torch.zeros_like(cur_t, dtype=torch.bool)
        for v, t in moved:
            mine = (t == gm) & ~won
            gv = torch.where(mine, v, gv)
            won |= mine
        take = gm > cur_t
        cur_v.copy_(torch.where(take, gv, cur_v))
        cur_t.copy_(torch.where(take, gm, cur_t))
    else:
        raise NotImplementedError(kind)


def _ordered_add(flat: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """flat[idx] += vals with every cell's terms added in entry order:
    index_put_ under deterministic algorithms (sorted, no atomics), the
    global switch restored after the call."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        flat.index_put_((idx,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


@contextlib.contextmanager
def _full_float32():
    """torch.matmul in full float32 (pcr_tpu's Precision.HIGHEST): no TF32
    inside, the caller's settings restored after."""
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _cells(mesh: Mesh, s: int, arrays):
    """(device, the arrays' dp pieces on it) of each cell (d, s), d
    ascending."""
    for d in range(mesh.shape["dp"]):
        dev = mesh.devices[d][s]
        yield dev, [a[d].to(dev) for a in arrays]


def _fields_of(info: ReductionInfo):
    """(nf, use_val) of a glyph step: Average and WeightedAverage keep a
    value sum and a weight sum, Count weights alone, Sum values alone."""
    rtype = ReductionType(info.type)
    nf = 2 if rtype in (ReductionType.WeightedAverage,
                        ReductionType.Average) else 1
    return nf, rtype != ReductionType.Count


def _tile_clip(cfg, icx, icy):
    """Home-tile cell ranges (cs, ce, rs, re), end-exclusive, of the
    clamped centre cells (tpu_backend._device_tile_clip); a row-offset
    view's tile rows are computed in the whole grid's frame and returned
    in its own rows."""
    W = cfg.width
    off = getattr(cfg, "row_offset", 0)
    Hg = getattr(cfg, "global_height", cfg.height)
    tw, th = cfg.tile_width, cfg.tile_height
    cs = icx.clamp(0, W - 1) // tw * tw
    rs = (icy + off).clamp(0, Hg - 1) // th * th
    return cs, (cs + tw).clamp(max=W), rs - off, (rs + th).clamp(max=Hg) - off


def _blocked(arrays, block: int, what: str):
    """The per-cell arrays cut into whole blocks of `block` entries."""
    n = arrays[0].shape[0]
    if n % block:
        raise ValueError(
            f"per-shard {what} count {n} not divisible by block {block}; "
            "pad inputs to a multiple of block * mesh.shape['dp']")
    for b in range(n // block):
        yield [a[b * block:(b + 1) * block] for a in arrays]


def sharded_point_step(info: ReductionInfo, H: int, W: int, mesh: Mesh):
    """The Point-glyph ingest step over a mesh:

    f(states, rows, cols, valid, values, weights, timestamps) -> states

    states as replicate_state gives them, point arrays as shard_points
    does; the states are updated in place. Each cell (d, s) folds the
    points of its dp piece whose row lies in block s into a delta, merged
    into the block with the op's merge (merge_deltas)."""
    kind = info.scatter_kind
    lh = _local_rows(H, mesh)
    C = lh * W

    def step(states, rows, cols, valid, values, weights, timestamps):
        for s in range(mesh.shape["sp"]):
            deltas = []
            for dev, (r, c, ok, v, w, ts) in _cells(
                    mesh, s, (rows, cols, valid, values, weights, timestamps)):
                lrow = r.long() - s * lh
                mine = ok.bool() & (lrow >= 0) & (lrow < lh)
                cell = torch.where(mine, lrow * W + c.long(), C)
                fields = [f.float() for f in info.fields(
                    v.float(), w.float(), ts.float())]
                if kind == "sum":
                    sel = mine.nonzero().squeeze(1)
                    delta = []
                    for fv in fields:
                        acc = torch.zeros(C, device=dev)
                        _ordered_add(acc, cell[sel], fv[sel])
                        delta.append(acc)
                elif kind in ("max", "min"):
                    ident = -FLT_MAX if kind == "max" else FLT_MAX
                    delta = [torch.full((C,), ident, device=dev)]
                    _scatter_minmax(delta[0], cell, fields[0], C,
                                    "amax" if kind == "max" else "amin",
                                    ident)
                elif kind == "argmax_ts":
                    delta = [torch.full((C,), float(x), device=dev)
                             for x in info.identity]
                    _argmax_ts_update(delta, cell, fields[0], fields[1], C)
                else:
                    raise NotImplementedError(kind)
                deltas.append([f.view(lh, W) for f in delta])
            merge_deltas(kind, [st[s] for st in states], deltas)
        return states

    return step


def sharded_gaussian_step(info: ReductionInfo, H: int, W: int, mesh: Mesh,
                          block: int = 2048, cfg=None):
    """The separable (rotation-free) Gaussian splat over a mesh: each cell
    contracts its dp piece's row weights with its column weights, block
    by block, over the rows of block s (torch.matmul in full float32),
    and the deltas merge by sum.

    f(states, icx, icy, sub_cx, sub_cy, sx, sy, r, valid, values) -> states

    The per-cell point count must be divisible by `block`. With `cfg` (a
    GridConfig of several tiles) footprints are also clipped to each
    point's home tile, as the single-device engines clip them."""
    nf, use_val = _fields_of(info)
    lh = _local_rows(H, mesh)
    multi_tile = cfg is not None and cfg.total_tiles() > 1

    def cell_delta(dev, off, arrays):
        hs_i = (torch.arange(lh, device=dev) + off)[None, :]
        ws_i = torch.arange(W, device=dev)[None, :]
        hs, ws = hs_i.float(), ws_i.float()
        acc = [torch.zeros(lh, W, device=dev) for _ in range(nf)]
        for icx, icy, scx, scy, sx, sy, r, ok, val in _blocked(
                arrays, block, "point"):
            icx, icy, r = icx.long()[:, None], icy.long()[:, None], \
                r.long()[:, None]
            qy = ((hs - icy.float()) - scy[:, None]) / sy[:, None]
            wy = torch.exp(-0.5 * qy * qy)
            my = ((hs_i - icy).abs() <= r) & (wy >= 1e-6) & ok.bool()[:, None]
            qx = ((ws - icx.float()) - scx[:, None]) / sx[:, None]
            wx = torch.exp(-0.5 * qx * qx)
            mx = ((ws_i - icx).abs() <= r) & (wx >= 1e-6)
            if multi_tile:
                cs, ce, rs, re = _tile_clip(cfg, icx, icy)
                my &= (hs_i >= rs) & (hs_i < re)
                mx &= (ws_i >= cs) & (ws_i < ce)
            wy = torch.where(my, wy, 0.0)
            wx = torch.where(mx, wx, 0.0)
            cols = ([wx * val[:, None], wx] if nf == 2
                    else [wx * val[:, None] if use_val else wx])
            with _full_float32():
                contrib = wy.T @ torch.cat(cols, dim=1)
            for f in range(nf):
                acc[f] += contrib[:, f * W:(f + 1) * W]
        return acc

    def step(states, *arrays):
        for s in range(mesh.shape["sp"]):
            deltas = [cell_delta(dev, s * lh, a)
                      for dev, a in _cells(mesh, s, arrays)]
            merge_deltas("sum", [st[s] for st in states], deltas)
        return states

    return step


def sharded_gaussian_rotated_step(info: ReductionInfo, H: int, W: int,
                                  mesh: Mesh, rmax: int, cfg=None):
    """The exact rotated-Gaussian splat over a mesh: each cell adds its dp
    piece's weights over the (2 rmax + 1)^2 offset window (with the 1e-6
    cutoff), restricted to block s's rows, one offset at a time in order;
    the deltas merge by sum.

    f(states, icx, icy, sub_cx, sub_cy, sx, sy, cos_rot, sin_rot, r,
      valid, values) -> states"""
    nf, use_val = _fields_of(info)
    lh = _local_rows(H, mesh)
    multi_tile = cfg is not None and cfg.total_tiles() > 1

    def cell_delta(dev, off, arrays):
        icx, icy, scx, scy, sx, sy, cos_r, sin_r, r, ok, val = arrays
        icx, icy = icx.long(), icy.long()
        r = torch.where(ok.bool(), r.long(), -1)
        if multi_tile:
            cs, ce, rs, re = _tile_clip(cfg, icx, icy)
        else:
            cs, ce, rs, re = 0, W, 0, H
        acc = [torch.zeros(lh * W, device=dev) for _ in range(nf)]
        for dy in range(-rmax, rmax + 1):
            for dx in range(-rmax, rmax + 1):
                gy, gx = icy + dy, icx + dx
                rdy, rdx = float(dy) - scy, float(dx) - scx
                qx = (rdx * cos_r - rdy * sin_r) / sx
                qy = (rdx * sin_r + rdy * cos_r) / sy
                w = torch.exp(-0.5 * (qx * qx + qy * qy))
                ly = gy - off
                sel = ((w >= 1e-6) & (abs(dy) <= r) & (abs(dx) <= r)
                       & (gx >= cs) & (gx < ce) & (gy >= rs) & (gy < re)
                       & (ly >= 0) & (ly < lh)).nonzero().squeeze(1)
                cell, w = ly[sel] * W + gx[sel], w[sel]
                _ordered_add(acc[0], cell, val[sel] * w if use_val else w)
                if nf == 2:
                    _ordered_add(acc[1], cell, w)
        return [a.view(lh, W) for a in acc]

    def step(states, *arrays):
        for s in range(mesh.shape["sp"]):
            deltas = [cell_delta(dev, s * lh, a)
                      for dev, a in _cells(mesh, s, arrays)]
            merge_deltas("sum", [st[s] for st in states], deltas)
        return states

    return step


def sharded_line_step(info: ReductionInfo, H: int, W: int, mesh: Mesh,
                      block: int = 2048):
    """The Line-glyph splat over a mesh, in rect form: lines decompose on
    the host into their exact Bresenham runs (routing.line_rects); each
    cell contracts its dp piece's rectangles, as interval x interval
    factors, over block s's rows (torch.matmul in full float32), and the
    deltas merge by sum.

    f(states, ax, bx, ay, by, valid, values) -> states

    ax / bx / ay / by are inclusive cell intervals; an empty one (ax > bx)
    is inert, so padding needs no mask. The per-cell count must be
    divisible by `block`."""
    nf, use_val = _fields_of(info)
    lh = _local_rows(H, mesh)

    def cell_delta(dev, off, arrays):
        hs_i = (torch.arange(lh, device=dev) + off)[None, :]
        ws_i = torch.arange(W, device=dev)[None, :]
        acc = [torch.zeros(lh, W, device=dev) for _ in range(nf)]
        for ax, bx, ay, by, ok, val in _blocked(arrays, block, "rect"):
            wy = ((hs_i >= ay.long()[:, None]) & (hs_i <= by.long()[:, None])
                  & ok.bool()[:, None]).float()
            wx = ((ws_i >= ax.long()[:, None])
                  & (ws_i <= bx.long()[:, None])).float()
            cols = ([wx * val[:, None], wx] if nf == 2
                    else [wx * val[:, None] if use_val else wx])
            with _full_float32():
                contrib = wy.T @ torch.cat(cols, dim=1)
            for f in range(nf):
                acc[f] += contrib[:, f * W:(f + 1) * W]
        return acc

    def step(states, *arrays):
        for s in range(mesh.shape["sp"]):
            deltas = [cell_delta(dev, s * lh, a)
                      for dev, a in _cells(mesh, s, arrays)]
            merge_deltas("sum", [st[s] for st in states], deltas)
        return states

    return step

"""
Kernel K1 — the sorted point splat: its wrapper, its plain PyTorch version
and its launch counter.

K1 replaces the point mode of
`pcr_tpu/engine/pallas_kernels.py::build_sorted_splat_pallas` (two_d=True;
the point parts at :537-559, :671-687, :742-749), which the TPU engine runs
for every sum-family Point reduction (Sum, Count, Average,
WeightedAverage). The CUDA source is `csrc/sorted_splat_point.cu`; its
header comment has the design. In short:

  * Contract (unchanged from the TPU kernel): `params` (nsub, 3|4, BLOCK)
    int32 `[icx | icy | f0 bits | (f1 bits)]`, `bids` (nsub,) int32
    ascending tile ids `row_block * ncb + col_block` over (th, wt) tiles of
    the (H_pad, W_pad) state fields. Live entries fold f0 into field 0 and
    f1 (or 1.0 for Average) into field 1; entries outside their tile are
    dead; runs with bids outside [0, nb_total) are skipped.
  * What bounds it on the card: per sub-chunk the work in shared memory
    (ranking the entries by owner and folding them), not the 12-16 B of
    device memory read per entry; and how many SMs the sub-chunks spread
    over.
  * What the design does about it: it gives up the TPU's one-hot matmul
    (the TPU has no scatter) and its float-atomic alternative (reruns would
    differ in the last bits). Each tile's run is cut into groups of
    consecutive sub-chunks (a function of `bids` and nsub alone); a CTA
    folds a group into its slice of the tile held in shared memory
    (`slice_rows` rows), each cell owned by one warp, which sums the
    cell's terms in an order fixed by the input, so reruns are
    bit-identical. A run's only group adds its slice to the state; groups
    of a run with more than one write their partial tile into scratch,
    and a second pass adds the partials to the state in group order.

The states are updated IN PLACE. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .tiling import col_tile, padded_width  # noqa: F401

__all__ = ["BLOCK", "TH", "col_tile", "padded_width", "k1_group_size",
           "slice_rows", "sorted_splat_point", "sorted_splat_point_plain"]

TH = 128        # tile rows (the TPU's GAUSS_ROW_BLOCK)
BLOCK = 2048    # entries per sub-chunk (the TPU's PALLAS_BLOCK)
GROUP_MIN = 4           # fewest sub-chunks in a full group
GROUP_TARGET = 132      # about this many groups on few tiles, whatever nsub
TILE_BYTES = 192 << 10  # shared memory for one CTA's slice of a tile
COUNT16_GROUP_MAX = 31  # 16-bit counts hold a group: 31 * 2048 < 65536

_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pcr_sorted_splat_point.argtypes = [
            vp, vp, ctypes.c_int64, vp, vp, vp] + [i32] * 10 + [vp]
        lib.pcr_sorted_splat_point.restype = i32
        lib.pcr_sorted_splat_point_block.argtypes = []
        lib.pcr_sorted_splat_point_block.restype = i32
        if lib.pcr_sorted_splat_point_block() != BLOCK:
            raise RuntimeError("sorted_splat_point: kernel block size "
                               "differs from kernels.BLOCK")
        _BOUND = lib
    return _BOUND


def k1_group_size(nsub: int) -> int:
    """Sub-chunks per full group of K1's first pass, from nsub alone: at
    least GROUP_MIN, and large enough that a run of all nsub sub-chunks
    makes about GROUP_TARGET groups (which bounds the scratch and the
    second pass's reads)."""
    return max(GROUP_MIN, -(-int(nsub) // GROUP_TARGET))


def slice_rows(th: int, wt: int, cell_bytes: int) -> int:
    """Tile rows per CTA of K1's first pass: th halved until the slice
    (cell_bytes a cell: 4 per float32 field, 6 for Average's float32 sum
    and 16-bit count) fits TILE_BYTES of shared memory. A 128 x 256 tile
    fits whole with one field or Average's pair, in halves with two."""
    rs = th
    while cell_bytes * rs * wt > TILE_BYTES and rs % 2 == 0:
        rs //= 2
    if cell_bytes * rs * wt > TILE_BYTES:
        raise ValueError(f"sorted_splat_point: a ({th}, {wt}) tile has no "
                         f"row slice that fits {TILE_BYTES} B of shared "
                         f"memory")
    return rs


def _check(states, params, bids, th: int, wt: int, with_f1: bool) -> None:
    if len(states) not in (1, 2) or (with_f1 and len(states) != 2):
        raise ValueError("sorted_splat_point: 1 state field, or 2 "
                         "(with_f1 needs 2)")
    dev = states[0].device
    shape = states[0].shape
    for s in states:
        if (s.dtype != torch.float32 or s.device != dev or s.shape != shape
                or s.dim() != 2 or not s.is_contiguous()):
            raise ValueError("sorted_splat_point: states must be contiguous "
                             "float32 (H_pad, W_pad) fields on one device")
    if shape[0] % th or shape[1] % wt:
        raise ValueError(f"sorted_splat_point: state {tuple(shape)} is not "
                         f"a whole number of ({th}, {wt}) tiles")
    if (params.dtype != torch.int32 or params.dim() != 3
            or params.shape[1] != 3 + int(with_f1)
            or not params.is_contiguous() or params.device != dev):
        raise ValueError("sorted_splat_point: params must be contiguous "
                         "int32 (nsub, 3|4, block) on the states' device")
    if (bids.dtype != torch.int32 or bids.shape != (params.shape[0],)
            or not bids.is_contiguous() or bids.device != dev):
        raise ValueError("sorted_splat_point: bids must be contiguous int32 "
                         "(nsub,) on the states' device")


def sorted_splat_point(states, params: torch.Tensor, bids: torch.Tensor, *,
                       th: int, wt: int, with_f1: bool,
                       group: int | None = None) -> None:
    """K1: fold every live entry of `params` into `states`, in place.
    `group` (sub-chunks per full group, k1_group_size(nsub) by default)
    is there to time other groupings; every grouping gives the same
    result up to the order of float32 sums."""
    _check(states, params, bids, th, wt, with_f1)
    dev = states[0].device
    if dev.type == "cpu":
        sorted_splat_point_plain(states, params, bids, th=th, wt=wt,
                                 with_f1=with_f1)
        return
    if dev.type != "cuda":
        raise ValueError(f"sorted_splat_point: no kernel for {dev.type} "
                         f"tensors")
    if params.shape[2] != BLOCK:
        raise ValueError(f"sorted_splat_point: the kernel takes "
                         f"{BLOCK}-entry sub-chunks, got {params.shape[2]}")
    lib = _lib()
    h_pad, w_pad = states[0].shape
    ncb = w_pad // wt
    nsub = params.shape[0]
    group = int(group or k1_group_size(nsub))
    nf = len(states)
    count16 = nf == 2 and not with_f1 and group <= COUNT16_GROUP_MAX
    # two scratch tiles per block of `group` sub-chunks (slots 2b and
    # 2b + 1, see the CUDA source): at the default group, at most
    # 2 * GROUP_TARGET tiles a field (34.6 MB of 128 x 256 float32 tiles)
    scratch = torch.empty(2 * -(-nsub // group) * len(states) * th * wt,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcr_sorted_splat_point(
            params.data_ptr(), bids.data_ptr(), nsub,
            states[0].data_ptr(),
            states[1].data_ptr() if len(states) == 2 else None,
            scratch.data_ptr(), nf, int(with_f1), int(count16), th, wt, ncb,
            h_pad // th * ncb, w_pad,
            slice_rows(th, wt, 6 if count16 else 4 * nf), group,
            stream)
    if err != 0:
        raise RuntimeError(f"sorted_splat_point: launch failed "
                           f"(cudaError {err})")
    sorted_splat_point.launches += 1


sorted_splat_point.launches = 0


def sorted_splat_point_plain(states, params: torch.Tensor,
                             bids: torch.Tensor, *, th: int, wt: int,
                             with_f1: bool) -> None:
    """K1's plain PyTorch version: the same function through `index_add_`
    into the flattened fields, in place. On the CPU `index_add_` adds in
    index order, so reruns are bit-identical there; on CUDA it is atomic
    and serves only as the reference the kernel is held against."""
    h_pad, w_pad = states[0].shape
    ncb = w_pad // wt
    bid = bids.long()[:, None]
    row0 = bid // ncb * th
    col0 = bid % ncb * wt
    icx = params[:, 0].long()
    icy = params[:, 1].long()
    live = ((bid >= 0) & (bid < h_pad // th * ncb)
            & (icy >= row0) & (icy < row0 + th)
            & (icx >= col0) & (icx < col0 + wt))
    cells = (icy * w_pad + icx)[live]
    states[0].view(-1).index_add_(0, cells,
                                  params[:, 2].view(torch.float32)[live])
    if len(states) == 2:
        f1 = (params[:, 3].view(torch.float32)[live] if with_f1
              else torch.ones(cells.shape, dtype=torch.float32,
                              device=cells.device))
        states[1].view(-1).index_add_(0, cells, f1)

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
  * What bounds it on the card: one CTA owns one tile's run and walks its
    sub-chunks in order, so a grid with few tiles uses few of the 132 SMs;
    per sub-chunk the block radix sort in shared memory sets the time, not
    the 12-16 B of device memory read per entry.
  * What the design does about it: it gives up the TPU's one-hot matmul
    (the TPU has no scatter) and its float-atomic alternative (reruns would
    differ in the last bits): a stable sort by cell plus one fixed-order
    sum per cell keeps reruns bit-identical, and only one 2048-entry
    sub-chunk, not the tile, lives in shared memory.

The states are updated IN PLACE. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pcr_tpu.engine.pallas_kernels import col_tile, padded_width  # noqa: F401

from . import _build

__all__ = ["BLOCK", "TH", "col_tile", "padded_width", "sorted_splat_point",
           "sorted_splat_point_plain"]

TH = 128        # tile rows (the TPU's GAUSS_ROW_BLOCK)
BLOCK = 2048    # entries per sub-chunk (the TPU's PALLAS_BLOCK)

_BOUND = None


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pcr_sorted_splat_point.argtypes = [
            vp, vp, ctypes.c_int64, vp, vp] + [i32] * 8 + [vp]
        lib.pcr_sorted_splat_point.restype = i32
        lib.pcr_sorted_splat_point_block.argtypes = []
        lib.pcr_sorted_splat_point_block.restype = i32
        if lib.pcr_sorted_splat_point_block() != BLOCK:
            raise RuntimeError("sorted_splat_point: kernel block size "
                               "differs from kernels.BLOCK")
        _BOUND = lib
    return _BOUND


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
                       th: int, wt: int, with_f1: bool) -> None:
    """K1: fold every live entry of `params` into `states`, in place."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pcr_sorted_splat_point(
            params.data_ptr(), bids.data_ptr(), params.shape[0],
            states[0].data_ptr(),
            states[1].data_ptr() if len(states) == 2 else None,
            len(states), int(with_f1), th, wt, ncb, h_pad // th * ncb,
            w_pad, (th * wt).bit_length(), stream)
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

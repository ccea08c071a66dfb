"""
Grid state merge — init / merge / finalize of reduction state buffers.

The port's copy of pcr_tpu/engine/grid_merge.py, the rebuild of the
reference's grid_merge component (include/pcr/engine/grid_merge.h:22-41,
src/engine/grid_merge.cu:16-183): element-wise operations over
band-sequential state buffers, used for combining independently
accumulated state (chunked runs, multiple collections, the bands of an
out-of-core run). Works on host numpy arrays or torch tensors on any
device: the ReductionInfo vectorized plans dispatch on the array type
(ops/reduction.py, `_xp`).

Because every registered op's merge is associative and commutative
(builtin_ops.h merge functions), merging is order-free.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ReductionType
from ..ops.reduction import get_reduction_info

__all__ = ["init_state", "merge_state", "finalize_state"]


def _info(rtype: ReductionType):
    info = get_reduction_info(rtype)
    if info is None:
        raise ValueError(f"unregistered reduction {rtype}")
    return info


def init_state(rtype: ReductionType, shape, device=None):
    """Fresh identity-filled state fields (list of float32 arrays)
    (reference: grid_merge.h init_grid_state): numpy, or torch tensors on
    `device` where one is named."""
    info = _info(rtype)
    if device is None:
        return info.init_state(shape)
    return [torch.full(tuple(shape), float(info.identity[f]),
                       dtype=torch.float32, device=device)
            for f in range(info.state_floats)]


def merge_state(rtype: ReductionType, dst, src):
    """Merge src state into dst state element-wise; returns the merged
    fields (reference: grid_merge.h merge_grid_state). dst/src are lists of
    per-field arrays of equal shape."""
    info = _info(rtype)
    if len(dst) != info.state_floats or len(src) != info.state_floats:
        raise ValueError(
            f"state_floats mismatch: expected {info.state_floats}, "
            f"got dst={len(dst)} src={len(src)}")
    for a, b in zip(dst, src):
        if tuple(np.shape(a)) != tuple(np.shape(b)):
            raise ValueError("state shape mismatch")
    return info.merge_arrays(list(dst), list(src))


def finalize_state(rtype: ReductionType, state):
    """Convert state fields to output values (empty cells → NaN)
    (reference: grid_merge.h finalize_grid_state)."""
    return _info(rtype).finalize_arrays(list(state))

"""
Torch forms of the builtin reductions' finalize (pcr_tpu/ops/reduction.py:
170-254), for state fields that live in torch tensors.

The registry itself (`get_reduction_info`, ReductionInfo, Custom ops) is
pcr_tpu's and is imported, not copied. Its `finalize_arrays` must only ever
see numpy arrays: for anything else its `_xp()` imports jax.numpy. So the
engine finalizes device tensors here and hands the shared host code numpy.
"""

from __future__ import annotations

import torch

from pcr_tpu.core.types import PcrError, ReductionType, Status, StatusCode
from pcr_tpu.ops.reduction import FLT_MAX, ReductionInfo

__all__ = ["finalize_fields"]


def finalize_fields(info: ReductionInfo, fields) -> torch.Tensor:
    """Per-cell output of a builtin reduction (NaN = no data)."""
    rtype = ReductionType(info.type)
    s = fields[0]
    nan = torch.full((), float("nan"), dtype=s.dtype, device=s.device)
    if rtype in (ReductionType.Sum, ReductionType.MostRecent,
                 ReductionType.PriorityMerge):
        return s
    if rtype == ReductionType.Max:
        return torch.where(s == -FLT_MAX, nan, s)
    if rtype == ReductionType.Min:
        return torch.where(s == FLT_MAX, nan, s)
    if rtype == ReductionType.Count:
        return torch.where(s > 0.0, s, nan)
    if rtype in (ReductionType.Average, ReductionType.WeightedAverage):
        c = fields[1]
        return torch.where(c > 0.0, s / torch.where(c > 0.0, c, 1.0), nan)
    raise PcrError(Status.error(
        StatusCode.NotImplemented,
        f"pcr_tpu_torch: device finalize of {rtype.name} not yet ported"))

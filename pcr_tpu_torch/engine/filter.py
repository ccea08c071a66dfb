"""
Filter — predicate-based point filtering before reduction.

The port's copy of pcr_tpu/engine/filter.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

TPU-native rebuild of the reference filter (include/pcr/engine/filter.h:20-74,
src/engine/filter.cpp, filter_kernels.cu). Predicates are AND-combined over
Float32 channels. The reference compacts surviving indices (CUB
DeviceSelect::Flagged); on TPU compaction forces dynamic shapes, so this
build evaluates predicates to a boolean *mask* and folds it into the ingest
valid-mask (masked points simply contribute nothing) — semantically
identical, and cheaper than compaction.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..core.types import PcrError, Status, StatusCode

__all__ = ["CompareOp", "FilterPredicate", "FilterSpec", "evaluate_filter_mask"]


class CompareOp(enum.IntEnum):
    Equal = 0
    NotEqual = 1
    Less = 2
    LessEqual = 3
    Greater = 4
    GreaterEqual = 5
    InSet = 6       # value is in a set of allowed values
    NotInSet = 7


@dataclass
class FilterPredicate:
    channel_name: str = ""
    op: CompareOp = CompareOp.Equal
    value: float = 0.0
    value_set: list = dc_field(default_factory=list)


@dataclass
class FilterSpec:
    """Collection of predicates, AND-combined (reference: filter.h:41-51)."""

    predicates: list = dc_field(default_factory=list)

    def add(self, channel: str, op: CompareOp, value: float) -> "FilterSpec":
        self.predicates.append(FilterPredicate(channel, op, float(value)))
        return self

    def add_in_set(self, channel: str, values) -> "FilterSpec":
        self.predicates.append(FilterPredicate(
            channel, CompareOp.InSet, 0.0, [float(v) for v in values]))
        return self

    def empty(self) -> bool:
        return len(self.predicates) == 0


def _eval_predicate(vals: np.ndarray, pred: FilterPredicate) -> np.ndarray:
    op = CompareOp(pred.op)
    v = np.float32(pred.value)
    if op == CompareOp.Equal:
        return vals == v
    if op == CompareOp.NotEqual:
        return vals != v
    if op == CompareOp.Less:
        return vals < v
    if op == CompareOp.LessEqual:
        return vals <= v
    if op == CompareOp.Greater:
        return vals > v
    if op == CompareOp.GreaterEqual:
        return vals >= v
    if op == CompareOp.InSet:
        return np.isin(vals, np.asarray(pred.value_set, dtype=np.float32))
    if op == CompareOp.NotInSet:
        return ~np.isin(vals, np.asarray(pred.value_set, dtype=np.float32))
    raise PcrError(Status.error(StatusCode.InvalidArgument,
                                f"unknown CompareOp {pred.op}"))


def evaluate_filter_mask(cloud, spec: FilterSpec) -> np.ndarray:
    """Evaluate a FilterSpec against a PointCloud.

    Returns a boolean mask of surviving points (True = keep). Predicates
    are AND-combined; an empty spec passes everything
    (reference: filter.cpp:127-189 semantics). Raises on missing channels.
    """
    n = cloud.count()
    mask = np.ones(n, dtype=bool)
    for pred in spec.predicates:
        if not cloud.has_channel(pred.channel_name):
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                f"filter: channel {pred.channel_name!r} not found"))
        vals = cloud.channel_array_f32(pred.channel_name)
        mask &= _eval_predicate(vals, pred)
    return mask

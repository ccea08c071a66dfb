"""
Reduction ops — the op algebra and type-erased registry, and the torch
finalizes of the device states.

The registry is the port's copy of pcr_tpu/ops/reduction.py, the rebuild of
the reference ops layer
(include/pcr/ops/reduction_op.h:17-51, include/pcr/ops/builtin_ops.h:10-183,
include/pcr/ops/reduction_registry.h:31-80).

An op is defined by: State (K float fields per cell, band-sequential layout
state[f, cell]), identity, combine(state, value[, weight/timestamp]),
merge(state_a, state_b), finalize(state)->float. All builtin merges are
associative+commutative, which is what makes the framework's deterministic
sort/segment-reduce and multi-chip psum-style tree merges valid.

Instead of the reference's per-point function-pointer loop, every op here
additionally carries a *vectorized plan*:

  * ``fields(values, weights, timestamps)`` maps N points to an (K, N) field
    matrix of per-point state contributions,
  * ``scatter_kind`` says how fields fold per cell: 'sum' (Sum/Count/Average/
    WeightedAverage — matmul-scatter on the MXU), 'max'/'min' (sort +
    segment-reduce), 'argmax_ts' (MostRecent: lexicographic max on
    (timestamp, value)),
  * ``merge_arrays`` / ``finalize_arrays`` are whole-grid vectorized
    equivalents of merge/finalize.

The host layers only ever hand the registry numpy arrays (pcr_tpu's jnp
branch, `_xp`, is left out). State that lives in torch tensors finalizes
through `finalize_fields` and `gauss_state_flush` at the end of this file,
the torch forms of the builtin finalizes (:170-254) and of
tpu_backend.gauss_state_flush.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.types import PcrError, ReductionType, Status, StatusCode
from ..engine.glyph import GlyphType
from ..engine.tiling import GAUSS_WMIN

__all__ = [
    "FLT_MAX", "ReductionOp", "ReductionInfo", "get_reduction_info",
    "registered_reductions", "is_registered",
    "register_custom_reduction", "unregister_reduction",
    "finalize_fields", "gauss_state_flush",
]

FLT_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Scalar op algebra (reference: builtin_ops.h)
#
# States are tuples of floats; combine takes (state, value) with optional
# weight/timestamp keyword for the weighted/timestamped variants
# (builtin_ops.h:91-93, :114-116).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReductionOp:
    type: ReductionType
    state_floats: int
    identity: tuple
    combine: Callable            # (state, value, **kw) -> state
    merge: Callable              # (state_a, state_b) -> state
    finalize: Callable           # (state) -> float


def _sum_combine(s, v, **kw):
    return (s[0] + v,)


def _max_combine(s, v, **kw):
    return (max(s[0], v),)


def _min_combine(s, v, **kw):
    return (min(s[0], v),)


def _count_combine(s, v, **kw):
    return (s[0] + 1.0,)


def _avg_combine(s, v, **kw):
    return (s[0] + v, s[1] + 1.0)


def _wavg_combine(s, v, weight=1.0, **kw):
    return (s[0] + v * weight, s[1] + weight)


def _mostrecent_combine(s, v, timestamp=None, **kw):
    ts = -FLT_MAX if timestamp is None else timestamp
    return (v, ts) if ts > s[1] else s


def _add2(a, b):
    return (a[0] + b[0], a[1] + b[1])


_OPS = {
    ReductionType.Sum: ReductionOp(
        ReductionType.Sum, 1, (0.0,), _sum_combine,
        lambda a, b: (a[0] + b[0],), lambda s: s[0]),
    ReductionType.Max: ReductionOp(
        ReductionType.Max, 1, (-FLT_MAX,), _max_combine,
        lambda a, b: (max(a[0], b[0]),),
        lambda s: float("nan") if s[0] == -FLT_MAX else s[0]),
    ReductionType.Min: ReductionOp(
        ReductionType.Min, 1, (FLT_MAX,), _min_combine,
        lambda a, b: (min(a[0], b[0]),),
        lambda s: float("nan") if s[0] == FLT_MAX else s[0]),
    ReductionType.Count: ReductionOp(
        ReductionType.Count, 1, (0.0,), _count_combine,
        lambda a, b: (a[0] + b[0],),
        lambda s: s[0] if s[0] > 0.0 else float("nan")),
    ReductionType.Average: ReductionOp(
        ReductionType.Average, 2, (0.0, 0.0), _avg_combine, _add2,
        lambda s: s[0] / s[1] if s[1] > 0.0 else float("nan")),
    ReductionType.WeightedAverage: ReductionOp(
        ReductionType.WeightedAverage, 2, (0.0, 0.0), _wavg_combine, _add2,
        lambda s: s[0] / s[1] if s[1] > 0.0 else float("nan")),
    ReductionType.MostRecent: ReductionOp(
        ReductionType.MostRecent, 2, (float("nan"), -FLT_MAX),
        _mostrecent_combine,
        lambda a, b: a if a[1] >= b[1] else b,
        lambda s: s[0]),
    # Same argmax algebra as MostRecent with the per-point priority channel
    # in the key slot ("keeps value with highest priority channel value",
    # reference types.h:44 — left TODO in its registry,
    # reduction_registry.cpp:185).
    ReductionType.PriorityMerge: ReductionOp(
        ReductionType.PriorityMerge, 2, (float("nan"), -FLT_MAX),
        _mostrecent_combine,
        lambda a, b: a if a[1] >= b[1] else b,
        lambda s: s[0]),
}


# ---------------------------------------------------------------------------
# Vectorized plans
# ---------------------------------------------------------------------------

def _ones_like(values):
    return values * 0.0 + 1.0


def _fields_sum(values, weights, timestamps):
    return [values]


def _fields_count(values, weights, timestamps):
    return [_ones_like(values)]


def _fields_avg(values, weights, timestamps):
    return [values, _ones_like(values)]


def _fields_wavg(values, weights, timestamps):
    w = _ones_like(values) if weights is None else weights
    return [values * w, w]


def _fields_minmax(values, weights, timestamps):
    return [values]


def _fields_mostrecent(values, weights, timestamps):
    ts = (values * 0.0 - FLT_MAX) if timestamps is None else timestamps
    return [values, ts]


def _fin_sum(state):
    return state[0]


def _xp(arr):
    """The array module of the host forms: numpy (device tensors finalize
    through finalize_fields)."""
    return np


def _native_fin():
    """The native single-pass finalize module, or None. Numpy's forms need
    3-4 full-array passes (compare/guard/divide/select) — the dominant cost
    of a host finalize at 10M+ cells on a slow machine."""
    from .. import native
    return native if native.available() else None


def _fin_max_arrays(state):
    s = state[0]
    xp = _xp(s)
    if xp is np:
        nat = _native_fin()
        if nat is not None:
            return nat.fin_sentinel(s, -FLT_MAX).reshape(s.shape)
    return xp.where(s == np.float32(-FLT_MAX), np.float32(np.nan), s)


def _fin_min_arrays(state):
    s = state[0]
    xp = _xp(s)
    if xp is np:
        nat = _native_fin()
        if nat is not None:
            return nat.fin_sentinel(s, FLT_MAX).reshape(s.shape)
    return xp.where(s == np.float32(FLT_MAX), np.float32(np.nan), s)


def _fin_count_arrays(state):
    s = state[0]
    xp = _xp(s)
    if xp is np:
        nat = _native_fin()
        if nat is not None:
            return nat.fin_count(s).reshape(s.shape)
    return xp.where(s > 0.0, s, np.float32(np.nan))


def _fin_avg_arrays(state):
    s, c = state[0], state[1]
    xp = _xp(s)
    if xp is np:
        nat = _native_fin()
        if nat is not None:
            return nat.fin_avg(s, c).reshape(s.shape)
    # Guard the division to avoid 0/0 warnings on the numpy path.
    denom = xp.where(c > 0.0, c, np.float32(1.0))
    return xp.where(c > 0.0, s / denom, np.float32(np.nan))


def _fin_mostrecent_arrays(state):
    return state[0]


def _merge_add(a, b):
    return [a[i] + b[i] for i in range(len(a))]


def _merge_max(a, b):
    xp = _xp(a[0])
    return [xp.maximum(a[0], b[0])]


def _merge_min(a, b):
    xp = _xp(a[0])
    return [xp.minimum(a[0], b[0])]


def _merge_mostrecent(a, b):
    # a wins ties (builtin_ops.h:118-120: a.timestamp >= b.timestamp → a)
    xp = _xp(a[0])
    take_a = a[1] >= b[1]
    return [xp.where(take_a, a[0], b[0]), xp.where(take_a, a[1], b[1])]


# ---------------------------------------------------------------------------
# ReductionInfo — type-erased registry entry
# (reference: reduction_registry.h:31-80)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReductionInfo:
    type: ReductionType
    state_floats: int
    op: ReductionOp
    # identity per state field, float32
    identity: np.ndarray
    # 'sum' | 'max' | 'min' | 'argmax_ts'
    scatter_kind: str
    # (values, weights, timestamps) -> list of K per-point field arrays
    fields: Callable
    # vectorized merge: (list[K arrays], list[K arrays]) -> list[K arrays]
    merge_arrays: Callable
    # vectorized finalize: list[K arrays] -> array
    finalize_arrays: Callable
    # whether the op consumes a weight channel / timestamp channel
    uses_weight: bool = False
    uses_timestamp: bool = False
    # False for user-registered Custom ops: the engines then skip the
    # builtin-shaped fast paths (wire packs / Pallas one-hot layouts,
    # whose field layouts are keyed to the builtin types) and run the
    # generic kind-dispatched scatter, which consumes info.fields as-is
    builtin: bool = True
    # Unique per REGISTRATION for custom ops (0 for builtins): compiled
    # update/finalize programs cache under the engine's jit-namespace
    # key, and two different custom ops would otherwise collide on
    # (type=Custom, state_floats) and silently reuse each other's
    # programs (round-5 review).
    token: int = 0

    def init_state(self, shape) -> list[np.ndarray]:
        """Fresh state arrays (numpy, float32) of the given per-field shape,
        filled with the identity (reference: registry.cpp:28-40)."""
        return [np.full(shape, self.identity[f], dtype=np.float32)
                for f in range(self.state_floats)]


_REGISTRY: dict[ReductionType, ReductionInfo] = {}
_CUSTOM_TOKEN = 0


def _register(rtype, scatter_kind, fields, merge_arrays, finalize_arrays,
              uses_weight=False, uses_timestamp=False):
    op = _OPS[rtype]
    _REGISTRY[rtype] = ReductionInfo(
        type=rtype,
        state_floats=op.state_floats,
        op=op,
        identity=np.asarray(op.identity, dtype=np.float32),
        scatter_kind=scatter_kind,
        fields=fields,
        merge_arrays=merge_arrays,
        finalize_arrays=finalize_arrays,
        uses_weight=uses_weight,
        uses_timestamp=uses_timestamp,
    )


# Registered ops. The reference registers Sum/Max/Min/Count/Average/
# WeightedAverage (registry.cpp:174-186) and leaves MostRecent TODO; this
# build also registers MostRecent (the sort/segment design handles it
# cleanly as a lexicographic (timestamp, value) max — and deterministically,
# unlike the reference GPU's CAS race at accumulator_kernels.cu:139-167).
_register(ReductionType.Sum, "sum", _fields_sum, _merge_add, _fin_sum)
_register(ReductionType.Max, "max", _fields_minmax, _merge_max, _fin_max_arrays)
_register(ReductionType.Min, "min", _fields_minmax, _merge_min, _fin_min_arrays)
_register(ReductionType.Count, "sum", _fields_count, _merge_add, _fin_count_arrays)
_register(ReductionType.Average, "sum", _fields_avg, _merge_add, _fin_avg_arrays)
_register(ReductionType.WeightedAverage, "sum", _fields_wavg, _merge_add,
          _fin_avg_arrays, uses_weight=True)
_register(ReductionType.MostRecent, "argmax_ts", _fields_mostrecent,
          _merge_mostrecent, _fin_mostrecent_arrays, uses_timestamp=True)
# PriorityMerge rides the same deterministic argmax scatter; the pipeline
# routes spec.priority_channel into the key slot.
_register(ReductionType.PriorityMerge, "argmax_ts", _fields_mostrecent,
          _merge_mostrecent, _fin_mostrecent_arrays, uses_timestamp=True)


# ---------------------------------------------------------------------------
# Median / Percentile — order statistics (declared but never implemented in
# the reference, registry.cpp:183-185 TODO).
#
# These are not K-float-state reductions: an exact per-cell quantile needs
# every value. They are registered with scatter_kind='collect' — the
# pipeline retains the raw (cell, value) stream (host RAM, ~8 B/point) and
# finalize computes the quantile in one vectorized pass:
# lexsort by (cell, value), segment boundaries, gather at
# start + floor(q * (count - 1))   [lower-interpolation quantile].
# ---------------------------------------------------------------------------

def _quantile_identity():
    return (float("nan"),)


def compute_percentile_band(cells: np.ndarray, values: np.ndarray,
                            shape, q: float) -> np.ndarray:
    """Exact per-cell q-quantile (lower interpolation) of collected values.

    cells: flat int64 cell ids; values: float32. Empty cells → NaN."""
    H, W = shape
    band = np.full(H * W, np.nan, dtype=np.float32)
    if len(cells) == 0:
        return band.reshape(H, W)
    order = np.lexsort((values, cells))
    c = cells[order]
    v = values[order]
    # segment starts
    first = np.ones(len(c), dtype=bool)
    first[1:] = c[1:] != c[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(c)))
    qidx = starts + np.floor(q * (counts - 1)).astype(np.int64)
    band[c[starts]] = v[qidx]
    return band.reshape(H, W)


def _register_collect(rtype):
    op = ReductionOp(rtype, 1, (float("nan"),),
                     lambda s, v, **kw: s, lambda a, b: a, lambda s: s[0])
    _REGISTRY[rtype] = ReductionInfo(
        type=rtype,
        state_floats=1,
        op=op,
        identity=np.asarray([np.nan], dtype=np.float32),
        scatter_kind="collect",
        fields=_fields_sum,
        merge_arrays=_merge_add,
        finalize_arrays=_fin_sum,
    )


_register_collect(ReductionType.Median)
_register_collect(ReductionType.Percentile)


def register_custom_reduction(*, state_floats: int, identity,
                              scatter_kind: str, fields,
                              merge_arrays, finalize_arrays,
                              uses_weight: bool = False,
                              uses_timestamp: bool = False) -> None:
    """Install a user-provided op as ``ReductionType.Custom``.

    The TPU-native analogue of the reference's compile-time template
    path (``Accumulator::accumulate<Op>``, accumulator.cpp:61-99; the
    registry returns nullptr for Custom, reduction_registry.h:75): the
    op is defined by its VECTORIZED plan and runs on every engine —
    the numpy CPU oracle, the single-chip device scatter, and the mesh
    engines (the merge collectives follow ``scatter_kind``).

      state_floats     K state fields per cell
      identity         K floats — the empty-cell state
      scatter_kind     'sum'  (per-cell scatter-ADD of each field)
                       'max' / 'min'  (K must be 1)
                       'argmax_ts'    (K must be 2: (value, key); the
                                       per-cell winner has the largest
                                       key, earliest-wins on ties)
      fields(values, weights, timestamps) -> list of K per-point arrays
                       (numpy arrays; stick to operators and
                       ufunc-style calls)
      merge_arrays(a, b) -> list[K]   associative state merge
      finalize_arrays(fields) -> array  per-cell output (NaN = empty)

    Point glyph only (glyph splatting keeps the reference's restriction
    to WeightedAverage/Average/Sum/Count, glyph_kernels.cu:298-305).
    Call ``unregister_reduction(ReductionType.Custom)`` to remove."""
    if scatter_kind not in ("sum", "max", "min", "argmax_ts"):
        raise ValueError(f"unsupported scatter_kind {scatter_kind!r}")
    if scatter_kind in ("max", "min") and state_floats != 1:
        raise ValueError("max/min custom ops require state_floats == 1")
    if scatter_kind == "argmax_ts" and state_floats != 2:
        raise ValueError("argmax_ts custom ops require state_floats == 2")
    ident = np.asarray(identity, dtype=np.float32).reshape(-1)
    if len(ident) != state_floats:
        raise ValueError("identity length must equal state_floats")
    op = ReductionOp(ReductionType.Custom, state_floats, tuple(ident),
                     lambda s, v, **kw: s, lambda a, b: a,
                     lambda s: s[0])
    global _CUSTOM_TOKEN
    _CUSTOM_TOKEN += 1
    _REGISTRY[ReductionType.Custom] = ReductionInfo(
        type=ReductionType.Custom,
        state_floats=state_floats,
        op=op,
        identity=ident,
        scatter_kind=scatter_kind,
        fields=fields,
        merge_arrays=merge_arrays,
        finalize_arrays=finalize_arrays,
        uses_weight=uses_weight,
        uses_timestamp=uses_timestamp,
        builtin=False,
        token=_CUSTOM_TOKEN,
    )


def unregister_reduction(rtype: ReductionType) -> None:
    """Remove a Custom registration. Builtin registrations happen once
    at import and could not be reinstalled, so removing them is
    rejected."""
    if ReductionType(rtype) != ReductionType.Custom:
        raise ValueError(
            "only ReductionType.Custom can be unregistered")
    _REGISTRY.pop(ReductionType.Custom, None)


def get_reduction_info(rtype: ReductionType) -> ReductionInfo | None:
    """Look up a registered reduction (None if not registered,
    like registry.cpp:189-196)."""
    return _REGISTRY.get(ReductionType(rtype))


def is_registered(rtype: ReductionType) -> bool:
    return ReductionType(rtype) in _REGISTRY


def registered_reductions() -> list[ReductionType]:
    return sorted(_REGISTRY.keys())


# ---------------------------------------------------------------------------
# Torch finalizes of the device states (the builtin finalize_arrays above,
# for state fields that live in torch tensors)
# ---------------------------------------------------------------------------

def gauss_state_flush(spec, info: ReductionInfo, fields):
    """Zero sub-cutoff Gaussian weight sums, and their value sums, so the
    empty-cell NaN footprint is exact (tpu_backend.gauss_state_flush,
    :314-341). Every legitimate Gaussian deposit weighs >= 1e-6, so a
    weight sum under GAUSS_WMIN is a residue, never data. Point and Line
    specs and Sum states pass through. Returns new tensors; the inputs
    are not changed."""
    if GlyphType(spec.glyph.type) != GlyphType.Gaussian:
        return fields
    rtype = ReductionType(info.type)
    if rtype in (ReductionType.Average, ReductionType.WeightedAverage):
        keep = fields[1] >= float(GAUSS_WMIN)
        return [torch.where(keep, f, 0.0) for f in fields]
    if rtype == ReductionType.Count:
        return [torch.where(fields[0] >= float(GAUSS_WMIN), fields[0], 0.0)]
    return fields


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

"""
The port's Pipeline: pcr_tpu's Pipeline (pcr_tpu/engine/pipeline.py) with
its device backend on a TorchEngine.

Everything host-side is inherited: routing, filtering, staging
(`stage`), ingest, per-tile finalize, PCRT checkpoints, resume and the
GeoTIFF writers, and the numpy CPU oracle for ExecutionMode.CPU. What is
overridden is what names the device: `create` (the base builds its own
class by name), the backend probe, engine selection and `warmup`.

The base class tags its device backend "jax" and keys every shared device
branch on that tag (stage, ingest, finalize, resume); here the same tag
drives the TorchEngine, and no jax code is reached.

Not yet ported, refused with StatusCode.NotImplemented on the device path:
Gaussian and Line glyphs, Custom reductions, `gpu_memory_budget`
out-of-core banding and device meshes. The CPU backend runs them all.
"""

from __future__ import annotations

import os
import warnings

import torch

from pcr_tpu import native
from pcr_tpu.core.types import PcrError, ReductionType, Status, StatusCode
from pcr_tpu.engine import pipeline as _ref
from pcr_tpu.engine.glyph import GLYPH_SUPPORTED_REDUCTIONS, GlyphType
from pcr_tpu.ops.reduction import get_reduction_info

from ..core.device import cuda_device_available, cuda_device_count
from .torch_backend import TorchEngine, _not_ported

__all__ = ["ExecutionMode", "ReductionSpec", "PipelineConfig",
           "ProgressInfo", "StagedCloud", "Pipeline"]

ExecutionMode = _ref.ExecutionMode
ReductionSpec = _ref.ReductionSpec
PipelineConfig = _ref.PipelineConfig
ProgressInfo = _ref.ProgressInfo
StagedCloud = _ref.StagedCloud

_DEVICE = "jax"   # the base class's tag for its device backend


def _device_override() -> torch.device | None:
    """Opt-in mirroring pcr_tpu's PCR_FORCE_JAX: PCR_TORCH_DEVICE names the
    torch device the device path runs on (e.g. "cpu", where K1 takes its
    plain version), which then counts as an available accelerator."""
    name = os.environ.get("PCR_TORCH_DEVICE", "")
    return torch.device(name) if name else None


class Pipeline(_ref.Pipeline):
    """Create with `Pipeline.create(config)`, then `ingest(cloud)` (or
    `ingest(pipe.stage(cloud))`) one or more times, then `finalize()`;
    read back via `result()`."""

    @classmethod
    def create(cls, config: PipelineConfig) -> "Pipeline":
        st = cls._validate_config(config)
        if not st.ok():
            raise PcrError(st)
        native.set_num_threads(config.cpu_threads or 0)
        p = cls(config, cls._resolve_backend(config))
        for spec in config.reductions:
            info = get_reduction_info(spec.type)
            if info is None:
                raise PcrError(Status.error(
                    StatusCode.InvalidArgument,
                    f"pipeline: unregistered reduction type "
                    f"{ReductionType(spec.type).name}"))
            gt = GlyphType(spec.glyph.type)
            if (gt != GlyphType.Point
                    and ReductionType(spec.type)
                    not in GLYPH_SUPPORTED_REDUCTIONS):
                raise PcrError(Status.error(
                    StatusCode.NotImplemented,
                    "glyph splatting only supports WeightedAverage, Average, "
                    "Sum, or Count reduction types"))
            p._plans.append((spec, info))
            if info.scatter_kind == "collect":
                from pcr_tpu.engine.collect_spill import CollectStream
                p._collect[len(p._plans) - 1] = CollectStream(
                    spill_dir=config.state_dir or None)
        p._init_state()
        p._load_existing_state()
        return p

    @staticmethod
    def _resolve_backend(config: PipelineConfig) -> str:
        mode = ExecutionMode(config.exec_mode)
        if mode == ExecutionMode.CPU:
            return "cpu"
        accel = _device_override() is not None or cuda_device_available()
        if mode == ExecutionMode.Auto:
            return _DEVICE if accel else "cpu"
        # GPU / Hybrid: the fallback ladder (reference: pipeline.cpp:113-214)
        if accel:
            return _DEVICE
        if config.gpu_require_strict:
            raise PcrError(Status.error(
                StatusCode.CudaError,
                "pipeline: CUDA device required (strict mode) but none "
                "available"))
        if config.gpu_fallback_to_cpu:
            warnings.warn("pcr_tpu_torch: no CUDA device available, "
                          "falling back to CPU execution")
            return "cpu"
        raise PcrError(Status.error(
            StatusCode.CudaError,
            "pipeline: no CUDA device available and fallback disabled"))

    def _init_state(self):
        if self._backend == "cpu":
            return super()._init_state()
        self._tiled = False
        cfg = self.config
        if (cfg.mesh_devices is not None or cfg.mesh_dp > 1
                or cfg.mesh_sp > 1):
            raise _not_ported("multi-device meshes")
        if cfg.gpu_memory_budget:
            raise _not_ported("gpu_memory_budget out-of-core banding")
        for spec, _ in self._plans:
            if GlyphType(spec.glyph.type) != GlyphType.Point:
                raise _not_ported(
                    f"{GlyphType(spec.glyph.type).name} glyphs on the "
                    f"device path")
        device = _device_override() or torch.device(
            "cuda", min(cfg.cuda_device_id, cuda_device_count() - 1))
        self._engine = TorchEngine(cfg.grid, self._plans, device)

    def warmup(self, chunk_points: int = 0) -> None:
        """Absorb one-time device costs before timed work: the CUDA kernel
        build and device start-up. PyTorch runs eagerly, so there are no
        per-shape compiles to warm and `chunk_points` (kept for API
        compatibility) changes nothing."""
        if self._backend == _DEVICE:
            self._engine.warmup()

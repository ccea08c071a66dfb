"""
Pipeline — the main orchestration entry point of the port.

The port's own Pipeline, carried over from pcr_tpu/engine/pipeline.py (the
rebuild of the reference Pipeline, include/pcr/engine/pipeline.h:49-145,
src/engine/pipeline.cpp:31-1403): the same config surface, ingest/finalize/
run lifecycle, per-reduction output bands, progress/cancel callback,
fallback ladder, and tile-state checkpointing via PCRT files. Its host half
(config, validation, routing and filter, `stage`, `ingest`, per-tile
finalize, PCRT flush and resume, the GeoTIFF writers and the numpy CPU
path) is pcr_tpu's, on the port's own copies of the host layers.

Execution modes:
  * CPU    — vectorized numpy oracle path (engine/cpu_backend.py).
  * GPU    — the device path: a TorchEngine (engine/torch_backend.py) on
             the CUDA card, its kernels hand-written for Hopper.
  * Auto   — the same as GPU.
  * Hybrid — the same as GPU: host routing, device accumulation. pcr_tpu's
             worker pool that overlaps host prep with device commits is
             not carried over (ROADMAP Queue 1).

Where it runs: on the card unless the caller asks for the CPU. Auto, GPU
and Hybrid take the card; without one they raise StatusCode.CudaError. The
CPU runs only for ExecutionMode.CPU, for an explicit
`gpu_fallback_to_cpu=True` (with a warning), or on the torch device named
by PCR_TORCH_DEVICE (the tests set "cpu", where every kernel takes its
plain version).

Not carried over, refused with StatusCode.NotImplemented on the device
path: Custom reductions, `gpu_memory_budget` out-of-core banding and
device meshes (pcr_tpu's OutOfCoreTpuEngine, ShardedTpuEngine and
PartitionedTpuEngine). The CPU backend runs them all.

Differences from the reference, by design (as in pcr_tpu):
  * Multi-reduction ingest shares one world→cell assignment per cloud
    instead of re-routing per reduction (pipeline.cpp:360-743 re-sorts per
    reduction) — identical semantics, less work.
  * Accumulation is deterministic (sorted sums, no float atomics).
  * Tile state files are written under a per-reduction subdirectory
    `red{i}_{type}` — the reference writes all reductions' tiles into one
    directory with colliding filenames (pipeline.cpp:236 +
    tile_state_io.cpp:197-210), which corrupts multi-reduction resume.
  * Only a pipeline with a `state_dir` resumes state or writes it. Without
    one, CPU out-of-core tiles spill into a private temporary directory,
    removed with the pipeline; pcr_tpu shares one fixed directory between
    all such pipelines and resumes whatever an earlier run left there.
"""

from __future__ import annotations

import enum
import os
import shutil
import tempfile
import time
import warnings
import weakref
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .. import native
from ..core.device import (cuda_device_available, cuda_device_count,
                           device_override)
from ..core.grid import BandDesc, Grid
from ..core.grid_config import GridConfig
from ..core.point_cloud import PointCloud
from ..core.types import (
    CRS, DataType, MemoryLocation, PcrError, ReductionType, Status,
    StatusCode, TileIndex,
)
from ..io import tile_state_io
from ..ops.reduction import get_reduction_info
from . import cpu_backend as cpu
from . import routing
from .filter import FilterSpec, evaluate_filter_mask
from .glyph import GLYPH_SUPPORTED_REDUCTIONS, GlyphSpec, GlyphType
from .torch_backend import TorchEngine, _not_ported

__all__ = ["ExecutionMode", "ReductionSpec", "PipelineConfig",
           "ProgressInfo", "StagedCloud", "Pipeline"]

_DEVICE = "torch"   # the backend tag of the device path
_STREAM_MIN_BYTES = 2 << 20    # with an output file, stream bands this big
_STRIP_TARGET_BYTES = 2 << 20  # a streamed finalize's row strip


class ExecutionMode(enum.IntEnum):
    CPU = 0
    GPU = 1      # the device path, on the CUDA card
    Auto = 2
    Hybrid = 3


@dataclass
class ReductionSpec:
    """What to reduce and how (reference: pipeline.h:20-34)."""
    value_channel: str = ""
    type: ReductionType = ReductionType.Sum
    weight_channel: str = ""       # for WeightedAverage
    timestamp_channel: str = ""    # for MostRecent
    priority_channel: str = ""     # for PriorityMerge
    percentile: float = 0.5        # for Percentile (not yet registered)
    output_band_name: str = ""
    glyph: GlyphSpec = dc_field(default_factory=GlyphSpec)


@dataclass
class PipelineConfig:
    """Full configuration for a processing run (reference: pipeline.h:49-86)."""
    grid: GridConfig = dc_field(default_factory=GridConfig)
    reductions: list = dc_field(default_factory=list)
    filter: FilterSpec = dc_field(default_factory=FilterSpec)

    # CRS handling
    target_crs: CRS = dc_field(default_factory=CRS)
    auto_reproject: bool = True

    exec_mode: ExecutionMode = ExecutionMode.Auto

    # Memory budget
    gpu_memory_budget: int = 0     # refused on the device path (not ported)
    host_cache_budget: int = 0
    chunk_size: int = 0            # points per device chunk, 0 = auto

    # Device configuration (names kept for reference compatibility,
    # pipeline.h:49-86)
    gpu_pool_size_bytes: int = 512 * 1024 * 1024
    # ^ COMPAT-ONLY, ignored: PyTorch's caching allocator owns device
    #   memory; there is no user-sized arena.
    cuda_device_id: int = 0
    use_cuda_streams: bool = True
    # ^ COMPAT-ONLY, ignored: kernels launch on PyTorch's current stream.
    gpu_fallback_to_cpu: bool = False
    # ^ The reference's and pcr_tpu's default is True; the port runs on the
    #   card unless the caller asks for the CPU.
    gpu_require_strict: bool = False

    # CPU threading
    cpu_threads: int = 0
    # ^ caps the native OpenMP kernels' thread count (0 = runtime default)
    hybrid_cpu_threads: int = 0
    # ^ COMPAT-ONLY, ignored: Hybrid runs as GPU (no prep worker pool).

    # Multi-device scale-out (pcr_tpu's mesh engines): refused on the
    # device path (not ported).
    mesh_devices: object = None
    mesh_dp: int = 0
    mesh_sp: int = 0

    # State persistence
    state_dir: str = ""
    resume: bool = False

    # GeoTIFF output
    output_path: str = ""
    write_cog: bool = False


@dataclass
class ProgressInfo:
    collections_processed: int = 0
    collections_total: int = 0     # 0 if unknown (streaming mode)
    points_processed: int = 0
    tiles_active: int = 0
    elapsed_seconds: float = 0.0


@dataclass
class StagedCloud:
    """A routed point cloud staged in device memory (see Pipeline.stage)."""
    per_spec: list           # per ReductionSpec: list[StagedChunk]
    n_valid: int
    col: np.ndarray          # valid points' assigned cells (for tile stats)
    row: np.ndarray
    tiles: frozenset = frozenset()   # touched (trow, tcol), precomputed at
                                     # stage() time so ingest stays O(1) host


def _ch(cloud, name, sel):
    """Sliced optional glyph channel."""
    arr = routing.glyph_channel(cloud, name)
    return arr[sel] if arr is not None else None


class Pipeline:
    """Create with `Pipeline.create(config)`, then `ingest(cloud)` (or
    `ingest(pipe.stage(cloud))`) one or more times, then `finalize()`;
    read back via `result()`."""

    def __init__(self, config: PipelineConfig, backend: str):
        self.config = config
        self._backend = backend           # 'cpu' | 'torch'
        self._plans = []                  # list of (spec, info)
        self._host_state = []             # CPU mode: per spec list[(H,W)]
        self._managers = []               # CPU out-of-core: TileManager/spec
        self._collect = {}                # order-statistics specs: spec idx
                                          #   -> CollectStream (spill-backed)
        self._tiled = False
        self._spill_root = None           # tiled without state_dir: temp dir
        self._engine = None               # torch mode: TorchEngine
        self._result: Grid | None = None
        self._finalized = False
        self._cancelled = False
        self._progress_cb = None
        self._collections = 0
        self._points = 0
        self._start = time.perf_counter()
        self._touched_tiles: set = set()
        self._device_cloud_cache: dict = {}  # id(cloud) -> (weakref, StagedCloud)

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, config: PipelineConfig) -> "Pipeline":
        st = cls._validate_config(config)
        if not st.ok():
            raise PcrError(st)
        # Cap the native OpenMP kernels' thread count (reference:
        # omp_set_num_threads, pipeline.cpp:94-98); results are
        # thread-count-invariant, this only bounds CPU usage. The cap is
        # process-global, so a default config (cpu_threads=0) RESTORES the
        # runtime default rather than inheriting a previous pipeline's cap.
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
                from .collect_spill import CollectStream
                p._collect[len(p._plans) - 1] = CollectStream(
                    spill_dir=config.state_dir or None)
        p._init_state()
        p._load_existing_state()
        return p

    @staticmethod
    def _validate_config(config: PipelineConfig) -> Status:
        st = config.grid.validate()
        if not st.ok():
            return st
        if not config.reductions:
            return Status.error(StatusCode.InvalidArgument,
                                "pipeline: no reductions configured")
        return Status.success()

    @staticmethod
    def _resolve_backend(config: PipelineConfig) -> str:
        """The fallback ladder (reference: pipeline.cpp:113-214), with the
        card as the default: Auto, GPU and Hybrid take the card, and
        without one fall back to the CPU only when the caller set
        gpu_fallback_to_cpu."""
        if ExecutionMode(config.exec_mode) == ExecutionMode.CPU:
            return "cpu"
        if device_override() is not None or cuda_device_available():
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
            "pipeline: no CUDA device available (set ExecutionMode.CPU, or "
            "gpu_fallback_to_cpu=True, to run on the CPU)"))

    def _init_state(self):
        cfg = self.config.grid
        if self._backend == "cpu":
            # Out-of-core: when the full-grid state would exceed the host
            # cache budget, switch to per-tile state via the TileManager
            # (LRU cache + PCRT spill, reference: tile_manager.cpp).
            budget = self.config.host_cache_budget
            state_bytes = sum(
                info.state_floats * cfg.total_cells() * 4
                for _, info in self._plans)
            self._tiled = bool(budget and state_bytes > budget)
            if self._tiled:
                from .tile_manager import TileManager, TileManagerConfig
                if not self.config.state_dir:
                    self._spill_root = tempfile.mkdtemp(prefix="pcr_tiles_")
                    weakref.finalize(self, shutil.rmtree, self._spill_root,
                                     True)
                for i, (spec, info) in enumerate(self._plans):
                    self._managers.append(TileManager.create(
                        TileManagerConfig(
                            state_dir=self._state_dir_for(i),
                            cache_size_bytes=max(
                                budget // len(self._plans), 1 << 20),
                            state_floats=info.state_floats,
                            reduction_type=ReductionType(spec.type),
                            grid_config=cfg)))
            else:
                for spec, info in self._plans:
                    self._host_state.append(
                        info.init_state((cfg.height, cfg.width)))
            return
        self._tiled = False
        c = self.config
        if c.mesh_devices is not None or c.mesh_dp > 1 or c.mesh_sp > 1:
            raise _not_ported("multi-device meshes")
        if c.gpu_memory_budget:
            raise _not_ported("gpu_memory_budget out-of-core banding")
        device = device_override() or torch.device(
            "cuda", min(c.cuda_device_id, cuda_device_count() - 1))
        self._engine = TorchEngine(cfg, self._plans, device)

    # -- state persistence ------------------------------------------------------

    def _state_dir_for(self, spec_idx: int) -> str:
        base = self.config.state_dir or self._spill_root
        spec, _ = self._plans[spec_idx]
        return os.path.join(base, f"red{spec_idx}_{int(spec.type)}")

    def _load_existing_state(self):
        """Resume: load any existing PCRT tile files (the reference's
        TileManager loads existing files implicitly on acquire,
        tile_manager.cpp:272-302 — the `resume` flag is declared but never
        read there; we honor the same implicit behaviour). Without a
        state_dir there is nothing to resume."""
        if not self.config.state_dir:
            return
        cfg = self.config.grid
        if self._tiled:
            # TileManager loads existing PCRT files lazily on acquire;
            # just record which tiles already have state.
            for trow in range(cfg.tiles_y):
                for tcol in range(cfg.tiles_x):
                    if self._managers[0].tile_has_state(
                            TileIndex(row=trow, col=tcol)):
                        self._touched_tiles.add((trow, tcol))
            return
        for i, (spec, info) in enumerate(self._plans):
            d = self._state_dir_for(i)
            if not os.path.isdir(d):
                continue
            fields = (self._host_state[i] if self._backend == "cpu"
                      else [f.copy() for f in self._engine.fetch_state(i)])
            loaded = False
            for trow in range(cfg.tiles_y):
                for tcol in range(cfg.tiles_x):
                    tile = TileIndex(row=trow, col=tcol)
                    path = tile_state_io.tile_state_filename(d, tile)
                    if not os.path.exists(path):
                        continue
                    out, st = tile_state_io.read_tile_state(path)
                    if not st.ok():
                        # corrupt/mismatched state: reinitialize to identity
                        # (reference: tile_manager.cpp:280-320)
                        continue
                    t, cols, rows, sf, rtype = out[:5]
                    state = out[5]
                    cs, rs, cc, rc = cfg.tile_cell_range(tile)
                    if (cols != cc or rows != rc or sf != info.state_floats
                            or ReductionType(rtype) != ReductionType(spec.type)):
                        continue
                    body = state.reshape(sf, rows, cols)
                    for f in range(sf):
                        fields[f][rs:rs + rc, cs:cs + cc] = body[f]
                    loaded = True
                    self._touched_tiles.add((trow, tcol))
            if loaded and self._backend == _DEVICE:
                self._engine.load_state(i, fields)

    def _flush_state(self):
        """Write every touched tile's state as a PCRT file (flush_all,
        reference: tile_manager.cpp:416-426 + pipeline.cpp:1166-1172)."""
        if self._tiled:
            for mgr in self._managers:
                st = mgr.flush_all()
                if not st.ok():
                    raise PcrError(st)
            return
        for i, (spec, info) in enumerate(self._plans):
            if info.scatter_kind == "collect":
                # order statistics keep the raw stream, not K-float tile
                # state; PCRT checkpointing does not apply
                continue
            fields = (self._host_state[i] if self._backend == "cpu"
                      else self._engine.fetch_state(i))
            self._write_state_tiles(i, fields)

    def _write_state_tiles(self, i, fields):
        """Write touched tiles' PCRT files from host (H, W) state fields
        (flush_all, tile_manager.cpp:416-426)."""
        cfg = self.config.grid
        spec, info = self._plans[i]
        d = self._state_dir_for(i)
        os.makedirs(d, exist_ok=True)
        # only tiles with state are flushed (tile_manager.cpp:416-426)
        for (trow, tcol) in sorted(self._touched_tiles):
            tile = TileIndex(row=trow, col=tcol)
            cs, rs, cc, rc = cfg.tile_cell_range(tile)
            body = np.stack([f[rs:rs + rc, cs:cs + cc] for f in fields])
            st = tile_state_io.write_tile_state(
                tile_state_io.tile_state_filename(d, tile),
                tile, cc, rc, info.state_floats, spec.type, body)
            if not st.ok():
                raise PcrError(st)

    # -- validation -------------------------------------------------------------

    def validate(self) -> None:
        st = Pipeline._validate_config(self.config)
        if not st.ok():
            raise PcrError(st)

    # -- ingest -----------------------------------------------------------------

    def stage(self, cloud: PointCloud) -> "StagedCloud":
        """Route a cloud on the host and stage its packed chunks in device
        memory without running the accumulation compute.

        This is the analogue of the reference's Device-resident clouds
        ("GPU-Device" mode, docs/BENCHMARK_RESULTS.md:28-42): a subsequent
        `ingest(staged)` is pure device compute. Only available on the
        device backend."""
        if self._backend != _DEVICE:
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                "stage() requires the accelerator backend"))
        x = cloud.x_array()
        y = cloud.y_array()
        keep = (evaluate_filter_mask(cloud, self.config.filter)
                if not self.config.filter.empty() else None)
        col, row, valid = routing.assign(self.config.grid, x, y)
        if keep is not None:
            valid = valid & keep
        per_spec = []
        for i, (spec, info) in enumerate(self._plans):
            n = cloud.count()
            values = self._values_for(spec, cloud, n)
            if info.scatter_kind == "collect":
                flat = (row[valid].astype(np.int64)
                        * self.config.grid.width
                        + col[valid].astype(np.int64))
                per_spec.append(("collect", flat,
                                 np.asarray(values, np.float32)[valid]))
                continue
            weights, timestamps = self._aux_channels(spec, info, cloud, n)
            gt = GlyphType(spec.glyph.type)
            per_spec.append(self._prepare_device(
                i, spec, gt, cloud, x, y, col, row, valid, values, weights,
                timestamps))
        vc, vr = col[valid], row[valid]
        return StagedCloud(per_spec=per_spec,
                           n_valid=int(np.count_nonzero(valid)),
                           col=vc, row=vr,
                           tiles=frozenset(self._tiles_of(col, row, valid)))

    def ingest(self, cloud) -> None:
        """Process one point-cloud collection (PointCloud or StagedCloud).
        Can be called repeatedly.

        Raises PcrError on invalid input or user cancellation
        (reference: pipeline.cpp:283-770).
        """
        if self._cancelled:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "pipeline: cancelled by user"))
        # Device-located clouds (cloud.to_device(), the reference's
        # GPU-Device idiom — benchmark_cpu_gpu.py:55) are staged once per
        # pipeline and every subsequent ingest is pure device compute,
        # matching the reference's device-resident semantics.
        if (self._backend == _DEVICE and not isinstance(cloud, StagedCloud)
                and hasattr(cloud, "location")
                and cloud.location() == MemoryLocation.Device):
            cached = self._device_cloud_cache.get(id(cloud))
            if cached is None or cached[0]() is not cloud:
                import weakref
                cached = (weakref.ref(cloud), self.stage(cloud.to_host()))
                self._device_cloud_cache[id(cloud)] = cached
            return self.ingest(cached[1])
        if isinstance(cloud, StagedCloud):
            for i in range(len(self._plans)):
                staged = cloud.per_spec[i]
                if (isinstance(staged, tuple) and staged
                        and staged[0] == "collect"):
                    self._collect[i].append(staged[1], staged[2])
                else:
                    self._engine.commit(i, staged)
            self._touched_tiles.update(cloud.tiles)
            self._points += cloud.n_valid
            self._collections += 1
            self._emit_progress()
            return
        x = cloud.x_array()
        y = cloud.y_array()

        # auto-reproject clouds whose CRS differs from the grid's (the
        # reference declares these config fields but never reads them,
        # pipeline.h:63-65 / SURVEY.md §2.3; native transforms here)
        if (self.config.auto_reproject and cloud.crs().is_valid()
                and self.config.grid.crs.is_valid()
                and not cloud.crs().equivalent_to(self.config.grid.crs)):
            from .reprojection import reproject_points
            x, y, st = reproject_points(x, y, cloud.crs(),
                                        self.config.grid.crs)
            if not st.ok():
                raise PcrError(st)

        # Filter (AND-combined predicates; empty spec passes all)
        if not self.config.filter.empty():
            keep = evaluate_filter_mask(cloud, self.config.filter)
        else:
            keep = None

        # One shared assignment for all reductions
        col, row, valid = routing.assign(self.config.grid, x, y)
        if keep is not None:
            valid = valid & keep

        for i, (spec, info) in enumerate(self._plans):
            self._ingest_spec(i, spec, info, cloud, x, y, col, row, valid)

        self._track_tiles(col, row, valid)
        self._points += int(np.count_nonzero(valid))
        self._collections += 1
        self._emit_progress()

    def _values_for(self, spec: ReductionSpec, cloud: PointCloud,
                    n: int) -> np.ndarray:
        if spec.value_channel and cloud.has_channel(spec.value_channel):
            return cloud.channel_array_f32(spec.value_channel)
        if ReductionType(spec.type) == ReductionType.Count:
            # Count ignores the value; allow missing channel
            return np.zeros(n, dtype=np.float32)
        raise PcrError(Status.error(
            StatusCode.InvalidArgument,
            f"pipeline: value channel {spec.value_channel!r} not found"))

    def _aux_channels(self, spec, info, cloud, n):
        """Weight/timestamp channels for ops that use them."""
        weights = None
        if info.uses_weight and spec.weight_channel:
            if not cloud.has_channel(spec.weight_channel):
                raise PcrError(Status.error(
                    StatusCode.InvalidArgument,
                    f"pipeline: weight channel {spec.weight_channel!r} "
                    f"not found"))
            weights = cloud.channel_array_f32(spec.weight_channel)
        timestamps = None
        if info.uses_timestamp:
            is_prio = ReductionType(spec.type) == ReductionType.PriorityMerge
            ch = spec.priority_channel if is_prio else spec.timestamp_channel
            if ch and cloud.has_channel(ch):
                timestamps = cloud.channel_array_f32(ch)
            elif is_prio:
                # no priority channel: every point ties, the deterministic
                # argmax keeps the first-ingested value per cell
                timestamps = np.zeros(n, dtype=np.float32)
            else:
                # Fallback: ingestion order (later collections win).
                # The reference leaves MostRecent unregistered; with no
                # timestamp the strict-> combine would never replace, so
                # ingest order is the useful interpretation.
                timestamps = np.arange(
                    self._points, self._points + n, dtype=np.float32)
        return weights, timestamps

    def _ingest_spec(self, i, spec, info, cloud, x, y, col, row, valid):
        n = cloud.count()
        values = self._values_for(spec, cloud, n)
        if info.scatter_kind == "collect":
            # Order statistics (Median/Percentile) retain the raw stream;
            # the exact quantile is computed at finalize (ops/reduction.py).
            flat = (row[valid].astype(np.int64) * self.config.grid.width
                    + col[valid].astype(np.int64))
            self._collect[i].append(
                flat, np.asarray(values, np.float32)[valid])
            return
        weights, timestamps = self._aux_channels(spec, info, cloud, n)
        gt = GlyphType(spec.glyph.type)
        if self._backend == "cpu":
            self._ingest_cpu(i, spec, info, gt, cloud, x, y, col, row, valid,
                             values, weights, timestamps)
        else:
            self._ingest_device(i, spec, gt, cloud, x, y, col, row, valid,
                                values, weights, timestamps)

    # -- CPU path ---------------------------------------------------------------

    def _ingest_cpu_tiled(self, i, spec, info, gt, cloud, x, y, col, row,
                          valid, values, weights, timestamps):
        """Out-of-core CPU ingest: group points by home tile, accumulate
        into each tile's TileManager state block (acquire → accumulate →
        release), mirroring the reference's per-tile batch loop
        (pipeline.cpp:688-733)."""
        cfg = self.config.grid
        mgr = self._managers[i]
        tcol = col // cfg.tile_width
        trow = row // cfg.tile_height
        tid = trow.astype(np.int64) * cfg.tiles_x + tcol.astype(np.int64)
        tid = np.where(valid, tid, -1)
        for t in np.unique(tid):
            if t < 0:
                continue
            sel = tid == t
            tile = TileIndex(row=int(t) // cfg.tiles_x,
                             col=int(t) % cfg.tiles_x)
            cs, rs, cc, rc = cfg.tile_cell_range(tile)
            block = mgr.acquire(tile)
            state = [block[f] for f in range(info.state_floats)]
            region = (cs, rs, cc, rc)
            if gt == GlyphType.Point:
                flat = ((row[sel].astype(np.int64) - rs) * cc
                        + (col[sel].astype(np.int64) - cs))
                st = cpu.accumulate_point_cpu(
                    info, state, flat, values[sel],
                    weights[sel] if weights is not None else None,
                    timestamps[sel] if timestamps is not None else None)
            elif gt == GlyphType.Gaussian:
                st = cpu.accumulate_gaussian_cpu(
                    spec.glyph, spec.type, cfg, state, x[sel], y[sel],
                    values[sel],
                    _ch(cloud, spec.glyph.sigma_x_channel, sel),
                    _ch(cloud, spec.glyph.sigma_y_channel, sel),
                    _ch(cloud, spec.glyph.rotation_channel, sel),
                    col[sel], row[sel], region=region)
            else:   # Line
                st = cpu.accumulate_line_cpu(
                    spec.glyph, spec.type, cfg, state, x[sel], y[sel],
                    values[sel],
                    _ch(cloud, spec.glyph.direction_channel, sel),
                    _ch(cloud, spec.glyph.half_length_channel, sel),
                    col[sel], row[sel], region=region)
            mgr.release(tile)
            if not st.ok():
                raise PcrError(st)

    def _ingest_cpu(self, i, spec, info, gt, cloud, x, y, col, row, valid,
                    values, weights, timestamps):
        cfg = self.config.grid
        if self._tiled:
            return self._ingest_cpu_tiled(i, spec, info, gt, cloud, x, y,
                                          col, row, valid, values, weights,
                                          timestamps)
        state = self._host_state[i]
        v = valid
        if gt == GlyphType.Point:
            flat = (row[v].astype(np.int64) * cfg.width
                    + col[v].astype(np.int64))
            st = cpu.accumulate_point_cpu(
                info, state, flat, values[v],
                weights[v] if weights is not None else None,
                timestamps[v] if timestamps is not None else None)
        elif gt == GlyphType.Gaussian:
            st = cpu.accumulate_gaussian_cpu(
                spec.glyph, spec.type, cfg, state, x[v], y[v], values[v],
                _ch(cloud, spec.glyph.sigma_x_channel, v),
                _ch(cloud, spec.glyph.sigma_y_channel, v),
                _ch(cloud, spec.glyph.rotation_channel, v),
                col[v], row[v])
        elif gt == GlyphType.Line:
            st = cpu.accumulate_line_cpu(
                spec.glyph, spec.type, cfg, state, x[v], y[v], values[v],
                _ch(cloud, spec.glyph.direction_channel, v),
                _ch(cloud, spec.glyph.half_length_channel, v),
                col[v], row[v])
        else:
            st = Status.error(StatusCode.NotImplemented,
                              f"unknown glyph type {gt}")
        if not st.ok():
            raise PcrError(st)

    # -- device path --------------------------------------------------------------

    def _prepare_device(self, i, spec, gt, cloud, x, y, col, row, valid,
                        values, weights, timestamps):
        """Host-route one cloud for one spec and stage its packed chunks on
        the device. Returns the staged chunk list (commit runs the
        kernels). Host-sourced and staged ingest take the same layouts."""
        cfg = self.config.grid
        eng = self._engine
        if gt == GlyphType.Point:
            return eng.prepare_point(i, None, valid, values, weights,
                                     timestamps, col=col, row=row)
        if gt == GlyphType.Gaussian:
            gp = routing.gaussian_params(
                spec.glyph, cfg, x, y,
                routing.glyph_channel(cloud, spec.glyph.sigma_x_channel),
                routing.glyph_channel(cloud, spec.glyph.sigma_y_channel),
                routing.glyph_channel(cloud, spec.glyph.rotation_channel))
            return eng.prepare_gaussian(i, gp, valid, values)
        if gt == GlyphType.Line:
            lp = routing.line_params(
                spec.glyph, cfg, x, y,
                routing.glyph_channel(cloud, spec.glyph.direction_channel),
                routing.glyph_channel(cloud, spec.glyph.half_length_channel))
            return eng.prepare_line(i, lp, valid, values, col, row)
        raise PcrError(Status.error(StatusCode.NotImplemented,
                                    f"unknown glyph type {gt}"))

    def _ingest_device(self, i, spec, gt, cloud, x, y, col, row, valid,
                       values, weights, timestamps):
        n = len(x)
        # User-pinned device chunk size (pipeline.h:67 declares it; the
        # reference never reads it — honored here): slice the cloud and
        # commit chunk-by-chunk.
        cs = int(self.config.chunk_size)
        if cs <= 0 or n <= cs:
            cs = max(n, 1)
        for a in range(0, n, cs):
            sl = slice(a, min(a + cs, n))
            staged = self._prepare_device(
                i, spec, gt, cloud, x[sl], y[sl], col[sl], row[sl],
                valid[sl], values[sl],
                weights[sl] if weights is not None else None,
                timestamps[sl] if timestamps is not None else None)
            self._engine.commit(i, staged)

    # -- bookkeeping -------------------------------------------------------------

    def _tiles_of(self, col, row, valid=None):
        """Exact set of (tile_row, tile_col) touched by the given cells
        (an O(N) presence scan, no sort)."""
        cfg = self.config.grid
        ntiles = cfg.tiles_x * cfg.tiles_y
        if len(col) == 0:
            return []
        any_valid = bool(valid.any()) if valid is not None else True
        if not any_valid:
            return []
        if ntiles == 1:
            # single-tile grid (tile 4096^2 default covers most grids)
            return [(0, 0)]
        tid = ((row // np.int32(cfg.tile_height)) * np.int32(cfg.tiles_x)
               + (col // np.int32(cfg.tile_width)))
        if valid is not None:
            # route invalid entries to a scratch bin instead of a gather
            tid = np.where(valid, tid, np.int32(ntiles))
        present = np.bincount(tid.ravel(), minlength=ntiles + 1)[:ntiles]
        t = np.flatnonzero(present)
        return [(int(ti) // cfg.tiles_x, int(ti) % cfg.tiles_x) for ti in t]

    def _track_tiles(self, col, row, valid=None):
        self._touched_tiles.update(self._tiles_of(col, row, valid))

    def _emit_progress(self):
        if self._progress_cb is None:
            return
        info = self.stats()
        if not self._progress_cb(info):
            self._cancelled = True
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "pipeline: cancelled by user"))

    # -- finalize ----------------------------------------------------------------

    def finalize(self) -> None:
        """Flush tile state, assemble the result Grid, write GeoTIFF output
        (reference: pipeline.cpp:1154-1363)."""
        if self._backend == _DEVICE:
            # Small grids finalize in one device pass and one copy to the
            # host (_finalize_packed); large grids stream row strips with
            # encode/checkpoint overlap (_finalize_streamed). With
            # state_dir set, only the raw state planes come to the host
            # and the band is finalized there from the same bytes that
            # become the PCRT checkpoint.
            cfg = self.config.grid
            need_state = bool(self.config.state_dir)
            pack_max = int(os.environ.get("PCR_PACK_MAX_BYTES",
                                          str(8 << 20)))
            worst = 0
            for spec, info in self._plans:
                if info.scatter_kind == "collect":
                    continue
                planes = info.state_floats if need_state else 1
                worst = max(worst, planes * cfg.height * cfg.width * 4)
            # With an encoded output the streamed path wins earlier: the
            # LZW encode of strip k-1 overlaps the fetch of strip k.
            stream_min = (_STREAM_MIN_BYTES if self.config.output_path
                          else pack_max)
            if worst <= min(pack_max, 2 * stream_min - 1):
                return self._finalize_packed(need_state)
            return self._finalize_streamed(need_state)
        if self.config.state_dir or self._tiled:
            self._flush_state()

        cfg = self.config.grid
        grid = Grid.create(cfg.width, cfg.height, self._band_descs(),
                           MemoryLocation.Host)
        # When every tile was touched the NaN prefill is fully overwritten —
        # skip it (and the extra full-band copy below).
        all_touched = (len(self._touched_tiles)
                       == cfg.tiles_x * cfg.tiles_y)
        for i, (spec, info) in enumerate(self._plans):
            # Per-tile finalize, reference semantics (pipeline.cpp:1204-1283):
            # bands start NaN; only tiles with state are finalized, so e.g.
            # Sum yields 0.0 for empty cells inside touched tiles and NaN
            # for untouched tiles.
            band = (np.empty((cfg.height, cfg.width), dtype=np.float32)
                    if all_touched else
                    np.full((cfg.height, cfg.width), np.nan,
                            dtype=np.float32))
            if info.scatter_kind == "collect":
                grid.set_band_array(i, self._collect_band(i, spec))
                continue
            if self._tiled:
                mgr = self._managers[i]
                for (trow, tcol) in self._touched_tiles:
                    tile = TileIndex(row=trow, col=tcol)
                    cs, rs, cc, rc = cfg.tile_cell_range(tile)
                    block = mgr.acquire(tile)
                    tile_fields = [block[f]
                                   for f in range(info.state_floats)]
                    band[rs:rs + rc, cs:cs + cc] = np.asarray(
                        info.finalize_arrays(tile_fields), dtype=np.float32)
            elif all_touched:
                band = np.asarray(
                    info.finalize_arrays(list(self._host_state[i])),
                    dtype=np.float32)
                if any(band is f for f in self._host_state[i]):
                    band = band.copy()   # Sum finalize returns state itself
            else:
                fields = self._host_state[i]
                for (trow, tcol) in self._touched_tiles:
                    cs, rs, cc, rc = cfg.tile_cell_range(
                        TileIndex(row=trow, col=tcol))
                    tile_fields = [f[rs:rs + rc, cs:cs + cc] for f in fields]
                    band[rs:rs + rc, cs:cs + cc] = np.asarray(
                        info.finalize_arrays(tile_fields), dtype=np.float32)
            grid.set_band_array(i, band, copy=False)
        self._result = grid
        self._finalized = True
        self._write_output(grid)

    def _write_output(self, grid) -> None:
        if self.config.output_path:
            from ..io.geotiff import write_geotiff
            st = write_geotiff(self.config.output_path, grid,
                               self.config.grid, self._geotiff_opts())
            if not st.ok():
                raise PcrError(st)

    def _band_names(self):
        return [(spec.output_band_name
                 or f"{spec.value_channel}_{int(spec.type)}")
                for spec, _ in self._plans]

    def _band_descs(self):
        return [BandDesc(name=n, dtype=DataType.Float32, is_state=False)
                for n in self._band_names()]

    def _mask_strip(self, band, host, r0, r1):
        """Copy the touched-tile regions of a fetched row strip into the
        NaN-initialized output band (per-tile finalize semantics,
        pipeline.cpp:1204-1283)."""
        cfg = self.config.grid
        t0 = r0 // cfg.tile_height
        t1 = (r1 - 1) // cfg.tile_height
        for trow in range(t0, t1 + 1):
            for tcol in range(cfg.tiles_x):
                if (trow, tcol) not in self._touched_tiles:
                    continue
                cs, rs, cc, rc = cfg.tile_cell_range(
                    TileIndex(row=trow, col=tcol))
                a, b = max(rs, r0), min(rs + rc, r1)
                if a < b:
                    band[a:b, cs:cs + cc] = host[a - r0:b - r0, cs:cs + cc]

    def _collect_band(self, i, spec):
        """Assemble an order-statistics (Median/Percentile) band from the
        collected (cell, value) stream (spill-backed: collect_spill)."""
        cfg = self.config.grid
        q = (0.5 if ReductionType(spec.type) == ReductionType.Median
             else float(spec.percentile))
        return self._collect[i].band((cfg.height, cfg.width), q)

    def _geotiff_opts(self):
        from ..io.geotiff import GeoTiffOptions
        # LZW default like the reference (GeoTiffOptions/grid_io.h); the
        # native C++ codec keeps it fast. Without a compiler, fall back
        # to zlib level 1 (the pure-Python LZW is too slow for the
        # pipeline hot path).
        if native.available():
            return GeoTiffOptions(cloud_optimized=self.config.write_cog)
        return GeoTiffOptions(cloud_optimized=self.config.write_cog,
                              compress="DEFLATE", compress_level=1)

    def _finalize_packed(self, need_state: bool) -> None:
        """Small-grid device finalize: per reduction, one device pass whose
        result comes to the host in one copy. With `need_state` the copy
        carries the raw state planes — the PCRT checkpoint is written from
        them and the band is host-finalized, so checkpointing costs no
        extra copy (the reference's flush_all + assemble single pass,
        pipeline.cpp:1154-1363)."""
        cfg = self.config.grid
        eng = self._engine
        grid = Grid.create(cfg.width, cfg.height, self._band_descs(),
                           MemoryLocation.Host)
        all_touched = (len(self._touched_tiles)
                       == cfg.tiles_x * cfg.tiles_y)
        for i, (spec, info) in enumerate(self._plans):
            if info.scatter_kind == "collect":
                grid.set_band_array(i, self._collect_band(i, spec),
                                    copy=False)
                continue
            host = eng.finalize_packed_async(i, need_state)
            if need_state:
                fields = [host[k] for k in range(info.state_floats)]
                self._write_state_tiles(i, fields)
                full = np.asarray(info.finalize_arrays(fields),
                                  dtype=np.float32)
                if any(full is f for f in fields):
                    full = full.copy()   # Sum finalize returns state itself
            else:
                full = host[0]
            if all_touched:
                band = np.ascontiguousarray(full, dtype=np.float32)
            else:
                band = np.full((cfg.height, cfg.width), np.nan,
                               dtype=np.float32)
                for (trow, tcol) in self._touched_tiles:
                    cs, rs, cc, rc = cfg.tile_cell_range(
                        TileIndex(row=trow, col=tcol))
                    band[rs:rs + rc, cs:cs + cc] = full[rs:rs + rc,
                                                        cs:cs + cc]
            grid.set_band_array(i, band, copy=False)
        self._result = grid
        self._finalized = True
        self._write_output(grid)

    def _finalize_streamed(self, need_state: bool = False) -> None:
        """Large-grid device finalize with encode/checkpoint overlap: per
        reduction the engine finalizes on the device and hands back row
        strips (~2 MB each, _STRIP_TARGET_BYTES); a writer thread
        LZW-encodes strip k-1 into the GeoTIFF (and, with `need_state`,
        writes the PCRT checkpoint from the same strips) while the main
        thread masks strip k."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.config.grid
        eng = self._engine
        names = self._band_names()
        grid = Grid.create(cfg.width, cfg.height, self._band_descs(),
                           MemoryLocation.Host)
        writer = None
        if self.config.output_path:
            from ..io.geotiff import StreamingGeoTiffWriter
            writer = StreamingGeoTiffWriter(self.config.output_path, cfg,
                                            names, self._geotiff_opts())
        target = _STRIP_TARGET_BYTES
        # when every tile is touched the NaN prefill is fully overwritten
        # by _mask_strip — skip the extra full-band pass on the host
        all_touched = (len(self._touched_tiles)
                       == cfg.tiles_x * cfg.tiles_y)
        ex = ThreadPoolExecutor(max_workers=1)
        futures = []
        bands = []
        try:
            for i, (spec, info) in enumerate(self._plans):
                if info.scatter_kind == "collect":
                    band = self._collect_band(i, spec)
                    if writer is not None:
                        futures.append(ex.submit(writer.write_rows, band))
                        futures.append(ex.submit(writer.end_band))
                    grid.set_band_array(i, band, copy=False)
                    bands.append(band)
                    continue
                nplanes = info.state_floats if need_state else 1
                rows = max(1, target // (cfg.width * 4 * nplanes))
                if writer is not None and rows >= cfg.height > 1:
                    # keep >=2 strips so the tail encode overlaps
                    rows = (cfg.height + 1) // 2
                strips = eng.finalize_strips(i, min(rows, cfg.height),
                                             with_state=need_state)
                band = (np.empty((cfg.height, cfg.width), dtype=np.float32)
                        if all_touched else
                        np.full((cfg.height, cfg.width), np.nan,
                                dtype=np.float32))
                fields = ([np.empty((cfg.height, cfg.width), np.float32)
                           for _ in range(info.state_floats)]
                          if need_state else None)
                for r0, r1, host in strips:
                    if need_state:
                        for k in range(info.state_floats):
                            fields[k][r0:r1] = host[k]
                        fin = np.asarray(
                            info.finalize_arrays([host[k] for k in
                                                  range(info.state_floats)]),
                            dtype=np.float32)
                    else:
                        fin = host
                    self._mask_strip(band, fin, r0, r1)
                    if writer is not None:
                        futures.append(ex.submit(writer.write_rows,
                                                 band[r0:r1]))
                if writer is not None:
                    futures.append(ex.submit(writer.end_band))
                if need_state:
                    futures.append(ex.submit(self._write_state_tiles,
                                             i, fields))
                grid.set_band_array(i, band, copy=False)
                bands.append(band)
            for f in futures:
                f.result()
            if writer is not None:
                st = writer.close(
                    overview_bands=bands if self.config.write_cog else None)
                if not st.ok():
                    raise PcrError(st)
        finally:
            ex.shutdown(wait=True)
        self._result = grid
        self._finalized = True

    # -- convenience ----------------------------------------------------------------

    def run(self, clouds) -> None:
        for c in clouds:
            self.ingest(c)
        self.finalize()

    def warmup(self, chunk_points: int = 0) -> None:
        """Absorb one-time device costs before timed work: the CUDA kernel
        build and device start-up. PyTorch runs eagerly, so there are no
        per-shape compiles to warm and `chunk_points` (kept for API
        compatibility) changes nothing. No-op on the CPU backend."""
        if self._backend == _DEVICE:
            self._engine.warmup()

    def set_progress_callback(self, cb) -> None:
        self._progress_cb = cb

    def result(self) -> Grid | None:
        """The finalized grid (None before finalize())."""
        return self._result if self._finalized else None

    def stats(self) -> ProgressInfo:
        return ProgressInfo(
            collections_processed=self._collections,
            collections_total=0,
            points_processed=self._points,
            tiles_active=len(self._touched_tiles),
            elapsed_seconds=time.perf_counter() - self._start,
        )

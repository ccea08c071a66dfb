"""
pcr_tpu_torch — the PyTorch / CUDA port of pcr_tpu, for NVIDIA Hopper.

The same public API as pcr_tpu (pcr_tpu/__init__.py:37-229): switch with
`import pcr_tpu_torch as pcr`. Device state lives in torch tensors, and the
TPU's Pallas kernels become hand-written Hopper kernels (CUDA C++ under
`csrc/`, built with nvcc at first use). The device-neutral host layers —
core types, the reduction registry, routing, filters, glyph specs, the
numpy CPU oracle, I/O and the native C++ helpers — are pcr_tpu's own,
imported rather than copied; none of them imports jax.

Ported so far: the Point, Gaussian and Line glyphs on the device path
(ExecutionMode.GPU / Auto / Hybrid), host-sourced and staged ingest,
finalize with PCRT checkpoints and GeoTIFF output, and resume. Point Sum /
Count / Average / WeightedAverage run kernel K1 (engine/kernels.py); Max /
Min / MostRecent / PriorityMerge run torch scatters; Median / Percentile
stay host-side. Gaussian splats run kernels K2 (separable), K4 (dense
rotated) and K5 (windowed rotated) (engine/gauss_kernels.py); Line glyphs
run kernel K3, the rect splat of their Bresenham runs
(engine/line_kernels.py). Kernel K6 is a micro-probe with its own entry
point (probes/rot_expand.py). Custom reductions, out-of-core banding and
meshes are refused on the device path (NotImplemented) and run on the CPU
backend.
"""

from pcr_tpu import __version__  # noqa: F401
from pcr_tpu import gaussian_splat_spec, line_splat_spec
from pcr_tpu.core.grid import BandDesc, Grid
from pcr_tpu.core.grid_config import GridConfig
from pcr_tpu.core.point_cloud import ChannelDesc, PointCloud
from pcr_tpu.core.types import (
    BBox,
    CRS,
    DataType,
    MemoryLocation,
    NoDataPolicy,
    PcrError,
    ReductionType,
    Status,
    StatusCode,
    TileIndex,
    data_type_size,
)
from pcr_tpu.engine.filter import CompareOp, FilterPredicate, FilterSpec
from pcr_tpu.engine.glyph import GlyphSpec, GlyphType
from pcr_tpu.io.geotiff import (
    GeoTiffOptions,
    TiledGeoTiffWriter,
    read_geotiff_band,
    read_geotiff_info,
    write_geotiff,
)
from pcr_tpu.io.point_cloud_io import (
    PointCloudFormat,
    PointCloudInfo,
    PointCloudReader,
    read_point_cloud,
    read_point_cloud_info,
    write_point_cloud,
)
from pcr_tpu.ops.reduction import (
    ReductionInfo,
    ReductionOp,
    get_reduction_info,
    register_custom_reduction,
    registered_reductions,
    unregister_reduction,
)

from .core.device import (
    cuda_device_available,
    cuda_device_count,
    cuda_device_name,
    cuda_is_compiled,
    cuda_memory_info,
)
from .engine.pipeline import (
    ExecutionMode,
    Pipeline,
    PipelineConfig,
    ProgressInfo,
    ReductionSpec,
)

__all__ = [
    # Enums
    "DataType", "ReductionType", "MemoryLocation", "ExecutionMode",
    "StatusCode", "CompareOp", "PointCloudFormat", "GlyphType",
    # Core types
    "BBox", "CRS", "NoDataPolicy", "TileIndex", "Status", "PcrError",
    "ChannelDesc", "BandDesc",
    # Grid
    "GridConfig", "Grid",
    # PointCloud
    "PointCloud",
    # Filter
    "FilterPredicate", "FilterSpec",
    # Pipeline / Glyph
    "GlyphSpec", "ReductionSpec", "PipelineConfig", "ProgressInfo", "Pipeline",
    # Glyph helpers
    "gaussian_splat_spec", "line_splat_spec",
    # Ops
    "ReductionOp", "ReductionInfo", "get_reduction_info", "registered_reductions",
    "register_custom_reduction", "unregister_reduction",
    # I/O — GeoTIFF
    "GeoTiffOptions", "write_geotiff", "read_geotiff_info", "read_geotiff_band",
    "TiledGeoTiffWriter",
    # I/O — Point cloud
    "PointCloudInfo", "read_point_cloud", "write_point_cloud",
    "read_point_cloud_info", "PointCloudReader",
    # Device probes
    "data_type_size", "cuda_is_compiled", "cuda_device_available",
    "cuda_device_count", "cuda_device_name", "cuda_memory_info",
]

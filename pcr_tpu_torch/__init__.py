"""
pcr_tpu_torch — the PyTorch / CUDA port of pcr_tpu, for NVIDIA Hopper.

The same public API as pcr_tpu (pcr_tpu/__init__.py:37-229): switch with
`import pcr_tpu_torch as pcr`. Device state lives in torch tensors, and the
TPU's Pallas kernels become hand-written Hopper kernels (CUDA C++ under
`csrc/`, built with nvcc at first use). The package stands alone: its host
layers — core types, the reduction registry, routing, filters, glyph specs,
the numpy CPU oracle, I/O and the native C++ helpers — are its own copies
of pcr_tpu's, and nothing in it imports pcr_tpu or jax.

Entry points run on the CUDA card unless the caller asks for the CPU
(ExecutionMode.CPU, gpu_fallback_to_cpu=True, or PCR_TORCH_DEVICE=cpu);
without a card the device modes raise StatusCode.CudaError.

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

__version__ = "0.5.0"   # the port's own: its fifth slice

from .core.device import (
    cuda_device_available,
    cuda_device_count,
    cuda_device_name,
    cuda_is_compiled,
    cuda_memory_info,
)
from .core.grid import BandDesc, Grid
from .core.grid_config import GridConfig
from .core.point_cloud import ChannelDesc, PointCloud
from .core.types import (
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
from .engine.filter import CompareOp, FilterPredicate, FilterSpec
from .engine.glyph import GlyphSpec, GlyphType
from .engine.pipeline import (
    ExecutionMode,
    Pipeline,
    PipelineConfig,
    ProgressInfo,
    ReductionSpec,
)
from .io.geotiff import (
    GeoTiffOptions,
    TiledGeoTiffWriter,
    read_geotiff_band,
    read_geotiff_info,
    write_geotiff,
)
from .io.point_cloud_io import (
    PointCloudFormat,
    PointCloudInfo,
    PointCloudReader,
    read_point_cloud,
    read_point_cloud_info,
    write_point_cloud,
)
from .ops.reduction import (
    ReductionInfo,
    ReductionOp,
    get_reduction_info,
    register_custom_reduction,
    registered_reductions,
    unregister_reduction,
)


# ---------------------------------------------------------------------------
# Convenience helpers for glyph ReductionSpec construction
# (reference: python/pcr/__init__.py:73-181)
# ---------------------------------------------------------------------------

def gaussian_splat_spec(
    value_channel,
    sigma_x_channel="",
    sigma_y_channel="",
    rotation_channel="",
    default_sigma=1.0,
    default_sigma_x=None,
    default_sigma_y=None,
    default_rotation=0.0,
    max_radius_cells=32.0,
    output_band_name=None,
):
    """Build a ``ReductionSpec`` that rasterizes each point as an
    anisotropic Gaussian blob (WeightedAverage reduction).

    Instead of landing on a single cell, every point contributes
    ``w = exp(-(dx²/2σx² + dy²/2σy²))`` to all cells within its truncated
    elliptical footprint — useful for turning sparse clouds into smooth
    continuous surfaces.  On the device path axis-aligned blobs take the
    separable splat (kernel K2); nonzero rotation routes through the
    rotated splats (K4, K5).

    Arguments mirror the fields they populate on ``spec.glyph``:

    - ``value_channel``: which point channel supplies the splatted value.
    - ``sigma_x_channel`` / ``sigma_y_channel`` / ``rotation_channel``:
      names of per-point channels overriding the ellipse shape.  An empty
      string means "use the scalar default below for every point".
    - ``default_sigma``: isotropic fallback σ (world units); the
      per-axis ``default_sigma_x`` / ``default_sigma_y`` win when given.
    - ``default_rotation``: fallback ellipse angle, radians CCW.
    - ``max_radius_cells``: hard cap on the footprint half-width, in
      cells, so one wild σ cannot splat the whole grid.
    - ``output_band_name``: optional label for the resulting band.

    Equivalent of the reference helper (python/pcr/__init__.py:73-131);
    semantics of the kernel match glyph_kernels.cu:98-143.
    """
    spec = ReductionSpec()
    spec.value_channel = value_channel
    spec.type = ReductionType.WeightedAverage
    spec.glyph.type = GlyphType.Gaussian
    spec.glyph.sigma_x_channel = sigma_x_channel
    spec.glyph.sigma_y_channel = sigma_y_channel
    spec.glyph.rotation_channel = rotation_channel
    spec.glyph.default_sigma_x = (
        default_sigma_x if default_sigma_x is not None else default_sigma
    )
    spec.glyph.default_sigma_y = (
        default_sigma_y if default_sigma_y is not None else default_sigma
    )
    spec.glyph.default_rotation = default_rotation
    spec.glyph.max_radius_cells = max_radius_cells
    if output_band_name:
        spec.output_band_name = output_band_name
    return spec


def line_splat_spec(
    value_channel,
    direction_channel="",
    half_length_channel="",
    default_direction=0.0,
    default_half_length=1.0,
    max_radius_cells=32.0,
    output_band_name=None,
):
    """Build a ``ReductionSpec`` that rasterizes each point as a thin
    line segment (WeightedAverage reduction).

    The segment is centered on the point, runs along ``direction``
    (radians, 0 = +X/East), and spans ``half_length`` world units to
    either side; cells are selected by Bresenham traversal so the stroke
    stays one cell wide at any angle.  The device path expands segments
    into closed-form Bresenham runs and commits them through the rect
    splat (kernel K3), so cost scales with covered cells, not with a
    per-point loop.

    - ``value_channel``: point channel whose value the stroke deposits.
    - ``direction_channel`` / ``half_length_channel``: per-point
      overrides; empty string selects the scalar defaults.
    - ``default_direction`` / ``default_half_length``: used when no
      per-point channel is named.
    - ``max_radius_cells``: clamp on the stroke's reach in cells.
    - ``output_band_name``: optional label for the resulting band.

    Equivalent of the reference helper (python/pcr/__init__.py:134-181);
    stroke semantics match glyph_kernels.cu:145-176.
    """
    spec = ReductionSpec()
    spec.value_channel = value_channel
    spec.type = ReductionType.WeightedAverage
    spec.glyph.type = GlyphType.Line
    spec.glyph.direction_channel = direction_channel
    spec.glyph.half_length_channel = half_length_channel
    spec.glyph.default_direction = default_direction
    spec.glyph.default_half_length = default_half_length
    spec.glyph.max_radius_cells = max_radius_cells
    if output_band_name:
        spec.output_band_name = output_band_name
    return spec


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

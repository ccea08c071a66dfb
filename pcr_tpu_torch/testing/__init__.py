"""Test-data generators and raster comparison (copies of pcr_tpu/testing)."""

from .compare import (  # noqa: F401
    RasterComparison, assert_rasters_match, compare_rasters,
)
from . import generators  # noqa: F401

"""The port's I/O: PCRT tile state, GeoTIFF, point-cloud files (copies of
pcr_tpu/io)."""

from .tile_state_io import (  # noqa: F401
    read_tile_state, read_tile_state_header, tile_state_filename,
    write_tile_state,
)
from .geotiff import (  # noqa: F401
    GeoTiffOptions, TiledGeoTiffWriter, read_geotiff_band,
    read_geotiff_info, write_geotiff,
)
from .point_cloud_io import (  # noqa: F401
    PointCloudFormat, PointCloudInfo, PointCloudReader, detect_format,
    read_point_cloud, read_point_cloud_info, write_point_cloud,
)

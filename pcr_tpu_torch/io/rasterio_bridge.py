"""
Interop bridge to the rasterio/GDAL ecosystem (the reference ships an empty
python/pcr/rasterio_bridge.py stub; this is a working implementation).

rasterio is not a dependency; when it is importable these helpers move
Grids to/from rasterio datasets, and either way `grid_profile` produces the
standard rasterio-style profile dict (transform, crs, dtype, nodata) so
downstream GIS tooling can consume pipeline outputs without reading our
GeoTIFFs back.

The port's copy of pcr_tpu/io/rasterio_bridge.py, on the port's own core
types.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import BandDesc, Grid
from ..core.grid_config import GridConfig
from ..core.types import DataType, PcrError, Status, StatusCode

__all__ = ["grid_profile", "to_rasterio", "from_rasterio",
           "rasterio_available"]


def rasterio_available() -> bool:
    try:
        import rasterio  # noqa: F401
        return True
    except ImportError:
        return False


def grid_profile(config: GridConfig, count: int = 1) -> dict:
    """rasterio-style profile dict for a GridConfig."""
    gt = config.gdal_geotransform()
    profile = {
        "driver": "GTiff",
        "width": config.width,
        "height": config.height,
        "count": count,
        "dtype": "float32",
        "nodata": float("nan"),
        # affine transform coefficients (a, b, c, d, e, f) in rasterio order
        "transform": (gt[1], gt[2], gt[0], gt[4], gt[5], gt[3]),
    }
    if config.crs.epsg:
        profile["crs"] = f"EPSG:{config.crs.epsg}"
    elif config.crs.wkt:
        profile["crs"] = config.crs.wkt
    return profile


def to_rasterio(path: str, grid: Grid, config: GridConfig) -> None:
    """Write a Grid through rasterio (requires rasterio installed)."""
    if not rasterio_available():
        raise PcrError(Status.error(StatusCode.NotImplemented,
                                    "rasterio is not installed"))
    import rasterio
    from rasterio.transform import Affine
    profile = grid_profile(config, count=grid.num_bands())
    t = profile.pop("transform")
    profile["transform"] = Affine(*t)
    with rasterio.open(path, "w", **profile) as dst:
        for i in range(grid.num_bands()):
            dst.write(np.asarray(grid.band_array(i), np.float32), i + 1)
            dst.set_band_description(i + 1, grid.band_desc(i).name)


def from_rasterio(path: str):
    """Read a raster through rasterio into (Grid, GridConfig)."""
    if not rasterio_available():
        raise PcrError(Status.error(StatusCode.NotImplemented,
                                    "rasterio is not installed"))
    import rasterio
    from ..core.types import BBox, CRS
    with rasterio.open(path) as src:
        cfg = GridConfig()
        b = BBox()
        b.min_x, b.min_y, b.max_x, b.max_y = src.bounds
        cfg.bounds = b
        cfg.cell_size_x = src.transform.a
        cfg.cell_size_y = src.transform.e
        if src.crs is not None and src.crs.to_epsg():
            cfg.crs = CRS.from_epsg(src.crs.to_epsg())
        cfg.compute_dimensions()
        bands = [BandDesc(name=src.descriptions[i] or f"band_{i + 1}",
                          dtype=DataType.Float32)
                 for i in range(src.count)]
        grid = Grid.create(src.width, src.height, bands)
        for i in range(src.count):
            grid.set_band_array(i, src.read(i + 1).astype(np.float32))
    return grid, cfg

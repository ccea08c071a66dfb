"""
Raster visualization helpers (the reference ships an empty
python/pcr/visualization.py stub; this is a working implementation).

Renders Grid bands / numpy rasters to PNG with nodata-aware normalization
and a few built-in colormaps, using matplotlib when present and a
dependency-free grayscale/viridis-approximation fallback via PIL.

The port's copy of pcr_tpu/utils/visualization.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_band", "save_png", "coverage"]


def coverage(band: np.ndarray) -> float:
    """Fraction of cells with data (non-NaN)."""
    return float(np.isfinite(band).mean())


def render_band(band: np.ndarray, cmap: str = "viridis",
                vmin: float | None = None, vmax: float | None = None,
                nodata_color=(0, 0, 0)) -> np.ndarray:
    """Render a (H, W) float band to an (H, W, 3) uint8 RGB image.

    NaN cells render as nodata_color; the value range defaults to the
    finite min/max."""
    band = np.asarray(band, dtype=np.float64)
    m = np.isfinite(band)
    if vmin is None:
        vmin = float(band[m].min()) if m.any() else 0.0
    if vmax is None:
        vmax = float(band[m].max()) if m.any() else 1.0
    span = max(vmax - vmin, 1e-300)
    norm = np.clip((band - vmin) / span, 0.0, 1.0)
    norm = np.where(m, norm, 0.0)

    rgb = _apply_cmap(norm, cmap)
    for c in range(3):
        rgb[..., c] = np.where(m, rgb[..., c], nodata_color[c])
    return rgb.astype(np.uint8)


def _apply_cmap(norm: np.ndarray, cmap: str) -> np.ndarray:
    try:
        import matplotlib.cm as cm
        mapped = cm.get_cmap(cmap)(norm)
        return (mapped[..., :3] * 255.0)
    except Exception:
        pass
    if cmap == "gray":
        g = norm * 255.0
        return np.stack([g, g, g], axis=-1)
    # compact viridis-like polynomial approximation
    r = np.clip(255 * (0.267 + 0.005 * norm + 0.72 * norm ** 3), 0, 255)
    g = np.clip(255 * (0.005 + 0.90 * norm), 0, 255)
    b = np.clip(255 * (0.33 + 0.62 * norm - 0.80 * norm ** 2), 0, 255)
    return np.stack([r, g, b], axis=-1)


def save_png(path: str, band: np.ndarray, cmap: str = "viridis",
             vmin: float | None = None, vmax: float | None = None) -> None:
    """Render a band and write it as PNG."""
    rgb = render_band(band, cmap=cmap, vmin=vmin, vmax=vmax)
    from PIL import Image
    Image.fromarray(rgb).save(path)

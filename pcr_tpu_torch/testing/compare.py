"""
Raster comparison helpers (the reference ships an empty python/pcr/testing.py
stub; this is a working implementation of the parity machinery its scripts
use — compare_cpu_gpu_patterns.py:28-95).

The port's copy of pcr_tpu/testing/compare.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["RasterComparison", "compare_rasters", "assert_rasters_match"]


@dataclass
class RasterComparison:
    ok: bool
    max_diff: float
    num_different: int
    nan_mismatch: int
    cells_compared: int

    def __str__(self) -> str:
        return (f"{'PASS' if self.ok else 'FAIL'} "
                f"max_diff={self.max_diff:.3e} "
                f"num_different={self.num_different} "
                f"nan_mismatch={self.nan_mismatch}")


def compare_rasters(a: np.ndarray, b: np.ndarray,
                    atol: float = 1e-5, rtol: float = 1e-5
                    ) -> RasterComparison:
    """Cell-wise comparison with |a-b| <= atol + rtol*|a| and NaN-pattern
    equality. The reference's bar is atol=1e-4, rtol=0."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return RasterComparison(False, float("inf"), a.size, 0, 0)
    nan_mismatch = int((np.isnan(a) != np.isnan(b)).sum())
    m = np.isfinite(a) & np.isfinite(b)
    if m.any():
        diff = np.abs(a[m] - b[m])
        tol = atol + rtol * np.abs(a[m])
        num_diff = int((diff > tol).sum())
        max_diff = float(diff.max())
    else:
        num_diff, max_diff = 0, 0.0
    ok = nan_mismatch == 0 and num_diff == 0
    return RasterComparison(ok, max_diff, num_diff, nan_mismatch,
                            int(m.sum()))


def assert_rasters_match(a, b, atol: float = 1e-5, rtol: float = 1e-5,
                         label: str = "") -> None:
    cmp = compare_rasters(a, b, atol, rtol)
    assert cmp.ok, f"{label} {cmp}"

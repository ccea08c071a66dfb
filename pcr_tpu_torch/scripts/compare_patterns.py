"""
CPU <-> device parity comparator of the glyph pattern suite, on the port:
compares each `*_cpu.tif` that generate_glyph_patterns wrote with its
`*_gpu.tif` cell by cell and prints PASS / FAIL with max_diff and
num_different per raster. The counterpart of
scripts/patterns/compare_cpu_tpu_patterns.py, with the same bar.

    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode cpu
    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode gpu
    python -m pcr_tpu_torch.scripts.compare_patterns --dir DIR

Exits 1 if any raster fails, 2 if DIR holds no `*_cpu.tif`.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np

from pcr_tpu_torch.io.geotiff import read_geotiff_band

# Tolerance: atol + rtol * |cpu| per cell (the reference's bar is 1e-4
# absolute; this repository's is 1e-5). Cells sitting exactly on the
# w >= 1e-6 cutoff boundary divide by a near-zero accumulated weight
# (Average), which amplifies last-ulp arithmetic differences past any fixed
# bar: up to 0.005% of the cells, all on the NaN fringe, may fall back to
# the reference's 1e-4 bar. The NaN footprint must always match exactly.
ATOL = 1e-5
RTOL = 1e-5
ATOL_BOUNDARY = 1e-4
BOUNDARY_FRAC = 5e-5


def _nan_fringe(a):
    """Cells within one cell of a NaN (or the raster edge): where the
    w >= 1e-6 Average cutoff boundary lives, the only cells whose
    near-zero accumulated weight legitimately amplifies last-ulp
    arithmetic differences past the 1e-5 bar."""
    nanm = np.isnan(a)
    fringe = np.ones_like(nanm)
    fringe[1:-1, 1:-1] = False
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            fringe |= np.roll(np.roll(nanm, dy, 0), dx, 1)
    return fringe


def compare(cpu_path, gpu_path):
    """(ok, message) of one raster pair."""
    a = read_geotiff_band(cpu_path, 0)
    b = read_geotiff_band(gpu_path, 0)
    if a.shape != b.shape:
        return False, f"shape mismatch {a.shape} vs {b.shape}"
    nan_mismatch = int((np.isnan(a) != np.isnan(b)).sum())
    m = np.isfinite(a) & np.isfinite(b)
    interior_bad = 0
    if m.any():
        diff = np.abs(a - b)
        bad = m & (diff > ATOL + RTOL * np.abs(a))
        nbad = int(bad.sum())
        nworse = int((m & (diff > ATOL_BOUNDARY + RTOL * np.abs(a))).sum())
        max_diff = float(diff[m].max())
        allowed = max(1, int(BOUNDARY_FRAC * m.sum()))
        if nbad:
            # the allowance exists ONLY for cutoff-boundary cells: any
            # cell over the bar away from the NaN fringe is a real defect
            interior_bad = int((bad & ~_nan_fringe(a)).sum())
    else:
        nbad = nworse = 0
        max_diff, allowed = 0.0, 1
    ok = (nan_mismatch == 0 and nworse == 0 and interior_bad == 0
          and (nbad == 0 or nbad <= allowed))
    return ok, (f"max_diff={max_diff:.2e} num_different={nbad} "
                f"nan_mismatch={nan_mismatch} "
                f"boundary_allowance={allowed} "
                f"interior_bad={interior_bad}")


def compare_dir(directory):
    """{name: (ok, message)} of every `*_cpu.tif` in `directory` that has
    a `*_gpu.tif` beside it, and the names that have none."""
    results, missing = {}, []
    for cpu_path in sorted(glob.glob(os.path.join(directory, "*_cpu.tif"))):
        name = os.path.basename(cpu_path)[: -len("_cpu.tif")]
        gpu_path = cpu_path[: -len("_cpu.tif")] + "_gpu.tif"
        if os.path.exists(gpu_path):
            results[name] = compare(cpu_path, gpu_path)
        else:
            missing.append(name)
    return results, missing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "pcr_patterns"))
    args = ap.parse_args(argv)
    results, missing = compare_dir(args.dir)
    if not results and not missing:
        print(f"no *_cpu.tif files in {args.dir}; run "
              f"generate_glyph_patterns first", file=sys.stderr)
        return 2
    for name in missing:
        print(f"{name:24s} SKIP (no gpu output)")
    for name, (ok, msg) in results.items():
        print(f"{name:24s} {'PASS' if ok else 'FAIL'}  {msg}")
    return 1 if any(not ok for ok, _ in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

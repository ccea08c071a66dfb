"""
Visual demo on the port: a smiley-face point cloud through three filtered
pipelines composited into one raster. The outline is a ring of Line
glyphs tangent to the circle (kernel K3 on the card), the eyes are
Gaussian splats of a per-point sigma (K2) and the smile an arc of Line
glyphs.

    python -m pcr_tpu_torch.examples.smiley_face                 # 200k pts, 512^2
    python -m pcr_tpu_torch.examples.smiley_face --points 5000000 --size 2048 --mode gpu

The counterpart of examples/smiley_face.py, at its sizes. `main` returns
the composite (SIZE, SIZE) raster; the PNG is written where PIL imports.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.examples import MODES, make_cloud, square_grid

WORLD = 1000.0


def ring(rng, n, cx, cy, radius, jitter):
    a = rng.uniform(0, 2 * np.pi, n)
    r = radius + rng.normal(0, jitter, n)
    return cx + r * np.cos(a), cy + r * np.sin(a), a


def blob(rng, n, cx, cy, spread):
    return (cx + rng.normal(0, spread, n), cy + rng.normal(0, spread, n))


def arc(rng, n, cx, cy, radius, a0, a1, jitter):
    a = rng.uniform(a0, a1, n)
    r = radius + rng.normal(0, jitter, n)
    return cx + r * np.cos(a), cy + r * np.sin(a), a


def inputs(n_total: int, world: float = WORLD) -> dict:
    """The face's parts as x, y and the channels value, direction,
    half_length, sigma and part (0 outline, 1 eyes, 2 smile)."""
    rng = np.random.default_rng(7)
    c = world / 2.0
    R = world * 0.38
    n_outline = n_total // 2
    n_eye = n_total // 8
    n_smile = n_total - n_outline - 2 * n_eye

    # outline: line glyphs tangent to the circle (direction = angle + 90 deg)
    ox, oy, oa = ring(rng, n_outline, c, c, R, world * 0.004)
    od = oa + np.pi / 2.0
    ohl = np.full(n_outline, world * 0.01)

    # eyes: gaussian blobs (sigma in world units)
    e_dx, e_dy = R * 0.42, R * 0.35
    lx, ly = blob(rng, n_eye, c - e_dx, c + e_dy, world * 0.01)
    rx, ry = blob(rng, n_eye, c + e_dx, c + e_dy, world * 0.01)

    # smile: lower arc, line glyphs along the tangent
    sx, sy, sa = arc(rng, n_smile, c, c, R * 0.62,
                     np.pi * 1.15, np.pi * 1.85, world * 0.004)
    sd = sa + np.pi / 2.0
    shl = np.full(n_smile, world * 0.008)

    n = n_outline + 2 * n_eye + n_smile
    sigma = np.zeros(n, np.float32)
    sigma[n_outline:n_outline + 2 * n_eye] = world * 0.012
    part = np.zeros(n, np.float32)
    part[n_outline:n_outline + 2 * n_eye] = 1.0
    part[n_outline + 2 * n_eye:] = 2.0
    return {
        "x": np.concatenate([ox, lx, rx, sx]),
        "y": np.concatenate([oy, ly, ry, sy]),
        "value": np.concatenate([np.full(n_outline, 1.0),
                                 np.full(2 * n_eye, 3.0),
                                 np.full(n_smile, 2.0)]).astype(np.float32),
        "direction": np.concatenate([od, np.zeros(2 * n_eye), sd])
        .astype(np.float32),
        "half_length": np.concatenate([ohl, np.zeros(2 * n_eye), shl])
        .astype(np.float32),
        "sigma": sigma,
        "part": part,
    }


def parts():
    """(name, part code, spec) of each filtered pipeline: outline and
    smile through the Line glyph, the eyes through the Gaussian glyph."""
    return [
        ("outline", 0.0, pcr.line_splat_spec(
            "value", direction_channel="direction",
            half_length_channel="half_length", output_band_name="outline")),
        ("eyes", 1.0, pcr.gaussian_splat_spec(
            "value", sigma_x_channel="sigma", sigma_y_channel="sigma",
            output_band_name="eyes")),
        ("smile", 2.0, pcr.line_splat_spec(
            "value", direction_channel="direction",
            half_length_channel="half_length", output_band_name="smile")),
    ]


def main(points: int = 200_000, size: int = 512, mode: str = "auto",
         out: str | None = None, png: str | None = None) -> np.ndarray:
    tmp = tempfile.gettempdir()
    out = out or os.path.join(tmp, "pcr_smiley.tif")
    png = png or os.path.join(tmp, "pcr_smiley.png")
    gc = square_grid(WORLD, size)
    cloud = make_cloud(**inputs(points))

    face = np.zeros((gc.height, gc.width), np.float32)
    t0 = time.perf_counter()
    for name, code, spec in parts():
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [spec]
        cfg.filter.add("part", pcr.CompareOp.Equal, code)
        cfg.exec_mode = MODES[mode]
        if name == "outline":
            cfg.output_path = out
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(cloud)
        pipe.finalize()
        band = pipe.result().band_array(0)
        m = np.isfinite(band)
        face[m] = np.maximum(face[m], band[m])
    dt = time.perf_counter() - t0

    cov = 100.0 * float((face > 0).mean())
    print(f"{cloud.count():,} pts -> {gc.width}x{gc.height} raster "
          f"in {dt:.2f}s ({cloud.count() / dt / 1e6:.2f} Mpts/s, "
          f"mode={mode}), face coverage {cov:.1f}%")
    print(f"GeoTIFF: {out}")

    shown = face.copy()
    shown[shown == 0] = np.nan
    try:
        from pcr_tpu_torch.utils.visualization import save_png
        # vmin=0 keeps the lowest-valued part (the outline, value 1.0)
        # above the colormap's black end, so it stays visible on the
        # nodata background
        save_png(png, shown, cmap="magma", vmin=0.0)
        print(f"PNG:     {png}")
    except ImportError as e:    # no PIL: the PNG is a nicety
        print(f"(png render skipped: {e})")
    return face


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--size", type=int, default=512,
                    help="output raster is SIZE x SIZE")
    ap.add_argument("--mode", default="auto", choices=list(MODES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--png", default=None)
    args = ap.parse_args()
    main(args.points, args.size, args.mode, args.out, args.png)

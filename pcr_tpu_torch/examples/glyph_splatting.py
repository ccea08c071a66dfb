"""
Gaussian and Line glyph splatting on a sparse cloud, on the port: a
per-point sigma Gaussian (its windows are clipped on the host: kernel K5)
and a per-point direction Line (kernel K3).

    python -m pcr_tpu_torch.examples.glyph_splatting [--mode cpu] [--out-dir DIR]

The counterpart of examples/glyph_splatting.py, at its sizes. `main`
returns {"gaussian": band, "line": band}.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.examples import MODES, make_cloud, square_grid


def inputs(n: int, extent: float, seed: int = 0) -> dict:
    """x, y and the channels value, sigma, direction and half_length of n
    uniform points over [0, extent]^2."""
    rng = np.random.default_rng(seed)
    out = {"x": rng.uniform(0, extent, n), "y": rng.uniform(0, extent, n)}
    for name, lo, hi in (("value", 0, 1), ("sigma", 1.0, 5.0),
                         ("direction", 0, 2 * np.pi),
                         ("half_length", 2.0, 10.0)):
        out[name] = rng.uniform(lo, hi, n).astype(np.float32)
    return out


def specs():
    return [("gaussian", pcr.gaussian_splat_spec(
                "value", sigma_x_channel="sigma", sigma_y_channel="sigma")),
            ("line", pcr.line_splat_spec(
                "value", direction_channel="direction",
                half_length_channel="half_length"))]


def main(n: int = 2_000, size: int = 500, mode=pcr.ExecutionMode.Auto,
         out_dir: str | None = None) -> dict:
    out_dir = out_dir or tempfile.gettempdir()
    arrays = inputs(n, size)
    cloud = make_cloud(**arrays)
    bands = {}
    for label, spec in specs():
        cfg = pcr.PipelineConfig()
        cfg.grid = square_grid(size)
        cfg.reductions = [spec]
        cfg.exec_mode = mode
        cfg.output_path = os.path.join(out_dir, f"pcr_{label}.tif")
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(cloud)
        pipe.finalize()
        bands[label] = pipe.result().band_array(0)
        print(f"{label:10s} coverage "
              f"{100 * np.isfinite(bands[label]).mean():5.1f}%  "
              f"-> {cfg.output_path}")
    return bands


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--mode", choices=list(MODES), default="auto")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    main(mode=MODES[args.mode], out_dir=args.out_dir)

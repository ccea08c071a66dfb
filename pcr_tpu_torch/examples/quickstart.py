"""
The README quickstart on the port: 1M random points -> Average raster ->
GeoTIFF, through kernel K1 on the card.

    python -m pcr_tpu_torch.examples.quickstart [--mode cpu] [--out PATH]

The counterpart of examples/quickstart.py, at its sizes. `main` returns
the band.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.examples import MODES, make_cloud, square_grid


def inputs(n: int, extent: float, seed: int = 42):
    """(x, y, value): n uniform points over [0, extent]^2, values in
    [0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, extent, n), rng.uniform(0, extent, n),
            rng.uniform(0, 1, n).astype(np.float32))


def main(n: int = 1_000_000, size: int = 1000,
         mode=pcr.ExecutionMode.Auto, out: str | None = None) -> np.ndarray:
    x, y, v = inputs(n, size)
    spec = pcr.ReductionSpec()
    spec.value_channel = "value"
    spec.type = pcr.ReductionType.Average
    spec.output_band_name = "mean_value"

    cfg = pcr.PipelineConfig()
    cfg.grid = square_grid(size)
    cfg.reductions = [spec]
    cfg.exec_mode = mode
    cfg.output_path = out or os.path.join(tempfile.gettempdir(),
                                          "pcr_quickstart.tif")
    pipe = pcr.Pipeline.create(cfg)
    pipe.ingest(make_cloud(x, y, value=v))
    pipe.finalize()
    band = pipe.result().band_array(0)
    print(f"wrote {cfg.output_path}; coverage "
          f"{100 * np.isfinite(band).mean():.1f}%, "
          f"mean {np.nanmean(band):.4f}")
    return band


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--mode", choices=list(MODES), default="auto")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(mode=MODES[args.mode], out=args.out)

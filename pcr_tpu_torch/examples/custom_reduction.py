"""
A user-defined reduction registered at run time, on the port: per-cell RMS
(root mean square) of the point values, state = (sum of v^2, count),
finalized as sqrt(sum / count). A sum-kind op of two fields runs kernel K1
over both fields in one launch a chunk on the card.

    python -m pcr_tpu_torch.examples.custom_reduction [--mode cpu]

The counterpart of examples/custom_reduction.py, at its sizes. `main`
registers the op, rasterizes, unregisters it and returns the band.
"""

from __future__ import annotations

import argparse

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.examples import MODES, make_cloud, square_grid


def register_rms():
    pcr.register_custom_reduction(
        state_floats=2,
        identity=(0.0, 0.0),
        scatter_kind="sum",                   # each field scatter-ADDs
        fields=lambda v, w, t: [v * v, v * 0 + 1.0],
        merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
        finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5,
    )


def inputs(n: int, extent: float, seed: int = 0):
    """(x, y, v): n uniform points over [0, extent]^2, v ~ N(0, 3)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, extent, n), rng.uniform(0, extent, n),
            rng.normal(0, 3, n).astype(np.float32))


def main(n: int = 200_000, size: int = 200,
         mode=pcr.ExecutionMode.Auto) -> np.ndarray:
    register_rms()
    try:
        x, y, v = inputs(n, size)
        cfg = pcr.PipelineConfig(
            grid=square_grid(size),
            reductions=[pcr.ReductionSpec(value_channel="v",
                                          type=pcr.ReductionType.Custom,
                                          output_band_name="rms")],
            exec_mode=mode)
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(make_cloud(x, y, v=v))
        pipe.finalize()
        band = pipe.result().band_array(0)
    finally:
        pcr.unregister_reduction(pcr.ReductionType.Custom)
    m = ~np.isnan(band)
    print(f"RMS band: {m.sum()} populated cells, mean RMS "
          f"{band[m].mean():.3f} (values ~N(0,3) -> expect ~3)")
    return band


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--mode", choices=list(MODES), default="auto")
    args = ap.parse_args()
    main(mode=MODES[args.mode])

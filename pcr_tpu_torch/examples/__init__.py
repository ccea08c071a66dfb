"""
The user examples of pcr_tpu_torch, each a module run with `python -m`:

    python -m pcr_tpu_torch.examples.quickstart        # 1M points, Average (K1)
    python -m pcr_tpu_torch.examples.glyph_splatting   # per-point sigma Gaussian (K5), Line (K3)
    python -m pcr_tpu_torch.examples.streaming_resume  # PCRT checkpoint + resume
    python -m pcr_tpu_torch.examples.custom_reduction  # a registered op (K1 over K fields)
    python -m pcr_tpu_torch.examples.smiley_face       # Line + Gaussian composite
    python -m pcr_tpu_torch.examples.multichip         # a dp x sp mesh of devices

They are the counterparts of the JAX package's `examples/*.py`, on the
card unless `--mode cpu` asks for the CPU (PCR_TORCH_DEVICE=cpu runs the
device path on torch-CPU). Each exposes `main(...)` with the JAX example's
sizes as defaults and returns what it rasterized, so a caller can run it
small or hold one mode against another.
"""

from __future__ import annotations

import numpy as np

from .. import BBox, CRS, DataType, ExecutionMode, GridConfig, PointCloud

__all__ = ["MODES", "square_grid", "make_cloud"]

MODES = {"auto": ExecutionMode.Auto, "cpu": ExecutionMode.CPU,
         "gpu": ExecutionMode.GPU, "hybrid": ExecutionMode.Hybrid}


def square_grid(extent: float, cells: int | None = None,
                epsg: int = 3857) -> GridConfig:
    """A north-up grid over [0, extent]^2 of `cells` x `cells` cells (by
    default 1-unit cells)."""
    cell = extent / cells if cells else 1.0
    gc = GridConfig()
    gc.bounds = BBox()
    gc.bounds.min_x = gc.bounds.min_y = 0.0
    gc.bounds.max_x = gc.bounds.max_y = float(extent)
    gc.cell_size_x, gc.cell_size_y = cell, -cell
    gc.crs = CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def make_cloud(x, y, **channels) -> PointCloud:
    """A point cloud of float64 (x, y) with float32 `channels`."""
    c = PointCloud.create(len(x))
    c.set_x_array(np.asarray(x, np.float64))
    c.set_y_array(np.asarray(y, np.float64))
    for name, arr in channels.items():
        c.add_channel(name, DataType.Float32)
        c.set_channel_array_f32(name, np.asarray(arr, np.float32))
    return c

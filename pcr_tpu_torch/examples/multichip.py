"""
Multi-device ingest on the port: a dp (points) x sp (grid rows) mesh of
torch devices, one process driving them (pcr_tpu_torch.parallel.sharding).
A Point Average step and a separable Gaussian Sum step over the mesh.

    python -m pcr_tpu_torch.examples.multichip

The mesh takes every visible card; with one card it runs four shards on
it (["cuda:0"] * 4), and under PCR_TORCH_DEVICE the named device four
times. The counterpart of examples/multichip.py, at its sizes. `main`
returns the two steps' (H, W) state fields as numpy arrays.
"""

from __future__ import annotations

import argparse

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import routing
from pcr_tpu_torch.examples import square_grid
from pcr_tpu_torch.ops.reduction import get_reduction_info
from pcr_tpu_torch.parallel.sharding import (
    available_devices, gather_state, make_mesh, replicate_state,
    shard_points, sharded_gaussian_step, sharded_point_step)

GAUSS = dict(default_sigma_x=2.0, default_sigma_y=2.0, max_radius_cells=6.0)


def mesh_devices():
    """Every visible card, or four shards of the one device there is."""
    devs = available_devices()
    if not devs:
        raise pcr.PcrError(pcr.Status.error(
            pcr.StatusCode.CudaError,
            "multichip: no CUDA device available (PCR_TORCH_DEVICE=cpu "
            "runs the mesh on the CPU)"))
    return devs * 4 if len(devs) == 1 else devs


def inputs(n: int, size: int, seed: int = 0):
    """(x, y, values): n uniform points over [0, size]^2."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, size, n), rng.uniform(0, size, n),
            rng.uniform(0, 1, n).astype(np.float32))


def main(devices=None, n: int = 1 << 16, size: int = 256):
    devices = devices or mesh_devices()
    sp = 2 if len(devices) % 2 == 0 and len(devices) > 1 else 1
    mesh = make_mesh(devices, dp=len(devices) // sp, sp=sp)
    print(f"mesh: dp={mesh.shape['dp']} x sp={mesh.shape['sp']} "
          f"({len(devices)} devices: {sorted({str(d) for d in devices})})")

    H = W = size
    gc = square_grid(size)
    x, y, values = inputs(n, size)
    col, row, valid = routing.assign(gc, x, y)

    # Point glyph: Average over the mesh
    info = get_reduction_info(pcr.ReductionType.Average)
    step = sharded_point_step(info, H, W, mesh)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    args = shard_points(mesh, row.astype(np.int32), col.astype(np.int32),
                        valid, values, np.ones(n, np.float32),
                        np.zeros(n, np.float32))
    point = [f.numpy() for f in gather_state(step(states, *args))]
    occ = point[1] > 0
    print(f"point Average: mean={(point[0][occ] / point[1][occ]).mean():.4f}"
          f" (expect ~0.5), count={float(point[1].sum()):.0f}")

    # Gaussian glyph: separable splat over the mesh
    spec = pcr.GlyphSpec(type=pcr.GlyphType.Gaussian, **GAUSS)
    gp = routing.gaussian_params(spec, gc, x, y, None, None, None)
    info_g = get_reduction_info(pcr.ReductionType.Sum)
    gstep = sharded_gaussian_step(info_g, H, W, mesh, block=512)
    gstates = replicate_state(mesh, info_g.init_state((H, W)), H, W)
    gargs = shard_points(mesh, gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx,
                         gp.sy, gp.r, valid, values)
    gauss = [f.numpy() for f in gather_state(gstep(gstates, *gargs))]
    print(f"gaussian Sum: total mass={float(gauss[0].sum()):.1f}")
    return point, gauss


if __name__ == "__main__":
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args()
    main()

"""
Device health diagnostic: the CUDA probes, the port's kernel library built
(or loaded) and kernel K1 run on a small layout against its plain version,
and a 2 GB allocation on the card, each failure reported, not raised.

    python -m pcr_tpu_torch.scripts.diagnostics.device_health

The counterpart of scripts/diagnostics/device_health.py. Its compile
smoke test (a jit of (v * 2).sum()) becomes the port's own build and
launch. Exit codes: 0 healthy; 1 a probe failed; 2 no card (the JAX
script would go on to the CPU in Auto mode; the port's Auto raises
CudaError instead). Under PCR_TORCH_DEVICE=cpu the device path is
torch-CPU, where K1 is its plain version and the allocation probe is
skipped.
"""

from __future__ import annotations

import argparse
import time
import traceback

import numpy as np
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.scripts.diagnostics import (NO_CARD, NO_CARD_EXIT,
                                               probe_device, synchronize)
from pcr_tpu_torch.scripts.diagnostics.grid_sizes import grid_config

TOL = 1e-5


def k1_smoke(device: torch.device, size: int = 512, n: int = 100_000,
             seed: int = 0) -> tuple[float, float]:
    """(seconds to build or load the kernel library, K1's largest
    difference from its plain version) for the layout of n uniform points
    on a size x size Average grid. Raises AssertionError if the two differ
    beyond atol = rtol = 1e-5 or touch different cells."""
    from pcr_tpu_torch.engine import kernels
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    t0 = time.perf_counter()
    if device.type == "cuda":
        kernels._lib()
    build_s = time.perf_counter() - t0
    gc = grid_config(size, size)
    spec = pcr.ReductionSpec(value_channel="v",
                             type=pcr.ReductionType.Average)
    eng = TorchEngine(gc, [(spec, pcr.get_reduction_info(spec.type))],
                      device)
    rng = np.random.default_rng(seed)
    col = rng.integers(0, size, n).astype(np.int32)
    row = rng.integers(0, size, n).astype(np.int32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    (st,) = eng.prepare_point(0, None, np.ones(n, bool), vals, col=col,
                              row=row)
    shape = eng._states[0][0].shape
    got = [torch.zeros(shape, device=device) for _ in range(2)]
    want = [torch.zeros(shape, device=device) for _ in range(2)]
    kw = dict(th=kernels.TH, wt=eng.WT, with_f1=False)
    kernels.sorted_splat_point(got, st.params, st.bids, **kw)
    kernels.sorted_splat_point_plain(want, st.params, st.bids, **kw)
    synchronize(device)
    if not torch.equal(got[1] > 0, want[1] > 0):
        raise AssertionError("K1 and its plain version touch different "
                             "cells")
    err = 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        if bool((d > TOL + TOL * w.abs()).any()):
            raise AssertionError(f"K1 differs from its plain version by "
                                 f"{float(d.max())} (atol = rtol = 1e-5)")
        err = max(err, float(d.max()))
    return build_s, err


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args(argv)
    print(f"cuda_is_compiled:        {pcr.cuda_is_compiled()}")
    print(f"cuda_device_available:   {pcr.cuda_device_available()}")
    print(f"cuda_device_count:       {pcr.cuda_device_count()}")
    dev = probe_device()
    if dev is None:
        print(NO_CARD)
        return NO_CARD_EXIT
    if dev.type == "cuda":
        print(f"cuda_device_name:        {pcr.cuda_device_name(dev.index)}")
        free, total = pcr.cuda_memory_info(dev.index)
        print(f"cuda_memory_info:        free={free / 1e9:.2f} GB "
              f"total={total / 1e9:.2f} GB")
    else:
        print(f"device:                  {dev} (PCR_TORCH_DEVICE; every "
              f"kernel takes its plain PyTorch version)")
    rc = 0
    try:
        build_s, err = k1_smoke(dev)
        print(f"kernel smoke test (K1):  OK (library ready in "
              f"{build_s:.2f}s; max_abs_err={err!r} against the plain "
              f"version)")
    except Exception as e:  # noqa: BLE001 - a diagnostic reports and goes on
        traceback.print_exc()
        print(f"kernel smoke test (K1):  FAILED: {e}")
        rc = 1
    if dev.type != "cuda":
        print("2 GB allocation probe:  skipped (not a CUDA device)")
        return rc
    try:
        big = torch.empty((512, 1024, 1024), dtype=torch.float32,
                          device=dev)
        big.zero_()
        synchronize(dev)
        free, _ = torch.cuda.mem_get_info(dev)
        del big
        torch.cuda.empty_cache()
        print(f"2 GB allocation probe:  OK (free={free / 1e9:.2f} GB with "
              f"it held)")
    except RuntimeError as e:   # torch.OutOfMemoryError is one
        print(f"2 GB allocation probe:  failed (headroom?): {e}")
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

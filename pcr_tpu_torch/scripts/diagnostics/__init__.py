"""
The port's diagnostics, each a module run with `python -m`:

    python -m pcr_tpu_torch.scripts.diagnostics.device_health    # the cuda_* probes, K1 built and run, 2 GB
    python -m pcr_tpu_torch.scripts.diagnostics.grid_sizes --mode GPU    # eight odd grids, Count
    python -m pcr_tpu_torch.scripts.diagnostics.boundary_points  # edge and seam points, CPU vs card
    python -m pcr_tpu_torch.scripts.diagnostics.transfer_sizes   # H2D / D2H, pageable vs pinned

The counterparts of the JAX package's scripts/diagnostics/, with their
arguments, output lines and exit codes, on the card unless `--mode CPU`
or PCR_TORCH_DEVICE (the tests' stand-in for the card, e.g. "cpu") says
otherwise. Nothing falls back to the CPU: without a card a diagnostic that
needs one prints why and exits 2, and a failed probe exits 1.
"""

from __future__ import annotations

import torch

from ...core.device import cuda_device_available, device_override

__all__ = ["NO_CARD", "NO_CARD_EXIT", "probe_device", "synchronize"]

NO_CARD_EXIT = 2
NO_CARD = ("no CUDA device: the device modes (Auto, GPU, Hybrid) raise "
           "CudaError and nothing falls back to the CPU; ask for the CPU "
           "with ExecutionMode.CPU (--mode CPU) or PCR_TORCH_DEVICE=cpu")


def probe_device() -> torch.device | None:
    """The torch device the device modes take: PCR_TORCH_DEVICE's, else
    the card; None when there is neither."""
    dev = device_override()
    if dev is not None:
        return dev
    return torch.device("cuda", 0) if cuda_device_available() else None


def synchronize(device: torch.device | None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)

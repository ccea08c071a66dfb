"""
CUDA capability probes — the reference's `cuda_*` names (reference:
types.h:156-219), in place of pcr_tpu's `tpu_*` probes
(pcr_tpu/core/types.py:386-566).

They ask `torch.cuda` directly: a local card answers at once, so the
subprocess and round-trip probes the TPU's remote link needed have no
counterpart here. `default_device` is where device state goes unless the
caller names a device.
"""

from __future__ import annotations

import os

import torch

__all__ = ["cuda_is_compiled", "cuda_device_available", "cuda_device_count",
           "cuda_device_name", "cuda_memory_info", "device_override",
           "default_device"]


def device_override() -> torch.device | None:
    """The torch device named by PCR_TORCH_DEVICE (e.g. "cpu", where every
    kernel takes its plain version), or None. The tests set it to reach
    the device path without a card."""
    name = os.environ.get("PCR_TORCH_DEVICE", "")
    return torch.device(name) if name else None


def default_device() -> torch.device:
    """Where device state goes unless the caller names a device: the card,
    or PCR_TORCH_DEVICE."""
    return device_override() or torch.device("cuda")


def cuda_is_compiled() -> bool:
    """True if this PyTorch build has CUDA support."""
    return torch.backends.cuda.is_built()


def cuda_device_available() -> bool:
    return torch.cuda.is_available()


def cuda_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def cuda_device_name(device_id: int = 0) -> str:
    if not cuda_is_compiled():
        return "CUDA not available"
    if device_id >= cuda_device_count():
        return "Unknown CUDA device"
    return torch.cuda.get_device_name(device_id)


def cuda_memory_info(device_id: int = 0):
    """Return (free_bytes, total_bytes) or None if unavailable."""
    if device_id >= cuda_device_count():
        return None
    return torch.cuda.mem_get_info(device_id)

"""Published peaks of the cards the benchmark knows, for rooflines:
NVIDIA's H100 SXM data sheet, dense, without sparsity (3.35 TB/s of HBM3,
67 TFLOP/s float32 outside the tensor cores). They assume the card's full
700 W; a run states the card's power limit beside its shares."""

from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_s": 3.35e12, "f32_flop_s": 67e12},
}


def of(device_name: str):
    """The peaks of a card by its torch.cuda name, or None."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def least_time(work: dict, peaks: dict) -> float:
    """Seconds the card needs at least: the larger of the bytes over the
    memory's peak and the float32 operations over the peak rate."""
    return max(work["bytes"] / peaks["hbm_bytes_s"],
               work["flops"] / peaks["f32_flop_s"])

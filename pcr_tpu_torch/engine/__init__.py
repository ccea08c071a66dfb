"""The port's host layers (copies of pcr_tpu/engine), its device engine,
kernels and Pipeline."""

"""The port's core types, grid and point cloud (copies of pcr_tpu/core),
and its CUDA device probes."""

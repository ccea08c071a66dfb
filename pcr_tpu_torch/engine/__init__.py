"""The port's device engine, kernels and Pipeline."""

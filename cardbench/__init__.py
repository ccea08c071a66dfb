"""
cardbench — the benchmark of pcr_tpu_torch on one CUDA card.

One run measures one cell of the repository's BENCHMARK.json: whole
rasterization jobs of `pcr_tpu_torch.Pipeline` (create, ingest, finalize,
result), one after another, for a fixed window, then a check of the
rasters those jobs returned against a plain float64 reference.

    python3 -m cardbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, glyph or metric
is a file of its own, found by its name (see README.md). Nothing here
imports jax, jaxlib, flax, pcr_tpu or pcr; the run ends by checking that
none of them was loaded.
"""

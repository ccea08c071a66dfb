"""
The user scripts of pcr_tpu_torch, each a module run with `python -m`:

    python -m pcr_tpu_torch.scripts.run_lidar_pipeline --input DIR --synthesize 40 --extent 8192 --modes gpu cpu
    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode gpu
    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode cpu
    python -m pcr_tpu_torch.scripts.compare_patterns --dir DIR
    python -m pcr_tpu_torch.scripts.quick_validation
    python -m pcr_tpu_torch.scripts.diagnostics.device_health   # and grid_sizes, boundary_points, transfer_sizes

The counterparts of the JAX package's scripts/data/run_lidar_pipeline.py
(the streaming LiDAR harness), scripts/patterns/ (the glyph pattern
suite and its CPU <-> device comparator), scripts/quick_validation.sh and
scripts/diagnostics/, on the card unless a mode asks for the CPU.
"""

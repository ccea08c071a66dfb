"""tests/test_fuzz_parity.py's combined and filtered cases on the port.

The same seeds and the same generators (fuzz_cloud, random_spec: a random
grid and tiling, one to three specs drawn from the Point reductions,
Gaussians with fixed or per-point sigma and rotation, and Lines with fixed
or per-point direction and half length, one or two clouds straddling the
bbox, and for the filtered cases a predicate on "w") go through the port's
device path on torch-CPU, pcr_tpu's device path and pcr_tpu's numpy
oracle, under test_parity's bar (1e-5 + 1e-5 * |want| for the sum family,
exact for Max / Min, the exact NaN footprint). The mesh cases' twin is in
tests/test_torch_mesh.py.
"""

import numpy as np
import pytest

import pcr_tpu as ref
from conftest import make_grid_config
from test_fuzz_parity import fuzz_cloud, random_spec
from test_torch_parity import assert_twin, devices  # noqa: F401


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_combined_pipeline(seed):
    rng = np.random.default_rng(1000 + seed)
    w = float(rng.integers(40, 130))
    h = float(rng.integers(40, 130))
    tile = int(rng.choice([4096, 32, 48]))
    gc = make_grid_config(w=w, h=h, tile=tile)
    specs = [random_spec(rng) for _ in range(int(rng.integers(1, 4)))]
    clouds = [fuzz_cloud(rng, w, h, int(rng.integers(800, 4000)))
              for _ in range(int(rng.integers(1, 3)))]
    assert_twin(specs, clouds, gc)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_filtered_pipeline(seed):
    rng = np.random.default_rng(2000 + seed)
    w, h = float(rng.integers(50, 110)), float(rng.integers(50, 110))
    gc = make_grid_config(w=w, h=h)
    specs = [random_spec(rng) for _ in range(int(rng.integers(1, 3)))]
    clouds = [fuzz_cloud(rng, w, h, 2500)]
    op = [ref.CompareOp.Greater, ref.CompareOp.LessEqual][seed % 2]
    filt = ref.FilterSpec().add("w", op, float(rng.uniform(0.5, 2.5)))
    got = assert_twin(specs, clouds, gc, filter=filt)
    assert any(np.isfinite(b).any() for b in got)

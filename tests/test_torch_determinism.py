"""tests/test_determinism.py's ingest-order and thread-count cases on the
port (its rerun cases are tests/test_torch_pipeline.py::
test_port_reruns_are_bit_identical).

Max, Min and Count give the same bits whichever order two clouds are
ingested in, on the port's device path (torch-CPU) and in CPU mode; and a
pipeline capped at one native thread (cpu_threads, which the port passes
to native.set_num_threads) gives the bits of one at eight, on 100k points
so the native routing runs threaded. Each band is also held against
pcr_tpu's in the same mode.
"""

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch import native
from test_determinism import SPECS, big_cloud
from test_torch_parity import bands, devices  # noqa: F401
from test_torch_pipeline import assert_bands

RT = ref.ReductionType
MODES = pytest.mark.parametrize(
    "mode", [ref.ExecutionMode.CPU, ref.ExecutionMode.GPU],
    ids=["CPU", "GPU"])


@MODES
@pytest.mark.parametrize("rtype", [RT.Max, RT.Min, RT.Count],
                         ids=lambda t: t.name)
def test_ingest_order_invariance_for_commutative_ops(rtype, mode):
    gc = make_grid_config(w=100.0, h=100.0)
    c1, c2 = big_cloud(seed=1), big_cloud(seed=2)
    specs = [ref.ReductionSpec(value_channel="v", type=rtype)]
    a = bands(port, mode, specs, [c1, c2], gc)
    b = bands(port, mode, specs, [c2, c1], gc)
    assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert_bands(a, bands(ref, mode, specs, [c1, c2], gc), specs)


@MODES
def test_cpu_threads_invariance(mode):
    gc = make_grid_config(w=100.0, h=100.0)
    cloud = big_cloud(n=100_000)
    out = []
    try:
        for nthreads in (1, 8):
            out.append(bands(port, mode, SPECS, [cloud], gc,
                             cpu_threads=nthreads))
    finally:
        native.set_num_threads(0)   # the runtime default again
    for a, b in zip(*out):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert_bands(out[0], bands(ref, mode, SPECS, [cloud], gc), SPECS)

"""tests/test_device_cloud.py on the port: a cloud whose location() is
Device is staged once per pipeline, cached by identity, and every later
ingest of it is pure device compute.

GPU mode stands where the JAX test says TPU (the port keeps no
ExecutionMode.TPU alias). The device path runs on torch-CPU
(PCR_TORCH_DEVICE=cpu); each band is held against pcr_tpu's in the same
mode and against the numpy oracle, and the staging is counted by wrapping
Pipeline.stage.
"""

import numpy as np

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_cloud, make_grid_config
from test_torch_parity import devices, make  # noqa: F401
from test_torch_pipeline import assert_close, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
SPECS = [ref.ReductionSpec(value_channel="v", type=RT.Sum)]


def test_no_tpu_alias():
    assert not hasattr(port.ExecutionMode, "TPU")
    assert ref.ExecutionMode.TPU == ref.ExecutionMode.GPU


def test_device_cloud_matches_host_cloud():
    """A Device cloud's band is the host cloud's, bit for bit, in each
    package; the port's is pcr_tpu's and the oracle's within 1e-5."""
    gc = make_grid_config(w=100.0, h=100.0)
    out = []
    for pkg in (port, ref):
        cloud = like(pkg, make_cloud(2000, seed=7, w=100.0, h=100.0))
        host = make(pkg, GPU, SPECS, gc)
        host.ingest(cloud)
        host.finalize()
        dev = make(pkg, GPU, SPECS, gc)
        dcloud = cloud.to_device()
        assert dcloud.location() == pkg.MemoryLocation.Device
        dev.ingest(dcloud)
        dev.finalize()
        out.append(dev.result().band_array(0))
        assert np.array_equal(host.result().band_array(0), out[-1],
                              equal_nan=True)
    assert_close(out[0], out[1])
    o = make(ref, CPU, SPECS, gc)
    o.ingest(make_cloud(2000, seed=7, w=100.0, h=100.0))
    o.finalize()
    assert_close(out[0], o.result().band_array(0))


def test_device_cloud_staged_once(monkeypatch):
    gc = make_grid_config(w=100.0, h=100.0)
    cloud = make_cloud(1000, seed=3, w=100.0, h=100.0)
    staged = []
    stage = port.Pipeline.stage
    monkeypatch.setattr(port.Pipeline, "stage", lambda self, c: (
        staged.append(c), stage(self, c))[1])
    p = make(port, GPU, SPECS, gc)
    dcloud = like(port, cloud).to_device()
    p.ingest(dcloud)
    assert len(staged) == 1 and len(p._device_cloud_cache) == 1
    first = p._device_cloud_cache[id(dcloud)][1]
    p.ingest(dcloud)                       # the second ingest reuses it
    assert len(staged) == 1
    assert p._device_cloud_cache[id(dcloud)][1] is first
    p.finalize()
    got = p.result().band_array(0)
    for pkg, mode in ((ref, GPU), (ref, CPU)):
        q = make(pkg, mode, SPECS, gc)
        c = cloud.to_device() if mode == GPU else cloud
        q.ingest(c)
        q.ingest(c)
        q.finalize()
        assert_close(got, q.result().band_array(0))


def test_device_cloud_cpu_mode_still_works():
    """The CPU backend has no staging; a Device-located cloud still
    rasterizes, as pcr_tpu's does."""
    gc = make_grid_config(w=50.0, h=50.0)
    cloud = make_cloud(500, seed=1, w=50.0, h=50.0)
    out = []
    for pkg in (port, ref):
        p = make(pkg, CPU, SPECS, gc)
        p.ingest(like(pkg, cloud).to_device())
        p.finalize()
        out.append(p.result().band_array(0))
    assert np.nansum(out[0]) != 0.0
    assert np.array_equal(out[0], out[1], equal_nan=True)

"""Kernel K1 and the Point slice of the PyTorch port on a CUDA card.

These tests need the card (marker `cuda`) and skip without one. That
machine has no jax, and tests/conftest.py imports it, so run them there
without the conftest (this file needs nothing from it):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

K1 is held against its plain PyTorch version at atol = rtol = 1e-5 (the
two add the same float32 values in different orders), its reruns must be
bit-identical, and the pipeline against the numpy CPU oracle.
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import kernels
from pcr_tpu_torch.engine.torch_backend import TorchEngine

pytestmark = pytest.mark.cuda
RT = pcr.ReductionType
TOL = 1e-5


def make_grid_config(w, h, tile=4096):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, w, h
    gc = pcr.GridConfig(bounds=bbox, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    return gc


def make_cloud(n, seed, w, h):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    for name, arr in (("v", rng.normal(0, 1, n)),
                      ("ts", rng.integers(0, 50, n))):
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine run python -m "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def layout(device, w, h, n, rtype, adversarial, seed=0):
    """K1's staged chunk for n points; adversarial values span 1e-3..1e3
    with both signs (float add order shows), the others are in [0, 100)."""
    gc = make_grid_config(w=float(w), h=float(h))
    spec = pcr.ReductionSpec(value_channel="v", type=rtype)
    eng = TorchEngine(gc, [(spec, pcr.get_reduction_info(rtype))], device)
    rng = np.random.default_rng(seed)
    col = rng.integers(0, gc.width, n).astype(np.int32)
    row = rng.integers(0, gc.height, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.05
    vals = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
            if adversarial else rng.uniform(0, 100, n)).astype(np.float32)
    wts = rng.uniform(0.1, 2.0, n).astype(np.float32)
    (st,) = eng.prepare_point(0, None, valid, vals, wts, col=col, row=row)
    return eng, st


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["parity", "reruns"])
@pytest.mark.parametrize("w,h,n,rtype", [
    (160, 160, 200_000, RT.Average),
    (1000, 700, 300_000, RT.WeightedAverage),
    (300, 200, 50_000, RT.Sum),
])
def test_k1_matches_plain_and_reruns_bit_identical(card, w, h, n, rtype,
                                                   adversarial):
    """On adversarial values only the reruns are compared: cancellation
    makes the two summation orders differ by more than 1e-5 there."""
    eng, st = layout(card, w, h, n, rtype, adversarial)
    with_f1 = st.params.shape[1] == 4
    kw = dict(th=kernels.TH, wt=eng.WT, with_f1=with_f1)
    rng = np.random.default_rng(1)
    init = [torch.from_numpy(rng.uniform(0, 1, s.shape).astype(np.float32))
            .to(card) for s in eng._states[0]]
    got, again, want = ([s.clone() for s in init] for _ in range(3))
    before = kernels.sorted_splat_point.launches
    kernels.sorted_splat_point(got, st.params, st.bids, **kw)
    kernels.sorted_splat_point(again, st.params, st.bids, **kw)
    assert kernels.sorted_splat_point.launches == before + 2
    kernels.sorted_splat_point_plain(want, st.params, st.bids, **kw)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if not adversarial:
            torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


def test_k1_refuses_a_foreign_block_size(card):
    states = [torch.zeros(128, 256, device=card)]
    params = torch.zeros(1, 3, 1024, dtype=torch.int32, device=card)
    bids = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="2048-entry"):
        kernels.sorted_splat_point(states, params, bids, th=128, wt=256,
                                   with_f1=False)


@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
def test_pipeline_on_the_card_matches_oracle(card, staged, monkeypatch):
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    c = make_cloud(100_000, seed=3, w=300.0, h=200.0)
    specs = [pcr.ReductionSpec(value_channel="v", type=RT.Average),
             pcr.ReductionSpec(value_channel="v", type=RT.Max),
             pcr.ReductionSpec(value_channel="v", type=RT.MostRecent,
                               timestamp_channel="ts")]
    bands = {}
    for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=mode,
            gpu_require_strict=True))
        before = kernels.sorted_splat_point.launches
        p.ingest(p.stage(c) if staged and p._engine is not None else c)
        p.finalize()
        if mode == pcr.ExecutionMode.GPU:
            assert p._engine.device.type == "cuda"
            assert kernels.sorted_splat_point.launches > before
        bands[mode] = [p.result().band_array(i) for i in range(3)]
    g, o = bands[pcr.ExecutionMode.GPU], bands[pcr.ExecutionMode.CPU]
    np.testing.assert_allclose(g[0], o[0], atol=TOL, rtol=TOL)
    assert np.array_equal(np.isnan(g[0]), np.isnan(o[0]))
    for i in (1, 2):
        assert np.array_equal(g[i], o[i], equal_nan=True)

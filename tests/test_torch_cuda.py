"""Kernels K1-K6 and the Point, Gaussian and Line slices of the PyTorch
port on a CUDA card.

These tests need the card (marker `cuda`) and skip without one. That
machine has no jax, and tests/conftest.py imports it, so run them there
without the conftest (this file needs nothing from it):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

K1 is held against its plain PyTorch version at atol = rtol = 1e-5 (the
two add the same float32 values in different orders), its reruns must be
bit-identical, and the pipeline against the numpy CPU oracle. K2, K4 and K5
likewise, at a tolerance that grows with the terms per cell (gauss_rtol).
K3 (Line runs) at 1e-5, with the same touched cells; K6 (the rot-expand
probe) at the probe's rtol = 1e-4 with atol = rot_expand.atol(...).
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import gauss_kernels as gk
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


def k1_plan(bids, nb_total: int, group: int | None = None):
    """The test's oracle of K1's first-pass groups, as
    csrc/sorted_splat_point.cu forms them inline (the kernel is the only
    planner; this copy lets the tests see its plan): a group starts at each
    run's first sub-chunk and at each sub-chunk whose index is a multiple
    of `group` (kernels.k1_group_size(nsub) by default), and ends before
    the next start. Returns int64 arrays (first, end, slot), one entry per
    group of a live run (bid in [0, nb_total)), in sub-chunk order; `slot`
    is -1 for a run's only group (it writes the state), else the scratch
    tile it writes: 2b for the group starting at block b's first sub-chunk
    (b = first // group), 2b + 1 for one starting inside block b."""
    bids = np.asarray(bids, np.int64)
    nsub = len(bids)
    group = group or kernels.k1_group_size(nsub)
    j = np.arange(nsub)
    run_start = np.ones(nsub, bool)
    run_start[1:] = bids[1:] != bids[:-1]
    first = np.flatnonzero(run_start | (j % group == 0))
    end = np.append(first[1:], nsub)
    run_end = np.append(run_start[1:], True)[end - 1]   # last of its run
    alone = run_start[first] & run_end
    slot = np.where(alone, -1, 2 * (first // group) + (first % group != 0))
    keep = (bids[first] >= 0) & (bids[first] < nb_total)
    return first[keep], end[keep], slot[keep]


K1_FIELDS = {"one": RT.Sum, "two": RT.Average, "two_f1": RT.WeightedAverage}
K1_SPLITS = {   # (w, h, n, group): layouts whose runs split into groups
    "160x160": (160, 160, 1_000_000, None),     # 2 tiles, ~250 groups each
    "one_tile": (100, 100, 400_000, None),      # 1 tile, one long run
    "long_run": (160, 160, 2_000_000, 2),       # ~500 partial tiles a run
}


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["parity", "reruns"])
@pytest.mark.parametrize("fields", list(K1_FIELDS))
@pytest.mark.parametrize("case", list(K1_SPLITS))
def test_k1_split_runs(card, case, fields, adversarial):
    """K1 with a tile's run split over many CTAs and merged in group order:
    reruns are bit-identical (adversarial values, where float add order
    shows) and the result is within 1e-5 of the plain version."""
    w, h, n, group = K1_SPLITS[case]
    eng, st = layout(card, w, h, n, K1_FIELDS[fields], adversarial, seed=2)
    nb_total = eng.H_pad // kernels.TH * eng.ncb
    first, _, slot = k1_plan(st.bids.cpu().numpy(), nb_total, group)
    assert (slot >= 0).sum() > 2 * nb_total        # the runs really split
    kw = dict(th=kernels.TH, wt=eng.WT, with_f1=st.params.shape[1] == 4)
    rng = np.random.default_rng(3)
    init = [torch.from_numpy(rng.uniform(0, 1, s.shape).astype(np.float32))
            .to(card) for s in eng._states[0]]
    got, again, want = ([s.clone() for s in init] for _ in range(3))
    kernels.sorted_splat_point(got, st.params, st.bids, group=group, **kw)
    kernels.sorted_splat_point(again, st.params, st.bids, group=group, **kw)
    kernels.sorted_splat_point_plain(want, st.params, st.bids, **kw)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if not adversarial:
            torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("group", [1, 3, 7, 1 << 20])
def test_k1_every_grouping_matches_plain(card, group):
    """The grouping moves only the order of float32 sums: one sub-chunk a
    group, odd sizes, and one group a run (the first design) all agree
    with the plain version at 1e-5."""
    eng, st = layout(card, 300, 200, 300_000, RT.WeightedAverage, False,
                     seed=4)
    kw = dict(th=kernels.TH, wt=eng.WT, with_f1=True)
    got = [torch.zeros_like(s) for s in eng._states[0]]
    want = [torch.zeros_like(s) for s in eng._states[0]]
    kernels.sorted_splat_point(got, st.params, st.bids, group=group, **kw)
    kernels.sorted_splat_point_plain(want, st.params, st.bids, **kw)
    for g, r in zip(got, want):
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


GLYPHS = {
    "s1": (dict(default_sigma=1.0), "gauss", 3),
    "s4": (dict(default_sigma=4.0), "gauss", 12),
    "rot4": (dict(default_sigma_x=4.0, default_sigma_y=1.5,
                  default_rotation=0.6), "rotp", 12),
    "rot8": (dict(default_sigma_x=8.0, default_sigma_y=3.0,
                  default_rotation=0.6), "rot", 24),
}


def gauss_rtol(n, cells, r):
    """Both sum ~K = (points per cell) * (2r + 1)^2 positive float32 terms
    per cell in different orders: 8 standard deviations of the difference
    (sqrt(K) * 2^-24 relative), never below 1e-5."""
    k = n / cells * (2 * r + 1) ** 2
    return max(TOL, 8.0 * np.sqrt(k) * 2.0 ** -24)


def gauss_chunk(card, glyph, n, adversarial, seed=0):
    """A Gaussian chunk of n points on 300 x 200, staged through the
    Pipeline; adversarial values span 1e-3..1e3 with both signs."""
    gc = make_grid_config(w=300.0, h=200.0)
    spec = pcr.gaussian_splat_spec("v", **GLYPHS[glyph][0])
    spec.type = RT.Average
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True))
    c = make_cloud(n, seed, 300.0, 200.0)
    rng = np.random.default_rng(seed + 1)
    vals = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
            if adversarial else rng.uniform(0, 100, n))
    c.set_channel_array_f32("v", vals.astype(np.float32))
    (chunk,) = p.stage(c).per_spec[0]
    assert chunk.kind == GLYPHS[glyph][1] and chunk.params.is_cuda
    return p._engine, chunk


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["parity", "reruns"])
@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_gauss_kernels_match_plain_and_rerun_bit_identical(card, glyph,
                                                          adversarial):
    """200k points on 60k cells: hundreds to thousands of terms per cell.
    On adversarial values only the reruns are compared."""
    n = 200_000
    eng, chunk = gauss_chunk(card, glyph, n, adversarial)
    kern, plain, kw = eng.splat_fns(chunk)
    rng = np.random.default_rng(1)
    init = [torch.from_numpy(rng.uniform(0, 1, s.shape).astype(np.float32))
            .to(card) for s in eng._states[0]]
    got, again, want = ([s.clone() for s in init] for _ in range(3))
    before = kern.launches
    kern(got, chunk.params, chunk.bids, **kw)
    kern(again, chunk.params, chunk.bids, **kw)
    assert kern.launches == before + 2
    plain(want, chunk.params, chunk.bids, **kw)
    torch.cuda.synchronize()
    rtol = gauss_rtol(n, 300 * 200, GLYPHS[glyph][2])
    for g, a, r in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if not adversarial:
            torch.testing.assert_close(g, r, atol=rtol, rtol=rtol)


@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_gauss_pipeline_on_the_card_matches_oracle(card, glyph, monkeypatch):
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    c = make_cloud(50_000, seed=4, w=300.0, h=200.0)
    # positive values: the oracle evaluates the rotated form in another
    # algebra (each term ~1e-5 apart), which a sign-mixed sum that cancels
    # to near 0 would turn into a larger relative difference
    c.set_channel_array_f32("v", np.random.default_rng(5).uniform(
        0, 100, 50_000).astype(np.float32))
    specs = []
    for rtype in (RT.Average, RT.Count, RT.Sum):
        sp = pcr.gaussian_splat_spec("v", **GLYPHS[glyph][0])
        sp.type = rtype
        specs.append(sp)
    kern = {"gauss": gk.sorted_splat_gauss, "rot": gk.rot_splat_dense,
            "rotp": gk.rot_splat_packed}[GLYPHS[glyph][1]]
    bands = {}
    for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=mode,
            gpu_require_strict=True))
        kern.launches = 0
        p.ingest(p.stage(c) if p._engine is not None else c)
        p.finalize()
        if mode == pcr.ExecutionMode.GPU:
            assert p._engine.device.type == "cuda" and kern.launches >= 3
        bands[mode] = [p.result().band_array(i) for i in range(3)]
    for g, o in zip(bands[pcr.ExecutionMode.GPU],
                    bands[pcr.ExecutionMode.CPU]):
        assert np.array_equal(np.isnan(g), np.isnan(o))
        np.testing.assert_allclose(g, o, atol=TOL, rtol=TOL)


LINES = {
    "dir0_hl16": dict(default_half_length=16.0),
    "dir07_hl16": dict(default_direction=0.7, default_half_length=16.0),
    "per_point": dict(direction_channel="dir", half_length_channel="hl"),
}


def line_cloud(n, seed, w, h):
    c = make_cloud(n, seed, w, h)
    rng = np.random.default_rng(seed + 7)
    for name, arr in (("dir", rng.uniform(-np.pi, np.pi, n)),
                      ("hl", rng.uniform(0.5, 20.0, n))):
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def line_spec(glyph, rtype):
    sp = pcr.line_splat_spec("v", **LINES[glyph])
    sp.type = rtype
    return sp


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["parity", "reruns"])
@pytest.mark.parametrize("rtype", [RT.WeightedAverage, RT.Sum],
                         ids=["nf2", "nf1"])
@pytest.mark.parametrize("glyph", list(LINES))
def test_k3_matches_plain_and_reruns_bit_identical(card, glyph, rtype,
                                                   adversarial):
    """A Line chunk of 200k points on 300 x 200, staged through the
    Pipeline; adversarial values span 1e-3..1e3 with both signs, where
    only the reruns are compared (cancellation makes the two summation
    orders differ by more than 1e-5)."""
    from pcr_tpu_torch.engine import line_kernels as lk
    n = 200_000
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=make_grid_config(w=300.0, h=200.0),
        reductions=[line_spec(glyph, rtype)],
        exec_mode=pcr.ExecutionMode.GPU, gpu_require_strict=True))
    c = line_cloud(n, 0, 300.0, 200.0)
    rng = np.random.default_rng(1)
    vals = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
            if adversarial else rng.uniform(0, 100, n))
    c.set_channel_array_f32("v", vals.astype(np.float32))
    (chunk,) = p.stage(c).per_spec[0]
    assert chunk.kind == "rect" and chunk.params.is_cuda
    eng = p._engine
    init = [torch.from_numpy(rng.uniform(0, 1, s.shape).astype(np.float32))
            .to(card) for s in eng._states[0]]
    got, again, want = ([s.clone() for s in init] for _ in range(3))
    kw = dict(th=chunk.th, wt=chunk.wt)
    before = lk.rect_splat.launches
    lk.rect_splat(got, chunk.params, chunk.bids, **kw)
    lk.rect_splat(again, chunk.params, chunk.bids, **kw)
    assert lk.rect_splat.launches == before + 2
    lk.rect_splat_plain(want, chunk.params, chunk.bids, **kw)
    torch.cuda.synchronize()
    for g, a, r, s in zip(got, again, want, init):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if not adversarial:
            assert torch.equal(g != s, r != s)        # the touched cells
            torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("glyph", list(LINES))
def test_line_pipeline_on_the_card_matches_oracle(card, glyph, monkeypatch):
    from pcr_tpu_torch.engine import line_kernels as lk
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    c = line_cloud(50_000, seed=4, w=300.0, h=200.0)
    specs = [line_spec(glyph, rt) for rt in (RT.WeightedAverage, RT.Count,
                                             RT.Sum)]
    bands = {}
    for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=mode,
            gpu_require_strict=True))
        lk.rect_splat.launches = 0
        p.ingest(p.stage(c) if p._engine is not None else c)
        p.finalize()
        if mode == pcr.ExecutionMode.GPU:
            assert p._engine.device.type == "cuda"
            assert lk.rect_splat.launches >= 3
        bands[mode] = [p.result().band_array(i) for i in range(3)]
    for g, o in zip(bands[pcr.ExecutionMode.GPU],
                    bands[pcr.ExecutionMode.CPU]):
        assert np.array_equal(np.isnan(g), np.isnan(o))
        np.testing.assert_allclose(g, o, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("variant", ["smem", "loop"])
def test_k6_matches_plain_and_reruns_bit_identical(card, variant):
    from pcr_tpu_torch.probes import rot_expand as k6
    nsub, nq, block = 64, 9, 2048
    p = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (nq, block), dtype=np.float32)).to(card)
    before = k6.rot_expand.launches
    got = k6.rot_expand(p, nsub, variant)
    again = k6.rot_expand(p, nsub, variant)
    assert k6.rot_expand.launches == before + 2
    want = k6.rot_expand_plain(p, nsub)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=k6.atol(nsub, nq, block))


@pytest.mark.parametrize("rtype", [RT.Average, RT.Count], ids=["nf2", "nf1"])
@pytest.mark.parametrize("wt", [64, 256])
def test_k3_other_tile_widths(card, wt, rtype, monkeypatch):
    """PCR_RECT_W_TILE (the JAX package's knob, read by rect_col_tile)
    gives K3 tiles of 64 columns (warps that own none) or 256 (two column
    passes per thread, two row bands per slice with two fields)."""
    from pcr_tpu_torch.engine import line_kernels as lk
    monkeypatch.setenv("PCR_RECT_W_TILE", str(wt))
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=make_grid_config(w=600.0, h=300.0),
        reductions=[line_spec("per_point", rtype)],
        exec_mode=pcr.ExecutionMode.GPU, gpu_require_strict=True))
    (chunk,) = p.stage(line_cloud(100_000, 2, 600.0, 300.0)).per_spec[0]
    assert chunk.kind == "rect" and chunk.wt == wt
    kw = dict(th=chunk.th, wt=chunk.wt)
    got = [torch.zeros_like(s) for s in p._engine._states[0]]
    want = [torch.zeros_like(s) for s in p._engine._states[0]]
    lk.rect_splat(got, chunk.params, chunk.bids, **kw)
    lk.rect_splat_plain(want, chunk.params, chunk.bids, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g != 0, r != 0)
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)

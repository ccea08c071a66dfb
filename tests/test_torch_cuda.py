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
likewise, at a tolerance that grows with the terms per cell (gauss_rtol);
the walks of K2 and K4 also on points at the borders of their slices, blocks
and tiles.
K3 (Line runs) at 1e-5, with the same touched cells, and bit for bit
against the plain version run on the CPU (both add a cell's terms in entry
order) on runs at the borders of its slices; K6 (the rot-expand probe) at
the probe's rtol = 1e-4 with atol = rot_expand.atol(...).
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


# -- the window-aware walks of K2 and K4 (csrc/splat_walk.cuh) ---------------

BORDER_X = [0.2, 31.5, 32.0, 32.5, 63.9, 64.1, 127.5, 128.2, 199.7]
BORDER_Y = [0.1, 7.5, 8.0, 8.5, 31.9, 32.1, 63.5, 64.4, 127.9, 128.1, 149.8]
WALK_GLYPHS = {           # glyph, kind, th, r
    "s1": (dict(default_sigma=1.0), "gauss", 32, 3),
    "s4": (dict(default_sigma=4.0), "gauss", 64, 12),
    "s16": (dict(default_sigma=16.0), "gauss", 128, 32),
    "rot8": (dict(default_sigma_x=8.0, default_sigma_y=3.0,
                  default_rotation=0.6), "rot", 32, 24),
}
WALK_GEOMS = {            # the staging grid's tile, the masks' geometry
    "one_tile": (4096, None),
    "tiles64": (64, None),
    "row_offset": (64, gk.GaussGeom(110, 200, True, 64, 48, 40, 150)),
}
N_WALK = 20_000


def walk_chunk(card, glyph, tile, rtype, adversarial):
    """A chunk of points on the borders of the walk's 8-row slices and
    32-column blocks and of the tiles, then N_WALK random ones, on
    200 x 150, with a sub-chunk of dead entries appended to the last run."""
    w, h = 200.0, 150.0
    spec = pcr.gaussian_splat_spec("v", **WALK_GLYPHS[glyph][0])
    spec.type = rtype
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=make_grid_config(w=w, h=h, tile=tile), reductions=[spec],
        exec_mode=pcr.ExecutionMode.GPU, gpu_require_strict=True))
    rng = np.random.default_rng(7)
    bx, by = np.meshgrid(BORDER_X, BORDER_Y)
    x = np.concatenate([bx.ravel(), rng.uniform(0, w, N_WALK)])
    y = np.concatenate([by.ravel(), rng.uniform(0, h, N_WALK)])
    n = len(x)
    c = pcr.PointCloud.create(n)
    c.set_x_array(x)
    c.set_y_array(y)
    vals = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
            if adversarial else rng.uniform(0, 100, n))
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v", vals.astype(np.float32))
    (chunk,) = p.stage(c).per_spec[0]
    kind, th = WALK_GLYPHS[glyph][1:3]
    assert chunk.kind == kind and chunk.th == th and chunk.params.is_cuda
    dead = torch.zeros_like(chunk.params[:1])
    dead[:, 6 if kind == "gauss" else 8] = -1
    return (p._engine, chunk, torch.cat([chunk.params, dead]),
            torch.cat([chunk.bids, chunk.bids[-1:]]), n)


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["parity", "reruns"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average], ids=["nf1", "nf2"])
@pytest.mark.parametrize("geom", list(WALK_GEOMS))
@pytest.mark.parametrize("glyph", list(WALK_GLYPHS))
def test_walk_kernels_on_slice_and_block_borders(card, glyph, geom, rtype,
                                                 adversarial):
    """K2 (th 32 with the cutoff, 64, 128) and K4 where the walk's cases
    meet: windows that straddle slices, blocks and tiles, entries whose
    home-tile clip leaves them no cell of a tile (64-cell tiles, with and
    without a row offset), a dead sub-chunk, one field and two. Reruns
    bit-identical; on adversarial values only those."""
    tile, masks = WALK_GEOMS[geom]
    eng, chunk, params, bids, n = walk_chunk(card, glyph, tile, rtype,
                                             adversarial)
    kern, plain, kw = eng.splat_fns(chunk)
    if masks is not None:
        kw = dict(kw, geom=masks)
    rng = np.random.default_rng(1)
    init = [torch.from_numpy(rng.uniform(0, 1, s.shape).astype(np.float32))
            .to(card) for s in eng._states[0]]
    assert len(init) == (2 if rtype == RT.Average else 1)
    got, again, want = ([s.clone() for s in init] for _ in range(3))
    before = kern.launches
    kern(got, params, bids, **kw)
    kern(again, params, bids, **kw)
    assert kern.launches == before + 2
    plain(want, params, bids, **kw)
    torch.cuda.synchronize()
    rtol = gauss_rtol(n, 200 * 150, WALK_GLYPHS[glyph][3])
    for g, a, r, s in zip(got, again, want, init):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        if not adversarial:
            assert torch.equal(g != s, r != s)        # the touched cells
            torch.testing.assert_close(g, r, atol=rtol, rtol=rtol)


@pytest.mark.parametrize("cut", [False, True], ids=["nocut", "cut"])
@pytest.mark.parametrize("glyph", ["s1", "s4"])
def test_k2_product_cutoff_both_ways(card, glyph, cut):
    """The product cutoff on and off on the same entries, whatever the
    routing chose for them."""
    eng, chunk, params, bids, n = walk_chunk(card, glyph, 64, RT.Average,
                                             False)
    kw = dict(th=chunk.th, wt=chunk.wt, cut=cut, geom=eng.geom)
    got = [torch.zeros_like(s) for s in eng._states[0]]
    want = [torch.zeros_like(s) for s in eng._states[0]]
    gk.sorted_splat_gauss(got, params, bids, **kw)
    gk.sorted_splat_gauss_plain(want, params, bids, **kw)
    rtol = gauss_rtol(n, 200 * 150, WALK_GLYPHS[glyph][3])
    for g, r in zip(got, want):
        assert torch.equal(g != 0, r != 0)
        torch.testing.assert_close(g, r, atol=rtol, rtol=rtol)


@pytest.mark.parametrize("glyph", ["s4", "rot8"])
def test_walk_kernels_on_wide_tiles(card, glyph):
    """(th, 256) tiles, two column slices a row slice: the 128-column
    tiles' runs are merged pairwise (bids // 2 stays ascending; halo copies
    then count twice, in the kernel and in plain alike)."""
    eng, chunk, params, bids, n = walk_chunk(card, glyph, 4096, RT.Average,
                                             False)
    assert chunk.wt == 128 and eng._states[0][0].shape[1] == 256
    kern, plain, kw = eng.splat_fns(chunk)
    kw = dict(kw, wt=256)
    got = [torch.zeros_like(s) for s in eng._states[0]]
    want = [torch.zeros_like(s) for s in eng._states[0]]
    kern(got, params, bids // 2, **kw)
    plain(want, params, bids // 2, **kw)
    rtol = gauss_rtol(2 * n, 200 * 150, WALK_GLYPHS[glyph][3])
    for g, r in zip(got, want):
        assert torch.equal(g != 0, r != 0)
        torch.testing.assert_close(g, r, atol=rtol, rtol=rtol)


def test_walk_kernels_refuse_unaligned_params(card):
    """cp.async copies 16 bytes at a time."""
    states = [torch.zeros(128, 128, device=card)]
    flat = torch.zeros(8 * 2048 + 1, dtype=torch.int32, device=card)
    params = flat[1:].view(1, 8, 2048)
    bids = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        gk.sorted_splat_gauss(states, params, bids, th=32, wt=128, cut=False,
                              geom=gk.GaussGeom(128, 128))


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
@pytest.mark.parametrize("nsub,nq,block", [
    (64, 9, 2048),      # the probe's defaults: two CTAs a step
    (5, 7, 2044),       # 511 g's: ragged shares, groups and chains
    (700, 2, 4),        # one g: seven groups of eight have nothing to add
    (3, 28, 2048),      # 56 KB a CTA: over the default shared memory
])
def test_k6_matches_plain_and_reruns_bit_identical(card, variant, nsub, nq,
                                                   block):
    from pcr_tpu_torch.probes import rot_expand as k6
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


def test_k6_refuses_unaligned_params(card):
    """cp.async copies 16 bytes at a time."""
    from pcr_tpu_torch.probes import rot_expand as k6
    p = torch.zeros(3 * 256 + 1, device=card)[1:].view(3, 256)
    with pytest.raises(ValueError, match="16-byte"):
        k6.rot_expand(p, 2, "smem")


def k3_border_entries(th, wt, seed):
    """K3 entries on a 2 x 2 grid of (th, wt) tiles where the walk's cases
    meet: 1-row runs that straddle the 32-column blocks and 128-column
    slices, 1-column runs through several 8-row slices, runs across the
    tile's edges, dead entries; tile 0 holds a run of five sub-chunks,
    tile 2 nothing but dead entries. Values span 1e-3..1e3 with both signs.
    Returns numpy (params, bids)."""
    rng = np.random.default_rng(seed)
    block = kernels.BLOCK
    bids = np.array([0] * 5 + [1, 2, 3, 3], np.int32)
    shape = (len(bids), block)
    r0, c0 = (bids // 2 * th)[:, None], (bids % 2 * wt)[:, None]
    kind = rng.integers(0, 4, shape)
    # a border of a block or slice, and a start a few cells before it
    bx = c0 + 32 * rng.integers(0, wt // 32 + 1, shape)
    by = r0 + 8 * rng.integers(0, th // 8 + 1, shape)
    ax = np.where(kind < 2, bx - rng.integers(0, 6, shape),
                  c0 + rng.integers(-6, wt + 2, shape))
    ay = np.where(kind >= 2, by - rng.integers(0, 6, shape),
                  np.where(kind == 1, by - rng.integers(0, 2, shape),
                           r0 + rng.integers(-6, th + 2, shape)))
    length = rng.integers(0, 45, shape)
    horizontal = kind < 2
    params = np.stack([ax, ax + np.where(horizontal, length, 0), ay,
                       ay + np.where(horizontal, 0, length),
                       (rng.normal(size=shape)
                        * 10.0 ** rng.integers(-3, 4, shape)).astype(
                            np.float32).view(np.int32)], 1).astype(np.int32)
    dead = (rng.uniform(size=shape) < 0.05) | (bids == 2)[:, None]
    for seg, fill in enumerate((1, 0, 1, 0)):
        params[:, seg][dead] = fill
    return params, bids


@pytest.mark.parametrize("nf", [1, 2])
@pytest.mark.parametrize("th,wt", [(128, 128), (128, 64), (128, 256),
                                   (24, 192)])
def test_k3_on_slice_borders_matches_the_cpu_bits(card, th, wt, nf):
    """Both the kernel and the plain version on the CPU add a cell's terms
    in entry order to the state's value, so they agree bit for bit, on
    adversarial values and a random initial state; reruns too."""
    from pcr_tpu_torch.engine import line_kernels as lk
    params, bids = k3_border_entries(th, wt, th + wt + nf)
    rng = np.random.default_rng(1)
    init = [torch.from_numpy(rng.normal(size=(2 * th, 2 * wt)).astype(
        np.float32)) for _ in range(nf)]
    want = [s.clone() for s in init]
    lk.rect_splat_plain(want, torch.from_numpy(params),
                        torch.from_numpy(bids), th=th, wt=wt)
    got, again = ([s.to(card) for s in init] for _ in range(2))
    p, b = torch.from_numpy(params).to(card), torch.from_numpy(bids).to(card)
    before = lk.rect_splat.launches
    lk.rect_splat(got, p, b, th=th, wt=wt)
    lk.rect_splat(again, p, b, th=th, wt=wt)
    assert lk.rect_splat.launches == before + 2
    torch.cuda.synchronize()
    tile2 = (slice(th, 2 * th), slice(0, wt))
    for g, a, w, s in zip(got, again, want, init):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
        assert torch.equal(w[tile2], s[tile2]) and not torch.equal(w, s)


def test_k3_refuses_unaligned_params(card):
    """cp.async copies 16 bytes at a time."""
    from pcr_tpu_torch.engine import line_kernels as lk
    states = [torch.zeros(128, 128, device=card)]
    flat = torch.zeros(5 * 2048 + 1, dtype=torch.int32, device=card)
    params = flat[1:].view(1, 5, 2048)
    bids = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        lk.rect_splat(states, params, bids, th=128, wt=128)


@pytest.mark.parametrize("rtype", [RT.Average, RT.Count], ids=["nf2", "nf1"])
@pytest.mark.parametrize("wt", [64, 256])
def test_k3_other_tile_widths(card, wt, rtype, monkeypatch):
    """PCR_RECT_W_TILE (the JAX package's knob, read by rect_col_tile)
    gives K3 tiles of 64 columns (half a slice's threads own no cell) or
    256 (two column slices a row slice)."""
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


@pytest.mark.parametrize("glyph", ["point", "gauss", "rot", "line"])
def test_hybrid_workers_and_both_routes_give_the_same_bits(card, glyph,
                                                           monkeypatch):
    """400k points in 20 chunks of 20k, so the pinned buffers and the copy
    stream are reused many times under 4 workers: the bands of Hybrid
    (1 and 4 workers), of GPU mode, of a staged cloud and of the host
    layout (PCR_WIRE_CHEAP=0) are one, bit for bit, and each chunk's bytes
    are the same by both routes."""
    gc = make_grid_config(w=300.0, h=200.0, tile=64)
    c = make_cloud(400_000, 41, 300.0, 200.0)
    spec = {
        "point": pcr.ReductionSpec(value_channel="v",
                                   type=RT.WeightedAverage,
                                   weight_channel="ts"),
        "gauss": pcr.gaussian_splat_spec("v", default_sigma=3.0),
        "rot": pcr.gaussian_splat_spec("v", default_sigma_x=8.0,
                                       default_sigma_y=3.0,
                                       default_rotation=0.6),
        "line": pcr.line_splat_spec("v", default_direction=0.7,
                                    default_half_length=9.0),
    }[glyph]
    if glyph != "point":
        spec.type = RT.Average

    def run(mode, wire="1", workers=0, staged=False):
        monkeypatch.setenv("PCR_WIRE_CHEAP", wire)
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=[spec], exec_mode=mode,
            gpu_require_strict=True, chunk_size=20_000,
            hybrid_cpu_threads=workers))
        src = p.stage(c) if staged else c
        p.ingest(src)
        p.finalize()
        return p.result().band_array(0).view(np.int32).copy(), src

    GPU, HYBRID = pcr.ExecutionMode.GPU, pcr.ExecutionMode.Hybrid
    want, host = run(GPU, wire="0", staged=True)
    got, dev = run(GPU, staged=True)
    assert np.array_equal(got, want)
    for a, b in zip(dev.per_spec[0], host.per_spec[0]):
        assert a.kind == b.kind
        assert torch.equal(a.params.view(torch.int32),
                           b.params.view(torch.int32))
        assert torch.equal(a.bids, b.bids)
    assert len(dev.per_spec[0]) == 20
    for mode, workers in ((GPU, 0), (HYBRID, 1), (HYBRID, 4), (HYBRID, 4)):
        assert np.array_equal(run(mode, workers=workers)[0], want)


# -- out-of-core bands and Custom reductions ----------------------------------

BANDED = {
    "point": (lambda: pcr.ReductionSpec(value_channel="v",
                                        type=RT.WeightedAverage,
                                        weight_channel="ts"),
              kernels.sorted_splat_point),
    "gauss": (lambda: pcr.gaussian_splat_spec("v", default_sigma=3.0),
              gk.sorted_splat_gauss),
    "rotp": (lambda: pcr.gaussian_splat_spec("v", default_sigma_x=4.0,
                                             default_sigma_y=1.5,
                                             default_rotation=0.6),
             gk.rot_splat_packed),
    "rot": (lambda: pcr.gaussian_splat_spec("v", default_sigma_x=8.0,
                                            default_sigma_y=3.0,
                                            default_rotation=0.6),
            gk.rot_splat_dense),
    "line": (lambda: pcr.line_splat_spec("v", default_direction=0.7,
                                         default_half_length=9.0), None),
}


def positive_cloud(n, seed, w, h):
    c = make_cloud(n, seed, w, h)
    c.set_channel_array_f32("v", np.abs(c.channel_array_f32("v")) + 0.5)
    c.set_channel_array_f32("ts", c.channel_array_f32("ts") + 1.0)
    return c


@pytest.mark.parametrize("grid", ["tiled", "untiled"])
@pytest.mark.parametrize("glyph", list(BANDED))
def test_banded_pipeline_matches_resident(card, glyph, grid, monkeypatch):
    """Each glyph under a gpu_memory_budget that bands, on a 64-cell-tiled
    grid and on an untiled one (entries copied across bands): within 1e-5
    of the resident band (K1-K5 sum a sub-chunk before the state, and a
    band has other sub-chunks) and of the numpy oracle, reruns
    bit-identical, staged = host-sourced bit for bit, the glyph's kernel
    launched."""
    from pcr_tpu_torch.engine import line_kernels as lk
    from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    make_spec, kern = BANDED[glyph]
    kern = kern or lk.rect_splat
    gc = (make_grid_config(w=600.0, h=520.0, tile=64) if grid == "tiled"
          else make_grid_config(w=600.0, h=600.0))
    c = positive_cloud(100_000, 51, 600.0, 600.0)

    def band(budget, staged=False, mode=pcr.ExecutionMode.GPU):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=[make_spec()], exec_mode=mode,
            gpu_require_strict=True, gpu_memory_budget=budget))
        p.ingest(p.stage(c) if staged else c)
        p.finalize()
        return p, p.result().band_array(0)

    _, want = band(0)
    _, oracle = band(0, mode=pcr.ExecutionMode.CPU)
    before = kern.launches
    p, got = band(1 << 18)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.nbands > 1 and p._engine.device.type == "cuda"
    assert kern.launches > before
    for ref in (want, oracle):
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
        assert np.array_equal(np.isnan(got), np.isnan(ref))
    for staged in (False, True):
        assert np.array_equal(band(1 << 18, staged)[1].view(np.int32),
                              got.view(np.int32))


@pytest.mark.parametrize("glyph", ["gauss", "rotp", "rot"])
def test_banded_lower_edge_centres_keep_their_footprint(card, glyph,
                                                        monkeypatch):
    """Gaussians centred on the grid's lower edge (centre row H) on a grid
    of whole 64-cell tiles whose last 128-row band is partial: the band's
    row-offset view clamps their home tile to the last tile row, as the
    resident engine does, so the banded band is within 1e-5 of the
    resident one and of the oracle, footprints included."""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
    gc = make_grid_config(w=300.0, h=320.0, tile=64)
    c = positive_cloud(20_000, 54, 300.0, 320.0)
    y = c.y_array().copy()
    y[:5000] = gc.bounds.min_y
    c.set_y_array(y)
    bands = []
    for mode, budget in ((pcr.ExecutionMode.GPU, 1 << 21),
                         (pcr.ExecutionMode.GPU, 0),
                         (pcr.ExecutionMode.CPU, 0)):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=[BANDED[glyph][0]()], exec_mode=mode,
            gpu_require_strict=True, gpu_memory_budget=budget))
        p.ingest(c)
        p.finalize()
        if budget:
            assert isinstance(p._engine, OutOfCoreTorchEngine)
            assert p._engine.nbands == 3 and p._engine.band_rows == 128
        bands.append(p.result().band_array(0))
    assert not np.isnan(bands[1][-1]).all()
    for ref in bands[1:]:
        np.testing.assert_allclose(bands[0], ref, atol=TOL, rtol=TOL)
        assert np.array_equal(np.isnan(bands[0]), np.isnan(ref))


def test_band_swap_flushes_gaussian_residues(card):
    """A Gaussian weight sum under GAUSS_WMIN in a band is zeroed when the
    band leaves the card."""
    from pcr_tpu_torch.engine import routing
    from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    spec = pcr.gaussian_splat_spec("v", default_sigma=2.0)
    spec.type = RT.Average
    eng = OutOfCoreTorchEngine(gc, [(spec, pcr.get_reduction_info(RT.Average))],
                               128, card)
    fields = [np.zeros((512, 512), np.float32) for _ in range(2)]
    fields[0][5, 5], fields[1][5, 5] = 1e-7, 1e-7
    fields[0][6, 6], fields[1][6, 6] = 3.0, 1.5
    eng.load_state(0, fields)
    rng = np.random.default_rng(52)
    x = rng.uniform(100, 512, 2000)             # far from the residue
    y = np.concatenate([rng.uniform(0, 120, 1000),
                        rng.uniform(384, 504, 1000)])
    gp = routing.gaussian_params(spec.glyph, gc, x, y, None, None, None)
    staged = eng.prepare_gaussian(0, gp, np.ones(2000, bool),
                                  np.ones(2000, np.float32), wire_cheap=True)
    assert [b for b, _ in staged] == [0, 3]
    eng.commit(0, staged)
    host = eng._host[0]
    assert host[0][5, 5] == 0.0 and host[1][5, 5] == 0.0
    assert host[1][6, 6] >= 1.5 and eng.stats["swaps"] == 2


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sum_custom_launches_k1(card, k, monkeypatch):
    """A K-field sum custom runs ceil(K / 2) K1 launches a chunk on the
    card, matches the oracle within 1e-5 and reruns bit for bit."""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    c = make_cloud(200_000, seed=53, w=300.0, h=200.0)
    pcr.register_custom_reduction(
        state_floats=k, identity=(0.0,) * k, scatter_kind="sum",
        fields=lambda v, w, t: [v, v * v, v * 0 + 1.0][:k],
        merge_arrays=lambda a, b: [x + y for x, y in zip(a, b)],
        finalize_arrays=lambda f: f[0] + f[k - 1] * 2.0)
    try:
        bands = []
        for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.GPU,
                     pcr.ExecutionMode.CPU):
            p = pcr.Pipeline.create(pcr.PipelineConfig(
                grid=gc, reductions=[pcr.ReductionSpec(
                    value_channel="v", type=RT.Custom)],
                exec_mode=mode, gpu_require_strict=True))
            before = kernels.sorted_splat_point.launches
            p.ingest(c)
            p.finalize()
            if mode == pcr.ExecutionMode.GPU:
                assert (kernels.sorted_splat_point.launches - before
                        == -(-k // 2))
            bands.append(p.result().band_array(0))
    finally:
        pcr.unregister_reduction(RT.Custom)
    assert np.array_equal(bands[0].view(np.int32), bands[1].view(np.int32))
    np.testing.assert_allclose(bands[0], bands[2], atol=TOL, rtol=TOL)
    assert np.array_equal(np.isnan(bands[0]), np.isnan(bands[2]))


# -- multi-device meshes, several shards on one card --------------------------

def mesh_band(gc, specs, c, staged=False, **mesh):
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True, **mesh))
    p.ingest(p.stage(c) if staged else c)
    p.finalize()
    return p, [p.result().band_array(i) for i in range(len(specs))]


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
@pytest.mark.parametrize("grid", ["tiled", "untiled"])
@pytest.mark.parametrize("glyph", list(BANDED))
def test_mesh_of_one_card_matches_resident(card, glyph, grid, dp, sp,
                                           monkeypatch):
    """mesh_devices = [cuda:0] * 4: ShardedTorchEngine on the one-tile grid,
    PartitionedTorchEngine on the 64-cell-tiled one, each shard through
    the glyph's kernel on the card; within 1e-5 of the resident band and
    of the oracle, reruns and staged = host-sourced bit for bit."""
    from pcr_tpu_torch.engine import line_kernels as lk
    from pcr_tpu_torch.parallel.engine import (PartitionedTorchEngine,
                                               ShardedTorchEngine)
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    make_spec, kern = BANDED[glyph]
    kern = kern or lk.rect_splat
    gc = (make_grid_config(w=600.0, h=512.0, tile=64) if grid == "tiled"
          else make_grid_config(w=600.0, h=600.0))
    c = positive_cloud(100_000, 61, 600.0, 600.0)
    specs = [make_spec()]
    if glyph == "point":
        specs += [pcr.ReductionSpec(value_channel="v", type=RT.Max),
                  pcr.ReductionSpec(value_channel="v", type=RT.MostRecent,
                                    timestamp_channel="ts")]
    mesh = dict(mesh_devices=["cuda:0"] * 4, mesh_dp=dp, mesh_sp=sp)
    _, want = mesh_band(gc, specs, c)
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.CPU))
    p.ingest(c)
    p.finalize()
    oracle = [p.result().band_array(i) for i in range(len(specs))]
    before = kern.launches
    p, got = mesh_band(gc, specs, c, **mesh)
    assert kern.launches > before
    eng = p._engine
    assert type(eng) is (ShardedTorchEngine if grid == "untiled"
                         else PartitionedTorchEngine)
    assert all(e.device.type == "cuda" for e in eng.owners)
    for g, w, o, s in zip(got, want, oracle, specs):
        for ref in (w, o):
            if s.type in (RT.Max, RT.MostRecent):
                assert np.array_equal(g, ref, equal_nan=True)
            else:
                np.testing.assert_allclose(g, ref, atol=TOL, rtol=TOL)
                assert np.array_equal(np.isnan(g), np.isnan(ref))
    for staged in (False, True):
        again = mesh_band(gc, specs, c, staged, **mesh)[1]
        for a, g in zip(again, got):
            assert np.array_equal(a.view(np.int32), g.view(np.int32))


@pytest.mark.parametrize("glyph", ["rotp", "rot"])
def test_mesh_straddlers_on_the_card(card, glyph, monkeypatch):
    """K5 and K4 on a 512-row grid of 64-cell tiles over four 128-row
    shards, every centre within r of a shard border: windows whose home
    tile lies across the border stage dead on that side, so the mesh's
    band is within 1e-5 of the resident one, with the oracle's NaN
    footprint, and within 5e-5 of the oracle. (Against the oracle K4 and
    K5 miss 1e-5 here on the CPU as well, resident or not: their float32
    centre offset at rows of a few hundred, ROADMAP Queue 3. The plain
    versions read 2.8e-5 (K5) and 2.0e-5 (K4) on this input; the bar
    keeps the mesh from straying further.)"""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=400.0, h=512.0, tile=64)
    c = positive_cloud(40_000, 62, 400.0, 512.0)
    rng = np.random.default_rng(63)
    border = rng.integers(1, 4, c.count()) * 128
    c.set_y_array(512.0 - (border + rng.uniform(-8.0, 8.0, c.count())))
    spec = BANDED[glyph][0]()
    kern = BANDED[glyph][1]
    _, (want,) = mesh_band(gc, [spec], c)
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.CPU))
    p.ingest(c)
    p.finalize()
    oracle = p.result().band_array(0)
    before = kern.launches
    p, (got,) = mesh_band(gc, [spec], c, mesh_devices=["cuda:0"] * 4)
    assert kern.launches > before and p._engine.local_rows == 128
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, oracle, atol=5e-5, rtol=0.0)
    assert np.array_equal(np.isnan(got), np.isnan(oracle))


@pytest.mark.parametrize("owners", ["cpu", "cuda:0"])
def test_mesh_merges_across_devices(card, owners, monkeypatch):
    """A (dp 2, sp 2) mesh whose owners lie on one device and whose second
    dp row on the other: every merge copies a cell's delta between the
    host and the card through sharding.to_device (an event on the card's
    stream before the copy; a blocking copy to the host). Point Average,
    Max and MostRecent and a Gaussian, against the resident engine on the
    owners' device: sums within 1e-5, Max and MostRecent exact, and the
    card's cells through their kernels."""
    from pcr_tpu_torch.engine import routing
    from pcr_tpu_torch.parallel.engine import ShardedTorchEngine
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    other = "cuda:0" if owners == "cpu" else "cpu"
    gc = make_grid_config(w=300.0, h=256.0)
    c = positive_cloud(60_000, 64, 300.0, 256.0)
    specs = [pcr.ReductionSpec(value_channel="v", type=RT.Average),
             pcr.ReductionSpec(value_channel="v", type=RT.Max),
             pcr.ReductionSpec(value_channel="v", type=RT.MostRecent,
                               timestamp_channel="ts")]
    specs.append(pcr.gaussian_splat_spec("v", default_sigma=3.0))
    plans = [(s, pcr.get_reduction_info(s.type)) for s in specs]
    x, y = c.x_array(), c.y_array()
    values, ts = c.channel_array_f32("v"), c.channel_array_f32("ts")
    col, row, valid = routing.assign(gc, x, y)
    cells = row.astype(np.int64) * gc.width + col
    gp = routing.gaussian_params(specs[3].glyph, gc, x, y, None, None, None)
    mesh = ShardedTorchEngine(gc, plans, devices=[owners] * 2 + [other] * 2,
                              dp=2, sp=2)
    assert all(e.device == torch.device(owners) for e in mesh.owners)
    assert all(e.device == torch.device(other) for e in mesh.cells[1])
    resident = TorchEngine(gc, plans, owners)
    before = (kernels.sorted_splat_point.launches,
              gk.sorted_splat_gauss.launches)
    for eng in (mesh, resident):
        for i in range(3):
            eng.commit(i, eng.prepare_point(i, cells, valid, values, None,
                                            ts if i == 2 else None))
        eng.commit(3, eng.prepare_gaussian(3, gp, valid, values))
    assert kernels.sorted_splat_point.launches > before[0]
    assert gk.sorted_splat_gauss.launches > before[1]
    for i, s in enumerate(specs):
        for g, w in zip(mesh.fetch_state(i), resident.fetch_state(i)):
            if s.type in (RT.Max, RT.MostRecent):
                assert np.array_equal(g, w, equal_nan=True)
            else:
                np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tall", [True, False], ids=["rows", "cols"])
@pytest.mark.parametrize("glyph", ["rot", "rotp"])
def test_far_from_the_origin_k4_k5_hold_the_oracle(card, glyph, tall,
                                                   monkeypatch):
    """K4 (rotated 8 x 3) and K5 (4 x 1.5) on the card, on a 64 x 16384
    (rows) or 16384 x 64 (cols) grid: centres in the last 384 cells of the
    long axis and the same centres shifted into its first 384, values of
    both signs, Sum. Each block within 1e-5 of the numpy oracle relative
    to each cell's sum of |terms|, with the oracle's NaN footprint: the
    kernels form the distance to the centre from the integer difference,
    so the far block is no worse than the near one."""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    long, n = 16384, (300 if glyph == "rot" else 1000)
    gc = (make_grid_config(64.0, float(long)) if tall
          else make_grid_config(float(long), 64.0))
    rng = np.random.default_rng(11)
    along = rng.uniform(long - 384, long, n)
    across = rng.uniform(0, 64, n)
    along = np.concatenate([along, along - (long - 384)])
    across = np.concatenate([across, across])
    x, y = (across, long - along) if tall else (along, 64.0 - across)
    v = np.tile(rng.uniform(-2, 2, n), 2).astype(np.float32)
    glyphs = {"rot": dict(default_sigma_x=8.0, default_sigma_y=3.0),
              "rotp": dict(default_sigma_x=4.0, default_sigma_y=1.5)}
    spec = pcr.gaussian_splat_spec("v", default_rotation=0.6,
                                   **glyphs[glyph])
    spec.type = RT.Sum
    fn = gk.rot_splat_dense if glyph == "rot" else gk.rot_splat_packed

    def band(values, mode):
        c = pcr.PointCloud.create(2 * n)
        c.set_x_array(x)
        c.set_y_array(y)
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", values)
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=[spec], exec_mode=mode,
            gpu_require_strict=True))
        p.ingest(c)
        p.finalize()
        return p.result().band_array(0)

    fn.launches = 0
    got = band(v, pcr.ExecutionMode.GPU)
    assert fn.launches >= 1
    want = band(v, pcr.ExecutionMode.CPU)
    scale = band(np.abs(v), pcr.ExecutionMode.CPU)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want) & (scale > 0)
    err = np.zeros(got.shape)
    err[m] = np.abs(got[m] - want[m]) / scale[m]
    if not tall:
        err = err.T
    far, near = float(err[-384:].max()), float(err[:384].max())
    assert far <= TOL and near <= TOL, (far, near)
    assert far <= 1.5 * near + 1e-7, (far, near)


def card_and_cpu(gc, specs, clouds, device_cloud=False, **cfg):
    """{mode: pipeline} of GPU mode on the card (strict) and CPU mode, each
    fed `clouds` in turn; a Device-located cloud where device_cloud."""
    out = {}
    for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
        p = pcr.Pipeline.create(pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=mode,
            gpu_require_strict=True, **cfg))
        if mode == pcr.ExecutionMode.GPU:
            assert p._engine.device.type == "cuda"
        for c in clouds:
            p.ingest(c.to_device() if device_cloud else c)
        p.finalize()
        out[mode] = p
    return out


def card_vs_cpu(pipes, exact=()):
    g, o = (pipes[m].result() for m in (pcr.ExecutionMode.GPU,
                                        pcr.ExecutionMode.CPU))
    for i in range(g.num_bands()):
        a, b = g.band_array(i), o.band_array(i)
        assert np.array_equal(np.isnan(a), np.isnan(b)), i
        if i in exact:
            assert np.array_equal(a, b, equal_nan=True), i
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_percentile_and_median_on_the_card(card, monkeypatch):
    """Percentile 0.9 + Median + Average + Max in one pipeline over two
    clouds: the order statistics (collected on the host beside the card's
    state) exactly the CPU mode's, Average within 1e-5."""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    pct = pcr.ReductionSpec(value_channel="v", type=RT.Percentile)
    pct.percentile = 0.9
    specs = [pct, pcr.ReductionSpec(value_channel="v", type=RT.Median),
             pcr.ReductionSpec(value_channel="v", type=RT.Average),
             pcr.ReductionSpec(value_channel="v", type=RT.Max)]
    clouds = [make_cloud(60_000, seed=s, w=300.0, h=200.0) for s in (7, 8)]
    before = kernels.sorted_splat_point.launches
    card_vs_cpu(card_and_cpu(gc, specs, clouds), exact=(0, 1, 3))
    assert kernels.sorted_splat_point.launches > before


FILTERED = {
    "point": lambda: pcr.ReductionSpec(value_channel="v", type=RT.Average),
    "gauss": lambda: pcr.gaussian_splat_spec("v", default_sigma=2.0),
    "line": lambda: pcr.line_splat_spec("v", default_direction=0.7,
                                        default_half_length=4.0),
}


@pytest.mark.parametrize("glyph", list(FILTERED))
def test_filtered_spec_on_the_card(card, glyph, monkeypatch):
    """A FilterSpec on "ts" (ts > 20 and ts <= 40) on each glyph's card
    path, against CPU mode at 1e-5 (positive values), and not the
    unfiltered band."""
    from pcr_tpu_torch.engine import line_kernels as lk
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    c = positive_cloud(80_000, 9, 300.0, 200.0)
    filt = (pcr.FilterSpec().add("ts", pcr.CompareOp.Greater, 20.0)
            .add("ts", pcr.CompareOp.LessEqual, 40.0))
    kern = {"point": kernels.sorted_splat_point,
            "gauss": gk.sorted_splat_gauss, "line": lk.rect_splat}[glyph]
    before = kern.launches
    pipes = card_and_cpu(gc, [FILTERED[glyph]()], [c], filter=filt)
    assert kern.launches > before
    card_vs_cpu(pipes)
    whole = card_and_cpu(gc, [FILTERED[glyph]()], [c])
    assert not np.array_equal(
        pipes[pcr.ExecutionMode.GPU].result().band_array(0),
        whole[pcr.ExecutionMode.GPU].result().band_array(0), equal_nan=True)


def test_device_cloud_staged_once_on_the_card(card, monkeypatch):
    """A Device-located cloud ingested twice is staged once (Pipeline.stage
    counted) and its band is CPU mode's over the cloud twice."""
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = make_grid_config(w=300.0, h=200.0, tile=128)
    dcloud = make_cloud(100_000, seed=10, w=300.0, h=200.0).to_device()
    stage = pcr.Pipeline.stage
    staged = []
    monkeypatch.setattr(pcr.Pipeline, "stage", lambda self, c: (
        staged.append(c), stage(self, c))[1])
    specs = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
    p = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.GPU,
        gpu_require_strict=True))
    p.ingest(dcloud)
    p.ingest(dcloud)
    p.finalize()
    assert len(staged) == 1 and len(p._device_cloud_cache) == 1
    o = pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=specs, exec_mode=pcr.ExecutionMode.CPU))
    o.ingest(dcloud.to_host())
    o.ingest(dcloud.to_host())
    o.finalize()
    card_vs_cpu({pcr.ExecutionMode.GPU: p, pcr.ExecutionMode.CPU: o})


def test_strip_finalize_geotiff_on_the_card(card, monkeypatch, tmp_path):
    """The strip finalize (PCR_PACK_MAX_BYTES=1) streaming its GeoTIFF:
    Count + Max write the bytes CPU mode writes; an Average's file is the
    bytes write_geotiff makes of the card's band, which is within 1e-5 of
    CPU mode's."""
    from pcr_tpu_torch.io.geotiff import write_geotiff
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")
    gc = make_grid_config(w=700.0, h=600.0, tile=256)
    c = make_cloud(200_000, seed=11, w=500.0, h=600.0)   # a column idle
    for name, specs, exact in (
            ("exact", [pcr.ReductionSpec(value_channel="v", type=RT.Count),
                       pcr.ReductionSpec(value_channel="v", type=RT.Max)],
             True),
            ("avg", [pcr.ReductionSpec(value_channel="v",
                                       type=RT.Average)], False)):
        out, pipes = {}, {}
        for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
            out[mode] = str(tmp_path / f"{name}_{mode.name}.tif")
            p = pcr.Pipeline.create(pcr.PipelineConfig(
                grid=gc, reductions=specs, exec_mode=mode,
                gpu_require_strict=True, output_path=out[mode]))
            p.ingest(c)
            p.finalize()
            pipes[mode] = p
        assert pipes[pcr.ExecutionMode.GPU]._engine.device.type == "cuda"
        card_vs_cpu(pipes, exact=range(len(specs)) if exact else ())
        files = {m: read_bytes(path) for m, path in out.items()}
        if exact:
            assert files[pcr.ExecutionMode.GPU] == files[pcr.ExecutionMode.CPU]
        else:
            card_p = pipes[pcr.ExecutionMode.GPU]
            again = str(tmp_path / "again.tif")
            assert write_geotiff(again, card_p.result(), gc,
                                 card_p._geotiff_opts()).ok()
            assert files[pcr.ExecutionMode.GPU] == read_bytes(again)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("w,h", [(1, 1), (7, 3), (1, 4096), (4096, 1),
                                 (3001, 1999)])
def test_degenerate_grids_count_on_the_card(card, w, h, monkeypatch):
    """grid_sizes' degenerate shapes (K1's 64-row slices and the tile
    padding on one-cell and one-row grids): Count of 100k points on the
    card, cell for cell CPU mode's, summing to 100k."""
    from pcr_tpu_torch.scripts.diagnostics import grid_sizes
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    gc = grid_sizes.grid_config(w, h)
    c = grid_sizes.make_cloud(w, h, 100_000)
    before = kernels.sorted_splat_point.launches
    pipes = card_and_cpu(gc, [pcr.ReductionSpec(value_channel="value",
                                                type=RT.Count)], [c])
    assert kernels.sorted_splat_point.launches > before
    card_vs_cpu(pipes, exact=(0,))
    assert np.nansum(pipes[pcr.ExecutionMode.GPU].result()
                     .band_array(0)) == 100_000

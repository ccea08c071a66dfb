"""The port's walk counters on its device path on torch-CPU
(PCR_TORCH_DEVICE=cpu): K4 / K5's `rot_entries` / `rot_window_cells` and
K2's `gauss_entries` / `gauss_factor_cells` / `gauss_peak_x_runs` /
`gauss_work_items` / `gauss_split_subs`.

Under a profiler a commit of a rotated chunk adds its live entries (halo
copies included) and the cells of their windows cut to their tiles: K4's
windows are gauss_kernels.rot_dense_windows, K5's the host-clipped ones
its planes carry. A commit of a K2 chunk adds its live entries and, for
every 8 x 128 slice of its tile that an entry's window meets, a wx for
each of the window's columns there and a wy for each of its rows
(gauss_kernels.gauss_walk, held here against a loop over the entries and
the slices), and its longest tile run in live entries times the runs that
hold one (`gauss_peak_x_runs`, held against a count of each bid's live
entries: its ratio to the entries is 1 where every run is as long, and
grows with a clustered cloud's hot tiles), the items of its work list,
its runs on the grid and the segments of those it cuts, times a tile's
slices (`gauss_work_items`: the CTAs that walk), and the (sub-chunk,
slice) sums its cut runs walk into scratch (`gauss_split_subs`, held
against the plan built by hand in tests/test_torch_gauss_work.py).
`stage` counts them when it lays the chunks out, so an
ingest of a staged cloud reads nothing of the device for them; a
host-sourced ingest counts them only while a profiler records. Staged and
host-sourced ingests of one cloud count alike, by either layout route. A
K2 chunk carries its largest radius too, which picks the card's walk.
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import gauss_kernels
from pcr_tpu_torch.engine.torch_backend import _WALK_COUNTERS
from pcr_tpu_torch.utils import profiling
from test_torch_gauss_work import plan_by_hand

# the first multi-threaded float32 exp of a process can read up to 1e-4
# off every later call (tests/test_torch_pipeline.py); spend it here
torch.exp(torch.linspace(-20.0, 0.0, 1 << 20))

W, H, TILE = 150, 100, 64
# the upstream's anisotropic glyph (sigma 10 x 2.5 m, rotated): a cap of
# 40 cells gives r = 30 (K4), a cap of 16 gives r = 16 (K5); sigma 4
# (r = 12) takes K2
ROTATED = dict(default_sigma_x=10.0, default_sigma_y=2.5,
               default_rotation=0.5235987755982988)
KERNELS = {"rot": dict(ROTATED, max_radius_cells=40.0),
           "rotp": dict(ROTATED, max_radius_cells=16.0),
           "gauss": dict(default_sigma=4.0)}
RADIUS = {"rot": 30, "rotp": 16, "gauss": 12}
# K2's walk cases: sigma, the routing's product cutoff, the grid's tile
CASES = {"s1_cut": (1.0, True, 4096), "s4": (4.0, False, 4096),
         "s4_tiles": (4.0, False, TILE)}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    profiling.reset()
    yield
    profiling.reset()


def pipeline(glyph, tile=TILE, size=(W, H), **cfg):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, *map(float, size)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [pcr.gaussian_splat_spec("v", **glyph)]
    c.exec_mode = pcr.ExecutionMode.GPU
    for k, v in cfg.items():
        setattr(c, k, v)
    return pcr.Pipeline.create(c)


def cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(-5, W + 5, n))     # a few outside the grid
    c.set_y_array(rng.uniform(0, H, n))
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v", rng.uniform(0, 1, n).astype(np.float32))
    c.set_crs(pcr.CRS.from_epsg(3857))
    return c


def profiled(fn, *args):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn(*args)


def counters(kind="rot"):
    c = profiling.snapshot()["counters"]
    return tuple(c.get(name) for name in _WALK_COUNTERS[kind])


def by_hand(engine, chunk):
    """(entries, window cells) of a staged K4 / K5 chunk, entry by entry:
    a live entry (K4: r >= 0; K5: a window that is not empty) in a run of a
    tile of the state, and its window cut to that tile; a K2 chunk's
    (entries, factors) by gauss_by_hand."""
    if chunk.kind == "gauss":
        return gauss_by_hand(engine, chunk.params, chunk.bids, chunk.th,
                             chunk.wt)
    th, wt = chunk.th, chunk.wt
    ncb = engine.W_state // wt
    nb = engine.H_pad // th * ncb
    f = chunk.params.numpy()
    entries = cells = 0
    for j, bid in enumerate(chunk.bids.tolist()):
        if not 0 <= bid < nb:
            continue
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for e in range(f.shape[2]):
            p = torch.from_numpy(f[j, :, e].copy())
            if chunk.kind == "rot":
                if p[8] < 0:
                    continue
                win = [float(w) for w in gauss_kernels.rot_dense_windows(
                    p[6], p[7], p[8], engine.geom)]
            else:
                win = [float(w) for w in p[6:10]]
                if win[0] > win[1] or win[2] > win[3]:
                    continue
            entries += 1
            nx = min(win[1], c0 + wt - 1) - max(win[0], c0) + 1
            ny = min(win[3], r0 + th - 1) - max(win[2], r0) + 1
            cells += int(max(nx, 0) * max(ny, 0))
    return entries, cells


def gauss_by_hand(engine, params, bids, th, wt):
    """(entries, factors, peak x runs, work items, split subs) of a K2
    chunk, entry by entry and slice by slice: a live entry (r >= 0) in a
    run of a tile of the state, and in every 8 x 128 slice of that tile
    where its window keeps a row and a column, a factor for each of them;
    the most live entries of one bid times the bids that hold any; the
    items of the plan by hand (a run on the state, or a segment of one)
    and the sub-chunks of its tail segments, each times the slices of a
    tile."""
    ncb = engine.W_state // wt
    nb = engine.H_pad // th * ncb
    p = params.numpy()
    entries = factors = 0
    per_bid = {}
    for j, bid in enumerate(bids.tolist()):
        if not 0 <= bid < nb:
            continue
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for e in range(p.shape[2]):
            icx, icy, r = (torch.tensor(int(p[j, k, e])) for k in (0, 1, 6))
            if r < 0:
                continue
            entries += 1
            per_bid[bid] = per_bid.get(bid, 0) + 1
            clo, chi, rlo, rhi = (int(w) for w in gauss_kernels.gauss_windows(
                icx, icy, r, engine.geom))
            for y0 in range(r0, r0 + th, 8):
                rows = len(range(max(rlo, y0), min(rhi, y0 + 7) + 1))
                for x0 in range(c0, c0 + wt, 128):
                    cols = len(range(max(clo, x0), min(chi, x0 + 127) + 1))
                    if rows and cols:
                        factors += rows + cols
    slices = (th // 8) * (wt // 128)
    items = [r for r in plan_by_hand(bids.tolist(), nb) if r[0] >= 0]
    split = sum(e - f for f, e, t, _ in items if 0 <= t <= f)
    return (entries, factors, max(per_bid.values(), default=0) * len(per_bid),
            len(items) * slices, split * slices)


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_the_counters_are_the_staged_entries_and_windows(kind):
    p = pipeline(KERNELS[kind])
    staged = p.stage(cloud())
    chunks = staged.per_spec[0]
    assert {c.kind for c in chunks} == {kind}
    want = [by_hand(p._engine, c) for c in chunks]
    assert [c.walk for c in chunks] == want
    # staged outside a profiler
    assert counters(kind) == (None,) * len(_WALK_COUNTERS[kind])
    profiled(p.ingest, staged)
    entries, cells = counters(kind)[:2]
    assert entries == sum(w[0] for w in want) > 300      # halo copies
    assert cells == sum(w[1] for w in want)
    assert 0 < cells < entries * (2 * RADIUS[kind] + 1) ** 2
    once = counters(kind)
    assert once == tuple(sum(col) for col in zip(*want))
    profiled(p.ingest, staged)                 # each commit adds them
    assert counters(kind) == tuple(2 * n for n in once)
    others = {n for k, names in _WALK_COUNTERS.items() if k != kind
              for n in names} - set(_WALK_COUNTERS[kind])
    assert not others & set(profiling.snapshot()["counters"])


@pytest.mark.parametrize("case", list(CASES))
def test_gauss_walk_is_the_entries_and_their_factors_slice_by_slice(case):
    """σ 1 with the product cutoff, σ 4 on one tile and on 64-cell tiles
    (halo copies in several tiles, the home-tile clip), each chunk with a
    sub-chunk of dead entries (r = -1) appended to its last run, and with
    its runs merged pairwise into 256-wide tiles (two column slices)."""
    sigma, cut, tile = CASES[case]
    p = pipeline(dict(default_sigma=sigma), tile)
    n = 400
    (chunk,) = p.stage(cloud(n)).per_spec[0]
    assert chunk.kind == "gauss" and chunk.cut == cut
    eng = p._engine
    dead = torch.zeros_like(chunk.params[:1])
    dead[:, 6] = -1
    params = torch.cat([chunk.params, dead])
    bids = torch.cat([chunk.bids, chunk.bids[-1:]])
    shape = (eng.H_pad, eng.W_state)
    got = gauss_kernels.gauss_walk(params, bids, chunk.th, chunk.wt, shape,
                                   eng.geom)
    assert got == gauss_by_hand(eng, params, bids, chunk.th, chunk.wt)
    assert got == chunk.walk                  # the dead sub-chunk adds 0
    assert got[0] > n if tile == TILE else got[0] >= 0.9 * n  # halo copies
    r = int(np.ceil(3 * sigma))
    assert got[0] < got[1] < got[0] * (2 * r + 1) * 4
    if eng.W_state % 256 == 0:
        wide = gauss_kernels.gauss_walk(params, bids // 2, chunk.th, 256,
                                        shape, eng.geom)
        assert wide == gauss_by_hand(eng, params, bids // 2, chunk.th, 256)


@pytest.mark.parametrize("kind", ["gauss", "rot"])
def test_nothing_counts_without_a_profiler(kind, monkeypatch):
    p = pipeline(KERNELS[kind])
    staged = p.stage(cloud())
    assert all(c.walk is not None for c in staged.per_spec[0])
    name = "gauss_walk" if kind == "gauss" else "rot_walk"
    real = getattr(gauss_kernels, name)
    calls = []

    def walk(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(gauss_kernels, name, walk)
    p.ingest(cloud(seed=1))                    # laid out, not counted
    p.ingest(staged)
    p.finalize()
    assert calls == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    p = pipeline(KERNELS[kind])
    profiled(p.ingest, cloud(seed=1))          # counted under a profiler
    assert calls and counters(kind)[0] > 0


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_staged_and_host_sourced_ingests_count_alike(kind, route,
                                                     monkeypatch):
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline(KERNELS[kind])
    profiled(p.ingest, p.stage(cloud(seed=2)))
    staged = counters(kind)
    profiling.reset()
    profiled(p.ingest, cloud(seed=2))
    assert counters(kind) == staged
    assert staged[0] > 0


def points_cloud(x, y, seed=0):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(len(x))
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v",
                            rng.uniform(0, 1, len(x)).astype(np.float32))
    c.set_crs(pcr.CRS.from_epsg(3857))
    return c


# K2's tiles at sigma 1 (r = 3) are 32 rows x 128 columns
SKEW_SIGMA = dict(default_sigma=1.0)


def even_cloud(per_tile=50, seed=0):
    """`per_tile` points within 2 cells of the centre of each of the four
    32 x 128 tiles of a 256 x 64 grid: no window leaves its tile, so every
    run holds `per_tile` live entries."""
    rng = np.random.default_rng(seed)
    cx = np.repeat([64.0, 192.0, 64.0, 192.0], per_tile)
    cy = np.repeat([48.0, 48.0, 16.0, 16.0], per_tile)
    n = len(cx)
    return points_cloud(cx + rng.uniform(-2, 2, n),
                        cy + rng.uniform(-2, 2, n), seed)


def clustered_cloud(n=2000, hot=6000, seed=0):
    """`n` uniform points over a 512 x 256 grid and `hot` more piled
    within ~4 m of (100, 100), as a LiDAR scan's downtown tile."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0, 512, n), rng.normal(100, 4, hot)])
    y = np.concatenate([rng.uniform(0, 256, n), rng.normal(100, 4, hot)])
    return points_cloud(x, y, seed)


SKEWS = {"even": (even_cloud, (256, 64), 4096),
         "clustered": (clustered_cloud, (512, 256), TILE)}


def runs_by_hand(engine, chunk):
    """The most live entries (r >= 0) one bid on the state holds, times
    the bids that hold any: from the chunk's bids and r plane alone."""
    ncb = engine.W_state // chunk.wt
    nb = engine.H_pad // chunk.th * ncb
    live = (chunk.params[:, 6, :] >= 0).sum(1).tolist()
    per_bid = {}
    for bid, n in zip(chunk.bids.tolist(), live):
        if 0 <= bid < nb and n:
            per_bid[bid] = per_bid.get(bid, 0) + n
    return max(per_bid.values(), default=0) * len(per_bid)


@pytest.mark.parametrize("skew", list(SKEWS))
def test_gauss_peak_x_runs_is_the_longest_run_times_the_runs(skew):
    """An even cloud reads 1.0 (peak x runs = entries); a clustered one on
    64-cell tiles (the home-tile clip, halo copies) reads its hot tile's
    run over the mean run, here well above 1."""
    make, size, tile = SKEWS[skew]
    p = pipeline(SKEW_SIGMA, tile, size)
    staged = p.stage(make())
    (chunk,) = staged.per_spec[0]
    assert chunk.kind == "gauss" and chunk.th == 32 and chunk.wt == 128
    entries, _, peak_x_runs, _, _ = chunk.walk
    assert peak_x_runs == runs_by_hand(p._engine, chunk)
    if skew == "even":
        assert entries == 200 and peak_x_runs == entries
    else:
        assert entries > 8000                        # halo copies
        assert peak_x_runs > 10 * entries
    profiled(p.ingest, staged)
    assert counters("gauss")[2] == peak_x_runs


@pytest.mark.parametrize("skew", list(SKEWS))
def test_gauss_work_items_are_the_runs_times_the_slices(skew):
    """The items of the chunk's work list, its runs on the grid times the
    four slices of a 32 x 128 tile: the CTAs that walk, where the launch
    has a slot for each sub-chunk; a commit adds them."""
    make, size, tile = SKEWS[skew]
    p = pipeline(SKEW_SIGMA, tile, size)
    staged = p.stage(make())
    (chunk,) = staged.per_spec[0]
    eng = p._engine
    nb = eng.H_pad // chunk.th * (eng.W_state // chunk.wt)
    runs = len({b for b in chunk.bids.tolist() if 0 <= b < nb})
    items = chunk.walk[3]
    assert items == runs * 4 == int((chunk.work[:, 0] >= 0).sum()) * 4
    assert chunk.walk[4] == chunk.split_subs == 0       # no run is cut
    if skew == "even":
        assert runs == 4
    else:
        assert items < chunk.params.shape[0] * 4      # the hot tile's run
    profiled(p.ingest, staged)
    assert counters("gauss")[3] == items


@pytest.mark.parametrize("skew", list(SKEWS))
def test_gauss_split_subs_are_the_sums_a_cut_walks_into_scratch(skew):
    """Even runs are not cut: no scratch. A hot tile's run of some twenty
    sub-chunks among runs of one is: its tail segments' sub-chunks times
    the four slices, which the chunk's launch takes as its scratch, and
    each of its segments is an item; a commit adds both."""
    make, size, tile = SKEWS[skew]
    p = pipeline(SKEW_SIGMA, tile, size)
    staged = p.stage(make() if skew == "even" else make(hot=40000))
    (chunk,) = staged.per_spec[0]
    eng = p._engine
    nb = eng.H_pad // chunk.th * (eng.W_state // chunk.wt)
    items = [r for r in plan_by_hand(chunk.bids.tolist(), nb) if r[0] >= 0]
    tails = sum(e - f for f, e, t, _ in items if 0 <= t <= f)
    assert chunk.walk[3:] == (len(items) * 4, tails * 4)
    assert chunk.split_subs == tails * 4
    if skew == "even":
        assert tails == 0
    else:
        assert tails > 8 and len(items) > len(set(chunk.bids.tolist()))
    profiled(p.ingest, staged)
    assert counters("gauss")[3:] == chunk.walk[3:]


@pytest.mark.parametrize("route", ["device", "host"])
def test_the_run_skew_counts_nothing_without_a_profiler(route, monkeypatch):
    """A host-sourced ingest of the clustered cloud counts no walk outside
    a profiler, by either layout route; under one it adds the chunk's
    peak x runs, which a stage of the same cloud counts alike."""
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline(SKEW_SIGMA, TILE, (512, 256))
    p.ingest(clustered_cloud())
    p.finalize()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    p = pipeline(SKEW_SIGMA, TILE, (512, 256))
    profiled(p.ingest, clustered_cloud())
    got = counters("gauss")
    assert got[2] > 10 * got[0] > 0
    (chunk,) = p.stage(clustered_cloud()).per_spec[0]
    assert chunk.walk == got


@pytest.mark.parametrize("route", ["device", "host"])
def test_staged_and_host_sourced_ingests_count_the_run_skew_alike(
        route, monkeypatch):
    """The clustered cloud cut into three chunks (chunk_size): each
    chunk's peak x runs, summed, whether staged or host-sourced."""
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline(SKEW_SIGMA, TILE, (512, 256), chunk_size=3000)
    staged = p.stage(clustered_cloud(seed=4))
    chunks = staged.per_spec[0]
    assert len(chunks) == 3
    want = sum(runs_by_hand(p._engine, c) for c in chunks)
    profiled(p.ingest, staged)
    counted = counters("gauss")
    assert counted[2] == want > counted[0]
    profiling.reset()
    profiled(p.ingest, clustered_cloud(seed=4))
    assert counters("gauss") == counted


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("sigma,r", [(1.0, 3), (4.0, 12), (16.0, 32)])
def test_a_k2_chunk_carries_its_largest_radius(sigma, r, route,
                                               monkeypatch):
    """Both layout routes hand K2 its chunk's largest radius (ceil(3 sigma),
    capped at 32 cells), and splat_fns passes it to the kernel and to its
    plain version, which gives the same state as without it."""
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline(dict(default_sigma=sigma))
    chunks = p.stage(cloud()).per_spec[0]
    assert chunks and all(c.kind == "gauss" and c.rmax == r for c in chunks)
    eng = p._engine
    _, plain, kw = eng.splat_fns(chunks[0])
    assert kw["rmax"] == r
    got = [torch.zeros_like(s) for s in eng._states[0]]
    plain(got, chunks[0].params, chunks[0].bids, **kw)
    want = [torch.zeros_like(s) for s in eng._states[0]]
    kw.pop("rmax")
    plain(want, chunks[0].params, chunks[0].bids, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].abs().sum() > 0


def test_a_hybrid_stage_counts_on_its_workers():
    """Hybrid workers lay out a staged cloud's chunks in the stage's
    context: every chunk is counted, as by one thread."""
    p = pipeline(KERNELS["rot"], exec_mode=pcr.ExecutionMode.Hybrid,
                 hybrid_cpu_threads=2, chunk_size=100)
    chunks = p.stage(cloud()).per_spec[0]
    assert len(chunks) == 3
    assert [c.walk for c in chunks] == [by_hand(p._engine, c)
                                        for c in chunks]

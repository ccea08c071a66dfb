"""The port's K4 / K5 counters (`rot_entries`, `rot_window_cells`) on its
device path on torch-CPU (PCR_TORCH_DEVICE=cpu).

Under a profiler a commit of a rotated chunk adds its live entries (halo
copies included) and the cells of their windows cut to their tiles: K4's
windows are gauss_kernels.rot_dense_windows, K5's the host-clipped ones
its planes carry. `stage` counts them when it lays the chunks out, so an
ingest of a staged cloud reads nothing of the device for them; a
host-sourced ingest counts them only while a profiler records. Staged and
host-sourced ingests of one cloud count alike, by either layout route.
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import gauss_kernels
from pcr_tpu_torch.utils import profiling

# the first multi-threaded float32 exp of a process can read up to 1e-4
# off every later call (tests/test_torch_pipeline.py); spend it here
torch.exp(torch.linspace(-20.0, 0.0, 1 << 20))

W, H, TILE = 150, 100, 64
# the upstream's anisotropic glyph (sigma 10 x 2.5 m, rotated): a cap of
# 40 cells gives r = 30 (K4), a cap of 16 gives r = 16 (K5)
KERNELS = {"rot": 40.0, "rotp": 16.0}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    profiling.reset()
    yield
    profiling.reset()


def pipeline(cap, **cfg):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, float(W), float(H)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=TILE, tile_height=TILE,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [pcr.gaussian_splat_spec(
        "v", default_sigma_x=10.0, default_sigma_y=2.5,
        default_rotation=0.5235987755982988, max_radius_cells=cap)]
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


def counters():
    c = profiling.snapshot()["counters"]
    return c.get("rot_entries"), c.get("rot_window_cells")


def by_hand(engine, chunk):
    """(entries, window cells) of a staged chunk, entry by entry: a live
    entry (K4: r >= 0; K5: a window that is not empty) in a run of a tile
    of the state, and its window cut to that tile."""
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


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_the_counters_are_the_staged_entries_and_windows(kind):
    p = pipeline(KERNELS[kind])
    staged = p.stage(cloud())
    chunks = staged.per_spec[0]
    assert {c.kind for c in chunks} == {kind}
    want = [by_hand(p._engine, c) for c in chunks]
    assert [c.walk for c in chunks] == want
    assert counters() == (None, None)          # staged outside a profiler
    profiled(p.ingest, staged)
    entries, cells = counters()
    assert entries == sum(e for e, _ in want) > 300      # halo copies
    assert cells == sum(c for _, c in want)
    assert 0 < cells < entries * (2 * (30 if kind == "rot" else 16) + 1) ** 2
    profiled(p.ingest, staged)                 # each commit adds them
    assert counters() == (2 * entries, 2 * cells)


def test_nothing_counts_without_a_profiler(monkeypatch):
    p = pipeline(KERNELS["rot"])
    staged = p.stage(cloud())
    assert all(c.walk is not None for c in staged.per_spec[0])

    def refused(*a, **k):
        raise AssertionError("counted with no profiler recording")
    monkeypatch.setattr(gauss_kernels, "rot_walk", refused)
    p.ingest(cloud(seed=1))                    # laid out, not counted
    p.ingest(staged)
    p.finalize()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_staged_and_host_sourced_ingests_count_alike(kind, route,
                                                     monkeypatch):
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline(KERNELS[kind])
    profiled(p.ingest, p.stage(cloud(seed=2)))
    staged = counters()
    profiling.reset()
    profiled(p.ingest, cloud(seed=2))
    assert counters() == staged
    assert staged[0] > 0


def test_a_hybrid_stage_counts_on_its_workers():
    """Hybrid workers lay out a staged cloud's chunks in the stage's
    context: every chunk is counted, as by one thread."""
    p = pipeline(KERNELS["rot"], exec_mode=pcr.ExecutionMode.Hybrid,
                 hybrid_cpu_threads=2, chunk_size=100)
    chunks = p.stage(cloud()).per_spec[0]
    assert len(chunks) == 3
    assert [c.walk for c in chunks] == [by_hand(p._engine, c)
                                        for c in chunks]

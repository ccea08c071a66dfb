"""K3's walk counters on the port's device path on torch-CPU
(PCR_TORCH_DEVICE=cpu): `rect_entries`, `rect_hits` and `rect_staged`.

A commit of a Line chunk adds, while a profiler records, its live entries
(those whose rectangle meets their tile, halo copies included), the row
hits K3's walk takes on them (line_kernels.rect_walk_counts' second
number) and the entry slots K3's CTAs copy into shared memory (each tile
run's sub-chunks times BLOCK times its tile's bands). `stage` counts
them when it lays the chunks out, so an ingest of a staged cloud reads
nothing of the device for them; a host-sourced ingest counts them only
while a profiler records. Both layout routes count alike.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import gauss_kernels, line_kernels
from pcr_tpu_torch.engine.kernels import BLOCK
from pcr_tpu_torch.engine.torch_backend import _WALK_COUNTERS
from pcr_tpu_torch.utils import profiling

W, H, TILE = 300, 200, 64
NAMES = ("rect_entries", "rect_hits", "rect_staged")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    profiling.reset()
    yield
    profiling.reset()


def pipeline(tile=TILE, direction=math.pi / 6, **cfg):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, float(W), float(H)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [pcr.line_splat_spec("v", default_direction=direction,
                                        default_half_length=16.0)]
    c.exec_mode = pcr.ExecutionMode.GPU
    for k, v in cfg.items():
        setattr(c, k, v)
    return pcr.Pipeline.create(c)


def cloud(n=400, seed=0):
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
    return tuple(c.get(name) for name in NAMES)


def by_hand(engine, chunk):
    """(live entries, row hits, staged slots) of a staged K3 chunk: an
    entry of a run of a tile of the state whose rectangle, cut to that
    tile, keeps a cell; its hits as rect_walk_counts counts them; and for
    each run on the grid, each band of its tile staging the run's
    sub-chunks whole."""
    th, wt = chunk.th, chunk.wt
    ncb = engine.W_state // wt
    nb = engine.H_pad // th * ncb
    bands = -(-th // line_kernels.RECT_BAND_ROWS) * -(-wt // 128)
    live = staged = 0
    p = chunk.params.numpy()
    for j, bid in enumerate(chunk.bids.tolist()):
        if not 0 <= bid < nb:
            continue
        staged += BLOCK * bands
        r0, c0 = bid // ncb * th, bid % ncb * wt
        for ax, bx, ay, by in p[j, :4].T:
            if (max(ax, c0) <= min(bx, c0 + wt - 1)
                    and max(ay, r0) <= min(by, r0 + th - 1)):
                live += 1
    _, hits = line_kernels.rect_walk_counts(chunk.params, chunk.bids, th,
                                            wt, ncb, nb)
    return live, hits, staged


def test_the_counters_are_the_staged_entries_and_their_hits():
    assert _WALK_COUNTERS["rect"] == NAMES
    p = pipeline()
    staged = p.stage(cloud())
    chunks = staged.per_spec[0]
    assert {c.kind for c in chunks} == {"rect"}
    want = [by_hand(p._engine, c) for c in chunks]
    assert [c.walk for c in chunks] == want
    assert counters() == (None,) * 3           # staged outside a profiler
    profiled(p.ingest, staged)
    entries, hits, slots = counters()
    assert entries == sum(w[0] for w in want) > 400 * 10   # ~17 runs a line
    assert hits == sum(w[1] for w in want)
    assert slots == sum(w[2] for w in want)
    assert entries <= hits < 2 * entries       # 1-2 cell runs, one row each
    # one band a tile: every entry staged once, with its run's padding
    assert all(c.th == line_kernels.RECT_BAND_ROWS for c in chunks)
    runs = sum(len(c.bids.unique()) for c in chunks)
    assert entries <= slots < entries + BLOCK * runs
    profiled(p.ingest, staged)                 # each commit adds them
    assert counters() == (2 * entries, 2 * hits, 2 * slots)
    others = {n for k, names in _WALK_COUNTERS.items() if k != "rect"
              for n in names}
    assert not others & set(profiling.snapshot()["counters"])


@pytest.mark.parametrize("direction", [0.0, 0.7, math.pi / 2])
def test_rect_walk_reads_the_chunk_in_slices(direction, monkeypatch):
    """The chunk read a sub-chunk at a time (_WALK_SUBS = 1) counts what
    the whole-chunk recount does, on a grid of 64- and 128-column tiles
    and with a sub-chunk of padding appended."""
    staged = []
    for tile in (TILE, 4096):
        p = pipeline(tile, direction)
        (chunk,) = p.stage(cloud(300, seed=4)).per_spec[0]
        staged.append((p._engine, chunk))
    monkeypatch.setattr(gauss_kernels, "_WALK_SUBS", 1)
    for eng, chunk in staged:
        pad = torch.zeros_like(chunk.params[:1])
        pad[:, 0] = 1                          # ax = 1 > bx = 0
        params = torch.cat([chunk.params, pad])
        bids = torch.cat([chunk.bids, chunk.bids[-1:]])
        got = line_kernels.rect_walk(params, bids, chunk.th, chunk.wt,
                                     (eng.H_pad, eng.W_state))
        assert chunk.walk == by_hand(eng, chunk)
        assert got == by_hand(eng, dataclasses.replace(chunk, params=params,
                                                       bids=bids))
        # the padding adds no entry and no hit, and one staged sub-chunk
        assert got[:2] == chunk.walk[:2] and got[0] > 0
        assert got[2] == chunk.walk[2] + BLOCK


def test_nothing_counts_without_a_profiler(monkeypatch):
    p = pipeline()
    staged = p.stage(cloud())
    assert all(c.walk is not None for c in staged.per_spec[0])
    real = line_kernels.rect_walk
    calls = []

    def walk(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(line_kernels, "rect_walk", walk)
    p.ingest(cloud(seed=1))                    # laid out, not counted
    p.ingest(staged)
    p.finalize()
    assert calls == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    p = pipeline()
    profiled(p.ingest, cloud(seed=1))          # counted under a profiler
    assert calls and counters()[0] > 0


@pytest.mark.parametrize("route", ["device", "host"])
def test_staged_and_host_sourced_ingests_count_alike(route, monkeypatch):
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline()
    profiled(p.ingest, p.stage(cloud(seed=2)))
    staged = counters()
    profiling.reset()
    profiled(p.ingest, cloud(seed=2))
    assert counters() == staged
    assert staged[0] > 0


def test_a_hybrid_stage_counts_on_its_workers():
    """Hybrid workers lay out a staged cloud's chunks in the stage's
    context: every chunk is counted, as by one thread."""
    p = pipeline(exec_mode=pcr.ExecutionMode.Hybrid, hybrid_cpu_threads=2,
                 chunk_size=150)
    chunks = p.stage(cloud()).per_spec[0]
    assert len(chunks) == 3
    assert [c.walk for c in chunks] == [by_hand(p._engine, c)
                                        for c in chunks]

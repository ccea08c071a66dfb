"""K2's work list (gauss_kernels.gauss_work) on the CPU (PCR_TORCH_DEVICE=cpu).

The card's K2 launches one CTA a (tile run, slice) item of the list: item i
is run list[i // slices], slice i % slices. The list holds the first
sub-chunk of each run on the grid, the runs longest first in sub-chunks and
ties by tile id, then -1 in the slots left over. Held here against a sort in
Python on hand-made and random bids; on staged K2 chunks by both layout
routes, which build it once, with the layout, for the kernel to take where
it is given the chunk's own bids; and against the plain version, whose
bits no list moves. The card test holds the kernel's bits
under three orders of the list (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine import gauss_kernels as gk

# the first multi-threaded float32 exp of a process can read up to 1e-4
# off every later call (tests/test_torch_pipeline.py); spend it here
torch.exp(torch.linspace(-20.0, 0.0, 1 << 20))

NB = 9           # tiles on the grid of the hand-made bids
SLICES = 8
BIDS = {         # ascending bids, one a sub-chunk
    "even": [0, 0, 1, 1, 2, 2, 3, 3],
    "skewed": [0, 1, 1, 1, 1, 2, 3, 3, 5, 5, 5, 5, 5, 5, 6],
    "off_grid": [-1, -1, 0, 2, 2, 4, 4, 4, 9, 9, 12],
    "ties": [0, 0, 1, 2, 2, 3, 4, 4, 5, 6, 6, 8],
    "one_run": [3] * 6,
    "empty": [0],
}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def runs_by_hand(bids, nb_total):
    """{first sub-chunk: sub-chunks} of each run of one bid on the grid."""
    runs = {}
    for j, b in enumerate(bids):
        if not 0 <= b < nb_total:
            continue
        if j and bids[j - 1] == b:
            runs[max(runs)] += 1
        else:
            runs[j] = 1
    return runs


def list_by_hand(bids, nb_total):
    runs = runs_by_hand(bids, nb_total)
    firsts = sorted(runs, key=lambda j: (-runs[j], bids[j]))
    return firsts + [-1] * (len(bids) - len(firsts))


def random_bids(seed, nb_total=40):
    """Runs of 1-20 sub-chunks on some of the tiles, a few of them off the
    grid at either end."""
    rng = np.random.default_rng(seed)
    tiles = np.sort(rng.choice(np.arange(-3, nb_total + 3), 25,
                               replace=False))
    return np.repeat(tiles, rng.integers(1, 21, len(tiles))).tolist()


CASES = dict(BIDS, **{f"random{s}": random_bids(s) for s in range(4)})


@pytest.mark.parametrize("case", list(CASES))
def test_the_list_holds_each_run_on_the_grid_once_longest_first(case):
    bids = CASES[case]
    nb_total = 40 if case.startswith("random") else NB
    b = torch.tensor(bids, dtype=torch.int32)
    work = gk.gauss_work(b, nb_total)
    assert work.dtype == torch.int32 and work.shape == (len(bids),)
    assert work.is_contiguous()
    assert work.tolist() == list_by_hand(bids, nb_total)
    # the launch's items: every (run, slice) of the grid's runs once, none
    # of a run off the grid
    runs = runs_by_hand(bids, nb_total)
    items = [(int(work[i // SLICES]), i % SLICES)
             for i in range(len(work) * SLICES) if work[i // SLICES] >= 0]
    assert len(items) == len(set(items)) == len(runs) * SLICES
    assert set(items) == {(j, s) for j in runs for s in range(SLICES)}
    # the unused slots last; the same list from the same bids
    n = len(runs)
    assert (work[:n] >= 0).all() and (work[n:] == -1).all()
    assert torch.equal(gk.gauss_work(b.clone(), nb_total), work)


def test_even_runs_keep_tile_order():
    b = torch.arange(50, dtype=torch.int32).repeat_interleave(3)
    assert gk.gauss_work(b, 50).tolist() == list(range(0, 150, 3)) + \
        [-1] * 100


def pipeline(tile=64, size=(300, 200)):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, *map(float, size)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    spec = pcr.gaussian_splat_spec("v", default_sigma=1.0)
    spec.type = pcr.ReductionType.WeightedAverage
    return pcr.Pipeline.create(pcr.PipelineConfig(
        grid=gc, reductions=[spec], exec_mode=pcr.ExecutionMode.GPU))


def cloud(x, y, seed=0):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(len(x))
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v",
                            rng.uniform(0, 1, len(x)).astype(np.float32))
    c.set_crs(pcr.CRS.from_epsg(3857))
    return c


def clustered(n=1500, hot=5000, seed=0):
    """Uniform points and a pile of `hot` more within ~4 m of (100, 100):
    one tile's run several sub-chunks long, the others one."""
    rng = np.random.default_rng(seed)
    return cloud(np.concatenate([rng.uniform(0, 300, n),
                                 rng.normal(100, 4, hot)]),
                 np.concatenate([rng.uniform(0, 200, n),
                                 rng.normal(100, 4, hot)]), seed)


def nb_total(eng, chunk):
    return eng.H_pad // chunk.th * (eng.W_state // chunk.wt)


@pytest.mark.parametrize("route", ["device", "host"])
def test_a_staged_k2_chunk_carries_its_list_from_layout(route, monkeypatch):
    """Both layout routes build the list with the chunk; splat_fns hands
    the chunk to the kernel, and an ingest of the staged cloud builds no
    list."""
    if route == "host":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    p = pipeline()
    staged = p.stage(clustered())
    eng = p._engine
    (chunk,) = staged.per_spec[0]
    assert chunk.kind == "gauss"
    work = gk.gauss_work(chunk.bids, nb_total(eng, chunk))
    assert torch.equal(chunk.work, work)
    assert chunk.work.tolist() == list_by_hand(chunk.bids.tolist(),
                                               nb_total(eng, chunk))
    assert work[0] != 0                    # the hot tile's run goes first
    assert eng.splat_fns(chunk)[2]["chunk"] is chunk
    calls = []
    real = gk.gauss_work
    monkeypatch.setattr(gk, "gauss_work",
                        lambda *a: calls.append(1) or real(*a))
    p.ingest(staged)
    p.finalize()
    assert calls == []


def test_an_empty_chunk_gives_a_list_the_kernel_takes():
    """A cloud with no point on the grid stages one sub-chunk of fills for
    tile 0; its list is that sub-chunk, which the wrapper takes, and it
    adds nothing."""
    p = pipeline()
    (chunk,) = p.stage(cloud(np.full(5, -50.0), np.full(5, -50.0))
                       ).per_spec[0]
    assert chunk.kind == "gauss" and chunk.params.shape[0] == 1
    assert chunk.bids.tolist() == [0] and chunk.work.tolist() == [0]
    eng = p._engine
    kern, _, kw = eng.splat_fns(chunk)
    states = [torch.zeros_like(s) for s in eng._states[0]]
    kern(states, chunk.params, chunk.bids, **kw)
    assert not any(s.any() for s in states)


def test_plain_gives_the_same_bits_with_and_without_a_list():
    p = pipeline()
    (chunk,) = p.stage(clustered(seed=3)).per_spec[0]
    eng = p._engine
    _, plain, kw = eng.splat_fns(chunk)
    kw.pop("chunk")
    flipped = dataclasses.replace(
        chunk, work=torch.flip(chunk.work, [0]).contiguous())
    got = []
    for extra in ({}, dict(chunk=chunk), dict(chunk=flipped)):
        for fn in (plain, gk.sorted_splat_gauss):
            st = [torch.zeros_like(s) for s in eng._states[0]]
            fn(st, chunk.params, chunk.bids, **kw, **extra)
            got.append(torch.cat([s.view(-1) for s in st]).view(torch.int32))
    assert got[0].any()
    assert all(torch.equal(g, got[0]) for g in got[1:])


@pytest.mark.parametrize("given", ["own_bids", "other_bids", "no_chunk",
                                   "no_list"])
def test_the_kernel_takes_the_chunks_list_only_for_its_own_bids(given):
    """The list a staged chunk carries orders a launch over that chunk's
    bids tensor; a launch over other bids (a test's merged runs, say), or
    with no chunk or no list, takes gauss_work of the bids it is given."""
    p = pipeline()
    (chunk,) = p.stage(clustered(seed=5)).per_spec[0]
    nb = nb_total(p._engine, chunk)
    bids = chunk.bids // 2 if given == "other_bids" else chunk.bids
    with_chunk = {"own_bids": chunk, "other_bids": chunk, "no_chunk": None,
                  "no_list": dataclasses.replace(chunk, work=None)}[given]
    work = gk._work_of(with_chunk, bids, nb)
    if given == "own_bids":
        assert work is chunk.work
    else:
        assert work is not chunk.work
    assert torch.equal(work, gk.gauss_work(bids, nb))

"""K2's work list (gauss_kernels.gauss_work) on the CPU (PCR_TORCH_DEVICE=cpu).

The card's K2 launches one CTA an (item, slice): item i is row i // slices
of the list, slice i % slices. A row is [first, end, tail, base]: the
sub-chunks [first, end) of a tile run on the grid, or of a segment of a
run cut for its length, the items longest first in sub-chunks and ties by
first sub-chunk, then rows of -1 in the slots left over. A run longer than
the bound (SPLIT_FLOOR, or SPLIT_MULT times the chunk's mean run if more)
is cut into the fewest segments of at most the bound, as even as whole
sub-chunks allow; its rows carry its first sub-chunk after the head
segment (`tail`) and the scratch sub-chunk that tail takes (`base`), a
whole run's -1. The runs take scratch longest first, and under a budget
the runs past it stay whole. Held here against a plan built in Python
on hand-made and random bids, against the properties a launch needs
(every sub-chunk of every run on the grid walked once, segments
consecutive and within the bound, disjoint scratch), and against a model
of the kernel's fold in float32 under any order in which the CTAs finish;
on staged K2 chunks by both layout routes, which build it once, with the
layout, for the kernel to take where it is given the chunk's own bids; and
against the plain version, whose bits no list moves. The card tests hold
the kernel's bits under orders and cuts of the list
(tests/test_torch_cuda.py).
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
    """The list of whole runs: each run's first sub-chunk, longest first."""
    runs = runs_by_hand(bids, nb_total)
    firsts = sorted(runs, key=lambda j: (-runs[j], bids[j]))
    return firsts + [-1] * (len(bids) - len(firsts))


def bound_by_hand(runs):
    """The segment bound of runs {first: sub-chunks}: SPLIT_FLOOR, or
    ceil(SPLIT_MULT x the mean run) if more."""
    total, n = sum(runs.values()), max(len(runs), 1)
    return max(gk.SPLIT_FLOOR, -(-gk.SPLIT_MULT * total // n))


def plan_by_hand(bids, nb_total, budget=None):
    """gauss_work's rows, run by run: each run over the bound cut into
    ceil(length / bound) segments, the first length % m a sub-chunk
    longer; scratch taken by the cut runs longest first (ties by first
    sub-chunk) while it stays within `budget`."""
    runs = runs_by_hand(bids, nb_total)
    bound = bound_by_hand(runs)
    rows, room, full = [], 0, False
    for j in sorted(runs, key=lambda j: (-runs[j], j)):
        n = runs[j]
        m = -(-n // bound)
        lens = [n // m + (i < n % m) for i in range(m)]
        tail = base = -1
        if m > 1:
            room += n - lens[0]
            full = full or (budget is not None and room > budget)
            if full:
                lens = [n]
            else:
                tail, base = j + lens[0], room - (n - lens[0])
        a = j
        for k in lens:
            rows.append([a, a + k, tail, base])
            a += k
    rows.sort(key=lambda r: (r[0] - r[1], r[0]))
    return rows + [[-1] * 4] * (len(bids) - len(rows))


def random_bids(seed, nb_total=40):
    """Runs of 1-20 sub-chunks on some of the tiles, a few of them off the
    grid at either end."""
    rng = np.random.default_rng(seed)
    tiles = np.sort(rng.choice(np.arange(-3, nb_total + 3), 25,
                               replace=False))
    return np.repeat(tiles, rng.integers(1, 21, len(tiles))).tolist()


def skewed_bids(seed, nb_total=40):
    """Runs of 1-3 sub-chunks on most of the tiles and of up to 150 on a
    few hot ones, some tiles off the grid: the long runs are cut."""
    rng = np.random.default_rng(seed)
    tiles = np.sort(rng.choice(np.arange(-3, nb_total + 3), 30,
                               replace=False))
    reps = rng.integers(1, 4, len(tiles))
    hot = rng.choice(len(tiles), 4, replace=False)
    reps[hot] = rng.integers(20, 151, 4)
    return np.repeat(tiles, reps).tolist()


CASES = dict(BIDS, **{f"random{s}": random_bids(s) for s in range(4)})
# long runs among short ones: one hot tile, two, one off the grid, and ties
SKEWED = {
    "hot": list(range(30)) + [30] * 200,
    "two_hot": [0] * 90 + list(range(1, 20)) + [20] * 45 + [21, 22],
    "hot_off_grid": [-1] * 300 + list(range(12)) + [12] * 70,
    "hot_ties": [0] * 60 + list(range(1, 16)) + [16] * 60,
    **{f"skewed{s}": skewed_bids(s) for s in range(6)},
}
BUDGETS = {"none": None, "zero": 0, "small": 30, "ample": 10_000}


def nb_of(case):
    return NB if case in BIDS else 40


def rows(work):
    """The list's used rows as (first, end, tail, base) tuples."""
    return [tuple(r) for r in work.tolist() if r[0] >= 0]


@pytest.mark.parametrize("case", list(CASES))
def test_the_list_holds_each_run_on_the_grid_once_longest_first(case):
    """With no scratch (budget 0), and where every run is within the
    bound, the list is of whole runs: each run's first sub-chunk and end,
    no tail and no scratch."""
    bids = CASES[case]
    nb_total = nb_of(case)
    b = torch.tensor(bids, dtype=torch.int32)
    assert gk.gauss_work(b, nb_total).tolist() == plan_by_hand(bids,
                                                               nb_total)
    runs = runs_by_hand(bids, nb_total)
    if max(runs.values(), default=0) <= bound_by_hand(runs):
        assert torch.equal(gk.gauss_work(b, nb_total),
                           gk.gauss_work(b, nb_total, 0))
    work = gk.gauss_work(b, nb_total, 0)
    assert work.dtype == torch.int32 and work.shape == (len(bids), 4)
    assert work.is_contiguous()
    assert work[:, 0].tolist() == list_by_hand(bids, nb_total)
    assert work.tolist() == plan_by_hand(bids, nb_total, 0)
    assert (work[:, 2:] == -1).all() and int(gk._tail_subs(work)) == 0
    # the launch's items: every (run, slice) of the grid's runs once, none
    # of a run off the grid
    runs = runs_by_hand(bids, nb_total)
    items = [(int(work[i // SLICES, 0]), i % SLICES)
             for i in range(len(work) * SLICES) if work[i // SLICES, 0] >= 0]
    assert len(items) == len(set(items)) == len(runs) * SLICES
    assert set(items) == {(j, s) for j in runs for s in range(SLICES)}
    assert all(e == j + runs[j] for j, e, _, _ in rows(work))
    # the unused slots last; the same list from the same bids
    n = len(runs)
    assert (work[:n, :2] >= 0).all() and (work[n:] == -1).all()
    assert torch.equal(gk.gauss_work(b.clone(), nb_total, 0), work)


def test_even_runs_keep_tile_order():
    b = torch.arange(50, dtype=torch.int32).repeat_interleave(3)
    work = gk.gauss_work(b, 50)
    assert work[:, 0].tolist() == list(range(0, 150, 3)) + [-1] * 100
    assert work[:50, 1].tolist() == list(range(3, 153, 3))
    assert (work[:, 2:] == -1).all()


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("case", list(SKEWED))
def test_a_cut_list_is_the_plan_by_hand(case, budget):
    bids = SKEWED[case]
    b = torch.tensor(bids, dtype=torch.int32)
    work = gk.gauss_work(b, 40, BUDGETS[budget])
    assert work.shape == (len(bids), 4) and work.dtype == torch.int32
    assert work.tolist() == plan_by_hand(bids, 40, BUDGETS[budget])


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("case", list(SKEWED))
def test_segments_cover_every_run_once_within_the_bound(case, budget):
    """Every sub-chunk of every run on the grid lies in one item; a run's
    segments are consecutive, the first at the run's start, each at most
    the bound, as even as whole sub-chunks allow; a cut run's items agree
    on its tail, the head's end, and its base."""
    bids = SKEWED[case]
    runs = runs_by_hand(bids, 40)
    bound = bound_by_hand(runs)
    work = gk.gauss_work(torch.tensor(bids, dtype=torch.int32), 40,
                         BUDGETS[budget])
    got = rows(work)
    walked = [k for first, end, _, _ in got for k in range(first, end)]
    assert sorted(walked) == [k for j in runs for k in range(j, j + runs[j])]
    by_run = {}
    for first, end, tail, base in got:
        j = max(r for r in runs if r <= first)
        by_run.setdefault(j, []).append((first, end, tail, base))
    assert sorted(by_run) == sorted(runs)
    for j, segs in by_run.items():
        segs.sort()
        assert segs[0][0] == j and segs[-1][1] == j + runs[j]
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        lens = [e - f for f, e, _, _ in segs]
        assert max(lens) - min(lens) <= 1 and lens == sorted(lens)[::-1]
        assert len({(t, b) for _, _, t, b in segs}) == 1
        tail, base = segs[0][2:]
        if len(segs) == 1:
            assert (tail, base) == (-1, -1)
        else:
            assert max(lens) <= bound < runs[j]
            assert tail == segs[0][1] and base >= 0
    # longest first, ties by first sub-chunk
    assert [(f - e, f) for f, e, _, _ in got] == sorted(
        (f - e, f) for f, e, _, _ in got)


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("case", list(SKEWED))
def test_scratch_bases_are_disjoint_and_within_the_budget(case, budget):
    """Each cut run's tails take scratch sub-chunks [base, base + tails);
    the ranges of the cut runs do not meet, lie within the budget, and add
    up to the scratch gauss_walk counts."""
    bids = SKEWED[case]
    work = gk.gauss_work(torch.tensor(bids, dtype=torch.int32), 40,
                         BUDGETS[budget])
    runs = runs_by_hand(bids, 40)
    spans = {}
    for first, end, tail, base in rows(work):
        if tail >= 0:
            j = max(r for r in runs if r <= first)
            spans[j] = (base, base + j + runs[j] - tail)
    taken = sorted(spans.values())
    assert all(a[1] <= b[0] for a, b in zip(taken, taken[1:]))
    need = sum(e - b for b, e in taken)
    assert int(gk._tail_subs(work)) == need
    if BUDGETS[budget] is not None:
        assert need <= BUDGETS[budget]
    if taken:
        assert taken[0][0] == 0 and taken[-1][1] == need
    if budget == "zero":
        assert not taken and work[:, 0].tolist() == list_by_hand(bids, 40)
    if budget in ("none", "ample"):
        assert taken, "a long run is cut"


@pytest.mark.parametrize("case", [c for c in SKEWED if c.startswith("sk")])
def test_an_exhausted_budget_cuts_the_longest_runs_first(case):
    """Under a budget smaller than the cuts need, the runs cut are the
    longest ones, as many as fit in order; the others stay whole."""
    bids = SKEWED[case]
    runs = runs_by_hand(bids, 40)
    want = rows(gk.gauss_work(torch.tensor(bids, dtype=torch.int32), 40))
    need = {}
    for first, end, tail, base in want:
        if tail >= 0:
            j = max(r for r in runs if r <= first)
            need[j] = j + runs[j] - tail
    assert len(need) >= 2
    longest = sorted(need, key=lambda j: (-runs[j], j))
    budget = need[longest[0]] + need[longest[1]] - 1
    got = rows(gk.gauss_work(torch.tensor(bids, dtype=torch.int32), 40,
                             budget))
    cut = {max(r for r in runs if r <= f) for f, _, t, _ in got if t >= 0}
    assert cut == {longest[0]}
    whole = {f for f, e, t, _ in got if t < 0}
    assert set(longest[1:]) <= whole
    assert all(e == f + runs[f] for f, e, t, _ in got
               if t < 0 and f in runs)


def fold_by_hand(work, bids, nb_total, sums, finish):
    """A model of K2's schedule on one cell a tile, in float32: each item
    walks its sub-chunks; a whole run's or head's sums go into the state
    one at a time, a tail's into its scratch sub-chunk; the items finish
    in the order `finish` and each of a cut run counts the sub-chunks it
    walked, and the one that completes the run's (by the bids) adds the
    tails' sums into the state in sub-chunk order. Returns the state,
    which starts at 1."""
    state = np.ones(nb_total, np.float32)
    scratch = {}
    counts = {}
    live = [r for r in work.tolist() if r[0] >= 0]
    for i in finish(len(live)):
        first, end, tail, base = live[i]
        bid = bids[first]
        if not 0 <= bid < nb_total:
            continue
        run0 = bids.index(bid)
        run1 = len(bids) - bids[::-1].index(bid)
        if (tail < 0 or first < tail) and first != run0:
            continue
        end = run1 if tail < 0 else min(end, run1)
        for k in range(first, end):
            if tail >= 0 and first >= tail:
                scratch[base + k - tail] = sums[k]
            else:
                state[bid] = np.float32(state[bid] + sums[k])
        if tail >= 0:
            counts[base] = counts.get(base, 0) + end - first
            if counts[base] == run1 - run0:
                for k in range(tail, run1):
                    state[bid] = np.float32(state[bid]
                                            + scratch[base + k - tail])
    return state


@pytest.mark.parametrize("case", list(SKEWED))
def test_the_fold_adds_each_cells_sums_in_order_whatever_finishes_first(
        case):
    """In the model, the cut list gives the state of the list with every
    run whole, bit for bit, whichever item finishes first: the list's
    order, reversed, and shuffled."""
    bids = SKEWED[case]
    rng = np.random.default_rng(len(bids))
    sums = (rng.standard_normal(len(bids))
            * 10.0 ** rng.integers(-3, 4, len(bids))).astype(np.float32)
    b = torch.tensor(bids, dtype=torch.int32)
    whole = fold_by_hand(gk.gauss_work(b, 40, 0), bids, 40, sums, range)
    for budget in (None, 30):
        work = gk.gauss_work(b, 40, budget)
        for finish in (range, lambda n: range(n - 1, -1, -1),
                       lambda n: rng.permutation(n)):
            got = fold_by_hand(work, bids, 40, sums, finish)
            assert got.view(np.int32).tolist() == \
                whole.view(np.int32).tolist()
    # a list that misses a tail segment never folds, and so differs
    work = gk.gauss_work(b, 40)
    tails = [i for i, r in enumerate(work.tolist()) if 0 <= r[2] <= r[0]]
    if tails:
        broken = work.clone()
        broken[tails[0]] = -1
        got = fold_by_hand(broken, bids, 40, sums, range)
        assert got.view(np.int32).tolist() != whole.view(np.int32).tolist()


def test_bids_off_the_grid_and_no_bids_give_a_list_the_kernel_takes():
    """Runs off the grid take no item; all of them off it, or no bids,
    give a list of unused rows (or none)."""
    for bids in ([-1] * 5 + [45] * 40, [40] * 30):
        work = gk.gauss_work(torch.tensor(bids, dtype=torch.int32), 40)
        assert work.shape == (len(bids), 4) and (work == -1).all()
    work = gk.gauss_work(torch.zeros(0, dtype=torch.int32), 40)
    assert work.shape == (0, 4) and work.dtype == torch.int32


def pipeline(tile=64, size=(300, 200), sigma=1.0):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, *map(float, size)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    spec = pcr.gaussian_splat_spec("v", default_sigma=sigma)
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


def slices(chunk):
    return chunk.th // 8 * (chunk.wt // 128)


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
    assert chunk.work.tolist() == plan_by_hand(chunk.bids.tolist(),
                                               nb_total(eng, chunk))
    assert work[0, 0] != 0                 # the hot tile's run goes first
    assert chunk.split_subs == chunk.walk[4] == 0
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
    assert chunk.bids.tolist() == [0]
    assert chunk.work.tolist() == [[0, 1, -1, -1]]
    eng = p._engine
    kern, _, kw = eng.splat_fns(chunk)
    states = [torch.zeros_like(s) for s in eng._states[0]]
    kern(states, chunk.params, chunk.bids, **kw)
    assert not any(s.any() for s in states)


def test_plain_gives_the_same_bits_with_and_without_a_list():
    """Without a list, with the chunk's, that list reversed, and a list
    that cuts the hot tile's run (the bound's floor at 1 sub-chunk)."""
    p = pipeline()
    (chunk,) = p.stage(clustered(seed=3, hot=20000)).per_spec[0]
    eng = p._engine
    _, plain, kw = eng.splat_fns(chunk)
    kw.pop("chunk")
    flipped = dataclasses.replace(
        chunk, work=torch.flip(chunk.work, [0]).contiguous())
    nb = nb_total(eng, chunk)
    whole = dataclasses.replace(chunk, work=gk.gauss_work(chunk.bids, nb, 0),
                                split_subs=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gk, "SPLIT_FLOOR", 1)
        mp.setattr(gk, "SPLIT_MULT", 1)
        cut = gk.gauss_work(chunk.bids, nb)
    assert (cut[:, 2] >= 0).any()
    cut = dataclasses.replace(
        chunk, work=cut, split_subs=int(gk._tail_subs(cut)) * slices(chunk))
    got = []
    for extra in ({}, dict(chunk=chunk), dict(chunk=flipped),
                  dict(chunk=whole), dict(chunk=cut)):
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
    with no chunk or no list, takes gauss_work of the bids it is given
    with every run whole, and no scratch."""
    p = pipeline()
    (chunk,) = p.stage(clustered(seed=5)).per_spec[0]
    nb = nb_total(p._engine, chunk)
    bids = chunk.bids // 2 if given == "other_bids" else chunk.bids
    with_chunk = {"own_bids": chunk, "other_bids": chunk, "no_chunk": None,
                  "no_list": dataclasses.replace(chunk, work=None)}[given]
    work, subs = gk._work_of(with_chunk, bids, nb)
    if given == "own_bids":
        assert work is chunk.work and subs == chunk.split_subs
        assert torch.equal(work, gk.gauss_work(bids, nb))
    else:
        assert work is not chunk.work and subs == 0
        assert torch.equal(work, gk.gauss_work(bids, nb, 0))


@pytest.mark.parametrize("route,sigma", [
    ("stage", 1.0), ("stage", 6.0), ("ingest", 1.0), ("traced", 1.0)],
    ids=["staged_table", "staged_wide", "per_call", "per_call_traced"])
def test_only_a_staged_chunk_of_the_table_walk_cuts_its_runs(route, sigma,
                                                             monkeypatch):
    """`stage` cuts the long runs of a chunk that K2's walk with factor
    tables takes (radius up to GAUSS_TABLE_RADIUS) and counts the scratch
    its cuts need. A chunk of the wide walk (sigma 6: r 18), and a chunk
    laid out per call, traced or not, take every run whole, and a launch
    over them no scratch, though the bound (here at one sub-chunk) would
    cut their hot tile's run."""
    monkeypatch.setattr(gk, "SPLIT_FLOOR", 1)
    monkeypatch.setattr(gk, "SPLIT_MULT", 1)
    p = pipeline(sigma=sigma)
    eng = p._engine
    chunks = []
    real = eng._counted
    monkeypatch.setattr(eng, "_counted",
                        lambda c: chunks.append(real(c)) or chunks[-1])
    if route == "traced":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            p.ingest(clustered(hot=20000))
    else:
        getattr(p, route)(clustered(hot=20000))
    (chunk,) = chunks
    nb = nb_total(eng, chunk)
    assert (chunk.rmax <= gk.GAUSS_TABLE_RADIUS) == (sigma == 1.0)
    assert (gk.gauss_work(chunk.bids, nb)[:, 2] >= 0).any()
    assert (chunk.walk is None) == (route == "ingest")
    if route == "stage" and sigma == 1.0:
        assert torch.equal(chunk.work, gk.gauss_work(chunk.bids, nb))
        assert chunk.split_subs == chunk.walk[4] == (
            int(gk._tail_subs(chunk.work)) * slices(chunk)) > slices(chunk)
    else:
        assert torch.equal(chunk.work, gk.gauss_work(chunk.bids, nb, 0))
        assert chunk.split_subs == 0
        assert chunk.walk is None or chunk.walk[4] == 0
    work, subs = gk._work_of(chunk, chunk.bids, nb)
    assert work is chunk.work and subs == chunk.split_subs

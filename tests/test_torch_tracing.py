"""The port's spans and counters (pcr_tpu_torch.utils.profiling) on its
device path on torch-CPU (PCR_TORCH_DEVICE=cpu).

Without a profiler nothing records, the between-job gap included. Under
torch.profiler every span is a "pcr." range nested in the caller's own
range, on the profiler's clock; `ingest` counts once a public call and
`create` once a `Pipeline.create`; a span's self time is the rest of its
seconds once its children's are taken out, and its longest call lies
between its mean and its total; the layout synchronises twice a Point
chunk and three times a Gaussian or Line chunk (torch.bincount's host read
of the largest tile id counts since it is timed as a sync: once and twice
before); the arena's wait counts once a reused buffer; the between-job gap
opens at a finalize's copy and closes at the next job's first upload or
commit, and drops a gap the profiler stopped on; `d2h_bytes` are the
band's bytes (no pinned block, so no `finalize.pin` and no
`d2h_pin_new_bytes`: no card); Hybrid workers leave no self time negative;
and the bands do not change under the profiler.
"""

import sys

import numpy as np
import pytest
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.engine.torch_backend import _Arena, _HostBuf
from pcr_tpu_torch.utils import profiling

# the first multi-threaded float32 exp of a process can read up to 1e-4
# off every later call (tests/test_torch_pipeline.py); spend it here
torch.exp(torch.linspace(-20.0, 0.0, 1 << 20))

RT = pcr.ReductionType
CPU_SPANS = {"create", "ingest", "ingest.route", "ingest.buffer",
             "ingest.pack", "ingest.upload", "ingest.layout", "sync",
             "ingest.commit", "ingest.tiles", "finalize", "finalize.device",
             "finalize.d2h", "finalize.mask"}
W, H = 300, 200


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    profiling.reset()
    yield
    profiling.reset()


def grid(tile=128):
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = 0.0, 0.0, float(W), float(H)
    gc = pcr.GridConfig(bounds=b, cell_size_x=1.0, cell_size_y=-1.0,
                        tile_width=tile, tile_height=tile,
                        crs=pcr.CRS.from_epsg(3857))
    gc.compute_dimensions()
    return gc


def cloud(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, W, n))
    c.set_y_array(rng.uniform(0, 0.8 * H, n))   # a tile row left untouched
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v", rng.uniform(0, 1, n).astype(np.float32))
    c.set_crs(pcr.CRS.from_epsg(3857))
    return c


GLYPHS = {
    "point": pcr.GlyphSpec(),
    "gaussian": pcr.GlyphSpec(type=pcr.GlyphType.Gaussian,
                              default_sigma_x=2.0, default_sigma_y=2.0),
    "line": pcr.GlyphSpec(type=pcr.GlyphType.Line, default_half_length=3.0,
                          default_direction=0.6),
}


def pipeline(glyph="point", **cfg):
    c = pcr.PipelineConfig()
    c.grid = grid()
    c.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Average,
                                      glyph=GLYPHS[glyph])]
    c.exec_mode = pcr.ExecutionMode.GPU
    for k, v in cfg.items():
        setattr(c, k, v)
    return pcr.Pipeline.create(c)


def job(glyph="point", calls=2, **cfg):
    """A whole job of `calls` host clouds; its band."""
    p = pipeline(glyph, **cfg)
    for s in range(calls):
        p.ingest(cloud(seed=s))
    p.finalize()
    return p.result().band_array(0)


def staged_jobs(jobs, glyph="point", staged=None):
    """`jobs` whole jobs of one cloud staged once (made here unless
    given), as a staged cell runs them; the last job's band."""
    staged = staged or pipeline(glyph).stage(cloud())
    for _ in range(jobs):
        p = pipeline(glyph)
        p.ingest(staged)
        p.finalize()
    return p.result().band_array(0)


def profiled(fn, *args, **kw):
    """fn(...) under torch.profiler; (its result, the profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, prof


@pytest.mark.parametrize("glyph,staged", [("point", False),
                                          ("gaussian", False),
                                          ("point", True)],
                         ids=["point", "gaussian", "point-staged"])
def test_nothing_records_without_a_profiler(glyph, staged):
    """Two jobs back to back: neither `create`, nor the gap between them,
    nor any other row records, and no gap is left open."""
    before = profiling.snapshot()
    for _ in range(2):
        staged_jobs(1, glyph) if staged else job(glyph)
    profiling.gap_open()
    profiling.gap_close()
    assert profiling.snapshot() == before == {"spans": {}, "counters": {}}
    assert profiling._gap_t0 is None
    assert profiling.span("ingest") is profiling.span("finalize")
    assert profiling.device_span("x", torch.device("cpu")) is \
        profiling.span("x")


@pytest.mark.parametrize("glyph", ["point", "gaussian"])
def test_the_bands_are_the_same_under_the_profiler(glyph):
    off = job(glyph)
    on, _ = profiled(job, glyph)
    assert np.array_equal(off.view(np.int32), on.view(np.int32))
    assert profiling.snapshot()["spans"]["ingest"]["n"] == 2


def test_spans_are_ranges_inside_the_callers_own():
    def traced():
        with torch.profiler.record_function("caller"):
            job()
    _, prof = profiled(traced)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    (caller,) = [r for r in ranges if r[0] == "caller"]
    ours = [r for r in ranges if r[0].startswith(profiling.PREFIX)]
    assert {n[len(profiling.PREFIX):] for n, _, _ in ours} == CPU_SPANS
    for _, start, end in ours:
        assert caller[1] <= start <= end <= caller[2]
    # each child inside one of its parent's ranges, on the same clock
    parents = {"ingest.route": "ingest", "ingest.commit": "ingest",
               "sync": "ingest.layout", "finalize.d2h": "finalize"}
    for child, parent in parents.items():
        outer = [(s, e) for n, s, e in ours if n == profiling.PREFIX + parent]
        for n, s, e in ours:
            if n == profiling.PREFIX + child:
                assert any(a <= s <= e <= b for a, b in outer), child
    spans = profiling.snapshot()["spans"]
    for name in CPU_SPANS:
        assert spans[name]["n"] == sum(
            n == profiling.PREFIX + name for n, _, _ in ours)


def test_ingest_counts_once_a_public_call():
    def calls():
        p = pipeline()
        p.ingest(cloud(seed=1))
        dev = cloud(seed=2).to_device()
        p.ingest(dev)                       # staged once, then ingested
        p.ingest(dev)                       # from the pipeline's cache
        p.ingest(p.stage(cloud(seed=3)))
        p.finalize()
    profiled(calls)
    spans = profiling.snapshot()["spans"]
    assert spans["ingest"]["n"] == 4
    assert spans["ingest.commit"]["n"] == 4
    assert spans["ingest.route"]["n"] == 1    # host clouds alone route
    assert spans["finalize"]["n"] == 1


def test_self_time_is_what_the_children_leave():
    profiled(job)
    spans = profiling.snapshot()["spans"]
    tree = {"ingest": ["ingest.route", "ingest.buffer", "ingest.pack",
                       "ingest.upload", "ingest.layout", "ingest.commit",
                       "ingest.tiles"],
            "ingest.layout": ["sync"],
            "finalize": ["finalize.device", "finalize.d2h",
                         "finalize.mask"]}
    for parent, children in tree.items():
        got = spans[parent]["self_s"] + sum(spans[c]["s"] for c in children)
        assert got == pytest.approx(spans[parent]["s"], rel=1e-9, abs=1e-9)
        assert spans[parent]["self_s"] >= 0
    for name in ("create", "ingest.route", "sync", "finalize.d2h"):
        assert spans[name]["self_s"] == spans[name]["s"]


def test_create_records_once_a_pipeline_create():
    def creates():
        for glyph in ("point", "gaussian", "line"):
            pipeline(glyph)
        job()
    profiled(creates)
    spans = profiling.snapshot()["spans"]
    assert spans["create"]["n"] == 4
    assert spans["ingest"]["n"] == 2 and spans["finalize"]["n"] == 1


@pytest.mark.parametrize("staged", [False, True])
def test_the_longest_call_lies_between_the_mean_and_the_total(staged):
    profiled(staged_jobs, 3) if staged else profiled(job, calls=3)
    spans = profiling.snapshot()["spans"]
    assert spans and ("job_gap" in spans) == staged
    for name, row in spans.items():
        assert row["n"] >= 1, name
        mean = row["s"] / row["n"]
        assert mean * (1 - 1e-12) <= row["max_s"] <= row["s"] * (1 + 1e-12)
        if row["n"] == 1:
            assert row["max_s"] == pytest.approx(row["s"], rel=1e-12)


@pytest.mark.parametrize("staged", [False, True])
def test_the_gap_opens_at_a_finalize_and_closes_at_the_next_accumulate(
        staged, monkeypatch):
    """Three jobs, one after another: the gap opens where a finalize's
    copy returns and closes at the next job's first device work, the
    upload of a host cloud or the commit of a staged one; two gaps, each
    with no self time, and the one the last job opened is still open."""
    calls = []
    gap_open, gap_close = profiling.gap_open, profiling.gap_close

    def logged(what, fn):
        def call():
            calls.append((what, sys._getframe(1).f_code.co_name,
                          profiling._gap_t0 is not None))
            fn()
        return call
    monkeypatch.setattr(profiling, "gap_open", logged("open", gap_open))
    monkeypatch.setattr(profiling, "gap_close", logged("close", gap_close))

    def jobs():
        if staged:
            return staged_jobs(3, staged=pipeline().stage(cloud()))
        for _ in range(3):
            job(calls=1)
    profiled(jobs)
    opens = [c for c in calls if c[0] == "open"]
    assert len(opens) == 3 and {c[1] for c in opens} == {"_to_host"}
    # the closes that found a gap open: one each after the first job
    closing = [c[1] for c in calls if c[0] == "close" and c[2]]
    assert closing == ["commit" if staged else "put"] * 2
    assert profiling._gap_t0 is not None      # the last job's, still open
    row = profiling.snapshot()["spans"]["job_gap"]
    assert row["n"] == 2
    assert row["self_s"] == 0 and row["device_s"] is None
    assert 0 < row["max_s"] <= row["s"]


def test_a_gap_the_profiler_stopped_on_records_nothing():
    staged = pipeline().stage(cloud())
    profiled(staged_jobs, 1, staged=staged)     # leaves its gap open
    assert profiling._gap_t0 is not None
    staged_jobs(1, staged=staged)               # closes it, unrecorded
    assert profiling._gap_t0 is None
    profiled(staged_jobs, 1, staged=staged)
    spans = profiling.snapshot()["spans"]
    assert "job_gap" not in spans
    assert spans["create"]["n"] == 2 and spans["ingest.commit"]["n"] == 2
    profiling.reset()
    assert profiling._gap_t0 is None            # reset drops an open gap


@pytest.mark.parametrize("glyph,per_chunk", [("point", 2), ("gaussian", 3),
                                             ("line", 3)])
def test_the_layout_synchronises_as_its_docstring_says(glyph, per_chunk):
    p = pipeline(glyph, chunk_size=6000)
    staged, _ = profiled(p.stage, cloud())
    chunks = len(staged.per_spec[0])
    assert chunks == 4                        # 20000 points, 6000 a chunk
    snap = profiling.snapshot()
    assert snap["counters"]["syncs"] == per_chunk * chunks
    assert snap["spans"]["sync"]["n"] == per_chunk * chunks
    assert snap["spans"]["ingest.layout"]["n"] == chunks


class _Event:
    """A copy's event that has completed."""
    waits = 0

    def synchronize(self):
        _Event.waits += 1


def test_the_arena_waits_once_a_reused_buffer():
    arena = _Arena(torch.device("cpu"))
    arena.cuda = True                 # its reuse path, without a card
    hb = _HostBuf(torch.empty(256, dtype=torch.int32))
    arena.give_back(hb)
    _Event.waits = 0

    def reuse(times):
        for _ in range(times):
            got = arena.checkout(100)
            assert got is hb
            got.event = _Event()
            arena.give_back(got)
    profiled(reuse, 3)
    snap = profiling.snapshot()
    # the first checkout found no event yet: two waits for three reuses
    assert _Event.waits == 2
    assert snap["counters"]["syncs"] == 2
    assert snap["spans"]["ingest.buffer"]["n"] == 3
    assert snap["spans"]["sync"]["n"] == 2


@pytest.mark.parametrize("with_state", [False, True])
def test_d2h_bytes_are_the_bands(with_state, tmp_path):
    """One finalize.d2h a reduction: the band's bytes, or with a state_dir
    the K = 2 state planes of an Average."""
    cfg = {"state_dir": str(tmp_path / "state")} if with_state else {}
    band, _ = profiled(job, **cfg)
    snap = profiling.snapshot()
    assert band.nbytes == W * H * 4
    planes = 2 if with_state else 1
    assert snap["counters"]["d2h_bytes"] == planes * W * H * 4
    # pageable off a card: no pinned block, so no checkout to time
    assert "d2h_pin_new_bytes" not in snap["counters"]
    assert "finalize.pin" not in snap["spans"]
    assert snap["spans"]["finalize.d2h"]["n"] == 1
    assert snap["spans"]["finalize.d2h"]["device_s"] is None   # no card
    assert snap["counters"]["h2d_bytes"] == 2 * 20000 * 8  # cell | value


def test_hybrid_workers_leave_no_self_time_negative():
    cfg = dict(exec_mode=pcr.ExecutionMode.Hybrid, hybrid_cpu_threads=2,
               chunk_size=4000)
    band, _ = profiled(job, calls=2, **cfg)
    spans = profiling.snapshot()["spans"]
    for name, row in spans.items():
        assert row["self_s"] >= 0, name
        assert row["s"] >= row["self_s"]
    assert spans["ingest"]["n"] == 2
    assert spans["ingest.pack"]["n"] == 10    # 5 chunks a call, on workers
    assert spans["ingest.commit"]["n"] == 10
    assert np.array_equal(band.view(np.int32),
                          job(calls=2, chunk_size=4000).view(np.int32))

"""The Line glyph (glyphs/line.py) and its cell, `line_hl16.device`: the
registry's cell, whole runs of it on the CPU (the port's device path on
torch-CPU, K3's plain version), the control and planted faults outside
the limits, `spec`'s refusals, `work` against a count by brute force, and
the two metrics that read the port's K3 counters. The reference against
the port by every route, and one stroke worked by hand, are in
tests/test_torch_line_reference.py (tier-1)."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cardbench import compare, jobs, program_spans, registry, run
from cardbench.grid import Grid
from cardbench.metrics import rect_entries_per_pt, rect_hits_per_entry
from cardbench.points import Points

CELL = "line_hl16.device"
CONFIG = json.load(open(f"{registry.HERE}/configs/glyph_line_hl16.json"))
RED = CONFIG["reductions"][0]
CPU = torch.device("cpu")


def _config(tile=4096, count=3000, size=(96, 80)):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["grid"].update(extent_x=float(size[0]), extent_y=float(size[1]),
                       tile=tile)
    cfg["points"]["count"] = count
    return cfg


def _points(cfg, seed):
    return registry.cloud_generator(cfg["points"]["kind"])(
        cfg["points"], Grid.of(cfg), seed)


def _job(cfg, pts):
    return jobs.job(jobs.Feed(cfg, {"source": "staged"}, pts), jobs.Walls())


def _stroke_moved_one_cell(monkeypatch, cfg, pts):
    """The port's runs one column east of where the walk puts them."""
    from pcr_tpu_torch.engine import device_prep
    real = device_prep.line_runs_device

    def moved(*a, **k):
        ax, bx, ay, by, owner, keep = real(*a, **k)
        return ax + 1, bx + 1, ay, by, owner, keep
    monkeypatch.setattr(device_prep, "line_runs_device", moved)
    return _job(cfg, pts)


def _north_up_sign_dropped(monkeypatch, cfg, pts):
    """hy = +16 where the north-up grid makes it -16: every stroke mirrored
    about its row, which is the port's stroke at the opposite heading
    (cos is even and sin odd, in float32 too)."""
    bad = json.loads(json.dumps(cfg))
    bad["reductions"][0]["direction"] = -RED["direction"]
    return _job(bad, pts)


def _value_in_bfloat16(monkeypatch, cfg, pts):
    v = torch.from_numpy(pts.value).to(torch.bfloat16).float().numpy()
    return _job(cfg, Points(pts.x, pts.y, v))


@pytest.mark.parametrize("fault", [None, _stroke_moved_one_cell,
                                   _north_up_sign_dropped,
                                   _value_in_bfloat16])
def test_the_control_and_planted_faults_are_not_correct(fault, on_cpu,
                                                        monkeypatch):
    """Through the run's own check: the program is correct; the control
    (bfloat16 values summed in float32) and each planted fault are not."""
    cfg = _config()
    pts = _points(cfg, 2 ** 31 + 3)
    if fault is None:
        ctl = compare.references(cfg, pts, "cpu", control=True)
        bands = tuple(c.numpy() for c in ctl)
        checks, limits, correct = run.check(cfg, pts, [bands], 0, CPU)
        assert correct is False
        assert checks["max_rel_err"] > 10 * limits["max_rel_err"]
        checks, _, correct = run.check(cfg, pts, [_job(cfg, pts)], 0, CPU)
        assert correct is True and checks["max_rel_err"] < 1e-6
        return
    bands = fault(monkeypatch, cfg, pts)
    checks, limits, correct = run.check(cfg, pts, [bands], 0, CPU)
    assert correct is False
    assert (checks["nan_cells_differ"] > 0
            or checks["max_rel_err"] > 10 * limits["max_rel_err"])


def test_spec_refuses_what_the_reference_does_not_hold():
    import pcr_tpu_torch as pcr
    g = registry.glyph("line")
    s = g.spec(pcr, RED)
    assert s.type == pcr.ReductionType.WeightedAverage
    assert s.glyph.type == pcr.GlyphType.Line
    assert s.glyph.default_direction == pytest.approx(math.pi / 6)
    assert s.glyph.default_half_length == 16.0
    assert s.glyph.max_radius_cells == 32.0
    assert not s.glyph.direction_channel and not s.glyph.half_length_channel
    for channel in ("direction_channel", "half_length_channel", "sigma_x"):
        with pytest.raises(ValueError, match=channel):
            g.spec(pcr, dict(RED, **{channel: "d"}))
    for rtype in ("Sum", "Max", "Count"):
        with pytest.raises(ValueError, match=rtype):
            g.spec(pcr, dict(RED, type=rtype))
    assert g.spec(pcr, dict(RED, type="Average")).type == \
        pcr.ReductionType.Average


def _walk_by_hand(x0, y0, x1, y1):
    """The upstream's dual-step Bresenham walk, one cell at a time."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err, cells = dx - dy, []
    for _ in range(2 * (dx + dy) + 3):
        cells.append((x0, y0))
        if (x0, y0) == (x1, y1):
            break
        e2 = 2 * err
        if e2 > -dy:
            err, x0 = err - dy, x0 + sx
        if e2 < dx:
            err, y0 = err + dx, y0 + sy
    return cells


def test_work_counts_the_kept_pairs_by_brute_force():
    """Each kept (point, cell) pair 2 operations; 4 B a live point; 16 B a
    touched cell a call; counted here by loops over points and cells, on
    8-cell tiles so that home-tile clips and the grid's edge cut strokes."""
    cfg = _config(tile=8, size=(20, 16))
    red = dict(RED, half_length=5.0)
    grid = Grid.of(cfg)
    rng = np.random.default_rng(7)
    pts = Points(rng.uniform(-1, 21, 9), rng.uniform(0, 16, 9),
                 np.ones(9, np.float32))
    calls = [(0, 4), (4, 9)]
    c = float(np.cos(np.float32(red["direction"])))
    s = float(np.sin(np.float32(red["direction"])))

    def rnd(a):
        return math.floor(a + 0.5) if a >= 0 else math.ceil(a - 0.5)
    nbytes = pairs = 0
    for a, b in calls:
        touched = set()
        for i in range(a, b):
            x, y = pts.x[i], pts.y[i]
            if not (0 <= x <= 20 and 0 <= y <= 16):
                continue
            nbytes += 4
            fc, fr = x, 16 - y
            col, row = min(math.floor(fc), 19), min(math.floor(fr), 15)
            c0, r0 = col // 8 * 8, row // 8 * 8
            cells = _walk_by_hand(rnd(fc - 5 * c), rnd(fr + 5 * s),
                                  rnd(fc + 5 * c), rnd(fr - 5 * s))
            for gx, gy in cells:
                if c0 <= gx < min(c0 + 8, 20) and r0 <= gy < min(r0 + 8, 16):
                    pairs += 1
                    touched.add((gy, gx))
        nbytes += 16 * len(touched)
    got = registry.glyph("line").work(pts, grid, red, calls)
    assert pairs > 0
    assert got == {"bytes": nbytes, "flops": 2 * pairs}


def test_the_registry_loads_the_cell(bench):
    """The cell from the repository's benchmark, and from its small copy
    (conftest.small_bench, cut by the repository root's conftest.py)."""
    cell = registry.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["source"] == "staged"
    assert cell.config["reductions"] == [RED]
    assert cell.config["points"]["count"] == 5_000_000
    assert {m["name"] for m in cell.end_to_end} == {"mpts_s", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"rect_entries_per_pt", "rect_hits_per_entry", "splat_roofline",
            "finalize_ms", "device_idle_pct", "peak_dev_gib"} <= per_layer
    assert not {"rot_entries_per_pt", "rot_cells_per_entry"} & per_layer
    small = registry.load_cell(CELL, bench)
    assert small.config["points"]["count"] < 10_000


@pytest.mark.parametrize("trace", [0, 1])
def test_a_whole_run_of_the_cell_is_correct(trace, bench, on_cpu, capsys,
                                            monkeypatch):
    from pcr_tpu_torch.utils import profiling
    measured = []
    measure = run.measure

    def keep(*a, **k):
        out = measure(*a, **k)
        measured.append(out)
        return out
    monkeypatch.setattr(run, "measure", keep)
    profiling.reset()
    rc = run.execute(registry.load_cell(CELL, bench), 2 ** 32 + 5, 0.5,
                     bool(trace), time.perf_counter(), CPU)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["nan_cells_differ"]["value"] == 0
    if not trace:
        assert set(line["metrics"]) == {"mpts_s", "setup_s"}
        profiling.reset()
        return
    (r, pts, *_), = measured
    jobs_done = len(r.job_ends)
    counters = profiling.snapshot()["counters"]
    # the staged chunks' entries and hits, once a job of the window
    feed = jobs.Feed(registry.load_cell(CELL, bench).config,
                     {"source": "staged", "chunk_points": 0}, pts)
    walks = [c.walk for c in feed.inputs[0].per_spec[0]]
    entries, hits = (sum(w[k] for w in walks) for k in (0, 1))
    assert counters["rect_entries"] == entries * jobs_done
    assert counters["rect_hits"] == hits * jobs_done
    got = line["metrics"]
    assert got["rect_entries_per_pt"]["value"] == pytest.approx(
        entries / len(pts))
    # 17 runs a line, fewer on a 96 x 80 grid whose edges cut strokes
    assert 10.0 < got["rect_entries_per_pt"]["value"] < 18.0
    assert 1.0 <= got["rect_hits_per_entry"]["value"] < 1.1
    assert "row hits an entry" in err   # (work's pairs: a card's run)
    profiling.reset()


def test_the_readers_on_a_hand_made_snapshot(monkeypatch):
    """Two jobs of 1000 points whose commits folded 34000 entries and
    34500 row hits."""
    from pcr_tpu_torch.utils import profiling
    snap = {"spans": {}, "counters": {"rect_entries": 34_000,
                                      "rect_hits": 34_500}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    r = run.Run(points_per_job=1000, setup_s=1.0, window_start=0.0,
                job_ends=[1.0, 2.0])
    r.trace = object()
    assert rect_entries_per_pt.read(r) == 17.0
    assert rect_hits_per_entry.read(r) == 34_500 / 34_000
    snap["counters"] = {"rot_entries": 3}     # no Line chunk committed
    assert rect_entries_per_pt.read(r) is None
    assert rect_hits_per_entry.read(r) is None
    r.job_ends = []
    snap["counters"] = {"rect_entries": 34_000, "rect_hits": 34_500}
    assert rect_entries_per_pt.read(r) is None
    assert rect_hits_per_entry.read(r) is None
    r.trace = None                           # an untraced run
    assert program_spans.snapshot(r) is None
    assert rect_entries_per_pt.read(r) is None


@pytest.mark.cuda
def test_the_cell_on_the_card():
    """On the card: a short traced run of the cell through the command,
    correct, with the counters' metrics and K3's roofline share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "cardbench", "--workload",
                        CELL, "--seed", "7", "--seconds", "2", "--trace",
                        "1"], cwd=registry.REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"rect_entries_per_pt", "rect_hits_per_entry",
            "splat_roofline"} <= set(line["metrics"])
    assert 16.8 <= line["metrics"]["rect_entries_per_pt"]["value"] <= 18.0

"""The rotated Gaussian glyph (glyphs/gaussian_rot.py) and its cell,
`gauss_rot10x2.5.device`: the reference worked by hand and against the
port's numpy oracle and its device path on torch-CPU at the published
footprint (sigma 10 x 2.5 m, 30 degrees, a cap of 40 cells: K4; a cap of
16: K5) on 32-cell tiles, where the home-tile clip bites; the control and
planted faults outside the limits; `spec`'s refusals; `work` against a
count by brute force; whole runs of the cell; and the two metrics that
read the port's K4 / K5 counters."""

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
from cardbench.metrics import rot_cells_per_entry, rot_entries_per_pt
from cardbench.points import Points

CELL = "gauss_rot10x2.5.device"
CONFIG = json.load(open(f"{registry.HERE}/configs/glyph_gauss_rot10x2.5.json"))
RED = CONFIG["reductions"][0]
CPU = torch.device("cpu")
# the cap of 40 gives r = 30 (K4); a cap of 16 gives r = 16 (K5)
CAPS = {"rot": 40.0, "rotp": 16.0}


def _config(cap=40.0, tile=32, count=3000, size=(96, 80)):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["grid"].update(extent_x=float(size[0]), extent_y=float(size[1]),
                       tile=tile)
    cfg["points"]["count"] = count
    cfg["reductions"][0]["max_radius_cells"] = cap
    return cfg


def _points(cfg, seed):
    return registry.cloud_generator(cfg["points"]["kind"])(
        cfg["points"], Grid.of(cfg), seed)


def _ref(cfg, points, **kw):
    red = cfg["reductions"][0]
    return registry.glyph("gaussian_rot").reference(points, Grid.of(cfg),
                                                    red, "cpu", **kw)


def test_the_footprint_by_hand():
    """One point at a cell's centre: the ellipse's long axis runs 30
    degrees below the grid's x axis (rows grow southward); 20 cells along
    it are kept, 20 across it are cut, 30 along a row are cut (the ellipse
    is thin), and the window stops 30 columns out though the weight there
    along the axis would be kept."""
    cfg = _config(tile=4096, size=(81, 81))
    p = Points(np.array([40.5]), np.array([40.5]), np.ones(1, np.float32))
    got = _ref(cfg, p).numpy()
    row, col = 40, 40
    assert got[row, col] == 1.0
    assert got[row + 10, col + 17] == 1.0       # along the long axis
    assert np.isnan(got[row - 10, col + 17])    # the other diagonal
    assert np.isnan(got[row + 17, col - 10])    # across it
    assert np.isnan(got[row, col + 30])
    assert got[row + 15, col + 26] == 1.0
    assert np.isnan(got[row + 17, col + 31])    # w 2.3e-3, past r = 30


def test_two_points_weigh_by_the_rotated_distance():
    cfg = _config(tile=4096, size=(81, 81))
    p = Points(np.array([40.5, 44.5]), np.array([40.5, 40.5]),
               np.array([1, 3], np.float32))
    got = _ref(cfg, p).numpy()
    c, s = math.cos(-math.pi / 6), math.sin(-math.pi / 6)

    def w(dx, dy):       # offsets in cells, rows southward; sy = -2.5
        qx = (dx * c - dy * s) / 10.0
        qy = (dx * s + dy * c) / -2.5
        return math.exp(-0.5 * (qx * qx + qy * qy))
    # cell (43, 46) from each point, whose sub-cell offsets are 0.5
    w1, w2 = w(5.5, 2.5), w(1.5, 2.5)
    assert got[43, 46] == pytest.approx((w1 + 3 * w2) / (w1 + w2), rel=1e-6)


@pytest.mark.parametrize("kind", sorted(CAPS))
def test_the_reference_holds_the_ports_oracle_and_device_path(kind, on_cpu):
    """The port's numpy oracle (CPU mode) and its device path on torch-CPU
    (staged, the kernel's plain version) against the reference, on two
    seeds, within the configuration's limits; the chunks are the kernel's
    own."""
    for seed in (2 ** 31 + 17, 5):
        cfg = _config(CAPS[kind])
        pts = _points(cfg, seed)
        refs = compare.references(cfg, pts, "cpu")
        for mode, traffic in (("CPU", "host"), ("GPU", "staged")):
            cfg["pipeline"]["exec_mode"] = mode
            feed = jobs.Feed(cfg, {"source": traffic, "chunk_points": 0},
                             pts)
            if traffic == "staged":
                (staged,) = feed.inputs
                assert {c.kind for c in staged.per_spec[0]} == {kind}
            got = compare.readings([jobs.job(feed, jobs.Walls())], refs)
            assert got["nan_cells_differ"] == 0, (mode, got)
            assert got["max_rel_err"] < CONFIG["limits"]["max_rel_err"], \
                (mode, got)


def _state_unchanged(monkeypatch, cfg, pts):
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    monkeypatch.setattr(TorchEngine, "commit", lambda self, i, staged: None)
    return jobs.job(jobs.Feed(cfg, {"source": "staged"}, pts), jobs.Walls())


def _half_the_cloud(monkeypatch, cfg, pts):
    h = len(pts) // 2
    half = Points(pts.x[:h], pts.y[:h], pts.value[:h])
    return jobs.job(jobs.Feed(cfg, {"source": "staged"}, half), jobs.Walls())


def _one_cell_altered(monkeypatch, cfg, pts):
    bands = jobs.job(jobs.Feed(cfg, {"source": "staged"}, pts), jobs.Walls())
    band = bands[0].copy()
    r, c = np.argwhere(~np.isnan(band))[0]
    band[r, c] += 1.0
    return (band,)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_the_cloud,
                                   _one_cell_altered])
def test_the_control_and_planted_faults_are_not_correct(fault, on_cpu,
                                                        monkeypatch):
    """Through the run's own check: the program is correct; the control
    (bfloat16 terms summed in float32) and each planted fault are not."""
    cfg = _config(tile=4096)
    pts = _points(cfg, 2 ** 31 + 3)
    if fault is None:
        ctl = compare.references(cfg, pts, "cpu", control=True)
        bands = tuple(c.numpy() for c in ctl)
        checks, limits, correct = run.check(cfg, pts, [bands], 0, CPU)
        assert correct is False
        assert checks["max_rel_err"] > 10 * limits["max_rel_err"]
        good = jobs.job(jobs.Feed(cfg, {"source": "staged"}, pts),
                        jobs.Walls())
        assert run.check(cfg, pts, [good], 0, CPU)[2] is True
        return
    bands = fault(monkeypatch, cfg, pts)
    assert run.check(cfg, pts, [bands], 0, CPU)[2] is False


def test_spec_refuses_what_the_reference_does_not_hold():
    import pcr_tpu_torch as pcr
    g = registry.glyph("gaussian_rot")
    s = g.spec(pcr, RED)
    assert s.type == pcr.ReductionType.WeightedAverage
    assert s.glyph.type == pcr.GlyphType.Gaussian
    assert (s.glyph.default_sigma_x, s.glyph.default_sigma_y) == (10.0, 2.5)
    assert s.glyph.default_rotation == pytest.approx(math.pi / 6)
    assert s.glyph.max_radius_cells == 40.0
    for channel in ("rotation_channel", "sigma_x_channel", "sigma_y_channel"):
        with pytest.raises(ValueError, match=channel):
            g.spec(pcr, dict(RED, **{channel: "rot"}))
    for bad in (dict(RED, rotation=0.0), dict(RED, sigma_y=10.0),
                dict(RED, sigma_y=-10.0)):
        with pytest.raises(ValueError, match="not rotated"):
            g.spec(pcr, bad)
    for rtype in ("Sum", "Max", "Count"):
        with pytest.raises(ValueError, match=rtype):
            g.spec(pcr, dict(RED, type=rtype))
    assert g.spec(pcr, dict(RED, type="Average")).type == \
        pcr.ReductionType.Average


def test_work_counts_the_kept_pairs_by_brute_force():
    """Each kept (point, cell) pair 9 operations; 4 B a live point; 16 B
    a touched cell a call; counted here by loops over points and cells."""
    cfg = _config(cap=6.0, tile=8, size=(20, 16))
    grid = Grid.of(cfg)
    rng = np.random.default_rng(7)
    pts = Points(rng.uniform(-1, 21, 9), rng.uniform(0, 16, 9),
                 np.ones(9, np.float32))
    calls = [(0, 4), (4, 9)]
    c, s = math.cos(-float(np.float32(math.pi / 6))), \
        math.sin(-float(np.float32(math.pi / 6)))
    nbytes = pairs = 0
    for a, b in calls:
        touched = set()
        for i in range(a, b):
            x, y = pts.x[i], pts.y[i]
            if not (0 <= x <= 20 and 0 <= y <= 16):
                continue
            nbytes += 4
            fc, fr = x, 16 - y
            ic, ir = math.floor(fc), math.floor(fr)
            col, row = min(max(ic, 0), 19), min(max(ir, 0), 15)
            c0, r0 = col // 8 * 8, row // 8 * 8
            for dy in range(-6, 7):
                for dx in range(-6, 7):
                    gx, gy = ic + dx, ir + dy
                    if not (c0 <= gx < min(c0 + 8, 20)
                            and r0 <= gy < min(r0 + 8, 16)):
                        continue
                    rdx, rdy = dx - (fc - ic), dy - (fr - ir)
                    qx = (rdx * c - rdy * s) / 10.0
                    qy = (rdx * s + rdy * c) / -2.5
                    if math.exp(-0.5 * (qx * qx + qy * qy)) >= 1e-6:
                        pairs += 1
                        touched.add((gy, gx))
        nbytes += 16 * len(touched)
    got = registry.glyph("gaussian_rot").work(pts, grid, cfg["reductions"][0],
                                              calls)
    assert pairs > 0
    assert got == {"bytes": nbytes, "flops": 9 * pairs}


def test_the_registry_loads_the_cell(bench):
    """The cell from the repository's benchmark, and from its small copy
    (conftest.small_bench, cut by cardbench/conftest.py's SMALL)."""
    cell = registry.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["source"] == "staged"
    assert cell.config["reductions"] == [RED]
    assert {m["name"] for m in cell.end_to_end} == {"mpts_s", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"rot_entries_per_pt", "rot_cells_per_entry", "splat_roofline",
            "finalize_ms", "device_idle_pct", "peak_dev_gib"} <= per_layer
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
    entries = profiling.snapshot()["counters"]["rot_entries"]
    # the staged chunks' entries, once a job of the window
    feed = jobs.Feed(registry.load_cell(CELL, bench).config,
                     {"source": "staged", "chunk_points": 0}, pts)
    staged = sum(c.walk[0] for c in feed.inputs[0].per_spec[0])
    assert entries == staged * jobs_done
    got = line["metrics"]
    assert got["rot_entries_per_pt"]["value"] == pytest.approx(
        staged / len(pts))
    assert 1.0 < got["rot_entries_per_pt"]["value"] < 12.0
    assert 0 < got["rot_cells_per_entry"]["value"] <= 32 * 128
    assert "window cells an entry" in err   # (work's pairs: a card's run)
    profiling.reset()


def test_the_readers_on_a_hand_made_snapshot(monkeypatch):
    """Two jobs of 1000 points whose commits folded 8000 entries of 750
    cells each."""
    from pcr_tpu_torch.utils import profiling
    snap = {"spans": {}, "counters": {"rot_entries": 8000,
                                      "rot_window_cells": 6_000_000}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    r = run.Run(points_per_job=1000, setup_s=1.0, window_start=0.0,
                job_ends=[1.0, 2.0])
    r.trace = object()
    assert rot_entries_per_pt.read(r) == 8000 / 2000
    assert rot_cells_per_entry.read(r) == 750.0
    snap["counters"] = {"syncs": 3}          # no rotated chunk committed
    assert rot_entries_per_pt.read(r) is None
    assert rot_cells_per_entry.read(r) is None
    r.job_ends = []
    assert rot_entries_per_pt.read(r) is None
    r.trace = None                           # an untraced run
    assert program_spans.snapshot(r) is None
    assert rot_cells_per_entry.read(r) is None


@pytest.mark.cuda
def test_the_cell_on_the_card():
    """On the card: a short traced run of the cell through the command,
    correct, with the counters' metrics and K4's roofline share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "cardbench", "--workload",
                        CELL, "--seed", "7", "--seconds", "2", "--trace",
                        "1"], cwd=registry.REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"rot_entries_per_pt", "rot_cells_per_entry",
            "splat_roofline"} <= set(line["metrics"])

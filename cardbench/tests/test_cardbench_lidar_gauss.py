"""The DC LiDAR Gaussian (configs/dc_lidar_gauss_s3.json, glyphs/gaussian.py)
and its cell, `lidar_gauss_s3.device`: the registry's cell, whole runs of
it on the CPU (the port's device path on torch-CPU, K2's plain version),
the control and planted faults outside the limits, and the metric that
reads the port's run-skew counter. The reference against the port by
every route is in tests/test_torch_gauss_lidar_reference.py (tier-1)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cardbench import compare, jobs, program_spans, registry, run
from cardbench.grid import Grid
from cardbench.metrics import gauss_run_skew
from cardbench.points import Points

CELL = "lidar_gauss_s3.device"
CONFIG = json.load(open(f"{registry.HERE}/configs/dc_lidar_gauss_s3.json"))
RED = CONFIG["reductions"][0]
CPU = torch.device("cpu")


def _config(tile=128, count=20_000, size=256):
    """The configuration on a size^2 grid of `tile`-cell tiles: the
    lidar_tiles clusters and the home-tile clip at a CPU's size."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["grid"].update(extent_x=float(size), extent_y=float(size), tile=tile)
    cfg["points"]["count"] = count
    return cfg


def _points(cfg, seed):
    return registry.cloud_generator(cfg["points"]["kind"])(
        cfg["points"], Grid.of(cfg), seed)


def _job(cfg, pts):
    return jobs.job(jobs.Feed(cfg, {"source": "staged"}, pts), jobs.Walls())


def _home_tile_clip_dropped(monkeypatch, cfg, pts):
    """The port on one tile where the reference clips at 128-cell tiles:
    windows that cross a tile's edge add into the next tile."""
    whole = json.loads(json.dumps(cfg))
    whole["grid"]["tile"] = 4096
    return _job(whole, pts)


def _the_last_chunk_lost(monkeypatch, cfg, pts):
    """The layout's entry budget cut small, so that the staged cloud is
    several K2 chunks (as a 20M job is two), and the last one dropped."""
    from pcr_tpu_torch.engine import torch_backend
    monkeypatch.setattr(torch_backend, "WIRE_ENTRY_BUDGET", 1 << 14)
    feed = jobs.Feed(cfg, {"source": "staged"}, pts)
    chunks = feed.inputs[0].per_spec[0]
    assert len(chunks) > 2 and {c.kind for c in chunks} == {"gauss"}
    chunks.pop()
    return jobs.job(feed, jobs.Walls())


def _sigma_a_tenth_wide(monkeypatch, cfg, pts):
    wide = json.loads(json.dumps(cfg))
    wide["reductions"][0].update(sigma_x=3.3, sigma_y=3.3)
    return _job(wide, pts)


def _value_in_bfloat16(monkeypatch, cfg, pts):
    v = torch.from_numpy(pts.value).to(torch.bfloat16).float().numpy()
    return _job(cfg, Points(pts.x, pts.y, v))


@pytest.mark.parametrize("fault", [None, _home_tile_clip_dropped,
                                   _the_last_chunk_lost, _sigma_a_tenth_wide,
                                   _value_in_bfloat16])
def test_the_control_and_planted_faults_are_not_correct(fault, on_cpu,
                                                        monkeypatch):
    """Through the run's own check: the program is correct; the control
    (bfloat16 terms summed in float32) and each planted fault are not."""
    cfg = _config()
    pts = _points(cfg, 2 ** 31 + 3)
    if fault is None:
        ctl = compare.references(cfg, pts, "cpu", control=True)
        bands = tuple(c.numpy() for c in ctl)
        checks, limits, correct = run.check(cfg, pts, [bands], 0, CPU)
        assert correct is False
        assert checks["max_rel_err"] > 10 * limits["max_rel_err"]
        checks, _, correct = run.check(cfg, pts, [_job(cfg, pts)], 0, CPU)
        assert correct is True
        assert checks["max_rel_err"] < 0.1 * limits["max_rel_err"]
        return
    bands = fault(monkeypatch, cfg, pts)
    checks, limits, correct = run.check(cfg, pts, [bands], 0, CPU)
    assert correct is False
    assert (checks["nan_cells_differ"] > 0
            or checks["max_rel_err"] > 10 * limits["max_rel_err"])


def test_the_registry_loads_the_cell(bench):
    """The cell from the repository's benchmark, and from its small copy
    (conftest.small_bench, cut by the repository root's conftest.py)."""
    cell = registry.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["source"] == "staged"
    assert cell.config["reductions"] == [RED]
    assert RED["sigma_x"] == RED["sigma_y"] == 3.0
    assert cell.config["points"] == {"kind": "lidar_tiles",
                                     "count": 20_000_000, "tiles": 49,
                                     "skew": 0.5}
    point = json.load(open(f"{registry.HERE}/configs/dc_lidar_point.json"))
    assert cell.config["grid"] == point["grid"]
    assert cell.config["pipeline"] == point["pipeline"]
    assert {m["name"] for m in cell.end_to_end} == {"mpts_s", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"gauss_run_skew", "splat_roofline", "finalize_ms",
            "device_idle_pct", "peak_dev_gib"} <= per_layer
    assert not {"rot_entries_per_pt", "rect_entries_per_pt",
                "route_ms_per_mpt"} & per_layer
    for other in ("gauss_s4.device", "lidar_point.stream"):
        assert "gauss_run_skew" not in {
            m["name"] for m in registry.load_cell(other).per_layer}
    small = registry.load_cell(CELL, bench)
    assert small.config["points"]["count"] <= 50_000
    assert small.config["grid"]["tile"] < small.config["grid"]["extent_x"]


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
    # the staged chunks' walks, once a job of the window
    feed = jobs.Feed(registry.load_cell(CELL, bench).config,
                     {"source": "staged", "chunk_points": 0}, pts)
    chunks = feed.inputs[0].per_spec[0]
    assert {c.kind for c in chunks} == {"gauss"}
    entries, _, peak_x_runs = (sum(c.walk[k] for c in chunks)
                               for k in range(3))
    assert counters["gauss_entries"] == entries * jobs_done
    assert counters["gauss_peak_x_runs"] == peak_x_runs * jobs_done
    got = line["metrics"]["gauss_run_skew"]["value"]
    assert got == pytest.approx(peak_x_runs / entries)
    assert got > 1.5                          # the clusters' hot tiles
    assert "gauss_run_skew" in err and "K2 entries a job" in err
    assert "finalize_ms" in line["metrics"]   # no roofline off the card
    profiling.reset()


def test_the_reader_on_a_hand_made_snapshot(monkeypatch):
    """Two jobs whose commits folded 60000 K2 entries, each job's chunks
    with a longest run times runs of 1.2M: a skew of 40."""
    from pcr_tpu_torch.utils import profiling
    snap = {"spans": {}, "counters": {"gauss_entries": 60_000,
                                      "gauss_factor_cells": 9,
                                      "gauss_peak_x_runs": 2_400_000}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    r = run.Run(points_per_job=20_000, setup_s=1.0, window_start=0.0,
                job_ends=[1.0, 2.0])
    r.trace = object()
    assert gauss_run_skew.read(r) == 40.0
    snap["counters"] = {"gauss_entries": 60_000}      # a parent's port
    assert gauss_run_skew.read(r) is None
    snap["counters"] = {"rot_entries": 3}             # no K2 chunk
    assert gauss_run_skew.read(r) is None
    snap["counters"] = {"gauss_entries": 10, "gauss_peak_x_runs": 10}
    assert gauss_run_skew.read(r) == 1.0              # even runs
    r.job_ends = []
    assert gauss_run_skew.read(r) is None
    r.trace = None                                    # an untraced run
    assert program_spans.snapshot(r) is None
    assert gauss_run_skew.read(r) is None


@pytest.mark.cuda
def test_the_cell_on_the_card():
    """On the card: a short traced run of the cell through the command,
    correct, with the skew well above 1 and K2's roofline share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "cardbench", "--workload",
                        CELL, "--seed", "7", "--seconds", "2", "--trace",
                        "1"], cwd=registry.REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"gauss_run_skew", "splat_roofline"} <= set(line["metrics"])
    assert np.isfinite(line["metrics"]["gauss_run_skew"]["value"])
    assert line["metrics"]["gauss_run_skew"]["value"] > 5.0

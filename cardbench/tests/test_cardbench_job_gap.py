"""The metrics that read the port's between-job gap and the spans around
it: `job_gap_ms`, `job_gap_max_ms`, `create_ms` (pipeline entry) and
`finalize_pin_ms` (transfer). Their registry entries, each reader on a
hand-made snapshot (None where its row is missing, as from a program that
lacks it, and from an untraced run), and a traced run of every cell on
the CPU at its small size, where the first three print and
`finalize_pin_ms` does not: off a card the finalize's copy lands in
pageable memory and pins nothing."""

from __future__ import annotations

import json
import time

import pytest
import torch

from cardbench import jobs, registry, run
from cardbench.metrics import (create_ms, finalize_pin_ms, job_gap_max_ms,
                               job_gap_ms)

NEW = {"job_gap_ms": "pipeline entry", "job_gap_max_ms": "pipeline entry",
       "create_ms": "pipeline entry", "finalize_pin_ms": "transfer"}
CELLS = [w["name"] for w in json.load(open(registry.BENCHMARK))["workloads"]]


def row(s, n, max_s):
    return {"s": s, "self_s": 0.0, "n": n, "max_s": max_s, "device_s": None}


def test_every_cell_reports_the_metrics():
    bench = json.load(open(registry.BENCHMARK))
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(entries) == set(NEW)
    for name, layer in NEW.items():
        m = entries[name]
        assert m == {"name": name, "unit": "ms", "better": "lower",
                     "source": "program_span", "layer": layer,
                     "moves": "mpts_s"}
    for cell in CELLS:
        assert set(NEW) <= {m["name"]
                            for m in registry.load_cell(cell).per_layer}


def test_the_readers_on_a_hand_made_snapshot(monkeypatch, capsys):
    """Four jobs: three gaps of 1, 1 and 4 ms; four creates of 0.5 ms;
    four pinned checkouts of 0.25 ms, one of which grew the pool by 4 MiB
    (a job's 4 MB band rounded up)."""
    from pcr_tpu_torch.utils import profiling
    snap = {"spans": {"job_gap": row(6e-3, 3, 4e-3),
                      "create": row(2e-3, 4, 0.5e-3),
                      "finalize.pin": row(1e-3, 4, 0.25e-3)},
            "counters": {"d2h_pin_new_bytes": 4 << 20}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    r = run.Run(points_per_job=1000, setup_s=1.0, window_start=0.0,
                job_ends=[1.0, 2.0, 3.0, 4.0])
    r.trace = object()
    assert job_gap_ms.read(r) == pytest.approx(1.5)
    assert job_gap_max_ms.read(r) == pytest.approx(4.0)
    assert create_ms.read(r) == pytest.approx(0.5)
    assert finalize_pin_ms.read(r) == pytest.approx(0.25)
    err = capsys.readouterr().err
    assert "pinned pool growth 1048576 B a job" in err
    assert "longest checkout 0.250000 ms" in err
    # the counter missing (a torch whose pinned pool does not say)
    del snap["counters"]["d2h_pin_new_bytes"]
    assert finalize_pin_ms.read(r) == pytest.approx(0.25)
    assert "pinned pool growth not counted" in capsys.readouterr().err
    # a program without the rows (the parent of these metrics), or a
    # window of one job, which closes no gap
    snap["spans"] = {"finalize.d2h": row(1e-3, 4, 0.3e-3)}
    for reader in (job_gap_ms, job_gap_max_ms, create_ms, finalize_pin_ms):
        assert reader.read(r) is None
    # a program whose table keeps no longest call
    snap["spans"] = {"job_gap": {"s": 6e-3, "self_s": 0.0, "n": 3,
                                 "device_s": None}}
    assert job_gap_max_ms.read(r) is None
    assert job_gap_ms.read(r) == pytest.approx(1.5)
    r.job_ends = []
    assert job_gap_ms.read(r) is None
    r.trace = None                          # an untraced run
    for reader in (job_gap_ms, job_gap_max_ms, create_ms, finalize_pin_ms):
        assert reader.read(r) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_gap_and_create(cell, bench, on_cpu, capsys,
                                               monkeypatch):
    """Each of the window's jobs runs behind an unrecorded twin, so a
    window of n jobs, however short, runs 2n: they close 2n - 1 gaps and
    open 2n creates, and the longest gap lies between the gaps' mean and
    their sum."""
    from pcr_tpu_torch.utils import profiling
    measured = []
    measure, job = run.measure, jobs.job

    def keep(*a, **k):
        out = measure(*a, **k)
        measured.append(out[0])
        return out

    def twice(feed, walls, traced=False):
        if traced:
            job(feed, jobs.Walls(), traced)
        return job(feed, walls, traced)
    monkeypatch.setattr(run, "measure", keep)
    monkeypatch.setattr(jobs, "job", twice)
    profiling.reset()
    rc = run.execute(registry.load_cell(cell, bench), 2 ** 32 + 26, 0.5,
                     True, time.perf_counter(), torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    (r,) = measured
    n = len(r.job_ends)
    snap = profiling.snapshot()
    got = {k: line["metrics"][k]["value"]
           for k in ("job_gap_ms", "job_gap_max_ms", "create_ms")}
    assert "finalize_pin_ms" not in line["metrics"]
    gap = snap["spans"]["job_gap"]
    assert gap["n"] == 2 * n - 1
    assert snap["spans"]["create"]["n"] == 2 * n
    assert got["job_gap_ms"] == pytest.approx(gap["s"] * 1e3 / n)
    assert gap["s"] * 1e3 / gap["n"] <= got["job_gap_max_ms"] * (1 + 1e-9)
    assert got["job_gap_max_ms"] <= gap["s"] * 1e3 * (1 + 1e-9)
    assert got["create_ms"] == pytest.approx(
        snap["spans"]["create"]["s"] * 1e3 / n)
    profiling.reset()

"""rect_staged_per_entry (metrics/rect_staged_per_entry.py), the metric
that reads the port's `rect_staged` counter in `line_hl16.device`: the
registry's entry, the reader on hand-made snapshots (nothing to read
without the counter, as from a program that lacks it, and the ratio with
it), and a traced run of the cell on the CPU at its small size, where the
port lays each Line entry out in the band of the one K3 CTA that stages
it."""

from __future__ import annotations

import json
import time

import pytest
import torch

from cardbench import jobs, program_spans, registry, run
from cardbench.metrics import rect_staged_per_entry

CELL = "line_hl16.device"
CPU = torch.device("cpu")


def test_the_cell_reports_the_metric():
    bench = json.load(open(registry.BENCHMARK))
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "rect_staged_per_entry"]
    assert entry["layer"] == "kernels" and entry["moves"] == "mpts_s"
    assert entry["workloads"] == [CELL]
    names = {m["name"] for m in registry.load_cell(CELL).per_layer}
    assert {"rect_staged_per_entry", "rect_entries_per_pt"} <= names
    assert "rect_staged_per_entry" not in {
        m["name"] for m in registry.load_cell("gauss_s4.device").per_layer}


def test_the_reader_on_a_hand_made_snapshot(monkeypatch):
    """Two jobs whose commits folded 34000 entries from 36864 staged entry
    slots (18 sub-chunks of 2048)."""
    from pcr_tpu_torch.utils import profiling
    snap = {"spans": {}, "counters": {"rect_entries": 34_000,
                                      "rect_hits": 34_500,
                                      "rect_staged": 36_864}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    r = run.Run(points_per_job=1000, setup_s=1.0, window_start=0.0,
                job_ends=[1.0, 2.0])
    r.trace = object()
    assert rect_staged_per_entry.read(r) == 36_864 / 34_000
    # a program without the counter (the K3 counters of its parent)
    snap["counters"] = {"rect_entries": 34_000, "rect_hits": 34_500}
    assert rect_staged_per_entry.read(r) is None
    snap["counters"] = {"rot_entries": 3}     # no Line chunk committed
    assert rect_staged_per_entry.read(r) is None
    snap["counters"] = {"rect_entries": 0, "rect_staged": 0}
    assert rect_staged_per_entry.read(r) is None
    snap["counters"] = {"rect_entries": 34_000, "rect_staged": 36_864}
    r.job_ends = []
    assert rect_staged_per_entry.read(r) is None
    r.trace = None                           # an untraced run
    assert program_spans.snapshot(r) is None
    assert rect_staged_per_entry.read(r) is None


def test_a_traced_run_of_the_cell_reads_about_one(bench, on_cpu, capsys,
                                                  monkeypatch):
    """Each Line entry is staged once, by the band that owns its rows, so
    the slots staged an entry are one plus the padding of each tile run
    to whole sub-chunks (under one sub-chunk a run); a layout by 128-row
    tiles staged each entry once a band of its tile."""
    from pcr_tpu_torch.engine.kernels import BLOCK
    from pcr_tpu_torch.utils import profiling
    measured = []
    measure = run.measure

    def keep(*a, **k):
        out = measure(*a, **k)
        measured.append(out)
        return out
    monkeypatch.setattr(run, "measure", keep)
    profiling.reset()
    cell = registry.load_cell(CELL, bench)
    rc = run.execute(cell, 2 ** 33 + 9, 0.5, True, time.perf_counter(), CPU)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    (r, pts, *_), = measured
    feed = jobs.Feed(cell.config, {"source": "staged", "chunk_points": 0},
                     pts)
    chunks = feed.inputs[0].per_spec[0]
    entries = sum(c.walk[0] for c in chunks)
    staged = sum(c.walk[2] for c in chunks)
    assert staged == sum(c.params.shape[0] for c in chunks) * BLOCK
    runs = sum(len(c.bids.unique()) for c in chunks)
    assert entries <= staged < entries + runs * BLOCK
    got = line["metrics"]["rect_staged_per_entry"]["value"]
    assert got == pytest.approx(staged / entries)
    assert "entry slots staged an entry" in err
    profiling.reset()

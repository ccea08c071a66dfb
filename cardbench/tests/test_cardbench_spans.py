"""The port's own spans and counters in traced runs, on its torch-CPU
device path: each cell reports the per-layer metrics that read them
(`d2h_gbs` excepted: the CPU has no CUDA events), the port counts the
bytes the harness counts at `_Arena.put`, and its `ingest` span the
window's ingest calls."""

from __future__ import annotations

import json
import time

import pytest
import torch

from cardbench import program_spans, registry, run
from cardbench.run import Run

CELLS = [w["name"] for w in json.load(open(registry.BENCHMARK))["workloads"]]
PORT = {"tiles_ms_per_mpt", "ingest_self_ms_per_mpt", "pack_ms_per_mpt",
        "upload_ms_per_mpt", "sync_ms_per_mpt", "syncs_per_call", "d2h_gbs",
        "finalize_wait_ms", "finalize_mask_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_ports_spans(cell, bench, on_cpu, capsys,
                                            monkeypatch):
    from pcr_tpu_torch.utils import profiling
    measured = []
    measure = run.measure

    def keep(*a, **k):
        out = measure(*a, **k)
        measured.append(out[0])
        return out
    monkeypatch.setattr(run, "measure", keep)
    profiling.reset()
    rc = run.execute(registry.load_cell(cell, bench), 2 ** 31 + 91, 0.5,
                     True, time.perf_counter(), torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    (r,) = measured
    snap = profiling.snapshot()

    want = {m["name"] for m in registry.load_cell(cell, bench).per_layer}
    assert want & PORT - {"d2h_gbs"} <= set(line["metrics"])
    assert "d2h_gbs" not in line["metrics"]
    assert snap["counters"].get("h2d_bytes", 0) == r.h2d_bytes
    assert snap["spans"]["ingest"]["n"] == len(r.ingest_walls)
    assert snap["spans"]["finalize"]["n"] == len(r.job_ends)
    if cell == "lidar_point.stream":
        assert r.h2d_bytes > 0
        assert line["metrics"]["syncs_per_call"]["value"] == 1.0
        ingest = program_spans.ms_per_mpt(r, "ingest")
        self_ms = line["metrics"]["ingest_self_ms_per_mpt"]["value"]
        assert 0 <= self_ms <= ingest
    profiling.reset()


def test_without_the_ports_table_nothing_is_read(monkeypatch):
    """An untraced run, or a program without `snapshot`, gives None."""
    from pcr_tpu_torch.utils import profiling
    r = Run(points_per_job=10, setup_s=1.0, window_start=0.0,
            job_ends=[1.0])
    assert program_spans.snapshot(r) is None
    r.trace = object()
    assert program_spans.snapshot(r) is not None
    monkeypatch.delattr(profiling, "snapshot")
    assert program_spans.snapshot(r) is None
    for name in PORT:
        assert registry.metric_reader(name)(r) is None

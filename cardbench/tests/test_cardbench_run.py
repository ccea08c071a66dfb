"""Whole runs: without a card the command prints no result; on the port's
torch-CPU device path a small copy of every cell runs and proves correct;
with the timed path broken underneath, `correct` comes out false."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cardbench import registry, run

CELLS = [w["name"] for w in json.load(open(registry.BENCHMARK))["workloads"]]


def _run(bench, cell, capsys, seconds=0.5, trace=0, seed=2 ** 31 + 77):
    """A run of the small copy of `cell` on the port's torch-CPU path,
    from set-up to the result line (the command's own, past its look for
    a card)."""
    rc = run.execute(registry.load_cell(cell, bench), seed, seconds,
                     bool(trace), time.perf_counter(), torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("cardbench: check ")
    return line


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    env = {k: v for k, v in os.environ.items() if k != "PCR_TORCH_DEVICE"}
    r = subprocess.run([sys.executable, "-m", "cardbench", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=registry.REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


def test_a_port_sent_off_the_card_is_no_run(monkeypatch, capsys):
    """With a card there but PCR_TORCH_DEVICE naming the CPU, the command
    prints no result and exits 2: it never measures torch-CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for dev in ("cpu", "cuda:1"):
        monkeypatch.setenv("PCR_TORCH_DEVICE", dev)
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
        out, err = capsys.readouterr()
        assert rc == 2 and out == ""
        assert f"the port's device is {dev}" in err


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_proves_correct(cell, bench, on_cpu, capsys):
    line = _run(bench, cell, capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in registry.load_cell(cell, bench).end_to_end}
    assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert v["value"] > 0
    assert line["checks"]["nan_cells_differ"]["value"] == 0


@pytest.mark.parametrize("cell", ["lidar_point.stream", "gauss_s4.device"])
def test_a_traced_run_reports_per_layer(cell, bench, on_cpu, capsys):
    line = _run(bench, cell, capsys, trace=1)
    assert line["correct"] is True
    assert {"finalize_ms", "peak_dev_gib", "device_idle_pct",
            "splat_roofline"} & set(line["metrics"]) == {"finalize_ms"}
    if cell == "lidar_point.stream":
        assert "route_ms_per_mpt" in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _state_unchanged(monkeypatch):
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    monkeypatch.setattr(TorchEngine, "commit", lambda self, i, staged: None)


def _half_the_batch(monkeypatch):
    """Half of each host cloud left out, whether it is ingested or staged
    on the card."""
    import pcr_tpu_torch as pcr
    ingest, stage = pcr.Pipeline.ingest, pcr.Pipeline.stage

    def halved(cloud):
        if not isinstance(cloud, pcr.PointCloud):
            return cloud
        h = cloud.count() // 2
        part = pcr.PointCloud.wrap(cloud.x_array()[:h], cloud.y_array()[:h])
        for name in cloud.channel_names():
            part.add_channel(name, pcr.DataType.Float32)
            part.set_channel_array_f32(name,
                                       cloud.channel_array_f32(name)[:h])
        part.set_crs(cloud.crs())
        return part
    monkeypatch.setattr(pcr.Pipeline, "ingest",
                        lambda self, cloud: ingest(self, halved(cloud)))
    monkeypatch.setattr(pcr.Pipeline, "stage",
                        lambda self, cloud: stage(self, halved(cloud)))


def _answer_altered(monkeypatch):
    import pcr_tpu_torch as pcr
    result = pcr.Pipeline.result

    def altered(self):
        grid = result(self)
        band = grid.band_array(0)
        r, c = np.argwhere(~np.isnan(band))[0]
        band[r, c] += 1.0
        return grid
    monkeypatch.setattr(pcr.Pipeline, "result", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, cell, bench, on_cpu,
                                            capsys, monkeypatch):
    """Each fault a cell can have: the state left unchanged, half of each
    ingested or staged cloud left out (the mean taken over the rest), an
    answer altered where the program produces it. (One card: there is no
    exchange between chips to leave out.)"""
    fault(monkeypatch)
    line = _run(bench, cell, capsys)
    assert line["correct"] is False


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """On the card: a short run of one cell through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "cardbench", "--workload",
                        "gauss_s4.device", "--seed", "5", "--seconds", "2",
                        "--trace", "1"], cwd=registry.REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert {"splat_roofline", "device_idle_pct", "finalize_ms",
            "peak_dev_gib"} <= set(line["metrics"])

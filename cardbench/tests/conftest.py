"""Shared fixtures of the harness's CPU tests: a small copy of the
benchmark (the same cells, configurations cut in size) and the port's
device path on torch-CPU (PCR_TORCH_DEVICE=cpu, every kernel its plain
version)."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from cardbench import registry

# torch-CPU: the first multi-threaded float32 exp of a process can read
# up to 1e-4 off every later call; spend it here, before any Gaussian
torch.exp(torch.linspace(-20, 0, 1 << 20))

SMALL = {
    "dc_lidar_point": {"grid": {"extent_x": 512.0, "extent_y": 512.0,
                                "tile": 256},
                       "points": {"count": 200_000}},
    "glyph_gauss_s4": {"grid": {"extent_x": 96.0, "extent_y": 80.0},
                       "points": {"count": 20_000}},
}


def small_bench(root, chunk_points=50_000):
    """A benchmark file under `root` with the repository's cells and
    metrics, its configurations cut by SMALL and its stream traffic in
    chunks of `chunk_points`. Returns the file's path."""
    bench = json.load(open(registry.BENCHMARK))
    os.makedirs(os.path.join(root, "cardbench", "configs"), exist_ok=True)
    shutil.copytree(os.path.join(registry.HERE, "traffic"),
                    os.path.join(root, "cardbench", "traffic"))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(registry.REPO, c["file"])))
        for group, cut in SMALL[c["name"]].items():
            cfg[group].update(cut)
        json.dump(cfg, open(os.path.join(root, c["file"]), "w"))
    path = os.path.join(root, "cardbench", "traffic", "stream.json")
    tr = json.load(open(path))
    tr["chunk_points"] = chunk_points
    json.dump(tr, open(path, "w"))
    out = os.path.join(root, "BENCHMARK.json")
    json.dump(bench, open(out, "w"))
    return out


@pytest.fixture
def bench(tmp_path):
    return small_bench(str(tmp_path))


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")

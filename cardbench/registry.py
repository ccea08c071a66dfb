"""
Where a cell's parts are found: BENCHMARK.json names them, and each part is
a file of its own under cardbench/.

  * a cell is an entry of `workloads`: a configuration and a traffic mix;
  * a configuration is `configs[].file` (grid, pipeline options,
    reductions, points, limits);
  * a traffic mix is `traffic/<name>.json` (how a job feeds its points);
  * a glyph's spec, reference and work count are `glyphs/<glyph>.py`;
  * a point generator is `clouds/<kind>.py`;
  * a metric, end-to-end or per-layer, is `metrics/<name>.py`, whose
    `read(run)` returns a number, or None when it finds nothing to read.

A later cell, configuration or metric is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BENCHMARK = os.path.join(REPO, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file, as loaded
    traffic: dict          # the traffic file, as loaded
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: str = BENCHMARK) -> Cell:
    """The cell `name` of the benchmark file, with its configuration,
    traffic and the metrics it reports. Paths in the benchmark file are
    relative to the directory that holds it."""
    root = os.path.dirname(os.path.abspath(benchmark))
    bench = _load_json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark} "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "cardbench", "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The `read(run)` of metrics/<name>.py."""
    return importlib.import_module(f"cardbench.metrics.{name}").read


def glyph(name: str):
    """The module glyphs/<name>.py: `spec`, `reference`, `work`."""
    return importlib.import_module(f"cardbench.glyphs.{name}")


def cloud_generator(kind: str):
    """The `generate(params, grid, seed)` of clouds/<kind>.py."""
    return importlib.import_module(f"cardbench.clouds.{kind}").generate

"""BENCHMARK.json and the files it names: every part found by its name,
a new cell found without an edit, and the file's own format: its keys,
names, units and bounds."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from cardbench import registry
from cardbench.run import Run

BENCH = json.load(open(registry.BENCHMARK))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell.chips in (1, 4)
        assert cell.traffic["source"] in ("host", "staged")
        for red in cell.config["reductions"]:
            registry.glyph(red["glyph"])
        registry.cloud_generator(cell.config["points"]["kind"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_every_metric_is_a_file_with_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        read = registry.metric_reader(m["name"])
        empty = Run(points_per_job=0, setup_s=1.0, window_start=0.0)
        v = read(empty)
        assert v is None or m["name"] == "setup_s"
    files = {f[:-3] for f in os.listdir(os.path.join(registry.HERE,
                                                     "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert files == {m["name"] for m in BENCH["end_to_end"]
                     + BENCH["per_layer"]}


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    from conftest import small_bench
    path = small_bench(str(tmp_path))
    bench = json.load(open(path))
    traffic = {"source": "host", "chunk_points": 1000, "why": "a test"}
    json.dump(traffic, open(tmp_path / "cardbench" / "traffic"
                            / "tiny.json", "w"))
    bench["workloads"].append({"name": "gauss_s4.tiny",
                               "config": "glyph_gauss_s4",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "finalize_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "pipeline entry",
                               "moves": "mpts_s",
                               "workloads": ["gauss_s4.tiny"]})
    json.dump(bench, open(path, "w"))
    cell = registry.load_cell("gauss_s4.tiny", path)
    assert cell.traffic == traffic
    assert cell.config["points"]["count"] == 20_000
    assert [m["name"] for m in cell.per_layer].count("finalize_ms") == 2
    assert "job_p95_ms" not in {m["name"] for m in cell.end_to_end}
    with pytest.raises(KeyError):
        registry.load_cell("no.such.cell", path)


def test_the_file_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "cardbench"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/")
        assert os.path.exists(os.path.join(registry.REPO, c["file"]))
        for k in c["reduced"]:
            assert NAME.match(k)
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in every:
        assert NAME.match(e["name"])
        assert set(e.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({e["name"] for e in every}) == len(every)


def test_the_harness_imports_no_jax_package():
    """No module of the harness names jax, jaxlib, flax, pcr_tpu or pcr
    in an import (the run checks sys.modules besides)."""
    pat = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|pcr_tpu|pcr)"
                     r"(?:[.\s]|$)", re.M)
    for dirpath, _, files in os.walk(registry.HERE):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert not pat.search(src), f
    importlib.import_module("cardbench.run")


def _config(name):
    return json.load(open(os.path.join(registry.HERE, "configs",
                                       name + ".json")))


@pytest.mark.parametrize("name,glyph", [("dc_lidar_point", "Point"),
                                        ("glyph_gauss_s4", "Gaussian")])
def test_the_pipeline_comes_from_the_configuration_file(name, glyph):
    """Each reduction's spec from its glyph's module, each option of
    `pipeline` onto the PipelineConfig by name."""
    import pcr_tpu_torch as pcr
    from cardbench import jobs
    cfg = _config(name)
    cfg["reductions"].append(dict(cfg["reductions"][0]))
    cfg["pipeline"].update(gpu_memory_budget=1 << 30, exec_mode="Hybrid")
    pc = jobs.pipeline_config(cfg)
    assert pc.exec_mode == pcr.ExecutionMode.Hybrid
    assert pc.gpu_require_strict is True
    assert pc.gpu_memory_budget == 1 << 30
    assert len(pc.reductions) == 2
    for spec, red in zip(pc.reductions, cfg["reductions"]):
        assert spec.glyph.type == getattr(pcr.GlyphType, glyph)
        assert spec.type == getattr(pcr.ReductionType, red["type"])
        assert spec.value_channel == red["value_channel"]
    if glyph == "Gaussian":
        g = pc.reductions[0].glyph
        assert (g.default_sigma_x, g.default_sigma_y) == (4.0, 4.0)
    cfg["pipeline"]["no_such_option"] = 1
    with pytest.raises(ValueError, match="no_such_option"):
        jobs.pipeline_config(cfg)


def test_a_glyph_the_reference_cannot_hold_is_refused():
    """No glyph falls back to another: an unknown glyph has no module, and
    a key or a type its reference does not hold to is refused."""
    import pcr_tpu_torch as pcr
    from cardbench import jobs
    cfg = _config("glyph_gauss_s4")
    rotated = dict(cfg["reductions"][0], rotation=0.5)
    with pytest.raises(ValueError, match="rotation"):
        registry.glyph("gaussian").spec(pcr, rotated)
    point_max = {"glyph": "point", "type": "Max", "value_channel": "z"}
    with pytest.raises(ValueError, match="Max"):
        registry.glyph("point").spec(pcr, point_max)
    cfg["reductions"] = [{"glyph": "line", "type": "Average",
                          "value_channel": "value"}]
    with pytest.raises(ModuleNotFoundError):
        jobs.pipeline_config(cfg)

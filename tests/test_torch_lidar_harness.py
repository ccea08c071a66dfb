"""The port's LiDAR streaming harness (pcr_tpu_torch.scripts.
run_lidar_pipeline) against the JAX package's (scripts/data/
run_lidar_pipeline.py, loaded by path).

  * `synthesize` writes the same LAS bytes from the same seed (3 files x
    20k points, skew 0 and 0.5);
  * `run_mode` streams the files in gpu, hybrid and cpu mode (the device
    path on torch-CPU under PCR_TORCH_DEVICE=cpu): each band within
    atol = rtol = 1e-5 of the JAX harness's cpu band (pcr_tpu's numpy
    oracle) with the exact NaN footprint, hybrid bit for bit gpu's (the
    same chunks), the same stats keys; Point Average and `--glyph gauss`;
  * `main` end to end, with the stats JSON and the CSV.
"""

import csv
import filecmp
import importlib.util
import json
import os

import numpy as np
import pytest

import pcr_tpu as ref
from pcr_tpu_torch.scripts import run_lidar_pipeline as port_harness
from test_torch_pipeline import REPO, like  # noqa: F401

TOL = 1e-5


def load_jax_harness():
    path = os.path.join(REPO, "scripts", "data", "run_lidar_pipeline.py")
    spec = importlib.util.spec_from_file_location("jax_lidar_harness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_harness = load_jax_harness()


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("las")
    port_harness.synthesize(str(d), 3, pts_per_file=20_000, extent=600.0,
                            skew=0.5)
    return str(d)


def near(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (TOL + TOL * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


@pytest.mark.parametrize("skew", [0.0, 0.5])
def test_synthesize_writes_the_jax_harness_bytes(tmp_path, skew):
    a, b = tmp_path / "port", tmp_path / "jax"
    port_harness.synthesize(str(a), 3, pts_per_file=20_000, extent=600.0,
                            skew=skew)
    jax_harness.synthesize(str(b), 3, pts_per_file=20_000, extent=600.0,
                           skew=skew)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 3
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.mark.parametrize("glyph", ["point", "gauss"])
def test_run_mode_bands_are_the_jax_harness_band(tiles, tmp_path, glyph):
    files = port_harness.input_files(tiles)
    assert len(files) == 3
    bbox, total = port_harness.scan_bounds(files)
    jbbox, jtotal = jax_harness.scan_bounds(files)
    assert total == jtotal and (bbox.min_x, bbox.max_y) == (
        jbbox.min_x, jbbox.max_y)
    gc = port_harness.make_grid(bbox, 1.0)
    jgc = ref.GridConfig()
    jgc.bounds = jbbox
    jgc.cell_size_x, jgc.cell_size_y = 1.0, -1.0
    jgc.crs = ref.CRS.from_epsg(32110)
    jgc.compute_dimensions()
    spec = port_harness.make_spec(glyph, "z", "Average", 3.0)
    jspec = (ref.gaussian_splat_spec("z", default_sigma=3.0)
             if glyph == "gauss" else ref.ReductionSpec(
                 value_channel="z", type=ref.ReductionType.Average))
    jstats, want = jax_harness.run_mode("cpu", files, jgc, jspec, 25_000,
                                        str(tmp_path / "jax.tif"))
    bands = {}
    for mode in ("gpu", "hybrid", "cpu"):
        stats, bands[mode] = port_harness.run_mode(
            mode, files, gc, spec, 25_000, str(tmp_path / f"{mode}.tif"))
        assert set(stats) == set(jstats)
        assert stats["points"] == jstats["points"] == total
        near(bands[mode], want)
    assert np.array_equal(bands["hybrid"].view(np.int32),
                          bands["gpu"].view(np.int32))


def test_main_writes_the_stats(tmp_path):
    stats_json, table = tmp_path / "stats.json", tmp_path / "modes.csv"
    rc = port_harness.main([
        "--input", str(tmp_path / "las"), "--synthesize", "2",
        "--pts-per-file", "5000", "--extent", "300", "--modes", "gpu", "cpu",
        "--out", str(tmp_path / "out.tif"), "--stats-json", str(stats_json),
        "--csv", str(table)])
    assert rc == 0
    with open(stats_json) as f:
        stats = json.load(f)
    assert stats["files"] == 2 and [r["mode"] for r in stats["modes"]] == [
        "gpu", "cpu"]
    assert all(r["points"] == 10_000 for r in stats["modes"])
    with open(table) as f:
        rows = list(csv.DictReader(f))
    assert [r["mode"] for r in rows] == ["gpu", "cpu"]
    assert port_harness.main(["--input", str(tmp_path / "none")]) == 2

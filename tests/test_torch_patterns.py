"""The port's glyph pattern pair (pcr_tpu_torch.scripts.
generate_glyph_patterns + compare_patterns) on torch-CPU.

Two scenes (03, anisotropic rotated Gaussians, and 08, the bullseye
through Point, Line and Gaussian) render at size_scale 0.5 in gpu mode
(the device path under PCR_TORCH_DEVICE=cpu) and in cpu mode (the numpy
oracle) into one directory, and the port's comparator passes every
raster. The port's comparator and the JAX package's
(scripts/patterns/compare_cpu_tpu_patterns.py, loaded by path) give the
same verdict and message on every pair of one directory, including pairs
made to fail (a cell off by 1e-3, a NaN moved) and a pair within the
cutoff fringe's allowance.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

import pcr_tpu_torch as port
from pcr_tpu_torch.scripts import compare_patterns, generate_glyph_patterns
from test_torch_pipeline import REPO, like  # noqa: F401


def load_jax_comparator():
    path = os.path.join(REPO, "scripts", "patterns",
                        "compare_cpu_tpu_patterns.py")
    spec = importlib.util.spec_from_file_location("jax_compare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def patterns(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("patterns"))
    mp = pytest.MonkeyPatch()
    mp.setenv("PCR_TORCH_DEVICE", "cpu")
    try:
        for mode in ("gpu", "cpu"):
            generate_glyph_patterns.main(["--out", out, "--mode", mode,
                                          "--scenes", "3", "8",
                                          "--size-scale", "0.5"])
    finally:
        mp.undo()
    return out


def test_two_scenes_pass_the_comparator(patterns, capsys):
    results, missing = compare_patterns.compare_dir(patterns)
    assert not missing
    assert len(results) == 9
    assert {n.split("_")[0] for n in results} == {"03", "08"}
    assert all(ok for ok, _ in results.values()), results
    band = port.read_geotiff_band(
        os.path.join(patterns, "08_showcase_gauss_gpu.tif"), 0)
    assert band.shape == (100, 100) and np.isfinite(band).mean() > 0.1
    assert compare_patterns.main(["--dir", patterns]) == 0
    assert capsys.readouterr().out.count("PASS") == 9


def write_tif(path, band):
    gc = port.GridConfig()
    gc.bounds = port.BBox()
    gc.bounds.min_x = gc.bounds.min_y = 0.0
    gc.bounds.max_x, gc.bounds.max_y = float(band.shape[1]), float(
        band.shape[0])
    gc.crs = port.CRS.from_epsg(3857)
    gc.compute_dimensions()
    grid = port.Grid.create(band.shape[1], band.shape[0],
                            [port.BandDesc("b", port.DataType.Float32)])
    grid.set_band_array(0, band)
    assert port.write_geotiff(path, grid, gc).ok()


def test_both_comparators_give_the_same_verdicts(patterns, tmp_path):
    jax_compare = load_jax_comparator()
    d = str(tmp_path)
    base = port.read_geotiff_band(
        os.path.join(patterns, "08_showcase_gauss_cpu.tif"), 0)
    live = np.flatnonzero(np.isfinite(base))
    fringe = compare_patterns._nan_fringe(base)
    interior = np.flatnonzero(np.isfinite(base) & ~fringe)
    edge = np.flatnonzero(np.isfinite(base) & fringe)
    cases = {"same": base.copy()}
    cases["off"] = base.copy()
    cases["off"].flat[interior[len(interior) // 2]] += 1e-3
    cases["nan"] = base.copy()
    cases["nan"].flat[live[0]] = np.nan
    cases["fringe"] = base.copy()
    cases["fringe"].flat[edge[0]] += 5e-5
    for name in ("03_aniso_r30", "08_showcase_line"):
        for side in ("cpu", "gpu"):
            shutil.copy(os.path.join(patterns, f"{name}_{side}.tif"), d)
    for name, band in cases.items():
        write_tif(os.path.join(d, f"{name}_cpu.tif"), base)
        write_tif(os.path.join(d, f"{name}_gpu.tif"), band)
    results, _ = compare_patterns.compare_dir(d)
    assert len(results) == 6
    verdicts = {n: ok for n, (ok, _) in results.items()}
    assert verdicts == {"same": True, "off": False, "nan": False,
                        "fringe": True, "03_aniso_r30": True,
                        "08_showcase_line": True}
    for name, got in results.items():
        want = jax_compare.compare(os.path.join(d, f"{name}_cpu.tif"),
                                   os.path.join(d, f"{name}_gpu.tif"))
        assert got == want, name
    assert compare_patterns.main(["--dir", d]) == 1
    assert compare_patterns.main(["--dir", str(tmp_path / "empty")]) == 2

"""The Line slice of the PyTorch port (pcr_tpu_torch) against pcr_tpu.

The same seeded clouds go through the port's device path on torch-CPU
(PCR_TORCH_DEVICE=cpu, where K3 runs its plain version), pcr_tpu's device
path (PCR_FORCE_JAX on the JAX CPU backend; its rect Pallas kernel in
interpret mode, or its scatter walk under PCR_PALLAS=0) and pcr_tpu's
numpy CPU oracle. Bands agree at atol = rtol = 1e-5 (the engines add the
same float32 terms in different orders) with an exact empty-cell NaN
footprint.

Count is held against the oracle and against pcr_tpu's walk
(PCR_PALLAS=0) only: pcr_tpu's rect path adds the value per cell where the
oracle adds 1, and the port follows the oracle.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_torch_pipeline import NO_JAX_QUICKSTART, REPO

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
TOL = 1e-5
GLYPHS = {
    "dir0_hl4": dict(default_half_length=4.0),
    "dir07_hl5": dict(default_direction=0.7, default_half_length=5.0),
    "per_point": dict(direction_channel="dir", half_length_channel="hl"),
}


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    monkeypatch.setenv("PCR_FORCE_JAX", "1")


def grid():
    """200 x 150 cells in 64-cell tiles; `cloud` leaves the right-most
    tile column untouched, so per-tile finalize semantics show."""
    return make_grid_config(w=200.0, h=150.0, tile=64)


def cloud(n=3000, seed=0, x_hi=140.0):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(-5, x_hi, n))     # includes off-grid points
    c.set_y_array(rng.uniform(-5, 155, n))
    for name, arr in (("v", rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3,
                                                                       n)),
                      ("dir", rng.uniform(-np.pi, np.pi, n)),
                      ("hl", rng.uniform(0.5, 9.0, n))):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def spec(glyph, rtype, **kw):
    s = ref.line_splat_spec("v", max_radius_cells=8.0, **GLYPHS[glyph], **kw)
    s.type = rtype
    return s


def run(pkg, mode, specs, clouds, staged=False, **cfg):
    p = pkg.Pipeline.create(pkg.PipelineConfig(
        grid=cfg.pop("gc", None) or grid(),
        reductions=copy.deepcopy(specs), exec_mode=mode, **cfg))
    for c in clouds:
        p.ingest(p.stage(c) if staged else c)
    p.finalize()
    return p, [p.result().band_array(i).copy() for i in range(len(specs))]


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (TOL + TOL * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


def port_chunk(specs, c):
    p = port.Pipeline.create(port.PipelineConfig(
        grid=grid(), reductions=copy.deepcopy(specs), exec_mode=GPU))
    assert isinstance(p._engine, TorchEngine)
    (chunk,) = p.stage(c).per_spec[0]
    return chunk


@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average, RT.WeightedAverage],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_slice_matches_jax_and_oracle(glyph, rtype, staged):
    specs = [spec(glyph, rtype)]
    clouds = [cloud(seed=1), cloud(seed=2)]
    assert port_chunk(specs, clouds[0]).kind == "rect"
    _, got = run(port, GPU, specs, clouds, staged)
    _, jax_bands = run(ref, GPU, specs, clouds, staged)
    _, oracle = run(ref, CPU, specs, clouds)
    assert_close(got[0], oracle[0])
    assert_close(got[0], jax_bands[0])
    assert np.isnan(got[0][:, 192:]).all()      # the untouched tile column


@pytest.mark.parametrize("value_channel", [True, False],
                         ids=["values", "no_value_channel"])
@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_count_matches_oracle_and_jax_walk(glyph, staged, value_channel,
                                           monkeypatch):
    specs = [spec(glyph, RT.Count)]
    if not value_channel:
        specs[0].value_channel = "absent"
    clouds = [cloud(seed=3), cloud(seed=4)]
    _, got = run(port, GPU, specs, clouds, staged)
    _, oracle = run(ref, CPU, specs, clouds)
    monkeypatch.setenv("PCR_PALLAS", "0")
    _, walk = run(ref, GPU, specs, clouds, staged)
    assert_close(got[0], oracle[0])
    assert_close(got[0], walk[0])
    assert np.nanmax(got[0]) > 1 and np.isnan(got[0][:, 192:]).all()


def test_jax_rect_path_adds_values_for_count():
    """The fault the port does not inherit: pcr_tpu's rect path stages
    f0 = value for Count (tpu_backend.py:2053)."""
    specs = [spec("dir07_hl5", RT.Count)]
    clouds = [cloud(seed=3)]
    _, got = run(port, GPU, specs, clouds)
    _, jax_rect = run(ref, GPU, specs, clouds)
    _, oracle = run(ref, CPU, specs, clouds)
    assert_close(got[0], oracle[0])
    assert not np.array_equal(np.isnan(jax_rect[0]), np.isnan(oracle[0]))


@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_reruns_are_bit_identical(glyph):
    specs = [spec(glyph, RT.Average), spec(glyph, RT.Count),
             spec(glyph, RT.Sum)]
    a = run(port, GPU, specs, [cloud(seed=5)])[1]
    b = run(port, GPU, specs, [cloud(seed=5)])[1]
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


@pytest.mark.parametrize("rtype", [RT.WeightedAverage, RT.Sum],
                         ids=lambda t: t.name)
def test_carried_state_continues_like_jax(rtype):
    """pcr_tpu's device state (fetch_state, as numpy) loaded into the port
    (load_state) accumulates on as pcr_tpu does."""
    specs = [spec("dir07_hl5", rtype)]
    c2 = cloud(seed=7, x_hi=205.0)
    j = ref.Pipeline.create(ref.PipelineConfig(grid=grid(), reductions=specs,
                                               exec_mode=GPU))
    j.ingest(cloud(seed=6))
    fields = [np.asarray(f).copy() for f in j._engine.fetch_state(0)]
    assert fields[0].any()
    t = port.Pipeline.create(port.PipelineConfig(
        grid=grid(), reductions=copy.deepcopy(specs), exec_mode=GPU))
    t._engine.load_state(0, fields)
    for a, b in zip(t._engine.fetch_state(0), fields):
        assert np.array_equal(a, b)
    for p in (j, t):
        p.ingest(c2)
        p.finalize()
    assert_close(t.result().band_array(0), j.result().band_array(0))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_resume_across_packages(direction, tmp_path):
    first, second = (ref, port) if direction == "jax_to_torch" else (port,
                                                                     ref)
    specs = [spec("per_point", RT.Average), spec("dir0_hl4", RT.Sum)]
    c1, c2 = cloud(seed=8), cloud(seed=9, x_hi=205.0)
    state_dir = str(tmp_path / "state")
    a, _ = run(first, GPU, specs, [c1], state_dir=state_dir,
               output_path=str(tmp_path / "a.tif"))
    b = second.Pipeline.create(second.PipelineConfig(
        grid=grid(), reductions=copy.deepcopy(specs), exec_mode=GPU,
        state_dir=state_dir))
    for i in range(len(specs)):
        for fa, fb in zip(a._engine.fetch_state(i), b._engine.fetch_state(i)):
            assert np.array_equal(np.asarray(fa), np.asarray(fb))
    b.ingest(c2)
    b.finalize()
    _, oracle = run(ref, CPU, specs, [c1, c2])
    for i in range(len(specs)):
        assert_close(b.result().band_array(i), oracle[i])


def test_line_quickstart_never_imports_jax():
    script = NO_JAX_QUICKSTART.replace(
        "specs = [pcr.ReductionSpec(value_channel=\"value\", type=t)\n"
        "         for t in (pcr.ReductionType.Average, "
        "pcr.ReductionType.Max)]",
        "specs = [pcr.line_splat_spec(\"value\", default_direction=0.7,\n"
        "                             default_half_length=6.0),\n"
        "         pcr.line_splat_spec(\"value\", default_half_length=3.0)]\n"
        "specs[1].type = pcr.ReductionType.Count")
    script = script.replace(
        "assert np.array_equal(g[1], c[1], equal_nan=True)",
        "assert np.allclose(g[1], c[1], rtol=1e-5, atol=1e-5, "
        "equal_nan=True)")
    assert "line_splat_spec" in script and "np.array_equal(g[1]" \
        not in script
    env = dict(os.environ, PCR_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")

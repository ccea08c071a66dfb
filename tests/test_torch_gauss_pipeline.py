"""The Gaussian slice of the PyTorch port (pcr_tpu_torch) against pcr_tpu.

The same seeded clouds go through three pipelines: the port's device path
on torch-CPU (PCR_TORCH_DEVICE=cpu, where K2, K4 and K5 run their plain
versions), pcr_tpu's device path (PCR_FORCE_JAX on the JAX CPU backend, its
Pallas kernels in interpret mode) and pcr_tpu's numpy CPU oracle. Bands
agree at atol = rtol = 1e-5 (the engines add the same float32 terms in
different orders, and evaluate the rotated form in another algebra than the
oracle) with an exact empty-cell NaN footprint.

Cases, by the route the JAX package's routing picks: sigma 1 (K2 with the
product cutoff), sigma 4 (K2), a per-point sigma channel (K2), rotated
4 x 1.5 (r = 12: K5) and rotated 8 x 3 (r = 24: K4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_torch_pipeline import NO_JAX_QUICKSTART, REPO, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
TOL = 1e-5
GLYPHS = {
    "s1": (dict(default_sigma=1.0), "gauss"),
    "s4": (dict(default_sigma=4.0), "gauss"),
    "sigch": (dict(sigma_x_channel="sig", sigma_y_channel="sig"), "gauss"),
    "rot4": (dict(default_sigma_x=4.0, default_sigma_y=1.5,
                  default_rotation=0.6), "rotp"),
    "rot8": (dict(default_sigma_x=8.0, default_sigma_y=3.0,
                  default_rotation=0.6), "rot"),
}
SUM_FAMILY = [RT.Sum, RT.Count, RT.Average, RT.WeightedAverage]


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    monkeypatch.setenv("PCR_FORCE_JAX", "1")


def grid():
    """120 x 100 cells in 64-cell tiles; `cloud` leaves the right-most
    tile column untouched, so per-tile finalize semantics show."""
    return make_grid_config(w=120.0, h=100.0, tile=64)


def cloud(n=800, seed=0, x_hi=60.0):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(-3, x_hi, n))
    c.set_y_array(rng.uniform(-3, 103, n))
    for name, arr in (("v", rng.uniform(0, 10, n)),
                      ("sig", rng.uniform(3.0, 6.0, n))):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def spec(glyph, rtype):
    s = ref.gaussian_splat_spec("v", **GLYPHS[glyph][0])
    s.type = rtype
    return s


def run(pkg, mode, specs, clouds, staged=False, **cfg):
    p = pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, cfg.pop("gc", None) or grid()),
        reductions=like(pkg, specs), exec_mode=like(pkg, mode), **cfg))
    for c in like(pkg, clouds):
        p.ingest(p.stage(c) if staged else c)
    p.finalize()
    return p, [p.result().band_array(i).copy() for i in range(len(specs))]


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    excess = np.abs(got[m] - want[m]) - (TOL + TOL * np.abs(want[m]))
    assert float(excess.max(initial=0.0)) <= 0


@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
@pytest.mark.parametrize("rtype", SUM_FAMILY, ids=lambda t: t.name)
@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_slice_matches_jax_and_oracle(glyph, rtype, staged):
    specs = [spec(glyph, rtype)]
    clouds = [cloud(seed=1), cloud(seed=2)]
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, grid()), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU))
    assert isinstance(p._engine, TorchEngine)
    (chunk,) = p.stage(like(port, clouds[0])).per_spec[0]
    assert chunk.kind == GLYPHS[glyph][1]
    _, got = run(port, GPU, specs, clouds, staged)
    _, jax_bands = run(ref, GPU, specs, clouds, staged)
    _, oracle = run(ref, CPU, specs, clouds)
    assert_close(got[0], oracle[0])
    assert_close(got[0], jax_bands[0])
    assert np.isnan(got[0][:, 64:]).all()       # the untouched tile column


@pytest.mark.parametrize("glyph", list(GLYPHS))
def test_reruns_are_bit_identical(glyph):
    specs = [spec(glyph, RT.Average), spec(glyph, RT.Count)]
    a = run(port, GPU, specs, [cloud(seed=3)])[1]
    b = run(port, GPU, specs, [cloud(seed=3)])[1]
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


@pytest.mark.parametrize("glyph", ["s1", "rot4", "rot8"])
def test_carried_state_continues_like_jax(glyph):
    """pcr_tpu's device state (fetch_state, as numpy) loaded into the port
    (load_state) accumulates on as pcr_tpu does."""
    specs = [spec(glyph, RT.WeightedAverage)]
    c2 = cloud(seed=5, x_hi=123.0)
    j = ref.Pipeline.create(ref.PipelineConfig(grid=grid(), reductions=specs,
                                               exec_mode=GPU))
    j.ingest(cloud(seed=4))
    fields = [np.asarray(f).copy() for f in j._engine.fetch_state(0)]
    assert fields[1].any()
    t = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, grid()), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU))
    t._engine.load_state(0, fields)
    for a, b in zip(t._engine.fetch_state(0), fields):
        assert np.array_equal(a, b)
    for pkg, p in ((ref, j), (port, t)):
        p.ingest(like(pkg, c2))
        p.finalize()
    assert_close(t.result().band_array(0), j.result().band_array(0))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("glyph", ["s4", "rot4"])
def test_resume_across_packages(glyph, direction, tmp_path):
    first, second = (ref, port) if direction == "jax_to_torch" else (port,
                                                                     ref)
    specs = [spec(glyph, RT.Average), spec(glyph, RT.Sum)]
    c1, c2 = cloud(seed=6), cloud(seed=7, x_hi=123.0)
    state_dir = str(tmp_path / "state")
    a, _ = run(first, GPU, specs, [c1], state_dir=state_dir)
    b = second.Pipeline.create(second.PipelineConfig(
        grid=like(second, grid()), reductions=like(second, specs),
        exec_mode=like(second, GPU), state_dir=state_dir))
    for i in range(len(specs)):
        for fa, fb in zip(a._engine.fetch_state(i), b._engine.fetch_state(i)):
            assert np.array_equal(np.asarray(fa), np.asarray(fb))
    b.ingest(like(second, c2))
    b.finalize()
    _, oracle = run(ref, CPU, specs, [c1, c2])
    for i in range(len(specs)):
        assert_close(b.result().band_array(i), oracle[i])


def test_checkpoint_holds_the_flushed_state(tmp_path):
    """A weight residue below GAUSS_WMIN never reaches the PCRT files or
    the band: the port's state exits are flushed as pcr_tpu's are."""
    specs = [spec("s4", RT.Average)]
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, grid()), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, state_dir=str(tmp_path / "state")))
    p.ingest(like(port, cloud(seed=8)))
    eng = p._engine
    s0, s1 = eng._states[0]
    s0[5, 100], s1[5, 100] = 3e-7, 1e-7        # an untouched-tile residue
    s0[90, 10], s1[90, 10] = 5.0, 2e-7
    fetched = eng.fetch_state(0)
    assert fetched[0][5, 100] == 0 and fetched[1][90, 10] == 0
    assert s1[90, 10] > 0                      # the state itself is kept
    p.finalize()
    q = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, grid()), reductions=like(port, specs),
        exec_mode=port.ExecutionMode.GPU, state_dir=str(tmp_path / "state")))
    for a, b in zip(q._engine.fetch_state(0), fetched):
        assert np.array_equal(a, b)
    assert np.isnan(p.result().band_array(0)[90, 10])


def test_gaussian_quickstart_never_imports_jax():
    script = NO_JAX_QUICKSTART.replace(
        "specs = [pcr.ReductionSpec(value_channel=\"value\", type=t)\n"
        "         for t in (pcr.ReductionType.Average, "
        "pcr.ReductionType.Max)]",
        "specs = [pcr.gaussian_splat_spec(\"value\", default_sigma=2.5),\n"
        "         pcr.gaussian_splat_spec(\"value\", default_sigma_x=4.0,\n"
        "                                 default_sigma_y=1.5,\n"
        "                                 default_rotation=0.6)]\n"
        "specs[1].type = pcr.ReductionType.Sum")
    script = script.replace(
        "assert np.array_equal(g[1], c[1], equal_nan=True)",
        "assert np.allclose(g[1], c[1], rtol=1e-5, atol=1e-5, "
        "equal_nan=True)")
    assert "gaussian_splat_spec" in script and "np.array_equal(g[1]" \
        not in script
    env = dict(os.environ, PCR_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")

"""The Point slice of the PyTorch port (pcr_tpu_torch) against pcr_tpu.

The same seeded clouds go through three pipelines: pcr_tpu's device path
(GPU mode on the JAX CPU backend under PCR_FORCE_JAX, its Pallas kernels in
interpret mode), pcr_tpu's numpy CPU oracle, and the port's device path on
torch-CPU (PCR_TORCH_DEVICE=cpu, where kernel K1 runs its plain version).
Sum-family bands agree at atol = rtol = 1e-5 (the engines add the same
float32 values in different orders) with an exact NaN footprint; Max, Min,
MostRecent, PriorityMerge and Median are exact.

Each package is handed inputs of its own types: the helpers build them from
pcr_tpu's, and `like` rebuilds them from the port's classes.
"""

import dataclasses
import enum
import importlib
import os
import subprocess
import sys
import tempfile
import textwrap
import warnings

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.engine import pipeline as port_pipeline
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_determinism import SPECS as DETERMINISM_SPECS
from test_determinism import big_cloud

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
TOL = 1e-5
SUM_FAMILY = (RT.Sum, RT.Average, RT.Count, RT.WeightedAverage)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch 2.13 on the CPU: the first multi-threaded float32 `torch.exp` of a
# process returns, in about one process of eight, values up to 1e-4
# (relative) away from what every later call returns for the same input
# (pure torch: `torch.exp(-0.5 * q * q)` on 167,750 values, twice, in a
# fresh process). The Gaussian kernels' plain versions call it, so a first
# Gaussian commit could miss a bit comparison, or the 1e-5 bar. Every test
# module of the port that runs a Gaussian on the CPU imports `like` from
# this one: the first call is spent here, whichever module runs alone.
torch.exp(torch.linspace(-20.0, 0.0, 1 << 20))


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PCR_PALLAS", "interpret")


def like(pkg, obj):
    """`obj`, built from pcr_tpu's types, rebuilt from `pkg`'s own classes
    (the class of the same name in the same module path under `pkg`):
    enums, dataclasses (GridConfig, ReductionSpec, GlyphSpec, FilterSpec,
    routing's parameter records, ...), point clouds, and lists of them."""
    if pkg is ref or obj is None:
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(like(pkg, o) for o in obj)
    mod = type(obj).__module__
    if not mod.startswith("pcr_tpu."):
        return obj
    cls = getattr(importlib.import_module(pkg.__name__ + mod[len("pcr_tpu"):]),
                  type(obj).__name__)
    if isinstance(obj, enum.Enum):
        return cls(obj.value)
    if isinstance(obj, ref.PointCloud):
        c = cls.create(obj.count())
        c.set_x_array(obj.x_array())
        c.set_y_array(obj.y_array())
        for name in obj.channel_names():
            c.add_channel(name, like(pkg, obj.channel(name).dtype))
            c.set_channel_array(name, obj.channel_array(name))
        c.set_crs(like(pkg, obj.crs()))
        return c.to(like(pkg, obj.location()))
    return cls(**{f.name: like(pkg, getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


def grid():
    """200 x 150 cells in 64-cell tiles; `cloud` leaves the right-most
    tile column untouched, so per-tile finalize semantics show."""
    return make_grid_config(w=200.0, h=150.0, tile=64)


def cloud(n=3000, seed=0, x_hi=140.0):
    rng = np.random.default_rng(seed)
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(-5, x_hi, n))     # includes off-grid points
    c.set_y_array(rng.uniform(-5, 155, n))
    chans = {
        "v": rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n),
        "w": rng.uniform(0.1, 2.0, n),
        "ts": rng.integers(0, 8, n),             # ties within and across
        "prio": rng.integers(0, 4, n),           # batches
    }
    for name, arr in chans.items():
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def spec(rtype):
    s = ref.ReductionSpec(value_channel="v", type=rtype)
    if rtype == RT.WeightedAverage:
        s.weight_channel = "w"
    elif rtype == RT.MostRecent:
        s.timestamp_channel = "ts"
    elif rtype == RT.PriorityMerge:
        s.priority_channel = "prio"
    return s


def make(pkg, mode, specs, **cfg):
    return pkg.Pipeline.create(pkg.PipelineConfig(
        grid=like(pkg, cfg.pop("gc", None) or grid()),
        reductions=like(pkg, specs), exec_mode=like(pkg, mode), **cfg))


def run(pkg, mode, specs, clouds, staged=False, **cfg):
    p = make(pkg, mode, specs, **cfg)
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


def assert_bands(got, want, specs):
    for g, w, s in zip(got, want, specs):
        if s.type in SUM_FAMILY:
            assert_close(g, w)
        else:
            assert np.array_equal(g, w, equal_nan=True)


def is_port_engine(p):
    return isinstance(p._engine, TorchEngine) and p._engine.device.type == "cpu"


@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
@pytest.mark.parametrize("rtype", [
    RT.Sum, RT.Average, RT.Count, RT.WeightedAverage, RT.Max, RT.Min,
    RT.MostRecent, RT.PriorityMerge, RT.Median], ids=lambda t: t.name)
def test_slice_matches_jax_and_oracle(rtype, staged):
    specs = [spec(rtype)]
    clouds = [cloud(seed=1), cloud(seed=2)]
    p, got = run(port, GPU, specs, clouds, staged)
    assert is_port_engine(p)
    _, jax_bands = run(ref, GPU, specs, clouds, staged)
    _, oracle = run(ref, CPU, specs, clouds)
    assert_bands(got, oracle, specs)
    assert_bands(got, jax_bands, specs)
    assert np.isnan(got[0][:, 192:]).all()      # the untouched tile column


@pytest.mark.parametrize("path", ["packed", "streamed"],
                         ids=["ref_packed", "ref_streamed"])
def test_finalize_writes_checkpoint_and_geotiff(path, monkeypatch, tmp_path):
    """The port's one finalize with a state_dir and an output file against
    pcr_tpu's packed or streamed finalize: the same bands, files and PCRT
    tiles."""
    if path == "streamed":
        monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")   # pcr_tpu's strips
    specs = [spec(RT.Average), spec(RT.Max), spec(RT.MostRecent)]
    clouds = [cloud(seed=3)]
    outs = {}
    for name, pkg in (("port", port), ("jax", ref)):
        d = tmp_path / name
        d.mkdir()
        p, bands = run(pkg, GPU, specs, clouds, state_dir=str(d / "state"),
                       output_path=str(d / "out.tif"))
        for i, band in enumerate(bands):
            assert np.array_equal(
                ref.read_geotiff_band(str(d / "out.tif"), i), band,
                equal_nan=True)
        outs[name] = (p, bands, sorted(
            os.path.relpath(os.path.join(r, f), d / "state")
            for r, _, fs in os.walk(d / "state") for f in fs))
    assert is_port_engine(outs["port"][0])
    assert_bands(outs["port"][1], outs["jax"][1], specs)
    assert outs["port"][2] == outs["jax"][2]    # the same PCRT tile files


@pytest.mark.parametrize("first,second", [(ref, port), (port, ref)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_resume_across_packages(first, second, tmp_path):
    specs = [spec(RT.Average), spec(RT.Max), spec(RT.MostRecent)]
    c1, c2 = cloud(seed=4), cloud(seed=5, x_hi=205.0)
    state_dir = str(tmp_path / "state")
    a, _ = run(first, GPU, specs, [c1], state_dir=state_dir)
    b = make(second, GPU, specs, state_dir=state_dir)
    for i in range(len(specs)):
        for fa, fb in zip(a._engine.fetch_state(i), b._engine.fetch_state(i)):
            assert np.array_equal(np.asarray(fa), np.asarray(fb),
                                  equal_nan=True)
    b.ingest(like(second, c2))
    b.finalize()
    _, oracle = run(ref, CPU, specs, [c1, c2])
    assert_bands([b.result().band_array(i) for i in range(len(specs))],
                 oracle, specs)


def tree(root):
    return {str(f): f.read_bytes() for f in root.rglob("*") if f.is_file()}


@pytest.mark.parametrize("mode", ["device", "cpu", "cpu_tiled"])
def test_no_state_dir_resumes_nothing(mode, monkeypatch, tmp_path):
    """Without a state_dir a pipeline starts empty: PCRT tiles an earlier
    run left under the temp root neither enter its band nor change, and
    CPU out-of-core tiles spill into a private directory that goes with
    the pipeline."""
    import gc

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    specs = [spec(RT.Average), spec(RT.Max)]
    exec_mode = GPU if mode == "device" else CPU
    cfg = {"host_cache_budget": 64 * 64 * 4} if mode == "cpu_tiled" else {}
    planted = tmp_path / "pcr_tiles"
    run(port, exec_mode, specs, [cloud(seed=6)], state_dir=str(planted),
        **cfg)
    before = tree(planted)
    assert before
    c2 = cloud(seed=7)
    p, got = run(port, exec_mode, specs, [c2], **cfg)
    _, oracle = run(ref, CPU, specs, [c2], state_dir=str(tmp_path / "ref"))
    assert_bands(got, oracle, specs)
    assert tree(planted) == before
    assert p._tiled == (mode == "cpu_tiled")
    if p._tiled:
        spill = p._spill_root
        assert os.path.dirname(spill) == str(tmp_path) and os.listdir(spill)
        del p
        gc.collect()
        assert not os.path.exists(spill)


@pytest.mark.parametrize("rtype", [RT.Average, RT.WeightedAverage, RT.Max,
                                   RT.MostRecent], ids=lambda t: t.name)
def test_carried_state_continues_like_jax(rtype):
    """pcr_tpu's device state (fetch_state, as numpy) loaded into the port
    (load_state) accumulates on exactly as pcr_tpu does."""
    specs = [spec(rtype)]
    c2 = cloud(seed=7, x_hi=205.0)              # touches every tile
    j = make(ref, GPU, specs)
    j.ingest(cloud(seed=6))
    fields = [np.asarray(f).copy() for f in j._engine.fetch_state(0)]
    identity = ref.get_reduction_info(rtype).identity[0]
    assert not np.array_equal(fields[0], np.full_like(fields[0], identity),
                              equal_nan=True)
    t = make(port, GPU, specs)
    t._engine.load_state(0, fields)
    for a, b in zip(t._engine.fetch_state(0), fields):
        assert np.array_equal(a, b, equal_nan=True)
    for pkg, p in ((ref, j), (port, t)):
        p.ingest(like(pkg, c2))
        p.finalize()
    assert_bands([t.result().band_array(0)], [j.result().band_array(0)],
                 specs)


def test_port_reruns_are_bit_identical():
    """pcr_tpu's determinism bar (tests/test_determinism.py) on the port."""
    def once():
        _, bands = run(port, GPU, DETERMINISM_SPECS, [big_cloud()],
                       gc=make_grid_config(w=100.0, h=100.0))
        return bands
    a, b = once(), once()
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


def test_host_ingest_takes_the_k1_layout():
    """The keyword wire_cheap (host-sourced ingest) changes nothing in the
    chunk: it has the card lay the chunk out itself (engine/device_prep.py)
    from an exact wire, and that layout is the host layout byte for
    byte."""
    gc = like(port, grid())
    eng = TorchEngine(gc, [(like(port, spec(RT.Average)),
                            port.get_reduction_info(RT.Average))],
                      torch.device("cpu"))
    rng = np.random.default_rng(8)
    col = rng.integers(0, gc.width, 500).astype(np.int32)
    row = rng.integers(0, gc.height, 500).astype(np.int32)
    vals = rng.normal(size=500).astype(np.float32)
    valid = np.ones(500, bool)
    (a,) = eng.prepare_point(0, None, valid, vals, col=col, row=row)
    (b,) = eng.prepare_point(0, None, valid, vals, wire_cheap=True, col=col,
                             row=row)
    assert b.bids is not None
    assert torch.equal(a.params, b.params) and torch.equal(a.bids, b.bids)


@pytest.mark.parametrize("case", ["strict", "fallback", "no_fallback",
                                  "auto", "default"])
def test_fallback_ladder_without_a_card(case, monkeypatch):
    """Without a card the device modes raise CudaError; the CPU runs only
    when the caller asks for it (here: gpu_fallback_to_cpu=True, with its
    warning). "default" is a PipelineConfig with nothing but a grid and a
    reduction."""
    monkeypatch.delenv("PCR_TORCH_DEVICE")
    monkeypatch.setattr(port_pipeline, "cuda_device_available",
                        lambda: False)
    specs = [spec(RT.Average)]
    if case == "default":
        with pytest.raises(port.PcrError) as e:
            port.Pipeline.create(port.PipelineConfig(
                grid=like(port, grid()), reductions=like(port, specs)))
        assert e.value.status.code == port.StatusCode.CudaError
        return
    cfg = dict(gpu_require_strict=case == "strict",
               gpu_fallback_to_cpu=case == "fallback")
    mode = ref.ExecutionMode.Auto if case == "auto" else GPU
    if case != "fallback":
        with pytest.raises(port.PcrError) as e:
            make(port, mode, specs, **cfg)
        assert e.value.status.code == port.StatusCode.CudaError
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        p = make(port, mode, specs, **cfg)
    assert p._backend == "cpu" and p._engine is None
    assert any("falling back" in str(w.message) for w in seen)


NO_JAX_QUICKSTART = textwrap.dedent("""
    import os, sys, tempfile
    for name in ("jax", "pcr_tpu", "pcr"):
        sys.modules[name] = None       # any import of them now raises
    import numpy as np
    import pcr_tpu_torch as pcr
    from pcr_tpu_torch.engine.torch_backend import TorchEngine

    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0, 0, 300, 200
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    n = 20000
    rng = np.random.default_rng(42)
    cloud = pcr.PointCloud.create(n)
    cloud.set_x_array(rng.uniform(0, 300, n))
    cloud.set_y_array(rng.uniform(0, 200, n))
    cloud.add_channel("value", pcr.DataType.Float32)
    cloud.set_channel_array_f32("value", rng.uniform(0, 1, n).astype(np.float32))
    specs = [pcr.ReductionSpec(value_channel="value", type=t)
             for t in (pcr.ReductionType.Average, pcr.ReductionType.Max)]
    d = tempfile.mkdtemp()
    bands = {}
    for mode in (pcr.ExecutionMode.GPU, pcr.ExecutionMode.CPU):
        cfg = pcr.PipelineConfig(
            grid=gc, reductions=specs, exec_mode=mode,
            gpu_require_strict=mode == pcr.ExecutionMode.GPU,
            state_dir=os.path.join(d, f"state{int(mode)}"),
            output_path=os.path.join(d, f"out{int(mode)}.tif"))
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(pipe.stage(cloud) if mode == pcr.ExecutionMode.GPU
                    else cloud)
        pipe.ingest(cloud)
        pipe.finalize()
        if mode == pcr.ExecutionMode.GPU:
            assert isinstance(pipe._engine, TorchEngine)
            resumed = pcr.Pipeline.create(cfg)
            for a, b in zip(resumed._engine.fetch_state(0),
                            pipe._engine.fetch_state(0)):
                assert np.array_equal(a, b)
        bands[mode] = [pipe.result().band_array(i) for i in range(2)]
    g, c = bands[pcr.ExecutionMode.GPU], bands[pcr.ExecutionMode.CPU]
    assert np.allclose(g[0], c[0], rtol=1e-5, atol=1e-5, equal_nan=True)
    assert np.array_equal(g[1], c[1], equal_nan=True)
    assert all(sys.modules[m] is None for m in ("jax", "pcr_tpu", "pcr"))
    print("ok")
""")


def test_quickstart_never_imports_jax():
    env = dict(os.environ, PCR_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", NO_JAX_QUICKSTART], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")

"""Custom reductions (register_custom_reduction) on the port's device path.

A sum-kind op with K fields takes its per-point fields from `info.fields`
on the host, as the numpy oracle does, and folds them through kernel K1 in
ceil(K / 2) launches a chunk (TorchEngine.field_launches); max / min /
argmax_ts ops take the torch scatters. The same seeded clouds go through
the port's device path on torch-CPU (PCR_TORCH_DEVICE=cpu, K1 on its plain
version), the port's CPU oracle, pcr_tpu's device path (GPU mode on the
JAX CPU backend, its Pallas kernels in interpret mode) and a closed form:
sums within 1e-5 (abs + rel per cell) with an exact NaN footprint, max /
min / argmax_ts exact, reruns bit-identical. Each package keeps its own
registry, so every op is registered in both. The cases of
tests/test_reduction_ops.py::TestCustomReduction have twins here.
"""

import math

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.engine import torch_backend
from pcr_tpu_torch.engine.out_of_core import OutOfCoreTorchEngine
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_torch_pipeline import (assert_close, cloud, grid, like, make,
                                 run, spec)

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    """The card's stand-in, and no Custom registration left behind."""
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    yield
    for pkg in (ref, port):
        pkg.unregister_reduction(RT.Custom)


def _sum_fields(k):
    """K per-point fields of a sum op: v, v^2, 1, |v|, ... (first k)."""
    def fields(v, w, t):
        return [v, v * v, v * 0 + 1.0, abs(v)][:k]
    return fields


# `fields` and `finalize_arrays` stick to operators, as
# register_custom_reduction asks: pcr_tpu runs them on traced jax arrays
# too (no engine here merges, so the merges may use numpy).

def _avg_of_first(f):
    """Finalize: the mean of field 0 over the count in field 2 (or in
    field 1 when K = 2, field 0 itself when K = 1); 0 / 0 is NaN."""
    if len(f) == 1:
        return f[0]
    return f[0] / (f[2] if len(f) > 2 else f[1])


def _nan_at(sentinel):
    """Finalize of a max / min op: NaN where the state is the identity
    (0 / 0 there, 0 / 1 + s = s elsewhere)."""
    return lambda f: (f[0] - f[0]) / (f[0] != sentinel) + f[0]


OPS = {
    "rms": dict(state_floats=2, identity=(0.0, 0.0), scatter_kind="sum",
                fields=lambda v, w, t: [v * v, v * 0 + 1.0],
                merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
                finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5),
    "sum_k1": dict(state_floats=1, identity=(0.0,), scatter_kind="sum",
                   fields=_sum_fields(1),
                   merge_arrays=lambda a, b: [a[0] + b[0]],
                   finalize_arrays=_avg_of_first),
    "sum_k2": dict(state_floats=2, identity=(0.0, 0.0), scatter_kind="sum",
                   fields=lambda v, w, t: [v * w, w],
                   merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
                   finalize_arrays=_avg_of_first, uses_weight=True),
    "sum_k3": dict(state_floats=3, identity=(0.0, 0.0, 0.0),
                   scatter_kind="sum", fields=_sum_fields(3),
                   merge_arrays=lambda a, b: [x + y for x, y in zip(a, b)],
                   finalize_arrays=_avg_of_first),
    "sum_k4": dict(state_floats=4, identity=(0.0,) * 4, scatter_kind="sum",
                   fields=_sum_fields(4),
                   merge_arrays=lambda a, b: [x + y for x, y in zip(a, b)],
                   finalize_arrays=lambda f: f[3] / f[2]),
    "max_abs": dict(state_floats=1, identity=(-FLT_MAX,), scatter_kind="max",
                    fields=lambda v, w, t: [abs(v)],
                    merge_arrays=lambda a, b: [np.maximum(a[0], b[0])],
                    finalize_arrays=_nan_at(-FLT_MAX)),
    "min_scaled": dict(state_floats=1, identity=(FLT_MAX,),
                       scatter_kind="min",
                       fields=lambda v, w, t: [v * 2.0],
                       merge_arrays=lambda a, b: [np.minimum(a[0], b[0])],
                       finalize_arrays=_nan_at(FLT_MAX)),
    "argmax_weight": dict(state_floats=2, identity=(np.nan, -FLT_MAX),
                          scatter_kind="argmax_ts",
                          fields=lambda v, w, t: [v, w],
                          merge_arrays=lambda a, b: [
                              np.where(a[1] >= b[1], a[0], b[0]),
                              np.maximum(a[1], b[1])],
                          finalize_arrays=lambda f: f[0], uses_weight=True),
}


def register(name):
    for pkg in (ref, port):
        pkg.register_custom_reduction(**OPS[name])


def custom(name):
    s = ref.ReductionSpec(value_channel="v", type=RT.Custom)
    if OPS[name].get("uses_weight"):
        s.weight_channel = "w"
    return s


def assert_custom(got, want, name):
    if OPS[name]["scatter_kind"] == "sum":
        assert_close(got, want)
    else:
        assert np.array_equal(got, want, equal_nan=True)


def k1_launches(monkeypatch):
    """Count K1's calls from TorchEngine.commit (plain on the CPU)."""
    calls = []
    real = torch_backend.sorted_splat_point

    def counted(states, params, bids, **kw):
        calls.append((len(states), params.shape[1], kw["with_f1"]))
        return real(states, params, bids, **kw)
    monkeypatch.setattr(torch_backend, "sorted_splat_point", counted)
    return calls


@pytest.mark.parametrize("name", list(OPS))
def test_custom_matches_oracle_and_jax(name, monkeypatch):
    """Every kind of custom op on the device path, against the port's
    oracle and pcr_tpu's device path; reruns bit-identical; a sum op with
    K fields takes ceil(K / 2) K1 launches a chunk."""
    register(name)
    specs = [custom(name)]
    clouds = [cloud(seed=1), cloud(seed=2)]
    calls = k1_launches(monkeypatch)
    p, got = run(port, GPU, specs, clouds)
    assert isinstance(p._engine, TorchEngine)
    k = OPS[name]["state_floats"]
    if OPS[name]["scatter_kind"] == "sum":
        assert len(calls) == 2 * math.ceil(k / 2)        # two clouds
        assert [c[0] for c in calls[:math.ceil(k / 2)]] == (
            [2] * (k // 2) + [1] * (k % 2))
        assert all(f1 == (n == 2) for n, _, f1 in calls)
    else:
        assert not calls
    _, again = run(port, GPU, specs, clouds)
    assert np.array_equal(got[0].view(np.int32), again[0].view(np.int32))
    _, oracle = run(port, CPU, specs, clouds)
    assert_custom(got[0], oracle[0], name)
    _, jax_bands = run(ref, GPU, specs, clouds)
    assert_custom(got[0], jax_bands[0], name)
    assert np.isnan(got[0][:, 192:]).all()      # the untouched tile column


def test_register_validates():
    for kw in (dict(state_floats=2, identity=(0.0, 0.0), scatter_kind="max"),
               dict(state_floats=1, identity=(0.0,), scatter_kind="bogus"),
               dict(state_floats=1, identity=(0.0,), scatter_kind="argmax_ts"),
               dict(state_floats=2, identity=(0.0,), scatter_kind="sum")):
        with pytest.raises(ValueError):
            port.register_custom_reduction(fields=None, merge_arrays=None,
                                           finalize_arrays=None, **kw)
    assert port.get_reduction_info(RT.Custom) is None


def test_custom_rms_all_engines():
    """The RMS op of tests/test_reduction_ops.py: the port's oracle, its
    device path and pcr_tpu's device path all agree with the closed
    form."""
    register("rms")
    gc = make_grid_config(w=16.0, h=16.0)
    rng = np.random.default_rng(3)
    n = 4000
    c = ref.PointCloud.create(n)
    x = rng.uniform(0, 16, n)
    y = rng.uniform(0, 16, n)
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("v", ref.DataType.Float32)
    vals = rng.normal(0, 2, n).astype(np.float32)
    c.set_channel_array_f32("v", vals)
    col = np.clip(np.floor(x), 0, 15).astype(int)
    row = np.clip(np.floor((y - 16.0) / -1.0), 0, 15).astype(int)
    s = np.zeros((16, 16))
    k = np.zeros((16, 16))
    np.add.at(s, (row, col), vals.astype(np.float64) ** 2)
    np.add.at(k, (row, col), 1.0)
    want = np.where(k > 0, np.sqrt(s / np.maximum(k, 1)), np.nan)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Custom)]
    for pkg, mode in ((port, CPU), (port, GPU), (ref, GPU)):
        _, got = run(pkg, mode, specs, [c], gc=gc)
        assert (np.isnan(got[0]) == np.isnan(want)).all()
        m = ~np.isnan(want)
        np.testing.assert_allclose(got[0][m], want[m], atol=1e-4)


def test_reregistration_does_not_reuse_an_earlier_op():
    """Two custom ops registered one after the other on the same
    (type, state_floats): each pipeline runs the op registered when it was
    created."""
    gc = make_grid_config(w=8.0, h=8.0)
    c = port.PointCloud.create(4)
    c.set_x_array(np.array([1.5, 1.5, 5.5, 6.5]))
    c.set_y_array(np.array([1.5, 1.5, 5.5, 6.5]))
    c.add_channel("v", port.DataType.Float32)
    c.set_channel_array_f32("v", np.array([2, 4, 8, 16], np.float32))
    specs = [port.ReductionSpec(value_channel="v", type=RT.Custom)]

    def band():
        p = port.Pipeline.create(port.PipelineConfig(
            grid=like(port, gc), reductions=specs,
            exec_mode=port.ExecutionMode.GPU))
        p.ingest(c)
        p.finalize()
        return p.result().band_array(0)

    port.register_custom_reduction(
        state_floats=1, identity=(0.0,), scatter_kind="sum",
        fields=lambda v, w, t: [v],
        merge_arrays=lambda a, b: [a[0] + b[0]],
        finalize_arrays=lambda f: f[0])
    a = band()
    port.unregister_reduction(RT.Custom)
    port.register_custom_reduction(
        state_floats=1, identity=(0.0,), scatter_kind="sum",
        fields=lambda v, w, t: [v * 10.0],
        merge_arrays=lambda a, b: [a[0] + b[0]],
        finalize_arrays=lambda f: f[0] + 100.0)
    b = band()
    assert a[6, 1] == 6.0          # op A: 2 + 4
    assert b[6, 1] == 160.0        # op B: (2+4)*10 + 100 — not A's


@pytest.mark.parametrize("staged", [False, True], ids=["host", "staged"])
def test_customs_beside_builtins_on_one_pipeline(staged):
    """A K = 3 sum op beside Average, Max and MostRecent on one pipeline,
    staged or host-sourced: each band as the oracle's."""
    register("sum_k3")
    specs = [custom("sum_k3"), spec(RT.Average), spec(RT.Max),
             spec(RT.MostRecent)]
    clouds = [cloud(seed=3), cloud(seed=4)]
    _, got = run(port, GPU, specs, clouds, staged)
    _, oracle = run(port, CPU, specs, clouds)
    assert_close(got[0], oracle[0])
    assert_close(got[1], oracle[1])
    for g, o in zip(got[2:], oracle[2:]):
        assert np.array_equal(g, o, equal_nan=True)


@pytest.mark.parametrize("cog", [False, True], ids=["tiff", "cog"])
def test_custom_checkpoint_and_resume(cog, tmp_path):
    """PCRT state and GeoTIFF (plain or cloud-optimized) of a custom op; a
    second pipeline resumes the state and continues as the oracle."""
    register("sum_k3")
    specs = [custom("sum_k3")]
    sd = str(tmp_path / "state")
    tif = str(tmp_path / "out.tif")
    _, first = run(port, GPU, specs, [cloud(seed=5)], state_dir=sd,
                   output_path=tif, write_cog=cog)
    assert np.array_equal(port.read_geotiff_band(tif, 0), first[0],
                          equal_nan=True)
    _, got = run(port, GPU, specs, [cloud(seed=6)], state_dir=sd)
    _, oracle = run(port, CPU, specs, [cloud(seed=5), cloud(seed=6)])
    assert_close(got[0], oracle[0])
    p = make(port, GPU, specs)
    assert np.array_equal(                      # no state_dir: nothing
        p._engine.fetch_state(0)[0], np.zeros((150, 200), np.float32))


@pytest.mark.parametrize("name", ["sum_k3", "max_abs", "argmax_weight"])
def test_custom_banded_equals_resident(name):
    """Under a gpu_memory_budget that bands, a custom op's band is the
    resident band bit for bit."""
    register(name)
    specs = [custom(name)]
    clouds = [cloud(seed=7), cloud(seed=8)]
    p, got = run(port, GPU, specs, clouds, gpu_memory_budget=1 << 14)
    assert isinstance(p._engine, OutOfCoreTorchEngine)
    assert p._engine.nbands > 1
    _, want = run(port, GPU, specs, clouds)
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))


def test_k_field_launch_plan():
    """field_launches: planes (0, 1), (2, 3), ... with with_f1, the last
    alone when K is odd, each launch's params (col, row, its planes)."""
    import torch
    for k in range(1, 6):
        p = torch.arange(3 * (k + 2) * 8, dtype=torch.int32).view(3, k + 2, 8)
        chunk = torch_backend.StagedChunk("fields", p, None, 0)
        plan = TorchEngine.field_launches(chunk)
        assert [f for f, _, _ in plan] == list(range(0, k, 2))
        for f, params, with_f1 in plan:
            w = 2 if with_f1 else 1
            assert params.is_contiguous()
            assert torch.equal(params, torch.cat(
                [p[:, :2], p[:, 2 + f:2 + f + w]], 1))
        assert [w for _, _, w in plan] == [True] * (k // 2) + [False] * (k % 2)


def test_builtin_fast_paths_stay_builtin():
    """A custom op that looks like a builtin (K = 2 sum, like Average)
    takes the host layout of its own fields, never the device wire whose
    modes are keyed to the builtin types."""
    register("sum_k2")
    gc = like(port, grid())
    info = port.get_reduction_info(RT.Custom)
    eng = TorchEngine(gc, [(like(port, custom("sum_k2")), info)],
                      torch_backend.torch.device("cpu"))
    assert not eng._wire_ok(info)
    rng = np.random.default_rng(9)
    col = rng.integers(0, gc.width, 300).astype(np.int32)
    row = rng.integers(0, gc.height, 300).astype(np.int32)
    v = rng.normal(size=300).astype(np.float32)
    w = rng.uniform(0.5, 2, 300).astype(np.float32)
    (chunk,) = eng.prepare_point(0, None, np.ones(300, bool), v, w,
                                 wire_cheap=True, col=col, row=row)
    assert chunk.kind == "fields" and chunk.params.shape[1] == 4

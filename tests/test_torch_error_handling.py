"""tests/test_error_handling.py on the port: typed status errors and the
device probes.

The port's `cuda_*` probes ask torch.cuda in-process, so the JAX package's
wedged-tunnel case (a probe subprocess that hangs, bounded by
PCR_TPU_PROBE_TIMEOUT) has no counterpart to bound; its twin here proves
that each probe answers, with a typed value, within a few seconds, with a
card and without one. The fallback ladder's cases (strict, fallback, no
fallback, Auto and a default config without a card) are
tests/test_torch_pipeline.py::test_fallback_ladder_without_a_card; the
Hybrid rung is here.
"""

import threading

import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from test_torch_parity import devices, make  # noqa: F401
from test_torch_pipeline import like

RT = ref.ReductionType
SPECS = [ref.ReductionSpec(value_channel="v", type=RT.Sum)]
PROBES = {
    "cuda_is_compiled": ((), bool),
    "cuda_device_available": ((), bool),
    "cuda_device_count": ((), int),
    "cuda_device_name": ((0,), str),
    "cuda_memory_info": ((0,), (tuple, type(None))),
}
NO_CARD = {"cuda_device_available": False, "cuda_device_count": 0,
           "cuda_memory_info": None}
ANSWER_S = 5.0


def answer(fn, *args):
    """fn(*args) on a thread that must finish within ANSWER_S seconds."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args)), daemon=True)
    t.start()
    t.join(ANSWER_S)
    assert not t.is_alive(), f"{fn.__name__} did not answer in {ANSWER_S}s"
    assert out, f"{fn.__name__} raised"
    return out[0]


@pytest.mark.parametrize("card", [True, False], ids=["as_is", "no_card"])
@pytest.mark.parametrize("name", list(PROBES))
def test_probes_answer_typed_and_promptly(name, card, monkeypatch):
    if not card:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    args, kind = PROBES[name]
    value = answer(getattr(port, name), *args)
    assert isinstance(value, kind), (name, value)
    if not card and name == "cuda_device_name":
        assert value in ("CUDA not available", "Unknown CUDA device")
    elif not card and name != "cuda_is_compiled":
        assert value == NO_CARD[name]


def test_hybrid_mode_resolves():
    """Hybrid takes the device engine (the card, or PCR_TORCH_DEVICE), as
    pcr_tpu's Hybrid takes its accelerator under PCR_FORCE_JAX."""
    gc = make_grid_config(w=10.0, h=10.0)
    p = make(port, ref.ExecutionMode.Hybrid, SPECS, gc)
    assert isinstance(p._engine, TorchEngine) and p._backend != "cpu"
    assert make(ref, ref.ExecutionMode.Hybrid, SPECS, gc)._backend == "jax"


def invalid_grid(pkg):
    return pkg.PipelineConfig(reductions=[pkg.ReductionSpec(
        value_channel="v", type=pkg.ReductionType.Sum)])


def empty_crs(pkg):
    gc = like(pkg, make_grid_config(w=10.0, h=10.0))
    gc.crs = pkg.CRS()
    return pkg.PipelineConfig(grid=gc, reductions=[pkg.ReductionSpec(
        value_channel="v", type=pkg.ReductionType.Sum)])


@pytest.mark.parametrize("config,code", [(invalid_grid, "InvalidArgument"),
                                         (empty_crs, "CrsError")])
def test_typed_status_errors(config, code):
    codes = []
    for pkg in (port, ref):
        with pytest.raises(pkg.PcrError) as e:
            pkg.Pipeline.create(config(pkg))
        codes.append(e.value.status.code.name)
        assert e.value.status.code == getattr(pkg.StatusCode, code)
    assert codes == [code, code]

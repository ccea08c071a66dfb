"""The port's diagnostics and quick validation
(pcr_tpu_torch/scripts/diagnostics/, pcr_tpu_torch/scripts/quick_validation.py)
without a card.

Under PCR_TORCH_DEVICE=cpu, the tests' stand-in for the card, grid_sizes
(every size of the JAX script, Count, at its default points) and
boundary_points PASS with exit code 0, device_health builds nothing and
holds K1's plain version against itself, and quick validation's probe,
quickstart and ladder sections pass. Without a card and without the
stand-in, nothing falls back to the CPU: device_health, grid_sizes,
boundary_points and transfer_sizes exit 2, and the ladder reports
CudaError and fails. grid_sizes' band counts are also held against
pcr_tpu's CPU oracle on the same sizes.
"""

import os

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch.core import device
from pcr_tpu_torch.scripts import quick_validation
from pcr_tpu_torch.scripts.diagnostics import (boundary_points,
                                               device_health, grid_sizes,
                                               transfer_sizes)
from test_torch_parity import bands


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.delenv("PCR_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("mode", ["GPU", "Auto", "CPU"])
def test_grid_sizes_pass(mode, stand_in, capsys):
    assert grid_sizes.main(["--mode", mode]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PASS"
    assert len([ln for ln in out if ln.endswith(" OK")]) == 8


@pytest.mark.parametrize("w,h", [(1, 1), (7, 3), (1, 4096), (4096, 1),
                                 (3001, 1999)])
def test_grid_sizes_bands_match_the_jax_oracle(w, h, stand_in):
    """grid_sizes' grid and cloud for a size, Count on the port's device
    path, cell for cell pcr_tpu's CPU oracle on the same points."""
    gc = grid_sizes.grid_config(w, h)
    c = grid_sizes.make_cloud(w, h, 20_000)
    ref_gc = make_grid_config(w=float(w), h=float(h))
    assert (gc.width, gc.height, gc.tiles_x, gc.tiles_y) == (
        ref_gc.width, ref_gc.height, ref_gc.tiles_x, ref_gc.tiles_y)
    ref_c = ref.PointCloud.create(c.count())
    ref_c.set_x_array(c.x_array())
    ref_c.set_y_array(c.y_array())
    ref_c.add_channel("value", ref.DataType.Float32)
    ref_c.set_channel_array_f32("value", c.channel_array_f32("value"))
    specs = [ref.ReductionSpec(value_channel="value",
                               type=ref.ReductionType.Count)]
    got = bands(port, ref.ExecutionMode.GPU, specs, [ref_c], ref_gc)[0]
    want = bands(ref, ref.ExecutionMode.CPU, specs, [ref_c], ref_gc)[0]
    assert np.array_equal(got, want, equal_nan=True)
    assert np.nansum(got) == 20_000


def test_boundary_points_pass(stand_in, capsys):
    assert boundary_points.main([]) == 0
    out = capsys.readouterr().out
    assert "PASS - backends agree" in out
    assert out.count("count sum 10 ") == 2


def test_device_health_on_the_stand_in(stand_in, capsys):
    assert device_health.main([]) == 0
    out = capsys.readouterr().out
    assert "kernel smoke test (K1):  OK" in out
    assert "2 GB allocation probe:  skipped" in out


@pytest.mark.parametrize("run", [
    lambda: device_health.main([]),
    lambda: grid_sizes.main(["--mode", "GPU"]),
    lambda: grid_sizes.main([]),
    lambda: boundary_points.main([]),
    lambda: transfer_sizes.main([]),
], ids=["device_health", "grid_sizes_gpu", "grid_sizes_auto",
        "boundary_points", "transfer_sizes"])
def test_without_a_card_exit_2(run, no_card, capsys):
    assert run() == 2
    assert "no CUDA device" in capsys.readouterr().out
    assert not device.cuda_device_available()


def test_grid_sizes_cpu_mode_needs_no_card(no_card, capsys):
    assert grid_sizes.main(["--mode", "CPU", "--points", "1000"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "PASS"


def test_quick_validation_sections_on_the_stand_in(stand_in, capsys):
    assert quick_validation.section_probe()
    assert quick_validation.section_ladder()
    out = capsys.readouterr().out
    assert "device_health exit code 0" in out
    assert "mode=Auto   sum=1000 on the engine on cpu" in out


def test_quick_validation_quickstart_on_the_stand_in(stand_in, capsys):
    assert quick_validation.section_quickstart()
    assert "wrote " in capsys.readouterr().out


def test_quick_validation_ladder_without_a_card(no_card, capsys):
    assert not quick_validation.section_ladder()
    out = capsys.readouterr().out
    assert "mode=CPU    sum=1000 on the CPU oracle" in out
    assert "mode=Auto   raised CudaError" in out
    assert not quick_validation.section_probe()


def test_quick_validation_areas_name_the_port_tests():
    for _, args, _ in quick_validation.AREAS:
        for a in args:
            if a.startswith("tests/"):
                assert os.path.isfile(os.path.join(quick_validation.REPO, a))
                assert os.path.basename(a).startswith("test_torch_"), a
    assert quick_validation.missing("reference") is None   # jax is here
    assert quick_validation.missing("card") == (
        None if torch.cuda.is_available() else "no CUDA card")

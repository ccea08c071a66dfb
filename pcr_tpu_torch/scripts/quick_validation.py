"""
Quick validation of pcr_tpu_torch: is the install healthy on this machine?

    python -m pcr_tpu_torch.scripts.quick_validation

The counterpart of scripts/quick_validation.sh, with its four sections:

  1. the card probe (diagnostics.device_health: the cuda_* probes, the
     kernel library built and K1 run against its plain version, 2 GB);
  2. the port's test areas, one line each, run with
     `python -m pytest --noconftest` (tests/conftest.py imports jax). The
     twins hold the port against pcr_tpu, which needs jax: where jax or
     pcr_tpu is absent those areas are listed as not run, and the card
     area runs only where there is a card;
  3. the README quickstart, `python -m pcr_tpu_torch.examples.quickstart`;
  4. the ladder: ExecutionMode.CPU and Auto each sum 1000 ones, Auto on
     the card. Without a card Auto raises CudaError, and the section says
     so and fails: nothing falls back to the CPU.

Exit code 0 only when every section passed.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import pcr_tpu_torch as pcr
from pcr_tpu_torch.scripts.diagnostics.grid_sizes import grid_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GREEN, YELLOW, BLUE, NC = "\033[0;32m", "\033[1;33m", "\033[0;34m", "\033[0m"

# (label, pytest arguments, what the area needs beyond the port)
AREAS = [
    ("core and host layers", ["tests/test_torch_host_layers.py",
                              "tests/test_torch_streaming_geotiff.py"],
     "reference"),
    ("kernels        ", ["tests/test_torch_kernels.py",
                         "tests/test_torch_gauss_kernels.py",
                         "tests/test_torch_line_kernels.py"], "reference"),
    ("device layout  ", ["tests/test_torch_device_prep.py"], "reference"),
    ("error handling ", ["tests/test_torch_error_handling.py",
                         "tests/test_torch_diagnostics.py"], "reference"),
    ("pipeline       ", ["tests/test_torch_pipeline.py",
                         "tests/test_torch_pipeline_api.py",
                         "tests/test_torch_percentile.py",
                         "tests/test_torch_device_cloud.py",
                         "tests/test_torch_finalize_paths.py",
                         "tests/test_torch_parity.py",
                         "tests/test_torch_fuzz_parity.py",
                         "tests/test_torch_determinism.py"], "reference"),
    ("meshes         ", ["tests/test_torch_mesh.py",
                         "tests/test_torch_sharding.py"], "reference"),
    ("card           ", ["tests/test_torch_cuda.py", "-m", "cuda"], "card"),
]


def banner() -> None:
    print("===========================================")


def ok(msg: str) -> None:
    print(f"  {GREEN}OK{NC} {msg}")


def bad(msg: str) -> None:
    print(f"  {YELLOW}!!{NC} {msg}")


def section_probe() -> bool:
    """1. The card probe: device_health's probes, exit code 0."""
    from pcr_tpu_torch.scripts.diagnostics import device_health
    print(f"{BLUE}1. Accelerator probe{NC}")
    rc = device_health.main([])
    (ok if rc == 0 else bad)(f"device_health exit code {rc}")
    return rc == 0


def missing(need: str) -> str | None:
    """Why an area cannot run here, or None."""
    if need == "card":
        return None if torch.cuda.is_available() else "no CUDA card"
    absent = [m for m in ("jax", "pcr_tpu")
              if importlib.util.find_spec(m) is None]
    return (f"these twins hold the port against pcr_tpu; {', '.join(absent)}"
            f" absent here" if absent else None)


def run_area(label: str, args: list[str]) -> bool:
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", *args], cwd=REPO, capture_output=True,
        text=True, timeout=3600)
    lines = r.stdout.strip().splitlines() or [r.stderr.strip()[-300:]]
    last = lines[-1]
    passed = (r.returncode == 0
              and re.match(r"^(=+ )?\d+ passed", last) is not None)
    (ok if passed else bad)(f"{label}: {last.strip('= ')}")
    return passed


def section_areas() -> bool:
    """2. The test areas: every area that can run here passes."""
    print(f"{BLUE}2. Test areas{NC}")
    results = []
    for label, args, need in AREAS:
        why = missing(need)
        if why is not None:
            print(f"  -- {label}: not run ({why})")
            continue
        results.append(run_area(label, args))
    print(f"  {len(results)} of {len(AREAS)} areas run here, "
          f"{results.count(True)} passed")
    return bool(results) and all(results)


def section_quickstart() -> bool:
    """3. The README quickstart end to end, in a process of its own."""
    print(f"{BLUE}3. README quickstart (end-to-end){NC}")
    tmp = tempfile.gettempdir()
    log = os.path.join(tmp, "pcr_torch_quickstart.log")
    out = os.path.join(tmp, "pcr_torch_quickstart.tif")
    with open(log, "w") as f:
        r = subprocess.run(
            [sys.executable, "-m", "pcr_tpu_torch.examples.quickstart",
             "--out", out], cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
            timeout=600)
    with open(log) as f:
        text = f.read()
    wrote = re.search(r"wrote .*", text)
    if r.returncode == 0 and wrote:
        ok(wrote.group(0))
        return True
    bad(f"quickstart failed (exit code {r.returncode}); see {log}")
    return False


def ladder_cloud(n: int = 1000) -> tuple:
    gc = grid_config(64, 64)
    rng = np.random.default_rng(0)
    cloud = pcr.PointCloud.create(n)
    cloud.set_x_array(rng.uniform(0, 64, n))
    cloud.set_y_array(rng.uniform(0, 64, n))
    cloud.add_channel("v", pcr.DataType.Float32)
    cloud.set_channel_array_f32("v", np.ones(n, np.float32))
    return gc, cloud


def section_ladder() -> bool:
    """4. CPU and Auto each sum 1000 ones; Auto takes the card, and
    without one raises CudaError (which fails the section)."""
    print(f"{BLUE}4. Fallback ladder{NC}")
    gc, cloud = ladder_cloud()
    passed = True
    for mode in (pcr.ExecutionMode.CPU, pcr.ExecutionMode.Auto):
        cfg = pcr.PipelineConfig(grid=gc, exec_mode=mode, reductions=[
            pcr.ReductionSpec(value_channel="v", type=pcr.ReductionType.Sum)])
        try:
            p = pcr.Pipeline.create(cfg)
        except pcr.PcrError as e:
            if e.status.code != pcr.StatusCode.CudaError:
                raise
            bad(f"mode={mode.name:6s} raised CudaError: {e.status.message}")
            passed = False
            continue
        p.ingest(cloud)
        p.finalize()
        total = float(np.nansum(p.result().band_array(0)))
        where = (f"the engine on {p._engine.device}" if p._engine is not None
                 else "the CPU oracle")
        good = abs(total - 1000.0) < 1e-3
        (ok if good else bad)(f"mode={mode.name:6s} sum={total:.0f} on "
                              f"{where}")
        passed &= good
    print("  Auto takes the card; without one it raises CudaError and does "
          "not fall back to the CPU (README, differences from the reference)")
    return passed


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args(argv)
    banner()
    print("pcr_tpu_torch quick validation")
    banner()
    results = []
    for section in (section_probe, section_areas, section_quickstart,
                    section_ladder):
        results.append(section())
        print("")
    banner()
    if all(results):
        print(f"{GREEN}pcr_tpu_torch validated successfully{NC}")
    else:
        print(f"{YELLOW}validation finished with failures{NC}")
    banner()
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())

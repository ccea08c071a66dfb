"""The PyTorch port stands alone: nothing under pcr_tpu_torch/, and nothing
in chip_smoke.py, imports the JAX package (pcr_tpu), its alias (pcr) or
jax.

Each source is parsed with `ast` and every import is checked: `import x`,
`from x import y` (relative imports stay inside the port), and
`importlib.import_module("x")` / `__import__("x")` with a literal name. A
subprocess then imports every module of the port with the three blocked.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

import pcr_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("pcr_tpu", "pcr", "jax")
SOURCES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "pcr_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]


DIAGNOSTICS = [f"pcr_tpu_torch.scripts.diagnostics.{m}" for m in (
    "device_health", "grid_sizes", "boundary_points", "transfer_sizes")]
ENTRY_POINTS = [f"pcr_tpu_torch.examples.{m}" for m in (
    "quickstart", "glyph_splatting", "streaming_resume", "custom_reduction",
    "smiley_face", "multichip")] + [f"pcr_tpu_torch.scripts.{m}" for m in (
        "run_lidar_pipeline", "generate_glyph_patterns", "compare_patterns",
        "quick_validation")] + DIAGNOSTICS


def banned_imports(source: str, path: str = "<src>") -> list[str]:
    """Names of the banned packages that `source` imports."""
    found = []
    for node in ast.walk(ast.parse(source, path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            names = [node.args[0].value]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in BANNED]
    return found


def test_the_sources_are_found():
    assert "pcr_tpu_torch/engine/pipeline.py" in SOURCES
    assert "pcr_tpu_torch/native/__init__.py" in SOURCES
    assert "pcr_tpu_torch/engine/device_prep.py" in SOURCES
    for new in ("engine/out_of_core.py", "engine/grid_merge.py",
                "testing/generators.py", "testing/compare.py",
                "utils/profiling.py", "utils/visualization.py",
                "io/rasterio_bridge.py", "parallel/sharding.py",
                "parallel/engine.py"):
        assert f"pcr_tpu_torch/{new}" in SOURCES
    for entry in ENTRY_POINTS:
        assert entry.replace(".", "/") + ".py" in SOURCES
    assert "pcr_tpu_torch/scripts/diagnostics/__init__.py" in SOURCES
    assert len(SOURCES) > 40


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        assert banned_imports(f.read(), path) == []


@pytest.mark.parametrize("snippet,names", [
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from pcr_tpu.engine import routing", ["pcr_tpu.engine"]),
    ("import pcr", ["pcr"]),
    ("import importlib\nimportlib.import_module('pcr_tpu.core')",
     ["pcr_tpu.core"]),
    ("__import__('jax')", ["jax"]),
    ("from . import routing\nfrom ..core import types", []),
    ("import pcr_tpu_torch\nimport jaxlib_free_name", []),
])
def test_the_check_catches_each_form(snippet, names):
    assert banned_imports(snippet) == names


def test_pipeline_is_the_ports_own():
    """No class in the Pipeline's or TorchEngine's ancestry, and no public
    name of the package, comes from pcr_tpu."""
    from pcr_tpu_torch.engine.torch_backend import TorchEngine
    for cls in (port.Pipeline, port.PipelineConfig, TorchEngine):
        assert all(c.__module__.split(".")[0] not in BANNED
                   for c in cls.__mro__), cls
    for name in port.__all__:
        mod = getattr(getattr(port, name), "__module__", "pcr_tpu_torch")
        assert mod.split(".")[0] == "pcr_tpu_torch", (name, mod)
    assert port.__version__ and port.StatusCode.CudaError == 3


EVERY_MODULE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "pcr_tpu", "pcr"):
        sys.modules[name] = None       # any import of them now raises
    import pcr_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(pcr_tpu_torch.__path__,
                                                  "pcr_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    print(len(mods), "ok")
""")


def test_every_module_imports_with_the_jax_package_blocked():
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", EVERY_MODULE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    n, ok = r.stdout.split()
    assert ok == "ok" and int(n) >= 25


EVERY_ENTRY_POINT = textwrap.dedent("""
    import contextlib, io, runpy, sys
    for name in ("jax", "pcr_tpu", "pcr"):
        sys.modules[name] = None       # any import of them now raises
    for mod in sys.argv[1:]:
        sys.argv = [mod, "--help"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module(mod, run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (mod, e.code)
        assert out.getvalue().startswith("usage:"), mod
        print(mod, "ok")
""")


def test_every_entry_point_runs_with_the_jax_package_blocked():
    """`python -m` of each example and script (its --help) with jax,
    pcr_tpu and pcr blocked."""
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", EVERY_ENTRY_POINT,
                        *ENTRY_POINTS], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == [w for m in ENTRY_POINTS for w in (m, "ok")]


def test_an_install_ships_every_kernel_source():
    """Every file of pcr_tpu_torch/csrc (sources and the headers they
    include) is named by the wheel's package data and by the sdist's
    manifest: a kernel built at first use needs them all."""
    import fnmatch
    import glob
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        pyproject = f.read()
    line = next(ln for ln in pyproject.splitlines()
                if ln.startswith('"pcr_tpu_torch" ='))
    wheel = [p.strip(' "') for p in line.split("[")[1].rstrip("]").split(",")]
    with open(os.path.join(REPO, "MANIFEST.in")) as f:
        sdist = [ln.split()[1] for ln in f if ln.startswith("include ")]
    files = glob.glob(os.path.join(REPO, "pcr_tpu_torch", "csrc", "*"))
    assert any(f.endswith(".cuh") for f in files)
    for path in files:
        rel = os.path.relpath(path, REPO)
        assert any(fnmatch.fnmatch(rel, os.path.join("pcr_tpu_torch", p))
                   for p in wheel), rel
        assert any(fnmatch.fnmatch(rel, p) for p in sdist), rel


DIAGNOSTICS_RUN = textwrap.dedent("""
    import contextlib, io, runpy, sys
    for name in ("jax", "pcr_tpu", "pcr"):
        sys.modules[name] = None       # any import of them now raises
    for mod, args in (("grid_sizes", ["--mode", "GPU", "--points", "2000"]),
                      ("boundary_points", []), ("device_health", [])):
        mod = "pcr_tpu_torch.scripts.diagnostics." + mod
        sys.argv = [mod, *args]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module(mod, run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (mod, e.code, out.getvalue())
        text = out.getvalue()
        print(mod, "ok" if "PASS" in text or "(K1):  OK" in text else "bad")
""")


def test_diagnostics_run_with_the_jax_package_blocked():
    """`python -m` of grid_sizes (GPU mode), boundary_points and
    device_health on the tests' stand-in for the card, with jax, pcr_tpu
    and pcr blocked: each exits 0, the first two with PASS, the last with
    its K1 smoke test OK."""
    env = dict(os.environ, PCR_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", DIAGNOSTICS_RUN], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == [
        w for m in ("grid_sizes", "boundary_points", "device_health")
        for w in (f"pcr_tpu_torch.scripts.diagnostics.{m}", "ok")]

"""Sizes for the harness's CPU tests of the configurations that came after
cardbench/tests/conftest.py: its SMALL table cuts each configuration of
BENCHMARK.json for the small copy of the benchmark (`small_bench`), and
each later configuration adds its cut here."""

from __future__ import annotations

import os

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")

# the rotated glyph at its published footprint (61^2-cell windows) on a
# grid of 96 x 80 cells, a few thousand points: K4's plain version and
# the float64 reference stay within seconds on the CPU
SMALL = {
    "glyph_gauss_rot10x2.5": {"grid": {"extent_x": 96.0, "extent_y": 80.0},
                              "points": {"count": 2_000}},
}


def pytest_plugin_registered(plugin, manager):
    """Add SMALL to the tests' own table when pytest loads their
    conftest."""
    path = getattr(plugin, "__file__", None) or ""
    if os.path.dirname(os.path.abspath(path)) == TESTS and isinstance(
            getattr(plugin, "SMALL", None), dict):
        for name, cut in SMALL.items():
            plugin.SMALL.setdefault(name, cut)

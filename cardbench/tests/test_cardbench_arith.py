"""The harness's arithmetic on fixed inputs: percentiles, the window's
rate, the union of device intervals and the idle time by span, the
accumulate's kernels, the transfer, the work counts, and the isolation
check by whole top-level names."""

from __future__ import annotations

import math

import numpy as np
import pytest

from cardbench import isolation, peaks, registry
from cardbench.glyphs import job_work
from cardbench.grid import Grid
from cardbench.metrics import mpts_s, splat_roofline
from cardbench.points import Points
from cardbench.run import Run, Sample
from cardbench.stats import percentile, spread
from cardbench.trace import Event, summarize, union


def test_percentile_interpolates_as_numpy():
    xs = [7.0, 1.0, 3.0, 10.0, 2.0, 5.0, 4.0, 9.0, 6.0, 8.0]
    assert percentile(xs, 95) == pytest.approx(9.55)
    assert percentile(xs, 50) == pytest.approx(5.5)
    rs = np.random.default_rng(3).random(257)
    for q in (5, 50, 95, 99):
        assert percentile(rs, q) == pytest.approx(np.percentile(rs, q))
    assert percentile([4.0], 95) == 4.0


def test_spread_is_the_quartiles_over_the_median():
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_mpts_s_counts_the_job_that_overran_the_window():
    run = Run(points_per_job=1_000_000, setup_s=1.0, window_start=10.0,
              job_ends=[11.0, 12.0, 13.5])   # a 3 s window, closed at 13
    assert mpts_s.read(run) == pytest.approx(3.0 / 3.5)
    assert mpts_s.read(Run(points_per_job=1, setup_s=1.0,
                           window_start=0.0)) is None


def test_event_kinds_from_name_device_and_annotation():
    from cardbench.trace import _kind
    assert _kind("void k1<128>(int*)", True, False) == "kernel"
    assert _kind("Memcpy HtoD (Pinned -> Device)", True, False) == "memcpy"
    assert _kind("Memset (Device)", True, False) == "memset"
    assert _kind("cardbench.commit", True, True) == "other"
    assert _kind("Stream Sync", True, False) == "other"
    assert _kind("cardbench.commit", False, True) == "span"
    assert _kind("cudaLaunchKernel", False, False) == "launch"
    assert _kind("cuLaunchKernel", False, False) == "launch"
    assert _kind("aten::copy_", False, False) == "op"
    assert _kind("cudnn_helper", False, False) == "op"


def test_union_merges_overlaps_once():
    assert union([(10, 12), (0, 5), (3, 8), (12, 13)]) == [[0, 8], [10, 13]]


def _events():
    ev = [Event("cardbench.window", "span", 0, 100, corr=100),
          Event("cardbench.job", "span", 1, 90, corr=101),
          Event("cardbench.ingest", "span", 8, 45, corr=102),
          Event("cardbench.commit", "span", 10, 20, corr=103),
          Event("aten::copy_", "op", 11, 12, corr=104),
          Event("cardbench.ingest", "span", 47, 65, corr=107),
          Event("cardbench.commit", "span", 55, 60, corr=106),
          Event("cardbench.finalize", "span", 66, 89, corr=105),
          Event("Memcpy HtoD (Pinned -> Device)", "memcpy", 0, 5, corr=7),
          Event("cardbench.commit", "other", 15, 25, corr=103),
          Event("K", "kernel", 15, 25, corr=1),
          Event("other", "kernel", 30, 40, corr=2),
          Event("K", "kernel", 60, 70, corr=3),
          Event("outside", "kernel", 120, 130, corr=4)]
    ev += [Event("cudaLaunchKernel", "launch", 12, 13, corr=1),
           Event("cudaLaunchKernel", "launch", 30, 31, corr=2),
           Event("cudaLaunchKernel", "launch", 55, 56, corr=3)]
    return ev


def test_the_trace_summary():
    s = summarize(_events())
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(35e-9)
    assert s.commit_kernel_s == pytest.approx(20e-9)
    assert s.h2d_s == pytest.approx(5e-9)
    assert s.device_ops[0] == ["K", pytest.approx(20e-9)]
    # gaps [5, 15] in a commit, [25, 30] and [40, 60] in an ingest,
    # [70, 100] in the finalize (the window closes inside the job)
    assert [n for n, _ in s.idle_gaps] == ["finalize", "ingest", "commit"]
    assert [t for _, t in s.idle_gaps] == [pytest.approx(30e-9),
                                          pytest.approx(25e-9),
                                          pytest.approx(10e-9)]


def test_the_roofline_share_of_a_window():
    run = Run(points_per_job=1, setup_s=1.0, window_start=0.0,
              job_ends=[1.0, 2.0], least_time_per_job_s=0.001)
    run.trace = summarize(_events())
    run.trace.commit_kernel_s = 0.004
    assert splat_roofline.read(run) == pytest.approx(50.0)
    h100 = peaks.of("NVIDIA H100 80GB HBM3")
    assert peaks.least_time({"bytes": 3.35e9, "flops": 6.7e9},
                            h100) == pytest.approx(1e-3)
    assert peaks.of("cpu") is None


def _grid(size):
    return Grid(0.0, 0.0, float(size), float(size), 1.0, 3857, 4096)


POINT = {"glyph": "point", "type": "Average", "value_channel": "v"}


def test_the_point_work_count():
    p = Points(np.array([0.5, 0.7, 2.2, 4.0, 5.0]),
               np.array([3.5, 3.9, 0.1, 0.0, 5.0]),
               np.array([1, 3, 5, 7, 9], np.float32))
    calls = [(0, 2), (2, 5)]
    w = registry.glyph("point").work(p, _grid(4), POINT, calls)
    # call 1: 2 points, 1 cell; call 2: 2 live points, 2 cells, 1 outside
    assert w == {"bytes": 2 * 4 + 1 * 16 + 2 * 4 + 2 * 16, "flops": 8}
    # the job: each live point's cell read once a call, for all reductions
    one = job_work(p, _grid(4), [POINT], calls)
    assert one == {"bytes": w["bytes"] + 4 * 4, "flops": 8}
    two = job_work(p, _grid(4), [POINT, POINT], calls)
    assert two == {"bytes": 2 * w["bytes"] + 4 * 4, "flops": 16}


def test_the_gaussian_work_count():
    red = {"glyph": "gaussian", "type": "Average", "value_channel": "v",
           "sigma_x": 1.0, "sigma_y": 1.0, "max_radius_cells": 32.0}
    p = Points(np.array([4.5]), np.array([4.5]), np.ones(1, np.float32))
    w = job_work(p, _grid(9), [red], [(0, 1)])
    assert w == {"bytes": 8 + 49 * 16, "flops": 49 * 5}
    # at sigma 0.5 (r = 2) the product cutoff drops the 5 cells whose
    # offsets (dx - 0.5, dy - 0.5) / 0.5 square to over 27.63: the corner
    # (-2.5, -2.5) and the four (-2.5, +-1.5), (+-1.5, -2.5)
    red.update(sigma_x=0.5, sigma_y=0.5)
    w = registry.glyph("gaussian").work(p, _grid(9), red, [(0, 1)])
    assert w["flops"] == (25 - 5) * 5


def test_the_sample_keeps_k_and_the_last():
    s = Sample(3, seed=5)
    for i in range(100):
        s.offer(i)
    got = s.rasters()
    assert len(got) == 4 and got[-1] == 99 and len(set(got)) == 4
    again = Sample(3, seed=5)
    for i in range(100):
        again.offer(i)
    assert again.rasters() == got
    one = Sample(3, seed=5)
    one.offer("a")
    assert one.rasters() == ["a"]


def test_isolation_compares_whole_top_level_names():
    mods = ["pcr_tpu_torch", "pcr_tpu_torch.engine", "pcr_tpu",
            "pcr_tpu.core", "jax.numpy", "jaxlib", "pcr", "pcrx",
            "flax.linen", "numpy", "jaxtyping"]
    assert isolation.forbidden(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                         "pcr", "pcr_tpu", "pcr_tpu.core"]
    assert isolation.forbidden(["pcr_tpu_torch.core.grid"]) == []


def test_gaussian_weights_by_hand():
    assert math.exp(-0.25) == pytest.approx(0.7788007830714049)

"""Bounded-memory collect streams for order-statistics reductions.

The port's copy of pcr_tpu/engine/collect_spill.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Median/Percentile keep the raw (cell, value) stream rather than K-float
tile state (exact quantiles need every sample; the reference leaves these
ops unregistered, reduction_registry.cpp:183-185). Round 2 held the whole
stream in host RAM (~12 B/point) — the one op that broke the streaming
contract: a billion-point run with a Percentile spec would OOM the host.

CollectStream caps resident memory at COLLECT_BUDGET (256 MB) by default:
when the in-RAM buffer exceeds the budget, it is sorted by cell and
written to disk as one run (cells int64 + values float32, raw .npy).
Finalize merges the sorted runs cell-range by cell-range — each range is
sliced from every run with two searchsorted probes (contiguous reads via
np.load(mmap_mode='r')), so peak memory is ~budget regardless of total
points. Host RSS stays flat through a streaming run; see
benchmarks note in scripts/data/run_lidar_pipeline.py.

The reference's streaming point reader (point_cloud_io.h:75-99) is the
model for the contract this restores.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from ..ops.reduction import compute_percentile_band

__all__ = ["COLLECT_BUDGET", "CollectStream"]

COLLECT_BUDGET = 256 << 20   # bytes of (cell, value) pairs held in RAM


class CollectStream:
    def __init__(self, budget_bytes: int | None = None,
                 spill_dir: str | None = None):
        self._budget = budget_bytes or COLLECT_BUDGET
        self._spill_parent = spill_dir
        self._dir: str | None = None
        self._runs: list[tuple[str, str]] = []
        self._buf: list[tuple[np.ndarray, np.ndarray]] = []
        self._buf_bytes = 0
        self.total_points = 0

    # -- ingest -----------------------------------------------------------------

    def append(self, cells, values) -> None:
        cells = np.asarray(cells, np.int64)
        values = np.asarray(values, np.float32)
        self._buf.append((cells, values))
        self._buf_bytes += cells.nbytes + values.nbytes
        self.total_points += len(cells)
        if self._buf_bytes > self._budget:
            self._spill()

    def _spill(self) -> None:
        if not self._buf:
            return
        cells = np.concatenate([c for c, _ in self._buf])
        values = np.concatenate([v for _, v in self._buf])
        self._buf = []
        self._buf_bytes = 0
        order = np.argsort(cells, kind="stable")
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="pcr_collect_",
                                         dir=self._spill_parent)
        k = len(self._runs)
        cpath = os.path.join(self._dir, f"run{k}.cells.npy")
        vpath = os.path.join(self._dir, f"run{k}.vals.npy")
        np.save(cpath, cells[order])
        np.save(vpath, values[order])
        self._runs.append((cpath, vpath))

    @property
    def spilled_runs(self) -> int:
        return len(self._runs)

    # -- finalize ---------------------------------------------------------------

    def band(self, shape, q: float) -> np.ndarray:
        """Exact per-cell q-quantile band over everything appended."""
        H, W = shape
        if not self._runs:
            if not self._buf:
                return np.full((H, W), np.nan, dtype=np.float32)
            cells = np.concatenate([c for c, _ in self._buf])
            values = np.concatenate([v for _, v in self._buf])
            return compute_percentile_band(cells, values, shape, q)
        self._spill()   # tail becomes the final run
        runs = [(np.load(c, mmap_mode="r"), np.load(v, mmap_mode="r"))
                for c, v in self._runs]
        total_bytes = sum(rc.nbytes + rv.nbytes for rc, rv in runs)
        nranges = max(1, -(-total_bytes // self._budget))
        bounds = np.linspace(0, H * W, nranges + 1).astype(np.int64)
        band = np.full(H * W, np.nan, dtype=np.float32)
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            if c1 <= c0:
                continue
            parts_c, parts_v = [], []
            for rc, rv in runs:
                a = int(np.searchsorted(rc, c0))
                b = int(np.searchsorted(rc, c1))
                if b > a:
                    parts_c.append(np.asarray(rc[a:b]))
                    parts_v.append(np.asarray(rv[a:b]))
            if not parts_c:
                continue
            cc = np.concatenate(parts_c) - c0
            vv = np.concatenate(parts_v)
            band[c0:c1] = compute_percentile_band(
                cc, vv, (1, int(c1 - c0)), q).ravel()
        return band.reshape(H, W)

    # -- cleanup ----------------------------------------------------------------

    def close(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
            self._runs = []

    def __del__(self):   # best-effort spill cleanup
        try:
            self.close()
        except Exception:
            pass

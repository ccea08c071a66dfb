"""
The mesh engines behind the Pipeline API — the port's counterpart of
pcr_tpu/parallel/engine.py. Both keep the TorchEngine surface the Pipeline
uses (prepare_*, commit, fetch_state, load_state, finalize_to_host, warmup,
block_until_ready), and both split the grid into
row shards, each a TorchEngine over a shard view of the grid (`shard_view`:
the shard's rows in its own frame, carrying the whole grid's row offset and
height, as an out-of-core band does), so K1-K5 run unchanged on every
shard:

  * ingest routes every entry on the host to each shard its footprint rows
    meet (a Point's: its own row; a Gaussian's: icy +- r; a Line's: its
    endpoint rows), and the shard stages it in its own rows. A footprint
    that crosses a shard border is staged in both, and each shard's clips
    (the grid's rows, and on a tiled grid the home tile, computed in the
    whole grid's frame) keep its own part: a window whose home tile lies
    in another shard stages dead here;
  * `PartitionedTorchEngine` serves grids of several tiles: all devices
    of the mesh become row shards, which own their rows exclusively, so
    nothing merges;
  * `ShardedTorchEngine` serves one-tile grids over a (dp, sp) mesh: sp
    row shards, each owned by mesh.devices[0][s]. With dp > 1 the shard's
    entries split contiguously in ingest order over dp cells (so the
    lowest dp index holds the earliest points, which MostRecent's tie rule
    needs); each cell runs its part from the merge's identity on its own
    device, and sharding.merge_deltas folds the cells into the owner in dp
    order. A cell's delta costs one shard state of every field. Built
    directly on a grid of several tiles it runs the same row shards (the
    Pipeline takes PartitionedTorchEngine there).

One process drives every device, as in pcr_tpu: a merge copies between
devices (`sharding.to_device`), nothing launches a process. Engines on one
device share one staging arena (pinned buffers and a copy stream).

Staging writes nothing on an engine (Hybrid workers stage at once). The raw
staging paths (`prepare_*_raw`) return None, as the out-of-core engine's
do, so the pipeline routes such clouds through routing's per-point
parameters, which the engines then split by shard. The Gaussian flush runs
at every state exit (each shard's fetch_state and finalize), never at a dp
merge.

Not carried over from pcr_tpu: the common-program nsub floor and its
re-staging pass, the padded-length ladder, the shared jit namespace, the
check_vma shim and the PCR_PALLAS switch, all jit and TPU workarounds:
each cell simply stages its own chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.out_of_core import take_optional, take_points
from ..engine.torch_backend import TorchEngine, _Arena, shard_view
from . import sharding

__all__ = ["ShardedTorchEngine", "PartitionedTorchEngine",
           "resolve_mesh_devices", "shard_view"]


def resolve_mesh_devices(mesh_devices):
    """A PipelineConfig `mesh_devices` value as a device list: None (no
    mesh), an int n (the first n CUDA devices, or n shards on the
    PCR_TORCH_DEVICE device; ValueError when there are fewer), or a list
    of devices, which may name one device more than once."""
    if mesh_devices is None:
        return None
    if isinstance(mesh_devices, int):
        if mesh_devices < 1:
            raise ValueError(f"mesh_devices={mesh_devices}: a mesh needs "
                             f"at least one device")
        devs = sharding.available_devices(mesh_devices)
        if len(devs) < mesh_devices:
            raise ValueError(f"mesh_devices={mesh_devices} but only "
                             f"{len(devs)} devices available")
        return devs[:mesh_devices]
    return [torch.device(d) for d in mesh_devices]


class _MeshStep:
    """One staged chunk of a ShardedTorchEngine: per shard s, per dp cell
    d, the chunk list cell (d, s) staged ([] for none)."""
    __slots__ = ("cells",)

    def __init__(self, cells):
        self.cells = cells


class _RowShards:
    """What both mesh engines share: the grid's row shards, their engines
    (`owners`: shard s's state), routing by footprint rows, staging in each
    shard's frame and the state exits, which join the shards' rows."""

    def _split_rows(self, n: int) -> None:
        n = max(1, min(n, self.H))
        self.local_rows = -(-self.H // n)
        self.nshards = -(-self.H // self.local_rows)
        self.offsets = [s * self.local_rows for s in range(self.nshards)]

    def _shard_engine(self, s: int, device, arenas, state: bool = True):
        """A TorchEngine over shard s on `device`, sharing the device's
        arena."""
        device = torch.device(device)
        arena = arenas.setdefault(device, _Arena(device))
        off = self.offsets[s]
        return TorchEngine(shard_view(self.cfg, off, min(
            self.local_rows, self.H - off)), self.plans, device, state=state,
            arena=arena)

    def _route(self, lo, hi, valid):
        """Per shard, the indices of the valid entries whose inclusive
        global row span [lo, hi] meets its rows, in entry order."""
        lr = self.local_rows
        s0 = np.clip(np.minimum(lo, hi) // lr, 0, self.nshards - 1)
        s1 = np.clip(np.maximum(lo, hi) // lr, 0, self.nshards - 1)
        return [np.flatnonzero(valid & (s0 <= s) & (s <= s1))
                for s in range(self.nshards)]

    # -- staging (writes nothing on the engine: Hybrid workers call these
    # at once); `_stage(lo, hi, valid, stage)` calls stage(engine, idx,
    # row_offset) for each shard's entries

    def prepare_point(self, spec_idx: int, cells, valid, values,
                      weights=None, timestamps=None, wire_cheap=False,
                      col=None, row=None):
        valid = np.asarray(valid, bool)
        if col is None:
            cells = np.asarray(cells, np.int64)
            row = cells // self.W
            col = cells - row * self.W
        col, row, values = (np.asarray(a) for a in (col, row, values))

        def stage(eng, idx, off):
            return eng.prepare_point(
                spec_idx, None, np.ones(len(idx), bool), values[idx],
                take_optional(weights, idx), take_optional(timestamps, idx),
                wire_cheap=wire_cheap, col=col[idx].astype(np.int32),
                row=(row[idx] - off).astype(np.int32))
        return self._stage(row, row, valid, stage)

    def prepare_gaussian(self, spec_idx: int, gp, valid, values,
                         wire_cheap: bool = False):
        valid = np.asarray(valid, bool)
        values = np.asarray(values)
        icy = gp.icy.astype(np.int64)
        r = np.where(valid, gp.r, 0).astype(np.int64)

        def stage(eng, idx, off):
            return eng.prepare_gaussian(
                spec_idx, take_points(gp, idx, off), np.ones(len(idx), bool),
                values[idx], wire_cheap=wire_cheap)
        return self._stage(icy - r, icy + r, valid, stage)

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row,
                     wire_cheap: bool = False):
        valid = np.asarray(valid, bool)
        values, col, row = (np.asarray(a) for a in (values, col, row))

        def stage(eng, idx, off):
            # the owner's cell in the shard's rows, unclamped on a tiled
            # grid (its home tile is computed in the whole grid's frame);
            # a one-tile grid has no home tile, any row of the shard will do
            lrow = row[idx] - off
            if self.cfg.total_tiles() <= 1:
                lrow = np.clip(lrow, 0, eng.H - 1)
            return eng.prepare_line(
                spec_idx, take_points(lp, idx, off), np.ones(len(idx), bool),
                values[idx], col[idx], lrow.astype(np.int32),
                wire_cheap=wire_cheap)
        return self._stage(np.minimum(lp.iy0, lp.iy1),
                           np.maximum(lp.iy0, lp.iy1), valid, stage)

    def prepare_gaussian_raw(self, spec_idx, glyph, x, y, valid, values):
        """None: a shard's raw pass would route world coordinates to the
        whole grid's rows, so these clouds go through
        routing.gaussian_params and prepare_gaussian."""
        return None

    def prepare_line_raw(self, spec_idx, glyph, x, y, valid, values, col,
                         row):
        """None, as prepare_gaussian_raw: through routing.line_params and
        prepare_line."""
        return None

    # -- state access: the shards' rows joined

    def load_state(self, spec_idx: int, fields_hw) -> None:
        for off, eng in zip(self.offsets, self.owners):
            eng.load_state(spec_idx, [np.asarray(f, np.float32)[
                off:off + eng.H] for f in fields_hw])

    def fetch_state(self, spec_idx: int):
        """The (H, W) host state fields, Gaussian flush applied (each
        shard's fetch_state flushes)."""
        parts = [eng.fetch_state(spec_idx) for eng in self.owners]
        return [np.concatenate(f) for f in zip(*parts)]

    def finalize_to_host(self, spec_idx: int, with_state: bool = False):
        """Host (K, H, W) raw state planes (`with_state`) or the (1, H, W)
        finalized band, each shard finalized on its device."""
        return np.concatenate([eng.finalize_to_host(spec_idx, with_state)
                               for eng in self.owners], axis=1)

    def _engines_by_device(self):
        return {eng.device: eng for eng in self.owners}.values()

    def block_until_ready(self) -> None:
        for eng in self._engines_by_device():
            eng.block_until_ready()

    def warmup(self) -> None:
        for eng in self._engines_by_device():
            eng.warmup()

    # -- one-shot ingest

    def ingest_point(self, spec_idx, cells, valid, values, weights=None,
                     timestamps=None) -> None:
        self.commit(spec_idx, self.prepare_point(
            spec_idx, cells, valid, values, weights, timestamps))

    def ingest_gaussian(self, spec_idx, gp, valid, values) -> None:
        self.commit(spec_idx, self.prepare_gaussian(spec_idx, gp, valid,
                                                    values))

    def ingest_line(self, spec_idx, lp, valid, values, col, row) -> None:
        self.commit(spec_idx, self.prepare_line(spec_idx, lp, valid, values,
                                                col, row))


class PartitionedTorchEngine(_RowShards):
    """The mesh engine of grids of several tiles: one TorchEngine per row
    shard, shard s on devices[s % len(devices)] (more devices than rows:
    one shard a row). Rows are owned exclusively, so nothing merges.
    Staging returns [(shard, chunks)], shards with no entry left out."""

    def __init__(self, cfg, plans, devices):
        self.cfg, self.plans = cfg, plans
        self.devices = [torch.device(d) for d in devices]
        self.H, self.W = cfg.height, cfg.width
        self._split_rows(len(self.devices))
        arenas = {}
        self.engines = [
            self._shard_engine(s, self.devices[s % len(self.devices)], arenas)
            for s in range(self.nshards)]
        self.owners = self.engines

    def _stage(self, lo, hi, valid, stage):
        return [(s, stage(self.engines[s], idx, self.offsets[s]))
                for s, idx in enumerate(self._route(lo, hi, valid))
                if len(idx)]

    def commit(self, spec_idx: int, staged) -> None:
        for s, chunks in staged:
            self.engines[s].commit(spec_idx, chunks)


class ShardedTorchEngine(_RowShards):
    """The mesh engine of one-tile grids over a (dp, sp) mesh (see the
    module docstring); built directly on a tiled grid, the same row shards
    serve it, their home tiles in the whole grid's frame. `cells[d][s]` stages and runs cell (d, s);
    `owners[s]` holds shard s's state (cells[0] itself when dp == 1).
    Staging returns one _MeshStep a chunk."""

    def __init__(self, cfg, plans, mesh=None, devices=None,
                 dp: int | None = None, sp: int | None = None):
        self.cfg, self.plans = cfg, plans
        self.mesh = mesh if mesh is not None else sharding.make_mesh(
            devices, dp=dp, sp=sp)
        self.dp, self.sp = self.mesh.shape["dp"], self.mesh.shape["sp"]
        self.H, self.W = cfg.height, cfg.width
        self._split_rows(self.sp)
        arenas = {}
        devs = self.mesh.devices
        self.owners = [self._shard_engine(s, devs[0][s], arenas)
                       for s in range(self.nshards)]
        self.cells = [self.owners] if self.dp == 1 else [
            [self._shard_engine(s, devs[d][s], arenas, state=False)
             for s in range(self.nshards)] for d in range(self.dp)]

    def _stage(self, lo, hi, valid, stage):
        cells = [[stage(self.cells[d][s], part, self.offsets[s])
                  if len(part) else []
                  for d, part in enumerate(np.array_split(idx, self.dp))]
                 for s, idx in enumerate(self._route(lo, hi, valid))]
        return [_MeshStep(cells)]

    def commit(self, spec_idx: int, staged) -> None:
        """Apply staged steps in order: in place on each shard's state
        (dp == 1), or each cell from the identity, then merged into the
        shard's owner in dp order."""
        _, info = self.plans[spec_idx]
        kind = info.scatter_kind
        fill = ([0.0] * info.state_floats if kind == "sum"
                else list(info.identity))
        for step in staged:
            for s, per_d in enumerate(step.cells):
                if self.dp == 1:
                    if per_d[0]:
                        self.owners[s].commit(spec_idx, per_d[0])
                    continue
                deltas = []
                for d, chunks in enumerate(per_d):
                    if chunks:
                        eng = self.cells[d][s]
                        eng.reset_state(spec_idx, fill)
                        eng.commit(spec_idx, chunks)
                        deltas.append(eng.states(spec_idx))
                if deltas:
                    sharding.merge_deltas(
                        kind, self.owners[s].states(spec_idx), deltas)

"""
TileManager — out-of-core tile-state persistence.

The port's copy of pcr_tpu/engine/tile_manager.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Rebuild of the reference TileManager (include/pcr/engine/tile_manager.h:26-72,
src/engine/tile_manager.cpp): an LRU cache of per-tile reduction-state
buffers that spills dirty tiles to PCRT files and reloads (or re-initialises
to the op identity) on miss. Tile state *is* the checkpoint: a new manager
pointed at the same state_dir resumes accumulation.

Semantics matched to the reference:
  * acquire(tile) → state buffer; miss loads the PCRT file (header-validated
    before the body, tile_manager.cpp:272-302) else initialises to identity;
    corrupt/mismatched files re-initialise (:280-320).
  * release(tile) marks the tile dirty (:377-414).
  * LRU eviction flushes dirty unpinned tiles to disk when the cache
    exceeds cache_size_bytes (:79-103); pinned tiles are never evicted.
  * flush_all writes every dirty cached tile (:416-426).
  * edge tiles use their clamped dimensions (:242-249).
  * stats: cache_hits / cache_misses / tiles_in_cache; tiles_on_disk counts
    state files (the reference stubs this at 0, tile_manager.cpp:464-468 —
    implemented for real here).

States are numpy (state_floats, rows, cols) float32 blocks in host RAM;
the CPU pipeline accumulates directly into them (pipeline._ingest_cpu_tiled).
The accelerator's over-HBM path is the band-swapped OutOfCoreTpuEngine
(engine/out_of_core.py), which keeps full host-resident state and stages
tile-row bands to the device on acquire/release.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..core.grid_config import GridConfig
from ..core.types import ReductionType, Status, StatusCode, TileIndex
from ..io import tile_state_io
from ..ops.reduction import get_reduction_info

__all__ = ["TileManagerConfig", "TileManager"]


@dataclass
class TileManagerConfig:
    """(reference: tile_manager.h:26-33)"""
    state_dir: str = ""
    cache_size_bytes: int = 1 << 30      # 1 GB default
    state_floats: int = 1
    reduction_type: ReductionType = ReductionType.Sum
    grid_config: GridConfig = dc_field(default_factory=GridConfig)


class TileManager:
    """LRU tile-state cache with disk spill."""

    def __init__(self, config: TileManagerConfig):
        self.config = config
        self._cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._dirty: set = set()
        self._pinned: set = set()
        self._hits = 0
        self._misses = 0
        info = get_reduction_info(config.reduction_type)
        if info is None:
            raise ValueError(
                f"unregistered reduction {config.reduction_type}")
        self._info = info
        if config.state_dir:
            os.makedirs(config.state_dir, exist_ok=True)

    @staticmethod
    def create(config: TileManagerConfig) -> "TileManager":
        return TileManager(config)

    # -- internals -------------------------------------------------------------

    def _key(self, tile: TileIndex):
        return (tile.row, tile.col)

    def _tile_dims(self, tile: TileIndex):
        _, _, cols, rows = self.config.grid_config.tile_cell_range(tile)
        return cols, rows

    def _tile_path(self, tile: TileIndex) -> str:
        return tile_state_io.tile_state_filename(self.config.state_dir, tile)

    def _tile_bytes(self, tile_state: np.ndarray) -> int:
        return tile_state.nbytes

    def _cache_bytes(self) -> int:
        return sum(v.nbytes for v in self._cache.values())

    def _evict_if_needed(self) -> Status:
        """Evict least-recently-used unpinned tiles until under budget
        (reference: tile_manager.cpp:79-103)."""
        while self._cache_bytes() > self.config.cache_size_bytes:
            victim = None
            for key in self._cache:           # OrderedDict: LRU first
                if key not in self._pinned:
                    victim = key
                    break
            if victim is None:
                return Status.success()       # everything pinned
            st = self._flush_key(victim)
            if not st.ok():
                return st
            del self._cache[victim]
            self._dirty.discard(victim)
        return Status.success()

    def _flush_key(self, key) -> Status:
        if key not in self._dirty:
            return Status.success()
        if not self.config.state_dir:
            return Status.success()
        tile = TileIndex(row=key[0], col=key[1])
        cols, rows = self._tile_dims(tile)
        return tile_state_io.write_tile_state(
            self._tile_path(tile), tile, cols, rows,
            self.config.state_floats, self.config.reduction_type,
            self._cache[key])

    # -- public API -------------------------------------------------------------

    def acquire(self, tile: TileIndex) -> np.ndarray:
        """Get the tile's state buffer (state_floats, rows, cols).

        Cache hit moves it to MRU; miss loads from disk (validated) or
        initialises to the op identity."""
        key = self._key(tile)
        if key in self._cache:
            self._hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        self._misses += 1
        cols, rows = self._tile_dims(tile)
        state = None
        path = self._tile_path(tile) if self.config.state_dir else ""
        if path and os.path.exists(path):
            out, st = tile_state_io.read_tile_state(path)
            if st.ok():
                t, fcols, frows, sf, rtype, body = out
                if (fcols == cols and frows == rows
                        and sf == self.config.state_floats
                        and ReductionType(rtype)
                        == ReductionType(self.config.reduction_type)):
                    state = body.reshape(sf, rows, cols).copy()
            # corrupt or mismatched → fall through to identity init
        if state is None:
            state = np.stack([
                np.full((rows, cols), self._info.identity[f], np.float32)
                for f in range(self.config.state_floats)])
        self._cache[key] = state
        self._evict_if_needed()
        return self._cache.get(key, state)

    def release(self, tile: TileIndex) -> None:
        """Mark a tile's state as modified (will flush on evict/flush_all)."""
        key = self._key(tile)
        if key in self._cache:
            self._dirty.add(key)

    def pin(self, tile: TileIndex) -> None:
        self._pinned.add(self._key(tile))

    def unpin(self, tile: TileIndex) -> None:
        self._pinned.discard(self._key(tile))

    def flush_all(self) -> Status:
        """Write every dirty cached tile to disk
        (reference: tile_manager.cpp:416-426)."""
        for key in list(self._dirty):
            st = self._flush_key(key)
            if not st.ok():
                return st
            self._dirty.discard(key)
        return Status.success()

    def clear_cache(self) -> None:
        """Drop the cache WITHOUT flushing (reference: reset/clear_cache)."""
        self._cache.clear()
        self._dirty.clear()

    def reset(self) -> Status:
        """Clear cache and delete all tile state files."""
        self.clear_cache()
        if self.config.state_dir and os.path.isdir(self.config.state_dir):
            for name in os.listdir(self.config.state_dir):
                if name.startswith("tile_") and name.endswith(".pcrt"):
                    try:
                        os.remove(os.path.join(self.config.state_dir, name))
                    except OSError as e:
                        return Status.error(StatusCode.IoError, str(e))
        return Status.success()

    def tile_has_state(self, tile: TileIndex) -> bool:
        """True if the tile has cached or on-disk state
        (reference: tile_manager.cpp:437-444)."""
        if self._key(tile) in self._cache:
            return True
        path = self._tile_path(tile) if self.config.state_dir else ""
        return bool(path) and os.path.exists(path)

    # -- stats -------------------------------------------------------------------

    def cache_hits(self) -> int:
        return self._hits

    def cache_misses(self) -> int:
        return self._misses

    def tiles_in_cache(self) -> int:
        return len(self._cache)

    def tiles_on_disk(self) -> int:
        if not self.config.state_dir or not os.path.isdir(self.config.state_dir):
            return 0
        return sum(1 for n in os.listdir(self.config.state_dir)
                   if n.startswith("tile_") and n.endswith(".pcrt"))

    def cache_size_bytes_used(self) -> int:
        return self._cache_bytes()

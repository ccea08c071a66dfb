"""
Grid — 2-D multi-band raster buffer.

The port's copy of pcr_tpu/core/grid.py, the rebuild of the reference Grid
(include/pcr/core/grid.h:30-96, src/core/grid.cpp). Band-major separate
allocations; Host bands are numpy arrays, Device bands are torch tensors on
one explicit torch.device (`device=`, default core.device.default_device(),
the card). The reference's Grid is host-only in practice (grid.cpp:46-49
leaves CUDA alloc TODO); this build supports real device residency via
`to(MemoryLocation.Device)`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import default_device
from .types import (
    DataType, MemoryLocation, PcrError, Status, StatusCode, TileIndex,
    np_dtype,
)
from .grid_config import GridConfig

__all__ = ["BandDesc", "Grid"]


@dataclass
class BandDesc:
    """Describes one output band or internal state band
    (reference: grid.h:14-18)."""
    name: str = ""
    dtype: DataType = DataType.Float32
    is_state: bool = False   # true = internal reduction state, not output


def _host(arr) -> np.ndarray:
    """A band as a numpy array (device tensors are copied to the host)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class Grid:
    """2-D multi-band raster buffer (row-major, band-major storage)."""

    def __init__(self):
        self._cols = 0
        self._rows = 0
        self._bands: list[BandDesc] = []
        self._data: list = []    # per-band: np.ndarray (Host) or torch.Tensor
        self._location = MemoryLocation.Host
        self._device: torch.device | None = None   # Device grids only

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """A copy of a host array on this grid's device."""
        return torch.as_tensor(np.array(host), device=self._device)

    # -- Construction ---------------------------------------------------------

    @staticmethod
    def create(cols: int, rows: int, bands,
               loc: MemoryLocation = MemoryLocation.Host,
               device=None) -> "Grid":
        if cols <= 0 or rows <= 0:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "Grid dimensions must be positive"))
        g = Grid()
        g._cols = int(cols)
        g._rows = int(rows)
        g._bands = list(bands)
        g._location = MemoryLocation(loc)
        if g._location == MemoryLocation.Device:
            g._device = torch.device(device or default_device())
        for bd in g._bands:
            arr = np.zeros((rows, cols), dtype=np_dtype(bd.dtype))
            if g._location == MemoryLocation.Device:
                arr = g._put(arr)
            g._data.append(arr)
        return g

    @staticmethod
    def create_for_tile(config: GridConfig, tile: TileIndex, bands,
                        loc: MemoryLocation = MemoryLocation.Host,
                        device=None) -> "Grid":
        _, _, col_count, row_count = config.tile_cell_range(tile)
        return Grid.create(col_count, row_count, bands, loc, device)

    # -- Band access ----------------------------------------------------------

    def num_bands(self) -> int:
        return len(self._bands)

    def band_desc(self, band_index: int) -> BandDesc:
        return self._bands[band_index]

    def band_index(self, name: str) -> int:
        for i, bd in enumerate(self._bands):
            if bd.name == name:
                return i
        return -1

    def band_array(self, band_index: int):
        """Band data as a (rows, cols) array. Host grids return the live
        numpy buffer (zero-copy, like the reference's numpy views at
        bindings.cpp:257-268); Device grids the live torch tensor."""
        return self._data[band_index]

    def set_band_array(self, band_index: int, arr, copy: bool = True) -> None:
        """Replace a band's contents. copy=False adopts a C-contiguous
        matching-dtype array zero-copy (the caller hands over ownership) —
        used by the streamed finalize to avoid re-copying a 4 MB band the
        host just assembled."""
        a = _host(arr)
        if a.shape != (self._rows, self._cols):
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                f"band array shape {a.shape} != grid ({self._rows}, {self._cols})"))
        target_dtype = np_dtype(self._bands[band_index].dtype)
        if self._location == MemoryLocation.Device:
            self._data[band_index] = self._put(a.astype(target_dtype,
                                                        copy=False))
        elif (not copy and a.dtype == target_dtype
                and a.flags.c_contiguous):
            self._data[band_index] = a
        else:
            # np.copyto casts in place; no astype temporary
            np.copyto(self._data[band_index], a)

    # -- Properties -------------------------------------------------------------

    def cols(self) -> int:
        return self._cols

    def rows(self) -> int:
        return self._rows

    def cell_count(self) -> int:
        return self._cols * self._rows

    def location(self) -> MemoryLocation:
        return self._location

    # -- Fill -------------------------------------------------------------------

    def fill(self, value: float) -> Status:
        for i in range(len(self._bands)):
            st = self.fill_band(i, value)
            if not st.ok():
                return st
        return Status.success()

    def fill_band(self, band_index: int, value: float) -> Status:
        if band_index < 0 or band_index >= len(self._bands):
            return Status.error(StatusCode.InvalidArgument,
                                f"band index {band_index} out of range")
        if self._location == MemoryLocation.Device:
            self._data[band_index].fill_(value)
        else:
            self._data[band_index].fill(value)
        return Status.success()

    # -- Transfer -----------------------------------------------------------------

    def to(self, dst: MemoryLocation, device=None) -> "Grid":
        g = Grid()
        g._cols, g._rows = self._cols, self._rows
        g._bands = [BandDesc(b.name, b.dtype, b.is_state) for b in self._bands]
        g._location = MemoryLocation(dst)
        if g._location == MemoryLocation.Device:
            g._device = torch.device(device or self._device
                                     or default_device())
        for arr in self._data:
            host = _host(arr)
            if g._location == MemoryLocation.Device:
                g._data.append(g._put(host))
            else:
                g._data.append(host.copy())
        return g

    def copy_from(self, other: "Grid") -> Status:
        if (other._cols != self._cols or other._rows != self._rows
                or other.num_bands() != self.num_bands()):
            return Status.error(StatusCode.InvalidArgument,
                                "copy_from: grid shape/band mismatch")
        for i in range(self.num_bands()):
            src = _host(other._data[i])
            if self._location == MemoryLocation.Device:
                self._data[i] = self._put(src)
            else:
                np.copyto(self._data[i], src)
        return Status.success()

    # -- Nodata mask -----------------------------------------------------------------

    def valid_mask(self, band_index: int = 0) -> np.ndarray:
        """Boolean mask: True where the cell has data (not NaN)
        (reference: grid.cpp valid_mask — examines one band)."""
        arr = _host(self._data[band_index])
        if np.issubdtype(arr.dtype, np.floating):
            return ~np.isnan(arr)
        return np.ones_like(arr, dtype=bool)

    def __repr__(self) -> str:
        names = [b.name for b in self._bands]
        return (f"Grid({self._cols}x{self._rows}, bands={names}, "
                f"loc={self._location.name})")

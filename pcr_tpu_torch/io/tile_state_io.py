"""
Tile state I/O — the "PCRT" binary checkpoint format.

The port's copy of pcr_tpu/io/tile_state_io.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Byte-compatible with the reference (src/io/tile_state_io.cpp:14-38):

    Header (36 bytes, little-endian, packed):
      magic:        uint32  0x54524350 ("PCRT")
      version:      uint32  1
      tile_row:     int32
      tile_col:     int32
      cols:         int32   tile width in cells
      rows:         int32   tile height in cells
      state_floats: int32   float fields per cell
      reduction:    uint8   ReductionType enum
      reserved:     uint8[7]
    Body:
      float32[state_floats * cols * rows]   band-sequential layout

Tile state files *are* the checkpoint/resume mechanism: dirty tiles flush
here on LRU eviction and at finalize, and a new Pipeline pointed at the same
state_dir resumes accumulation.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core.types import ReductionType, Status, StatusCode, TileIndex

__all__ = [
    "write_tile_state", "read_tile_state", "read_tile_state_header",
    "tile_state_filename",
]

_MAGIC = 0x54524350   # "PCRT" little-endian
_VERSION = 1
_HEADER_FMT = "<IIiiiiiB7x"   # 36 bytes
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 36


def tile_state_filename(directory: str, tile: TileIndex) -> str:
    """`{dir}/tile_RRRR_CCCC.pcrt` (reference: tile_state_io.cpp:197-210)."""
    name = f"tile_{tile.row:04d}_{tile.col:04d}.pcrt"
    if directory:
        return os.path.join(directory, name)
    return name


def write_tile_state(path: str, tile: TileIndex, cols: int, rows: int,
                     state_floats: int, rtype: ReductionType,
                     state: np.ndarray) -> Status:
    """Write tile state. `state` is flattened band-sequential float32 of
    length state_floats * cols * rows."""
    if cols <= 0 or rows <= 0 or state_floats <= 0:
        return Status.error(StatusCode.InvalidArgument, "invalid dimensions")
    state = np.ascontiguousarray(state, dtype=np.float32).ravel()
    expected = state_floats * cols * rows
    if state.size != expected:
        return Status.error(
            StatusCode.InvalidArgument,
            f"state size {state.size} != expected {expected}")
    header = struct.pack(_HEADER_FMT, _MAGIC, _VERSION, tile.row, tile.col,
                         cols, rows, state_floats, int(rtype))
    try:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(state.tobytes())
        os.replace(tmp, path)   # atomic publish (crash-safe checkpointing)
    except OSError as e:
        return Status.error(StatusCode.IoError,
                            f"failed to write {path}: {e}")
    return Status.success()


def _parse_header(data: bytes, path: str):
    if len(data) < _HEADER_SIZE:
        return None, Status.error(StatusCode.IoError,
                                  f"truncated header in {path}")
    magic, version, trow, tcol, cols, rows, sf, red = struct.unpack(
        _HEADER_FMT, data[:_HEADER_SIZE])
    if magic != _MAGIC:
        return None, Status.error(StatusCode.IoError,
                                  f"bad magic in {path}")
    if version != _VERSION:
        return None, Status.error(StatusCode.IoError,
                                  f"unsupported version {version} in {path}")
    if cols <= 0 or rows <= 0 or sf <= 0:
        return None, Status.error(StatusCode.IoError,
                                  f"corrupt header dims in {path}")
    return (TileIndex(row=trow, col=tcol), cols, rows, sf,
            ReductionType(red)), Status.success()


def read_tile_state_header(path: str):
    """Peek at the header. Returns ((tile, cols, rows, state_floats, rtype),
    Status)."""
    try:
        with open(path, "rb") as f:
            data = f.read(_HEADER_SIZE)
    except OSError as e:
        return None, Status.error(StatusCode.IoError,
                                  f"failed to open {path}: {e}")
    return _parse_header(data, path)


def read_tile_state(path: str):
    """Read tile state. Returns ((tile, cols, rows, state_floats, rtype,
    state float32 array), Status). Validates header before body and checks
    body size (reference: tile_manager.cpp:272-302 header-validated load)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return None, Status.error(StatusCode.IoError,
                                  f"failed to open {path}: {e}")
    hdr, st = _parse_header(data, path)
    if not st.ok():
        return None, st
    tile, cols, rows, sf, rtype = hdr
    expected_bytes = sf * cols * rows * 4
    body = data[_HEADER_SIZE:]
    if len(body) != expected_bytes:
        return None, Status.error(
            StatusCode.IoError,
            f"body size {len(body)} != expected {expected_bytes} in {path}")
    state = np.frombuffer(body, dtype="<f4").copy()
    return (tile, cols, rows, sf, rtype, state), Status.success()

"""
PointCloud — Structure-of-Arrays point cloud with named channels.

The port's copy of pcr_tpu/core/point_cloud.py, the rebuild of the
reference PointCloud (include/pcr/core/point_cloud.h:29-103,
src/core/point_cloud.cpp). Coordinates (x, y) are always Float64 for geo
precision; value/metadata channels are registered by name with any
DataType. Storage is numpy. MemoryLocation.Device is a tag, as in pcr_tpu:
the Pipeline routes a Device cloud on the host once and keeps its packed
int32/float32 chunks on the card (Pipeline.ingest), so raw float64
coordinates never need to be on the device.
"""

from __future__ import annotations

import numpy as np

from .types import (
    CRS, DataType, MemoryLocation, PcrError, Status, StatusCode, np_dtype,
)

__all__ = ["ChannelDesc", "PointCloud"]


class ChannelDesc:
    """Describes one named array in the SoA (reference: point_cloud.h:14-18)."""

    def __init__(self, name: str = "", dtype: DataType = DataType.Float32):
        self.name = name
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"ChannelDesc({self.name!r}, {DataType(self.dtype).name})"


class PointCloud:
    """SoA point cloud: x/y float64 + named typed channels."""

    def __init__(self):
        self._x: np.ndarray | None = None
        self._y: np.ndarray | None = None
        self._channels: dict[str, np.ndarray] = {}
        self._channel_order: list[str] = []
        self._count = 0
        self._capacity = 0
        self._location = MemoryLocation.Host
        self._crs = CRS()
        self._owns = True

    # -- Construction -----------------------------------------------------------

    @staticmethod
    def create(capacity: int, loc: MemoryLocation = MemoryLocation.Host) -> "PointCloud":
        pc = PointCloud()
        pc._capacity = int(capacity)
        pc._count = 0   # reference: create() leaves count at 0 (point_cloud.cpp:20)
        pc._location = MemoryLocation(loc)
        pc._x = np.zeros(capacity, dtype=np.float64)
        pc._y = np.zeros(capacity, dtype=np.float64)
        return pc

    @staticmethod
    def wrap(x: np.ndarray, y: np.ndarray,
             loc: MemoryLocation = MemoryLocation.Host) -> "PointCloud":
        """Wrap existing external SoA buffers (non-owning views)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.shape != y.shape or x.ndim != 1:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "wrap: x/y must be equal-length 1-D"))
        pc = PointCloud()
        pc._x, pc._y = x, y
        pc._count = pc._capacity = len(x)
        pc._location = MemoryLocation(loc)
        pc._owns = False
        return pc

    # -- Channel management --------------------------------------------------------

    def add_channel(self, name: str, dtype: DataType = DataType.Float32) -> None:
        if name in self._channels:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        f"channel {name!r} already exists"))
        if not name:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "channel name cannot be empty"))
        self._channels[name] = np.zeros(self._capacity, dtype=np_dtype(dtype))
        self._channel_order.append(name)

    def has_channel(self, name: str) -> bool:
        return name in self._channels

    def channel(self, name: str) -> ChannelDesc | None:
        if name not in self._channels:
            return None
        from .types import from_np_dtype
        return ChannelDesc(name, from_np_dtype(self._channels[name].dtype))

    def channel_names(self) -> list[str]:
        return list(self._channel_order)

    # -- Array access (zero-copy views, like bindings.cpp:289-388) -------------------

    def x_array(self) -> np.ndarray:
        return self._x[: self._count]

    def y_array(self) -> np.ndarray:
        return self._y[: self._count]

    def channel_array(self, name: str) -> np.ndarray:
        self._require_channel(name)
        return self._channels[name][: self._count]

    def channel_array_f32(self, name: str) -> np.ndarray:
        """Channel as float32 (casts if the stored dtype differs,
        mirroring the reference's f32-everywhere value path)."""
        self._require_channel(name)
        arr = self._channels[name][: self._count]
        if arr.dtype == np.float32:
            return arr
        return arr.astype(np.float32)

    def set_x_array(self, arr) -> None:
        a = np.asarray(arr, dtype=np.float64).ravel()
        self._ensure_capacity_for(len(a))
        self._count = len(a)   # reference resizes on set_x (bindings.cpp:338-346)
        self._x[: len(a)] = a

    def set_y_array(self, arr) -> None:
        a = np.asarray(arr, dtype=np.float64).ravel()
        if len(a) > self._capacity:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "set_y_array: exceeds capacity"))
        self._y[: len(a)] = a

    def set_channel_array_f32(self, name: str, arr) -> None:
        self._require_channel(name)
        a = np.asarray(arr).ravel()
        if len(a) > self._capacity:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "set_channel_array_f32: exceeds capacity"))
        ch = self._channels[name]
        ch[: len(a)] = a.astype(ch.dtype)

    def set_channel_array(self, name: str, arr) -> None:
        self.set_channel_array_f32(name, arr)

    def _require_channel(self, name: str) -> None:
        if name not in self._channels:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        f"channel {name!r} not found"))

    def _ensure_capacity_for(self, n: int) -> None:
        if n <= self._capacity:
            return
        # Grow coordinate + channel storage (reference errors instead; growing
        # is strictly more permissive and keeps the numpy-first API ergonomic).
        self._x = np.resize(self._x, n)
        self._y = np.resize(self._y, n)
        for k in self._channels:
            self._channels[k] = np.resize(self._channels[k], n)
        self._capacity = n

    # -- Properties -----------------------------------------------------------------

    def count(self) -> int:
        return self._count

    def capacity(self) -> int:
        return self._capacity

    def location(self) -> MemoryLocation:
        return self._location

    def crs(self) -> CRS:
        return self._crs

    def set_crs(self, crs: CRS) -> None:
        self._crs = crs

    # -- Resize -----------------------------------------------------------------------

    def resize(self, new_count: int) -> None:
        if new_count > self._capacity:
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                f"resize({new_count}) exceeds capacity {self._capacity}"))
        self._count = int(new_count)

    # -- Transfer ---------------------------------------------------------------------
    # Host↔Device transfer of the raw f64 cloud is intentionally a logical tag
    # flip: the device path never wants raw f64 coordinates on the card. The
    # ingest pipeline moves the *routed* int32 cells + f32 payloads instead
    # (Pipeline.stage).

    def to(self, dst: MemoryLocation) -> "PointCloud":
        pc = PointCloud()
        pc._x = self._x.copy()
        pc._y = self._y.copy()
        pc._channels = {k: v.copy() for k, v in self._channels.items()}
        pc._channel_order = list(self._channel_order)
        pc._count, pc._capacity = self._count, self._capacity
        pc._location = MemoryLocation(dst)
        pc._crs = self._crs
        return pc

    def to_device(self) -> "PointCloud":
        return self.to(MemoryLocation.Device)

    def to_host(self) -> "PointCloud":
        return self.to(MemoryLocation.Host)

    def __repr__(self) -> str:
        return (f"PointCloud({self._count} points, "
                f"channels={self._channel_order}, loc={self._location.name})")

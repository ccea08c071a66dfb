"""
Core scalar types, enums, geometry, CRS, status.

The port's copy of pcr_tpu/core/types.py, the rebuild of the reference's
L0 core types (reference: include/pcr/core/types.h:18-219,
src/core/types.cpp). The TPU probes and their subprocess/tunnel machinery
(pcr_tpu/core/types.py:381-566) are left out: the port's `cuda_*` probes
are in core/device.py.
The reference wraps PROJ for CRS; this build has no PROJ dependency and
implements a lightweight WKT/EPSG wrapper with the same API surface.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "DataType", "ReductionType", "MemoryLocation", "StatusCode", "Status",
    "PcrError", "BBox", "CRS", "NoDataPolicy", "TileIndex", "data_type_size",
    "np_dtype",
]


# ---------------------------------------------------------------------------
# Scalar type support — channels can hold different types
# (reference: types.h:18-26)
# ---------------------------------------------------------------------------
class DataType(enum.IntEnum):
    Float32 = 0
    Float64 = 1
    Int32 = 2
    UInt32 = 3
    Int16 = 4
    UInt16 = 5
    UInt8 = 6


_DTYPE_SIZE = {
    DataType.Float32: 4,
    DataType.Float64: 8,
    DataType.Int32: 4,
    DataType.UInt32: 4,
    DataType.Int16: 2,
    DataType.UInt16: 2,
    DataType.UInt8: 1,
}

_DTYPE_NP = {
    DataType.Float32: np.float32,
    DataType.Float64: np.float64,
    DataType.Int32: np.int32,
    DataType.UInt32: np.uint32,
    DataType.Int16: np.int16,
    DataType.UInt16: np.uint16,
    DataType.UInt8: np.uint8,
}

_NP_DTYPE = {np.dtype(v): k for k, v in _DTYPE_NP.items()}


def data_type_size(dt: DataType) -> int:
    """Size in bytes for a given DataType (reference: types.cpp:11-22)."""
    return _DTYPE_SIZE[DataType(dt)]


def np_dtype(dt: DataType):
    """numpy dtype for a given DataType."""
    return _DTYPE_NP[DataType(dt)]


def from_np_dtype(dtype) -> DataType:
    """DataType for a given numpy dtype."""
    d = np.dtype(dtype)
    if d not in _NP_DTYPE:
        raise ValueError(f"unsupported numpy dtype: {d}")
    return _NP_DTYPE[d]


# ---------------------------------------------------------------------------
# Reduction operations (reference: types.h:34-46)
# ---------------------------------------------------------------------------
class ReductionType(enum.IntEnum):
    Sum = 0
    Max = 1
    Min = 2
    Average = 3
    WeightedAverage = 4
    Count = 5
    Median = 6
    Percentile = 7      # requires percentile parameter
    MostRecent = 8      # requires timestamp channel
    PriorityMerge = 9   # keeps value with highest priority channel value
    Custom = 10         # user-provided op


# ---------------------------------------------------------------------------
# Memory location tag (reference: types.h:96-100).
# Host/HostPinned are numpy; Device is the card's memory (torch tensors).
# ---------------------------------------------------------------------------
class MemoryLocation(enum.IntEnum):
    Host = 0
    HostPinned = 1
    Device = 2


# ---------------------------------------------------------------------------
# Status / error reporting (reference: types.h:110-135)
# ---------------------------------------------------------------------------
class StatusCode(enum.IntEnum):
    Ok = 0
    InvalidArgument = 1
    OutOfMemory = 2
    CudaError = 3
    IoError = 4
    CrsError = 5
    NotImplemented = 6


@dataclass
class Status:
    code: StatusCode = StatusCode.Ok
    message: str = ""

    def ok(self) -> bool:
        return self.code == StatusCode.Ok

    def __bool__(self) -> bool:
        return self.ok()

    @staticmethod
    def success() -> "Status":
        return Status()

    @staticmethod
    def error(code: StatusCode, message: str) -> "Status":
        return Status(code, message)

    def __repr__(self) -> str:
        if self.ok():
            return "Status(Ok)"
        return f"Status({self.code.name}: {self.message})"


class PcrError(RuntimeError):
    """Raised by user-facing API methods on non-Ok Status.

    Mirrors the reference Python bindings' check_status behaviour
    (reference: python/bindings.cpp:22-26 raises RuntimeError).
    """

    def __init__(self, status: Status):
        super().__init__(f"{status.code.name}: {status.message}")
        self.status = status


def check_status(status: Status) -> None:
    if not status.ok():
        raise PcrError(status)


# ---------------------------------------------------------------------------
# Axis-aligned bounding box (2D, double precision for geo coords)
# (reference: types.h:51-64, types.cpp:28-43)
# ---------------------------------------------------------------------------
@dataclass
class BBox:
    min_x: float = float(np.finfo(np.float64).max)
    min_y: float = float(np.finfo(np.float64).max)
    max_x: float = float(-np.finfo(np.float64).max)
    max_y: float = float(-np.finfo(np.float64).max)

    def expand(self, *args) -> None:
        if len(args) == 1 and isinstance(args[0], BBox):
            other = args[0]
            if not other.valid():
                return
            self.expand(other.min_x, other.min_y)
            self.expand(other.max_x, other.max_y)
        elif len(args) == 2:
            x, y = args
            self.min_x = min(self.min_x, x)
            self.min_y = min(self.min_y, y)
            self.max_x = max(self.max_x, x)
            self.max_y = max(self.max_y, y)
        else:
            raise TypeError("expand() takes (x, y) or (BBox)")

    def contains(self, x: float, y: float) -> bool:
        return (self.min_x <= x <= self.max_x) and (self.min_y <= y <= self.max_y)

    def width(self) -> float:
        return self.max_x - self.min_x

    def height(self) -> float:
        return self.max_y - self.min_y

    def valid(self) -> bool:
        return self.max_x >= self.min_x and self.max_y >= self.min_y

    def __repr__(self) -> str:
        return (f"BBox({self.min_x}, {self.min_y}, {self.max_x}, {self.max_y})")


# ---------------------------------------------------------------------------
# Coordinate Reference System — lightweight WKT/EPSG wrapper.
#
# The reference wraps PROJ (types.cpp:49-168). This environment has no PROJ;
# we keep the same API with a small built-in catalogue of common CRSs plus
# structural WKT parsing, which covers the reference's usage (tests use
# EPSG:3857/4326/32110 and WKT round-trips).
# ---------------------------------------------------------------------------

def _utm_wkt(epsg: int) -> str | None:
    """Generate WKT2 for WGS84 UTM zones (EPSG:326xx north / 327xx south)."""
    if 32601 <= epsg <= 32660:
        zone, south = epsg - 32600, False
    elif 32701 <= epsg <= 32760:
        zone, south = epsg - 32700, True
    else:
        return None
    lon0 = -183 + 6 * zone
    hemi = "S" if south else "N"
    fn = 10000000.0 if south else 0.0
    return (
        f'PROJCRS["WGS 84 / UTM zone {zone}{hemi}",'
        f'BASEGEOGCRS["WGS 84",DATUM["World Geodetic System 1984",'
        f'ELLIPSOID["WGS 84",6378137,298.257223563]]],'
        f'CONVERSION["UTM zone {zone}{hemi}",'
        f'METHOD["Transverse Mercator"],'
        f'PARAMETER["Latitude of natural origin",0],'
        f'PARAMETER["Longitude of natural origin",{lon0}],'
        f'PARAMETER["Scale factor at natural origin",0.9996],'
        f'PARAMETER["False easting",500000],'
        f'PARAMETER["False northing",{fn}]],'
        f'CS[Cartesian,2],AXIS["easting",east],AXIS["northing",north],'
        f'LENGTHUNIT["metre",1],ID["EPSG",{epsg}]]'
    )


_WKT_CATALOG = {
    4326: (
        'GEOGCRS["WGS 84",DATUM["World Geodetic System 1984",'
        'ELLIPSOID["WGS 84",6378137,298.257223563]],'
        'CS[ellipsoidal,2],AXIS["latitude",north],AXIS["longitude",east],'
        'ANGLEUNIT["degree",0.0174532925199433],ID["EPSG",4326]]'
    ),
    3857: (
        'PROJCRS["WGS 84 / Pseudo-Mercator",'
        'BASEGEOGCRS["WGS 84",DATUM["World Geodetic System 1984",'
        'ELLIPSOID["WGS 84",6378137,298.257223563]]],'
        'CONVERSION["Popular Visualisation Pseudo-Mercator",'
        'METHOD["Popular Visualisation Pseudo Mercator"]],'
        'CS[Cartesian,2],AXIS["easting",east],AXIS["northing",north],'
        'LENGTHUNIT["metre",1],ID["EPSG",3857]]'
    ),
    32110: (
        'PROJCRS["NAD83 / New Hampshire",'
        'BASEGEOGCRS["NAD83",DATUM["North American Datum 1983",'
        'ELLIPSOID["GRS 1980",6378137,298.257222101]]],'
        'CONVERSION["SPCS83 New Hampshire zone",'
        'METHOD["Transverse Mercator"]],'
        'CS[Cartesian,2],AXIS["easting",east],AXIS["northing",north],'
        'LENGTHUNIT["metre",1],ID["EPSG",32110]]'
    ),
}


def _epsg_from_wkt(wkt: str) -> int:
    """Extract trailing ID["EPSG", code] / AUTHORITY["EPSG","code"] if present."""
    import re

    matches = re.findall(r'ID\s*\[\s*"EPSG"\s*,\s*(\d+)\s*\]', wkt)
    if matches:
        return int(matches[-1])
    matches = re.findall(r'AUTHORITY\s*\[\s*"EPSG"\s*,\s*"(\d+)"\s*\]', wkt)
    if matches:
        return int(matches[-1])
    return 0


@dataclass
class CRS:
    wkt: str = ""       # WKT string (authoritative)
    epsg: int = 0       # EPSG code if known, 0 = unknown

    def is_valid(self) -> bool:
        return bool(self.wkt) or self.epsg != 0

    def is_projected(self) -> bool:
        if "PROJCS" in self.wkt or "PROJCRS" in self.wkt:
            return True
        if self.wkt:
            return False
        # EPSG-only: geographic codes are 4xxx 2D lat/lon; treat the common
        # geographic range as not projected, everything else as projected.
        return self.epsg != 0 and not self.is_geographic()

    def is_geographic(self) -> bool:
        if "GEOGCS" in self.wkt or "GEOGCRS" in self.wkt:
            # A projected CRS embeds a BASEGEOGCRS/GEOGCS — check it is not
            # wrapped in a PROJCRS.
            return not ("PROJCS" in self.wkt or "PROJCRS" in self.wkt)
        if self.wkt:
            return False
        return self.epsg in (4326, 4269, 4267, 4258, 4283, 4759)

    @staticmethod
    def from_epsg(code: int) -> "CRS":
        if code <= 0:
            raise PcrError(Status.error(StatusCode.CrsError,
                                        f"invalid EPSG code: {code}"))
        wkt = _WKT_CATALOG.get(code) or _utm_wkt(code)
        if wkt is None:
            # Unknown to the catalogue — keep a minimal but valid WKT husk so
            # round-trips preserve the code.
            wkt = f'PROJCRS["EPSG:{code}",ID["EPSG",{code}]]'
        return CRS(wkt=wkt, epsg=code)

    @staticmethod
    def from_wkt(wkt_str: str) -> "CRS":
        if not wkt_str or not wkt_str.strip():
            raise PcrError(Status.error(StatusCode.CrsError, "empty WKT"))
        head = wkt_str.lstrip()
        known = ("PROJCRS", "PROJCS", "GEOGCRS", "GEOGCS", "COMPD_CS",
                 "COMPOUNDCRS", "LOCAL_CS", "ENGCRS", "BOUNDCRS", "VERT_CS")
        if not head.startswith(known):
            raise PcrError(Status.error(StatusCode.CrsError,
                                        "unrecognised WKT string"))
        return CRS(wkt=wkt_str, epsg=_epsg_from_wkt(wkt_str))

    def equivalent_to(self, other: "CRS") -> bool:
        if not self.is_valid() or not other.is_valid():
            return False
        if self.epsg and other.epsg:
            return self.epsg == other.epsg
        a = "".join(self.wkt.split())
        b = "".join(other.wkt.split())
        return a == b and bool(a)

    def __repr__(self) -> str:
        if self.epsg:
            return f"CRS(EPSG:{self.epsg})"
        return f"CRS(wkt={self.wkt[:40]!r}...)" if self.wkt else "CRS(invalid)"


# ---------------------------------------------------------------------------
# Nodata policy (reference: types.h:86-91)
# ---------------------------------------------------------------------------
@dataclass
class NoDataPolicy:
    value: float = math.nan
    use_nan: bool = True

    def sentinel(self) -> float:
        return math.nan if self.use_nan else self.value


# ---------------------------------------------------------------------------
# Tile index (row, col within tile grid) (reference: types.h:105-114)
# ---------------------------------------------------------------------------
@dataclass(frozen=True, order=False)
class TileIndex:
    row: int = 0
    col: int = 0

    def __lt__(self, o: "TileIndex") -> bool:
        return self.row < o.row or (self.row == o.row and self.col < o.col)

    def __repr__(self) -> str:
        return f"TileIndex(row={self.row}, col={self.col})"

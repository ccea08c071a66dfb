"""
Point-cloud file I/O — PCRP binary, CSV, LAS, plus a streaming reader.

The port's copy of pcr_tpu/io/point_cloud_io.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Formats match the reference (include/pcr/io/point_cloud_io.h:14-99,
src/io/point_cloud_io.cpp):

  * **PCRP** v1 binary SoA (byte-compatible): header {magic 0x50524350,
    version u32=1, num_points u64, num_channels u32, crs_wkt_len u32,
    crs_wkt, channel table of {name_len u16, name, dtype u8}}, body x f64[n],
    y f64[n], then each channel [n] in table order — designed for
    seek-based chunked streaming.
  * **CSV** with an `x,y[,channel...]` header row, 15 significant digits.
  * **LAS** 1.0-1.4: implemented natively here with numpy (point formats
    0-10, uncompressed) — the reference's C++ core stubs LAS out
    (point_cloud_io.cpp:478-491) and shells out to Python laspy in scripts;
    this build reads LAS directly. X/Y are descaled to world doubles;
    intensity / classification / gps_time / z become channels.
  * **LAZ**: read via the optional laspy[lazrs] dependency (the LASzip
    stream needs an arithmetic decoder); everything else has no
    third-party requirements. A native LAS 1.2 writer (point format 1)
    round-trips through the reader.

Format auto-detection follows point_cloud_io.cpp:25-46: extension first,
then PCRP magic sniff, defaulting to CSV.
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..core.point_cloud import ChannelDesc, PointCloud
from ..core.types import (
    BBox, CRS, DataType, PcrError, Status, StatusCode, np_dtype,
)

__all__ = ["PointCloudFormat", "PointCloudInfo", "read_point_cloud",
           "write_point_cloud", "read_point_cloud_info", "PointCloudReader",
           "detect_format"]

_MAGIC_PCRP = 0x50524350


class PointCloudFormat(enum.IntEnum):
    PCR_Binary = 0
    CSV = 1
    LAS = 2
    LAZ = 3
    Auto = 4


@dataclass
class PointCloudInfo:
    num_points: int = 0
    channels: list = dc_field(default_factory=list)
    crs: CRS = dc_field(default_factory=CRS)
    bounds: BBox = dc_field(default_factory=BBox)


def detect_format(path: str) -> PointCloudFormat:
    lower = path.lower()
    if lower.endswith(".pcrp"):
        return PointCloudFormat.PCR_Binary
    if lower.endswith(".csv"):
        return PointCloudFormat.CSV
    if lower.endswith(".las"):
        return PointCloudFormat.LAS
    if lower.endswith(".laz"):
        return PointCloudFormat.LAZ
    try:
        with open(path, "rb") as f:
            magic = struct.unpack("<I", f.read(4))[0]
        if magic == _MAGIC_PCRP:
            return PointCloudFormat.PCR_Binary
    except (OSError, struct.error):
        pass
    return PointCloudFormat.CSV


# ---------------------------------------------------------------------------
# PCRP binary
# ---------------------------------------------------------------------------

def _pcrp_header_bytes(cloud: PointCloud) -> bytes:
    wkt = cloud.crs().wkt.encode()
    names = cloud.channel_names()
    out = struct.pack("<IIQII", _MAGIC_PCRP, 1, cloud.count(), len(names),
                      len(wkt))
    out += wkt
    for name in names:
        desc = cloud.channel(name)
        nb = name.encode()
        out += struct.pack("<H", len(nb)) + nb + struct.pack(
            "<B", int(desc.dtype))
    return out


def _parse_pcrp_header(f):
    head = f.read(24)
    if len(head) < 24:
        raise PcrError(Status.error(StatusCode.IoError, "truncated PCRP header"))
    magic, version, n, nch, wkt_len = struct.unpack("<IIQII", head)
    if magic != _MAGIC_PCRP:
        raise PcrError(Status.error(StatusCode.IoError, "bad PCRP magic"))
    if version != 1:
        raise PcrError(Status.error(StatusCode.IoError,
                                    f"unsupported PCRP version {version}"))
    wkt = f.read(wkt_len).decode()
    channels = []
    for _ in range(nch):
        (nl,) = struct.unpack("<H", f.read(2))
        name = f.read(nl).decode()
        (dt,) = struct.unpack("<B", f.read(1))
        channels.append(ChannelDesc(name, DataType(dt)))
    crs = CRS(wkt=wkt) if wkt else CRS()
    if wkt:
        from ..core.types import _epsg_from_wkt
        crs.epsg = _epsg_from_wkt(wkt)
    return n, channels, crs, f.tell()


def _write_pcrp(path: str, cloud: PointCloud) -> Status:
    try:
        with open(path, "wb") as f:
            f.write(_pcrp_header_bytes(cloud))
            f.write(np.ascontiguousarray(
                cloud.x_array(), dtype="<f8").tobytes())
            f.write(np.ascontiguousarray(
                cloud.y_array(), dtype="<f8").tobytes())
            for name in cloud.channel_names():
                arr = cloud.channel_array(name)
                f.write(np.ascontiguousarray(arr).tobytes())
    except OSError as e:
        return Status.error(StatusCode.IoError, f"write PCRP failed: {e}")
    return Status.success()


def _read_pcrp(path: str) -> PointCloud:
    with open(path, "rb") as f:
        n, channels, crs, body_off = _parse_pcrp_header(f)
        cloud = PointCloud.create(n)
        cloud.set_crs(crs)
        x = np.frombuffer(f.read(8 * n), dtype="<f8")
        y = np.frombuffer(f.read(8 * n), dtype="<f8")
        cloud.set_x_array(x)
        cloud.set_y_array(y)
        for ch in channels:
            dt = np_dtype(ch.dtype)
            nb = np.dtype(dt).itemsize * n
            arr = np.frombuffer(f.read(nb), dtype=dt)
            cloud.add_channel(ch.name, ch.dtype)
            cloud.set_channel_array_f32(ch.name, arr)
    return cloud


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def _write_csv(path: str, cloud: PointCloud) -> Status:
    names = cloud.channel_names()
    cols = [cloud.x_array(), cloud.y_array()]
    for name in names:
        cols.append(cloud.channel_array(name))
    try:
        with open(path, "w") as f:
            f.write(",".join(["x", "y"] + names) + "\n")
            for i in range(cloud.count()):
                f.write(",".join(_fmt_csv(c[i]) for c in cols) + "\n")
    except OSError as e:
        return Status.error(StatusCode.IoError, f"write CSV failed: {e}")
    return Status.success()


def _fmt_csv(v) -> str:
    if isinstance(v, (np.floating, float)):
        return f"{float(v):.15g}"
    return str(v)


def _read_csv_header(path: str):
    with open(path) as f:
        header = f.readline().strip()
    if not header:
        raise PcrError(Status.error(StatusCode.IoError, "empty CSV file"))
    cols = [c.strip() for c in header.split(",")]
    if len(cols) < 2 or cols[0] != "x" or cols[1] != "y":
        raise PcrError(Status.error(StatusCode.IoError,
                                    "CSV must start with x,y header"))
    return cols


def _read_csv(path: str) -> PointCloud:
    cols = _read_csv_header(path)
    try:
        data = np.genfromtxt(path, delimiter=",", skip_header=1,
                             dtype=np.float64, ndmin=2)
    except ValueError as e:
        raise PcrError(Status.error(StatusCode.IoError, f"corrupt CSV: {e}"))
    if data.size == 0:
        data = data.reshape(0, len(cols))
    if data.shape[1] != len(cols):
        raise PcrError(Status.error(StatusCode.IoError,
                                    "CSV column count mismatch"))
    if np.isnan(data[:, :2]).any():
        raise PcrError(Status.error(StatusCode.IoError,
                                    "corrupt CSV: non-numeric coordinates"))
    n = data.shape[0]
    cloud = PointCloud.create(n)
    cloud.set_x_array(data[:, 0])
    cloud.set_y_array(data[:, 1])
    for i, name in enumerate(cols[2:], start=2):
        cloud.add_channel(name, DataType.Float32)
        cloud.set_channel_array_f32(name, data[:, i].astype(np.float32))
    return cloud


# ---------------------------------------------------------------------------
# LAS (native numpy reader; reference stubs this out)
# ---------------------------------------------------------------------------

# Fixed-size leading fields per LAS point format (x, y, z always first)
_LAS_PDRF_SIZE = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63,
                  6: 30, 7: 36, 8: 38, 9: 59, 10: 67}


@dataclass
class _LasHeader:
    version: tuple
    point_offset: int
    point_format: int
    point_size: int
    num_points: int
    scale: tuple
    offset: tuple
    bounds: BBox


def _read_las_header(f) -> _LasHeader:
    f.seek(0)
    raw = f.read(375)
    if raw[:4] != b"LASF":
        raise PcrError(Status.error(StatusCode.IoError, "not a LAS file"))
    ver = (raw[24], raw[25])
    point_offset = struct.unpack("<I", raw[96:100])[0]
    pdrf = raw[104]
    if pdrf >= 128:
        raise PcrError(Status.error(StatusCode.NotImplemented,
                                    "LAZ (compressed LAS) is not supported"))
    point_size = struct.unpack("<H", raw[105:107])[0]
    legacy_n = struct.unpack("<I", raw[107:111])[0]
    sx, sy, sz = struct.unpack("<3d", raw[131:155])
    ox, oy, oz = struct.unpack("<3d", raw[155:179])
    max_x, min_x, max_y, min_y, _, _ = struct.unpack("<6d", raw[179:227])
    n = legacy_n
    if ver >= (1, 4) and len(raw) >= 255:
        n14 = struct.unpack("<Q", raw[247:255])[0]
        if n14:
            n = n14
    b = BBox()
    b.min_x, b.max_x, b.min_y, b.max_y = min_x, max_x, min_y, max_y
    return _LasHeader(ver, point_offset, pdrf, point_size, n,
                      (sx, sy, sz), (ox, oy, oz), b)


def _las_record_dtype(h: _LasHeader) -> np.dtype:
    pf = h.point_format
    if pf not in _LAS_PDRF_SIZE:
        raise PcrError(Status.error(StatusCode.NotImplemented,
                                    f"LAS point format {pf} not supported"))
    fields = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
              ("intensity", "<u2")]
    if pf >= 6:
        fields += [("flags1", "u1"), ("flags2", "u1"),
                   ("classification", "u1"), ("user_data", "u1"),
                   ("scan_angle", "<i2"), ("point_source", "<u2"),
                   ("gps_time", "<f8")]
    else:
        fields += [("flags", "u1"), ("classification", "u1"),
                   ("scan_angle", "i1"), ("user_data", "u1"),
                   ("point_source", "<u2")]
        if pf in (1, 3, 4, 5):
            fields += [("gps_time", "<f8")]
    known = np.dtype(fields)
    if known.itemsize < h.point_size:
        fields += [("extra", f"V{h.point_size - known.itemsize}")]
    return np.dtype(fields)


def _read_las(path: str, max_points: int | None = None,
              skip: int = 0) -> PointCloud:
    with open(path, "rb") as f:
        h = _read_las_header(f)
        dt = _las_record_dtype(h)
        n = h.num_points - skip
        if max_points is not None:
            n = min(n, max_points)
        n = max(n, 0)
        f.seek(h.point_offset + skip * h.point_size)
        raw = f.read(n * h.point_size)
        rec = np.frombuffer(raw, dtype=dt, count=n)
    cloud = PointCloud.create(n)
    cloud.set_x_array(rec["X"] * h.scale[0] + h.offset[0])
    cloud.set_y_array(rec["Y"] * h.scale[1] + h.offset[1])
    cloud.add_channel("z", DataType.Float32)
    cloud.set_channel_array_f32(
        "z", (rec["Z"] * h.scale[2] + h.offset[2]).astype(np.float32))
    cloud.add_channel("intensity", DataType.Float32)
    cloud.set_channel_array_f32("intensity",
                                rec["intensity"].astype(np.float32))
    cloud.add_channel("classification", DataType.Float32)
    cls = rec["classification"].astype(np.float32)
    if h.point_format < 6:
        cls = (rec["classification"] & 0x1F).astype(np.float32)
    cloud.set_channel_array_f32("classification", cls)
    if "gps_time" in rec.dtype.names:
        cloud.add_channel("gps_time", DataType.Float32)
        cloud.set_channel_array_f32("gps_time",
                                    rec["gps_time"].astype(np.float32))
    return cloud


def _write_las(path: str, cloud: PointCloud) -> Status:
    """Native LAS 1.2 writer (point format 1: xyz + intensity + gps_time).

    Coordinates are quantized with a scale derived from the extent (so the
    int32 range is never exceeded); z comes from the 'z' channel when
    present, intensity/classification/gps_time likewise. Round-trips
    through _read_las."""
    n = cloud.count()
    x = np.asarray(cloud.x_array(), np.float64)
    y = np.asarray(cloud.y_array(), np.float64)

    def chan(name):
        return (np.asarray(cloud.channel_array_f32(name), np.float64)
                if cloud.has_channel(name) else np.zeros(n))

    z = chan("z")

    def scale_for(lo, hi):
        ext = max(hi - lo, 1e-9)
        s = 10.0 ** np.ceil(np.log10(ext / 2**31))
        return max(float(s), 1e-8)

    mins = [float(a.min()) if n else 0.0 for a in (x, y, z)]
    maxs = [float(a.max()) if n else 0.0 for a in (x, y, z)]
    scales = [scale_for(lo, hi) for lo, hi in zip(mins, maxs)]

    dt = np.dtype([("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
                   ("intensity", "<u2"), ("flags", "u1"),
                   ("classification", "u1"), ("scan_angle", "i1"),
                   ("user_data", "u1"), ("point_source", "<u2"),
                   ("gps_time", "<f8")])
    rec = np.zeros(n, dt)
    for name, a, s, o in (("X", x, scales[0], mins[0]),
                          ("Y", y, scales[1], mins[1]),
                          ("Z", z, scales[2], mins[2])):
        rec[name] = np.round((a - o) / s).astype(np.int64).astype(np.int32)
    rec["intensity"] = np.clip(chan("intensity"), 0, 65535).astype(np.uint16)
    rec["classification"] = np.clip(chan("classification"),
                                    0, 31).astype(np.uint8)
    rec["gps_time"] = chan("gps_time")

    hdr = bytearray(227)
    hdr[0:4] = b"LASF"
    hdr[24] = 1
    hdr[25] = 2
    hdr[26:58] = b"pcr-tpu".ljust(32, b"\x00")
    hdr[58:90] = b"pcr_tpu point_cloud_io".ljust(32, b"\x00")
    struct.pack_into("<H", hdr, 94, 227)        # header size
    struct.pack_into("<I", hdr, 96, 227)        # point data offset
    struct.pack_into("<I", hdr, 100, 0)         # VLR count
    hdr[104] = 1                                # point format 1
    struct.pack_into("<H", hdr, 105, dt.itemsize)
    struct.pack_into("<I", hdr, 107, n)
    struct.pack_into("<I", hdr, 111, n)         # points by return[0]
    struct.pack_into("<3d", hdr, 131, *scales)
    struct.pack_into("<3d", hdr, 155, *mins)    # offsets
    struct.pack_into("<6d", hdr, 179, maxs[0], mins[0], maxs[1], mins[1],
                     maxs[2], mins[2])
    try:
        with open(path, "wb") as f:
            f.write(bytes(hdr))
            f.write(rec.tobytes())
    except OSError as e:
        return Status.error(StatusCode.IoError, f"write_las: {e}")
    return Status.success()


def _read_laz(path: str) -> PointCloud:
    """LAZ via the optional laspy[lazrs] dependency (the compressed LASzip
    stream needs an arithmetic decoder; LAS itself is read natively)."""
    try:
        import laspy
    except ImportError:
        raise PcrError(Status.error(
            StatusCode.NotImplemented,
            "LAZ input needs the optional 'laspy' + 'lazrs' packages "
            "(pip install laspy[lazrs]); uncompressed LAS reads natively"))
    las = laspy.read(path)
    n = len(las.points)
    cloud = PointCloud.create(n)
    cloud.set_x_array(np.asarray(las.x, np.float64))
    cloud.set_y_array(np.asarray(las.y, np.float64))
    cloud.add_channel("z", DataType.Float32)
    cloud.set_channel_array_f32("z", np.asarray(las.z, np.float32))
    for name in ("intensity", "classification", "gps_time"):
        if hasattr(las, name):
            cloud.add_channel(name, DataType.Float32)
            cloud.set_channel_array_f32(
                name, np.asarray(las[name], np.float32))
    return cloud


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def read_point_cloud(path: str,
                     format: PointCloudFormat = PointCloudFormat.Auto
                     ) -> PointCloud:
    if not os.path.exists(path):
        raise PcrError(Status.error(StatusCode.IoError,
                                    f"file not found: {path}"))
    fmt = detect_format(path) if format == PointCloudFormat.Auto else format
    fmt = PointCloudFormat(fmt)
    if fmt == PointCloudFormat.PCR_Binary:
        return _read_pcrp(path)
    if fmt == PointCloudFormat.CSV:
        return _read_csv(path)
    if fmt == PointCloudFormat.LAS:
        return _read_las(path)
    if fmt == PointCloudFormat.LAZ:
        return _read_laz(path)
    raise PcrError(Status.error(StatusCode.InvalidArgument,
                                f"unknown format {format}"))


def write_point_cloud(path: str, cloud: PointCloud,
                      format: PointCloudFormat = PointCloudFormat.PCR_Binary
                      ) -> Status:
    fmt = detect_format(path) if format == PointCloudFormat.Auto else format
    fmt = PointCloudFormat(fmt)
    if fmt == PointCloudFormat.PCR_Binary:
        return _write_pcrp(path, cloud)
    if fmt == PointCloudFormat.CSV:
        return _write_csv(path, cloud)
    if fmt == PointCloudFormat.LAS:
        return _write_las(path, cloud)
    return Status.error(StatusCode.NotImplemented,
                        f"writing format {fmt.name} is not supported")


def read_point_cloud_info(path: str,
                          format: PointCloudFormat = PointCloudFormat.Auto
                          ) -> PointCloudInfo:
    if not os.path.exists(path):
        raise PcrError(Status.error(StatusCode.IoError,
                                    f"file not found: {path}"))
    fmt = detect_format(path) if format == PointCloudFormat.Auto else format
    fmt = PointCloudFormat(fmt)
    info = PointCloudInfo()
    if fmt == PointCloudFormat.PCR_Binary:
        with open(path, "rb") as f:
            n, channels, crs, _ = _parse_pcrp_header(f)
        info.num_points = n
        info.channels = channels
        info.crs = crs
    elif fmt == PointCloudFormat.CSV:
        cols = _read_csv_header(path)
        with open(path) as f:
            info.num_points = sum(1 for line in f if line.strip()) - 1
        info.channels = [ChannelDesc(c, DataType.Float32) for c in cols[2:]]
    elif fmt in (PointCloudFormat.LAS, PointCloudFormat.LAZ):
        with open(path, "rb") as f:
            h = _read_las_header(f)
        info.num_points = h.num_points
        names = ["z", "intensity", "classification"]
        if h.point_format in (1, 3, 4, 5) or h.point_format >= 6:
            names.append("gps_time")
        info.channels = [ChannelDesc(n, DataType.Float32) for n in names]
        info.bounds = h.bounds
    else:
        raise PcrError(Status.error(StatusCode.InvalidArgument,
                                    f"unknown format {format}"))
    return info


# ---------------------------------------------------------------------------
# Streaming reader (reference: point_cloud_io.h:75-99, seek-based chunking)
# ---------------------------------------------------------------------------

class PointCloudReader:
    """Chunked reader for PCRP / CSV / LAS.

    read_chunk(cloud, max_points) fills `cloud` with up to max_points and
    returns the number read (0 at EOF)."""

    def __init__(self, path: str, fmt: PointCloudFormat):
        self._path = path
        self._fmt = fmt
        self._info = read_point_cloud_info(path, fmt)
        self._pos = 0
        self._csv_file = None
        if fmt == PointCloudFormat.CSV:
            self._csv_cols = _read_csv_header(path)
            self._csv_file = open(path)
            self._csv_file.readline()   # skip header
        elif fmt == PointCloudFormat.PCR_Binary:
            with open(path, "rb") as f:
                n, channels, crs, body = _parse_pcrp_header(f)
            self._pcrp_body = body
            self._pcrp_channels = channels

    @staticmethod
    def open(path: str,
             format: PointCloudFormat = PointCloudFormat.Auto
             ) -> "PointCloudReader":
        if not os.path.exists(path):
            raise PcrError(Status.error(StatusCode.IoError,
                                        f"file not found: {path}"))
        fmt = (detect_format(path) if format == PointCloudFormat.Auto
               else PointCloudFormat(format))
        if fmt == PointCloudFormat.LAZ:
            raise PcrError(Status.error(StatusCode.NotImplemented,
                                        "LAZ streaming is not supported"))
        return PointCloudReader(path, fmt)

    def info(self) -> PointCloudInfo:
        return self._info

    def eof(self) -> bool:
        return self._pos >= self._info.num_points

    def rewind(self) -> Status:
        self._pos = 0
        if self._csv_file is not None:
            self._csv_file.seek(0)
            self._csv_file.readline()
        return Status.success()

    def read_chunk(self, cloud: PointCloud, max_points: int) -> int:
        if self.eof():
            return 0
        n = min(max_points, self._info.num_points - self._pos,
                cloud.capacity())
        if n <= 0:
            return 0
        if self._fmt == PointCloudFormat.PCR_Binary:
            self._read_chunk_pcrp(cloud, n)
        elif self._fmt == PointCloudFormat.CSV:
            n = self._read_chunk_csv(cloud, n)
        else:
            chunk = _read_las(self._path, max_points=n, skip=self._pos)
            _copy_into(chunk, cloud)
            n = chunk.count()
        self._pos += n
        return n

    def _read_chunk_pcrp(self, cloud: PointCloud, n: int):
        total = self._info.num_points
        with open(self._path, "rb") as f:
            f.seek(self._pcrp_body + 8 * self._pos)
            x = np.frombuffer(f.read(8 * n), dtype="<f8")
            f.seek(self._pcrp_body + 8 * total + 8 * self._pos)
            y = np.frombuffer(f.read(8 * n), dtype="<f8")
            cloud.set_x_array(x)
            cloud.set_y_array(y)
            cloud.set_crs(self._info.crs)
            off = self._pcrp_body + 16 * total
            for ch in self._pcrp_channels:
                isize = np.dtype(np_dtype(ch.dtype)).itemsize
                f.seek(off + isize * self._pos)
                arr = np.frombuffer(f.read(isize * n),
                                    dtype=np_dtype(ch.dtype))
                if not cloud.has_channel(ch.name):
                    cloud.add_channel(ch.name, ch.dtype)
                cloud.set_channel_array_f32(ch.name, arr)
                off += isize * total

    def _read_chunk_csv(self, cloud: PointCloud, n: int) -> int:
        rows = []
        for _ in range(n):
            line = self._csv_file.readline()
            if not line:
                break
            if not line.strip():
                continue
            rows.append([float(v) for v in line.strip().split(",")])
        if not rows:
            return 0
        data = np.asarray(rows, dtype=np.float64)
        cloud.set_x_array(data[:, 0])
        cloud.set_y_array(data[:, 1])
        for i, name in enumerate(self._csv_cols[2:], start=2):
            if not cloud.has_channel(name):
                cloud.add_channel(name, DataType.Float32)
            cloud.set_channel_array_f32(name, data[:, i].astype(np.float32))
        return len(rows)


def _copy_into(src: PointCloud, dst: PointCloud):
    dst.set_x_array(src.x_array())
    dst.set_y_array(src.y_array())
    for name in src.channel_names():
        if not dst.has_channel(name):
            dst.add_channel(name, src.channel(name).dtype)
        dst.set_channel_array_f32(name, src.channel_array(name))

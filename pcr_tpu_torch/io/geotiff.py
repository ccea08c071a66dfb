"""
GeoTIFF I/O — pure-Python TIFF/BigTIFF codec with GeoTIFF tags.

The port's copy of pcr_tpu/io/geotiff.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

The reference uses GDAL (src/io/grid_io.cpp:39-370); this environment has no
GDAL/rasterio, so the writer/reader are implemented from scratch:

  * classic TIFF and BigTIFF (auto-selected when data exceeds 4 GB and
    options.bigtiff allows it)
  * float32 bands, planar configuration 2 (band-sequential, like GDAL)
  * tiled layout (default 256x256, grid_io.h:21-22) or strips when
    tile_width == 0
  * compression: NONE, DEFLATE (zlib), ZSTD (if the zstandard module is
    available), and a real TIFF LZW codec (MSB-first, early-change)
  * GeoTIFF tags: ModelPixelScale, ModelTiepoint, GeoKeyDirectory with
    EPSG code, CRS WKT in GTCitation ASCII params
  * GDAL interop tags: GDAL_NODATA ("nan"), band descriptions via
    GDAL_METADATA XML
  * COG overviews: reduced-resolution IFDs with 2x average resampling
    (grid_io.cpp BuildOverviews analogue)

Supported for reading: everything this module writes, which is what the
pipeline/tests need (round-trips, parity comparison, resume inspection).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from ..core.grid import BandDesc, Grid
from ..core.grid_config import GridConfig
from ..core.types import (
    BBox, CRS, DataType, MemoryLocation, PcrError, Status, StatusCode,
)

__all__ = ["GeoTiffOptions", "write_geotiff", "read_geotiff_info",
           "read_geotiff_band", "TiledGeoTiffWriter",
           "StreamingGeoTiffWriter"]


@dataclass
class GeoTiffOptions:
    """GeoTIFF write options (reference: grid_io.h:16-24)."""
    cloud_optimized: bool = False
    compress: str = "LZW"          # NONE, LZW, DEFLATE, ZSTD
    compress_level: int = 6
    tile_width: int = 256          # 0 = stripped
    tile_height: int = 256
    bigtiff: bool = True           # allow BigTIFF when size requires it
    overview_resampling: str = "average"


# ---------------------------------------------------------------------------
# TIFF constants
# ---------------------------------------------------------------------------

T_IMAGEWIDTH = 256
T_IMAGELENGTH = 257
T_BITSPERSAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_IMAGEDESCRIPTION = 270
T_STRIPOFFSETS = 273
T_SAMPLESPERPIXEL = 277
T_ROWSPERSTRIP = 278
T_STRIPBYTECOUNTS = 279
T_PLANARCONFIG = 284
T_PREDICTOR = 317
T_NEWSUBFILETYPE = 254
T_TILEWIDTH = 322
T_TILELENGTH = 323
T_TILEOFFSETS = 324
T_TILEBYTECOUNTS = 325
T_SAMPLEFORMAT = 339
T_MODELPIXELSCALE = 33550
T_MODELTIEPOINT = 33922
T_GEOKEYDIRECTORY = 34735
T_GEODOUBLEPARAMS = 34736
T_GEOASCIIPARAMS = 34737
T_GDAL_METADATA = 42112
T_GDAL_NODATA = 42113

TYPE_BYTE, TYPE_ASCII, TYPE_SHORT, TYPE_LONG = 1, 2, 3, 4
TYPE_RATIONAL, TYPE_SBYTE, TYPE_UNDEF, TYPE_SSHORT = 5, 6, 7, 8
TYPE_SLONG, TYPE_SRATIONAL, TYPE_FLOAT, TYPE_DOUBLE = 9, 10, 11, 12
TYPE_LONG8, TYPE_SLONG8, TYPE_IFD8 = 16, 17, 18

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8, 18: 8}

COMP_NONE, COMP_LZW, COMP_DEFLATE_ADOBE, COMP_DEFLATE = 1, 5, 8, 32946
COMP_ZSTD = 50000


# ---------------------------------------------------------------------------
# TIFF LZW codec (MSB-first bit order, early-change, per TIFF6 spec)
# ---------------------------------------------------------------------------

_CLEAR, _EOI = 256, 257


def lzw_encode(data: bytes) -> bytes:
    out = bytearray()
    bitbuf = 0
    nbits = 0
    code_width = 9

    def emit(code):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << code_width) | code
        nbits += code_width
        while nbits >= 8:
            nbits -= 8
            out.append((bitbuf >> nbits) & 0xFF)
        bitbuf &= (1 << nbits) - 1   # keep the buffer a small int

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(_CLEAR)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
        else:
            emit(table[w])
            table[wc] = next_code
            next_code += 1
            # Width/reset points verified against libtiff (Pillow reads
            # the output; round 5 — the previous rule was one step early
            # at every boundary and standard readers rejected the
            # streams): widen when the next code to assign reaches
            # 2^width, reset one entry before the 12-bit table fills.
            if next_code >= 4094:
                emit(_CLEAR)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                code_width = 9
            elif next_code == (1 << code_width) and code_width < 12:
                code_width += 1
            w = bytes([ch])
    if w:
        emit(table[w])
    emit(_EOI)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def lzw_decode(data: bytes, legacy: bool = False) -> bytes:
    """TIFF LZW decode. `legacy=True` replays the pre-round-5 width rule
    (one step early at every boundary) so GeoTIFFs written by older
    releases of this library still read back; standard streams (libtiff,
    GDAL, this writer since round 5) use the default rule."""
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    code_width = 9
    bitbuf = 0
    nbits = 0
    prev: bytes | None = None
    pos = 0
    n = len(data)
    bump = 2 if legacy else 1
    while True:
        while nbits < code_width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= code_width
        code = (bitbuf >> nbits) & ((1 << code_width) - 1)
        bitbuf &= (1 << nbits) - 1   # keep the buffer a small int
        if code == _EOI:
            return bytes(out)
        if code == _CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            code_width = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            # beyond KwKwK: not decodable under this width rule (a
            # legacy-flavor stream desyncing, or corruption) — return
            # short so _decompress can try the legacy rule
            return bytes(out)
        out += entry
        prev = entry
        # Early change, lag-corrected: the decoder's table is one entry
        # behind the encoder's next_code at emission time, so bump at -1
        # where the encoder bumps at 2^width (verified against libtiff
        # streams; round 5).
        if len(table) >= (1 << code_width) - bump and code_width < 12:
            code_width += 1


# ---------------------------------------------------------------------------
# Compression dispatch
# ---------------------------------------------------------------------------

def _compress(data: bytes, compress: str, level: int):
    c = (compress or "NONE").upper()
    if c in ("NONE", ""):
        return data, COMP_NONE
    if c == "DEFLATE":
        return zlib.compress(data, level), COMP_DEFLATE_ADOBE
    if c == "LZW":
        from .. import native
        if native.available():
            return native.lzw_encode(data), COMP_LZW
        return lzw_encode(data), COMP_LZW
    if c == "ZSTD":
        try:
            import zstandard
            return zstandard.ZstdCompressor(level=level).compress(data), COMP_ZSTD
        except ImportError:
            # graceful degradation: deflate is universally readable
            return zlib.compress(data, level), COMP_DEFLATE_ADOBE
    raise PcrError(Status.error(StatusCode.InvalidArgument,
                                f"unknown compression {compress!r}"))


def _decompress(data: bytes, comp_id: int, expected: int = 0) -> bytes:
    if comp_id == COMP_NONE:
        return data
    if comp_id in (COMP_DEFLATE_ADOBE, COMP_DEFLATE):
        return zlib.decompress(data)
    if comp_id == COMP_LZW:
        from .. import native
        out = None
        if native.available() and expected:
            try:
                out = native.lzw_decode(data, expected)
            except RuntimeError:
                # misparse (e.g. a legacy-flavor stream desyncing past a
                # width boundary) — retry with the Python decoders below
                out = None
        if out is None:
            out = lzw_decode(data)
        if expected and len(out) < expected:
            # pre-round-5 flavor of this library's own writer (early
            # width bumps); standard streams never hit this path
            out = lzw_decode(data, legacy=True)
        return out
    if comp_id == COMP_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(data)
    raise PcrError(Status.error(StatusCode.IoError,
                                f"unsupported TIFF compression id {comp_id}"))


# ---------------------------------------------------------------------------
# Low-level TIFF file builder (little-endian; classic or BigTIFF)
# ---------------------------------------------------------------------------

class _TiffBuilder:
    def __init__(self, f, big: bool):
        self.f = f
        self.big = big
        self.ifd_patch_pos = None   # where to write "offset of next IFD"
        if big:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
            self.ifd_patch_pos = 8
        else:
            f.write(struct.pack("<2sHI", b"II", 42, 0))
            self.ifd_patch_pos = 4

    def tell(self):
        return self.f.tell()

    def write_raw(self, data: bytes) -> int:
        off = self.f.tell()
        self.f.write(data)
        if self.f.tell() % 2:
            self.f.write(b"\x00")
        return off

    def write_ifd(self, entries: list):
        """entries: list of (tag, type, values | bytes). Values arrays
        exceeding the inline slot are written to the heap after the IFD."""
        entries = sorted(entries, key=lambda e: e[0])
        f, big = self.f, self.big
        inline = 8 if big else 4
        entry_size = 20 if big else 12

        # first pass: compute heap placement
        ifd_off = f.tell()
        if ifd_off % 2:
            f.write(b"\x00")
            ifd_off += 1
        count_size = 8 if big else 2
        next_size = 8 if big else 4
        heap_off = ifd_off + count_size + entry_size * len(entries) + next_size

        packed = []
        heap = bytearray()
        for tag, typ, values in entries:
            if isinstance(values, (bytes, bytearray)):
                data = bytes(values)
                count = len(data)
            else:
                vals = list(values)
                count = len(vals)
                fmt = {TYPE_SHORT: "H", TYPE_LONG: "I", TYPE_DOUBLE: "d",
                       TYPE_FLOAT: "f", TYPE_LONG8: "Q",
                       TYPE_SLONG: "i"}[typ]
                data = struct.pack(f"<{count}{fmt}", *vals)
            if len(data) <= inline:
                packed.append((tag, typ, count, data.ljust(inline, b"\x00")))
            else:
                pos = heap_off + len(heap)
                heap += data
                if len(heap) % 2:
                    heap += b"\x00"
                ptr = struct.pack("<Q" if big else "<I", pos)
                packed.append((tag, typ, count, ptr))

        # patch previous next-IFD pointer to point here
        cur = f.tell()
        f.seek(self.ifd_patch_pos)
        f.write(struct.pack("<Q" if big else "<I", ifd_off))
        f.seek(cur)

        if big:
            f.write(struct.pack("<Q", len(entries)))
            for tag, typ, count, data in packed:
                f.write(struct.pack("<HHQ", tag, typ, count))
                f.write(data)
            self.ifd_patch_pos = f.tell()
            f.write(struct.pack("<Q", 0))
        else:
            f.write(struct.pack("<H", len(entries)))
            for tag, typ, count, data in packed:
                f.write(struct.pack("<HHI", tag, typ, count))
                f.write(data)
            self.ifd_patch_pos = f.tell()
            f.write(struct.pack("<I", 0))
        f.write(bytes(heap))


def _geo_entries(config: GridConfig):
    """GeoTIFF + GDAL tags from a GridConfig."""
    entries = []
    gt = config.gdal_geotransform()
    entries.append((T_MODELPIXELSCALE, TYPE_DOUBLE,
                    [abs(gt[1]), abs(gt[5]), 0.0]))
    entries.append((T_MODELTIEPOINT, TYPE_DOUBLE,
                    [0.0, 0.0, 0.0, gt[0], gt[3], 0.0]))
    crs = config.crs
    keys = []
    ascii_params = ""
    model_type = 1 if crs.is_projected() else 2
    keys.append((1024, 0, 1, model_type))      # GTModelTypeGeoKey
    keys.append((1025, 0, 1, 1))               # GTRasterTypeGeoKey=PixelIsArea
    if crs.wkt:
        ascii_params = crs.wkt.replace("|", " ") + "|"
        keys.append((1026, T_GEOASCIIPARAMS, len(ascii_params), 0))
    if crs.epsg:
        if crs.is_geographic():
            keys.append((2048, 0, 1, crs.epsg))   # GeographicTypeGeoKey
        else:
            keys.append((3072, 0, 1, crs.epsg))   # ProjectedCSTypeGeoKey
    header = [1, 1, 0, len(keys)]
    for k in keys:
        header.extend(k)
    entries.append((T_GEOKEYDIRECTORY, TYPE_SHORT, header))
    if ascii_params:
        entries.append((T_GEOASCIIPARAMS, TYPE_ASCII,
                        ascii_params.encode() + b"\x00"))
    return entries


def _gdal_metadata_xml(band_names: list[str]) -> bytes:
    items = "".join(
        f'<Item name="DESCRIPTION" sample="{i}" role="description">{n}</Item>'
        for i, n in enumerate(band_names))
    return (f"<GDALMetadata>{items}</GDALMetadata>").encode() + b"\x00"


def _tile_grid(width, height, tw, th):
    return ((width + tw - 1) // tw, (height + th - 1) // th)


def _write_band_tiles(builder, band: np.ndarray, tw, th, compress, level):
    """Write one band's tiles to the heap; return (offsets, bytecounts).

    Tiles are independent compression streams, and every codec used here
    (native LZW via ctypes, zlib, zstd) releases the GIL — so encode them
    concurrently and write sequentially in tile order."""
    h, w = band.shape
    tiles_x, tiles_y = _tile_grid(w, h, tw, th)
    raws = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile = np.zeros((th, tw), dtype="<f4")
            ys, xs = ty * th, tx * tw
            ye, xe = min(ys + th, h), min(xs + tw, w)
            tile[: ye - ys, : xe - xs] = band[ys:ye, xs:xe]
            raws.append(tile.tobytes())
    enc = lambda raw: _compress(raw, compress, level)[0]
    workers = min(8, len(raws), os.cpu_count() or 1)
    if workers > 1 and (compress or "NONE").upper() != "NONE":
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            encoded = list(pool.map(enc, raws))
    else:
        encoded = [enc(raw) for raw in raws]
    offsets, counts = [], []
    for data in encoded:
        offsets.append(builder.write_raw(data))
        counts.append(len(data))
    return offsets, counts


def _write_ifd_for_image(builder, bands: list[np.ndarray], band_names,
                         config: GridConfig | None, options: GeoTiffOptions,
                         reduced: bool = False):
    """Write the data + one IFD for a (possibly reduced-resolution) image."""
    h, w = bands[0].shape
    nb = len(bands)
    tw = options.tile_width
    th = options.tile_height
    tiled = tw > 0 and th > 0
    _, comp_id = _compress(b"", options.compress, options.compress_level)

    offsets, counts = [], []
    if tiled:
        for b in bands:
            o, c = _write_band_tiles(builder, b, tw, th, options.compress,
                                     options.compress_level)
            offsets += o
            counts += c
    else:
        for b in bands:
            raw = np.ascontiguousarray(b, dtype="<f4").tobytes()
            data, _ = _compress(raw, options.compress,
                                options.compress_level)
            offsets.append(builder.write_raw(data))
            counts.append(len(data))

    _write_image_ifd(builder, w, h, nb, comp_id, tiled, offsets, counts,
                     band_names, config, options, reduced)


def _write_image_ifd(builder, w, h, nb, comp_id, tiled, offsets, counts,
                     band_names, config, options, reduced=False):
    """Write one image IFD given already-written tile/strip data."""
    off_type = TYPE_LONG8 if builder.big else TYPE_LONG
    entries = [
        (T_IMAGEWIDTH, TYPE_LONG, [w]),
        (T_IMAGELENGTH, TYPE_LONG, [h]),
        (T_BITSPERSAMPLE, TYPE_SHORT, [32] * nb),
        (T_COMPRESSION, TYPE_SHORT, [comp_id]),
        (T_PHOTOMETRIC, TYPE_SHORT, [1]),       # BlackIsZero
        (T_SAMPLESPERPIXEL, TYPE_SHORT, [nb]),
        (T_PLANARCONFIG, TYPE_SHORT, [2]),      # planar (band-sequential)
        (T_SAMPLEFORMAT, TYPE_SHORT, [3] * nb),  # IEEE float
        (T_GDAL_NODATA, TYPE_ASCII, b"nan\x00"),
    ]
    if tiled:
        entries += [
            (T_TILEWIDTH, TYPE_SHORT, [options.tile_width]),
            (T_TILELENGTH, TYPE_SHORT, [options.tile_height]),
            (T_TILEOFFSETS, off_type, offsets),
            (T_TILEBYTECOUNTS, off_type, counts),
        ]
    else:
        entries += [
            (T_ROWSPERSTRIP, TYPE_LONG, [h]),
            (T_STRIPOFFSETS, off_type, offsets),
            (T_STRIPBYTECOUNTS, off_type, counts),
        ]
    if reduced:
        entries.append((T_NEWSUBFILETYPE, TYPE_LONG, [1]))
    if config is not None:
        entries += _geo_entries(config)
    if band_names:
        entries.append((T_GDAL_METADATA, TYPE_ASCII,
                        _gdal_metadata_xml(band_names)))
    builder.write_ifd(entries)


def write_geotiff(path: str, grid: Grid, config: GridConfig,
                  options: GeoTiffOptions | None = None) -> Status:
    """Write a complete Grid to GeoTIFF (reference: grid_io.cpp:39-180).

    Band names are embedded as GDAL band descriptions; per-band NoData is
    NaN; COG mode appends averaged overview levels.
    """
    options = options or GeoTiffOptions()
    if grid.location() != MemoryLocation.Host:
        return Status.error(StatusCode.InvalidArgument,
                            "write_geotiff: grid must be on Host")
    if grid.num_bands() == 0:
        return Status.error(StatusCode.InvalidArgument,
                            "write_geotiff: grid has no bands")
    bands = [np.asarray(grid.band_array(i), dtype=np.float32)
             for i in range(grid.num_bands())]
    names = [grid.band_desc(i).name for i in range(grid.num_bands())]

    data_bytes = sum(b.nbytes for b in bands)
    big = options.bigtiff and data_bytes > (3 << 30)

    try:
        with open(path, "wb") as f:
            builder = _TiffBuilder(f, big)
            _write_ifd_for_image(builder, bands, names, config, options)
            if options.cloud_optimized:
                level = bands
                while min(level[0].shape) > 256:
                    level = [_downsample2x(b, options.overview_resampling)
                             for b in level]
                    _write_ifd_for_image(builder, level, [], None, options,
                                         reduced=True)
    except OSError as e:
        return Status.error(StatusCode.IoError,
                            f"write_geotiff: {e}")
    return Status.success()


def _downsample2x(band: np.ndarray, resampling: str) -> np.ndarray:
    h, w = band.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    padded = np.full((h2 * 2, w2 * 2), np.nan, dtype=np.float32)
    padded[:h, :w] = band
    q = padded.reshape(h2, 2, w2, 2)
    if resampling.lower() in ("nearest",):
        return q[:, 0, :, 0]
    with np.errstate(invalid="ignore"):
        return np.nanmean(q, axis=(1, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Incremental tiled writer (reference: grid_io.cpp:188-370)
# ---------------------------------------------------------------------------

class TiledGeoTiffWriter:
    """Open → write_tile (any order, once per tile) → close.

    Tile data is `data[band][row][col]` band-sequential float32 of the
    *grid config* tile size; edge tiles pass their clamped size region.
    Tiles never written stay NaN (nodata).
    """

    def __init__(self, path: str, config: GridConfig,
                 band_names: list[str], options: GeoTiffOptions):
        self._path = path
        self._config = config
        self._names = list(band_names)
        self._options = options
        # Assemble in memory; spill-to-disk assembly arrives with the
        # out-of-core TileManager integration.
        self._bands = [np.full((config.height, config.width), np.nan,
                               dtype=np.float32) for _ in band_names]
        self._closed = False

    @staticmethod
    def open(path: str, config: GridConfig, band_names,
             options: GeoTiffOptions | None = None) -> "TiledGeoTiffWriter":
        st = config.validate()
        if not st.ok():
            raise PcrError(st)
        if not band_names:
            raise PcrError(Status.error(StatusCode.InvalidArgument,
                                        "TiledGeoTiffWriter: no bands"))
        return TiledGeoTiffWriter(path, config, band_names,
                                  options or GeoTiffOptions())

    def write_tile(self, tile, data: np.ndarray, num_bands: int) -> Status:
        if self._closed:
            return Status.error(StatusCode.InvalidArgument,
                                "writer is closed")
        if num_bands != len(self._names):
            return Status.error(StatusCode.InvalidArgument,
                                "band count mismatch")
        cs, rs, cc, rc = self._config.tile_cell_range(tile)
        if cc <= 0 or rc <= 0:
            return Status.error(StatusCode.InvalidArgument,
                                "tile outside grid")
        arr = np.asarray(data, dtype=np.float32).reshape(num_bands, rc, cc)
        for b in range(num_bands):
            self._bands[b][rs:rs + rc, cs:cs + cc] = arr[b]
        return Status.success()

    def close(self) -> Status:
        if self._closed:
            return Status.success()
        g = Grid.create(self._config.width, self._config.height,
                        [BandDesc(name=n, dtype=DataType.Float32)
                         for n in self._names])
        for i, b in enumerate(self._bands):
            g.set_band_array(i, b)
        st = write_geotiff(self._path, g, self._config, self._options)
        self._closed = True
        return st


# ---------------------------------------------------------------------------
# Streaming writer: encode row strips as they arrive
# ---------------------------------------------------------------------------

class StreamingGeoTiffWriter:
    """Write a tiled planar GeoTIFF incrementally from row strips.

    Purpose: encode a band's tiles as its rows arrive, so that a caller
    producing a band in row strips overlaps its work with the compression
    (the TIFF layout puts tile data first and the IFD last, so nothing
    needs to be known up front). It writes the bytes write_geotiff writes;
    the Pipeline's finalize, which holds whole bands, uses write_geotiff.

    Contract: bands are delivered in order (0..nb-1); within a band, rows
    arrive in order via `write_rows`. The internal buffer slices rows into
    `options.tile_height`-row runs of tiles. Call `end_band()` after each
    band's final rows, then `close()` to write the IFD (and COG overviews
    if requested — those need the full bands, pass them to close()).
    """

    def __init__(self, path: str, config: GridConfig, band_names,
                 options: GeoTiffOptions | None = None):
        self._options = options or GeoTiffOptions()
        if not (self._options.tile_width > 0 and self._options.tile_height > 0):
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                "StreamingGeoTiffWriter requires a tiled layout"))
        self._config = config
        self._names = list(band_names)
        self._w, self._h = config.width, config.height
        nbytes = len(self._names) * self._w * self._h * 4
        big = self._options.bigtiff and nbytes > (3 << 30)
        self._f = open(path, "wb")
        self._builder = _TiffBuilder(self._f, big)
        self._offsets: list[int] = []
        self._counts: list[int] = []
        self._band = 0
        self._row = 0
        self._buf: list[np.ndarray] = []
        self._buf_rows = 0
        self._closed = False

    def write_rows(self, rows: np.ndarray) -> None:
        """Append rows to the current band (float32, shape (k, width))."""
        rows = np.asarray(rows, dtype=np.float32)
        self._buf.append(rows)
        self._buf_rows += rows.shape[0]
        self._row += rows.shape[0]
        th = self._options.tile_height
        while self._buf_rows >= th:
            strip = np.concatenate(self._buf, axis=0) if len(self._buf) > 1 \
                else self._buf[0]
            self._encode_strip(strip[:th])
            rest = strip[th:]
            self._buf = [rest] if rest.shape[0] else []
            self._buf_rows = rest.shape[0]

    def end_band(self) -> None:
        if self._row != self._h:
            raise PcrError(Status.error(
                StatusCode.InvalidArgument,
                f"band {self._band}: got {self._row} rows, "
                f"expected {self._h}"))
        if self._buf_rows:
            strip = (np.concatenate(self._buf, axis=0)
                     if len(self._buf) > 1 else self._buf[0])
            self._encode_strip(strip)
            self._buf, self._buf_rows = [], 0
        self._band += 1
        self._row = 0

    def _encode_strip(self, strip: np.ndarray) -> None:
        tw = self._options.tile_width
        th = self._options.tile_height
        k, w = strip.shape
        tiles_x = (self._w + tw - 1) // tw
        for tx in range(tiles_x):
            tile = np.zeros((th, tw), dtype="<f4")
            xs = tx * tw
            xe = min(xs + tw, w)
            tile[:k, : xe - xs] = strip[:, xs:xe]
            data, _ = _compress(tile.tobytes(), self._options.compress,
                                self._options.compress_level)
            self._offsets.append(self._builder.write_raw(data))
            self._counts.append(len(data))

    def close(self, overview_bands=None) -> Status:
        """Write the IFD(s). `overview_bands` (full-resolution (H, W) arrays
        in band order) are required only for cloud_optimized output."""
        if self._closed:
            return Status.success()
        try:
            if self._band != len(self._names):
                return Status.error(
                    StatusCode.InvalidArgument,
                    f"wrote {self._band} bands, expected {len(self._names)}")
            _, comp_id = _compress(b"", self._options.compress,
                                   self._options.compress_level)
            _write_image_ifd(self._builder, self._w, self._h,
                             len(self._names), comp_id, True,
                             self._offsets, self._counts, self._names,
                             self._config, self._options)
            if self._options.cloud_optimized and overview_bands is not None:
                level = [np.asarray(b, np.float32) for b in overview_bands]
                while min(level[0].shape) > 256:
                    level = [_downsample2x(b,
                                           self._options.overview_resampling)
                             for b in level]
                    _write_ifd_for_image(self._builder, level, [], None,
                                         self._options, reduced=True)
            self._f.close()
        except OSError as e:
            return Status.error(StatusCode.IoError,
                                f"StreamingGeoTiffWriter: {e}")
        finally:
            self._closed = True
        return Status.success()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class _TiffImage:
    width: int
    height: int
    samples: int
    compression: int
    planar: int
    tile_w: int            # 0 if stripped
    tile_h: int
    offsets: list
    counts: list
    rows_per_strip: int
    pixel_scale: tuple | None
    tiepoint: tuple | None
    geokeys: list
    ascii_params: str
    subfile_type: int
    sample_format: int
    bits: int
    predictor: int = 1


def _read_ifds(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"II":
        raise PcrError(Status.error(StatusCode.IoError,
                                    "only little-endian TIFF supported"))
    version = struct.unpack("<H", data[2:4])[0]
    big = version == 43
    if big:
        next_off = struct.unpack("<Q", data[8:16])[0]
    elif version == 42:
        next_off = struct.unpack("<I", data[4:8])[0]
    else:
        raise PcrError(Status.error(StatusCode.IoError, "not a TIFF file"))

    images = []
    while next_off:
        tags = {}
        pos = next_off
        if big:
            n = struct.unpack("<Q", data[pos:pos + 8])[0]
            pos += 8
            entry_size, inline = 20, 8
        else:
            n = struct.unpack("<H", data[pos:pos + 2])[0]
            pos += 2
            entry_size, inline = 12, 4
        for i in range(n):
            e = data[pos + i * entry_size: pos + (i + 1) * entry_size]
            if big:
                tag, typ, count = struct.unpack("<HHQ", e[:12])
                payload = e[12:20]
            else:
                tag, typ, count = struct.unpack("<HHI", e[:8])
                payload = e[8:12]
            size = _TYPE_SIZE.get(typ, 1) * count
            if size <= inline:
                raw = payload[:size]
            else:
                off = struct.unpack("<Q" if big else "<I", payload)[0]
                raw = data[off:off + size]
            tags[tag] = _decode_tag(typ, count, raw)
        pos_next = pos + n * entry_size
        next_off = struct.unpack("<Q" if big else "<I",
                                 data[pos_next:pos_next + (8 if big else 4)])[0]
        images.append(_image_from_tags(tags))
    return images, data


def _decode_tag(typ, count, raw):
    fmts = {TYPE_BYTE: "B", TYPE_SHORT: "H", TYPE_LONG: "I",
            TYPE_SLONG: "i", TYPE_FLOAT: "f", TYPE_DOUBLE: "d",
            TYPE_LONG8: "Q", TYPE_SLONG8: "q", TYPE_IFD8: "Q",
            TYPE_SSHORT: "h", TYPE_SBYTE: "b"}
    if typ == TYPE_ASCII:
        return raw.rstrip(b"\x00").decode("latin1")
    if typ in (TYPE_UNDEF,):
        return raw
    fmt = fmts.get(typ)
    if fmt is None:
        return raw
    vals = struct.unpack(f"<{count}{fmt}", raw[:_TYPE_SIZE[typ] * count])
    return list(vals)


def _image_from_tags(t):
    def one(tag, default=None):
        v = t.get(tag, default)
        if isinstance(v, list):
            return v[0]
        return v

    return _TiffImage(
        width=int(one(T_IMAGEWIDTH, 0)),
        height=int(one(T_IMAGELENGTH, 0)),
        samples=int(one(T_SAMPLESPERPIXEL, 1)),
        compression=int(one(T_COMPRESSION, COMP_NONE)),
        planar=int(one(T_PLANARCONFIG, 1)),
        tile_w=int(one(T_TILEWIDTH, 0)),
        tile_h=int(one(T_TILELENGTH, 0)),
        offsets=t.get(T_TILEOFFSETS, t.get(T_STRIPOFFSETS, [])),
        counts=t.get(T_TILEBYTECOUNTS, t.get(T_STRIPBYTECOUNTS, [])),
        rows_per_strip=int(one(T_ROWSPERSTRIP, 0)),
        pixel_scale=t.get(T_MODELPIXELSCALE),
        tiepoint=t.get(T_MODELTIEPOINT),
        geokeys=t.get(T_GEOKEYDIRECTORY, []),
        ascii_params=t.get(T_GEOASCIIPARAMS, ""),
        subfile_type=int(one(T_NEWSUBFILETYPE, 0)),
        sample_format=int(one(T_SAMPLEFORMAT, 1)),
        bits=int(one(T_BITSPERSAMPLE, 32)),
        predictor=int(one(T_PREDICTOR, 1)),
    )


def _crs_from_geokeys(img: _TiffImage) -> CRS:
    crs = CRS()
    keys = img.geokeys
    for i in range(4, len(keys), 4):
        key_id, loc, count, value = keys[i:i + 4]
        if key_id in (3072, 2048) and loc == 0:
            crs.epsg = int(value)
        if key_id == 1026 and loc == T_GEOASCIIPARAMS:
            s = img.ascii_params
            crs.wkt = s.split("|")[0] if "|" in s else s
    if crs.epsg and not crs.wkt:
        try:
            crs = CRS.from_epsg(crs.epsg)
        except PcrError:
            pass
    return crs


def read_geotiff_info(path: str):
    """Returns (width, height, num_bands, crs, bounds)
    (reference: grid_io.h:72-75)."""
    if not os.path.exists(path):
        raise PcrError(Status.error(StatusCode.IoError,
                                    f"file not found: {path}"))
    images, _ = _read_ifds(path)
    main = [im for im in images if im.subfile_type == 0]
    img = main[0] if main else images[0]
    crs = _crs_from_geokeys(img)
    bounds = BBox()
    if img.pixel_scale and img.tiepoint:
        sx, sy = img.pixel_scale[0], img.pixel_scale[1]
        ox, oy = img.tiepoint[3], img.tiepoint[4]
        bounds.min_x = ox
        bounds.max_x = ox + img.width * sx
        bounds.max_y = oy
        bounds.min_y = oy - img.height * sy
    return img.width, img.height, img.samples, crs, bounds


# SampleFormat (tag 339) x BitsPerSample (tag 258) -> numpy dtype.
# 1 = unsigned int, 2 = signed int, 3 = IEEE float (TIFF 6.0 §19).
_SAMPLE_DTYPES = {
    (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
    (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
    (3, 32): np.float32, (3, 64): np.float64,
}


def _decode_chunk(raw: bytes, rows: int, width: int, samples: int,
                  img: "_TiffImage", dtype) -> np.ndarray:
    """Decode one decompressed tile/strip into (rows, width, samples).

    Handles the horizontal-differencing predictor (tag 317 = 2, the GDAL
    LZW default for integer rasters: each sample is stored as the delta
    to the previous pixel's same channel along the row) and the
    floating-point predictor (317 = 3, TIFF TechNote 3: the row's value
    bytes are split into MSB-first byte planes, then delta-coded as a
    byte stream). Integer cumsum wraps modulo 2^bits, matching the
    encoder's modular differencing."""
    itemsize = np.dtype(dtype).itemsize
    n = width * samples
    expected = rows * n * itemsize
    if img.predictor == 3:
        b = np.frombuffer(raw[:expected], np.uint8).reshape(
            rows, n * itemsize)
        acc = np.cumsum(b, axis=1, dtype=np.uint8)
        planes = acc.reshape(rows, itemsize, n)
        # plane 0 holds each value's MSB; reorder to little-endian bytes
        interleaved = np.ascontiguousarray(
            planes[:, ::-1, :].transpose(0, 2, 1))
        a = interleaved.view(np.dtype(dtype).newbyteorder("<"))
        return a.reshape(rows, width, samples)
    a = np.frombuffer(raw[:expected],
                      np.dtype(dtype).newbyteorder("<")).reshape(
        rows, width, samples)
    if img.predictor == 2:
        a = np.cumsum(a, axis=1, dtype=a.dtype)
    return a


def read_geotiff_band(path: str, band_index: int) -> np.ndarray:
    """Read one band (0-based) as a (height, width) float32 array
    (reference: grid_io.h:77-80; GDAL reads any driver flavor,
    grid_io.cpp:372-497 — this reader covers the common GeoTIFF
    envelope: chunky or band-sequential planar config, strips (any
    rows-per-strip) or tiles, uint8/16/32, int8/16/32, float32/64
    samples, LZW/DEFLATE/ZSTD/none compression, horizontal and
    floating-point predictors)."""
    images, data = _read_ifds(path)
    main = [im for im in images if im.subfile_type == 0]
    img = main[0] if main else images[0]
    if band_index < 0 or band_index >= img.samples:
        raise PcrError(Status.error(StatusCode.InvalidArgument,
                                    f"band index {band_index} out of range"))
    if img.planar not in (1, 2):
        raise PcrError(Status.error(
            StatusCode.NotImplemented,
            f"unsupported TIFF planar configuration {img.planar}"))
    dtype = _SAMPLE_DTYPES.get((img.sample_format, img.bits))
    if dtype is None:
        raise PcrError(Status.error(
            StatusCode.NotImplemented,
            f"unsupported TIFF sample format {img.sample_format} with "
            f"{img.bits} bits per sample"))
    itemsize = np.dtype(dtype).itemsize
    chunky = img.planar == 1 and img.samples > 1
    spc = img.samples if chunky else 1         # samples per chunk pixel
    sel = band_index if chunky else 0
    out = np.empty((img.height, img.width), dtype=np.float32)
    if img.tile_w:
        tiles_x, tiles_y = _tile_grid(img.width, img.height,
                                      img.tile_w, img.tile_h)
        per_band = tiles_x * tiles_y
        base = 0 if chunky or img.samples == 1 else band_index * per_band
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                k = base + ty * tiles_x + tx
                off, cnt = int(img.offsets[k]), int(img.counts[k])
                raw = _decompress(data[off:off + cnt], img.compression,
                                  img.tile_h * img.tile_w * spc * itemsize)
                tile = _decode_chunk(raw, img.tile_h, img.tile_w, spc,
                                     img, dtype)[:, :, sel]
                ys, xs = ty * img.tile_h, tx * img.tile_w
                ye = min(ys + img.tile_h, img.height)
                xe = min(xs + img.tile_w, img.width)
                out[ys:ye, xs:xe] = tile[: ye - ys, : xe - xs]
    else:
        rps = img.rows_per_strip or img.height
        nstrips = -(-img.height // rps)
        base = 0 if chunky or img.samples == 1 else band_index * nstrips
        for s in range(nstrips):
            ys = s * rps
            rows = min(rps, img.height - ys)
            off = int(img.offsets[base + s])
            cnt = int(img.counts[base + s])
            raw = _decompress(data[off:off + cnt], img.compression,
                              rows * img.width * spc * itemsize)
            out[ys:ys + rows] = _decode_chunk(
                raw, rows, img.width, spc, img, dtype)[:, :, sel]
    return out

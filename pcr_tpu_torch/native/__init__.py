"""
Native host kernels — ctypes loader with on-demand compilation.

The port's copy of pcr_tpu/native/__init__.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

The shared library is built from router.cpp with g++ -O3 -fopenmp on first
use, into the port's own git-ignored build directory `pcr_tpu_torch/_build/`
as `pcr_torch_router_<source hash>.so` (pcr_tpu builds its copy elsewhere
under another name, so the two packages never load one file); if no
compiler is available, callers fall back to the vectorized numpy paths
(routing.py checks `available()`). Set PCR_NATIVE=0 to force the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["available", "lib", "assign", "assign_cells", "fractional_cells",
           "gauss_wire_exact", "gauss_wire_words", "line_endpoints",
           "lzw_encode", "lzw_decode", "rotp_counts", "rotp_place",
           "set_num_threads", "tile_presence"]

_LIB = None
_TRIED = False


def _src_path() -> str:
    return os.path.join(os.path.dirname(__file__), "router.cpp")


def _build(src: str, out: str) -> bool:
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    tmp = f"{out}.{os.getpid()}.tmp"
    for omp in (["-fopenmp"], []):
        try:
            subprocess.run(["g++", *flags, *omp, src, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)   # a concurrent loader sees all or none
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            continue
    return False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PCR_NATIVE", "1") == "0":
        return None
    src = _src_path()
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(os.path.dirname(os.path.dirname(src)), "_build")
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return None
    out = os.path.join(cache, f"pcr_torch_router_{digest}.so")
    if not os.path.exists(out):
        if not _build(src, out):
            return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None

    d = ctypes.POINTER(ctypes.c_double)
    f = ctypes.POINTER(ctypes.c_float)
    i = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.pcr_assign.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 8 + [ctypes.c_int32] * 2 + [i, i, u8]
    lib.pcr_tile_presence.argtypes = [i, i, u8, ctypes.c_int64] + \
        [ctypes.c_int32] * 4 + [u8]
    lib.pcr_tile_presence.restype = None
    lib.pcr_assign_cells.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 8 + [ctypes.c_int32] * 3 + [i]
    lib.pcr_fractional_cells.argtypes = [d, d, ctypes.c_int64] + \
        [ctypes.c_double] * 4 + [i, i, f, f]
    lib.pcr_native_version.restype = ctypes.c_int
    lib.pcr_native_threads.restype = ctypes.c_int
    u8c = ctypes.POINTER(ctypes.c_uint8)
    lib.pcr_lzw_encode.argtypes = [u8c, ctypes.c_int64, u8c, ctypes.c_int64]
    lib.pcr_lzw_encode.restype = ctypes.c_int64
    lib.pcr_lzw_decode.argtypes = [u8c, ctypes.c_int64, u8c, ctypes.c_int64]
    lib.pcr_lzw_decode.restype = ctypes.c_int64
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.pcr_bucket_nsub.argtypes = [i, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32]
    lib.pcr_bucket_nsub.restype = ctypes.c_int64
    lib.pcr_bucket_layout.argtypes = [i, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int64, i64, i]
    lib.pcr_pack_sub_major.argtypes = [
        i64, i64, ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(
            ctypes.c_int32)), i, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, i]
    lib.pcr_pack_quad_major.argtypes = lib.pcr_pack_sub_major.argtypes
    lib.pcr_pack_point_wire.argtypes = [
        i, i, u8, f, f, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i]
    lib.pcr_line_runs_count.argtypes = [i, i, i, i, u8, ctypes.c_int64]
    lib.pcr_line_runs_count.restype = ctypes.c_int64
    lib.pcr_line_runs_emit.argtypes = [i, i, i, i, u8] + [i] * 4 + \
        [ctypes.c_int64] + [i] * 5
    lib.pcr_line_runs_emit.restype = ctypes.c_int64
    lib.pcr_gauss_wire_exact.argtypes = [
        d, d, u8, f, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i]
    lib.pcr_gauss_wire_exact.restype = ctypes.c_int32
    lib.pcr_line_endpoints.argtypes = [
        d, d, ctypes.c_int64, u8,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i, i, i, i64]
    lib.pcr_rotp_counts.argtypes = [f, f, f, f, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, i]
    lib.pcr_rotp_place.argtypes = [f, f, f, f, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, i64, i,
                                   ctypes.c_int32, ctypes.c_int32,
                                   i64, ctypes.c_int64]
    lib.pcr_fin_avg.argtypes = [f, f, f, ctypes.c_int64]
    lib.pcr_fin_sentinel.argtypes = [f, f, ctypes.c_int64, ctypes.c_float]
    lib.pcr_fin_count.argtypes = [f, f, ctypes.c_int64]
    lib.pcr_set_num_threads.argtypes = [ctypes.c_int]
    lib.pcr_set_num_threads.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def lib():
    return _load()


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def assign(cfg, x: np.ndarray, y: np.ndarray):
    """Native world→cell assignment. Returns (col, row, valid) identical to
    GridConfig.world_to_cell_array."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    col = np.empty(n, np.int32)
    row = np.empty(n, np.int32)
    valid = np.empty(n, np.uint8)
    b = cfg.bounds
    L.pcr_assign(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double), n,
                 b.min_x, b.min_y, b.max_x, b.max_y,
                 cfg.origin_x, cfg.origin_y,
                 1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                 cfg.width, cfg.height,
                 _ptr(col, ctypes.c_int32), _ptr(row, ctypes.c_int32),
                 _ptr(valid, ctypes.c_uint8))
    return col, row, valid.astype(bool)


def tile_presence(col, row, valid, tile_w: int, tile_h: int, tiles_x: int,
                  ntiles: int) -> np.ndarray:
    """One-pass touched-tile presence: uint8 (ntiles,), 1 at tile
    (row // tile_h) * tiles_x + col // tile_w of every valid cell (every
    cell where `valid` is None); tiles at or past ntiles are dropped. A
    bool `valid` is read in place as bytes."""
    L = _load()
    n = len(col)
    col = np.ascontiguousarray(col, np.int32)
    row = np.ascontiguousarray(row, np.int32)
    if valid is not None:
        if valid.dtype == np.bool_:
            valid = valid.view(np.uint8)
        valid = np.ascontiguousarray(valid, np.uint8)
    if not (len(row) == n and (valid is None or len(valid) == n)
            and tile_w > 0 and tile_h > 0 and 0 < tiles_x <= ntiles):
        raise ValueError("tile_presence: bad lengths or tile shape")
    present = np.zeros(ntiles, np.uint8)
    L.pcr_tile_presence(_ptr(col, ctypes.c_int32), _ptr(row, ctypes.c_int32),
                        None if valid is None else _ptr(valid, ctypes.c_uint8),
                        n, tile_w, tile_h, tiles_x, ntiles,
                        _ptr(present, ctypes.c_uint8))
    return present


def assign_cells(cfg, x: np.ndarray, y: np.ndarray,
                 sentinel: int) -> np.ndarray:
    """Native fused assign+flatten with invalid→sentinel."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    cells = np.empty(n, np.int32)
    b = cfg.bounds
    L.pcr_assign_cells(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double), n,
                       b.min_x, b.min_y, b.max_x, b.max_y,
                       cfg.origin_x, cfg.origin_y,
                       1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                       cfg.width, cfg.height, sentinel,
                       _ptr(cells, ctypes.c_int32))
    return cells


def fractional_cells(cfg, x: np.ndarray, y: np.ndarray):
    """Native fused fractional-cell computation: (icx, icy, sub_cx, sub_cy)."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    icx = np.empty(n, np.int32)
    icy = np.empty(n, np.int32)
    sub_cx = np.empty(n, np.float32)
    sub_cy = np.empty(n, np.float32)
    L.pcr_fractional_cells(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                           n, cfg.origin_x, cfg.origin_y,
                           1.0 / cfg.cell_size_x, 1.0 / cfg.cell_size_y,
                           _ptr(icx, ctypes.c_int32),
                           _ptr(icy, ctypes.c_int32),
                           _ptr(sub_cx, ctypes.c_float),
                           _ptr(sub_cy, ctypes.c_float))
    return icx, icy, sub_cx, sub_cy


def pack_point_wire(col, row, valid, values, weights, start: int, end: int,
                    bucket: int, width: int, sentinel: int,
                    mode: int, out: np.ndarray | None = None) -> np.ndarray:
    """One-pass staging pack for the wire-minimal Point layout.

    Returns the padded int32 device buffer [cells | f0 (| f1)] for the
    [start, end) slice (written into `out` where given); mode 0 =
    Sum/Average (f0=value), 1 = Count (f0=1), 2 = WeightedAverage
    (f0=value*w, f1=w). Invalid points get the cell `sentinel` and keep
    their fields."""
    L = _load()
    nseg = 3 if mode == 2 else 2
    if out is None:
        out = np.empty(nseg * bucket, np.int32)
    if not (out.dtype == np.int32 and out.flags.c_contiguous
            and len(out) >= nseg * bucket
            and 0 <= start <= end <= min(len(col), len(row), len(valid),
                                          len(values))
            and end - start <= bucket
            and (weights is None or len(weights) >= end)):
        raise ValueError("pack_point_wire: bad slice or output buffer")
    col = np.ascontiguousarray(col, np.int32)
    row = np.ascontiguousarray(row, np.int32)
    if valid.dtype == np.bool_:
        valid = valid.view(np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    values = np.ascontiguousarray(values, np.float32)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
        wptr = _ptr(weights, ctypes.c_float)
    else:
        wptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    L.pcr_pack_point_wire(_ptr(col, ctypes.c_int32),
                          _ptr(row, ctypes.c_int32),
                          _ptr(valid, ctypes.c_uint8),
                          _ptr(values, ctypes.c_float), wptr,
                          start, end, bucket, width, sentinel, mode,
                          _ptr(out, ctypes.c_int32))
    return out


def gauss_wire_words(m: int) -> int:
    """int32 words of the exact Gaussian wire of m points: four planes and
    the valid bytes, padded to a word."""
    return 4 * m + (m + 3) // 4


def gauss_wire_exact(cfg, x, y, valid, values, start: int, end: int,
                     out: np.ndarray) -> bool:
    """One-pass exact Gaussian wire of the [start, end) slice (uniform
    shape): raw f64 world coords -> `out`, int32 [icx,icy int16 pair |
    sub_cx bits | sub_cy bits | value bits | valid bytes] (see router.cpp
    pcr_gauss_wire_exact). False when a centre cell does not fit the int16
    pair; `out` is then unspecified."""
    L = _load()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if valid.dtype == np.bool_:
        valid = valid.view(np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    values = np.ascontiguousarray(values, np.float32)
    if not (out.dtype == np.int32 and out.flags.c_contiguous
            and len(out) >= gauss_wire_words(end - start)
            and 0 <= start <= end <= min(len(x), len(y), len(valid),
                                          len(values))):
        raise ValueError("gauss_wire_exact: bad slice or output buffer")
    return bool(L.pcr_gauss_wire_exact(
        _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
        _ptr(valid, ctypes.c_uint8), _ptr(values, ctypes.c_float),
        start, end, cfg.origin_x, cfg.origin_y, cfg.cell_size_x,
        cfg.cell_size_y, _ptr(out, ctypes.c_int32)))


def line_endpoints(cfg, x, y, valid, hx: float, hy: float,
                   cos_d: float, sin_d: float):
    """One-pass line endpoint math of the device layout's Line wire
    (uniform direction and half length). Returns (e0, e1, nruns,
    max_abs_coord, max_dmaj, total_runs): e0/e1 are routing.line_params'
    endpoints as int16-pair words (iy0 = -32768 marks an invalid line),
    nruns the per-point run counts, and the scalars, taken over the valid
    lines, feed the wire's coordinate guard and the chunking."""
    L = _load()
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if valid.dtype == np.bool_:
        valid = valid.view(np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    if not len(y) == len(valid) == n:
        raise ValueError("line_endpoints: x, y and valid differ in length")
    e0 = np.empty(n, np.int32)
    e1 = np.empty(n, np.int32)
    nruns = np.empty(n, np.int32)
    stats = np.zeros(3, np.int64)
    L.pcr_line_endpoints(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                         n, _ptr(valid, ctypes.c_uint8),
                         hx, hy, cos_d, sin_d,
                         cfg.origin_x, cfg.origin_y,
                         cfg.cell_size_x, cfg.cell_size_y,
                         _ptr(e0, ctypes.c_int32), _ptr(e1, ctypes.c_int32),
                         _ptr(nruns, ctypes.c_int32),
                         _ptr(stats, ctypes.c_int64))
    return e0, e1, nruns, int(stats[0]), int(stats[1]), int(stats[2])


def set_num_threads(n: int) -> None:
    """Cap the OpenMP thread count used by every native kernel
    (PipelineConfig.cpu_threads; the reference does the same via
    omp_set_num_threads, pipeline.cpp:94-98). n <= 0 restores the
    runtime default. No-op when the native library is unavailable."""
    L = _load()
    if L is not None:
        L.pcr_set_num_threads(int(n))


def lzw_encode(data: bytes) -> bytes:
    """Native TIFF LZW encode (byte-compatible with io.geotiff.lzw_encode)."""
    L = _load()
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    # worst case ~12/8 expansion plus slack
    out = np.empty(n * 2 + 64, np.uint8)
    m = L.pcr_lzw_encode(_ptr(src, ctypes.c_uint8), n,
                         _ptr(out, ctypes.c_uint8), len(out))
    if m < 0:
        raise RuntimeError("native LZW encode overflow")
    return out[:m].tobytes()


def lzw_decode(data: bytes, max_out: int) -> bytes:
    """Native TIFF LZW decode; max_out bounds the decoded size."""
    L = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    m = L.pcr_lzw_decode(_ptr(src, ctypes.c_uint8), len(src),
                         _ptr(out, ctypes.c_uint8), max_out)
    if m < 0:
        raise RuntimeError("native LZW decode failed")
    return out[:m].tobytes()


def bucket_layout(eb: np.ndarray, nblocks: int, block: int,
                  visit_all: bool, nsub_bucket_fn):
    """Native counting-sort layout for the sorted splat.

    Returns (slots int64 (E,), bids int32 (nsub,), nsub) with -1 slots as
    padding; trailing pads carry the last real block id."""
    L = _load()
    eb = np.ascontiguousarray(eb, np.int32)
    n = len(eb)
    nsub_real = L.pcr_bucket_nsub(_ptr(eb, ctypes.c_int32), n, nblocks,
                                  block, int(visit_all))
    nsub = nsub_bucket_fn(max(int(nsub_real), 1))
    E = nsub * block
    slots = np.empty(E, np.int64)
    bids = np.zeros(nsub, np.int32)
    L.pcr_bucket_layout(_ptr(eb, ctypes.c_int32), n, nblocks, block,
                        int(visit_all), nsub,
                        _ptr(slots, ctypes.c_int64),
                        _ptr(bids, ctypes.c_int32))
    return slots, bids, nsub


def pack_sub_major(slots: np.ndarray, idx, seg_arrays, nsub: int,
                   block: int, out: np.ndarray | None = None,
                   quad: bool = False) -> np.ndarray:
    """Fused gather+fill+sub_major pack (see router.cpp pcr_pack_sub_major).

    slots: int64 (nsub*block,) slot→entry map (-1 = padding); idx: int64
    entry→source map or None (identity); seg_arrays: list of (array, fill)
    where float arrays are bit-viewed into the int32 buffer. Returns the
    packed int32 buffer of nseg*E ints (bids are appended by the caller).
    quad=True emits the quad-major layout [sub][slot(4)][seg][block/4]
    consumed by the packed rot splat (pcr_pack_quad_major)."""
    L = _load()
    nseg = len(seg_arrays)
    E = nsub * block
    if out is None:
        out = np.empty(nseg * E, np.int32)
    assert out.flags.c_contiguous and len(out) >= nseg * E
    holders = []
    ptrs = (ctypes.POINTER(ctypes.c_int32) * nseg)()
    fills = np.empty(nseg, np.int32)
    for g, (arr, fill) in enumerate(seg_arrays):
        orig = np.asarray(arr)
        if orig.dtype.kind == "f":
            a = np.ascontiguousarray(orig, np.float32).view(np.int32)
            fv = np.float32(fill).view(np.int32)
        else:
            a = np.ascontiguousarray(orig, np.int32)
            fv = np.int32(fill)
        holders.append(a)
        ptrs[g] = _ptr(a, ctypes.c_int32)
        fills[g] = fv
    slots = np.ascontiguousarray(slots, np.int64)
    if idx is None:
        idxp = slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        has_idx = 0
    else:
        idx = np.ascontiguousarray(idx, np.int64)
        idxp = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        has_idx = 1
    fn = L.pcr_pack_quad_major if quad else L.pcr_pack_sub_major
    fn(slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idxp,
       has_idx, ptrs, _ptr(fills, ctypes.c_int32), nseg, nsub, block,
       _ptr(out, ctypes.c_int32))
    return out


def rotp_counts(rlo, rhi, wlo, whi, th: int, ncb: int,
                nbc: int) -> np.ndarray:
    """Fused (row-block, quarter) histogram for the packed rot layout.
    Inputs are the integral f32 window bounds; returns cf (nbc, 4) int32."""
    L = _load()
    n = len(rlo)
    rlo, rhi, wlo, whi = (np.ascontiguousarray(a, np.float32)
                          for a in (rlo, rhi, wlo, whi))
    cf = np.empty(nbc * 4, np.int32)
    L.pcr_rotp_counts(_ptr(rlo, ctypes.c_float), _ptr(rhi, ctypes.c_float),
                      _ptr(wlo, ctypes.c_float), _ptr(whi, ctypes.c_float),
                      n, th, ncb, nbc, _ptr(cf, ctypes.c_int32))
    return cf.reshape(nbc, 4)


def rotp_place(rlo, rhi, wlo, whi, th: int, ncb: int, nbc: int,
               base_b: np.ndarray, G: int, block: int,
               slots: np.ndarray) -> None:
    """Fill `slots` (int64, prefilled to -1 inside) with the packed rot
    layout: point-order iteration reproduces the numpy stable argsort's
    slot assignment bit-for-bit (see router.cpp pcr_rotp_place)."""
    L = _load()
    n = len(rlo)
    rlo, rhi, wlo, whi = (np.ascontiguousarray(a, np.float32)
                          for a in (rlo, rhi, wlo, whi))
    base_b = np.ascontiguousarray(base_b, np.int64)
    counters = np.empty(nbc * 4, np.int32)
    L.pcr_rotp_place(_ptr(rlo, ctypes.c_float), _ptr(rhi, ctypes.c_float),
                     _ptr(wlo, ctypes.c_float), _ptr(whi, ctypes.c_float),
                     n, th, ncb, nbc, _ptr(base_b, ctypes.c_int64),
                     _ptr(counters, ctypes.c_int32), G, block,
                     _ptr(slots, ctypes.c_int64), len(slots))


def line_runs(ix0, iy0, ix1, iy1, valid, clip_cs, clip_rs, clip_ce,
              clip_re):
    """Native closed-form Bresenham run expansion (clipped rectangles).

    Returns (ax, bx, ay, by, owner) int32 arrays."""
    L = _load()
    n = len(ix0)
    ix0 = np.ascontiguousarray(ix0, np.int32)
    iy0 = np.ascontiguousarray(iy0, np.int32)
    ix1 = np.ascontiguousarray(ix1, np.int32)
    iy1 = np.ascontiguousarray(iy1, np.int32)
    v = np.ascontiguousarray(valid, np.uint8)
    cs = np.ascontiguousarray(clip_cs, np.int32)
    rs = np.ascontiguousarray(clip_rs, np.int32)
    ce = np.ascontiguousarray(clip_ce, np.int32)
    re = np.ascontiguousarray(clip_re, np.int32)
    cap = int(L.pcr_line_runs_count(_ptr(ix0, ctypes.c_int32),
                                    _ptr(iy0, ctypes.c_int32),
                                    _ptr(ix1, ctypes.c_int32),
                                    _ptr(iy1, ctypes.c_int32),
                                    _ptr(v, ctypes.c_uint8), n))
    ax = np.empty(cap, np.int32)
    bx = np.empty(cap, np.int32)
    ay = np.empty(cap, np.int32)
    by = np.empty(cap, np.int32)
    owner = np.empty(cap, np.int32)
    m = int(L.pcr_line_runs_emit(
        _ptr(ix0, ctypes.c_int32), _ptr(iy0, ctypes.c_int32),
        _ptr(ix1, ctypes.c_int32), _ptr(iy1, ctypes.c_int32),
        _ptr(v, ctypes.c_uint8),
        _ptr(cs, ctypes.c_int32), _ptr(rs, ctypes.c_int32),
        _ptr(ce, ctypes.c_int32), _ptr(re, ctypes.c_int32), n,
        _ptr(ax, ctypes.c_int32), _ptr(bx, ctypes.c_int32),
        _ptr(ay, ctypes.c_int32), _ptr(by, ctypes.c_int32),
        _ptr(owner, ctypes.c_int32)))
    return ax[:m], bx[:m], ay[:m], by[:m], owner[:m]


def fin_avg(sum_arr: np.ndarray, cnt_arr: np.ndarray) -> np.ndarray:
    """Single-pass Average finalize: sum/count with empty-cell NaN."""
    L = _load()
    s = np.ascontiguousarray(sum_arr, np.float32)
    c = np.ascontiguousarray(cnt_arr, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_avg(_ptr(s, ctypes.c_float), _ptr(c, ctypes.c_float),
                  _ptr(out, ctypes.c_float), s.size)
    return out


def fin_sentinel(state: np.ndarray, sentinel: float) -> np.ndarray:
    """Single-pass Max/Min finalize: sentinel (±FLT_MAX) -> NaN."""
    L = _load()
    s = np.ascontiguousarray(state, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_sentinel(_ptr(s, ctypes.c_float), _ptr(out, ctypes.c_float),
                       s.size, ctypes.c_float(sentinel))
    return out


def fin_count(state: np.ndarray) -> np.ndarray:
    """Single-pass Count finalize: zero -> NaN."""
    L = _load()
    s = np.ascontiguousarray(state, np.float32)
    out = np.empty_like(s)
    L.pcr_fin_count(_ptr(s, ctypes.c_float), _ptr(out, ctypes.c_float),
                    s.size)
    return out

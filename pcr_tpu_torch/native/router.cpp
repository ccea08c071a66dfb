// pcr_tpu native host router — fused assign/flatten/pack kernels.
//
// The reference implements routing in C++ (src/engine/tile_router.cpp:89-122
// assign; OpenMP). On this framework the device does the heavy accumulation,
// but the per-point world→cell math still runs on the host in float64 for
// geo precision; this kernel fuses what the numpy path does in ~10 memory
// passes (bounds test, two floor-divides, clamps, flatten, invalid-sentinel
// encode) into one OpenMP pass.
//
// Semantics are bit-identical to GridConfig::world_to_cell
// (grid_config.cpp:24-43): bbox-inclusive contains, floor, clamp to range.
//
// Built as a plain C ABI shared library; loaded via ctypes
// (pcr_tpu/native/__init__.py). No Python headers needed.

#include <cstdint>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Honor PipelineConfig::cpu_threads in the OpenMP kernels (the
// reference does the same via omp_set_num_threads,
// src/engine/pipeline.cpp:94-98). n <= 0 restores the runtime default.
void pcr_set_num_threads(int n)
{
#ifdef _OPENMP
    // Captured on FIRST call, before any set: restoring to this (not to
    // omp_get_num_procs()) preserves the user's OMP_NUM_THREADS default
    // (round-5 review).
    static const int initial = omp_get_max_threads();
    omp_set_num_threads(n > 0 ? n : initial);
#else
    (void)n;
#endif
}

// world→cell assignment: col/row (clamped) + valid mask.
void pcr_assign(const double* x, const double* y, int64_t n,
                double min_x, double min_y, double max_x, double max_y,
                double origin_x, double origin_y,
                double inv_csx, double inv_csy,
                int32_t width, int32_t height,
                int32_t* out_col, int32_t* out_row, uint8_t* out_valid)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double wx = x[i];
        const double wy = y[i];
        const bool ok = (wx >= min_x) & (wx <= max_x)
                      & (wy >= min_y) & (wy <= max_y);
        int64_t col = (int64_t)std::floor((wx - origin_x) * inv_csx);
        int64_t row = (int64_t)std::floor((wy - origin_y) * inv_csy);
        if (col < 0) col = 0;
        if (col > width - 1) col = width - 1;
        if (row < 0) row = 0;
        if (row > height - 1) row = height - 1;
        out_col[i] = ok ? (int32_t)col : 0;
        out_row[i] = ok ? (int32_t)row : 0;
        out_valid[i] = ok ? 1 : 0;
    }
}

// Fused assign + flatten + sentinel encode: flat cell id, or `sentinel`
// for out-of-bounds points (the device scatter drops them).
void pcr_assign_cells(const double* x, const double* y, int64_t n,
                      double min_x, double min_y, double max_x, double max_y,
                      double origin_x, double origin_y,
                      double inv_csx, double inv_csy,
                      int32_t width, int32_t height, int32_t sentinel,
                      int32_t* out_cells)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double wx = x[i];
        const double wy = y[i];
        const bool ok = (wx >= min_x) & (wx <= max_x)
                      & (wy >= min_y) & (wy <= max_y);
        int64_t col = (int64_t)std::floor((wx - origin_x) * inv_csx);
        int64_t row = (int64_t)std::floor((wy - origin_y) * inv_csy);
        if (col < 0) col = 0;
        if (col > width - 1) col = width - 1;
        if (row < 0) row = 0;
        if (row > height - 1) row = height - 1;
        out_cells[i] = ok ? (int32_t)(row * (int64_t)width + col) : sentinel;
    }
}

// Fused fractional-cell computation for glyph footprints
// (glyph_kernels.cu:119-123): integer center cell + float32 sub-cell offset.
void pcr_fractional_cells(const double* x, const double* y, int64_t n,
                          double origin_x, double origin_y,
                          double inv_csx, double inv_csy,
                          int32_t* out_icx, int32_t* out_icy,
                          float* out_sub_cx, float* out_sub_cy)
{
    const double lim = 1073741824.0;   // clamp to int32-safe range before
                                       // casting (wild out-of-bounds points)
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double fcx = (x[i] - origin_x) * inv_csx;
        const double fcy = (y[i] - origin_y) * inv_csy;
        double icx = std::floor(fcx);
        double icy = std::floor(fcy);
        if (icx > lim) icx = lim;
        if (icx < -lim) icx = -lim;
        if (icy > lim) icy = lim;
        if (icy < -lim) icy = -lim;
        out_icx[i] = (int32_t)icx;
        out_icy[i] = (int32_t)icy;
        out_sub_cx[i] = (float)(fcx - icx);
        out_sub_cy[i] = (float)(fcy - icy);
    }
}

// Fused staging pack for the wire-minimal Point layout: one pass turns
// (col,row,valid,values[,weights]) into the padded device buffer
// [cells | f0 (| f1)], each segment `bucket` entries, f32 bit-viewed into
// the i32 buffer. Replaces a 5-pass numpy chain (flatten, where, astype,
// field math, pad-copy) that cost seconds per 5M-point chunk on a 1-core
// host. mode: 0 f0=value (Sum/Average); 1 f0=1 (Count);
// 2 f0=value*w, f1=w (WeightedAverage).
void pcr_pack_point_wire(const int32_t* col, const int32_t* row,
                         const uint8_t* valid, const float* values,
                         const float* weights, int64_t start, int64_t end,
                         int64_t bucket, int32_t width, int32_t sentinel,
                         int32_t mode, int32_t* out)
{
    const int64_t m = end - start;
    int32_t* out_cells = out;
    int32_t* out_f0 = out + bucket;
    int32_t* out_f1 = (mode == 2) ? out + 2 * bucket : nullptr;
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) {
        const int64_t i = start + j;
        out_cells[j] = valid[i]
            ? row[i] * width + col[i] : sentinel;
        float f0;
        if (mode == 1) {
            f0 = 1.0f;
        } else if (mode == 2) {
            const float w = weights ? weights[i] : 1.0f;
            f0 = values[i] * w;
            float f1 = w;
            __builtin_memcpy(&out_f1[j], &f1, 4);
        } else {
            f0 = values[i];
        }
        __builtin_memcpy(&out_f0[j], &f0, 4);
    }
    // padding: sentinel cells scatter to the dropped overflow slot; zero
    // field contributions keep the padded tail inert either way
    for (int64_t j = m; j < bucket; ++j) {
        out_cells[j] = sentinel;
        out_f0[j] = 0;
        if (out_f1) out_f1[j] = 0;
    }
}

// Fused staging pack for the minimal-wire hybrid Gaussian layout
// (tpu_backend._prepare_gaussian_wire semantics, uniform-shape case): one
// pass turns raw f64 world coords into the padded [icxy | subq | value]
// device buffer — fractional cell, floor, u16 sub-cell quantization
// (round-half-even, matching np.round), u16 pair packing, invalid
// sentinel, pad fill. Replaces routing.gaussian_params (~20 numpy
// passes, and the dominant hybrid-glyph cost on a 1-core steal-jittery
// host) for clouds without per-point sigma/rotation channels. Byte-
// identical to the numpy wire path for in-bounds points.
void pcr_gauss_wire_pack(const double* x, const double* y,
                         const uint8_t* valid, const float* values,
                         int64_t start, int64_t end, int64_t bucket,
                         double origin_x, double origin_y,
                         double inv_csx, double inv_csy,
                         int32_t* out)
{
    const int64_t m = end - start;
    int32_t* out_icxy = out;
    int32_t* out_subq = out + bucket;
    int32_t* out_val = out + 2 * bucket;
    const double lim = 1073741824.0;   // int64-safe clamp for wild coords
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) {
        const int64_t i = start + j;
        const double fcx = (x[i] - origin_x) * inv_csx;
        const double fcy = (y[i] - origin_y) * inv_csy;
        double fx = std::floor(fcx);
        double fy = std::floor(fcy);
        if (!(fx > -lim)) fx = -lim;       // also catches NaN
        if (fx > lim) fx = lim;
        if (!(fy > -lim)) fy = -lim;
        if (fy > lim) fy = lim;
        const int64_t icx = valid[i] ? (int64_t)fx : -32768;
        const int64_t icy = valid[i] ? (int64_t)fy : 0;
        out_icxy[j] = (int32_t)(uint32_t)(((uint64_t)(icx & 0xFFFF) << 16)
                                          | (uint64_t)(icy & 0xFFFF));
        float sub_cx = (float)(fcx - fx);
        float sub_cy = (float)(fcy - fy);
        if (!(sub_cx == sub_cx)) sub_cx = 0.0f;   // NaN-safe (dead points)
        if (!(sub_cy == sub_cy)) sub_cy = 0.0f;
        const int64_t qx = (int64_t)std::nearbyintf(sub_cx * 65535.0f);
        const int64_t qy = (int64_t)std::nearbyintf(sub_cy * 65535.0f);
        out_subq[j] = (int32_t)(uint32_t)(((uint64_t)(qx & 0xFFFF) << 16)
                                          | (uint64_t)(qy & 0xFFFF));
        __builtin_memcpy(&out_val[j], &values[i], 4);
    }
    for (int64_t j = m; j < bucket; ++j) {
        out_icxy[j] = (int32_t)0x80000000;   // -32768 << 16: dead sentinel
        out_subq[j] = 0;
        out_val[j] = 0;
    }
}

// Fused line endpoint math for the minimal-wire hybrid Line layout
// (routing.line_params + tpu_backend._prepare_line_wire, uniform-shape
// case): one pass from raw f64 world coords to packed u16-pair endpoint
// arrays e0/e1, per-point run counts, and the chunking stats. cos/sin of
// the (single) direction are computed by the caller with numpy so the
// endpoint bits match the numpy/staged path exactly. stats[0] =
// max |endpoint coord| (the 32000 wire guard), stats[1] = max(ddx, ddy)
// (runlen_max - 1). Wild out-of-bounds coords are clamped int64-safe
// instead of int32-wrapped; the 32000 guard rejects them either way.
void pcr_line_endpoints(const double* x, const double* y, int64_t n,
                        const uint8_t* valid,
                        float hx, float hy, float cos_d, float sin_d,
                        double origin_x, double origin_y,
                        double inv_csx, double inv_csy,
                        int32_t* e0, int32_t* e1, int32_t* nruns,
                        int64_t* stats)
{
    const double dxh = (double)hx * (double)cos_d;
    const double dyh = (double)hy * (double)sin_d;
    const double lim = 1073741824.0;
    int64_t max_abs = 0;
    int64_t max_dmaj = 0;
#pragma omp parallel for schedule(static) \
    reduction(max:max_abs) reduction(max:max_dmaj)
    for (int64_t i = 0; i < n; ++i) {
        const double fcx = (x[i] - origin_x) * inv_csx;
        const double fcy = (y[i] - origin_y) * inv_csy;
        double x0 = fcx - dxh, y0 = fcy - dyh;
        double x1 = fcx + dxh, y1 = fcy + dyh;
        // literal routing._round_half_away formula (bit-parity with numpy)
        x0 = x0 >= 0.0 ? std::floor(x0 + 0.5) : std::ceil(x0 - 0.5);
        y0 = y0 >= 0.0 ? std::floor(y0 + 0.5) : std::ceil(y0 - 0.5);
        x1 = x1 >= 0.0 ? std::floor(x1 + 0.5) : std::ceil(x1 - 0.5);
        y1 = y1 >= 0.0 ? std::floor(y1 + 0.5) : std::ceil(y1 - 0.5);
        if (!(x0 > -lim)) x0 = -lim;
        if (x0 > lim) x0 = lim;
        if (!(y0 > -lim)) y0 = -lim;
        if (y0 > lim) y0 = lim;
        if (!(x1 > -lim)) x1 = -lim;
        if (x1 > lim) x1 = lim;
        if (!(y1 > -lim)) y1 = -lim;
        if (y1 > lim) y1 = lim;
        const int64_t ix0 = (int64_t)x0, iy0 = (int64_t)y0;
        const int64_t ix1 = (int64_t)x1, iy1 = (int64_t)y1;
        const int64_t ddx = ix1 >= ix0 ? ix1 - ix0 : ix0 - ix1;
        const int64_t ddy = iy1 >= iy0 ? iy1 - iy0 : iy0 - iy1;
        const int64_t dmaj = ddx > ddy ? ddx : ddy;
        const int64_t dmin = ddx > ddy ? ddy : ddx;
        int64_t a;
        a = ix0 < 0 ? -ix0 : ix0; if (a > max_abs) max_abs = a;
        a = iy0 < 0 ? -iy0 : iy0; if (a > max_abs) max_abs = a;
        a = ix1 < 0 ? -ix1 : ix1; if (a > max_abs) max_abs = a;
        a = iy1 < 0 ? -iy1 : iy1; if (a > max_abs) max_abs = a;
        if (dmaj > max_dmaj) max_dmaj = dmaj;
        const int64_t ey0 = valid[i] ? iy0 : -32768;
        e0[i] = (int32_t)(uint32_t)(((uint64_t)(ix0 & 0xFFFF) << 16)
                                    | (uint64_t)(ey0 & 0xFFFF));
        e1[i] = (int32_t)(uint32_t)(((uint64_t)(ix1 & 0xFFFF) << 16)
                                    | (uint64_t)(iy1 & 0xFFFF));
        nruns[i] = valid[i] ? (int32_t)(dmin + 1) : 0;
    }
    stats[0] = max_abs;
    stats[1] = max_dmaj;
}

int pcr_native_version() { return 1; }

int pcr_native_threads()
{
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

} // extern "C"

// ---------------------------------------------------------------------------
// TIFF LZW codec (TIFF6 spec: MSB-first bit packing, 9->12 bit codes with
// early change, ClearCode=256, EOI=257). ~100x the pure-Python codec in
// io/geotiff.py and byte-compatible with it.
// ---------------------------------------------------------------------------

#include <cstring>
#include <vector>

namespace {

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t pos = 0;
    uint32_t buf = 0;
    int nbits = 0;
    bool overflow = false;

    void emit(uint32_t code, int width) {
        buf = (buf << width) | code;
        nbits += width;
        while (nbits >= 8) {
            nbits -= 8;
            if (pos < cap) out[pos++] = (uint8_t)((buf >> nbits) & 0xFF);
            else overflow = true;
        }
        buf &= (1u << nbits) - 1;
    }
    void flush() {
        if (nbits > 0) {
            if (pos < cap) out[pos++] = (uint8_t)((buf << (8 - nbits)) & 0xFF);
            else overflow = true;
            nbits = 0;
        }
    }
};

constexpr int LZW_CLEAR = 256;
constexpr int LZW_EOI = 257;
constexpr int LZW_FIRST = 258;
constexpr int LZW_TABLE_SZ = 1 << 13;     // hash table (power of two)

} // namespace

extern "C" {

// Encode `n` bytes; returns compressed size, or -1 if `out` (capacity
// out_cap) is too small. Greedy LZW with a (prefix_code, byte) hash table.
int64_t pcr_lzw_encode(const uint8_t* in, int64_t n,
                       uint8_t* out, int64_t out_cap)
{
    BitWriter w{out, out_cap};
    // hash entries: key = (prefix << 8) | byte, value = code. Slots carry a
    // generation stamp so a dictionary reset is O(1) — on incompressible
    // data (e.g. random float rasters) the dictionary resets every ~3.9 KB
    // of input, and a full-table fill there dominated the encoder.
    std::vector<int32_t> hash_key(LZW_TABLE_SZ, -1);
    std::vector<int16_t> hash_val(LZW_TABLE_SZ, 0);
    std::vector<int32_t> hash_gen(LZW_TABLE_SZ, -1);
    int32_t gen = 0;

    auto reset = [&]() { ++gen; };

    int next_code = LZW_FIRST;
    int width = 9;
    w.emit(LZW_CLEAR, width);
    if (n == 0) {
        w.emit(LZW_EOI, width);
        w.flush();
        return w.overflow ? -1 : w.pos;
    }

    int cur = in[0];
    for (int64_t i = 1; i < n; ++i) {
        const int c = in[i];
        const int32_t key = (cur << 8) | c;
        // open-address probe (slot live iff its generation matches)
        // Fibonacci hashing keeps the TOP bits: masking the low bits
        // degenerates for run data (key = cur<<8 gives only 32 distinct
        // low-bit slots -> pathological probe chains on constant spans)
        uint32_t h = ((uint32_t)key * 2654435761u) >> (32 - 13);
        int found = -1;
        while (hash_gen[h] == gen) {
            if (hash_key[h] == key) { found = hash_val[h]; break; }
            h = (h + 1) & (LZW_TABLE_SZ - 1);
        }
        if (found >= 0) {
            cur = found;
            continue;
        }
        w.emit((uint32_t)cur, width);
        hash_key[h] = key;
        hash_val[h] = (int16_t)next_code;
        hash_gen[h] = gen;
        ++next_code;
        // Width/reset points verified against libtiff (round 5; the
        // previous rule was one step early and standard readers rejected
        // the streams): widen when the next code to assign reaches
        // 2^width, reset one entry before the 12-bit table fills.
        if (next_code >= 4094) {
            w.emit(LZW_CLEAR, width);
            reset();
            next_code = LZW_FIRST;
            width = 9;
        } else if (next_code == (1 << width) && width < 12) {
            ++width;
        }
        cur = c;
    }
    w.emit((uint32_t)cur, width);
    w.emit(LZW_EOI, width);
    w.flush();
    return w.overflow ? -1 : w.pos;
}

// Decode into `out` (capacity out_cap); returns decoded size or -1 on
// corrupt input / overflow.
int64_t pcr_lzw_decode(const uint8_t* in, int64_t n,
                       uint8_t* out, int64_t out_cap)
{
    // table entries as (prev_code, last_byte, length)
    std::vector<int32_t> prev(4096, -1);
    std::vector<uint8_t> last(4096, 0);
    std::vector<int32_t> len(4096, 0);
    auto reset = [&]() {
        for (int i = 0; i < 256; ++i) { prev[i] = -1; last[i] = (uint8_t)i; len[i] = 1; }
    };
    reset();
    int table_n = LZW_FIRST;
    int width = 9;
    uint32_t buf = 0;
    int nbits = 0;
    int64_t ip = 0;
    int64_t op = 0;
    int prev_code = -1;

    auto write_code = [&](int code) -> int64_t {
        // expand backwards
        int64_t l = len[code];
        if (op + l > out_cap) return -1;
        int64_t p = op + l;
        int c = code;
        while (c >= 0) {
            out[--p] = last[c];
            c = prev[c];
        }
        op += l;
        return l;
    };

    while (true) {
        while (nbits < width) {
            if (ip >= n) return op;     // ran out without EOI: return what we have
            buf = (buf << 8) | in[ip++];
            nbits += 8;
        }
        nbits -= width;
        int code = (int)((buf >> nbits) & ((1u << width) - 1));
        buf &= (1u << nbits) - 1;
        if (code == LZW_EOI) return op;
        if (code == LZW_CLEAR) {
            reset();
            table_n = LZW_FIRST;
            width = 9;
            prev_code = -1;
            continue;
        }
        if (prev_code < 0) {
            if (code >= 256) return -1;
            if (write_code(code) < 0) return -1;
        } else if (code < table_n) {
            if (write_code(code) < 0) return -1;
            if (table_n < 4096) {
                // new entry: prev_code + first byte of `code`
                int c = code;
                while (prev[c] >= 0) c = prev[c];
                prev[table_n] = prev_code;
                last[table_n] = last[c];
                len[table_n] = len[prev_code] + 1;
                ++table_n;
            }
        } else {
            // KwKwK case; a code BEYOND the next entry is not decodable
            // under this width rule (legacy-flavor stream or corruption)
            // — fail so the caller can retry with the legacy decoder
            if (code != table_n) return -1;
            int c = prev_code;
            while (prev[c] >= 0) c = prev[c];
            uint8_t first = last[c];
            prev[table_n] = prev_code;
            last[table_n] = first;
            len[table_n] = len[prev_code] + 1;
            ++table_n;
            if (write_code(table_n - 1) < 0) return -1;
        }
        prev_code = code;
        // decoder lags the encoder's table by one entry, so it widens at
        // (1 << width) - 1 where the encoder widens at 2^width (verified
        // against libtiff streams; see geotiff.py, round 5)
        if (table_n >= (1 << width) - 1 && width < 12) ++width;
    }
}

} // extern "C"

// ---------------------------------------------------------------------------
// Block bucket layout — the sorted-splat's counting sort (the analogue of
// the reference TileRouter's CUB radix sort, tile_router_kernels.cu:169-293).
// Entries carry a block id eb[i] in [0, nblocks); the layout places them
// block-contiguously with each block's run padded to a multiple of `block`
// (and at least one sub-chunk per block when visit_all != 0).
// ---------------------------------------------------------------------------

extern "C" {

// Pass 1: number of sub-chunks the layout needs.
int64_t pcr_bucket_nsub(const int32_t* eb, int64_t n, int32_t nblocks,
                        int32_t block, int32_t visit_all)
{
    std::vector<int64_t> counts(nblocks, 0);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t b = eb[i];
        if (b >= 0 && b < nblocks) ++counts[b];
    }
    int64_t nsub = 0;
    for (int32_t b = 0; b < nblocks; ++b) {
        int64_t subs = (counts[b] + block - 1) / block;
        if (visit_all && subs == 0) subs = 1;
        nsub += subs;
    }
    return nsub;
}

// Pass 2: fill slot->entry indices (-1 = padding) and per-sub-chunk block
// ids. out_slots has capacity nsub_total*block (nsub_total >= pass-1 nsub,
// ladder-padded by the caller); trailing pad sub-chunks get the last block
// id (the Pallas ascending-bids contract).
void pcr_bucket_layout(const int32_t* eb, int64_t n, int32_t nblocks,
                       int32_t block, int32_t visit_all,
                       int64_t nsub_total,
                       int64_t* out_slots, int32_t* out_bids)
{
    std::vector<int64_t> counts(nblocks, 0);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t b = eb[i];
        if (b >= 0 && b < nblocks) ++counts[b];
    }
    // per-block slot offsets (padded runs)
    std::vector<int64_t> offs(nblocks + 1, 0);
    int64_t epos = 0;
    int32_t last_bid = 0;
    for (int32_t b = 0; b < nblocks; ++b) {
        offs[b] = epos;
        int64_t subs = (counts[b] + block - 1) / block;
        if (visit_all && subs == 0) subs = 1;
        if (subs > 0) {
            for (int64_t s = epos / block; s < epos / block + subs; ++s)
                out_bids[s] = b;
            last_bid = b;
            epos += subs * block;
        }
    }
    offs[nblocks] = epos;
    const int64_t E = nsub_total * block;
    for (int64_t i = epos; i < E; ++i) out_slots[i] = -1;
    for (int64_t s = epos / block; s < nsub_total; ++s)
        out_bids[s] = last_bid;
    // init padding inside block runs
    {
        int64_t pos = 0;
        for (int32_t b = 0; b < nblocks; ++b) {
            int64_t subs = (counts[b] + block - 1) / block;
            if (visit_all && subs == 0) subs = 1;
            const int64_t run = subs * block;
            if (run == 0) continue;
            for (int64_t i = pos + counts[b]; i < pos + run; ++i)
                out_slots[i] = -1;
            pos += run;
        }
    }
    // stable place
    std::vector<int64_t> cursor(nblocks, 0);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t b = eb[i];
        if (b < 0 || b >= nblocks) continue;
        out_slots[offs[b] + cursor[b]++] = i;
    }
}

// Fused gather + fill + sub_major layout for the packed splat buffer:
// out[s*(nseg*block) + g*block + j] = slot<0 ? fill[g] : seg[g][idx?idx[p]:p]
// Replaces a numpy fancy-index + where + stack + transpose chain that costs
// seconds per 5M-point chunk on a single-core host.
void pcr_pack_sub_major(const int64_t* slots, const int64_t* idx,
                        int32_t has_idx,
                        const int32_t* const* segs, const int32_t* fills,
                        int32_t nseg, int64_t nsub, int32_t block,
                        int32_t* out)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t s = 0; s < nsub; ++s) {
        const int64_t* sl = slots + s * (int64_t)block;
        int32_t* base = out + s * (int64_t)nseg * block;
        for (int32_t g = 0; g < nseg; ++g) {
            const int32_t* src = segs[g];
            const int32_t fill = fills[g];
            int32_t* dst = base + (int64_t)g * block;
            for (int32_t j = 0; j < block; ++j) {
                const int64_t p = sl[j];
                dst[j] = (p < 0) ? fill
                                 : src[has_idx ? idx[p] : p];
            }
        }
    }
}

// Quad-major variant for the packed rotated-Gaussian splat: the block's
// four 32-lane slots become the OUTER dim so the device kernel can flatten
// (4, nseg, G) -> (4, nseg*G) for one whole-block selection matmul:
// out[s*(nseg*block) + q*(nseg*G) + g*G + j] with G = block/4, q = slot,
// j = rank within the slot (slots[] is slot-major within each sub-chunk:
// position q*G + j).
void pcr_pack_quad_major(const int64_t* slots, const int64_t* idx,
                         int32_t has_idx,
                         const int32_t* const* segs, const int32_t* fills,
                         int32_t nseg, int64_t nsub, int32_t block,
                         int32_t* out)
{
    const int32_t G = block / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t s = 0; s < nsub; ++s) {
        const int64_t* sl = slots + s * (int64_t)block;
        int32_t* base = out + s * (int64_t)nseg * block;
        for (int32_t q = 0; q < 4; ++q) {
            const int64_t* slq = sl + (int64_t)q * G;
            int32_t* dstq = base + (int64_t)q * nseg * G;
            for (int32_t g = 0; g < nseg; ++g) {
                const int32_t* src = segs[g];
                const int32_t fill = fills[g];
                int32_t* dst = dstq + (int64_t)g * G;
                for (int32_t j = 0; j < G; ++j) {
                    const int64_t p = slq[j];
                    dst[j] = (p < 0) ? fill
                                     : src[has_idx ? idx[p] : p];
                }
            }
        }
    }
}

} // extern "C"

// ---------------------------------------------------------------------------
// Line run expansion — closed-form Bresenham staircase decomposition
// (see engine/routing.py line_rects; semantics validated exhaustively
// against the reference walk). Emits one clipped rectangle per staircase
// run: [ax, bx] x [ay, by] plus the owning point index.
// ---------------------------------------------------------------------------

// The runs of line i that the clip leaves a cell, in staircase order:
// live(ax, bx, ay, by) is called for each. clip_* are the line's home-tile
// cell range (end-exclusive).
template <typename F>
static inline void line_live_runs(int32_t x0, int32_t y0, int32_t x1,
                                  int32_t y1, int32_t cs, int32_t rs,
                                  int32_t ce, int32_t re, F&& live)
{
    const int64_t ddx = std::abs((int64_t)x1 - x0);
    const int64_t ddy = std::abs((int64_t)y1 - y0);
    const bool xmaj = ddx >= ddy;
    const int64_t dmaj = xmaj ? ddx : ddy;
    const int64_t dmin = xmaj ? ddy : ddx;
    const int32_t sx = x0 < x1 ? 1 : -1;
    const int32_t sy = y0 < y1 ? 1 : -1;
    const int64_t maj0 = xmaj ? x0 : y0;
    const int32_t smaj = xmaj ? sx : sy;
    const int64_t min0 = xmaj ? y0 : x0;
    const int32_t smin = xmaj ? sy : sx;
    int64_t k0 = 0;
    for (int64_t j = 0; j <= dmin; ++j) {
        // k range of run j: [k0, k1]
        const int64_t k1 = (j < dmin)
            ? (dmaj * (2 * j + 1)) / (2 * dmin)   // start of run j+1, -1
            : dmaj;
        const int64_t p0 = maj0 + (int64_t)smaj * k0;
        const int64_t p1 = maj0 + (int64_t)smaj * k1;
        const int64_t lo = p0 < p1 ? p0 : p1;
        const int64_t hi = p0 < p1 ? p1 : p0;
        const int64_t minor = min0 + (int64_t)smin * j;
        int64_t ax = xmaj ? lo : minor;
        int64_t bx = xmaj ? hi : minor;
        int64_t ay = xmaj ? minor : lo;
        int64_t by = xmaj ? minor : hi;
        if (ax < cs) ax = cs;
        if (bx > ce - 1) bx = ce - 1;
        if (ay < rs) ay = rs;
        if (by > re - 1) by = re - 1;
        if (ax <= bx && ay <= by)
            live((int32_t)ax, (int32_t)bx, (int32_t)ay, (int32_t)by);
        k0 = k1 + 1;
    }
}

extern "C" {

// Pass 1: total run count over valid lines.
int64_t pcr_line_runs_count(const int32_t* ix0, const int32_t* iy0,
                            const int32_t* ix1, const int32_t* iy1,
                            const uint8_t* valid, int64_t n)
{
    int64_t total = 0;
#pragma omp parallel for schedule(static) reduction(+:total)
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const int64_t ddx = std::abs((int64_t)ix1[i] - ix0[i]);
        const int64_t ddy = std::abs((int64_t)iy1[i] - iy0[i]);
        total += (ddx < ddy ? ddx : ddy) + 1;
    }
    return total;
}

// Pass 2: emit clipped runs. clip_* give each point's home-tile cell range
// (end-exclusive). Runs that the clip empties are dropped, as the numpy
// route drops them (routing.line_rects). Returns the number of emitted
// rects, at most pcr_line_runs_count's.
int64_t pcr_line_runs_emit(const int32_t* ix0, const int32_t* iy0,
                           const int32_t* ix1, const int32_t* iy1,
                           const uint8_t* valid,
                           const int32_t* clip_cs, const int32_t* clip_rs,
                           const int32_t* clip_ce, const int32_t* clip_re,
                           int64_t n,
                           int32_t* out_ax, int32_t* out_bx,
                           int32_t* out_ay, int32_t* out_by,
                           int32_t* out_owner)
{
    // per-line output offsets (prefix over the live run counts) so the emit
    // loop is embarrassingly parallel: the staircase is walked twice, once
    // to count and once to write
    std::vector<int64_t> offs(n + 1, 0);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int64_t runs = 0;
        if (valid[i])
            line_live_runs(ix0[i], iy0[i], ix1[i], iy1[i], clip_cs[i],
                           clip_rs[i], clip_ce[i], clip_re[i],
                           [&](int32_t, int32_t, int32_t, int32_t) {
                               ++runs;
                           });
        offs[i + 1] = runs;
    }
    for (int64_t i = 0; i < n; ++i) offs[i + 1] += offs[i];
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        int64_t m = offs[i];
        line_live_runs(ix0[i], iy0[i], ix1[i], iy1[i], clip_cs[i],
                       clip_rs[i], clip_ce[i], clip_re[i],
                       [&](int32_t ax, int32_t bx, int32_t ay, int32_t by) {
                           out_ax[m] = ax;
                           out_bx[m] = bx;
                           out_ay[m] = ay;
                           out_by[m] = by;
                           out_owner[m] = (int32_t)i;
                           ++m;
                       });
    }
    return offs[n];
}

} // extern "C"

// ---------------------------------------------------------------------------
// Single-pass reduction finalizes. The numpy forms need 3-4 full-array
// passes each (compare, guard, divide, select) — on a slow host that is
// the dominant cost of a CPU-mode finalize at 10M+ cells. One fused pass
// with the empty-cell NaN semantics of builtin_ops.h:29,42,55.
// ---------------------------------------------------------------------------

#include <limits>

extern "C" {

void pcr_fin_avg(const float* sum, const float* cnt, float* out, int64_t n)
{
    const float nan = std::numeric_limits<float>::quiet_NaN();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        out[i] = cnt[i] > 0.0f ? sum[i] / cnt[i] : nan;
}

// max/min/count: empty cells carry `sentinel` (-FLT_MAX / FLT_MAX / 0).
void pcr_fin_sentinel(const float* s, float* out, int64_t n, float sentinel)
{
    const float nan = std::numeric_limits<float>::quiet_NaN();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        out[i] = s[i] == sentinel ? nan : s[i];
}

void pcr_fin_count(const float* s, float* out, int64_t n)
{
    const float nan = std::numeric_limits<float>::quiet_NaN();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        out[i] = s[i] > 0.0f ? s[i] : nan;
}

// ---------------------------------------------------------------------------
// Packed rotated-splat layout (tpu_backend._bucket_blocks_2d_packed): the
// numpy formulation materializes ~10 E-length int64 arrays plus a stable
// argsort — on this class of 1-core host that costs minutes at 5M points,
// nearly all of it first-touch page faults and radix passes. These two
// fused passes never materialize the expansion: counts go straight into
// the (nbc, 4) histogram, and placement iterates points in order (which IS
// the stable sort order: copies ascend by point index within every fine
// bucket, and each copy's (row-block, quarter) pairs are emitted row-major
// exactly like the numpy o // kq / o % kq decomposition).
// ---------------------------------------------------------------------------

static inline void rotp_ranges(float rlo, float rhi, float wlo, float whi,
                               int32_t th, int64_t* r0, int64_t* r1,
                               int64_t* q0, int64_t* q1)
{
    // inputs are integral, >= 0 floats (host-clipped windows; dead points
    // carry wlo=1 > whi=0), so (int64) truncation matches numpy's floor
    *r0 = (int64_t)rlo / th;
    *r1 = (int64_t)rhi / th;
    if (*r1 < *r0) *r1 = *r0;
    *q0 = (int64_t)wlo / 32;
    *q1 = (int64_t)whi / 32;
    if (*q1 < *q0) *q1 = *q0;
}

void pcr_rotp_counts(const float* rlo, const float* rhi,
                     const float* wlo, const float* whi,
                     int64_t n, int32_t th, int32_t ncb, int32_t nbc,
                     int32_t* cf /* nbc*4, zeroed here */)
{
    std::memset(cf, 0, (size_t)nbc * 4 * sizeof(int32_t));
    for (int64_t i = 0; i < n; ++i) {
        int64_t r0, r1, q0, q1;
        rotp_ranges(rlo[i], rhi[i], wlo[i], whi[i], th, &r0, &r1, &q0, &q1);
        for (int64_t rb = r0; rb <= r1; ++rb) {
            int32_t* row = cf + (rb * ncb) * 4;
            for (int64_t q = q0; q <= q1; ++q)
                row[(q >> 2) * 4 + (q & 3)]++;
        }
    }
}

void pcr_rotp_place(const float* rlo, const float* rhi,
                    const float* wlo, const float* whi,
                    int64_t n, int32_t th, int32_t ncb, int32_t nbc,
                    const int64_t* base_b /* nbc entry offsets */,
                    int32_t* counters /* nbc*4 scratch, zeroed here */,
                    int32_t G, int32_t block,
                    int64_t* slots, int64_t E /* prefilled here to -1 */)
{
    std::memset(counters, 0, (size_t)nbc * 4 * sizeof(int32_t));
    std::memset(slots, 0xFF, (size_t)E * sizeof(int64_t));   // -1
    for (int64_t i = 0; i < n; ++i) {
        int64_t r0, r1, q0, q1;
        rotp_ranges(rlo[i], rhi[i], wlo[i], whi[i], th, &r0, &r1, &q0, &q1);
        for (int64_t rb = r0; rb <= r1; ++rb) {
            for (int64_t q = q0; q <= q1; ++q) {
                const int64_t b = rb * ncb + (q >> 2);
                const int32_t slot = (int32_t)(q & 3);
                const int32_t rank = counters[b * 4 + slot]++;
                slots[base_b[b] + (int64_t)(rank / G) * block
                      + (int64_t)slot * G + rank % G] = i;
            }
        }
    }
}

} // extern "C"

// K2 — the separable Gaussian sorted splat, hand-written for Hopper (sm_90a).
//
// Replaces the gauss mode of pcr_tpu/engine/pallas_kernels.py
// ::build_sorted_splat_pallas (two_d=True, with corr_offsets). Same contract:
//
//   params  (nsub, 8, kBlock) int32   [icx | icy | sub_cx | sub_cy | sx | sy |
//                                      r | f0]  (sub_cx .. sy and f0 are f32
//                                      bit patterns; dead entries carry r = -1)
//   bids    (nsub,) int32, ascending  tile id = row_block * ncb + col_block
//   s0, s1  (H_pad, W_pad) float32    state fields, updated IN PLACE
//
// Every entry deposits the separable footprint wy[h] * wx[w] over the cells
// of its sub-chunk's (th, wt) tile: f0 * wy * wx into field 0 and wy * wx into
// field 1 (Average / WeightedAverage). The factors are the TPU kernel's:
// wy = exp(-0.5 ((h - icy - sub_cy) / sy)^2), masked to |h - icy| <= r,
// wy >= 1e-6, h < H and, on a multi-tile grid, the rows of the entry's home
// tile (row_offset / global_h give a row-offset view its global frame); wx
// the same along columns. Runs with bids outside [0, nb_total) are skipped.
//
// Departure from the TPU design: the product cutoff. The reference drops a
// (cell, point) pair whose weight wy * wx is below 1e-6. The TPU contracts
// the factors on its matrix unit, which cannot mask a product, so it stacks
// "corr" rows that subtract the below-cutoff corner products again, and
// routes the rest to the dense kernel. Here every product is formed in a
// register anyway, so with `cut` set the kernel simply drops each pair with
// wy * wx < 1e-6 — the same factor bits, the same test. This computes what
// the corr rows compute, for every offset at once; the caller passes cut =
// (corr_offsets is not empty), as the TPU's routing decides.
//
// Design. One CTA of 128 threads owns 8 rows x 128 columns of one state tile
// for the whole launch (csrc/splat_walk.cuh), so a (64, 128) tile is eight
// CTAs and a (128, 128) tile sixteen: about a thousand CTAs on a 1000 x 1000
// grid at every sigma, where one CTA per tile gave 64 to 256. Nothing else
// writes the slice, so no atomics are needed and every sum has a fixed
// order. Thread t holds column t's 8 cells of each field in registers, so a
// warp owns a block of 8 rows x 32 columns. The run's entries stream through
// shared memory in pieces of kPiece, the next piece copied by cp.async while
// this one is walked. When a piece has landed, one thread per entry forms
// its masked column and row ranges [clo, chi] x [rlo, rhi] (the +-r window
// clipped to the grid and, on a multi-tile grid, to the home tile; the
// integer divisions once per entry and CTA), empty ranges made unhittable,
// and a 16-byte record of what wx needs; then one thread per (entry, row)
// forms wy for the slice's 8 rows (0 outside the range and below 1e-6, as
// the TPU kernel masks it; skipped where a warp's entries all miss the
// slice). Each warp then tests 32 entries at a time against its block,
// ballots, and walks only the hits, in entry order: four broadcast loads
// bring the record, the column range and the eight wy, each lane forms wx
// for its column, and the eight rows take their products with no branch. A
// cell's terms are added in entry order within a sub-chunk, and the
// sub-chunk's sum is added to the state, once per cell and sub-chunk, as
// in the first version: a masked factor's term was 0 there and adds nothing
// here, so the two give the same bits.
//
// What bounds it: instruction issue in the hit walk, about 55-70
// instructions a hit, half of them wx (an IEEE division and an expf), one
// dependent chain a hit; bytes do not matter (32 B per entry, re-read from
// L2 by a run's slices). The first version formed th x wt products per
// entry and field from factors staged in shared memory (21 times the
// window's cells at sigma 4) and made factors for every row and column of
// the tile; the walk forms 8 x 32 products per hit, wx only for a hit
// block's columns, and wy once per entry and slice. Forming wy in the walk
// (one lane a row, passed round by shuffles) cost 8 shuffles and 13 scalar
// shared-memory loads a hit, and was a fifth slower. The registers are
// capped at 64 a thread (8 CTAs an SM): more warps in flight hid more of
// the factor chain's latency than the extra registers did.

#include "splat_walk.cuh"

namespace {

using namespace splat;

constexpr int kPiece = 256;          // entries staged at a time
constexpr int kMinCtas = 8;          // CTAs an SM: 64 registers a thread
constexpr int kSeg = 8;
constexpr int kNever = 1 << 30;      // an empty range's lo; hi = -kNever
// words per staged entry: its segments, its ranges, the column record
// and ranges, and its eight wy
constexpr int kSmemBytes = (kSeg + 4 + 4 + 2 + 8) * kPiece * 4;

struct GaussGeom {
  int th, wt, ncb, nb_total, w_pad;
  int H, W, multi_tile, tile_w, tile_h, row_offset, global_h;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One axis factor of the TPU kernel: exp(-0.5 q^2), q = ((x - ic) - sub) / s,
// where x lies in [lo, hi] and the factor is at least 1e-6; else 0. x and ic
// come as floats (whole numbers).
__device__ __forceinline__ float axis_factor(float x, bool inside, float ic,
                                             float sub, float s) {
  const float q = (x - ic) - sub;
  const float qq = q / s;
  const float w = expf(-0.5f * qq * qq);
  return inside && w >= 1e-6f ? w : 0.0f;
}

template <int NF, bool CUT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
sorted_splat_gauss_kernel(const int32_t* __restrict__ params,
                          const int32_t* __restrict__ bids, int64_t nsub,
                          float* __restrict__ s0, float* __restrict__ s1,
                          GaussGeom g) {
  constexpr int kPieces = kBlock / kPiece;
  // the staged piece as it came, then what the walk reads of it
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* ent = smem;                         // [kSeg][kPiece]
  int32_t* win = ent + kSeg * kPiece;          // [4][kPiece], for the ballot
  float4* col_rec = reinterpret_cast<float4*>(win + 4 * kPiece);
  int2* col_win = reinterpret_cast<int2*>(col_rec + kPiece);
  float* wys = reinterpret_cast<float*>(col_win + kPiece);  // [kPiece][8]
  const float* entf = reinterpret_cast<const float*>(ent);

  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int col_slices = g.wt / kSliceCols;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row_lo = (bid / g.ncb) * g.th +
                     static_cast<int>(blockIdx.y) / col_slices * kSliceRows;
  const int col = (bid % g.ncb) * g.wt +
                  static_cast<int>(blockIdx.y) % col_slices * kSliceCols + t;
  const float colf = __int2float_rn(col);
  // the warp's block, inclusive
  const int c_lo = col - lane, c_hi = c_lo + 31;
  const int r_hi = row_lo + kSliceRows - 1;

  const int32_t* run = params + first * kSeg * kBlock;
  const int64_t npiece = (run_end(bids, first, nsub, bid) - first) * kPieces;
  float acc0[kSliceRows], acc1[NF == 2 ? kSliceRows : 1];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    acc0[i] = 0.0f;
    if constexpr (NF == 2) acc1[i] = 0.0f;
  }

  stage_piece<kSeg, kPiece>(ent, run, 0);
  for (int64_t q = 0; q < npiece; ++q) {
    cp_async_wait_all();
    __syncthreads();  // piece q has landed; the walk of piece q - 1 is over
    for (int e = t; e < kPiece; e += kThreads) {
      const int icx = ent[e], icy = ent[kPiece + e], r = ent[6 * kPiece + e];
      int clo = icx - r, chi = min(icx + r, g.W - 1);
      int rlo = icy - r, rhi = min(icy + r, g.H - 1);
      if (g.multi_tile) {
        const int cs = (clampi(icx, 0, g.W - 1) / g.tile_w) * g.tile_w;
        clo = max(clo, cs);
        chi = min(chi, min(cs + g.tile_w, g.W) - 1);
        const int rowc = clampi(icy + g.row_offset, 0, g.global_h - 1);
        const int rs = (rowc / g.tile_h) * g.tile_h - g.row_offset;
        const int re = min(rs + g.row_offset + g.tile_h, g.global_h) -
                       g.row_offset;
        rlo = max(rlo, rs);
        rhi = min(rhi, re - 1);
      }
      if (r < 0 || clo > chi || rlo > rhi) {
        clo = rlo = kNever;
        chi = rhi = -kNever;
      }
      win[e] = clo;
      win[kPiece + e] = chi;
      win[2 * kPiece + e] = rlo;
      win[3 * kPiece + e] = rhi;
      // float(icx), sub_cx, sx, f0 | clo, chi
      col_rec[e] = make_float4(__int2float_rn(icx), entf[2 * kPiece + e],
                               entf[4 * kPiece + e], entf[7 * kPiece + e]);
      col_win[e] = make_int2(clo, chi);
    }
    __syncthreads();
    // wy of the slice's 8 rows for every entry, one (entry, row) a thread
    // and turn; a warp whose four entries all miss the slice's rows skips
    for (int k = t; k < kPiece * kSliceRows; k += kThreads) {
      const int e = k / kSliceRows, h = row_lo + k % kSliceRows;
      const int rlo = win[2 * kPiece + e], rhi = win[3 * kPiece + e];
      float wy = 0.0f;
      if (rlo <= r_hi && rhi >= row_lo)
        wy = axis_factor(__int2float_rn(h), h >= rlo && h <= rhi,
                         __int2float_rn(ent[kPiece + e]),
                         entf[3 * kPiece + e], entf[5 * kPiece + e]);
      wys[k] = wy;
    }
    __syncthreads();  // the records are written; `ent` is free again
    if (q + 1 < npiece) stage_piece<kSeg, kPiece>(ent, run, q + 1);

    for (int e0 = 0; e0 < kPiece; e0 += 32) {
      const int e = e0 + lane;
      // an entry hits the block exactly when its ranges share a cell with it
      unsigned hits = __ballot_sync(
          kAll, win[e] <= c_hi && win[kPiece + e] >= c_lo &&
                    win[2 * kPiece + e] <= r_hi &&
                    win[3 * kPiece + e] >= row_lo);
      while (hits) {  // the warp's hits, in entry order
        const int k = e0 + __ffs(hits) - 1;
        hits &= hits - 1;
        const float4 c = col_rec[k];
        const int2 cw = col_win[k];
        const float4 w0 = reinterpret_cast<const float4*>(wys)[2 * k];
        const float4 w1 = reinterpret_cast<const float4*>(wys)[2 * k + 1];
        const float wy[kSliceRows] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
        const float wx =
            axis_factor(colf, col >= cw.x && col <= cw.y, c.x, c.y, c.z);
        const float a = wx * c.w;
        // no branch in the rows: a masked factor is 0 and adds nothing
#pragma unroll
        for (int i = 0; i < kSliceRows; ++i) {
          if constexpr (CUT) {
            const float prod = wy[i] * wx;
            if (prod >= 1e-6f) {
              acc0[i] = fmaf(wy[i], a, acc0[i]);
              if constexpr (NF == 2) acc1[i] += prod;
            }
          } else {
            acc0[i] = fmaf(wy[i], a, acc0[i]);
            if constexpr (NF == 2) acc1[i] = fmaf(wy[i], wx, acc1[i]);
          }
        }
      }
    }
    if (q % kPieces == kPieces - 1) {
      // the sub-chunk's last piece: one read-modify-write per cell
#pragma unroll
      for (int i = 0; i < kSliceRows; ++i) {
        const int64_t off = static_cast<int64_t>(row_lo + i) * g.w_pad + col;
        s0[off] += acc0[i];
        acc0[i] = 0.0f;
        if constexpr (NF == 2) {
          s1[off] += acc1[i];
          acc1[i] = 0.0f;
        }
      }
    }
  }
}

template <int NF, bool CUT>
int launch(const int32_t* p, const int32_t* b, int64_t nsub, float* f0,
           float* f1, const GaussGeom& g, int slices, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      sorted_splat_gauss_kernel<NF, CUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nsub), static_cast<unsigned>(slices));
  sorted_splat_gauss_kernel<NF, CUT><<<grid, kThreads, kSmemBytes, st>>>(
      p, b, nsub, f0, f1, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_sorted_splat_gauss_block() { return kBlock; }
int pcr_sorted_splat_gauss_piece() { return kPiece; }

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// th must be a multiple of 8 and wt of 128; `slices` and `smem` are the
// wrapper's plan (gauss_kernels.splat_plan). Allocates nothing and does not
// synchronise.
int pcr_sorted_splat_gauss(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, int nf, int cut, int th, int wt,
                           int ncb, int nb_total, int w_pad, int H, int W,
                           int multi_tile, int tile_w, int tile_h,
                           int row_offset, int global_h, int slices, int smem,
                           void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  // the wrapper plans the grid and the shared memory; both must be the
  // kernel's own
  if (th % kSliceRows || wt % kSliceCols || (nf != 1 && nf != 2) ||
      slices != (th / kSliceRows) * (wt / kSliceCols) || smem != kSmemBytes ||
      reinterpret_cast<uintptr_t>(params) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const GaussGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                    tile_w, tile_h, row_offset, global_h};
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  if (nf == 1)
    return cut ? launch<1, true>(p, b, nsub, f0, f1, g, slices, st)
               : launch<1, false>(p, b, nsub, f0, f1, g, slices, st);
  return cut ? launch<2, true>(p, b, nsub, f0, f1, g, slices, st)
             : launch<2, false>(p, b, nsub, f0, f1, g, slices, st);
}

}  // extern "C"

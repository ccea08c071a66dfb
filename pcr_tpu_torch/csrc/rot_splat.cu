// K4 and K5 — the rotated-Gaussian splats, hand-written for Hopper (sm_90a).
//
// K4 replaces the rot mode of pcr_tpu/engine/pallas_kernels.py
// ::build_sorted_splat_pallas (two_d=True): the dense rotated splat. K5
// replaces ::build_rot_packed_pallas: the same contributions per entry, in a
// host-clipped window. Both evaluate the reference's rotated quadratic form
// (glyph_kernels.cu:145-176) in the completed-square form the host builds
// (TpuEngine._rot_quadratic_segs), with sqrt(log2 e) folded into sC and sA2:
//
//   dx = (ws - icx) - sub_cx,  dy = (hs - icy) - sub_cy,
//   gq = -(dx * sA2)^2,  v = (dy + dx * s) * sC,  q2n = gq - v^2,
//   w = exp2(q2n) where q2n >= -19.931569
//
// (-19.931569 = -ln(1e6) log2(e): the reference's 1e-6 PRODUCT cutoff), and
// add f0 * w to field 0 and w to field 1. The distance to the centre is the
// reference's own (engine/cpu_backend.py: rdx = float32(dx) - sub_cx): the
// integer difference ws - icx is exact in float32 (both below 2^24) and is
// rounded once with the sub-cell offset. The TPU kernel instead adds the
// cell to a plane xoff = -(icx + sub_cx) that was rounded at the cell's
// absolute coordinate, which loses up to 6e-5 of a cell at ~1000 and 5e-4
// at ~8000 (a weight error of 1.8e-3 relative there); and it forms v = hs *
// sC + (dx * s + yoff) * sC, two products of the absolute row whose
// difference is a few cells. Here dx and dy are exact to one rounding
// whatever the row and column, and a row-offset view (local icy) gives the
// whole grid's bits. Every product and sum of the chain is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn), as the plain version rounds it,
// so no contraction into an FMA moves a weight across the cutoff.
//
// K4  params (nsub, 9, kBlock) f32 [sub_cx | sub_cy | s | sC | sA2 | f0 |
//     icx | icy | r]; the masks are the TPU kernel's, computed here: columns
//     |ws - icx| <= r, ws < W and the home tile's columns; rows
//     [icy - r, icy + r] clipped to the grid or, on a multi-tile grid, to the
//     home tile's rows (row_offset / global_h give a row-offset view its
//     global frame). Dead entries carry r = -1. Tiles (th, wt) = (32, 128).
// K5  params (nsub, 12, kBlock) f32 [sub_cx | sub_cy | s | sC | sA2 | f0 |
//     wlo | whi | rlo | rhi | icx | icy]; the window [wlo, whi] x [rlo, rhi]
//     was clipped on the host (grid and home tile), so the centre cell rides
//     in two planes of its own (48 B an entry, 40 B before). Tiles (th, wt)
//     = (16, 128).
//
// The TPU's K5 packs four entries into the 32-lane quarters of its vector
// unit (quarter-slot packing, a quad-major wire and a 3-limb bf16 selection
// matmul to expand it); all of that exists only for the TPU's lanes. Here K5
// takes the port's own layout: entries bucketed per (16-row x 128-col) tile
// that their clipped window touches, sub-chunk-major like K4.
//
// Design. One CTA of 128 threads owns 8 rows x 128 columns of one state tile
// for the whole launch (csrc/splat_walk.cuh): a 32 x 128 tile of K4 is four
// such slices, a 16 x 128 tile of K5 two, so a 1000 x 1000 grid gives about
// a thousand CTAs where one CTA per tile gave 256. Nothing else writes the
// slice, so there are no atomics and reruns are bit-identical. Thread t holds
// column t's 8 cells of each field in registers, so a warp owns a block of
// 8 rows x 32 columns. The run's entries stream through shared memory in
// pieces of kPiece, the next piece copied by cp.async while this one is
// walked. When a piece has landed, one thread per entry turns it into what
// the walk reads: the clipped window [wlo, whi] x [rlo, rhi] (K4: from icx /
// icy / r, the grid and the home tile, the divisions of the home-tile clip
// once per entry and CTA, not once per thread; K5: the host's window as it
// is), empty windows made unhittable; two 16-byte records of the entry's
// coefficients and centre column; and dy = (hs - icy) - sub_cy for the
// slice's 8 rows, NaN for a row outside [rlo, rhi]. Each warp then tests 32 entries at a time against its
// block, ballots, and walks only the hits, in entry order: four 16-byte
// broadcast loads bring the records, each lane forms its column's half of
// the completed square once (NaN outside [wlo, whi]), and the eight rows
// are evaluated with no branch and no mask test: a NaN exponent fails the
// cutoff test like one below the cutoff, and only drops its term. So the
// eight chains overlap (with a uniform branch per row the walk was latency
// bound and took twice as long). A cell's terms are added in entry order
// within a sub-chunk and the sub-chunk's sum is added to the state, once
// per cell and sub-chunk, as in the first version: the two give the same
// bits.
//
// What bounds them: instruction issue in the hit walk. A hit costs about 83
// instructions, 8 a cell-row of 32 lanes (two adds, two multiplies, the
// cutoff test, the exp2 and the two accumulations) and 8 exp2 of the
// special-function unit's 16 a clock and SM; bytes do not matter (36-48 B
// per entry, re-read from L2 by a run's slices). About half the lanes of a
// hit lie outside the window (a 49-column window meets 2.5 blocks of 32).
// The first version evaluated every entry over its whole tile (4096 cells
// at K4 for a 49 x 49 window's share of it), and every thread repeated the
// per-entry mask arithmetic. The card's floor for the exp2 alone is about
// twice the float32 bound that counts it as one operation.

#include "splat_walk.cuh"

namespace {

using namespace splat;

constexpr int kPiece = 256;   // entries staged at a time
constexpr float kCut = -19.931569f;
constexpr float kNever = 3.0e38f;   // an empty window's wlo; whi = -kNever

struct RotGeom {
  int th, wt, ncb, nb_total, w_pad;
  int H, W, multi_tile, tile_w, tile_h, row_offset, global_h;
};

// words per staged entry: its segments, its window, three records
constexpr int smem_bytes(bool packed) {
  return ((packed ? 12 : 9) + 4 + 4 + 4 + 8) * kPiece * 4;
}

// exp2 of q2n in [kCut, 0]: one special-function instruction; exp2f's
// scaling for results below 2^-126 is not needed in that range.
__device__ __forceinline__ float exp2_cut(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K4's window of one entry, as the TPU kernel masks it: columns
// |ws - icx| <= r, ws < W and the home tile's columns; rows [icy - r,
// icy + r] clipped to the grid or, on a multi-tile grid, to the home tile's
// rows. icx, icy and r are whole numbers, so the sums are exact.
__device__ __forceinline__ void dense_window(float icx, float icy, float r,
                                             const RotGeom& g, float& wlo,
                                             float& whi, float& rlo,
                                             float& rhi) {
  const float W = static_cast<float>(g.W);
  wlo = icx - r;
  whi = fminf(icx + r, W - 1.0f);
  rlo = icy - r;
  rhi = icy + r;
  if (g.multi_tile) {
    const float tw = static_cast<float>(g.tile_w);
    const float cs = floorf(fminf(fmaxf(icx, 0.0f), W - 1.0f) / tw) * tw;
    wlo = fmaxf(wlo, cs);
    whi = fminf(whi, fminf(cs + tw, W) - 1.0f);
    const float off = static_cast<float>(g.row_offset);
    const float hg1 = static_cast<float>(g.global_h - 1);
    const float tht = static_cast<float>(g.tile_h);
    const float rs = floorf(fminf(fmaxf(icy + off, 0.0f), hg1) / tht) * tht;
    rlo = fmaxf(rlo, rs - off);
    rhi = fminf(rhi, fminf(rs + tht - 1.0f, hg1) - off);
  } else {
    rhi = fminf(rhi, static_cast<float>(g.H - 1));
  }
  if (r < 0.0f) whi = wlo - 1.0f;  // a dead entry
}

// The completed square's row-independent half for one column.
struct ColHalf {
  float gq, dxs;
};

__device__ __forceinline__ ColHalf col_half(float ws, float icx,
                                            float sub_cx, float s,
                                            float sA2) {
  const float dx = __fsub_rn(__fsub_rn(ws, icx), sub_cx);
  const float u = __fmul_rn(dx, sA2);
  return {-__fmul_rn(u, u), __fmul_rn(dx, s)};
}

// q2n = gq - ((dy + dx * s) * sC)^2, the negated exponent in log2 units.
__device__ __forceinline__ float rot_q2n(float dy, float sC, const ColHalf& c) {
  const float v = __fmul_rn(__fadd_rn(dy, c.dxs), sC);
  return __fsub_rn(c.gq, __fmul_rn(v, v));
}

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
rot_splat_kernel(const float* __restrict__ params,
                 const int32_t* __restrict__ bids, int64_t nsub,
                 float* __restrict__ s0, float* __restrict__ s1, int nf,
                 RotGeom g) {
  constexpr int kSeg = PACKED ? 12 : 9;
  constexpr int kIcx = PACKED ? 10 : 6;  // the planes of the centre cell
  constexpr int kPieces = kBlock / kPiece;
  // the staged piece as it came, then what the walk reads of it
  extern __shared__ __align__(16) float smem[];
  float* ent = smem;                           // [kSeg][kPiece]
  float* win = ent + kSeg * kPiece;            // [4][kPiece], for the ballot
  float4* col_rec = reinterpret_cast<float4*>(win + 4 * kPiece);
  float4* row_rec = col_rec + kPiece;          // one of each per entry
  float4* dys = row_rec + kPiece;              // two per entry: 8 rows' dy

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
  const float ws = static_cast<float>(col);
  const float hs0 = static_cast<float>(row_lo);
  // the warp's block, inclusive
  const float c_lo = static_cast<float>(col - lane), c_hi = c_lo + 31.0f;
  const float r_lo = hs0, r_hi = hs0 + (kSliceRows - 1);
  const float nan = __int_as_float(0x7fc00000);

  const float* run = params + first * kSeg * kBlock;
  const int64_t npiece = (run_end(bids, first, nsub, bid) - first) * kPieces;
  float acc0[kSliceRows], acc1[kSliceRows];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) acc0[i] = acc1[i] = 0.0f;

  stage_piece<kSeg, kPiece>(ent, run, 0);
  for (int64_t q = 0; q < npiece; ++q) {
    cp_async_wait_all();
    __syncthreads();  // piece q has landed; the walk of piece q - 1 is over
    for (int e = t; e < kPiece; e += kThreads) {
      float wlo, whi, rlo, rhi;
      if constexpr (PACKED) {
        wlo = ent[6 * kPiece + e];
        whi = ent[7 * kPiece + e];
        rlo = ent[8 * kPiece + e];
        rhi = ent[9 * kPiece + e];
      } else {
        dense_window(ent[6 * kPiece + e], ent[7 * kPiece + e],
                     ent[8 * kPiece + e], g, wlo, whi, rlo, rhi);
      }
      if (!(wlo <= whi && rlo <= rhi)) {
        wlo = kNever;
        whi = -kNever;
      }
      win[e] = wlo;
      win[kPiece + e] = whi;
      win[2 * kPiece + e] = rlo;
      win[3 * kPiece + e] = rhi;
      // sub_cx, s, sA2, f0 | sC, wlo, whi, icx | dy of the slice's 8
      // rows, NaN for a row outside [rlo, rhi]: its cells then fail the
      // cutoff test
      col_rec[e] = make_float4(ent[e], ent[2 * kPiece + e],
                               ent[4 * kPiece + e], ent[5 * kPiece + e]);
      row_rec[e] = make_float4(ent[3 * kPiece + e], wlo, whi,
                               ent[kIcx * kPiece + e]);
      const float sub_cy = ent[kPiece + e];
      const float icy = ent[(kIcx + 1) * kPiece + e];
      float dy[kSliceRows];
#pragma unroll
      for (int i = 0; i < kSliceRows; ++i) {
        const float hs = hs0 + static_cast<float>(i);
        dy[i] = hs >= rlo && hs <= rhi
                    ? __fsub_rn(__fsub_rn(hs, icy), sub_cy)
                    : nan;
      }
      dys[2 * e] = make_float4(dy[0], dy[1], dy[2], dy[3]);
      dys[2 * e + 1] = make_float4(dy[4], dy[5], dy[6], dy[7]);
    }
    __syncthreads();  // the records are written; `ent` is free again
    if (q + 1 < npiece) stage_piece<kSeg, kPiece>(ent, run, q + 1);

    for (int e0 = 0; e0 < kPiece; e0 += 32) {
      const int e = e0 + lane;
      // an entry hits the block exactly when its window shares a cell with it
      unsigned hits = __ballot_sync(
          kAll, win[e] <= c_hi && win[kPiece + e] >= c_lo &&
                    win[2 * kPiece + e] <= r_hi &&
                    win[3 * kPiece + e] >= r_lo);
      while (hits) {  // the warp's hits, in entry order
        const int k = e0 + __ffs(hits) - 1;
        hits &= hits - 1;
        const float4 c = col_rec[k], r = row_rec[k];
        const float4 d0 = dys[2 * k], d1 = dys[2 * k + 1];
        const float dy[kSliceRows] = {d0.x, d0.y, d0.z, d0.w,
                                      d1.x, d1.y, d1.z, d1.w};
        ColHalf ch = col_half(ws, r.w, c.x, c.y, c.z);
        if (!(ws >= r.y && ws <= r.z)) ch.gq = nan;  // outside the columns
        // no branch in the rows: the eight chains overlap, and a cell
        // outside the window (NaN) or below the cutoff only drops its term
#pragma unroll
        for (int i = 0; i < kSliceRows; ++i) {
          const float q2n = rot_q2n(dy[i], r.x, ch);
          const float w = exp2_cut(q2n);
          if (q2n >= kCut) {
            acc0[i] = fmaf(c.w, w, acc0[i]);
            acc1[i] += w;
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
        if (nf == 2) s1[off] += acc1[i];
        acc0[i] = acc1[i] = 0.0f;
      }
    }
  }
}

template <bool PACKED>
int launch(const void* params, const void* bids, int64_t nsub, void* s0,
           void* s1, int nf, const RotGeom& g, int slices, int smem,
           void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  // the wrapper plans the grid and the shared memory; both must be the
  // kernel's own
  if (g.th % kSliceRows || g.wt % kSliceCols || (nf != 1 && nf != 2) ||
      slices != (g.th / kSliceRows) * (g.wt / kSliceCols) ||
      smem != smem_bytes(PACKED) ||
      reinterpret_cast<uintptr_t>(params) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rot_splat_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nsub), static_cast<unsigned>(slices));
  rot_splat_kernel<PACKED>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(params),
          static_cast<const int32_t*>(bids), nsub, static_cast<float*>(s0),
          static_cast<float*>(s1), nf, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_rot_splat_block() { return kBlock; }
int pcr_rot_splat_piece() { return kPiece; }

// K4: launches the dense rotated splat on `stream`; returns the cudaError_t
// of the launch (0 = ok). th must be a multiple of 8, wt of 128; `slices`
// and `smem` are the wrapper's plan (gauss_kernels.splat_plan).
int pcr_rot_splat_dense(const void* params, const void* bids, int64_t nsub,
                        void* s0, void* s1, int nf, int th, int wt, int ncb,
                        int nb_total, int w_pad, int H, int W, int multi_tile,
                        int tile_w, int tile_h, int row_offset, int global_h,
                        int slices, int smem, void* stream) {
  const RotGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                  tile_w, tile_h, row_offset, global_h};
  return launch<false>(params, bids, nsub, s0, s1, nf, g, slices, smem,
                       stream);
}

// K5: launches the windowed rotated splat on `stream`; returns the
// cudaError_t of the launch (0 = ok). th must be a multiple of 8, wt of 128.
int pcr_rot_splat_packed(const void* params, const void* bids, int64_t nsub,
                         void* s0, void* s1, int nf, int th, int wt, int ncb,
                         int nb_total, int w_pad, int slices, int smem,
                         void* stream) {
  const RotGeom g{th, wt, ncb, nb_total, w_pad, 0, 0, 0, 1, 1, 0, 1};
  return launch<true>(params, bids, nsub, s0, s1, nf, g, slices, smem,
                      stream);
}

}  // extern "C"

// K4 and K5 — the rotated-Gaussian splats, hand-written for Hopper (sm_90a).
//
// K4 replaces the rot mode of pcr_tpu/engine/pallas_kernels.py
// ::build_sorted_splat_pallas (two_d=True): the dense rotated splat. K5
// replaces ::build_rot_packed_pallas: the same contributions per entry, in a
// host-clipped window. Both evaluate the reference's rotated quadratic form
// (glyph_kernels.cu:145-176) in the completed-square form the host builds
// (TpuEngine._rot_quadratic_segs), with sqrt(log2 e) folded into sC and sA2:
//
//   dx = ws + xoff,  dy = hs + yoff,  gq = -(dx * sA2)^2,
//   v = (dy + dx * s) * sC,  q2n = gq - v^2,  w = exp2(q2n) where
//   q2n >= -19.931569
//
// (-19.931569 = -ln(1e6) log2(e): the reference's 1e-6 PRODUCT cutoff), and
// add f0 * w to field 0 and w to field 1. This is the TPU kernel's q2n with
// one change of order: the TPU forms v = hs * sC + (dx * s + yoff) * sC, two
// products of the absolute row (about 1e3 on a 1000-row grid) whose
// difference is a few cells, so each loses a rounding of the large term.
// Here dy = hs + yoff is exact (hs is an integer beside yoff = -(icy +
// sub_cy)), and the per-term weight error against the reference's formula
// drops by about 1.6x (1.0e-4 vs 2.6e-4 at worst, 1.7e-5 vs 2.7e-5 in the
// mean, sigma 4 x 1.5 at row and column ~1000, from a numpy evaluation of
// the two orders). Every product and sum of the chain is rounded on its own
// (__fmul_rn / __fadd_rn), as the plain version rounds it, so no contraction
// into an FMA moves a weight across the cutoff.
//
// K4  params (nsub, 9, kBlock) f32  [xoff | yoff | s | sC | sA2 | f0 | icx |
//     icy | r]; the masks are the TPU kernel's, computed here: columns
//     |ws - icx| <= r, ws < W and the home tile's columns; rows
//     [icy - r, icy + r] clipped to the grid or, on a multi-tile grid, to the
//     home tile's rows (row_offset / global_h give a row-offset view its
//     global frame). Dead entries carry r = -1. Tiles (th, wt) = (32, 128).
// K5  params (nsub, 10, kBlock) f32 [xoff | yoff | s | sC | sA2 | f0 | wlo |
//     whi | rlo | rhi]; the window [wlo, whi] x [rlo, rhi] was clipped on the
//     host (grid and home tile). Tiles (th, wt) = (16, 128).
//
// The TPU's K5 packs four entries into the 32-lane quarters of its vector
// unit (quarter-slot packing, a quad-major wire and a 3-limb bf16 selection
// matmul to expand it); all of that exists only for the TPU's lanes. Here K5
// takes the port's own layout: entries bucketed per (16-row x 128-col) tile
// that their clipped window touches, sub-chunk-major like K4.
//
// Design. One CTA owns one run of equal bids (one state tile) and walks its
// sub-chunks in order; nothing else writes the tile, so there are no atomics
// and reruns are bit-identical. The tile is covered in passes of (8 * MR) rows
// x 128 columns: each of the 256 threads holds MR rows x 4 columns of cells
// (rows ty*MR.., columns tx + 32 j) in registers, MR = 4 for K4 (a 32 x 128
// tile, 4096 cells, in one pass) and MR = 2 for K5 (16 x 128, 2048 cells).
// Entries stream through shared memory kStage at a time; per entry a thread
// forms the column half (gq, dx * s, column mask) of its 4 columns and the row
// bounds once, then its MR x 4 cells. The state is read and written once per
// cell per sub-chunk.
//
// What bounds them: the per-cell exp2 and the ~8 multiply-adds around it,
// over the whole tile for every entry (K4: 32 x 128 cells per entry; K5:
// 16 x 128), i.e. the window area times the halo copies, not bytes (36-40 B
// per entry). Cells outside an entry's window skip the exp2 but still cost
// the mask test.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 2048;   // entries per sub-chunk
constexpr int kStage = 256;    // entries staged in shared memory at a time
constexpr int kCols = 128;     // columns per pass: 32 lanes x 4
constexpr float kCut = -19.931569f;

struct RotGeom {
  int th, wt, ncb, nb_total, w_pad;
  int H, W, multi_tile, tile_w, tile_h, row_offset, global_h;
};

// The completed square's row-independent half for one column.
struct ColHalf {
  float gq, dxs;
  bool ok;
};

__device__ __forceinline__ ColHalf col_half(float ws, float xoff, float s,
                                            float sA2, bool ok) {
  const float dx = __fadd_rn(ws, xoff);
  const float u = __fmul_rn(dx, sA2);
  return {-__fmul_rn(u, u), __fmul_rn(dx, s), ok};
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
  constexpr int MR = PACKED ? 2 : 4;
  constexpr int kRows = 8 * MR;
  constexpr int kSeg = PACKED ? 10 : 9;
  __shared__ float ent[kSeg][kStage];

  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int row0 = (bid / g.ncb) * g.th;
  const int col0 = (bid % g.ncb) * g.wt;
  const int t = threadIdx.x;
  const int tx = t & 31;
  const int ty = t >> 5;
  const float W = static_cast<float>(g.W);

  for (int64_t j = first; j < nsub && bids[j] == bid; ++j) {
    const float* p = params + j * kSeg * kBlock;
    for (int pr = 0; pr < g.th; pr += kRows) {
      for (int pc = 0; pc < g.wt; pc += kCols) {
        float hs[MR], ws[4];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          hs[i] = static_cast<float>(row0 + pr + ty * MR + i);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ws[c] = static_cast<float>(col0 + pc + tx + 32 * c);
        float acc0[MR][4], acc1[MR][4];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc0[i][c] = acc1[i][c] = 0.0f;

        for (int b0 = 0; b0 < kBlock; b0 += kStage) {
          for (int k = t; k < kSeg * kStage; k += kThreads)
            ent[k / kStage][k % kStage] =
                p[(k / kStage) * kBlock + b0 + k % kStage];
          __syncthreads();
          for (int e = 0; e < kStage; ++e) {
            const float xoff = ent[0][e], yoff = ent[1][e], s = ent[2][e];
            const float sC = ent[3][e], sA2 = ent[4][e], f0 = ent[5][e];
            float rlo, rhi;
            ColHalf ch[4];
            if constexpr (PACKED) {
              const float wlo = ent[6][e], whi = ent[7][e];
              rlo = ent[8][e];
              rhi = ent[9][e];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                ch[c] = col_half(ws[c], xoff, s, sA2,
                                 ws[c] >= wlo && ws[c] <= whi);
            } else {
              const float icx = ent[6][e], icy = ent[7][e], r = ent[8][e];
              float cs = 0.0f, ce = W;
              if (g.multi_tile) {
                const float tw = static_cast<float>(g.tile_w);
                cs = floorf(fminf(fmaxf(icx, 0.0f), W - 1.0f) / tw) * tw;
                ce = fminf(cs + tw, W);
              }
#pragma unroll
              for (int c = 0; c < 4; ++c)
                ch[c] = col_half(ws[c], xoff, s, sA2,
                                 fabsf(ws[c] - icx) <= r && ws[c] < W &&
                                     ws[c] >= cs && ws[c] < ce);
              rlo = icy - r;
              rhi = icy + r;
              if (g.multi_tile) {
                const float off = static_cast<float>(g.row_offset);
                const float hg1 = static_cast<float>(g.global_h - 1);
                const float tht = static_cast<float>(g.tile_h);
                const float rs =
                    floorf(fminf(fmaxf(icy + off, 0.0f), hg1) / tht) * tht;
                rlo = fmaxf(rlo, rs - off);
                rhi = fminf(rhi, fminf(rs + tht - 1.0f, hg1) - off);
              } else {
                rhi = fminf(rhi, static_cast<float>(g.H - 1));
              }
            }
#pragma unroll
            for (int i = 0; i < MR; ++i) {
              if (!(hs[i] >= rlo && hs[i] <= rhi)) continue;
              const float dy = __fadd_rn(hs[i], yoff);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (!ch[c].ok) continue;
                const float q2n = rot_q2n(dy, sC, ch[c]);
                if (q2n >= kCut) {
                  const float w = exp2f(q2n);
                  acc0[i][c] = fmaf(f0, w, acc0[i][c]);
                  acc1[i][c] += w;
                }
              }
            }
          }
          __syncthreads();  // the stage is refilled next
        }
        // one read-modify-write per cell for this sub-chunk
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int64_t row = row0 + pr + ty * MR + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int64_t off = row * g.w_pad + col0 + pc + tx + 32 * c;
            s0[off] += acc0[i][c];
            if (nf == 2) s1[off] += acc1[i][c];
          }
        }
      }
    }
  }
}

int launch(bool packed, const void* params, const void* bids, int64_t nsub,
           void* s0, void* s1, int nf, const RotGeom& g, void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  if (g.th % (packed ? 16 : 32) || g.wt % kCols || (nf != 1 && nf != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nsub));
  if (packed)
    rot_splat_kernel<true><<<grid, kThreads, 0, st>>>(p, b, nsub, f0, f1, nf,
                                                      g);
  else
    rot_splat_kernel<false><<<grid, kThreads, 0, st>>>(p, b, nsub, f0, f1, nf,
                                                       g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_rot_splat_block() { return kBlock; }

// K4: launches the dense rotated splat on `stream`; returns the cudaError_t
// of the launch (0 = ok). th must be a multiple of 32, wt of 128.
int pcr_rot_splat_dense(const void* params, const void* bids, int64_t nsub,
                        void* s0, void* s1, int nf, int th, int wt, int ncb,
                        int nb_total, int w_pad, int H, int W, int multi_tile,
                        int tile_w, int tile_h, int row_offset, int global_h,
                        void* stream) {
  const RotGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                  tile_w, tile_h, row_offset, global_h};
  return launch(false, params, bids, nsub, s0, s1, nf, g, stream);
}

// K5: launches the windowed rotated splat on `stream`; returns the
// cudaError_t of the launch (0 = ok). th must be a multiple of 16, wt of 128.
int pcr_rot_splat_packed(const void* params, const void* bids, int64_t nsub,
                         void* s0, void* s1, int nf, int th, int wt, int ncb,
                         int nb_total, int w_pad, void* stream) {
  const RotGeom g{th, wt, ncb, nb_total, w_pad, 0, 0, 0, 1, 1, 0, 1};
  return launch(true, params, bids, nsub, s0, s1, nf, g, stream);
}

}  // extern "C"

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
// Design. One CTA owns one run of equal bids (one state tile) and walks its
// sub-chunks in order; no other CTA writes the tile, so no atomics are needed
// and every sum has a fixed order. The tile is covered in passes of
// (8 * MR) rows x 128 columns. In a pass each of the 256 threads owns MR rows
// x 4 columns of cells (rows ty*MR.., columns tx + 32 j) in registers. The
// CTA stages the factors of kBatch entries at a time in shared memory
// (wy for the pass's rows, wx and wx * f0 for its columns), and every thread
// then adds the batch's products to its cells in entry order. The state is
// read and written once per cell per sub-chunk, after the sub-chunk's last
// batch. Reruns are bit-identical.
//
// What bounds it: the dense contraction, 2048 x th x wt multiply-adds per
// sub-chunk and field (about 60 G at sigma = 4 on 5M points), fed from
// shared memory: per entry a warp issues MR*4 (x2 fields) FMAs against
// about 1 + 8 shared-memory wavefronts. The factor generation (an IEEE
// division and an expf per entry and row / column) is the second cost.
// Bytes from device memory (32 B per entry) do not matter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 2048;  // entries per sub-chunk
constexpr int kBatch = 32;    // entries staged in shared memory at a time
constexpr int kCols = 128;    // columns per pass: 32 lanes x 4

struct GaussGeom {
  int th, wt, ncb, nb_total, w_pad;
  int H, W, multi_tile, tile_w, tile_h, row_offset, global_h;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One axis factor of the TPU kernel: exp(-0.5 q^2), q = ((x - ic) - sub) / s.
__device__ __forceinline__ float axis_factor(int x, int ic, float sub,
                                             float s) {
  const float q = (__int2float_rn(x) - __int2float_rn(ic)) - sub;
  const float qq = q / s;
  return expf(-0.5f * qq * qq);
}

template <int MR, int NF, bool CUT>
__global__ void __launch_bounds__(kThreads)
sorted_splat_gauss_kernel(const int32_t* __restrict__ params,
                          const int32_t* __restrict__ bids, int64_t nsub,
                          float* __restrict__ s0, float* __restrict__ s1,
                          GaussGeom g) {
  constexpr int kRows = 8 * MR;           // rows per pass
  constexpr bool kWx = NF == 2 || CUT;    // the bare wx is needed
  __shared__ float wy_s[kBatch][kRows];
  __shared__ float wxf_s[kBatch][kCols];
  __shared__ float wx_s[kWx ? kBatch : 1][kCols];

  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int row0 = (bid / g.ncb) * g.th;
  const int col0 = (bid % g.ncb) * g.wt;
  const int t = threadIdx.x;
  const int tx = t & 31;
  const int ty = t >> 5;

  for (int64_t j = first; j < nsub && bids[j] == bid; ++j) {
    const int32_t* p = params + j * 8 * kBlock;
    const float* pf = reinterpret_cast<const float*>(p);
    for (int pr = 0; pr < g.th; pr += kRows) {
      for (int pc = 0; pc < g.wt; pc += kCols) {
        float acc0[MR][4], acc1[NF == 2 ? MR : 1][4];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc0[i][c] = 0.0f;
            if constexpr (NF == 2) acc1[i][c] = 0.0f;
          }
        for (int b0 = 0; b0 < kBlock; b0 += kBatch) {
          // stage the batch's factors for this pass's rows and columns
          for (int k = t; k < kBatch * kRows; k += kThreads) {
            const int e = b0 + k / kRows;
            const int h = row0 + pr + k % kRows;
            const int icy = p[kBlock + e];
            const int r = p[6 * kBlock + e];
            const float w = axis_factor(h, icy, pf[3 * kBlock + e],
                                        pf[5 * kBlock + e]);
            bool ok = abs(h - icy) <= r && w >= 1e-6f && h < g.H;
            if (g.multi_tile) {
              const int rowc = clampi(icy + g.row_offset, 0, g.global_h - 1);
              const int rs = (rowc / g.tile_h) * g.tile_h - g.row_offset;
              const int re = min(rs + g.row_offset + g.tile_h, g.global_h) -
                             g.row_offset;
              ok = ok && h >= rs && h < re;
            }
            wy_s[k / kRows][k % kRows] = ok ? w : 0.0f;
          }
          for (int k = t; k < kBatch * kCols; k += kThreads) {
            const int e = b0 + k / kCols;
            const int x = col0 + pc + k % kCols;
            const int icx = p[e];
            const int r = p[6 * kBlock + e];
            const float w = axis_factor(x, icx, pf[2 * kBlock + e],
                                        pf[4 * kBlock + e]);
            bool ok = abs(x - icx) <= r && w >= 1e-6f && x < g.W;
            if (g.multi_tile) {
              const int cs = (clampi(icx, 0, g.W - 1) / g.tile_w) * g.tile_w;
              ok = ok && x >= cs && x < min(cs + g.tile_w, g.W);
            }
            const float wx = ok ? w : 0.0f;
            wxf_s[k / kCols][k % kCols] = wx * pf[7 * kBlock + e];
            if constexpr (kWx) wx_s[k / kCols][k % kCols] = wx;
          }
          __syncthreads();
#pragma unroll 4
          for (int e = 0; e < kBatch; ++e) {
            float wy[MR], a[4], b[4];
#pragma unroll
            for (int i = 0; i < MR; ++i) wy[i] = wy_s[e][ty * MR + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              a[c] = wxf_s[e][tx + 32 * c];
              if constexpr (kWx) b[c] = wx_s[e][tx + 32 * c];
            }
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if constexpr (CUT) {
                  const float prod = wy[i] * b[c];
                  if (prod >= 1e-6f) {
                    acc0[i][c] = fmaf(wy[i], a[c], acc0[i][c]);
                    if constexpr (NF == 2) acc1[i][c] += prod;
                  }
                } else {
                  acc0[i][c] = fmaf(wy[i], a[c], acc0[i][c]);
                  if constexpr (NF == 2) acc1[i][c] = fmaf(wy[i], b[c],
                                                           acc1[i][c]);
                }
              }
          }
          __syncthreads();  // the factors are restaged next
        }
        // one read-modify-write per cell for this sub-chunk
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int64_t row = row0 + pr + ty * MR + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int64_t off = row * g.w_pad + col0 + pc + tx + 32 * c;
            s0[off] += acc0[i][c];
            if constexpr (NF == 2) s1[off] += acc1[i][c];
          }
        }
      }
    }
  }
}

template <int MR>
int launch(const int32_t* p, const int32_t* b, int64_t nsub, float* f0,
           float* f1, int nf, int cut, const GaussGeom& g, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(nsub));
  if (nf == 1 && !cut)
    sorted_splat_gauss_kernel<MR, 1, false><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, g);
  else if (nf == 1)
    sorted_splat_gauss_kernel<MR, 1, true><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, g);
  else if (!cut)
    sorted_splat_gauss_kernel<MR, 2, false><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, g);
  else
    sorted_splat_gauss_kernel<MR, 2, true><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_sorted_splat_gauss_block() { return kBlock; }

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// th must be a multiple of 32 and wt of 128. Allocates nothing and does not
// synchronise.
int pcr_sorted_splat_gauss(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, int nf, int cut, int th, int wt,
                           int ncb, int nb_total, int w_pad, int H, int W,
                           int multi_tile, int tile_w, int tile_h,
                           int row_offset, int global_h, void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  if (th % 32 || wt % kCols || (nf != 1 && nf != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const GaussGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                    tile_w, tile_h, row_offset, global_h};
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  return th % 64 == 0 ? launch<8>(p, b, nsub, f0, f1, nf, cut, g, st)
                      : launch<4>(p, b, nsub, f0, f1, nf, cut, g, st);
}

}  // extern "C"

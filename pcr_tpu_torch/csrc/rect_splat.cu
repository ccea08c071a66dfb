// K3 — the deterministic rect (Line-run) splat, hand-written for Hopper
// (sm_90a).
//
// Replaces the rect mode of pcr_tpu/engine/pallas_kernels.py
// ::build_sorted_splat_pallas (two_d=True). Same contract as that kernel:
//
//   params  (nsub, 5, kBlock) int32   [ax | bx | ay | by | f0 bits]
//   bids    (nsub,) int32, ascending  tile id = row_block * ncb + col_block
//   s0, s1  (H_pad, W_pad) float32    state fields, updated IN PLACE
//
// Every entry is the inclusive cell rectangle [ax, bx] x [ay, by]. Its part
// inside the sub-chunk's (th, wt) tile adds f0 into field 0 and, with two
// fields (Average, WeightedAverage), 1.0 into field 1. Padding entries are
// the empty interval ax = 1 > bx = 0 (ay = 1 > by = 0); runs with bids
// outside [0, nb_total) are skipped; writes never leave the tile.
//
// Design. The TPU evaluates every entry over its whole 128 x 128 tile as a
// 0/1 outer product on the MXU, which costs it little. Here an entry is one
// Bresenham run: one row or one column of at most 2 * max_radius_cells + 1
// cells. So each run of equal bids (one state tile) is owned by a column
// of CTAs, one per 32-row slice of the tile; each loads its slice (in
// bands, when two fields of a wide tile would not fit) into shared memory
// and walks the run's sub-chunks in order. Each thread owns fixed cells:
// column `lane` (and every 128th column after it) of one quarter of the
// band's rows, so a warp owns a 32-column by 8-row block. Per sub-chunk the five segments are staged in
// shared memory; each warp then takes the entries 32 at a time, one per
// lane, tests them against its block, and ballots the hits. Only the hits
// are walked, in entry order, their fields broadcast with shuffles: each
// owning lane adds f0 (and 1.0) to its cells of the run. Each cell is
// written by one thread, in entry order, with no atomics: the result is a
// function of the input bits alone, and equal to the CPU plain version's
// index_add_, which adds in the same order.
//
// What bounds it: each warp scans every entry of its tile's run (a few
// shared-memory loads and a ballot per 32) and then walks its hits, each a
// dependent shared-memory read-modify-write per cell; bytes (20 B per
// entry) do not matter. The first version walked all 2048 entries in
// every warp, one dependent chain of shared-memory loads per entry, with
// one CTA per tile (64 of the 132 SMs on a 1000 x 1000 grid); the ballot
// cuts the walk to the warp's hits, and the row slices give each tile 4
// CTAs (72 KB of shared memory each, 3 to an SM), so every SM works and
// each has more warps to hide the walk's latency.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 128;                  // columns one pass covers
constexpr int kGroups = kThreads / kLanes;   // row groups per band
constexpr int kBlock = 2048;                 // entries per sub-chunk
constexpr int kSeg = 5;
constexpr int kSliceRows = 32;               // tile rows one CTA owns
constexpr int kBandFloats = 8192;            // 32 KB of state band
constexpr unsigned kAll = 0xffffffffu;

template <int NF>
__global__ void __launch_bounds__(kThreads)
rect_splat_kernel(const int32_t* __restrict__ params,
                  const int32_t* __restrict__ bids, int64_t nsub,
                  float* __restrict__ s0, float* __restrict__ s1, int th,
                  int wt, int ncb, int nb_total, int w_pad, int band_rows) {
  extern __shared__ float band0[];           // NF fields of the band
  __shared__ int32_t ent[kSeg * kBlock];     // the staged sub-chunk
  // One CTA per run of equal bids and row slice: only the CTAs of the
  // run's first sub-chunk work, the others leave at once.
  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int row0 = (bid / ncb) * th;
  const int col0 = (bid % ncb) * wt;
  const int t = threadIdx.x;
  const int lane = t % kLanes;
  const int group = t / kLanes;  // warp-uniform
  const int wl = t % 32;
  float* band1 = band0 + band_rows * wt;
  // the columns the warp owns span [c_lo, c_hi] (empty when wt < 128
  // leaves the warp none)
  const int wbase = lane - wl;
  const int c_lo = col0 + wbase;
  const int c_hi = wbase < wt
      ? col0 + min(wbase + 31 + kLanes * ((wt - 1 - wbase) / kLanes), wt - 1)
      : c_lo - 1;

  const int s_hi = min(static_cast<int>(blockIdx.y + 1) * kSliceRows, th);
  for (int b0 = blockIdx.y * kSliceRows; b0 < s_hi; b0 += band_rows) {
    const int rows = min(band_rows, s_hi - b0);
    const int r_lo = row0 + b0;
    for (int i = t; i < rows * wt; i += kThreads) {
      const int64_t off =
          static_cast<int64_t>(r_lo + i / wt) * w_pad + col0 + i % wt;
      band0[i] = s0[off];
      if constexpr (NF == 2) band1[i] = s1[off];
    }
    // this thread's rows of the band, absolute
    const int share = (rows + kGroups - 1) / kGroups;
    const int my_lo = r_lo + group * share;
    const int my_hi = min(r_lo + (group + 1) * share, r_lo + rows) - 1;

    for (int64_t j = first; j < nsub && bids[j] == bid; ++j) {
      __syncthreads();  // the band is loaded; the last sub-chunk is done
      const int32_t* p = params + j * kSeg * kBlock;
      for (int i = t; i < kSeg * kBlock; i += kThreads) ent[i] = p[i];
      __syncthreads();
      for (int e0 = 0; e0 < kBlock; e0 += 32) {
        const int e = e0 + wl;
        const int ax = ent[e];
        const int bx = ent[kBlock + e];
        const int ay = ent[2 * kBlock + e];
        const int by = ent[3 * kBlock + e];
        unsigned hits = __ballot_sync(
            kAll, max(ay, my_lo) <= min(by, my_hi) && ax <= c_hi &&
                      bx >= c_lo);
        while (hits) {  // the warp's hits, in entry order
          const int i = __ffs(hits) - 1;
          hits &= hits - 1;
          const int hax = __shfl_sync(kAll, ax, i);
          const int hbx = __shfl_sync(kAll, bx, i);
          const int lo = max(__shfl_sync(kAll, ay, i), my_lo);
          const int hi = min(__shfl_sync(kAll, by, i), my_hi);
          const float f0 = __int_as_float(ent[4 * kBlock + e0 + i]);
          for (int c = lane; c < wt; c += kLanes) {
            const int gc = col0 + c;
            if (gc < hax || gc > hbx) continue;
            for (int r = lo; r <= hi; ++r) {
              const int k = (r - r_lo) * wt + c;
              band0[k] += f0;
              if constexpr (NF == 2) band1[k] += 1.0f;
            }
          }
        }
      }
    }
    __syncthreads();
    for (int i = t; i < rows * wt; i += kThreads) {
      const int64_t off =
          static_cast<int64_t>(r_lo + i / wt) * w_pad + col0 + i % wt;
      s0[off] = band0[i];
      if constexpr (NF == 2) s1[off] = band1[i];
    }
    __syncthreads();  // the next band reuses the shared memory
  }
}

template <int NF>
int launch(const int32_t* p, const int32_t* b, int64_t nsub, float* f0,
           float* f1, int th, int wt, int ncb, int nb_total, int w_pad,
           cudaStream_t st) {
  const int band_rows =
      std::min(std::min(th, kSliceRows), kBandFloats / (NF * wt));
  if (band_rows < 1 || th < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the band is dynamic shared memory; the staged sub-chunk is static
  const int bytes = static_cast<int>(static_cast<int64_t>(NF) * band_rows *
                                     wt * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      rect_splat_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nsub),
                  static_cast<unsigned>((th + kSliceRows - 1) / kSliceRows));
  rect_splat_kernel<NF><<<grid, kThreads, bytes, st>>>(
      p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, band_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_rect_splat_block() { return kBlock; }

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Allocates nothing and does not synchronise.
int pcr_rect_splat(const void* params, const void* bids, int64_t nsub,
                   void* s0, void* s1, int nf, int th, int wt, int ncb,
                   int nb_total, int w_pad, void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  if (nf == 1)
    return launch<1>(p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, st);
  if (nf == 2)
    return launch<2>(p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

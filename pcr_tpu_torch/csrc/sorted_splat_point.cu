// K1 — the deterministic sorted point splat, hand-written for Hopper (sm_90a).
//
// Replaces the point mode of pcr_tpu/engine/pallas_kernels.py
// ::build_sorted_splat_pallas (two_d=True). Same contract as that kernel:
//
//   params  (nsub, 3|4, kBlock) int32   [icx | icy | f0 bits | (f1 bits)]
//   bids    (nsub,) int32, ascending    tile id = row_block * ncb + col_block
//   s0, s1  (H_pad, W_pad) float32      state fields, updated IN PLACE
//
// Every live entry adds f0 into cell (icy, icx) of field 0 and f1 (or 1.0
// when the layout carries no f1, i.e. Average) into field 1. Entries outside
// their sub-chunk's (th, wt) tile are dead (the layout marks dead entries with
// icx = icy = -1); runs with bids outside [0, nb_total) are skipped; writes
// never leave the tile, so never leave (H_pad, W_pad).
//
// Design. The TPU kernel contracts one-hot factors on the MXU because the TPU
// has no scatter; here a scatter is natural, but a float atomicAdd would make
// reruns differ in the last bits, and the repository promises bit-identical
// reruns. So each run of equal bids (one state tile) is owned by ONE CTA,
// which walks the run's sub-chunks in order. Per sub-chunk it
//   1. stable-radix-sorts the entries by local cell (CUB BlockRadixSort, keys
//      are the local cell ids, values the entry index, so equal cells keep
//      entry order),
//   2. lets the first thread of each equal-cell segment sum the segment in
//      entry order, and
//   3. does one plain read-modify-write per unique cell into the state.
// Nothing else writes the tile, and every sum has a fixed order: the result is
// a function of the input bits alone. Shared memory holds one 2048-entry
// sub-chunk (about 32 KB), never the (th, wt) tile itself.
//
// What bounds it: a tile's sub-chunks run one after another on one SM, so a
// grid with few tiles (the 160 x 160 harness has two) leaves most of the 132
// SMs idle, and the sort's shared-memory passes, not device-memory bytes
// (12-16 B per entry), set the time per sub-chunk. Splitting hot runs across
// CTAs with a deterministic second pass is later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kBlock = kThreads * kItems;  // entries per sub-chunk

template <int NF, bool WITH_F1>
__global__ void __launch_bounds__(kThreads)
sorted_splat_point_kernel(const int32_t* __restrict__ params,
                          const int32_t* __restrict__ bids, int64_t nsub,
                          float* __restrict__ s0, float* __restrict__ s1,
                          int th, int wt, int ncb, int nb_total, int w_pad,
                          int key_bits) {
  constexpr int kSeg = WITH_F1 ? 4 : 3;
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;
  __shared__ union {
    typename Sort::TempStorage sort;
    struct {
      unsigned key[kBlock];
      int idx[kBlock];
    } run;
  } sm;
  __shared__ float v0[kBlock];
  __shared__ float v1[NF == 2 ? kBlock : 1];

  // One CTA per run of equal bids: only the CTA of the run's first
  // sub-chunk works, the others leave at once.
  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int row0 = (bid / ncb) * th;
  const int col0 = (bid % ncb) * wt;
  const unsigned dead = static_cast<unsigned>(th * wt);
  const int t = threadIdx.x;

  for (int64_t j = first; j < nsub && bids[j] == bid; ++j) {
    const int32_t* p = params + j * kSeg * kBlock;
    unsigned keys[kItems];
    int vals[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = t * kItems + k;  // blocked: rank order == entry order
      const int lx = p[e] - col0;
      const int ly = p[kBlock + e] - row0;
      const bool live = lx >= 0 && lx < wt && ly >= 0 && ly < th;
      keys[k] = live ? static_cast<unsigned>(ly * wt + lx) : dead;
      vals[k] = e;
      v0[e] = __int_as_float(p[2 * kBlock + e]);
      if constexpr (NF == 2)
        v1[e] = WITH_F1 ? __int_as_float(p[3 * kBlock + e]) : 1.0f;
    }
    Sort(sm.sort).Sort(keys, vals, 0, key_bits);
    __syncthreads();  // the sort's storage becomes the run arrays
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sm.run.key[t * kItems + k] = keys[k];
      sm.run.idx[t * kItems + k] = vals[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + t;
      const unsigned key = sm.run.key[r];
      if (key == dead || (r > 0 && sm.run.key[r - 1] == key)) continue;
      // r heads a segment of equal cells: sum it in entry order
      float a0 = v0[sm.run.idx[r]];
      float a1 = 0.0f;
      if constexpr (NF == 2) a1 = v1[sm.run.idx[r]];
      for (int q = r + 1; q < kBlock && sm.run.key[q] == key; ++q) {
        const int e = sm.run.idx[q];
        a0 += v0[e];
        if constexpr (NF == 2) a1 += v1[e];
      }
      const int64_t off = static_cast<int64_t>(row0 + key / wt) * w_pad +
                          col0 + key % wt;
      s0[off] += a0;
      if constexpr (NF == 2) s1[off] += a1;
    }
    __syncthreads();  // v0/v1 and the run arrays are rewritten next
  }
}

}  // namespace

extern "C" {

int pcr_sorted_splat_point_block() { return kBlock; }

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Allocates nothing and does not synchronise.
int pcr_sorted_splat_point(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, int nf, int with_f1, int th,
                           int wt, int ncb, int nb_total, int w_pad,
                           int key_bits, void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nsub));
  if (nf == 1 && !with_f1) {
    sorted_splat_point_kernel<1, false><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, key_bits);
  } else if (nf == 2 && !with_f1) {
    sorted_splat_point_kernel<2, false><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, key_bits);
  } else if (nf == 2 && with_f1) {
    sorted_splat_point_kernel<2, true><<<grid, kThreads, 0, st>>>(
        p, b, nsub, f0, f1, th, wt, ncb, nb_total, w_pad, key_bits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

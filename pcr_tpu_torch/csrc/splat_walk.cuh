// What the window-aware splats (K2, K4, K5) and the rect splat (K3) share:
// the CTA's shape (K3 stacks two such slices in one CTA), the search for the
// end of a tile run, and the asynchronous staging of a sub-chunk's entries
// in pieces.
//
// One CTA of kThreads = 128 threads owns kSliceRows x kSliceCols = 8 x 128
// cells of one state tile: blockIdx.x is the first sub-chunk of the tile's
// run (the CTAs of a run's other sub-chunks leave at once), blockIdx.y the
// slice. Thread t owns column t of the slice and its 8 rows, so a warp owns
// a block of 8 rows x 32 columns, and every cell has one owner for the
// whole launch. The run's entries stream through shared memory in pieces
// of P entries. When a piece has landed, the CTA turns it into the records
// its walk reads (each kernel's own), and the walk touches the staged words
// no more: so piece q + 1 is copied by cp.async into the same buffer while
// piece q is walked.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace splat {

constexpr int kThreads = 128;
constexpr int kBlock = 2048;     // entries per sub-chunk
constexpr int kSliceRows = 8;    // rows of a tile one CTA owns
constexpr int kSliceCols = 128;  // its columns: 4 warps x 32 lanes
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One past the last sub-chunk of the run of `bid` that starts at `first`
// (bids ascend, so the run is contiguous): a binary search.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ bids,
                                           int64_t first, int64_t nsub,
                                           int bid) {
  int64_t lo = first + 1, hi = nsub;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (bids[mid] == bid) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Start the copy of piece `q` of the run (NSEG segments x P entries, 4 B
// each) into dst[seg * P + e] and commit it as one cp.async group. `run` is
// the run's first sub-chunk; sub-chunks are NSEG x kBlock words, 16-byte
// aligned. T is the CTA's thread count.
template <int NSEG, int P, int T = kThreads>
__device__ __forceinline__ void stage_piece(void* dst, const void* run,
                                            int64_t q) {
  constexpr int kPieces = kBlock / P;
  constexpr int kVecs = P / 4;  // 16-byte copies per segment
  const auto* src = static_cast<const int32_t*>(run) +
                    (q / kPieces) * NSEG * kBlock + (q % kPieces) * P;
  auto* d = static_cast<int32_t*>(dst);
  for (int k = threadIdx.x; k < NSEG * kVecs; k += T) {
    const int seg = k / kVecs, v = k % kVecs;
    cp_async16(d + seg * P + 4 * v, src + seg * kBlock + 4 * v);
  }
  cp_async_commit();
}

}  // namespace splat

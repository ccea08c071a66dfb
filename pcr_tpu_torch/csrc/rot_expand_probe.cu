// K6 — the rot-expand micro-probe, hand-written for Hopper (sm_90a).
//
// Replaces benchmarks/profile_rot_expand.py::build, the TPU probe of how
// K5's packed variant hands per-entry scalars to the 128 lanes of a tile
// row. It computes what that probe computes:
//
//   out[l] = nsub * sum_q sum_g p[q, 4g + l / 32],  l < 128, g < block / 4
//
// for p (nq, block) float32: each of nsub steps reads the whole block and
// broadcasts entry 4g + j to the 32 lanes of quarter j, as K5's threads
// read the entry a tile row's cells need. On Hopper the question becomes
// what it costs to hand per-entry scalars to the threads that own a tile's
// cells, so the work stays (every one of the 128 lanes takes its nq *
// block / 4 adds in each of the nsub steps; the four distinct sums and the
// nsub equal steps are not folded), and the variants differ only in where
// the scalars come from:
//
//   smem  the CTA's share of the block is staged in shared memory by
//         cp.async and every warp reads it as broadcasts: K5's pattern;
//   loop  every warp reads its scalars straight from device memory (L1/L2
//         broadcasts): the baseline shape.
//
// Design. One launch. The grid is nsub steps x `split` shares of g (the
// wrapper's plan: about one CTA an SM), and a CTA has kGroups groups of 128
// lanes. Group k of share s takes the g's  g_lo + k, g_lo + k + kGroups, ...
// of the share [g_lo, g_hi), so a lane's adds of one step are spread over
// split x kGroups threads; each thread keeps kChains sums (its m-th g goes
// to sum m % kChains, all q of one g to the same sum, q ascending), so the
// loads are independent of the adds and four chains are in flight a
// thread. The order of every sum is fixed:
//
//   thread   (c0 + c1) + (c2 + c3)  over its chains;
//   CTA      groups 0 .. kGroups - 1 in order, through shared memory, into
//            row step * split + s of `partial`;
//   launch   the CTA that finishes last (an integer counter in device
//            memory, atomicInc, which wraps to 0 for the next launch) adds
//            the nsub * split rows: row r goes to sum r % kGroups of lane
//            l, rows ascending, then the sums 0 .. kGroups - 1 in order.
//
// No float atomics: reruns are bit-identical. What bounds it: not the
// float32 rate (nsub * nq * block * 32 adds are under a microsecond of the
// card) but one launch, the staging of 36 KB a CTA, the longest chain of
// dependent adds (nq * block / 4 / split / kGroups / kChains of them, 4
// clocks each), the scalar shared-memory load that feeds every add, and
// the last CTA's pass over the partial rows. The first version ran one
// chain of nq * block / 4 dependent adds a thread, each behind its own
// load, on nsub CTAs of 4 warps, and added the rows in a second launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroups = 8;                  // groups of kLanes a CTA
constexpr int kThreads = kLanes * kGroups;
constexpr int kChains = 4;                  // independent sums a thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
rot_expand_kernel(const float* __restrict__ p, int nq, int block, int split,
                  float* __restrict__ partial, unsigned* __restrict__ done,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float sp[];   // [nq][4 * (g_hi - g_lo)]
  __shared__ float red[kGroups][kLanes];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int l = t % kLanes, k = t / kLanes;     // k is warp-uniform
  const int quarter = l / 32;
  const int share = blockIdx.x % split;
  const int G = block / 4;
  const int g_lo = static_cast<int>(static_cast<int64_t>(G) * share / split);
  const int g_hi =
      static_cast<int>(static_cast<int64_t>(G) * (share + 1) / split);
  const int width = 4 * (g_hi - g_lo);          // floats a row of the share

  // src[q * stride + 4 * (g - g_lo)] is p[q, 4g + quarter]
  const float* src;
  int stride;
  if constexpr (SMEM) {
    const int vecs = width / 4;                 // 16-byte copies a row
    for (int i = t; i < nq * vecs; i += kThreads) {
      const int q = i / vecs, v = i % vecs;
      cp_async16(sp + q * width + 4 * v,
                 p + static_cast<int64_t>(q) * block + 4 * g_lo + 4 * v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    src = sp + quarter;
    stride = width;
  } else {
    src = p + 4 * g_lo + quarter;
    stride = block;
  }

  // this thread's g's: g_lo + k + kGroups * m, m < count
  const int count = (g_hi - g_lo - k + kGroups - 1) / kGroups;
  float c[kChains] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* at = src + 4 * k;
  int m = 0;
  for (; m + kChains <= count; m += kChains) {
#pragma unroll 3
    for (int q = 0; q < nq; ++q) {
      const float* row = at + static_cast<int64_t>(q) * stride;
      float v[kChains];
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        const float* a = row + 4 * kGroups * (m + u);
        v[u] = SMEM ? *a : __ldg(a);
      }
#pragma unroll
      for (int u = 0; u < kChains; ++u) c[u] += v[u];
    }
  }
#pragma unroll
  for (int u = 0; u < kChains - 1; ++u)         // under kChains g's are left
    if (m + u < count)
      for (int q = 0; q < nq; ++q) {
        const float* a =
            at + static_cast<int64_t>(q) * stride + 4 * kGroups * (m + u);
        c[u] += SMEM ? *a : __ldg(a);
      }
  red[k][l] = (c[0] + c[1]) + (c[2] + c[3]);
  __syncthreads();
  if (k == 0) {
    float s = red[0][l];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) s += red[j][l];
    partial[static_cast<int64_t>(blockIdx.x) * kLanes + l] = s;
    __threadfence();                            // the row, then the count
  }
  __syncthreads();
  if (t == 0) last = atomicInc(done, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA: rows r = k, k + kGroups, ... into sum k of lane l
  const int rows = static_cast<int>(gridDim.x);
  float s = 0.0f;
  int r = k;
  for (; r + 7 * kGroups < rows; r += 8 * kGroups) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = __ldcg(partial + static_cast<int64_t>(r + u * kGroups) * kLanes
                    + l);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; r < rows; r += kGroups)
    s += __ldcg(partial + static_cast<int64_t>(r) * kLanes + l);
  red[k][l] = s;
  __syncthreads();
  if (k == 0) {
    float o = red[0][l];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) o += red[j][l];
    out[l] = o;
  }
}

}  // namespace

extern "C" {

int pcr_rot_expand_groups() { return kGroups; }

// Launches K6 (variant 0 = smem, 1 = loop) on `stream`: nsub * split
// partial rows into `partial` (nsub * split, 128), then, by the CTA that
// finishes last, their sum into `out` (128,). `done` is one unsigned
// integer in device memory that is 0 before the launch and 0 again after
// it; launches that share it must be on one stream. `split` is the
// wrapper's plan (rot_expand.split_of), 1 <= split <= block / 4. Returns
// the cudaError_t of the launch (0 = ok); allocates nothing, does not
// synchronise.
int pcr_rot_expand_probe(const void* params, int nq, int block, int nsub,
                         int variant, int split, void* partial, void* done,
                         void* out, void* stream) {
  if (nsub <= 0 || nq <= 0 || block <= 0 || block % 4 || split < 1 ||
      split > block / 4 || (variant != 0 && variant != 1) ||
      reinterpret_cast<uintptr_t>(params) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(params);
  auto* part = static_cast<float*>(partial);
  auto* cnt = static_cast<unsigned*>(done);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nsub) * split);
  if (variant == 0) {
    // the widest share of a row: ceil(G / split) groups of four floats
    const int G = block / 4;
    const int bytes = static_cast<int>(
        static_cast<int64_t>(nq) * ((G + split - 1) / split) * 16);
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rot_expand_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    rot_expand_kernel<true><<<grid, kThreads, bytes, st>>>(
        p, nq, block, split, part, cnt, o);
  } else {
    rot_expand_kernel<false><<<grid, kThreads, 0, st>>>(
        p, nq, block, split, part, cnt, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// cells, so the variants differ only in where those scalars come from:
//
//   smem  the block is staged in shared memory (coalesced) and every warp
//         reads it as broadcasts: K5's pattern;
//   loop  every warp reads the block straight from device memory (L1/L2
//         broadcasts): the baseline shape.
//
// One CTA of 128 threads per step (thread l is lane l) sums g in order and,
// for each g, q in order, as the TPU kernel does; a second one-CTA pass
// adds the nsub partial rows in step order. No atomics: reruns are
// bit-identical. What bounds it: one dependent float add per (g, q) per
// thread, block / 4 * nq of them, and the load that feeds it; the bytes
// (nq * block * 4 per step) come from L2 after the first step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

template <bool SMEM>
__global__ void __launch_bounds__(kLanes)
rot_expand_partial(const float* __restrict__ p, int nq, int block,
                   float* __restrict__ partial) {
  extern __shared__ float sp[];
  const int l = threadIdx.x;
  if constexpr (SMEM) {
    for (int i = l; i < nq * block; i += kLanes) sp[i] = p[i];
    __syncthreads();
  }
  const int quarter = l / 32;
  float acc = 0.0f;
  for (int g = 0; g < block / 4; ++g) {
    float s = acc;
    for (int q = 0; q < nq; ++q) {
      const int i = q * block + 4 * g + quarter;
      s += SMEM ? sp[i] : __ldg(p + i);
    }
    acc = s;
  }
  partial[static_cast<int64_t>(blockIdx.x) * kLanes + l] = acc;
}

__global__ void __launch_bounds__(kLanes)
rot_expand_sum(const float* __restrict__ partial, int nsub,
               float* __restrict__ out) {
  const int l = threadIdx.x;
  float s = 0.0f;
  for (int i = 0; i < nsub; ++i)
    s += partial[static_cast<int64_t>(i) * kLanes + l];
  out[l] = s;
}

}  // namespace

extern "C" {

// Launches K6 (variant 0 = smem, 1 = loop) on `stream`: nsub partial rows
// into `partial` (nsub, 128), then their sum into `out` (128,). Returns the
// cudaError_t of the launches (0 = ok); allocates nothing, does not
// synchronise.
int pcr_rot_expand_probe(const void* params, int nq, int block, int nsub,
                         int variant, void* partial, void* out,
                         void* stream) {
  if (nsub <= 0 || nq <= 0 || block <= 0 || block % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(params);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nsub));
  if (variant == 0) {
    const int bytes = static_cast<int>(static_cast<int64_t>(nq) * block *
                                       sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        rot_expand_partial<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rot_expand_partial<true><<<grid, kLanes, bytes, st>>>(p, nq, block, part);
  } else if (variant == 1) {
    rot_expand_partial<false><<<grid, kLanes, 0, st>>>(p, nq, block, part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rot_expand_sum<<<1, kLanes, 0, st>>>(part, nsub, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

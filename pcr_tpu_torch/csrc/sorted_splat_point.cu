// K1 — the deterministic point splat, hand-written for Hopper (sm_90a).
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
// reruns. So every sum has a fixed order, and every word has one writer at a
// time:
//
//   Groups. A run of equal bids (one state tile) is cut into groups of
//   consecutive sub-chunks: a group starts at the run's first sub-chunk and
//   at every sub-chunk whose index is a multiple of `group`. `group` is a
//   function of nsub alone (kernels.k1_group_size), so the groups are a
//   function of bids and nsub: never of the card, its SM count or timing.
//   Slot 2b of the scratch holds the partial tile of the group that starts
//   at block b's first sub-chunk (b * group), slot 2b + 1 that of the group
//   that starts inside block b at a run start and runs on past the block.
//
//   Pass 1, one CTA per (block of `group` sub-chunks, slice of `rs` tile
//   rows). The CTA keeps its slice of a group's partial tile in shared
//   memory (nf * rs * wt floats, fields side by side per cell, set to -0.0,
//   which adds to any x as x). Per sub-chunk, in order, it loads the entries
//   coalesced into registers (the next two sub-chunks' loads fly while one
//   is folded), ranks them by owner warp with a stable block radix rank (one
//   4-bit pass; the owner is a fixed function of the cell, entries outside
//   the slice go last) and places them in owner order. Each warp then walks
//   its own entries 32 at a time: lanes with equal cells find each other
//   (match.any), the first sums its peers' values in lane order and adds the
//   sum into the shared tile. No two warps own a cell, so no atomics, and
//   each cell's terms meet in an order fixed by the input. At the end of a
//   group the slice goes into the state (a run's only group: a run no
//   longer than `group` that does not cross a multiple of it, as on grids
//   with many tiles; spans of 256 cells no entry touched are skipped) or,
//   whole, into the group's scratch slot.
//
//   Pass 2, kMergeY CTAs per block, for the runs with more than one group:
//   the CTAs of the block boundaries such a run crosses share its cells.
//   Per cell, 1, 2, 4 or 8 lanes (by the run's number of groups) each sum
//   a range of the run's scratch tiles in group order, a fixed tree of
//   shuffles adds the ranges, and the sum goes into the state. The CTAs of
//   other blocks leave at once.
//
// The result is a function of the input bits alone.
//
// What bounds it: not the 12-16 B read per entry (~20-30 us of the card's
// memory rate for 5M points) but, per sub-chunk, the rank and the warps'
// walks in shared memory, on one CTA per SM (the tile slice takes 128 KB).

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_rank.cuh>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kBlock = kThreads * kItems;  // entries per sub-chunk
constexpr int kDead = kWarps;              // owner digit of dead entries
constexpr int kRankBits = 5;               // digits 0..kWarps
constexpr int kFlagCells = 256;            // cells per touched flag
constexpr int kMatchBits = 15;             // cells of a slice < 2^15
constexpr int kMergeThreads = 256;
constexpr int kMergeY = 8;        // pass-2 CTAs per block boundary

static_assert(kWarps + 1 <= (1 << kRankBits), "owner digits overflow");

__device__ __forceinline__ bool live_bid(int bid, int nb_total) {
  return bid >= 0 && bid < nb_total;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

using Rank = cub::BlockRadixRankMatch<kThreads, kRankBits, false>;

struct OwnerDigit {  // the rank's key is the owner digit itself
  __device__ __forceinline__ uint32_t Digit(unsigned key) const { return key; }
};

// The lanes of `act` whose v equals this lane's in the low `nbits` bits: one
// ballot a bit (match.any costs a pass per distinct value, too many here).
__device__ __forceinline__ unsigned match_bits(unsigned act, unsigned v,
                                               int nbits) {
  unsigned peers = act;
#pragma unroll
  for (int bit = 0; bit < kMatchBits; ++bit) {
    if (bit >= nbits) break;
    const bool one = (v >> bit) & 1u;
    const unsigned ones = __ballot_sync(act, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

// Pass 1's shared memory after the tile slice: the rank's storage, reused
// for the entries in owner order, and each owner's first position; then
// one touched flag per kFlagCells cells of the slice.
template <bool WITH_F1>
struct Stage {
  union {
    typename Rank::TempStorage rank;
    struct {
      unsigned key[kBlock];  // tile cell | (the owner's own cell index << 16)
      float v0[kBlock];
      float v1[WITH_F1 ? kBlock : 1];
    } run;
  } u;
  int start[kWarps + 1];
};

__host__ __device__ constexpr int64_t round16(int64_t x) {
  return (x + 15) / 16 * 16;
}

template <bool WITH_F1>
struct Entries {  // one sub-chunk's entries of one thread, striped
  int cx[kItems], cy[kItems];
  float f0[kItems], f1[kItems];

  __device__ __forceinline__ void load(const int32_t* __restrict__ p, int t) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = k * kThreads + t;
      cx[k] = p[e];
      cy[k] = p[kBlock + e];
      f0[k] = __int_as_float(p[2 * kBlock + e]);
      if constexpr (WITH_F1) f1[k] = __int_as_float(p[3 * kBlock + e]);
    }
  }
};

// Bytes of a slice of `cells` cells: NF float32 fields side by side, or
// (C16) field 0 as float32 then field 1 as uint16 counts.
template <int NF, bool C16>
__host__ __device__ constexpr int64_t tile_bytes(int64_t cells) {
  return round16(C16 ? cells * 6 : NF * cells * 4);
}

template <int NF, bool WITH_F1, bool C16>
__global__ void __launch_bounds__(kThreads, 1)
k1_groups_kernel(const int32_t* __restrict__ params,
                 const int32_t* __restrict__ bids, int64_t nsub,
                 float* __restrict__ s0, float* __restrict__ s1,
                 float* __restrict__ partial, int th, int wt, int ncb,
                 int nb_total, int w_pad, int rs, int slices, int group) {
  constexpr int kSeg = WITH_F1 ? 4 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = rs * wt;  // of this CTA's tile slice
  float* tile = reinterpret_cast<float*>(smem_raw);
  uint16_t* count = reinterpret_cast<uint16_t*>(tile + cells);  // C16 only
  unsigned char* stage = smem_raw + tile_bytes<NF, C16>(cells);
  auto& st = *reinterpret_cast<Stage<WITH_F1>*>(stage);
  unsigned char* touched = stage + sizeof(Stage<WITH_F1>);
  const int nflags = (cells + kFlagCells - 1) / kFlagCells;
  // bits of a cell's index among its owner warp's cells
  const int own_bits = 32 - __clz((rs + kWarps - 1) / kWarps * wt - 1);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1;
  const int slice = blockIdx.x % slices;
  const int64_t b = blockIdx.x / slices;
  const int64_t bend = min64((b + 1) * group, nsub);

  // The groups of block b, one after another: each ends before the next
  // run start or at the block's end.
  for (int64_t gs = b * group; gs < bend;) {
    const int bid = bids[gs];
    int64_t ge = gs + 1;
    while (ge < bend && bids[ge] == bid) ++ge;
    const int64_t first = gs;
    gs = ge;
    if (!live_bid(bid, nb_total)) continue;
    const bool run_start = first == 0 || bids[first - 1] != bid;
    const bool alone = run_start && (ge == nsub || bids[ge] != bid);
    const int row0 = (bid / ncb) * th + slice * rs;  // the slice's state row
    const int col0 = (bid % ncb) * wt;

    const float4 nzero = make_float4(-0.f, -0.f, -0.f, -0.f);
    for (int i = t; i < (C16 ? 1 : NF) * cells / 4; i += kThreads)
      reinterpret_cast<float4*>(tile)[i] = nzero;
    if constexpr (C16)
      for (int i = t; i < cells / 4; i += kThreads)
        reinterpret_cast<uint2*>(count)[i] = make_uint2(0, 0);
    for (int i = t; i < nflags; i += kThreads) touched[i] = 0;

    // Fold one sub-chunk's entries (in e) into the tile; e reloads from
    // `refill` as soon as its keys are read, so two sub-chunks' loads fly
    // while one is folded.
    auto fold = [&](Entries<WITH_F1>& e, const int32_t* refill) {
      unsigned key[kItems], owner[kItems];
      float v0[kItems], v1[kItems];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int lx = e.cx[k] - col0;
        const int ly = e.cy[k] - row0;
        const bool live = lx >= 0 && lx < wt && ly >= 0 && ly < rs;
        any |= live;
        // the owner warp takes every kWarps-th row of the slice; among
        // its cells this one is (ly / kWarps) * wt + lx
        key[k] = static_cast<unsigned>(ly * wt + lx) |
                 (static_cast<unsigned>((ly / kWarps) * wt + lx) << 16);
        owner[k] = live ? static_cast<unsigned>(ly % kWarps)
                        : static_cast<unsigned>(kDead);
        v0[k] = e.f0[k];
        v1[k] = WITH_F1 ? e.f1[k] : 1.0f;
      }
      if (refill) e.load(refill, t);

      // A barrier (the last sub-chunk's walks are done) that also skips a
      // sub-chunk with no entry in this slice.
      if (!__syncthreads_or(any)) return;
      int rank[kItems];
      int prefix[Rank::BINS_TRACKED_PER_THREAD];
      Rank(st.u.rank).RankKeys(owner, rank, OwnerDigit(), prefix);
      if (t <= kWarps) st.start[t] = prefix[0];
      __syncthreads();  // the rank's storage becomes the entries
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (owner[k] == kDead) continue;
        st.u.run.key[rank[k]] = key[k];
        st.u.run.v0[rank[k]] = v0[k];
        if constexpr (WITH_F1) st.u.run.v1[rank[k]] = v1[k];
      }
      __syncthreads();

      // Warp `warp` folds its entries, 32 at a time, in rank order.
      const int lo = st.start[warp];
      const int hi = st.start[warp + 1];
      for (int base = lo; base < hi; base += 32) {
        const int i = base + lane;
        const unsigned act = __ballot_sync(0xffffffffu, i < hi);
        if (i >= hi) continue;
        const unsigned packed = st.u.run.key[i];
        const unsigned c = packed & 0xffffu;
        const unsigned peers = match_bits(act, packed >> 16, own_bits);
        if (peers & lanes_below) continue;  // not the first of its cell
        float a0 = st.u.run.v0[i];
        float a1 = 0.0f;
        if constexpr (WITH_F1) a1 = st.u.run.v1[i];
        for (unsigned r = peers & (peers - 1); r; r &= r - 1) {
          const int q = base + __ffs(r) - 1;
          a0 += st.u.run.v0[q];
          if constexpr (WITH_F1) a1 += st.u.run.v1[q];
        }
        if constexpr (!WITH_F1) a1 = static_cast<float>(__popc(peers));
        if constexpr (C16) {
          tile[c] += a0;
          count[c] += static_cast<uint16_t>(__popc(peers));
        } else if constexpr (NF == 1) {
          tile[c] += a0;
        } else {
          float2* cell = reinterpret_cast<float2*>(tile) + c;
          float2 o = *cell;
          o.x += a0;
          o.y += a1;
          *cell = o;
        }
        touched[c / kFlagCells] = 1;
      }
    };

    auto at = [&](int64_t j) {
      return j < ge ? params + j * kSeg * kBlock : nullptr;
    };
    Entries<WITH_F1> even, odd;  // sub-chunks first + 2i and first + 2i + 1
    even.load(at(first), t);
    if (first + 1 < ge) odd.load(at(first + 1), t);
    for (int64_t j = first; j < ge; j += 2) {
      fold(even, at(j + 2));
      if (j + 1 < ge) fold(odd, at(j + 3));
    }
    __syncthreads();  // every warp's adds are in the tile

    // Cells 4i..4i+3 of the tile as NF float4s, fields side by side
    // (f0 f1 f0 f1 | f0 f1 f0 f1 when NF == 2), as the scratch holds them.
    auto quad = [&](int i, float4& q0, float4& q1) {
      const float4* t4 = reinterpret_cast<const float4*>(tile);
      if constexpr (C16) {
        const float4 f = t4[i];
        const uint2 n = reinterpret_cast<const uint2*>(count)[i];
        auto cnt = [](unsigned k) {  // 0 stays -0.0, like an untouched sum
          return k ? static_cast<float>(k) : -0.0f;
        };
        q0 = make_float4(f.x, cnt(n.x & 0xffffu), f.y, cnt(n.x >> 16));
        q1 = make_float4(f.z, cnt(n.y & 0xffffu), f.w, cnt(n.y >> 16));
      } else if constexpr (NF == 1) {
        q0 = t4[i];
      } else {
        q0 = t4[2 * i];
        q1 = t4[2 * i + 1];
      }
    };
    if (alone) {  // into the state, skipping flag spans no entry touched
      for (int i = t; i < cells / 4; i += kThreads) {
        const int c = 4 * i;
        if (!touched[c / kFlagCells]) continue;
        const int64_t off =
            static_cast<int64_t>(row0 + c / wt) * w_pad + col0 + c % wt;
        float4 q0, q1;
        quad(i, q0, q1);
        float4* t0 = reinterpret_cast<float4*>(s0 + off);
        float4 v = *t0;
        if constexpr (NF == 1) {
          add4(v, q0);
          *t0 = v;
        } else {
          add4(v, make_float4(q0.x, q0.z, q1.x, q1.z));
          *t0 = v;
          float4* t1 = reinterpret_cast<float4*>(s1 + off);
          float4 w = *t1;
          add4(w, make_float4(q0.y, q0.w, q1.y, q1.w));
          *t1 = w;
        }
      }
    } else {  // whole, into the group's scratch slot (rows slice * rs ..)
      const int64_t slot = 2 * b + (first % group == 0 ? 0 : 1);
      float4* dst = reinterpret_cast<float4*>(
          partial + (slot * th * wt + static_cast<int64_t>(slice) * cells) *
                        NF);
      for (int i = t; i < cells / 4; i += kThreads) {
        float4 q0, q1;
        quad(i, q0, q1);
        dst[NF * i] = q0;
        if constexpr (NF == 2) dst[2 * i + 1] = q1;
      }
    }
    __syncthreads();  // the tile is read out before the next group resets it
  }
}

template <int NF>
__global__ void __launch_bounds__(kMergeThreads)
k1_merge_kernel(const int32_t* __restrict__ bids, int64_t nsub,
                float* __restrict__ s0, float* __restrict__ s1,
                const float* __restrict__ partial, int th, int wt, int ncb,
                int nb_total, int w_pad, int group) {
  __shared__ int64_t run[2];  // the run's first sub-chunk and its end
  const int64_t b = blockIdx.x;
  const int64_t last = min64((b + 1) * group, nsub) - 1;
  const int bid = bids[last];
  // Work only where a run crosses the boundary after block b (so it has
  // more than one group); the CTAs of all its boundaries share its cells.
  if (!live_bid(bid, nb_total) || last + 1 >= nsub || bids[last + 1] != bid)
    return;
  if (threadIdx.x == 0) {  // bids ascend: binary searches for the run
    int64_t lo = 0, hi = last;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (bids[mid] < bid) lo = mid + 1; else hi = mid;
    }
    run[0] = lo;
    lo = last + 1;
    hi = nsub;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (bids[mid] == bid) lo = mid + 1; else hi = mid;
    }
    run[1] = lo;
  }
  __syncthreads();
  const int64_t b0 = run[0] / group;            // the run's first block
  const int64_t m = (run[1] - 1) / group - b0;  // boundaries it crosses
  const int64_t n = m + 1;                      // its groups, in order:
  // the one at its start, then the one at the start of each later block
  const int64_t slot0 = 2 * b0 + (run[0] % group == 0 ? 0 : 1);
  const int nquads = th * wt / 4;
  const int64_t slab = static_cast<int64_t>(NF) * th * wt;
  // ranges of groups per cell, summed apart: a function of n alone
  const int ranges = n <= 8 ? 1 : n <= 16 ? 2 : n <= 32 ? 4 : 8;
  const int quads = kMergeThreads / ranges;  // float4s of cells a pass
  const int r = threadIdx.x % ranges;
  const int64_t g_lo = r * n / ranges;
  const int64_t g_hi = (r + 1) * n / ranges;
  const float4* part = reinterpret_cast<const float4*>(partial);
  for (int64_t chunk = (b - b0) * kMergeY + blockIdx.y;
       chunk * quads < nquads; chunk += m * kMergeY) {
    // Cells 4q..4q+3: each of `ranges` lanes sums its range of the run's
    // groups in order, then a fixed tree adds the ranges.
    const int q = static_cast<int>(chunk * quads) + threadIdx.x / ranges;
    const bool valid = q < nquads;
    float4 acc[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[i] = make_float4(-0.f, -0.f, -0.f, -0.f);
    if (valid) {
      int64_t g = g_lo;
      for (; g + 3 < g_hi; g += 4) {
        float4 v[4][NF];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int64_t slot = g + u == 0 ? slot0 : 2 * (b0 + g + u);
#pragma unroll
          for (int i = 0; i < NF; ++i)
            v[u][i] = part[(slot * slab) / 4 + static_cast<int64_t>(q) * NF + i];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < NF; ++i) add4(acc[i], v[u][i]);
      }
      for (; g < g_hi; ++g) {
        const int64_t slot = g == 0 ? slot0 : 2 * (b0 + g);
#pragma unroll
        for (int i = 0; i < NF; ++i)
          add4(acc[i],
               part[(slot * slab) / 4 + static_cast<int64_t>(q) * NF + i]);
      }
    }
#pragma unroll
    for (int off = ranges / 2; off > 0; off /= 2)
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        acc[i].x += __shfl_down_sync(0xffffffffu, acc[i].x, off);
        acc[i].y += __shfl_down_sync(0xffffffffu, acc[i].y, off);
        acc[i].z += __shfl_down_sync(0xffffffffu, acc[i].z, off);
        acc[i].w += __shfl_down_sync(0xffffffffu, acc[i].w, off);
      }
    if (!valid || r != 0) continue;
    const int c = 4 * q;
    const int64_t off = static_cast<int64_t>((bid / ncb) * th + c / wt) *
                            w_pad + (bid % ncb) * wt + c % wt;
    float4* t0 = reinterpret_cast<float4*>(s0 + off);
    float4 v = *t0;
    if constexpr (NF == 1) {
      add4(v, acc[0]);
      *t0 = v;
    } else {  // the fields sit side by side: f0 f1 f0 f1 | f0 f1 f0 f1
      add4(v, make_float4(acc[0].x, acc[0].z, acc[1].x, acc[1].z));
      *t0 = v;
      float4* t1 = reinterpret_cast<float4*>(s1 + off);
      float4 w = *t1;
      add4(w, make_float4(acc[0].y, acc[0].w, acc[1].y, acc[1].w));
      *t1 = w;
    }
  }
}

template <int NF, bool WITH_F1, bool C16>
cudaError_t launch(const int32_t* p, const int32_t* b, int64_t nsub, float* f0,
                   float* f1, float* partial, int th, int wt, int ncb,
                   int nb_total, int w_pad, int rs, int group,
                   cudaStream_t st) {
  const int64_t cells = static_cast<int64_t>(rs) * wt;
  const int64_t smem = tile_bytes<NF, C16>(cells) + sizeof(Stage<WITH_F1>) +
                       (cells + kFlagCells - 1) / kFlagCells;
  cudaError_t err = cudaFuncSetAttribute(
      k1_groups_kernel<NF, WITH_F1, C16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int slices = th / rs;
  const int64_t nblocks = (nsub + group - 1) / group;
  k1_groups_kernel<NF, WITH_F1, C16>
      <<<dim3(static_cast<unsigned>(nblocks * slices)), kThreads, smem, st>>>(
          p, b, nsub, f0, f1, partial, th, wt, ncb, nb_total, w_pad, rs,
          slices, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(nblocks), kMergeY);
  k1_merge_kernel<NF><<<grid, kMergeThreads, 0, st>>>(
      b, nsub, f0, f1, partial, th, wt, ncb, nb_total, w_pad, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcr_sorted_splat_point_block() { return kBlock; }

// Launches K1's two passes on `stream`; returns the cudaError_t of the
// launches (0 = ok). `rs` (tile rows per pass-1 CTA) divides th; `count16`
// keeps an Average's count field as 16-bit integers in shared memory
// (needs group * 2048 < 65536); `partial` is the caller's scratch of
// 2 * ceil(nsub / group) * nf * th * wt floats (any contents). Allocates
// nothing and does not synchronise.
int pcr_sorted_splat_point(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, void* partial, int nf,
                           int with_f1, int count16, int th, int wt, int ncb,
                           int nb_total, int w_pad, int rs, int group,
                           void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  if (group < 1 || rs < 1 || th % rs || (rs * wt) % 4 || wt % 4 ||
      w_pad % 4 || static_cast<int64_t>(rs) * wt > (1 << kMatchBits) ||
      (count16 && (nf != 2 || with_f1 ||
                   static_cast<int64_t>(group) * kBlock > 0xffff)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nf == 1 && !with_f1) {
    err = launch<1, false, false>(p, b, nsub, f0, f1, part, th, wt, ncb,
                                  nb_total, w_pad, rs, group, st);
  } else if (nf == 2 && !with_f1 && count16) {
    err = launch<2, false, true>(p, b, nsub, f0, f1, part, th, wt, ncb,
                                 nb_total, w_pad, rs, group, st);
  } else if (nf == 2 && !with_f1) {
    err = launch<2, false, false>(p, b, nsub, f0, f1, part, th, wt, ncb,
                                  nb_total, w_pad, rs, group, st);
  } else if (nf == 2 && with_f1) {
    err = launch<2, true, false>(p, b, nsub, f0, f1, part, th, wt, ncb,
                                 nb_total, w_pad, rs, group, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"

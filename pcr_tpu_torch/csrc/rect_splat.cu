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
// cells, so nearly all of a tile's cells have nothing to do with it. One CTA
// of 256 threads owns a band of 16 rows x 128 columns of one state tile for
// the whole launch: two of csrc/splat_walk.cuh's 8-row slices, one a row of
// four warps, so a warp owns a block of 8 rows x 32 columns as in K2 / K4 /
// K5 (a (128, 128) tile is eight CTAs; any th and wt are taken, the ragged
// last bands masked). A thread owns one column of its slice and keeps its 8
// cells of each field in registers, loaded from the state first and stored
// once at the end, so no cell is read or written in between. The run's
// entries stream through shared memory in pieces of kPiece, the next piece
// copied by cp.async while this one is walked. When a piece has landed, one
// thread per entry cuts its rectangle to the tile and to the band; what is
// left of the piece is compacted, in entry order (a ballot and a prefix
// within each warp, the warps' counts added in warp order; the cut is made
// twice, to count and to write, rather than kept in registers), into
// 16-byte records {first column, columns - 1, mask of the band's rows, f0}.
// A 1-row run survives in one of a tile's eight bands. Each warp then takes
// the records 32 at a time, one per lane, tests them against its 32 columns
// and 8 rows, and for each of the 8 rows ballots the records that meet it
// and walks those hits in record order: one broadcast load of the record,
// one unsigned compare of the lane's column, and the adds into that row's
// registers. Rows are independent, so walking row by row keeps each cell's
// terms in entry order, and the row is a compile-time register, not a test.
// Each cell is written by one thread, its terms added in entry order to the
// state's value, with no atomics: the result is a function of the input
// bits alone, equal bit for bit to the first version's and to the CPU plain
// version's index_add_, which add in the same order.
//
// What bounds it: instruction issue and latency in the hit walk (12
// instructions a hit, one dependent shared-memory load each, 32 warps an
// SM), then the bands of a tile each staging the tile's whole run from L2
// (20 B an entry and band); device-memory bytes do not matter. A tile run
// is serial per cell, so the longest run of a launch sets its time. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W, CUDA events, on 5M horizontal lines
// of half length 16 on a 1000 x 1000 grid, two fields: bands
// of 8 / 16 / 32 rows with pieces of 512 / 1024 / 2048 entries (four
// entries a thread and piece, 32 warps an SM in each) took 0.78 / 0.67 /
// 0.72 ms, staging alone 0.29 / - / 0.17 ms: taller bands stage and cut
// less, but each warp then scans more records that miss its rows, and
// larger pieces at one band height cost occupancy. The first version (2.1
// ms) kept a 32-row slice in shared memory (4 CTAs of 512 threads a tile,
// two to an SM), staged each sub-chunk with plain loads behind barriers,
// had all 16 warps of all 4 slices test every entry, and walked a hit as a
// chain of shared-memory read-modify-writes.

#include "splat_walk.cuh"

namespace {

using namespace splat;

constexpr int kRowGroups = 2;       // 8-row slices a CTA owns, one a warp row
constexpr int kBandRows = kSliceRows * kRowGroups;
constexpr int kCta = kThreads * kRowGroups;   // threads a CTA
constexpr int kPiece = 1024;         // entries staged at a time
constexpr int kSeg = 5;
constexpr int kWarps = kCta / 32;
constexpr int kRounds = kPiece / kCta;  // entries a thread cuts a piece
static_assert(kPiece % kCta == 0 && kBlock % kPiece == 0, "piece size");
static_assert(kBandRows <= 32, "a record's rows are one 32-bit mask");

struct RectGeom {
  int th, wt, ncb, nb_total, w_pad, col_slices;
};

template <int NF>
__global__ void __launch_bounds__(kCta, 1024 / kCta)
rect_splat_kernel(const int32_t* __restrict__ params,
                  const int32_t* __restrict__ bids, int64_t nsub,
                  float* __restrict__ s0, float* __restrict__ s1,
                  RectGeom g) {
  constexpr int kPieces = kBlock / kPiece;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* ent = smem;                                  // the staged piece
  int4* rec = reinterpret_cast<int4*>(ent + kSeg * kPiece);  // what is left
  __shared__ int wcnt[kWarps];

  // One CTA per run of equal bids and band: only the CTAs of the run's
  // first sub-chunk work, the others leave at once.
  const int64_t first = blockIdx.x;
  const int bid = bids[first];
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int group = warp / 4;   // the warp's 8 rows of the band
  const int row0 = (bid / g.ncb) * g.th;
  const int col0 = (bid % g.ncb) * g.wt;
  // the band, inclusive, cut to the tile
  const int b_lo =
      row0 + static_cast<int>(blockIdx.y) / g.col_slices * kBandRows;
  const int b_hi = min(b_lo + kBandRows, row0 + g.th) - 1;
  const int s_clo =
      col0 + static_cast<int>(blockIdx.y) % g.col_slices * kSliceCols;
  const int s_chi = min(s_clo + kSliceCols, col0 + g.wt) - 1;
  // the thread's column and the first of its 8 rows
  const int col = s_clo + (t & (kSliceCols - 1));
  const int row_lo = b_lo + kSliceRows * group;
  const bool owns = col <= s_chi;
  // the warp's block of columns, inclusive
  const int c_lo = col - lane, c_hi = c_lo + 31;

  float acc0[kSliceRows], acc1[NF == 2 ? kSliceRows : 1];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    const bool cell = owns && row_lo + i <= b_hi;
    const int64_t off = static_cast<int64_t>(row_lo + i) * g.w_pad + col;
    acc0[i] = cell ? s0[off] : 0.0f;
    if constexpr (NF == 2) acc1[i] = cell ? s1[off] : 0.0f;
  }

  const int32_t* run = params + first * kSeg * kBlock;
  const int64_t npiece = (run_end(bids, first, nsub, bid) - first) * kPieces;
  stage_piece<kSeg, kPiece, kCta>(ent, run, 0);
  for (int64_t q = 0; q < npiece; ++q) {
    cp_async_wait_all();
    __syncthreads();  // piece q has landed; the walk of piece q - 1 is over
    // Cut: warp w takes entries [w, w + 1) * kPiece / kWarps, 32 a round,
    // so the records' order (warp, round, lane) is the entries' order.
    // First the warps count what they keep, then, the counts known, each
    // cuts its entries once more and writes the records at their places.
    unsigned kept[kRounds];
    int total = 0;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int e = warp * (kPiece / kWarps) + k * 32 + lane;
      kept[k] = __ballot_sync(
          kAll, max(ent[e], s_clo) <= min(ent[kPiece + e], s_chi) &&
                    max(ent[2 * kPiece + e], b_lo) <=
                        min(ent[3 * kPiece + e], b_hi));
      total += __popc(kept[k]);
    }
    if (lane == 0) wcnt[warp] = total;
    __syncthreads();
    int base = 0, nrec = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w];
      if (w < warp) base += c;
      nrec += c;
    }
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      if (kept[k] >> lane & 1u) {
        const int e = warp * (kPiece / kWarps) + k * 32 + lane;
        const int x0 = max(ent[e], s_clo), x1 = min(ent[kPiece + e], s_chi);
        const int y0 = max(ent[2 * kPiece + e], b_lo);
        const int y1 = min(ent[3 * kPiece + e], b_hi);
        // rows y0 .. y1 of the band as bits y0 - b_lo .. y1 - b_lo
        const unsigned rows = ((2u << (y1 - y0)) - 1u) << (y0 - b_lo);
        rec[base + __popc(kept[k] & ((1u << lane) - 1u))] = make_int4(
            x0, x1 - x0, static_cast<int>(rows), ent[4 * kPiece + e]);
      }
      base += __popc(kept[k]);
    }
    __syncthreads();  // the records are written; `ent` is free again
    if (q + 1 < npiece) stage_piece<kSeg, kPiece, kCta>(ent, run, q + 1);

    for (int k0 = 0; k0 < nrec; k0 += 32) {
      // the warp's rows of record k0 + lane, if it meets the warp's columns
      unsigned rows = 0u;
      if (k0 + lane < nrec) {
        const int4 r = rec[k0 + lane];
        if (r.x <= c_hi && r.x + r.y >= c_lo)
          rows = static_cast<unsigned>(r.z) >> (kSliceRows * group) & 0xffu;
      }
      if (!__any_sync(kAll, rows != 0u)) continue;
#pragma unroll
      for (int i = 0; i < kSliceRows; ++i) {
        unsigned hits = __ballot_sync(kAll, rows >> i & 1u);
        while (hits) {  // the records that meet row i, in entry order
          const int4 h = rec[k0 + __ffs(hits) - 1];
          hits &= hits - 1;
          if (static_cast<unsigned>(col - h.x) <= static_cast<unsigned>(h.y)) {
            acc0[i] += __int_as_float(h.w);
            if constexpr (NF == 2) acc1[i] += 1.0f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    if (owns && row_lo + i <= b_hi) {
      const int64_t off = static_cast<int64_t>(row_lo + i) * g.w_pad + col;
      s0[off] = acc0[i];
      if constexpr (NF == 2) s1[off] = acc1[i];
    }
  }
}

constexpr int kSmemBytes = (kSeg + 4) * kPiece * 4;

template <int NF>
int launch(const int32_t* p, const int32_t* b, int64_t nsub, float* f0,
           float* f1, const RectGeom& g, int slices, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      rect_splat_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nsub), static_cast<unsigned>(slices));
  rect_splat_kernel<NF><<<grid, kCta, kSmemBytes, st>>>(p, b, nsub, f0, f1,
                                                        g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pcr_rect_splat_block() { return kBlock; }
int pcr_rect_splat_piece() { return kPiece; }
int pcr_rect_splat_band_rows() { return kBandRows; }

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// `slices` is the wrapper's plan (line_kernels.rect_plan): the 16-row x
// 128-column bands of a (th, wt) tile. Allocates nothing and does not
// synchronise.
int pcr_rect_splat(const void* params, const void* bids, int64_t nsub,
                   void* s0, void* s1, int nf, int th, int wt, int ncb,
                   int nb_total, int w_pad, int slices, void* stream) {
  if (nsub <= 0) return static_cast<int>(cudaSuccess);
  if (th < 1 || wt < 1 || (nf != 1 && nf != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_slices = (wt + kSliceCols - 1) / kSliceCols;
  // the wrapper plans the grid; it must be the kernel's own
  if (slices != (th + kBandRows - 1) / kBandRows * col_slices ||
      slices > 65535 || reinterpret_cast<uintptr_t>(params) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const RectGeom g{th, wt, ncb, nb_total, w_pad, col_slices};
  const auto* p = static_cast<const int32_t*>(params);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  return nf == 1 ? launch<1>(p, b, nsub, f0, f1, g, slices, st)
                 : launch<2>(p, b, nsub, f0, f1, g, slices, st);
}

}  // extern "C"

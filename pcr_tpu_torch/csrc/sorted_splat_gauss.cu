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
//   work    (nwork,) int32            the runs' first sub-chunks in launch
//                                     order, -1 in unused slots (Schedule)
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
// Design. One CTA of 128 threads owns 8 rows x 128 columns of one state tile
// for the whole launch (csrc/splat_walk.cuh), so a (64, 128) tile is eight
// CTAs and a (128, 128) tile sixteen: about a thousand CTAs on a 1000 x 1000
// grid at every sigma, where one CTA per tile gave 64 to 256. Nothing else
// writes the slice, so no atomics are needed and every sum has a fixed
// order. Thread t holds column t's 8 cells of each field in registers, so a
// warp owns a block of 8 rows x 32 columns. The run's entries stream through
// shared memory in pieces, the next piece copied by cp.async while this one
// is walked. When a piece has landed, one thread per entry forms its masked
// column and row ranges [clo, chi] x [rlo, rhi] (the +-r window clipped to
// the grid and, on a multi-tile grid, to the home tile; the integer
// divisions once per entry and CTA). Each warp then tests 32 entries at a
// time against its block, ballots, and walks only the hits, in entry order:
// broadcast loads bring the column range, f0 and the eight wy, each lane
// takes its column's wx, and the eight rows take their products with no
// branch. A cell's terms are added in entry order within a sub-chunk, and
// the sub-chunk's sum is added to the state, once per cell and sub-chunk,
// as in the first version: a masked factor's term was 0 there and adds
// nothing here. Every factor is axis_factor's, with its IEEE division, expf
// and per-axis mask, and every product and sum is in the same order, so
// both walks below give the first version's bits.
//
// Schedule. A launch is one CTA a (tile run, slice) item of the wrapper's
// work list (gauss_kernels.gauss_work): the runs' first sub-chunks, longest
// run first (in sub-chunks; ties by tile id), and item i is run
// work[i / slices], slice i % slices, so all the slices of the longest run
// go out first. The card hands out CTAs in the order of their index, so
// this is longest-processing-time-first: each long CTA starts while the
// short ones fill the card around it, and none is left to run alone at the
// end. The grid was (nsub, slices) before, dispatched slice-major: every
// tile's slice-0 CTA went first and every tile's last slice in the last
// part of the launch, so on LiDAR runs (the longest 30 to 58 times the
// mean) the hot tiles' last slices started near the end and walked their
// 116k-218k entries at low occupancy, and the CTAs of a run's other
// sub-chunks left at once. A (tile, slice) is still owned by one CTA and
// walked in entry order, so the order of the list moves only the time,
// never a bit. The bids, not the list, say what a run is: a CTA whose item
// is off the grid or not a run's first sub-chunk leaves, as every CTA of a
// run's later sub-chunks did before. Slots past the runs are -1, sorted last, and their CTAs
// leave: the list is built on the card from the bids alone, which tell the
// runs but not on the host how many there are.
//
// Measured (H100, CUDA events, the two chunks of a 20M-point DC LiDAR job
// at sigma 3): 27.39 -> 20.81 ms and 37.86 -> 30.92 ms on two clouds,
// against 12.2 ms on even runs of the same count; a persistent launch that
// takes the same items by an atomic counter was slower (23.26, 31.38 ms).
// What is left is one CTA's walk: the longest run's eight CTAs alone take
// 11.7 and 18.0 ms. Cutting a run across CTAs would need each sub-chunk's
// sum kept apart and added in order, as the state takes one sum a
// sub-chunk.
//
// Two walks, two kernels; a launch takes one by the chunk's largest radius,
// which the routing knows. Both give the same bits, so the choice moves
// only the time.
//
// - Radii up to kTableRadius (windows of up to 27 columns; sigma 1 to
//   4.3): sorted_splat_gauss_kernel forms each factor once per entry and
//   slice. Pieces of 128 entries, one a thread. Each CTA cuts an entry's
//   window to its slice; an entry whose cut ranges keep no cell takes no
//   room and no warp meets it, a live one needs a wy for each of its rows
//   in the slice and a wx for each of its columns. Prefix sums over the
//   piece give each live entry its rank (where its walk records go) and its
//   slots; each thread writes a descriptor for each of its entry's slots
//   (its record, the row or column, the word the factor goes to), and the
//   CTA then forms the factors one slot a thread, so no lane idles on a
//   cell outside a window: wy into the entry's eight row words, wx into a
//   table of kTable slots, in rounds in entry order (at sigma 4 a piece is
//   one round). The walk ballots over live ranks and loads wx from the
//   table by a predicated load. (x - ic) is formed from the slice's
//   corner, the same whole number in float.
// - Wider windows: sorted_splat_gauss_wide_kernel, pieces of 256 entries;
//   one thread per (entry, row) forms wy for the slice's 8 rows, and each
//   lane of a hit forms wx for its column in the walk.
//
// What bounds them: instruction issue. A table hit is about 32
// instructions, 16 of them the rows' FMAs, and a factor about 31 in the
// fill; forming wx in the walk costs each hit an IEEE division and an expf
// on all 32 lanes, 55-70 instructions a hit. The table pays where a
// window's columns are few against the lanes of the blocks it meets: at
// sigma 4 an entry's ~21 columns in a slice meet 1.45 blocks (46 lane
// evaluations). Wider windows waste fewer lanes (sigma 16: ~58 columns, 2.6
// blocks) while the table's bookkeeping grows (descriptors, prefix sums,
// rounds, four barriers a 128-entry piece against three a 256-entry one).
// On an H100 the table kernel is 19 % faster than the wide one at sigma 1,
// 4.5 % at sigma 4 (r 12) and 1 % at r 13, even at r 14, 2.5 % slower at
// r 15, 10 % at sigma 6 and 22 % at sigma 16. The two share no code path,
// so each keeps its own registers: one kernel holding both walks spilled
// 200 B and was slower on both. Bytes do not matter (32 B per entry,
// re-read from L2 by a run's slices). The registers are capped at 64 a
// thread (8 CTAs an SM): more warps in flight hid more of the chains'
// latency than the extra registers did, and either kernel's shared memory
// (27,680 B the table's, 26,624 B the other's) keeps the eight.

#include "splat_walk.cuh"

namespace {

using namespace splat;

constexpr int kMinCtas = 8;          // CTAs an SM: 64 registers a thread
constexpr int kSeg = 8;
constexpr int kTableRadius = 13;     // the widest radius the table kernel takes

struct GaussGeom {
  int th, wt, ncb, nb_total, w_pad;
  int H, W, multi_tile, tile_w, tile_h, row_offset, global_h;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One axis factor of the TPU kernel: exp(-0.5 q^2), q = ((x - ic) - sub) / s,
// where x lies in the entry's range (`inside`) and the factor is at least
// 1e-6; else 0. x and ic come as floats (whole numbers).
__device__ __forceinline__ float axis_factor(float x, bool inside, float ic,
                                             float sub, float s) {
  const float q = (x - ic) - sub;
  const float qq = q / s;
  const float w = expf(-0.5f * qq * qq);
  return inside && w >= 1e-6f ? w : 0.0f;
}

// An entry's masked column and row ranges: its +-r window clipped to the
// grid and, on a multi-tile grid, to its home tile
__device__ __forceinline__ void entry_window(int icx, int icy, int r,
                                             const GaussGeom& g, int& clo,
                                             int& chi, int& rlo, int& rhi) {
  clo = icx - r;
  chi = min(icx + r, g.W - 1);
  rlo = icy - r;
  rhi = min(icy + r, g.H - 1);
  if (g.multi_tile) {
    const int cs = (clampi(icx, 0, g.W - 1) / g.tile_w) * g.tile_w;
    clo = max(clo, cs);
    chi = min(chi, min(cs + g.tile_w, g.W) - 1);
    const int rowc = clampi(icy + g.row_offset, 0, g.global_h - 1);
    const int rs = (rowc / g.tile_h) * g.tile_h - g.row_offset;
    const int re = min(rs + g.row_offset + g.tile_h, g.global_h) -
                   g.row_offset;
    rlo = max(rlo, rs);
    rhi = min(rhi, re - 1);
  }
}

// A sub-chunk's sums into the state: one read-modify-write per cell
template <int NF>
__device__ __forceinline__ void add_slice(float* s0, float* s1, float* acc0,
                                          float* acc1, int row_lo, int col,
                                          int w_pad) {
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    const int64_t off = static_cast<int64_t>(row_lo + i) * w_pad + col;
    s0[off] += acc0[i];
    acc0[i] = 0.0f;
    if constexpr (NF == 2) {
      s1[off] += acc1[i];
      acc1[i] = 0.0f;
    }
  }
}

// The CTA's item of the work list: run work[item / slices], the run's first
// sub-chunk, and slice item % slices of its tile. False where the slot is
// unused (-1): the CTA leaves.
__device__ __forceinline__ bool work_item(const int32_t* __restrict__ work,
                                          int slices, int64_t& first,
                                          int& slice) {
  const unsigned item = blockIdx.x;
  first = work[item / static_cast<unsigned>(slices)];
  slice = static_cast<int>(item % static_cast<unsigned>(slices));
  return first >= 0;
}

// K2 with factor tables: every factor once per entry and slice
namespace tbl {

constexpr int kPiece = kThreads;     // entries staged at a time: one a thread
constexpr int kTable = 1600;         // factor slots a round forms at most
constexpr int kWarps = kThreads / 32;
// bytes a CTA: per staged entry its segments, its column and row records,
// and per live entry its first slot, its walk record and its eight wy
// (words); then the factor table and a descriptor a slot, and the warps'
// slot and live-entry counts
constexpr int kSmemBytes =
    (kSeg + 8 + 1 + 4 + kSliceRows) * kPiece * 4 + kTable * (4 + 4) +
    2 * kWarps * 4;
static_assert(kPiece <= 128 && kSliceCols <= 128, "a descriptor's fields");
static_assert(kSmemBytes / 4 < (1 << 16), "a descriptor's destination");
static_assert(kTable >= 8 + kSliceCols, "a round holds any one entry");
static_assert(kSeg * kPiece == 8 * kThreads, "two 16-byte copies a thread");

}  // namespace tbl

// K2's walk with factor tables
template <int NF, bool CUT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
sorted_splat_gauss_kernel(const int32_t* __restrict__ params,
                          const int32_t* __restrict__ bids, int64_t nsub,
                          const int32_t* __restrict__ work, int slices,
                          float* __restrict__ s0, float* __restrict__ s1,
                          GaussGeom g) {
  using namespace tbl;
  constexpr int kPieces = kBlock / kPiece;
  // the staged piece as it came, then what the fill and the walk read
  extern __shared__ __align__(16) int32_t smem[];
  float* const smemf = reinterpret_cast<float*>(smem);
  int32_t* ent = smem;                                   // [kSeg][kPiece]
  // [kPiece][2]: (float(icx - the slice's first column), sub_cx, sx, -) and
  // (float(icy - its first row), sub_cy, sy, -)
  float4* rec = reinterpret_cast<float4*>(ent + kSeg * kPiece);
  // by live rank [kPiece]: clo, chi, the slot of column 0 (less the round's
  // first slot), f0's bits
  int4* wrec = reinterpret_cast<int4*>(rec + 2 * kPiece);
  float4* wy4 = reinterpret_cast<float4*>(wrec + kPiece);  // [kPiece][2]
  float* wys = reinterpret_cast<float*>(wy4);
  int* first_slot = reinterpret_cast<int*>(wy4 + 2 * kPiece);  // [kPiece]
  float* table = reinterpret_cast<float*>(first_slot + kPiece);  // [kTable]
  // [kTable]: a slot's record in `rec` (bits 0-7), its row or column in the
  // slice (bits 8-15) and the word of shared memory its factor goes to
  uint32_t* desc = reinterpret_cast<uint32_t*>(table + kTable);
  int* wsum = reinterpret_cast<int*>(desc + kTable);     // [kWarps]
  int* wlive = wsum + kWarps;                            // [kWarps]
  const float* entf = reinterpret_cast<const float*>(ent);
  const unsigned wys_at = static_cast<unsigned>(wys - smemf);
  const unsigned table_at = static_cast<unsigned>(table - smemf);

  int64_t first;
  int slice;
  if (!work_item(work, slices, first, slice)) return;
  const int bid = bids[first];
  // the list only orders the CTAs: the bids say which items are runs
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int col_slices = g.wt / kSliceCols;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int row_lo =
      (bid / g.ncb) * g.th + slice / col_slices * kSliceRows;
  const int col = (bid % g.ncb) * g.wt + slice % col_slices * kSliceCols + t;
  // the warp's block and the slice, inclusive
  const int c_lo = col - lane, c_hi = c_lo + 31;
  const int r_hi = row_lo + kSliceRows - 1;
  const int s_lo = col - t, s_hi = s_lo + kSliceCols - 1;

  const int32_t* run = params + first * kSeg * kBlock;
  const int64_t npiece = (run_end(bids, first, nsub, bid) - first) * kPieces;
  // thread t's two 16-byte copies of a piece: vector t % 32 of segments
  // t / 32 and t / 32 + 4
  const int to = (t >> 5) * kPiece + 4 * lane;
  const int from = (t >> 5) * kBlock + 4 * lane;
  auto stage = [&](int64_t q) {
    const int32_t* src = run + (q / kPieces) * (kSeg * kBlock) +
                         (q % kPieces) * kPiece;
    cp_async16(ent + to, src + from);
    cp_async16(ent + to + 4 * kPiece, src + from + 4 * kBlock);
    cp_async_commit();
  };
  float acc0[kSliceRows], acc1[NF == 2 ? kSliceRows : 1];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    acc0[i] = 0.0f;
    if constexpr (NF == 2) acc1[i] = 0.0f;
  }

  stage(0);
  for (int64_t q = 0; q < npiece; ++q) {
    cp_async_wait_all();
    __syncthreads();  // piece q has landed; the walk of piece q - 1 is over
    // thread t's entry: its ranges, cut to the slice; live when both keep a
    // cell, and then ny + nx factors
    int m, ny, incl, clo, chi, xlo, yrel;
    bool live;
    {
      const int icx = ent[t], icy = ent[kPiece + t], r = ent[6 * kPiece + t];
      int rlo, rhi;
      entry_window(icx, icy, r, g, clo, chi, rlo, rhi);
      xlo = max(clo, s_lo);
      const int xhi = min(chi, s_hi);
      const int ylo = max(rlo, row_lo), yhi = min(rhi, r_hi);
      live = r >= 0 && xlo <= xhi && ylo <= yhi;
      ny = live ? yhi - ylo + 1 : 0;
      m = live ? ny + xhi - xlo + 1 : 0;
      yrel = ylo - row_lo;
      // the centre from the slice's corner: (x - ic) is then (rel - this),
      // the same whole number in float
      rec[2 * t] = make_float4(__int2float_rn(icx - s_lo), entf[2 * kPiece + t],
                               entf[4 * kPiece + t], 0.0f);
      rec[2 * t + 1] = make_float4(__int2float_rn(icy - row_lo),
                                   entf[3 * kPiece + t], entf[5 * kPiece + t],
                                   0.0f);
    }
    // the warp's inclusive prefix sum of m, and its live entries
    incl = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += v;
    }
    const unsigned lives = __ballot_sync(kAll, live);
    if (lane == 31) {
      wsum[warp] = incl;
      wlive[warp] = __popc(lives);
    }
    const int f0_bits = ent[7 * kPiece + t];
    __syncthreads();  // the records and counts are written; `ent` is free
    if (q + 1 < npiece) stage(q + 1);
    int total = 0, nlive = 0, rank = __popc(lives & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = wsum[w], n = wlive[w];
      if (w < warp) {
        incl += s;
        rank += n;
      }
      total += s;
      nlive += n;
    }
    const int excl = incl - m;
    // a live entry's walk records go to its rank among the live ones
    if (live) {
      first_slot[rank] = excl;
      wrec[rank] = make_int4(clo, chi, excl + ny - xlo, f0_bits);
      wy4[2 * rank] = wy4[2 * rank + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }

    // rounds of at most kTable factors, in entry order; b0 and b1 are ranks
    for (int base = 0, b0 = 0; b0 < nlive;) {
      const bool fits = live && incl - base <= kTable;
      if (fits && rank >= b0) {  // its slots: rows, then columns
        uint32_t* d = desc + (excl - base);
        const unsigned step = 0x10100u;  // the next row or column
        unsigned v = 2u * t + 1u + (static_cast<unsigned>(yrel) << 8) +
                     ((wys_at + kSliceRows * rank + yrel) << 16);
        for (int j = 0; j < ny; ++j, v += step) d[j] = v;
        d += ny;
        v = 2u * t + (static_cast<unsigned>(xlo - s_lo) << 8) +
            ((table_at + excl - base + ny) << 16);
        for (int j = 0; j < m - ny; ++j, v += step) d[j] = v;
      }
      // live ranks [b0, b1) make this round; their descriptors are written
      const int b1 = __syncthreads_count(fits);
      const int end = b1 < nlive ? first_slot[b1] : total;
      for (int s = t; s < end - base; s += kThreads) {
        const unsigned d = desc[s];
        const float4 c = rec[d & 0xff];
        const int rel = d >> 8 & 0xff;
        const float w = axis_factor(__int2float_rn(rel), true, c.x, c.y, c.z);
        smemf[d >> 16] = w;
      }
      __syncthreads();  // the round's factors are formed

      for (int e0 = b0 & ~31; e0 < b1; e0 += 32) {
        const int e = e0 + lane;
        const int4 w = wrec[e];
        // an entry hits the block exactly when its columns share one with
        // it (a live entry keeps a row of the slice); entry e0 + i at bit
        // 31 - i
        unsigned hits = __brev(__ballot_sync(
            kAll, e >= b0 && e < b1 && w.x <= c_hi && w.y >= c_lo));
        while (hits) {  // the warp's hits, in entry order
          const int h = __clz(hits);
          hits ^= 0x80000000u >> h;
          const int k = e0 + h;
          const int4 c = wrec[k];
          const float4 w0 = wy4[2 * k];
          const float4 w1 = wy4[2 * k + 1];
          const float wy[kSliceRows] = {w0.x, w0.y, w0.z, w0.w,
                                        w1.x, w1.y, w1.z, w1.w};
          float wx = 0.0f;
          if (col >= c.x && col <= c.y) wx = table[col + c.z - base];
          const float a = wx * __int_as_float(c.w);
          // no branch in the rows: a masked factor is 0 and adds nothing
#pragma unroll
          for (int i = 0; i < kSliceRows; ++i) {
            if constexpr (CUT) {
              const float prod = wy[i] * wx;
              if (prod >= 1e-6f) {
                acc0[i] = fmaf(wy[i], a, acc0[i]);
                if constexpr (NF == 2) acc1[i] += prod;
              }
            } else {
              acc0[i] = fmaf(wy[i], a, acc0[i]);
              if constexpr (NF == 2) acc1[i] = fmaf(wy[i], wx, acc1[i]);
            }
          }
        }
      }
      base = end;
      b0 = b1;
      if (b0 < nlive) __syncthreads();  // the walk is over; refill
    }
    if (q % kPieces == kPieces - 1)  // the sub-chunk's last piece
      add_slice<NF>(s0, s1, acc0, acc1, row_lo, col, g.w_pad);
  }
}

// K2 forming wx in the walk
namespace wlk {

constexpr int kPiece = 256;          // entries staged at a time
constexpr int kNever = 1 << 30;      // an empty range's lo; hi = -kNever
// words per staged entry: its segments, its ranges, the column record
// and ranges, and its eight wy
constexpr int kSmemBytes = (kSeg + 4 + 4 + 2 + 8) * kPiece * 4;

}  // namespace wlk

// K2's walk forming wx in the walk
template <int NF, bool CUT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
sorted_splat_gauss_wide_kernel(const int32_t* __restrict__ params,
                               const int32_t* __restrict__ bids, int64_t nsub,
                               const int32_t* __restrict__ work, int slices,
                               float* __restrict__ s0, float* __restrict__ s1,
                               GaussGeom g) {
  using namespace wlk;
  constexpr int kPieces = kBlock / kPiece;
  // the staged piece as it came, then what the walk reads of it
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* ent = smem;                         // [kSeg][kPiece]
  int32_t* win = ent + kSeg * kPiece;          // [4][kPiece], for the ballot
  float4* col_rec = reinterpret_cast<float4*>(win + 4 * kPiece);
  int2* col_win = reinterpret_cast<int2*>(col_rec + kPiece);
  float* wys = reinterpret_cast<float*>(col_win + kPiece);  // [kPiece][8]
  const float* entf = reinterpret_cast<const float*>(ent);

  int64_t first;
  int slice;
  if (!work_item(work, slices, first, slice)) return;
  const int bid = bids[first];
  // the list only orders the CTAs: the bids say which items are runs
  if (bid < 0 || bid >= g.nb_total || (first > 0 && bids[first - 1] == bid))
    return;
  const int col_slices = g.wt / kSliceCols;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row_lo =
      (bid / g.ncb) * g.th + slice / col_slices * kSliceRows;
  const int col = (bid % g.ncb) * g.wt + slice % col_slices * kSliceCols + t;
  const float colf = __int2float_rn(col);
  // the warp's block, inclusive
  const int c_lo = col - lane, c_hi = c_lo + 31;
  const int r_hi = row_lo + kSliceRows - 1;

  const int32_t* run = params + first * kSeg * kBlock;
  const int64_t npiece = (run_end(bids, first, nsub, bid) - first) * kPieces;
  float acc0[kSliceRows], acc1[NF == 2 ? kSliceRows : 1];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    acc0[i] = 0.0f;
    if constexpr (NF == 2) acc1[i] = 0.0f;
  }

  stage_piece<kSeg, kPiece>(ent, run, 0);
  for (int64_t q = 0; q < npiece; ++q) {
    cp_async_wait_all();
    __syncthreads();  // piece q has landed; the walk of piece q - 1 is over
    for (int e = t; e < kPiece; e += kThreads) {
      const int icx = ent[e], icy = ent[kPiece + e], r = ent[6 * kPiece + e];
      int clo, chi, rlo, rhi;
      entry_window(icx, icy, r, g, clo, chi, rlo, rhi);
      if (r < 0 || clo > chi || rlo > rhi) {
        clo = rlo = kNever;
        chi = rhi = -kNever;
      }
      win[e] = clo;
      win[kPiece + e] = chi;
      win[2 * kPiece + e] = rlo;
      win[3 * kPiece + e] = rhi;
      // float(icx), sub_cx, sx, f0 | clo, chi
      col_rec[e] = make_float4(__int2float_rn(icx), entf[2 * kPiece + e],
                               entf[4 * kPiece + e], entf[7 * kPiece + e]);
      col_win[e] = make_int2(clo, chi);
    }
    __syncthreads();
    // wy of the slice's 8 rows for every entry, one (entry, row) a thread
    // and turn; a warp whose four entries all miss the slice's rows skips
    for (int k = t; k < kPiece * kSliceRows; k += kThreads) {
      const int e = k / kSliceRows, h = row_lo + k % kSliceRows;
      const int rlo = win[2 * kPiece + e], rhi = win[3 * kPiece + e];
      float wy = 0.0f;
      if (rlo <= r_hi && rhi >= row_lo)
        wy = axis_factor(__int2float_rn(h), h >= rlo && h <= rhi,
                         __int2float_rn(ent[kPiece + e]),
                         entf[3 * kPiece + e], entf[5 * kPiece + e]);
      wys[k] = wy;
    }
    __syncthreads();  // the records are written; `ent` is free again
    if (q + 1 < npiece) stage_piece<kSeg, kPiece>(ent, run, q + 1);

    for (int e0 = 0; e0 < kPiece; e0 += 32) {
      const int e = e0 + lane;
      // an entry hits the block exactly when its ranges share a cell with it
      unsigned hits = __ballot_sync(
          kAll, win[e] <= c_hi && win[kPiece + e] >= c_lo &&
                    win[2 * kPiece + e] <= r_hi &&
                    win[3 * kPiece + e] >= row_lo);
      while (hits) {  // the warp's hits, in entry order
        const int k = e0 + __ffs(hits) - 1;
        hits &= hits - 1;
        const float4 c = col_rec[k];
        const int2 cw = col_win[k];
        const float4 w0 = reinterpret_cast<const float4*>(wys)[2 * k];
        const float4 w1 = reinterpret_cast<const float4*>(wys)[2 * k + 1];
        const float wy[kSliceRows] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
        const float wx =
            axis_factor(colf, col >= cw.x && col <= cw.y, c.x, c.y, c.z);
        const float a = wx * c.w;
        // no branch in the rows: a masked factor is 0 and adds nothing
#pragma unroll
        for (int i = 0; i < kSliceRows; ++i) {
          if constexpr (CUT) {
            const float prod = wy[i] * wx;
            if (prod >= 1e-6f) {
              acc0[i] = fmaf(wy[i], a, acc0[i]);
              if constexpr (NF == 2) acc1[i] += prod;
            }
          } else {
            acc0[i] = fmaf(wy[i], a, acc0[i]);
            if constexpr (NF == 2) acc1[i] = fmaf(wy[i], wx, acc1[i]);
          }
        }
      }
    }
    if (q % kPieces == kPieces - 1)  // the sub-chunk's last piece
      add_slice<NF>(s0, s1, acc0, acc1, row_lo, col, g.w_pad);
  }
}

// the shared memory of the wrapper's plan: the larger of the two kernels'
constexpr int kPlanSmem = tbl::kSmemBytes > wlk::kSmemBytes
                              ? tbl::kSmemBytes
                              : wlk::kSmemBytes;

// What a launch runs over: the chunk, its work list and the tiles' slices
struct Work {
  const int32_t* params;
  const int32_t* bids;
  int64_t nsub;
  const int32_t* list;
  int64_t nwork;
  int slices;
};

template <bool TABLE, int NF, bool CUT>
int launch(const Work& w, float* f0, float* f1, const GaussGeom& g,
           cudaStream_t st) {
  const auto kernel = TABLE ? sorted_splat_gauss_kernel<NF, CUT>
                            : sorted_splat_gauss_wide_kernel<NF, CUT>;
  const int smem = TABLE ? tbl::kSmemBytes : wlk::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one CTA an item: the list's runs times the slices of a tile
  const unsigned grid = static_cast<unsigned>(w.nwork * w.slices);
  kernel<<<grid, kThreads, smem, st>>>(w.params, w.bids, w.nsub, w.list,
                                       w.slices, f0, f1, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool TABLE>
int launch_walk(const Work& w, float* f0, float* f1, int nf, int cut,
                const GaussGeom& g, cudaStream_t st) {
  if (nf == 1)
    return cut ? launch<TABLE, 1, true>(w, f0, f1, g, st)
               : launch<TABLE, 1, false>(w, f0, f1, g, st);
  return cut ? launch<TABLE, 2, true>(w, f0, f1, g, st)
             : launch<TABLE, 2, false>(w, f0, f1, g, st);
}

}  // namespace

extern "C" {

int pcr_sorted_splat_gauss_block() { return kBlock; }
int pcr_sorted_splat_gauss_piece() { return tbl::kPiece; }
int pcr_sorted_splat_gauss_table() { return tbl::kTable; }

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// th must be a multiple of 8 and wt of 128; `slices` and `smem` are the
// wrapper's plan (gauss_kernels.splat_plan), `work` its work list of `nwork`
// runs (gauss_kernels.gauss_work: each run's first sub-chunk, -1 in an
// unused slot), one CTA a run and slice. `rmax`, the chunk's largest
// radius (-1: not known), picks the walk: the factor tables up to
// kTableRadius. Allocates nothing and does not synchronise.
int pcr_sorted_splat_gauss(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, int nf, int cut, int rmax,
                           int th, int wt, int ncb, int nb_total, int w_pad,
                           int H, int W,
                           int multi_tile, int tile_w, int tile_h,
                           int row_offset, int global_h, int slices, int smem,
                           const void* work, int64_t nwork, void* stream) {
  if (nsub <= 0 || nwork == 0) return static_cast<int>(cudaSuccess);
  if (slices <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the wrapper plans the grid, the shared memory and the work list; the
  // first two must be the kernel's own, the list at most a run a sub-chunk
  if (th % kSliceRows || wt % kSliceCols || (nf != 1 && nf != 2) ||
      slices != (th / kSliceRows) * (wt / kSliceCols) || smem != kPlanSmem ||
      reinterpret_cast<uintptr_t>(params) % 16 || work == nullptr ||
      nwork < 0 || nwork > nsub || nwork > INT32_MAX / slices)
    return static_cast<int>(cudaErrorInvalidValue);
  const GaussGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                    tile_w, tile_h, row_offset, global_h};
  const Work w{static_cast<const int32_t*>(params),
               static_cast<const int32_t*>(bids), nsub,
               static_cast<const int32_t*>(work), nwork, slices};
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  return rmax >= 0 && rmax <= kTableRadius
             ? launch_walk<true>(w, f0, f1, nf, cut, g, st)
             : launch_walk<false>(w, f0, f1, nf, cut, g, st);
}

}  // extern "C"

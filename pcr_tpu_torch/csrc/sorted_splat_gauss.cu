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
//   work    (nwork, 4) int32         the work list's items in launch order,
//                                     [first, end, tail, base], -1 rows in
//                                     unused slots (Schedule)
//   scratch                           the cut runs' arrival counters and
//                                     partial sums (Schedule)
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
// Schedule. A launch is one CTA an (item, slice) of the wrapper's work
// list (gauss_kernels.gauss_work): item i is row work[i / slices], slice i
// % slices of its tile. An item is a tile run, or a segment of a long one:
// a run longer than a bound taken from the chunk's own runs (a few times
// its mean run, and at least a floor of sub-chunks) is cut into the
// fewest segments of at most the bound, as even as whole sub-chunks allow.
// Items go longest first in sub-chunks (ties by first sub-chunk), and the
// card hands out CTAs in the order of their index, so this is
// longest-processing-time-first: each long CTA starts while the short
// ones fill the card around it, and none is left to run alone at the end.
// The grid was (nsub, slices) before, dispatched slice-major, and the hot
// tiles' last slices started near the end; with whole runs longest first
// (the list with no run cut), the longest run's
// eight CTAs alone still took 11.7 and 18.0 ms of a 20M-point DC LiDAR
// job's 20.8 and 30.9 ms (runs of 115,851 and 218,016 entries), which no
// order of whole runs shortens.
//
// The cut keeps the bits. A cell of a (tile, slice) ends as ((state +
// S_0) + S_1) + ... + S_last, where S_k, the sub-chunk's sum, depends on
// sub-chunk k's entries alone, added in entry order from 0. A cut run's
// head segment adds its S_k into the state as a whole run does; each
// later (tail) segment writes its S_k to a scratch block of nf x 8 x 128
// floats, sub-chunk k's at (base + k - tail) * slices + slice. Every CTA
// of a cut run then fences its writes and adds the sub-chunks it walked
// to the (run, slice)'s arrival counter; the one whose add completes the
// run's sub-chunks, by the bids, folds the tails' sums into its cells in
// sub-chunk order, one add a cell and sub-chunk, after the head's own
// adds (made before the head arrived): the same sums, in the same order,
// as one CTA walking the whole run. Nothing spins and nothing waits on
// another CTA; one memset zeroes the counters before the launch, and a
// launch whose list cuts no run (no scratch) takes instantiations with
// none of this in their walk. The bids, not the list, say what a run is:
// a CTA whose whole run is off the grid or does not start a run leaves,
// an item of a cut run that fails those tests traps, and so does an
// arrival past the run's sub-chunks; a fold happens only when a run's
// sub-chunks are all walked. Slots past the items are -1, sorted last,
// and their CTAs leave: the list is built on the card from the bids
// alone, which tell the runs but not on the host how many there are.
//
// Measured (H100, CUDA events, both chunks of a 20M-point DC LiDAR job at
// sigma 3): 20.7-21.1 ms with whole runs, 14.1 ms cut with the fold
// inlined and 13.8 with the fold a call (arrive), 13.4 with no fold at all
// (the longest item's CTAs 12.5 -> 1.3 ms), against 12.0 ms on even runs
// of the same count; a sweep of the bound put its best at 3-5 sub-chunks
// here (twice the mean run), a bound of one sub-chunk 0.7 ms slower and
// whole runs 7.5. Only the table walk cuts. The wide walk's time is its work: on the same job at
// sigma 16 the cut list with no fold ran 56.24-56.28 ms against whole
// runs' 56.29-56.41, and the fold of its 112k tail sums made it 57.7; so
// it takes whole runs, a cut list traps in it, and the entry point gives
// it no scratch.
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

// What a launch runs over: the chunk, its work list, the tiles' slices and
// the scratch of the cut runs' partial sums
struct Work {
  const int32_t* params;
  const int32_t* bids;
  int64_t nsub;
  const int4* list;     // [first, end, tail, base] an item (gauss_work)
  int64_t nwork;
  int slices;
  int32_t* arrivals;    // a counter a (cut run, slice), zeroed each launch
  float* partials;      // NF x 8 x 128 floats a (sub-chunk, slice)
  int64_t blocks;       // (sub-chunk, slice) sums the scratch holds
};

// The CTA's item of the work list and its slice: list row blockIdx.x /
// slices, slice blockIdx.x % slices. The bids, not the list, say what a
// run is: the CTA leaves where the row is unused (-1), its tile is off the
// grid, or a whole run's first sub-chunk does not start a run. An item of
// a cut run that fails those tests traps: the run's fold would never come,
// and its tails' sums would be lost. `first` and `end` are the sub-chunks
// it walks, `bid` its tile; `part` is the scratch block of its first
// sub-chunk's sums where its item is a cut run's tail segment (the next
// sub-chunk's is `slices` blocks on), else -1: its sums go to the state.
__device__ __forceinline__ bool work_item(const Work& work, int nb_total,
                                          int64_t& first, int64_t& end,
                                          int& bid, int& slice,
                                          int64_t& part) {
  const unsigned s = static_cast<unsigned>(work.slices);
  const int4 it = work.list[blockIdx.x / s];
  slice = static_cast<int>(blockIdx.x % s);
  if (it.x < 0) return false;
  first = it.x;
  bid = work.bids[first];
  const bool tail = it.z >= 0 && it.x >= it.z;
  if (bid < 0 || bid >= nb_total ||
      (!tail && first > 0 && work.bids[first - 1] == bid)) {
    if (it.z >= 0) __trap();
    return false;
  }
  end = run_end(work.bids, first, work.nsub, bid);
  part = -1;
  if (it.z >= 0) {
    end = min(end, static_cast<int64_t>(it.y));
    // a cut run's sums must lie inside the scratch
    if ((static_cast<int64_t>(it.w) + end - it.z) * work.slices > work.blocks)
      __trap();
    if (tail)
      part = (static_cast<int64_t>(it.w) + it.x - it.z) * work.slices + slice;
  }
  return true;
}

// A sub-chunk's sums into the state, or where `part` is a scratch block,
// into that block, [NF][8][128] floats; the accumulators are zeroed
template <int NF>
__device__ __forceinline__ void put_sums(const Work& work, int64_t part,
                                         float* s0, float* s1, float* acc0,
                                         float* acc1, int row_lo, int col,
                                         int w_pad) {
  if (part < 0) {
    add_slice<NF>(s0, s1, acc0, acc1, row_lo, col, w_pad);
    return;
  }
  float* p = work.partials + part * (NF * kSliceRows * kSliceCols) +
             threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    p[i * kSliceCols] = acc0[i];
    acc0[i] = 0.0f;
    if constexpr (NF == 2) {
      p[(kSliceRows + i) * kSliceCols] = acc1[i];
      acc1[i] = 0.0f;
    }
  }
}

// A load at L2 that the compiler keeps after the fence before it
__device__ __forceinline__ float load_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The first sub-chunk of the run of `bid` that holds sub-chunk `at`
__device__ __forceinline__ int64_t run_begin(const int32_t* __restrict__ bids,
                                             int64_t at, int bid) {
  int64_t lo = 0, hi = at;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (bids[mid] < bid) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// After a CTA of a cut run has walked its sub-chunks: its arrival, and
// where it is the run's last CTA of this slice to arrive, the fold. Each
// CTA counts the sub-chunks it walked; the one whose count completes the
// run's (by the bids) adds the tails' sums into its 8 x 128 cells, one
// sub-chunk at a time in sub-chunk order, after the head's own adds, as
// the whole run's CTA adds them. Nothing waits on another CTA. `flag` is
// a word of shared memory that the walk no longer reads. Not inlined: the
// fold's registers inlined spilled 64-72 B in the table walk's loop, and
// the job's K2 ran 0.35 ms slower (14.12 against 13.77 ms on the DC LiDAR
// job, both seeds; 13.43 with no fold at all).
template <int NF>
__device__ __noinline__ void arrive(const Work& work, float* s0, float* s1,
                                       int row_lo, int col, int w_pad,
                                       int* flag) {
  const int4 it = work.list[blockIdx.x / static_cast<unsigned>(work.slices)];
  if (it.z < 0) return;  // a whole run: its sums are in the state
  const int slice = static_cast<int>(blockIdx.x % work.slices);
  const int bid = work.bids[it.x];
  const int64_t end = run_end(work.bids, it.x, work.nsub, bid);
  __threadfence();  // this CTA's adds or partials, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const int64_t walked = min(end, static_cast<int64_t>(it.y)) - it.x;
    const int64_t run = end - run_begin(work.bids, it.x, bid);
    int32_t* count =
        work.arrivals + static_cast<int64_t>(it.w) * work.slices + slice;
    const int64_t done = atomicAdd(count, static_cast<int>(walked)) + walked;
    if (done > run) __trap();  // a sub-chunk walked twice: a corrupt plan
    *flag = done == run;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();  // the other CTAs' adds and partials, before the fold
  float v0[kSliceRows], v1[NF == 2 ? kSliceRows : 1];
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    const int64_t off = static_cast<int64_t>(row_lo + i) * w_pad + col;
    v0[i] = load_cg(s0 + off);
    if constexpr (NF == 2) v1[i] = load_cg(s1 + off);
  }
  for (int64_t k = it.z; k < end; ++k) {
    const int64_t block = (it.w + k - it.z) * work.slices + slice;
    const float* p = work.partials + block * (NF * kSliceRows * kSliceCols) +
                     threadIdx.x;
#pragma unroll
    for (int i = 0; i < kSliceRows; ++i) {
      v0[i] += load_cg(p + i * kSliceCols);
      if constexpr (NF == 2)
        v1[i] += load_cg(p + (kSliceRows + i) * kSliceCols);
    }
  }
#pragma unroll
  for (int i = 0; i < kSliceRows; ++i) {
    const int64_t off = static_cast<int64_t>(row_lo + i) * w_pad + col;
    s0[off] = v0[i];
    if constexpr (NF == 2) s1[off] = v1[i];
  }
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
template <int NF, bool CUT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
sorted_splat_gauss_kernel(const __grid_constant__ Work work,
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

  int64_t first, end, part;
  int bid, slice;
  if (!work_item(work, g.nb_total, first, end, bid, slice, part)) return;
  if constexpr (!SPLIT) part = -1;
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

  const int32_t* run = work.params + first * kSeg * kBlock;
  const int64_t npiece = (end - first) * kPieces;
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
    if (q % kPieces == kPieces - 1) {  // the sub-chunk's last piece
      put_sums<NF>(work, part, s0, s1, acc0, acc1, row_lo, col, g.w_pad);
      if (part >= 0) part += work.slices;
    }
  }
  if constexpr (SPLIT) arrive<NF>(work, s0, s1, row_lo, col, g.w_pad, smem);
}

// K2 forming wx in the walk
namespace wlk {

constexpr int kPiece = 256;          // entries staged at a time
constexpr int kNever = 1 << 30;      // an empty range's lo; hi = -kNever
// words per staged entry: its segments, its ranges, the column record
// and ranges, and its eight wy
constexpr int kSmemBytes = (kSeg + 4 + 4 + 2 + 8) * kPiece * 4;

}  // namespace wlk

// K2's walk forming wx in the walk, over whole runs: a cut list traps
// (work_item, with no scratch), and the entry point gives it none
template <int NF, bool CUT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
sorted_splat_gauss_wide_kernel(const __grid_constant__ Work work,
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

  int64_t first, end, part;
  int bid, slice;
  if (!work_item(work, g.nb_total, first, end, bid, slice, part)) return;
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

  const int32_t* run = work.params + first * kSeg * kBlock;
  const int64_t npiece = (end - first) * kPieces;
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

template <bool TABLE, int NF, bool CUT, bool SPLIT>
int launch(const Work& w, float* f0, float* f1, const GaussGeom& g,
           cudaStream_t st) {
  const auto kernel = TABLE ? sorted_splat_gauss_kernel<NF, CUT, SPLIT>
                            : sorted_splat_gauss_wide_kernel<NF, CUT>;
  const int smem = TABLE ? tbl::kSmemBytes : wlk::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one CTA an item: the list's items times the slices of a tile
  const unsigned grid = static_cast<unsigned>(w.nwork * w.slices);
  kernel<<<grid, kThreads, smem, st>>>(w, f0, f1, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool TABLE, bool SPLIT>
int launch_walk(const Work& w, float* f0, float* f1, int nf, int cut,
                const GaussGeom& g, cudaStream_t st) {
  if (nf == 1)
    return cut ? launch<TABLE, 1, true, SPLIT>(w, f0, f1, g, st)
               : launch<TABLE, 1, false, SPLIT>(w, f0, f1, g, st);
  return cut ? launch<TABLE, 2, true, SPLIT>(w, f0, f1, g, st)
             : launch<TABLE, 2, false, SPLIT>(w, f0, f1, g, st);
}

}  // namespace

extern "C" {

int pcr_sorted_splat_gauss_block() { return kBlock; }
int pcr_sorted_splat_gauss_piece() { return tbl::kPiece; }
int pcr_sorted_splat_gauss_table_radius() { return kTableRadius; }
int pcr_sorted_splat_gauss_table() { return tbl::kTable; }

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// th must be a multiple of 8 and wt of 128; `slices` and `smem` are the
// wrapper's plan (gauss_kernels.splat_plan), `work` its work list of `nwork`
// items (gauss_kernels.gauss_work: [first, end, tail, base] a tile run or
// a segment of one, -1 in an unused row), one CTA an item and slice.
// `scratch`, 16-byte aligned, holds `blocks` counters, padded to 16 bytes,
// then `blocks` (sub-chunk, slice) sums of nf x 8 x 128 floats for the cut
// runs' tail segments; the counters are zeroed here, by one asynchronous
// memset before the launch. `rmax`, the chunk's largest radius (-1: not
// known), picks the walk: the factor tables up to kTableRadius, the only
// walk that takes a cut list and scratch. Allocates nothing and does not
// synchronise.
int pcr_sorted_splat_gauss(const void* params, const void* bids, int64_t nsub,
                           void* s0, void* s1, int nf, int cut, int rmax,
                           int th, int wt, int ncb, int nb_total, int w_pad,
                           int H, int W,
                           int multi_tile, int tile_w, int tile_h,
                           int row_offset, int global_h, int slices, int smem,
                           const void* work, int64_t nwork, void* scratch,
                           int64_t blocks, void* stream) {
  if (nsub <= 0 || nwork == 0) return static_cast<int>(cudaSuccess);
  if (slices <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool table = rmax >= 0 && rmax <= kTableRadius;
  // the wrapper plans the grid, the shared memory, the work list and the
  // scratch; the first two must be the kernel's own, the list at most an
  // item a sub-chunk
  if (th % kSliceRows || wt % kSliceCols || (nf != 1 && nf != 2) ||
      slices != (th / kSliceRows) * (wt / kSliceCols) || smem != kPlanSmem ||
      reinterpret_cast<uintptr_t>(params) % 16 || work == nullptr ||
      reinterpret_cast<uintptr_t>(work) % 16 || nwork < 0 || nwork > nsub ||
      nwork > INT32_MAX / slices || blocks < 0 ||
      (blocks > 0 && (!table || scratch == nullptr ||
                      reinterpret_cast<uintptr_t>(scratch) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const GaussGeom g{th, wt, ncb, nb_total, w_pad, H, W, multi_tile,
                    tile_w, tile_h, row_offset, global_h};
  auto* arrivals = static_cast<int32_t*>(scratch);
  const Work w{static_cast<const int32_t*>(params),
               static_cast<const int32_t*>(bids), nsub,
               static_cast<const int4*>(work), nwork, slices, arrivals,
               blocks > 0 ? reinterpret_cast<float*>(arrivals +
                                                     (blocks + 3) / 4 * 4)
                          : nullptr,
               blocks};
  auto* f0 = static_cast<float*>(s0);
  auto* f1 = static_cast<float*>(s1);
  auto st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const cudaError_t err =
        cudaMemsetAsync(arrivals, 0, blocks * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a launch whose list cuts no run (no scratch) takes the kernels that
  // add every sum into the state, with nothing of the cut in their walk
  if (!table) return launch_walk<false, false>(w, f0, f1, nf, cut, g, st);
  return blocks > 0 ? launch_walk<true, true>(w, f0, f1, nf, cut, g, st)
                    : launch_walk<true, false>(w, f0, f1, nf, cut, g, st);
}

}  // extern "C"

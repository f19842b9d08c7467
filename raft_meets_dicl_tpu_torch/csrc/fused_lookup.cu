// fused_lookup: the windowed-lookup contraction of one volume level,
// stage 1 alone and both stages fused, for Hopper (sm_90a).
//
// Replaces the TPU kernels scripts/probe_fused_lookup.py::_stage1_kernel
// (launched by _pallas_stage1) and ::_fused_kernel (launched by
// _pallas_fused), the level-0 lookup of ops/corr.py::_lookup_level written
// as hand-scheduled dots.
//
// What they compute, per position n (the flattened leading axes) with
// K = 9 window rows:
//   stage 1: t[n, k, w]   = sum over h of wy[n, k, h] * corr[n, h, w]
//            (wy (N, K, H2), corr (N, H2, W2), t (N, K, W2) float32)
//   fused:   t rounded to the inputs' dtype (round to nearest even, as
//            .to(torch.bfloat16) and XLA's convert do), then
//            out[n, k, a] = sum over w of t[n, k, w] * wx[n, a, w]
//            (wx (N, K, W2), out (N, K, K) float32, axes (wy's k, wx's a))
// for any wy and wx: the dense contraction, not a gather of the two
// non-zero hat weights a bilinear row has. Inputs are float32 or bfloat16,
// every product and sum is float32 (bf16 products are exact in float32).
//
// Bound: memory. Per position stage 1 reads K·H2 + H2·W2 input values and
// writes K·W2 floats for 2·K·H2·W2 operations: about K = 9 operations per
// byte of a bf16 corr (4.5 in float32), below the card's ridge (~20 a byte
// on float32 cores, ~295 on the bf16 tensor cores), so the least time is
// the bytes over 3.35 TB/s. The fused kernel reads wy, corr and wx once
// (K·H2 + H2·W2 + K·W2 values) and writes K·K floats: the same bound.
//
// Both kernels share one streaming main loop. corr is the bulk of the
// bytes and the blocks of consecutive positions are contiguous in memory,
// so a block takes a run of positions and streams it through a ring of
// kStages shared-memory buffers, kStages - 1 of them in flight while it
// computes on another: stage 1 with 16-byte asynchronous copies
// (cp.async.cg) issued by every thread, the fused kernel with bulk copies
// (TMA) issued by one thread. A stage is one contiguous span of corr,
// copied flat from its 16-byte-aligned start (a position's block of H2·W2
// values starts at any element: 9,000 bytes at the probe's bf16 50x90,
// ragged shapes at 2-byte offsets), with the tail past the tensor's end
// zero-filled. A stage holds:
//   whole mode    up to kMaxUnits whole positions (H2·W2 values each fit
//                 kStageCap bytes; the probe's case: 2 bf16 / 1 f32), and
//                 after them the positions' wy (K·H2 values each, also
//                 contiguous) and, fused, their wx (K·W2 values each),
//                 copied the same way;
//   rows mode     H2 rows in chunks of hc rows of one position (a position
//                 larger than kStageCap, e.g. 20x700 float32, or, fused,
//                 one whose wx exceeds kWxCap);
//   segment mode  one row in column segments (a row larger than kStageCap;
//                 stage 1 only: a fused row is at most 3,211 wide).
// In rows and segment modes the later units of a position add into t,
// which that block alone writes, so every shape the wrappers accept runs;
// there the stage's wy rows are read from device memory.
// - bf16 inputs: mma.sync m16n8k16 with float32 accumulation. A = wy (K
//   padded to 16 rows, H2 to whole 16-row k tiles, zeros), read in pairs
//   of 16-bit values from the stage's copy of wy; B = corr (16 rows x 8
//   columns, each value read from the flat stage with a 16-bit load: its
//   rows are not 16-byte aligned, so ldmatrix cannot); C = t. A warp takes
//   one position and three 8-column tiles. bf16 products are exact in
//   float32, so only the summation order changes.
// - float32 inputs: FMAs (TF32 would break the tolerance). The stage's wy
//   is first laid out as rows of kWyPad values (k = 0..8); a thread owns
//   one column and all K rows, 9 accumulators, and reads each wy row as
//   two float4 and a float broadcast to the position's threads.
// Stage 1 writes t coalesced along w (float2 pairs where W2 is even).
//
// The fused kernel. The single-pass design it replaces gave a thread one
// (position, column) and read corr with one synchronous 2- or 4-byte load
// a row (about 6 KB in flight an SM, where the card's latency needs ~15
// KB), staged wy as float32 behind two block barriers a 32-row chunk,
// ran bf16 on FMAs, and ended with a serial tail: wx staged only after
// stage 1, then a thread per output summing W2 products from shared
// memory with no load in flight. Here each of those goes:
// - streaming: the main loop above, with each stage's wx copied after its
//   wy, so corr, wy and wx of the next kStages - 1 stages are in flight
//   while the block computes (up to 24 KB of corr a stage, 3 blocks an SM
//   on the probe's shapes: kWholeBlocks bounds the registers). One thread
//   issues a stage as three bulk copies completing on the buffer's
//   mbarrier: the 16-byte copies of stage 1 cost every thread over a
//   hundred instructions a stage and their issue stalled the warps, and
//   at the probe's shapes the fused kernel is bound by the SM's
//   instruction issue rather than by the bytes (PERF.md);
// - barriers: the mbarrier wait and one block barrier a stage (two for
//   float32, whose wy is laid out first);
// - bf16 (whole mode): stage 1 on mma.sync as above, a warp per (position,
//   run of 3-tile groups); t never leaves registers. Stage 2 is a second
//   m16n8k16 whose A is t itself: C's rows g, g + 8 and columns 2t, 2t + 1
//   of tiles j and j + 1 are A's layout for one k16 step, so each pair of
//   C fragments is rounded with __floats2bfloat162_rn and reused as A
//   (the C-to-A register reuse of flash attention; a group's third tile
//   pairs with zeros). B is wx: rows a = 0..8 are the n axis (two n8
//   tiles, a >= 9 zero), its depth is w. Columns past the group or past
//   W2, and rows k >= 9, are zero in both operands (masked reads, so
//   0 · inf from another position's data never enters the sum);
// - float32 (whole mode): a warp per (position, run of 32-column chunks),
//   a lane per column with stage 1's FMA body, so t is in registers; each
//   lane forms its column's K·K products t[k]·wx[a] and the warp sums
//   them over its 32 columns with a reduce-scatter of shuffles (five
//   halving steps, 93 shuffles for 96 padded values; lane L ends with
//   elements 3L..3L + 2) instead of a serial loop per output;
// - rows mode (both dtypes): t must be whole over H2 before it is
//   rounded, so each unit adds its t into a (K, W2) float32 tile in shared
//   memory (stage 1's compute, into shared memory instead of device
//   memory); after a position's last unit the warps split its columns,
//   round t, read wx from device memory and reduce as float32 does.
// Each warp writes its partial (K, K) sums to its own slot in shared
// memory; in the next stage the block adds a position's slots in warp
// order and writes out: no atomics, the same result every run. Slots are
// double-buffered so that sum and the next stage's work need no barrier
// of their own. In bf16 whole mode only the last, partial k tile of
// stage 1 masks its rows; the columns of B past W2 are not masked there,
// since they reach only t's columns past W2, which stage 2 zeroes.
//
// Launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError(), or
// cudaErrorInvalidValue for K other than kK (radius 4, every shipped
// config's), inputs not 16-byte aligned (the wrapper copies them
// otherwise) or a plan larger than the card's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 9;          // window rows (2 * radius + 1, radius 4)
constexpr int kKK = kK * kK;   // fused outputs a position
constexpr int kThreads = 256;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // a block's limit on Hopper

constexpr int kStages = 3;              // ring of stage buffers
constexpr int kStageCap = 24 * 1024;    // corr bytes a stage holds, at most
constexpr int kMaxUnits = 8;            // whole positions a stage, at most
constexpr int kWyCap = 16 * 1024;       // bytes of a stage's staged wy
constexpr int kWxCap = 16 * 1024;       // bytes of a stage's wx (fused)
constexpr int kWyPad = 12;              // floats a staged float32 wy row
constexpr int kTilesPerWarp = 3;        // 8-column tiles a bf16 warp item
constexpr int kWholeBlocks = 3;         // fused whole mode: blocks an SM

// How a launch cuts corr into stages (host-computed, see make_plan).
struct Plan {
  long long n;       // positions
  int h2;
  int w2;
  int whole;         // 1: whole mode (wy, and wx fused, in the stage)
  int units;         // whole positions a stage (whole mode), else 1
  int upp;           // stages a position: 1 in whole mode
  int hc;            // rows a unit, at most
  int seg;           // columns a unit, at most (W2 unless segment mode)
  int spr;           // column segments a row (1 unless segment mode)
  long long stages;  // stages in all
  long long spb;     // stages a block
  int corr_bytes;    // bytes of a ring buffer's corr span (a multiple of 16)
  int wy_bytes;      // bytes of its wy span (whole mode), else 0
  int wx_bytes;      // bytes of its wx span (fused whole mode), else 0
  int stage_bytes;   // bytes of one ring buffer: corr, wy, wx
  int hp;            // bf16 path: the staged wy tile's row stride
  // fused only
  int ipu;           // warp items a unit (whole) or a position's stage 2
  int gpi;           // granules an item: 3-tile groups (bf16 whole mode)
                     // or 32-column chunks
  int swy_off;       // shared-memory offsets of the staged wy, the slots,
  int slot_off;      // the rows-mode t tile and the ring's mbarriers, and
  int ts_off;        // the bytes in all
  int bar_off;
  int smem;
};

// What stage j holds: nu units starting at position p; each unit covers
// rows [h0, h0 + rows) and columns [c0, c0 + cols) of its position; the
// stage is elements [e0, e0 + ne) of corr.
struct Span {
  long long p;
  int nu;
  int h0;
  int rows;
  int c0;
  int cols;
  long long e0;
  long long ne;
};

__device__ __forceinline__ Span span_at(const Plan& pl, long long j) {
  const long long pos_elems = static_cast<long long>(pl.h2) * pl.w2;
  Span s;
  if (pl.upp == 1) {
    s.p = j * pl.units;
    s.nu = static_cast<int>(pl.n - s.p < pl.units ? pl.n - s.p : pl.units);
    s.h0 = 0;
    s.rows = pl.h2;
    s.c0 = 0;
    s.cols = pl.w2;
    s.e0 = s.p * pos_elems;
    s.ne = s.nu * pos_elems;
    return s;
  }
  s.p = j / pl.upp;
  const int sub = static_cast<int>(j - s.p * pl.upp);
  s.nu = 1;
  if (pl.spr == 1) {
    s.h0 = sub * pl.hc;
    s.rows = pl.h2 - s.h0 < pl.hc ? pl.h2 - s.h0 : pl.hc;
    s.c0 = 0;
    s.cols = pl.w2;
    s.ne = static_cast<long long>(s.rows) * pl.w2;
  } else {
    s.h0 = sub / pl.spr;
    s.rows = 1;
    s.c0 = (sub % pl.spr) * pl.seg;
    s.cols = pl.w2 - s.c0 < pl.seg ? pl.w2 - s.c0 : pl.seg;
    s.ne = s.cols;
  }
  s.e0 = s.p * pos_elems + static_cast<long long>(s.h0) * pl.w2 + s.c0;
  return s;
}

// Queue 16-byte copies of elements [e0, e0 + ne) of src into dst: the
// span's bytes from the 16-byte boundary at or below its start; the chunk
// that crosses the tensor's end (total_bytes) copies what lies inside it
// and zero-fills the rest.
template <typename T>
__device__ __forceinline__ void copy_span(const T* __restrict__ src,
                                          long long total_bytes, long long e0,
                                          long long ne, unsigned char* dst) {
  const long long g0 = e0 * static_cast<long long>(sizeof(T));
  const long long g1 = (e0 + ne) * static_cast<long long>(sizeof(T));
  const long long a0 = g0 & ~15LL;
  const int chunks = static_cast<int>((g1 - a0 + 15) >> 4);
  const char* from = reinterpret_cast<const char*>(src) + a0;
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const long long left = total_bytes - a0 - 16LL * i;
    const int valid = left < 16 ? static_cast<int>(left) : 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     to + 16 * i),
                 "l"(from + 16LL * i), "r"(valid)
                 : "memory");
  }
}

// elements of misalignment of a span copied by copy_span
template <typename T>
__device__ __forceinline__ int span_shift(long long e0) {
  return static_cast<int>((e0 * static_cast<long long>(sizeof(T))) & 15) /
         static_cast<int>(sizeof(T));
}

// Queue stage j's corr span into buf and, in whole mode, its positions'
// wy rows (K·H2 values each, contiguous) after it.
template <typename T>
__device__ __forceinline__ void issue_stage(const Plan& pl,
                                            const T* __restrict__ wy,
                                            const T* __restrict__ corr,
                                            long long j, unsigned char* buf) {
  const Span s = span_at(pl, j);
  copy_span(corr, pl.n * pl.h2 * static_cast<long long>(pl.w2) * sizeof(T),
            s.e0, s.ne, buf);
  if (pl.whole) {
    const long long per = static_cast<long long>(kK) * pl.h2;
    copy_span(wy, pl.n * per * static_cast<long long>(sizeof(T)), s.p * per,
              s.nu * per, buf + pl.corr_bytes);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// t[p, k, c0 + w] = v, or += v for a later unit of the same position
__device__ __forceinline__ void put(float* __restrict__ out, long long idx,
                                   float v, bool add) {
  out[idx] = add ? out[idx] + v : v;
}

// the same for two neighbouring columns (idx even: 8-byte aligned)
__device__ __forceinline__ void put2(float* __restrict__ out, long long idx,
                                    float v0, float v1, bool add) {
  float2* o = reinterpret_cast<float2*>(out + idx);
  if (add) {
    const float2 a = *o;
    v0 += a.x;
    v1 += a.y;
  }
  *o = make_float2(v0, v1);
}

// The stage's wy rows [h0, h0 + rows) into a compute layout. src points
// at unit 0's row k = 0, h = h0, and unit u's row k starts (u·K + k)·H2
// values further: the raw copy in shared memory (whole mode) or wy in
// device memory (rows and segment modes). A warp takes a (unit, k) row.
// float32: (unit, row) rows of kWyPad values (k = 0..8, then padding)
__device__ __forceinline__ void stage_wy(const float* src, const Plan& pl,
                                         const Span& s, float* swy) {
  const int lane = threadIdx.x % 32;
  for (int uk = threadIdx.x / 32; uk < s.nu * kK; uk += kWarps) {
    const int u = uk / kK;
    const float* from = src + uk * static_cast<long long>(pl.h2);
    float* to = swy + u * pl.hc * kWyPad + (uk - u * kK);
    for (int r = lane; r < s.rows; r += 32) to[r * kWyPad] = from[r];
  }
}

// bf16 (rows and segment modes): (k, r) rows of hp values, zeros up to
// the next 16 rows
__device__ __forceinline__ void stage_wy(const __nv_bfloat16* src,
                                         const Plan& pl, const Span& s,
                                         __nv_bfloat16* swy) {
  const int lane = threadIdx.x % 32;
  const int rp = (s.rows + 15) & ~15;
  const unsigned short* from = reinterpret_cast<const unsigned short*>(src);
  unsigned short* to = reinterpret_cast<unsigned short*>(swy);
  for (int k = threadIdx.x / 32; k < kK; k += kWarps) {
    for (int r = lane; r < rp; r += 32) {
      to[k * pl.hp + r] =
          r < s.rows ? from[k * static_cast<long long>(pl.h2) + r]
                     : static_cast<unsigned short>(0);
    }
  }
}

// a[k] = sum over r < rows of wr[r·kWyPad + k] · col[r·w2]: one column of
// t from a staged float32 wy (rows of kWyPad) and the stage's corr
__device__ __forceinline__ void column_t(const float* col, const float* wr,
                                         int rows, int w2, float (&a)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) a[k] = 0.f;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float c = col[r * w2];
    const float4 w0 = *reinterpret_cast<const float4*>(wr + r * kWyPad);
    const float4 w1 = *reinterpret_cast<const float4*>(wr + r * kWyPad + 4);
    const float w8 = wr[r * kWyPad + 8];
    const float wv[kK] = {w0.x, w0.y, w0.z, w0.w, w1.x,
                          w1.y, w1.z, w1.w, w8};
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = fmaf(wv[k], c, a[k]);
  }
}

// float32 stage: a thread owns one column of one unit and all K rows;
// each wy row is two float4 and a float broadcast to the unit's threads.
// t goes to out[(p - p_base)·K·W2 + ...] (device memory, or the fused
// kernel's shared tile of one position).
__device__ __forceinline__ void compute_stage(const Plan& pl, const Span& s,
                                              const float* cb,
                                              const float* swy,
                                              float* __restrict__ out,
                                              long long p_base) {
  const long long pos_elems = static_cast<long long>(pl.h2) * pl.w2;
  const bool add = s.h0 > 0;
  for (int it = threadIdx.x; it < s.nu * s.cols; it += kThreads) {
    const int u = it / s.cols;
    const int w = it - u * s.cols;
    float a[kK];
    column_t(cb + u * pos_elems + w, swy + u * pl.hc * kWyPad, s.rows,
             pl.w2, a);
    const long long o = (s.p - p_base + u) * kK * static_cast<long long>(pl.w2)
                        + s.c0 + w;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      put(out, o + static_cast<long long>(k) * pl.w2, a[k], add);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// row[i], row[i + 1] as one 32-bit pair (row[i] low), each 0 at or past lim
__device__ __forceinline__ unsigned pair_lim(const unsigned short* row,
                                             int i, int lim) {
  const unsigned lo = i < lim ? row[i] : 0u;
  const unsigned hi = i + 1 < lim ? row[i + 1] : 0u;
  return lo | (hi << 16);
}

// row[i], row[i + 1] as one 32-bit pair (row[i] low), unmasked
__device__ __forceinline__ unsigned pair_at(const unsigned short* row,
                                            int i) {
  return static_cast<unsigned>(row[i]) |
         (static_cast<unsigned>(row[i + 1]) << 16);
}

// One 16-row k tile (kt) of t's 16 x 8 tiles n_first .. n_first +
// kTilesPerWarp - 1 of one unit, added into acc: wy's A fragment once,
// then each column tile's B fragment from the flat corr (cu: the unit's
// first value, row stride w2). Fragment layouts (g = lane / 4,
// t = lane % 4): A rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9;
// B rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g; C rows g, g + 8,
// columns 2t, 2t + 1. Rows k >= 9 of A are zero, so only lane group
// g = 0 reads the second half (k = 8: w8; wg is row k = g). kRows: rows
// r >= rows read as zeros (a partial k tile: B's rows past H2 may hold
// another position's values, and 0 · inf would reach every row of t);
// kCols: columns >= cols of B too (else they only fill t's columns past
// cols, which the caller drops).
template <bool kRows, bool kCols>
__device__ __forceinline__ void mma_ktile(float (&acc)[kTilesPerWarp][4],
                                          const unsigned short* cu,
                                          const unsigned short* wg,
                                          const unsigned short* w8,
                                          int rows, int cols, int w2,
                                          int n_first, int kt) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = kt * 16 + 2 * t;
  unsigned a0, a1, a2, a3;
  if constexpr (kRows) {
    a0 = pair_lim(wg, h, rows);
    a2 = pair_lim(wg, h + 8, rows);
    a1 = g == 0 ? pair_lim(w8, h, rows) : 0u;
    a3 = g == 0 ? pair_lim(w8, h + 8, rows) : 0u;
  } else {
    a0 = pair_at(wg, h);
    a2 = pair_at(wg, h + 8);
    a1 = g == 0 ? pair_at(w8, h) : 0u;
    a3 = g == 0 ? pair_at(w8, h + 8) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    const int w = (n_first + j) * 8 + g;
    if ((n_first + j) * 8 < cols) {
      const bool ok = !kCols || w < cols;
      const unsigned short* c = cu + w;
      const unsigned v0 = ok && (!kRows || h < rows) ? c[h * w2] : 0u;
      const unsigned v1 =
          ok && (!kRows || h + 1 < rows) ? c[(h + 1) * w2] : 0u;
      const unsigned v8 =
          ok && (!kRows || h + 8 < rows) ? c[(h + 8) * w2] : 0u;
      const unsigned v9 =
          ok && (!kRows || h + 9 < rows) ? c[(h + 9) * w2] : 0u;
      mma_bf16(acc[j], a0, a1, a2, a3, v0 | (v1 << 16), v8 | (v9 << 16));
    }
  }
}

// t's tiles n_first .. n_first + kTilesPerWarp - 1 of one unit into acc
// (see mma_ktile). Stage 1 masks every k tile's rows and columns; the
// fused kernel (kFused) masks only the rows of the last, partial k tile,
// and runs the full ones two at a time.
template <bool kFused>
__device__ __forceinline__ void mma_tiles(float (&acc)[kTilesPerWarp][4],
                                          const unsigned short* cu,
                                          const unsigned short* wg,
                                          const unsigned short* w8, int rows,
                                          int cols, int w2, int n_first) {
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  if constexpr (kFused) {
    const int full = rows / 16;
#pragma unroll 2
    for (int kt = 0; kt < full; ++kt) {
      mma_ktile<false, false>(acc, cu, wg, w8, rows, cols, w2, n_first, kt);
    }
    if (full * 16 < rows) {
      mma_ktile<true, false>(acc, cu, wg, w8, rows, cols, w2, n_first, full);
    }
  } else {
    const int k_tiles = (rows + 15) / 16;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mma_ktile<true, true>(acc, cu, wg, w8, rows, cols, w2, n_first, kt);
    }
  }
}

// bf16 stage: a warp takes one unit and kTilesPerWarp 8-column tiles (see
// mma_tiles). wy's row k of unit u starts at wy[(u·K + k)·ws]. t goes to
// out[(p - p_base)·K·W2 + ...] as the float32 stage's.
__device__ __forceinline__ void compute_stage(const Plan& pl, const Span& s,
                                              const __nv_bfloat16* cbp,
                                              const __nv_bfloat16* wyp,
                                              int ws,
                                              float* __restrict__ out,
                                              long long p_base) {
  const long long pos_elems = static_cast<long long>(pl.h2) * pl.w2;
  const unsigned short* cb = reinterpret_cast<const unsigned short*>(cbp);
  const unsigned short* wy = reinterpret_cast<const unsigned short*>(wyp);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (s.cols + 7) / 8;
  const int groups = (n_tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  const bool add = s.h0 > 0;
  const bool pairs = (pl.w2 % 2) == 0;  // t's rows 8-byte aligned
  for (int it = warp; it < s.nu * groups; it += kWarps) {
    const int u = it / groups;
    const int n_first = (it - u * groups) * kTilesPerWarp;
    float acc[kTilesPerWarp][4];
    mma_tiles<false>(acc, cb + u * pos_elems, wy + (u * kK + g) * ws,
              wy + (u * kK + 8) * ws, s.rows, s.cols, pl.w2, n_first);
    const long long o =
        (s.p - p_base + u) * kK * static_cast<long long>(pl.w2) + s.c0;
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
      const int w = (n_first + j) * 8 + 2 * t;
      const long long og = o + static_cast<long long>(g) * pl.w2 + w;
      const long long o8 = o + 8LL * pl.w2 + w;
      if (pairs && w + 1 < s.cols) {
        put2(out, og, acc[j][0], acc[j][1], add);
        if (g == 0) put2(out, o8, acc[j][2], acc[j][3], add);
      } else {
        if (w < s.cols) {
          put(out, og, acc[j][0], add);
          if (g == 0) put(out, o8, acc[j][2], add);
        }
        if (w + 1 < s.cols) {
          put(out, og + 1, acc[j][1], add);
          if (g == 0) put(out, o8 + 1, acc[j][3], add);
        }
      }
    }
  }
}

// the staged wy buffer's type: float32 rows, or bf16 tiles
template <typename T>
struct WyStage {
  using type = float;
};
template <>
struct WyStage<__nv_bfloat16> {
  using type = __nv_bfloat16;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stage1_kernel(const T* __restrict__ wy, const T* __restrict__ corr,
                  float* __restrict__ out, Plan pl) {
  using W = typename WyStage<T>::type;
  extern __shared__ __align__(16) unsigned char smem1[];
  W* swy = reinterpret_cast<W*>(smem1 + kStages * pl.stage_bytes);
  const long long j0 = static_cast<long long>(blockIdx.x) * pl.spb;
  const int nj = static_cast<int>(
      pl.stages - j0 < pl.spb ? pl.stages - j0 : pl.spb);

  // kStages - 1 stages in flight before the first is consumed; every
  // thread commits one group a stage (possibly empty), so the counts of
  // cp.async.wait_group line up
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nj) issue_stage(pl, wy, corr, j0 + s, smem1 + s * pl.stage_bytes);
    cp_async_commit();
  }
  for (int s = 0; s < nj; ++s) {
    // refill the buffer the previous iteration consumed
    if (s + kStages - 1 < nj) {
      issue_stage(pl, wy, corr, j0 + s + kStages - 1,
                  smem1 + ((s + kStages - 1) % kStages) * pl.stage_bytes);
    }
    cp_async_commit();
    const Span sp = span_at(pl, j0 + s);
    const unsigned char* buf = smem1 + (s % kStages) * pl.stage_bytes;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage s is in shared memory
    // wy of the stage: the raw copy after corr (whole mode), else rows
    // [h0, h0 + rows) of wy in device memory
    const T* wraw =
        reinterpret_cast<const T*>(buf + pl.corr_bytes) +
        span_shift<T>(sp.p * kK * static_cast<long long>(pl.h2));
    const T* wdev = wy + (sp.p * kK) * static_cast<long long>(pl.h2) + sp.h0;
    const T* cb = reinterpret_cast<const T*>(buf) + span_shift<T>(sp.e0);
    if constexpr (sizeof(T) == 4) {
      // float32: rows of kWyPad values
      if (pl.whole) {
        stage_wy(wraw, pl, sp, swy);
      } else {
        stage_wy(wdev, pl, sp, swy);
      }
      __syncthreads();
      compute_stage(pl, sp, cb, swy, out, 0);
    } else if (pl.whole) {
      compute_stage(pl, sp, cb, wraw, pl.h2, out, 0);  // the raw copy
    } else {
      stage_wy(wdev, pl, sp, swy);
      __syncthreads();
      compute_stage(pl, sp, cb, swy, pl.hp, out, 0);
    }
    __syncthreads();  // its buffers may be refilled
  }
  cp_async_wait<0>();
}

// Cut N positions of H2 x W2 into stages (see the modes at the top) and
// spread the stages over one wave of blocks. Fused: each stage of whole
// mode also holds its positions' wx, and the warp items and the shared
// memory of the fused kernel are laid out.
template <typename T>
Plan make_plan(long long n, int h2, int w2, int blocks, bool fused) {
  const long long es = sizeof(T);
  const bool bf16 = sizeof(T) == 2;
  // bytes of staged wy a unit of r rows takes
  auto staged_wy = [&](long long r) {
    return bf16 ? kK * (((r + 15) & ~15LL) + 8) * 2 : r * kWyPad * 4;
  };
  const long long wx_unit = fused ? kK * static_cast<long long>(w2) * es : 0;
  Plan pl = {};
  pl.n = n;
  pl.h2 = h2;
  pl.w2 = w2;
  const long long pos_bytes = static_cast<long long>(h2) * w2 * es;
  long long stage_elems;
  if (pos_bytes <= kStageCap && staged_wy(h2) <= kWyCap &&
      wx_unit <= kWxCap) {
    long long u = kStageCap / pos_bytes;
    const long long uw = kWyCap / staged_wy(h2);
    u = u < uw ? u : uw;
    if (fused) u = u < kWxCap / wx_unit ? u : kWxCap / wx_unit;
    pl.whole = 1;
    pl.units = static_cast<int>(u < kMaxUnits ? u : kMaxUnits);
    pl.upp = 1;
    pl.hc = h2;
    pl.seg = w2;
    pl.spr = 1;
    pl.stages = (n + pl.units - 1) / pl.units;
    stage_elems = pl.units * static_cast<long long>(h2) * w2;
  } else if (w2 * es <= kStageCap) {
    long long hc = kStageCap / (w2 * es);
    while (hc > 1 && staged_wy(hc) > kWyCap) hc /= 2;
    pl.hc = static_cast<int>(hc < h2 ? hc : h2);
    pl.units = 1;
    pl.seg = w2;
    pl.spr = 1;
    pl.upp = (h2 + pl.hc - 1) / pl.hc;
    pl.stages = n * pl.upp;
    stage_elems = static_cast<long long>(pl.hc) * w2;
  } else {
    pl.hc = 1;
    pl.units = 1;
    pl.seg = static_cast<int>((kStageCap / es) & ~7LL);
    pl.spr = (w2 + pl.seg - 1) / pl.seg;
    pl.upp = h2 * pl.spr;
    pl.stages = n * pl.upp;
    stage_elems = pl.seg;
  }
  pl.corr_bytes = static_cast<int>((stage_elems * es + 32 + 15) & ~15LL);
  pl.wy_bytes =
      pl.whole ? static_cast<int>((pl.units * kK * h2 * es + 32 + 15) & ~15LL)
               : 0;
  pl.wx_bytes =
      pl.whole && fused
          ? static_cast<int>((pl.units * wx_unit + 32 + 15) & ~15LL)
          : 0;
  pl.stage_bytes = pl.corr_bytes + pl.wy_bytes + pl.wx_bytes;
  pl.hp = ((pl.hc + 15) & ~15) + 8;
  // whole positions per block in rows and segment modes
  long long spb = (pl.stages + blocks - 1) / blocks;
  spb = (spb + pl.upp - 1) / pl.upp * pl.upp;
  pl.spb = spb < 1 ? 1 : spb;
  if (fused) {
    // granules of a unit's columns: bf16 whole mode's 3-tile groups (its
    // mma path), else 32-column chunks (a lane a column); a unit's warps
    // split them into runs of gpi, none empty
    const bool mma = bf16 && pl.whole;
    const int granules =
        mma ? ((w2 + 7) / 8 + kTilesPerWarp - 1) / kTilesPerWarp
            : (w2 + 31) / 32;
    const int warps = pl.whole ? kWarps / pl.units : kWarps;
    const int ipu = warps < granules ? warps : granules;
    pl.gpi = (granules + ipu - 1) / ipu;
    pl.ipu = (granules + pl.gpi - 1) / pl.gpi;
    const long long swy =
        bf16 ? (pl.whole ? 0 : static_cast<long long>(kK) * pl.hp * 2)
             : static_cast<long long>(pl.units) * pl.hc * kWyPad * 4;
    const long long slots =
        2LL * pl.units * pl.ipu * kKK * static_cast<long long>(sizeof(float));
    const long long ts =
        pl.whole ? 0 : static_cast<long long>(kK) * w2 * sizeof(float);
    const long long swy_off = static_cast<long long>(kStages) * pl.stage_bytes;
    const long long slot_off = swy_off + ((swy + 15) & ~15LL);
    const long long ts_off = slot_off + ((slots + 15) & ~15LL);
    const long long bar_off = (ts_off + ts + 15) & ~15LL;
    const long long total = bar_off + kStages * 8;
    pl.swy_off = static_cast<int>(swy_off);
    pl.slot_off = static_cast<int>(slot_off);
    pl.ts_off = static_cast<int>(ts_off);
    pl.bar_off = static_cast<int>(bar_off);
    // (capped, so a plan past the card's limit is refused, not wrapped)
    pl.smem = static_cast<int>(
        total <= kMaxSharedBytes ? total : kMaxSharedBytes + 1);
  }
  return pl;
}

template <typename T>
size_t stage1_smem(const Plan& pl) {
  const size_t wy = sizeof(T) == 2
                        ? static_cast<size_t>(pl.units) * kK * pl.hp * 2
                        : static_cast<size_t>(pl.units) * pl.hc * kWyPad * 4;
  return static_cast<size_t>(kStages) * pl.stage_bytes + ((wy + 15) & ~15);
}

template <typename T>
int launch_stage1(const void* wy, const void* corr, void* out, long long n,
                  int k, int h2, int w2, void* stream) {
  if (k != kK || h2 < 1 || w2 < 1 ||
      ((reinterpret_cast<uintptr_t>(wy) | reinterpret_cast<uintptr_t>(corr))
       & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    int device = 0;
    int sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // the plan's buffers do not depend on the block count; plan once to
    // size them, then spread the stages over the blocks that fit
    Plan pl = make_plan<T>(n, h2, w2, 1, false);
    const size_t smem = stage1_smem<T>(pl);
    if (smem > static_cast<size_t>(kMaxSharedBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaFuncSetAttribute(
        stage1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stage1_kernel<T>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    pl = make_plan<T>(n, h2, w2, blocks, false);
    const long long grid = (pl.stages + pl.spb - 1) / pl.spb;
    stage1_kernel<T><<<static_cast<unsigned int>(grid), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wy), static_cast<const T*>(corr),
        static_cast<float*>(out), pl);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- fused ------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// t rounded to the inputs' dtype, kept as float32
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v0, v1 (columns i, i + 1) rounded to bf16 as one A-fragment register,
// each 0 at or past lim
__device__ __forceinline__ unsigned pack_lim(float v0, float v1, int i,
                                             int lim) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(i < lim ? v0 : 0.f, i + 1 < lim ? v1 : 0.f);
  return *reinterpret_cast<const unsigned*>(&p);
}

// One halving step of reduce_outer: lanes with bit o keep the upper h
// values and add their partner's, the others the lower h.
template <int H>
__device__ __forceinline__ void halve(float (&v)[48], int o) {
  const bool up = (threadIdx.x & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = v[i + H];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, o);
  }
}

// r[i] += the warp's sum over its lanes (columns) of p[3·lane + i], where
// p[k·K + a] = tv[k]·xv[a] (p padded with zeros to 96 values): a
// reduce-scatter, five halving steps (offsets 16 .. 1, 93 shuffles) that
// leave lane L with elements 3L .. 3L + 2, in a fixed order.
__device__ __forceinline__ void reduce_outer(const float (&tv)[kK],
                                             const float (&xv)[kK],
                                             float (&r)[3]) {
  float v[48];
  const bool up = (threadIdx.x & 16) != 0;
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    const int e = i + 48;
    const float lo = tv[i / kK] * xv[i % kK];
    const float hi = e < kKK ? tv[e / kK] * xv[e % kK] : 0.f;
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 16);
  }
  halve<24>(v, 8);
  halve<12>(v, 4);
  halve<6>(v, 2);
  halve<3>(v, 1);
  r[0] += v[0];
  r[1] += v[1];
  r[2] += v[2];
}

// a warp's partial (K, K) sums (lane L: elements 3L .. 3L + 2) to its slot
__device__ __forceinline__ void put_slot(float* slot, const float (&r)[3]) {
  const int lane = threadIdx.x % 32;
  float* sw = slot + (threadIdx.x / 32) * kKK;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (3 * lane + i < kKK) sw[3 * lane + i] = r[i];
  }
}

// bf16 whole-mode stage: warp item (u, c) = (warp / ipu, warp % ipu) takes
// 3-tile groups [c·gpi, (c + 1)·gpi) of unit u. Stage 1 into registers
// (mma_tiles), then stage 2 from them: per pair of tiles one k16 step of a
// second m16n8k16 with A = t rounded to bf16 (C fragments reused as A,
// rows k = g and, g = 0, k = 8), B = wx (n = a: tile 0 a = g, tile 1
// a = 8 for g = 0; depth w), D accumulated over the warp's groups.
__device__ __forceinline__ void fused_stage(const Plan& pl, const Span& s,
                                            const __nv_bfloat16* cbp,
                                            const __nv_bfloat16* wyp,
                                            const __nv_bfloat16* wxp,
                                            float* slot) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int u = warp / pl.ipu;
  if (u >= s.nu) return;
  const int w2 = pl.w2;
  const long long pos_elems = static_cast<long long>(pl.h2) * w2;
  const unsigned short* cb = reinterpret_cast<const unsigned short*>(cbp);
  const unsigned short* wy = reinterpret_cast<const unsigned short*>(wyp);
  const unsigned short* wx = reinterpret_cast<const unsigned short*>(wxp);
  const int groups = ((w2 + 7) / 8 + kTilesPerWarp - 1) / kTilesPerWarp;
  const int q0 = (warp - u * pl.ipu) * pl.gpi;
  const int q1 = q0 + pl.gpi < groups ? q0 + pl.gpi : groups;
  const unsigned short* cu = cb + u * pos_elems;
  const unsigned short* wg = wy + (u * kK + g) * pl.h2;
  const unsigned short* w8 = wy + (u * kK + 8) * pl.h2;
  const unsigned short* xg = wx + (u * kK + g) * w2;
  const unsigned short* x8 = wx + (u * kK + 8) * w2;
  float d[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[0][i] = d[1][i] = 0.f;
  for (int q = q0; q < q1; ++q) {
    const int n_first = q * kTilesPerWarp;
    float acc[kTilesPerWarp][4];
    mma_tiles<true>(acc, cu, wg, w8, pl.h2, w2, w2, n_first);
    // the group's columns end here (a lone third tile pairs with zeros)
    const int end = (n_first + kTilesPerWarp) * 8;
    const int lim = end < w2 ? end : w2;
#pragma unroll
    for (int step = 0; step < (kTilesPerWarp + 1) / 2; ++step) {
      const int ja = 2 * step;
      const int jb = ja + 1;
      const int wa = (n_first + ja) * 8 + 2 * t;  // tile ja's columns
      const int wb = wa + 8;                      // tile jb's
      const unsigned a0 = pack_lim(acc[ja][0], acc[ja][1], wa, lim);
      const unsigned a1 =
          g == 0 ? pack_lim(acc[ja][2], acc[ja][3], wa, lim) : 0u;
      unsigned a2 = 0u;
      unsigned a3 = 0u;
      if (jb < kTilesPerWarp) {
        a2 = pack_lim(acc[jb][0], acc[jb][1], wb, lim);
        a3 = g == 0 ? pack_lim(acc[jb][2], acc[jb][3], wb, lim) : 0u;
      }
      const unsigned b0 = pair_lim(xg, wa, lim);
      const unsigned b1 = pair_lim(xg, wb, lim);
      const unsigned c0 = g == 0 ? pair_lim(x8, wa, lim) : 0u;
      const unsigned c1 = g == 0 ? pair_lim(x8, wb, lim) : 0u;
      mma_bf16(d[0], a0, a1, a2, a3, b0, b1);
      mma_bf16(d[1], a0, a1, a2, a3, c0, c1);
    }
  }
  // D rows g (k) and g + 8 (k = 8 for g = 0), columns 2t, 2t + 1 (a) of
  // n tile 0 and column 0 (a = 8) of n tile 1
  float* sw = slot + warp * kKK;
  sw[g * kK + 2 * t] = d[0][0];
  sw[g * kK + 2 * t + 1] = d[0][1];
  if (g == 0) {
    sw[8 * kK + 2 * t] = d[0][2];
    sw[8 * kK + 2 * t + 1] = d[0][3];
  }
  if (t == 0) {
    sw[g * kK + 8] = d[1][0];
    if (g == 0) sw[8 * kK + 8] = d[1][2];
  }
}

// float32 whole-mode stage: warp item (u, c) takes 32-column chunks
// [c·gpi, (c + 1)·gpi) of unit u, a lane a column: t by stage 1's FMA
// body, then the column's products with wx summed over the warp
// (reduce_outer). float32 t needs no rounding.
__device__ __forceinline__ void fused_stage(const Plan& pl, const Span& s,
                                            const float* cb,
                                            const float* swy,
                                            const float* wx, float* slot) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = warp / pl.ipu;
  if (u >= s.nu) return;
  const int w2 = pl.w2;
  const long long pos_elems = static_cast<long long>(pl.h2) * w2;
  const int chunks = (w2 + 31) / 32;
  const int q0 = (warp - u * pl.ipu) * pl.gpi;
  const int q1 = q0 + pl.gpi < chunks ? q0 + pl.gpi : chunks;
  const float* xu = wx + u * kK * static_cast<long long>(w2);
  float r[3] = {0.f, 0.f, 0.f};
  for (int q = q0; q < q1; ++q) {
    const int w = q * 32 + lane;
    float tv[kK];
    float xv[kK];
    if (w < w2) {
      column_t(cb + u * pos_elems + w, swy + u * pl.hc * kWyPad, pl.h2, w2,
               tv);
#pragma unroll
      for (int a = 0; a < kK; ++a) xv[a] = xu[a * w2 + w];
    } else {
#pragma unroll
      for (int k = 0; k < kK; ++k) tv[k] = xv[k] = 0.f;
    }
    reduce_outer(tv, xv, r);
  }
  put_slot(slot, r);
}

// rows-mode stage 2 of position p, once its (K, W2) t tile ts is whole:
// warp c takes 32-column chunks [c·gpi, (c + 1)·gpi), a lane a column, t
// rounded to the inputs' dtype, wx from device memory, reduce_outer.
template <typename T>
__device__ __forceinline__ void stage2_rows(const Plan& pl, long long p,
                                            const float* ts,
                                            const T* __restrict__ wx,
                                            float* slot) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= pl.ipu) return;
  const int w2 = pl.w2;
  const int chunks = (w2 + 31) / 32;
  const int q0 = warp * pl.gpi;
  const int q1 = q0 + pl.gpi < chunks ? q0 + pl.gpi : chunks;
  const T* xp = wx + p * kK * static_cast<long long>(w2);
  float r[3] = {0.f, 0.f, 0.f};
  for (int q = q0; q < q1; ++q) {
    const int w = q * 32 + lane;
    float tv[kK];
    float xv[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      tv[k] = w < w2 ? round_as(ts[k * w2 + w], wx) : 0.f;
      xv[k] = w < w2 ? to_f32(xp[k * w2 + w]) : 0.f;
    }
    reduce_outer(tv, xv, r);
  }
  put_slot(slot, r);
}

// out of positions p .. p + nu - 1: each output the sum of its unit's
// ipu warp slots, in warp order
__device__ __forceinline__ void finalize(const float* slot, int ipu,
                                         long long p, int nu,
                                         float* __restrict__ out) {
  for (int o = threadIdx.x; o < nu * kKK; o += kThreads) {
    const int u = o / kKK;
    const float* sl = slot + u * ipu * kKK + (o - u * kKK);
    float v = sl[0];
    for (int c = 1; c < ipu; ++c) v += sl[c * kKK];
    out[p * kKK + o] = v;
  }
}

// The fused kernel's ring is filled by bulk copies (TMA, cp.async.bulk),
// one thread issuing a stage's three spans, each completing on the
// buffer's mbarrier: stage 1's 16-byte copies cost every thread over a
// hundred instructions a stage, as much as its share of the products.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the producer's arrival, expecting `bytes` of copies on this phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Queue elements [e0, e0 + ne) of src (total_bytes in all) into dst from
// the 16-byte boundary at or below e0, as copy_span does: the whole
// 16-byte chunks inside the tensor by one bulk copy on bar (go = true;
// else only their bytes are returned, for the barrier's expected count),
// the tensor's last partial chunk, where the span reaches it, by plain
// byte copies, zero-filled.
template <typename T>
__device__ __forceinline__ unsigned bulk_span(const T* __restrict__ src,
                                              long long total_bytes,
                                              long long e0, long long ne,
                                              unsigned char* dst,
                                              unsigned long long* bar,
                                              bool go) {
  const long long a0 = (e0 * static_cast<long long>(sizeof(T))) & ~15LL;
  const long long end =
      ((e0 + ne) * static_cast<long long>(sizeof(T)) + 15) & ~15LL;
  const long long inside = total_bytes & ~15LL;
  const long long bulk_end = end < inside ? end : inside;
  const unsigned bytes =
      bulk_end > a0 ? static_cast<unsigned>(bulk_end - a0) : 0u;
  if (go) {
    const char* from = reinterpret_cast<const char*>(src);
    if (bytes > 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
          "l"(from + a0), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
    for (long long b = bulk_end > a0 ? bulk_end : a0; b < end; ++b) {
      dst[b - a0] = b < total_bytes ? from[b] : 0;
    }
  }
  return bytes;
}

// Stage j's corr span and, in whole mode, its positions' wy and wx spans
// into buf, completing on bar (one thread).
template <typename T>
__device__ __forceinline__ void issue_stage_bulk(const Plan& pl,
                                                 const T* __restrict__ wy,
                                                 const T* __restrict__ corr,
                                                 const T* __restrict__ wx,
                                                 long long j,
                                                 unsigned char* buf,
                                                 unsigned long long* bar) {
  const Span s = span_at(pl, j);
  const long long es = sizeof(T);
  const long long per = static_cast<long long>(kK) * pl.h2;
  const long long perx = static_cast<long long>(kK) * pl.w2;
  unsigned tx = 0;
#pragma unroll
  for (int go = 0; go < 2; ++go) {
    if (go) mbar_expect(bar, tx);
    tx = bulk_span(corr, pl.n * pl.h2 * static_cast<long long>(pl.w2) * es,
                   s.e0, s.ne, buf, bar, go);
    if (pl.whole) {
      tx += bulk_span(wy, pl.n * per * es, s.p * per, s.nu * per,
                      buf + pl.corr_bytes, bar, go);
      tx += bulk_span(wx, pl.n * perx * es, s.p * perx, s.nu * perx,
                      buf + pl.corr_bytes + pl.wy_bytes, bar, go);
    }
  }
}

// kWhole: whole mode (the plan's), bounded to kWholeBlocks blocks an SM
// (the stage ring's bytes in flight); rows mode is its own instantiation,
// so its shared t tile and reduce-scatter cost the whole-mode path no
// registers
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads, kWhole ? kWholeBlocks : 1)
    fused_kernel(const T* __restrict__ wy, const T* __restrict__ corr,
                 const T* __restrict__ wx, float* __restrict__ out, Plan pl) {
  using W = typename WyStage<T>::type;
  extern __shared__ __align__(16) unsigned char smem2[];
  W* swy = reinterpret_cast<W*>(smem2 + pl.swy_off);
  float* slots = reinterpret_cast<float*>(smem2 + pl.slot_off);
  float* ts = reinterpret_cast<float*>(smem2 + pl.ts_off);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem2 + pl.bar_off);
  const int slot_floats = pl.units * pl.ipu * kKK;
  const long long j0 = static_cast<long long>(blockIdx.x) * pl.spb;
  const int nj = static_cast<int>(
      pl.stages - j0 < pl.spb ? pl.stages - j0 : pl.spb);

  // kStages - 1 stages in flight before the first is consumed
  if (threadIdx.x == 0) {
    for (int b = 0; b < kStages; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && s < nj; ++s) {
      issue_stage_bulk(pl, wy, corr, wx, j0 + s, smem2 + s * pl.stage_bytes,
                       &bars[s]);
    }
  }
  __syncthreads();  // the barriers are set (and any tail bytes stored)
  // positions whose slots (buffer done_buf) wait to be summed
  long long done_p = 0;
  int done_nu = 0;
  int done_buf = 0;
  int next_buf = 0;
  for (int s = 0; s < nj; ++s) {
    // refill the buffer the previous iteration consumed (its readers passed
    // that iteration's closing barrier)
    if (threadIdx.x == 0 && s + kStages - 1 < nj) {
      const int b = (s + kStages - 1) % kStages;
      issue_stage_bulk(pl, wy, corr, wx, j0 + s + kStages - 1,
                       smem2 + b * pl.stage_bytes, &bars[b]);
    }
    const Span sp = span_at(pl, j0 + s);
    const unsigned char* buf = smem2 + (s % kStages) * pl.stage_bytes;
    // stage s is in shared memory (the buffer's (s / kStages)-th phase);
    // the slots and tiles the last iteration wrote are ordered by its
    // closing barrier
    mbar_wait(&bars[s % kStages], (s / kStages) & 1);
    if (done_nu > 0) {
      finalize(slots + done_buf * slot_floats, pl.ipu, done_p, done_nu, out);
      done_nu = 0;
    }
    float* slot = slots + next_buf * slot_floats;
    const T* cb = reinterpret_cast<const T*>(buf) + span_shift<T>(sp.e0);
    bool complete = true;
    if constexpr (kWhole) {
      const T* wraw =
          reinterpret_cast<const T*>(buf + pl.corr_bytes) +
          span_shift<T>(sp.p * kK * static_cast<long long>(pl.h2));
      const T* xraw =
          reinterpret_cast<const T*>(buf + pl.corr_bytes + pl.wy_bytes) +
          span_shift<T>(sp.p * kK * static_cast<long long>(pl.w2));
      if constexpr (sizeof(T) == 4) {
        stage_wy(wraw, pl, sp, swy);
        __syncthreads();
        fused_stage(pl, sp, cb, swy, xraw, slot);
      } else {
        fused_stage(pl, sp, cb, wraw, xraw, slot);
      }
    } else {
      // rows mode: the unit's t adds into the position's shared tile
      const T* wdev =
          wy + (sp.p * kK) * static_cast<long long>(pl.h2) + sp.h0;
      stage_wy(wdev, pl, sp, swy);
      __syncthreads();
      if constexpr (sizeof(T) == 4) {
        compute_stage(pl, sp, cb, swy, ts, sp.p);
      } else {
        compute_stage(pl, sp, cb, swy, pl.hp, ts, sp.p);
      }
      complete = sp.h0 + sp.rows == pl.h2;
      if (complete) {
        __syncthreads();  // the position's t is whole
        stage2_rows(pl, sp.p, ts, wx, slot);
      }
    }
    if (complete) {
      done_p = sp.p;
      done_nu = sp.nu;
      done_buf = next_buf;
      next_buf ^= 1;
    }
    __syncthreads();  // its buffers may be refilled; the slots are written
  }
  if (done_nu > 0) {
    finalize(slots + done_buf * slot_floats, pl.ipu, done_p, done_nu, out);
  }
}

template <typename T>
int launch_fused(const void* wy, const void* corr, const void* wx, void* out,
                 long long n, int k, int h2, int w2, void* stream) {
  if (k != kK || h2 < 1 || w2 < 1 ||
      ((reinterpret_cast<uintptr_t>(wy) | reinterpret_cast<uintptr_t>(corr) |
        reinterpret_cast<uintptr_t>(wx)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    int device = 0;
    int sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    Plan pl = make_plan<T>(n, h2, w2, 1, true);
    // segment mode has no fused form (a row wider than a stage)
    if (pl.spr > 1 || pl.smem > kMaxSharedBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = pl.whole ? fused_kernel<T, true> : fused_kernel<T, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    pl = make_plan<T>(n, h2, w2, blocks, true);
    const long long grid = (pl.stages + pl.spb - 1) / pl.spb;
    kernel<<<static_cast<unsigned int>(grid), kThreads, pl.smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wy), static_cast<const T*>(corr),
        static_cast<const T*>(wx), static_cast<float*>(out), pl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fused kernel's plan for H2 x W2 (host code, no launch): fields
// whole, units, upp, hc, ipu, gpi and shared-memory bytes, the values
// ops/lookup.py::fused_plan computes.
extern "C" int lookup_fused_plan(int h2, int w2, int bf16, int* fields) {
  if (h2 < 1 || w2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = bf16 ? make_plan<__nv_bfloat16>(1, h2, w2, 1, true)
                       : make_plan<float>(1, h2, w2, 1, true);
  if (pl.spr > 1) return static_cast<int>(cudaErrorInvalidValue);
  const int v[7] = {pl.whole, pl.units, pl.upp, pl.hc, pl.ipu, pl.gpi,
                    pl.smem};
  for (int i = 0; i < 7; ++i) fields[i] = v[i];
  return 0;
}

extern "C" int lookup_stage1_f32(const void* wy, const void* corr, void* out,
                                 long long n, int k, int h2, int w2,
                                 void* stream) {
  return launch_stage1<float>(wy, corr, out, n, k, h2, w2, stream);
}

extern "C" int lookup_stage1_bf16(const void* wy, const void* corr,
                                  void* out, long long n, int k, int h2,
                                  int w2, void* stream) {
  return launch_stage1<__nv_bfloat16>(wy, corr, out, n, k, h2, w2, stream);
}

extern "C" int lookup_fused_f32(const void* wy, const void* corr,
                                const void* wx, void* out, long long n, int k,
                                int h2, int w2, void* stream) {
  return launch_fused<float>(wy, corr, wx, out, n, k, h2, w2, stream);
}

extern "C" int lookup_fused_bf16(const void* wy, const void* corr,
                                 const void* wx, void* out, long long n,
                                 int k, int h2, int w2, void* stream) {
  return launch_fused<__nv_bfloat16>(wy, corr, wx, out, n, k, h2, w2,
                                     stream);
}

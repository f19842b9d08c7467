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
// the bytes over 3.35 TB/s; the fused kernel reads wx too and writes only
// K·K floats.
//
// Stage 1 is a streaming kernel. corr is the bulk of the bytes and the
// blocks of consecutive positions are contiguous in memory, so a block
// takes a run of positions and streams it through a ring of kStages
// shared-memory buffers with 16-byte asynchronous copies (cp.async.cg),
// kStages - 1 of them in flight while it computes on another. A stage is
// one contiguous span of corr, copied flat from its 16-byte-aligned start
// (a position's block of H2·W2 values starts at any element: 9,000 bytes
// at the probe's bf16 50x90, ragged shapes at 2-byte offsets), with the
// tail past the tensor's end zero-filled. A stage holds:
//   whole mode    up to kMaxUnits whole positions (H2·W2 values each fit
//                 kStageCap bytes; the probe's case: 2 bf16 / 1 f32), and
//                 after them the positions' wy (K·H2 values each, also
//                 contiguous), copied the same way;
//   rows mode     H2 rows in chunks of hc rows of one position (a position
//                 larger than kStageCap, e.g. 20x700 float32);
//   segment mode  one row in column segments (a row larger than kStageCap).
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
// t is written coalesced along w (float2 pairs where W2 is even).
//
// The fused kernel keeps PR 5's design: a block takes a few positions
// (ppb, chosen by the launcher so that ppb·W2 fills about three passes of
// its 256 threads); a thread owns one (position, column w) pair per pass
// and keeps K float32 accumulators. The rows of wy are staged in shared
// memory as float32, kHChunk rows at a time for every position of the
// block (a padded stride keeps two positions' rows in different banks);
// then each thread streams its column of corr down the chunk, one
// coalesced load a row, and adds K products with the wy values of that
// row. It rounds them to the inputs' dtype into a shared (ppb, K, W2)
// tile, stages wx beside it, and one thread per output (position, k, a)
// sums the W2 products from shared memory (row strides odd, so the K rows
// a warp reads fall in different banks); the (K, W2) intermediate never
// reaches device memory.
//
// Launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError(), or
// cudaErrorInvalidValue for K other than kK (radius 4, every shipped
// config's) or a fused tile larger than the card's shared memory. Stage 1
// needs wy and corr 16-byte aligned (the wrapper copies them otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 9;          // window rows (2 * radius + 1, radius 4)
constexpr int kThreads = 256;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // a block's limit on Hopper

// -- stage 1 ----------------------------------------------------------------

constexpr int kStages = 3;              // ring of stage buffers
constexpr int kStageCap = 24 * 1024;    // corr bytes a stage holds, at most
constexpr int kMaxUnits = 8;            // whole positions a stage, at most
constexpr int kWyCap = 16 * 1024;       // bytes of a stage's staged wy
constexpr int kWyPad = 12;              // floats a staged float32 wy row

// How a launch cuts corr into stages (host-computed, see make_plan).
struct Plan {
  long long n;       // positions
  int h2;
  int w2;
  int units;         // whole positions a stage (whole mode), else 1
  int upp;           // stages a position: 1 in whole mode
  int hc;            // rows a unit, at most
  int seg;           // columns a unit, at most (W2 unless segment mode)
  int spr;           // column segments a row (1 unless segment mode)
  long long stages;  // stages in all
  long long spb;     // stages a block
  int corr_bytes;    // bytes of a ring buffer's corr span (a multiple of 16)
  int stage_bytes;   // bytes of one ring buffer: corr, then (whole mode) wy
  int hp;            // bf16 path: the staged wy tile's row stride
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
  if (pl.upp == 1) {
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

// float32 stage: a thread owns one column of one unit and all K rows;
// each wy row is two float4 and a float broadcast to the unit's threads
__device__ __forceinline__ void compute_stage(const Plan& pl, const Span& s,
                                              const float* cb,
                                              const float* swy,
                                              float* __restrict__ out) {
  const long long pos_elems = static_cast<long long>(pl.h2) * pl.w2;
  const bool add = s.h0 > 0;
  for (int it = threadIdx.x; it < s.nu * s.cols; it += kThreads) {
    const int u = it / s.cols;
    const int w = it - u * s.cols;
    const float* col = cb + u * pos_elems + w;
    const float* wr = swy + u * pl.hc * kWyPad;
    float a[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = 0.f;
#pragma unroll 4
    for (int r = 0; r < s.rows; ++r) {
      const float c = col[r * pl.w2];
      const float4 w0 = *reinterpret_cast<const float4*>(wr + r * kWyPad);
      const float4 w1 =
          *reinterpret_cast<const float4*>(wr + r * kWyPad + 4);
      const float w8 = wr[r * kWyPad + 8];
      const float wv[kK] = {w0.x, w0.y, w0.z, w0.w, w1.x,
                            w1.y, w1.z, w1.w, w8};
#pragma unroll
      for (int k = 0; k < kK; ++k) a[k] = fmaf(wv[k], c, a[k]);
    }
    const long long o =
        (s.p + u) * kK * static_cast<long long>(pl.w2) + s.c0 + w;
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

constexpr int kTilesPerWarp = 3;  // 8-column tiles a warp item takes

// bf16 stage: a warp takes one unit and kTilesPerWarp 8-column tiles; for
// each 16-row k tile it loads wy's A fragment once and multiplies it with
// every column tile's B fragment. Fragment layouts (g = lane / 4,
// t = lane % 4): A rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9;
// B rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g; C rows g, g + 8, columns
// 2t, 2t + 1. Rows k >= 9 of A are zero, so only lane group g = 0 reads
// the second half (k = 8). wy's row k of unit u starts at
// wy[(u·K + k)·ws]; rows r >= rows read as zeros.
__device__ __forceinline__ void compute_stage(const Plan& pl, const Span& s,
                                              const __nv_bfloat16* cbp,
                                              const __nv_bfloat16* wyp,
                                              int ws,
                                              float* __restrict__ out) {
  const long long pos_elems = static_cast<long long>(pl.h2) * pl.w2;
  const unsigned short* cb = reinterpret_cast<const unsigned short*>(cbp);
  const unsigned short* wy = reinterpret_cast<const unsigned short*>(wyp);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (s.cols + 7) / 8;
  const int groups = (n_tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  const int k_tiles = (s.rows + 15) / 16;
  const bool add = s.h0 > 0;
  const bool pairs = (pl.w2 % 2) == 0;  // t's rows 8-byte aligned
  for (int it = warp; it < s.nu * groups; it += kWarps) {
    const int u = it / groups;
    const int n_first = (it - u * groups) * kTilesPerWarp;
    const unsigned short* cu = cb + u * pos_elems;
    const unsigned short* wg = wy + (u * kK + g) * ws;   // row k = g
    const unsigned short* w8 = wy + (u * kK + 8) * ws;   // row k = 8
    float acc[kTilesPerWarp][4];
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int h = kt * 16 + 2 * t;
      auto pair = [&](const unsigned short* row, int r) -> unsigned {
        const unsigned lo = r < s.rows ? row[r] : 0u;
        const unsigned hi = r + 1 < s.rows ? row[r + 1] : 0u;
        return lo | (hi << 16);
      };
      const unsigned a0 = pair(wg, h);
      const unsigned a2 = pair(wg, h + 8);
      const unsigned a1 = g == 0 ? pair(w8, h) : 0u;
      const unsigned a3 = g == 0 ? pair(w8, h + 8) : 0u;
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int w = (n_first + j) * 8 + g;
        if ((n_first + j) * 8 < s.cols) {
          const bool ok = w < s.cols;
          const unsigned short* c = cu + w;
          const unsigned v0 = ok && h < s.rows ? c[h * pl.w2] : 0u;
          const unsigned v1 = ok && h + 1 < s.rows ? c[(h + 1) * pl.w2] : 0u;
          const unsigned v8 = ok && h + 8 < s.rows ? c[(h + 8) * pl.w2] : 0u;
          const unsigned v9 = ok && h + 9 < s.rows ? c[(h + 9) * pl.w2] : 0u;
          mma_bf16(acc[j], a0, a1, a2, a3, v0 | (v1 << 16), v8 | (v9 << 16));
        }
      }
    }
    const long long o = (s.p + u) * kK * static_cast<long long>(pl.w2) + s.c0;
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
      if (pl.upp == 1) {
        stage_wy(wraw, pl, sp, swy);
      } else {
        stage_wy(wdev, pl, sp, swy);
      }
      __syncthreads();
      compute_stage(pl, sp, cb, swy, out);
    } else if (pl.upp == 1) {
      compute_stage(pl, sp, cb, wraw, pl.h2, out);  // the raw copy
    } else {
      stage_wy(wdev, pl, sp, swy);
      __syncthreads();
      compute_stage(pl, sp, cb, swy, pl.hp, out);
    }
    __syncthreads();  // its buffers may be refilled
  }
  cp_async_wait<0>();
}

// Cut N positions of H2 x W2 into stages (see the modes at the top) and
// spread the stages over one wave of blocks.
template <typename T>
Plan make_plan(long long n, int h2, int w2, int blocks) {
  const long long es = sizeof(T);
  const bool bf16 = sizeof(T) == 2;
  // bytes of staged wy a unit of r rows takes
  auto wy_bytes = [&](long long r) {
    return bf16 ? kK * (((r + 15) & ~15LL) + 8) * 2 : r * kWyPad * 4;
  };
  Plan pl = {};
  pl.n = n;
  pl.h2 = h2;
  pl.w2 = w2;
  const long long pos_bytes = static_cast<long long>(h2) * w2 * es;
  long long stage_elems;
  if (pos_bytes <= kStageCap && wy_bytes(h2) <= kWyCap) {
    long long u = kStageCap / pos_bytes;
    const long long uw = kWyCap / wy_bytes(h2);
    u = u < uw ? u : uw;
    pl.units = static_cast<int>(u < kMaxUnits ? u : kMaxUnits);
    pl.upp = 1;
    pl.hc = h2;
    pl.seg = w2;
    pl.spr = 1;
    pl.stages = (n + pl.units - 1) / pl.units;
    stage_elems = pl.units * static_cast<long long>(h2) * w2;
  } else if (w2 * es <= kStageCap) {
    long long hc = kStageCap / (w2 * es);
    while (hc > 1 && wy_bytes(hc) > kWyCap) hc /= 2;
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
  pl.stage_bytes =
      pl.corr_bytes +
      (pl.upp == 1
           ? static_cast<int>((pl.units * kK * h2 * es + 32 + 15) & ~15LL)
           : 0);
  pl.hp = ((pl.hc + 15) & ~15) + 8;
  // whole positions per block in rows and segment modes
  long long spb = (pl.stages + blocks - 1) / blocks;
  spb = (spb + pl.upp - 1) / pl.upp * pl.upp;
  pl.spb = spb < 1 ? 1 : spb;
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
    Plan pl = make_plan<T>(n, h2, w2, 1);
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
    pl = make_plan<T>(n, h2, w2, blocks);
    const long long grid = (pl.stages + pl.spb - 1) / pl.spb;
    stage1_kernel<T><<<static_cast<unsigned int>(grid), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wy), static_cast<const T*>(corr),
        static_cast<float*>(out), pl);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- fused ------------------------------------------------------------------

constexpr int kHChunk = 32;    // rows of wy staged at a time
constexpr int kMaxPositions = 16;  // positions a block, at most
// floats of one position's staged wy chunk; the +1 moves the next
// position's rows to other banks
constexpr int kWyStride = kK * kHChunk + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// t rounded to the inputs' dtype, kept as float32
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// odd row stride of the fused kernel's shared (K, W2) tiles
__host__ __device__ __forceinline__ int tile_stride(int w2) {
  return w2 | 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const T* __restrict__ wy, const T* __restrict__ corr,
                 const T* __restrict__ wx, float* __restrict__ out,
                 long long n, int h2, int w2, int ppb) {
  extern __shared__ float smem[];
  float* s_wy = smem;                     // (ppb, kWyStride)
  float* s_t = smem + ppb * kWyStride;    // (ppb, K, ws)
  const int ws = tile_stride(w2);
  float* s_wx = s_t + ppb * kK * ws;      // (ppb, K, ws)

  const long long p0 = static_cast<long long>(blockIdx.x) * ppb;
  const int np = static_cast<int>(n - p0 < ppb ? n - p0 : ppb);
  const int items = ppb * w2;

  // every thread runs the same passes, so the barriers below are uniform
  for (int item0 = 0; item0 < items; item0 += kThreads) {
    const int item = item0 + static_cast<int>(threadIdx.x);
    const int pl = item / w2;
    const int col = item - pl * w2;
    const bool active = item < np * w2;
    const T* ccol = corr + (p0 + pl) * h2 * static_cast<long long>(w2) + col;

    float acc[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) acc[k] = 0.f;

    for (int hc = 0; hc < h2; hc += kHChunk) {
      const int rows = h2 - hc < kHChunk ? h2 - hc : kHChunk;
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < np * kK * kHChunk; i += kThreads) {
        const int q = i / (kK * kHChunk);
        const int rem = i - q * (kK * kHChunk);
        const int k = rem / kHChunk;
        const int hh = rem - k * kHChunk;
        s_wy[q * kWyStride + rem] =
            hh < rows ? to_f32(wy[((p0 + q) * kK + k) * h2 + hc + hh]) : 0.f;
      }
      __syncthreads();
      if (active) {
        const float* sw = s_wy + pl * kWyStride;
#pragma unroll 4
        for (int hh = 0; hh < rows; ++hh) {
          const float c = to_f32(ccol[static_cast<long long>(hc + hh) * w2]);
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            acc[k] = fmaf(sw[k * kHChunk + hh], c, acc[k]);
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        s_t[(pl * kK + k) * ws + col] = round_as(acc[k], wy);
      }
    }
  }

  // wx of the block's positions is one contiguous run of np * K rows
  const T* wxb = wx + p0 * kK * w2;
  for (int i = threadIdx.x; i < np * kK * w2; i += kThreads) {
    const int row = i / w2;
    s_wx[row * ws + (i - row * w2)] = to_f32(wxb[i]);
  }
  __syncthreads();
  float* ob = out + p0 * kK * kK;
  for (int o = threadIdx.x; o < np * kK * kK; o += kThreads) {
    const int q = o / (kK * kK);
    const int k = (o / kK) % kK;
    const int a = o % kK;
    const float* tr = s_t + (q * kK + k) * ws;
    const float* xr = s_wx + (q * kK + a) * ws;
    float sum = 0.f;
    for (int w = 0; w < w2; ++w) sum = fmaf(tr[w], xr[w], sum);
    ob[o] = sum;
  }
}

// positions a block: about three passes of its threads, at most
// kMaxPositions, and as many as fit the shared memory
int positions_per_block(int w2) {
  int ppb = 3 * kThreads / w2;
  ppb = ppb < 1 ? 1 : (ppb > kMaxPositions ? kMaxPositions : ppb);
  const int per = (kWyStride + 2 * kK * tile_stride(w2)) * 4;
  while (ppb > 1 && ppb * per > 48 * 1024) --ppb;
  return ppb;
}

template <typename T>
int launch_fused(const void* wy, const void* corr, const void* wx, void* out,
                 long long n, int k, int h2, int w2, void* stream) {
  if (k != kK || h2 < 1 || w2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int ppb = positions_per_block(w2);
    const size_t smem = static_cast<size_t>(ppb) *
                        (kWyStride + 2 * kK * tile_stride(w2)) *
                        sizeof(float);
    if (smem > static_cast<size_t>(kMaxSharedBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks = (n + ppb - 1) / ppb;
    fused_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wy), static_cast<const T*>(corr),
        static_cast<const T*>(wx), static_cast<float*>(out), n, h2, w2, ppb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

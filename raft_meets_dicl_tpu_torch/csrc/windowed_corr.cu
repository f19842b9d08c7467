// windowed_corr: the raft/fs windowed correlation pyramid, forward and both
// backward halves (df1, df2), for Hopper (sm_90a).
//
// Replaces the TPU kernels of raft_meets_dicl_tpu/ops/pallas.py:
//   forward  _wcp_fwd_kernel / _wcp_fwd_band_kernel (launched by
//            _wcp_fwd_tpu, pallas.py:688, through _wcp and
//            windowed_corr_pyramid);
//   df1      _wcp_bwd_df1_kernel / _wcp_bwd_df1_band_kernel (_wcp_bwd_tpu,
//            pallas.py:769);
//   df2      _wcp_bwd_df2_kernel / _wcp_bwd_df2_band_kernel (_wcp_bwd_tpu,
//            pallas.py:793, one call per level).
//
// What the forward computes, per position p = (b, y, x) and level l < L,
// with K = 2R + 1 and T = K + 1 taps per axis:
//   centre (cx, cy) = coords[p] / 2^l, clamped to [-(R+1), W2_l + R] x
//   [-(R+1), H2_l + R] (a window wholly outside stays wholly outside:
//   exact zeros, no int overflow)
//   x0 = floor(cx) - R, y0 = floor(cy) - R, fx = cx - floor(cx), fy = ...
//   d[ty][tx] = <f1[p], f2_l[b, y0 + ty, x0 + tx]>   (0 outside f2_l)
//   t[dy][tx] = (1 - fy) * d[dy][tx] + fy * d[dy + 1][tx]       (y first)
//   out[p, l*K*K + dx*K + dy] = (1 - fx) * t[dy][dx] + fx * t[dy][dx + 1]
// i.e. the dot of f1[p] with f2_l bilinearly sampled at (cx + dx - R,
// cy + dy - R), zero padding, unnormalized; channels (level, dx, dy). f1
// and f2_l are float32 or bfloat16 (one dtype), accumulated in float32;
// out is float32.
//
// The backward takes dout = d(loss)/d(out), float32. Per position and
// level the transpose of both lerps gives the tap weights
//   wt[ty][tx] = sum over dx, dy of dout[p, l, dx, dy] wx(dx, tx) wy(dy, ty)
// (wx = 1 - fx where tx = dx, fx where tx = dx + 1; wy likewise), and
//   df1[p]                  = sum over l, taps of wt * f2_l[tap]
//   df2_l[b, tap] += wt * f1[p]        (over every position whose window
//                                       holds the tap)
// both float32 (the caller zeroes df2 and casts both to the inputs'
// dtype). Coordinates get no gradient.
//
// Bound. Per position and level the work is T^2 = 100 dots of length C:
// 2 * 100 * C operations, 51,200 at C = 256, against (f1 + coords + L*81
// outputs) bytes of the position's own plus each f2_l map read once. At
// C = 256 that is ~20 operations per byte moved, below the bf16 tensor
// cores' ridge (~295): the bfloat16 forms, whose products run on the
// tensor cores, are bound by the bytes; the float32 forms run on the
// float32 CUDA cores (67 TFLOP/s), where the operations bound (~33 us at
// 42,880 positions and one level).
//
// Tiles. The bfloat16 kernels take an 8x8 tile of positions of one image a
// block (the forward: one level a block, all levels in one launch; df1:
// every level in one block; df2: one launch a level). Phase A
// (tile_windows): a thread per position computes its window, and the
// block takes the bounding box of the tile's in-bounds taps. A tile whose
// box is at most kMaxBox pixels a side takes the tile path, which shares
// each staged f2 pixel among the windows that hold it; a wider box (a
// motion boundary, far-flung windows, whose windows share few of its
// pixels) keeps the per-position body for that tile and level.
// ops/windowed.py's tile_paths computes the same choice from the centres;
// path_counts, when not null, counts the tiles of each level per path:
// [tile path, per-position path, no in-bounds tap]. The band kernels of
// the TPU (one slab and one MXU contraction a chunk of positions, a
// per-position form where the chunk's windows spread) are the same idea.
//
// - Forward, bfloat16, tile path: the tile's f1 (64 x C, 256-channel
//   passes) is copied to shared memory with 16-byte cp.async, issued
//   before the windows are known, and loaded with ldmatrix into the warps'
//   registers as mma A fragments: warp w holds positions [16 (w % 4), +16)
//   (two tile rows) for every k step of the pass (64 registers). The box's
//   rows stream through a ring of 3 shared-memory stages (cp.async, 2 rows
//   in flight). Per row the two warps of a group find the span of columns
//   their windows reach there (two warp reductions), take alternate
//   8-pixel column tiles of it and multiply their positions by the row's
//   pixels on mma.sync m16n8k16 (bf16 in, f32 accumulate: the products
//   are exact, only the order of the sums changes); each position keeps
//   the dots that fall in its window in a shared table (100 a position,
//   one writer each). Dots of box pixels outside a window are redundant
//   work, cheap on the tensor cores. Then the two lerps, and the 81
//   outputs of the level contiguously.
// - df1, bfloat16, tile path: the transpose, df1_tile (64 x C) = W (64 x
//   box pixels) . F2_box, summed over rows and levels, on Hopper's
//   warpgroup MMA: each of the two warpgroups owns 128 channels of all 64
//   positions (wgmma.mma_async m64n128k16, the accumulators in registers
//   over every row and level). Per level the block copies the tile's dout
//   (81 values a position, cp.async, before the windows are known) and
//   turns it into the 100 tap weights of every position (a thread per
//   window row: the y lerp's transpose, then the x lerp's); the first box
//   rows' copies are already out. Per box row, over the 16-pixel k steps
//   that the tile's windows reach there, two wgmma read A from the row's
//   weights split into bf16 hi + lo matrices (the rest is at most 2^-16 of
//   a weight, so the sums keep float32-level accuracy; one rounding to
//   bfloat16 would not hold the bound) and B from the staged row read
//   transposed, while the block writes the next row's weights. Each
//   position owns its df1 row: no atomics; the rows go out coalesced
//   through shared memory. A non-finite f2 value in a box multiplies the
//   zero weights of the windows that do not hold it too (0 * inf = NaN),
//   so it reaches every df1 row of that tile, where the plain version
//   confines it to the windows that hold it.
// - Per-position bodies (wide boxes; the float32 forms): one warp a
//   position. Forward: a lane owns V consecutive channels per 32V-channel
//   chunk (V = 16 bytes of the dtype where C allows it); for a group of 32
//   taps each lane sums its channels' products in registers, then a
//   transpose reduction (31 shuffles for 32 sums) leaves tap g*32 + lane's
//   dot in that lane. df1: each lane sums weight * f2 tap over the taps for
//   its channels (no reduction across lanes); inside the df1 tile kernel
//   those sums reach the accumulators through shared memory.
// - float32 forms: TF32 would break their bounds, so the forward and df1
//   keep the per-position bodies with 8 consecutive positions a block and
//   all levels; with path_counts, the warp of each tile's first position
//   counts the tile as per-position or empty (their side limit is 0).
// - df2: one launch per level. The tile's tap weights are computed once
//   (dout read once), its f1 staged in shared memory, and on the tile path
//   each warp owns a row segment of the tile's box and sums every
//   window's contribution to it in registers; each df2 element the tile
//   touches then gets one float4 reduction (red.global.add.v4.f32) per
//   lane and 4 channels, not one atomic per tap and channel. A wider box
//   takes the direct path: one float4 reduction per tap.
// Out-of-bounds taps are neither read nor written. Launches go on the
// caller's stream, do not synchronise and allocate nothing; the C entry
// points return cudaGetLastError(), or cudaErrorInvalidValue for a radius
// other than kRadius (every shipped config's corr-radius), C not a
// multiple of 32, or a level count outside [1, kMaxLevels].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kRadius = 4;              // the window radius instantiated
constexpr int kK = 2 * kRadius + 1;     // window width (9)
constexpr int kT = kK + 1;              // taps per axis (10)
constexpr int kTaps = kT * kT;          // taps per window (100)
constexpr int kWin = kK * kK;           // outputs per level (81)
constexpr int kGroups = (kTaps + 31) / 32;
constexpr int kMaxLevels = 6;
constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 8;                  // positions a tile side
constexpr int kTilePos = kTile * kTile;   // positions a tile (64)
// every tile path: box sides at most (pixels; df2's row_mask holds this
// many box rows). A taller or wider box means windows spread over several
// window widths, which share few of its pixels (a motion boundary,
// far-flung windows): staging it for the tile saves little there
constexpr int kMaxBox = 48;

struct Levels {
  const void* f2[kMaxLevels];
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// top-left tap, bilinear fractions, and the in-bounds tap rows and
// columns (bit t set: tap row / column t lies inside f2_l)
struct Window {
  int x0;
  int y0;
  float fx;
  float fy;
  unsigned rows;
  unsigned cols;
};

__device__ __forceinline__ Window window_at(const float* __restrict__ coords,
                                            int64_t pos, int lvl, int h2,
                                            int w2) {
  const float scale = 1.0f / static_cast<float>(1 << lvl);  // exact
  float cx = __ldg(coords + 2 * pos) * scale;
  float cy = __ldg(coords + 2 * pos + 1) * scale;
  cx = fminf(fmaxf(cx, -(kRadius + 1.0f)), static_cast<float>(w2 + kRadius));
  cy = fminf(fmaxf(cy, -(kRadius + 1.0f)), static_cast<float>(h2 + kRadius));
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  Window win;
  win.x0 = static_cast<int>(x0f) - kRadius;
  win.y0 = static_cast<int>(y0f) - kRadius;
  win.fx = cx - x0f;
  win.fy = cy - y0f;
  win.rows = 0;
  win.cols = 0;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    if (win.y0 + t >= 0 && win.y0 + t < h2) win.rows |= 1u << t;
    if (win.x0 + t >= 0 && win.x0 + t < w2) win.cols |= 1u << t;
  }
  return win;
}

__device__ __forceinline__ bool tap_in(const Window& win, int ty, int tx) {
  return ((win.rows >> ty) & (win.cols >> tx) & 1u) != 0;
}

// V consecutive elements as float32 (V * sizeof(T) <= 16 bytes, aligned)
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = b.z;
    v[7] = b.w;
  } else if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    static_assert(V == 1, "float32 loads take 1, 2, 4 or 8 elements");
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float load_one(const float* p) { return __ldg(p); }

// a bfloat16 is the upper half of the float32 with the same bits
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ void unpack_bf16x2(unsigned u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    unpack_bf16x2(a.x, v);
    unpack_bf16x2(a.y, v + 2);
    unpack_bf16x2(a.z, v + 4);
    unpack_bf16x2(a.w, v + 6);
  } else if constexpr (V == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(a.x, v);
    unpack_bf16x2(a.y, v + 2);
  } else if constexpr (V == 2) {
    unpack_bf16x2(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  } else {
    static_assert(V == 1, "bfloat16 loads take 1, 2, 4 or 8 elements");
    v[0] = load_one(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One step of the transpose reduction: lanes with bit S clear keep sums
// [0, S), lanes with it set keep [S, 2S) (moved down to [0, S)), and each
// adds its partner's half.
template <int S>
__device__ __forceinline__ void transpose_step(float (&acc)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? acc[i] : acc[i + S];
    const float keep = upper ? acc[i + S] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// acc[i] in every lane -> acc[0] in lane l is the warp's sum of acc[l]
__device__ __forceinline__ void transpose_sum(float (&acc)[32], int lane) {
  transpose_step<16>(acc, lane);
  transpose_step<8>(acc, lane);
  transpose_step<4>(acc, lane);
  transpose_step<2>(acc, lane);
  transpose_step<1>(acc, lane);
}

// Tap t's weight at one level from the level's 81 dout values g of one
// position: the transpose of both lerps; 0 for taps outside f2_l.
__device__ __forceinline__ float tap_weight(const float* g, const Window& win,
                                           int t) {
  const int ty = t / kT;
  const int tx = t % kT;
  if (!tap_in(win, ty, tx)) return 0.0f;
  // x transpose for tap rows ty (as dy = ty) and ty - 1 (dy = ty - 1);
  // dout index dx * K + dy
  float gy0 = 0.0f;  // displacement row dy = ty
  float gy1 = 0.0f;  // displacement row dy = ty - 1
  if (ty < kK) {
    if (tx < kK) gy0 += (1.0f - win.fx) * g[tx * kK + ty];
    if (tx >= 1) gy0 += win.fx * g[(tx - 1) * kK + ty];
  }
  if (ty >= 1) {
    if (tx < kK) gy1 += (1.0f - win.fx) * g[tx * kK + ty - 1];
    if (tx >= 1) gy1 += win.fx * g[(tx - 1) * kK + ty - 1];
  }
  return (1.0f - win.fy) * gy0 + win.fy * gy1;
}

// Stage level l's 81 dout values of position pos in shared memory (g) and
// turn them into the 100 tap weights (wt; 0 for taps outside f2_l).
__device__ __forceinline__ void tap_weights(const float* __restrict__ dout,
                                            int64_t pos, int lvl,
                                            int n_levels, const Window& win,
                                            int lane, float* g, float* wt) {
  const float* src = dout + (pos * n_levels + lvl) * kWin;
  for (int o = lane; o < kWin; o += 32) g[o] = __ldg(src + o);
  __syncwarp();
  for (int t = lane; t < kTaps; t += 32) wt[t] = tap_weight(g, win, t);
  __syncwarp();
}

// output oi = dx * K + dy of a window from its 100 dots d: the two lerps,
// y first, then x
__device__ __forceinline__ float lerp_out(const float* d, const Window& win,
                                          int oi) {
  const int dx = oi / kK;
  const int dy = oi % kK;
  const float t0 = (1.0f - win.fy) * d[dy * kT + dx]
                   + win.fy * d[(dy + 1) * kT + dx];
  const float t1 = (1.0f - win.fy) * d[dy * kT + dx + 1]
                   + win.fy * d[(dy + 1) * kT + dx + 1];
  return (1.0f - win.fx) * t0 + win.fx * t1;
}

// The per-position forward body: the 100 dots of one position at one
// level, by a warp, into d (0 for taps outside f2_l).
template <typename T, int V>
__device__ __forceinline__ void position_dots(const T* __restrict__ f1p,
                                              const T* __restrict__ img,
                                              const Window& win, int w2,
                                              int c, int lane, float* d) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int c0 = lane * V; c0 < c; c0 += 32 * V) {
      float a[V];
      load_vec<V>(f1p + c0, a);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = g * 32 + i;
        if (t < kTaps) {
          const int ty = t / kT;
          const int tx = t % kT;
          if (tap_in(win, ty, tx)) {
            const int at = ((win.y0 + ty) * w2 + win.x0 + tx) * c + c0;
            float v[V];
            load_vec<V>(img + at, v);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[i] = fmaf(a[j], v[j], acc[i]);
          }
        }
      }
    }
    transpose_sum(acc, lane);
    if (g * 32 + lane < kTaps) d[g * 32 + lane] = acc[0];
  }
  __syncwarp();
}

// The per-position df1 body: acc[j] += the sum over the window's in-bounds
// taps of wt[tap] * channel c0 + j of the tap (one position, one level).
template <typename T, int V>
__device__ __forceinline__ void add_taps(const T* __restrict__ img,
                                         const Window& win, int w2, int c,
                                         const float* wt, int c0,
                                         float (&acc)[V]) {
#pragma unroll
  for (int ty = 0; ty < kT; ++ty) {
    if (!((win.rows >> ty) & 1u)) continue;
#pragma unroll
    for (int tx = 0; tx < kT; ++tx) {
      if (!((win.cols >> tx) & 1u)) continue;
      const float w = wt[ty * kT + tx];
      float v[V];
      load_vec<V>(img + ((win.y0 + ty) * w2 + win.x0 + tx) * c + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(w, v[j], acc[j]);
    }
  }
}

// -- tiles -------------------------------------------------------------------

// A block's tile: kTile x kTile positions of image bi from (ty0, tx0)
struct Tile {
  int64_t bi;
  int ty0;
  int tx0;
  int h;
  int w;
  // position q of the tile (row-major), or -1 outside the image
  __device__ __forceinline__ int64_t pos(int q) const {
    const int y = ty0 + q / kTile;
    const int x = tx0 + q % kTile;
    return y < h && x < w ? (bi * h + y) * w + x : -1;
  }
};

__device__ __forceinline__ Tile tile_at(int64_t index, int tiles_x,
                                        int tiles_per_image, int h, int w) {
  Tile t;
  t.bi = index / tiles_per_image;
  const int tile = static_cast<int>(index - t.bi * tiles_per_image);
  t.ty0 = (tile / tiles_x) * kTile;
  t.tx0 = (tile % tiles_x) * kTile;
  t.h = h;
  t.w = w;
  return t;
}

// Phase A of a tile at one level: a thread per position puts its window in
// wins (rows and cols 0 when it has no in-bounds tap); box gets the first
// and last in-bounds tap row and column of the tile (box[0] == INT_MAX:
// none). A barrier before and after.
__device__ __forceinline__ void tile_windows(const float* __restrict__ coords,
                                             const Tile& tile, int lvl,
                                             int h2, int w2, Window* wins,
                                             int* box) {
  const int tid = threadIdx.x;
  __syncthreads();  // the last readers of wins and box are done
  if (tid < 4) box[tid] = tid % 2 ? INT_MIN : INT_MAX;
  __syncthreads();
  if (tid < kTilePos) {
    const int64_t pos = tile.pos(tid);
    Window win = {};
    if (pos >= 0) win = window_at(coords, pos, lvl, h2, w2);
    if (!(win.rows && win.cols)) {
      win.rows = 0;
      win.cols = 0;
    }
    wins[tid] = win;
    if (win.rows) {
      const int top = win.y0 + __ffs(win.rows) - 1;
      const int bottom = win.y0 + 31 - __clz(win.rows);
      const int left = win.x0 + __ffs(win.cols) - 1;
      const int right = win.x0 + 31 - __clz(win.cols);
      atomicMin(&box[0], top);
      atomicMax(&box[1], bottom);
      atomicMin(&box[2], left);
      atomicMax(&box[3], right);
    }
  }
  __syncthreads();
}

// dout's 81 values at level lvl of every position of the tile with an
// in-bounds tap into g (kTilePos x kWin floats; zeros for the others),
// every load in flight before the first store (a block of kN threads)
template <int kN>
__device__ __forceinline__ void stage_dout(const float* __restrict__ dout,
                                           const Tile& tile, int lvl,
                                           int n_levels, const Window* wins,
                                           float* g) {
  constexpr int kPer = (kTilePos * kWin + kN - 1) / kN;
  const int tid = threadIdx.x;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kN;
    const int q = i / kWin;
    v[j] = i < kTilePos * kWin && wins[q].rows
               ? __ldg(dout + (tile.pos(q) * n_levels + lvl) * kWin + i
                       - q * kWin)
               : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (tid + j * kN < kTilePos * kWin) g[tid + j * kN] = v[j];
  }
}

// The tap weights of every position of a tile at one level, wt[q][ty][tx]
// (0 for taps outside f2_l), from dout's 81 values of each position
// staged in g (stage_dout): a thread per (position, tap row); the y lerp's
// transpose first (one value per dout column), then the x lerp's.
__device__ __forceinline__ void tile_tap_weights(const Window* wins,
                                                 const float* g, float* wt,
                                                 int threads) {
  for (int i = threadIdx.x; i < kTilePos * kT; i += threads) {
    const int q = i / kT;
    const int ty = i - q * kT;
    const Window& win = wins[q];
    float* row = wt + q * kTaps + ty * kT;
    if (!((win.rows >> ty) & 1u)) {
#pragma unroll
      for (int tx = 0; tx < kT; ++tx) row[tx] = 0.0f;
      continue;
    }
    const float* gq = g + q * kWin;
    // y[k]: dout column k (dx = k) transposed through the y lerp at tap
    // row ty (dy = ty with weight 1 - fy, dy = ty - 1 with fy)
    float y[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      y[k] = (ty < kK ? (1.0f - win.fy) * gq[k * kK + ty] : 0.0f)
             + (ty >= 1 ? win.fy * gq[k * kK + ty - 1] : 0.0f);
    }
#pragma unroll
    for (int tx = 0; tx < kT; ++tx) {
      const float v = (tx < kK ? (1.0f - win.fx) * y[tx] : 0.0f)
                      + (tx >= 1 ? win.fx * y[tx - 1] : 0.0f);
      row[tx] = (win.cols >> tx) & 1u ? v : 0.0f;
    }
  }
}

// path: 0 tile path, 1 per-position (direct) path, 2 no in-bounds tap
__device__ __forceinline__ void count_path(int* path_counts, int lvl,
                                           int path) {
  if (path_counts != nullptr && threadIdx.x == 0) {
    atomicAdd(path_counts + 3 * lvl + path, 1);
  }
}

// float32 forms: the warp of a tile's first position counts the tile at
// every level, as per-position or (no window of the tile has an in-bounds
// tap) empty
__device__ void count_position_tile(const float* __restrict__ coords,
                                    const Levels& lv, int n_levels,
                                    int64_t pos, int h, int w, int lane,
                                    int* path_counts) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t bi = pos / hw;
  const int rem = static_cast<int>(pos - bi * hw);
  const int y = rem / w;
  const int x = rem - y * w;
  if (y % kTile != 0 || x % kTile != 0) return;
  const Tile tile = {bi, y, x, h, w};
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    bool live = false;
    for (int q = lane; q < kTilePos; q += 32) {
      const int64_t p = tile.pos(q);
      if (p >= 0) {
        const Window win = window_at(coords, p, lvl, lv.h2[lvl], lv.w2[lvl]);
        live = live || (win.rows && win.cols);
      }
    }
    const bool any = __any_sync(kFull, live);
    if (lane == 0) atomicAdd(path_counts + 3 * lvl + (any ? 1 : 2), 1);
  }
}

// -- float32 forms: the per-position kernels ---------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wcp_fwd_kernel(const T* __restrict__ f1, Levels lv, int n_levels,
               const float* __restrict__ coords, float* __restrict__ out,
               int64_t positions, int h, int w, int c, int* path_counts) {
  __shared__ float dots[kWarps][kGroups * 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pos >= positions) return;
  if (path_counts != nullptr) {
    count_position_tile(coords, lv, n_levels, pos, h, w, lane, path_counts);
  }
  const int64_t bi = pos / (static_cast<int64_t>(h) * w);
  const T* f1p = f1 + pos * c;
  float* o = out + pos * n_levels * kWin;
  float* d = dots[warp];

  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int h2 = lv.h2[lvl];
    const int w2 = lv.w2[lvl];
    const Window win = window_at(coords, pos, lvl, h2, w2);
    const T* img = static_cast<const T*>(lv.f2[lvl])
                   + bi * h2 * static_cast<int64_t>(w2) * c;
    position_dots<T, V>(f1p, img, win, w2, c, lane, d);
    for (int oi = lane; oi < kWin; oi += 32) {
      o[lvl * kWin + oi] = lerp_out(d, win, oi);
    }
    __syncwarp();
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wcp_df1_kernel(const float* __restrict__ dout, Levels lv, int n_levels,
               const float* __restrict__ coords, float* __restrict__ df1,
               int64_t positions, int h, int w, int c, int* path_counts) {
  __shared__ float weights[kWarps][kMaxLevels][kTaps];
  __shared__ float staged[kWarps][kWin];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pos >= positions) return;
  if (path_counts != nullptr) {
    count_position_tile(coords, lv, n_levels, pos, h, w, lane, path_counts);
  }
  const int64_t bi = pos / (static_cast<int64_t>(h) * w);

  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const Window win = window_at(coords, pos, lvl, lv.h2[lvl], lv.w2[lvl]);
    tap_weights(dout, pos, lvl, n_levels, win, lane, staged[warp],
                weights[warp][lvl]);
  }

  for (int c0 = lane * V; c0 < c; c0 += 32 * V) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int lvl = 0; lvl < n_levels; ++lvl) {
      const int h2 = lv.h2[lvl];
      const int w2 = lv.w2[lvl];
      const Window win = window_at(coords, pos, lvl, h2, w2);
      const T* img = static_cast<const T*>(lv.f2[lvl])
                     + bi * h2 * static_cast<int64_t>(w2) * c;
      add_taps<T, V>(img, win, w2, c, weights[warp][lvl], c0, acc);
    }
    store_vec<V>(df1 + pos * c + c0, acc);
  }
}

// -- bfloat16 forward and df1: the tile paths --------------------------------

// 256-channel passes; box rows through a ring of 3 stages (forward) or 2
// (df1, whose weight matrices take the rest of the room): 2 blocks an SM
constexpr int kFwdChunk = 256;
constexpr int kFwdStages = 3;
constexpr int kDf1Chunk = 256;
constexpr int kDf1Stages = 2;
// The forward's staged rows (a box row's pixels, the tile's positions) are
// padded by 16 bytes: row p starts at p * 16 (nch + 1) for nch 16-byte
// chunks, so the same chunk of 8 consecutive rows falls in 8 different
// 4-bank groups and an 8-row ldmatrix reads each bank once.
constexpr int kFwdStageBytes = kMaxBox * 16 * (kFwdChunk / 8 + 1);
// df1's staged box rows are wgmma operands: 8 pixels x 8 channels (16
// bytes a pixel) make a core matrix of 128 contiguous bytes; core matrices
// follow each other kCm bytes apart along the channels (144, not 128, so
// that the 8 chunks of one pixel fall in 8 different 4-bank groups), and
// nch of them make a group of 8 pixels
constexpr int kCm = 144;
constexpr int kDf1StageBytes = kMaxBox / 8 * (kDf1Chunk / 8) * kCm;
constexpr int kFwdRing = kFwdStages * kFwdStageBytes;
constexpr int kDf1Ring = kDf1Stages * kDf1StageBytes;
// the forward's dots or df1's tap weights, 100 a position (float32)
constexpr int kTableBytes = kTilePos * kTaps * 4;
// df1's A operands: a box row's weights of every position as bf16 hi and
// lo matrices, K-major core matrices of 8 positions x 8 pixels (kWGroup
// bytes per 8 positions), for two rows (the one in use and the next);
// they follow the ring, then the tap weights
constexpr int kWGroup = kMaxBox / 8 * 128;
constexpr int kWBytes = kTilePos / 8 * kWGroup;
constexpr int kFwdSmem = kFwdRing + kTableBytes;
constexpr int kDf1Smem = kDf1Ring + 4 * kWBytes + kTableBytes;
// floats a row of df1's position-by-channel buffer (the room of the ring
// and the weight rows): a level's per-position sums, then the result
constexpr int kBufStride = kDf1Chunk + 8;
static_assert(kMaxBox % 16 == 0, "df1 reads box rows 16 pixels a step");
static_assert(kTilePos * 4 == kThreads, "df1 builds a position's weights "
              "in 4 parts");
static_assert(kTilePos * 16 * (kFwdChunk / 8 + 1) <= kFwdRing,
              "f1 fits the ring");
static_assert(kTilePos * kWin * 4 <= 4 * kWBytes, "dout fits the weight rows");
static_assert(kTilePos * kBufStride * 4 <= kDf1Ring + 4 * kWBytes,
              "buffer fits the ring and the weight rows");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes (ok false: src is not
// read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from src to shared dst (through L1)
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b on m16n8k16, bf16 in, f32 accumulate. Fragments (g = lane /
// 4, t = lane % 4): a rows g and g + 8, columns 2t, 2t + 1, 2t + 8,
// 2t + 9 (a[0] = (g, 2t..), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
// a[3] = (g + 8, 2t + 8..)); b column g, rows 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1); d rows g (d[0], d[1]) and g + 8 (d[2], d[3]),
// columns 2t, 2t + 1. The lower 16 bits hold the lower index.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bfloat16 pairs: hi = x rounded to bfloat16, lo = x - hi
// rounded (x - hi - lo is at most 2^-16 |x|)
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi,
                                             unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Of the box columns [0, bw), the span that the windows of a warp's 16
// positions holding box row r reach: xa, xb are the lane's two positions'
// first tap columns relative to the box, tya, tyb their window rows at r
// (out of [0, kT): the window does not hold row r). lo > hi: none.
__device__ __forceinline__ void row_reach(int tya, int tyb, int xa, int xb,
                                          int bw, int& lo, int& hi) {
  const bool ra = static_cast<unsigned>(tya) < static_cast<unsigned>(kT);
  const bool rb = static_cast<unsigned>(tyb) < static_cast<unsigned>(kT);
  int l = ra ? xa : INT_MAX;
  int m = ra ? xa : INT_MIN;
  if (rb) {
    l = min(l, xb);
    m = max(m, xb);
  }
  l = __reduce_min_sync(kFull, l);
  m = __reduce_max_sync(kFull, m);
  lo = l == INT_MAX ? 1 : max(l, 0);
  hi = l == INT_MAX ? 0 : min(m + kT - 1, bw - 1);
}

// Queue the copies of pixels [0, n) of one box row, nch 16-byte chunks
// each, into dst (padded rows of stride bytes): warp w copies pixels w,
// w + 8, ..., its lanes the pixel's chunks (contiguous in device memory).
// src points at pixel 0's first channel of the pass; pixels are c apart.
__device__ __forceinline__ void stage_row(const __nv_bfloat16* __restrict__ src,
                                          int c, int n, int nch, int stride,
                                          unsigned dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int p = warp; p < n; p += kWarps) {
    for (int ch = lane; ch < nch; ch += 32) {
      cp_async16(dst + p * stride + ch * 16, src + p * c + ch * 8, true);
    }
  }
}

// The bfloat16 forward, one (level, tile) a block. Tile path (box sides
// <= kMaxBox): per 256-channel pass, warp w holds the A fragments of
// positions [16 (w % 4), +16) (two tile rows) for every k step of the
// pass (64 registers), and per box row the two warps of a group take
// alternate 8-pixel column tiles of the span that the group's windows
// reach there; each position keeps the dots that fall in its window in
// dots[q][t] (position q's dot at tap t; one writer each). Otherwise each
// warp runs the per-position body for 8 positions. Then a thread per
// (position, output) applies the two lerps.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
wcp_fwd_tile_kernel(const __nv_bfloat16* __restrict__ f1, Levels lv,
                    int n_levels, const float* __restrict__ coords,
                    float* __restrict__ out, int h, int w, int c, int tiles_x,
                    int tiles_per_image, int64_t tiles, int* path_counts) {
  constexpr int kStages = kFwdStages;
  constexpr int kJ = kMaxBox / 16;   // column tiles a warp, at most
  extern __shared__ __align__(128) unsigned char smem[];
  float* dots = reinterpret_cast<float*>(smem + kFwdRing);
  __shared__ Window wins[kTilePos];
  __shared__ int box[4];
  const unsigned ring = smem_u32(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lvl = static_cast<int>(blockIdx.x / tiles);
  const Tile tile = tile_at(blockIdx.x - lvl * tiles, tiles_x,
                            tiles_per_image, h, w);
  const int h2 = lv.h2[lvl];
  const int w2 = lv.w2[lvl];
  const __nv_bfloat16* img = static_cast<const __nv_bfloat16*>(lv.f2[lvl])
                             + tile.bi * h2 * static_cast<int64_t>(w2) * c;

  // the tile's f1 of a pass into the ring (padded rows; zeros outside the
  // image); the first pass goes out before the windows are known
  auto stage_f1 = [&](int c0, int nch) {
    const int stride = 16 * (nch + 1);
    for (int q = warp; q < kTilePos; q += kWarps) {
      const int64_t pos = tile.pos(q);
      for (int ch = lane; ch < nch; ch += 32) {
        cp_async16(ring + q * stride + ch * 16,
                   f1 + (pos >= 0 ? pos * c + c0 + ch * 8 : 0), pos >= 0);
      }
    }
    cp_async_commit();
  };
  stage_f1(0, (c < kFwdChunk ? c : kFwdChunk) / 8);

  tile_windows(coords, tile, lvl, h2, w2, wins, box);
  const int by0 = box[0];
  const int bx0 = box[2];
  const bool any = by0 != INT_MAX;
  const int bh = any ? box[1] - by0 + 1 : 0;
  const int bw = any ? box[3] - bx0 + 1 : 0;
  const bool tile_path = any && bh <= kMaxBox && bw <= kMaxBox;
  count_path(path_counts, lvl, tile_path ? 0 : any ? 1 : 2);

  if (!any || tile_path) {
    for (int i = tid; i < kTilePos * kTaps; i += kThreads) dots[i] = 0.0f;
  }
  if (!tile_path) cp_async_wait<0>();   // the ring's f1 is not used
  if (tile_path) {
    const int mg = warp % 4;
    const int half = warp / 4;
    const int g = lane / 4;
    const int t = lane % 4;
    const int qa = mg * 16 + g;  // the lane's accumulator rows g, g + 8
    const int qb = qa + 8;
    // the two positions' first tap row and column relative to the box
    // (far above it without an in-bounds tap)
    const int ya = wins[qa].rows ? wins[qa].y0 - by0 : -(1 << 20);
    const int yb = wins[qb].rows ? wins[qb].y0 - by0 : -(1 << 20);
    const int xa = wins[qa].x0 - bx0;
    const int xb = wins[qb].x0 - bx0;
    for (int c0 = 0; c0 < c; c0 += kFwdChunk) {
      const int gc = c - c0 < kFwdChunk ? c - c0 : kFwdChunk;
      const int nch = gc / 8;
      const int stride = 16 * (nch + 1);
      const int kn = gc / 16;          // k steps (even: C % 32 == 0)
      if (c0 > 0) {
        __syncthreads();  // the last pass's reads of the ring are done
        stage_f1(c0, nch);
      }
      cp_async_wait<0>();
      __syncthreads();
      unsigned a[kFwdChunk / 16][4];
      const unsigned lane_a =
          ring + (mg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride
          + (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < kFwdChunk / 16; ++ks) {
        if (ks < kn) ldsm_x4(lane_a + ks * 32, a[ks]);
      }
      __syncthreads();  // f1 is in registers: the ring is free

      const __nv_bfloat16* src = img + (by0 * static_cast<int64_t>(w2) + bx0)
                                 * c + c0;
      const int64_t row_elems = static_cast<int64_t>(w2) * c;
      auto stage = [&](int row) {
        stage_row(src + row * row_elems, c, bw, nch, stride,
                  ring + (row % kStages) * kFwdStageBytes);
      };
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < bh) stage(s);
        cp_async_commit();
      }
      // B rows: pixel 8 j + lane % 8, chunks 2 ks + lane / 8
      const unsigned lane_b = (lane & 7) * stride + (lane >> 3) * 16;
      for (int r = 0; r < bh; ++r) {
        cp_async_wait<kStages - 2>();   // row r has landed
        __syncthreads();  // ... for every thread; row r - 1 is read
        if (r + kStages - 1 < bh) stage(r + kStages - 1);
        cp_async_commit();
        const int tya = r - ya;
        const int tyb = r - yb;
        int lo;
        int hi;
        row_reach(tya, tyb, xa, xb, bw, lo, hi);
        if (lo > hi) continue;  // no window of the group holds row r
        // this warp's column tiles: j0, j0 + 2, ... up to hi / 8
        const int j0 = lo / 8 + half;
        const int jn = hi / 8;

        const unsigned base = ring + (r % kStages) * kFwdStageBytes + lane_b
                              + j0 * 8 * stride;
        float acc[kJ][4];
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        }
#pragma unroll
        for (int ks = 0; ks < kFwdChunk / 16; ks += 2) {
          if (ks < kn) {
#pragma unroll
            for (int i = 0; i < kJ; ++i) {
              if (j0 + 2 * i <= jn) {
                unsigned b[4];
                ldsm_x4(base + i * 16 * stride + ks * 32, b);
                mma_bf16(acc[i], a[ks], b[0], b[1]);
                mma_bf16(acc[i], a[ks + 1], b[2], b[3]);
              }
            }
          }
        }
        // each position keeps the dots of this row that fall in its window
        // (box columns are in-bounds: a window's taps there are its
        // in-bounds taps)
        const bool ra = static_cast<unsigned>(tya) < static_cast<unsigned>(kT);
        const bool rb = static_cast<unsigned>(tyb) < static_cast<unsigned>(kT);
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
          if (j0 + 2 * i > jn) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * (j0 + 2 * i) + 2 * t + e;
            const unsigned txa = static_cast<unsigned>(col - xa);
            const unsigned txb = static_cast<unsigned>(col - xb);
            if (col < bw && ra && txa < static_cast<unsigned>(kT)) {
              dots[qa * kTaps + tya * kT + txa] += acc[i][e];
            }
            if (col < bw && rb && txb < static_cast<unsigned>(kT)) {
              dots[qb * kTaps + tyb * kT + txb] += acc[i][2 + e];
            }
          }
        }
      }
    }
  } else if (any) {
    for (int q = warp; q < kTilePos; q += kWarps) {
      const int64_t pos = tile.pos(q);
      if (pos >= 0) {
        position_dots<__nv_bfloat16, V>(f1 + pos * c, img, wins[q], w2, c,
                                        lane, dots + q * kTaps);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTilePos * kWin; i += kThreads) {
    const int q = i / kWin;
    const int64_t pos = tile.pos(q);
    if (pos >= 0) {
      out[(pos * n_levels + lvl) * kWin + i - q * kWin] =
          lerp_out(dots + q * kTaps, wins[q], i - q * kWin);
    }
  }
}

// A wgmma matrix descriptor (no swizzle): start address, and the byte
// strides between 8x16-byte core matrices along K (lbo) and along M or N
// (sbo)
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32;
}

// this thread's shared-memory writes (cp.async copies that have landed,
// stores) made visible to wgmma's operand reads (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// A thread's share of a box row's copies into df1's staged layout: pixel
// p's chunk ch at (p / 8) * nch * kCm + ch * kCm + (p % 8) * 16. A warp
// instruction takes 4 pixels x 8 chunks (128 contiguous bytes, a whole
// line, of each pixel; 8 pixels x 4 chunks where nch is not a multiple of
// 8). Where the warps' chunk groups divide the block's warps, each thread
// keeps one chunk and walks the pixels 8 apart (set up once per pass);
// otherwise it recomputes its items.
struct RowCopy {
  int nch;
  bool fixed;     // one chunk a thread, pixels step apart
  int p;          // fixed: the first pixel
  int step;       // fixed: pixels between two of the thread's copies
  int src;        // fixed: element offset of the first copy
  unsigned dst;   // fixed: byte offset of the first copy
};

__device__ __forceinline__ RowCopy row_copy(int nch, int c, int threads) {
  const int kc = nch % 8 == 0 ? 8 : 4;   // chunks a pixel, a lane each
  const int per = 32 / kc;               // pixels a warp instruction
  const int octs = nch / kc;
  const int warps = threads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  RowCopy rc;
  rc.nch = nch;
  rc.step = warps / octs * per;
  rc.fixed = warps % octs == 0 && rc.step % 8 == 0;
  const int ch = kc * (warp % octs) + lane % kc;
  rc.p = warp / octs * per + lane / kc;
  rc.src = rc.p * c + ch * 8;
  rc.dst = (rc.p / 8) * nch * kCm + ch * kCm + (rc.p % 8) * 16;
  return rc;
}

// Queue the copies of pixels [0, n) of one box row (c elements apart from
// src, the pass's nch chunks each) into dst
__device__ __forceinline__ void stage_row_cm(
    const RowCopy& rc, const __nv_bfloat16* __restrict__ src, int c, int n,
    unsigned dst, int threads) {
  const int nch = rc.nch;
  if (rc.fixed) {
    const unsigned dstep = rc.step / 8 * nch * kCm;
    const int sstep = rc.step * c;
    unsigned d = dst + rc.dst;
    const __nv_bfloat16* s = src + rc.src;
    for (int p = rc.p; p < n; p += rc.step, d += dstep, s += sstep) {
      cp_async16(d, s, true);
    }
    return;
  }
  const int kc = nch % 8 == 0 ? 8 : 4;
  const int per = 32 / kc;
  const int octs = nch / kc;
  const int items = (n + per - 1) / per * octs * 32;
  for (int it = threadIdx.x; it < items; it += threads) {
    const int l = it % 32;
    const int grp = it / 32;
    const int pq = grp / octs;
    const int ch = kc * (grp - pq * octs) + l % kc;
    const int p = pq * per + l / kc;
    if (p < n) {
      cp_async16(dst + (p / 8) * nch * kCm + ch * kCm + (p % 8) * 16,
                 src + static_cast<int64_t>(p) * c + ch * 8, true);
    }
  }
}

// d (64 x 128, f32; 64 values a thread) += a . b for one k step of 16
// pixels: a the K-major descriptor of 64 positions x 16 pixels, b the
// MN-major (transposed) descriptor of 16 pixels x 128 channels
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// df1's A operand for box row r: every position's weights at the row's
// pixels [0, np) (0 where its window does not reach), split into bf16 hi
// and lo matrices in the K-major core-matrix layout (position q, pixel p
// at (q / 8) * kWGroup + (p / 8) * 128 + (q % 8) * 16 + (p % 8) * 2). A
// thread takes 12 pixels of one position.
__device__ __forceinline__ void build_weights(const Window* wins,
                                              const float* wt, int r, int by0,
                                              int bx0, int np,
                                              unsigned char* whi,
                                              unsigned char* wlo) {
  constexpr int kPart = kMaxBox / 4;
  const int q = threadIdx.x / 4;
  const int p0 = (threadIdx.x % 4) * kPart;
  if (p0 >= np) return;
  const Window& win = wins[q];
  const int ty = by0 + r - win.y0;
  const int x = win.x0 - bx0;
  const bool held = win.rows && ty >= 0 && ty < kT;
  const float* row = wt + q * kTaps + (held ? ty * kT : 0);
  const int at = (q / 8) * kWGroup + (q % 8) * 16;
  if (!held || p0 + kPart <= x || p0 >= x + kT) {   // no tap of the window
#pragma unroll
    for (int i = 0; i < kPart; i += 2) {
      const int o = at + ((p0 + i) / 8) * 128 + ((p0 + i) % 8) * 2;
      *reinterpret_cast<unsigned*>(whi + o) = 0u;
      *reinterpret_cast<unsigned*>(wlo + o) = 0u;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPart; i += 2) {
    const int p = p0 + i;
    const unsigned t0 = static_cast<unsigned>(p - x);
    const unsigned t1 = t0 + 1;
    const float v0 = held && t0 < static_cast<unsigned>(kT) ? row[t0] : 0.0f;
    const float v1 = held && t1 < static_cast<unsigned>(kT) ? row[t1] : 0.0f;
    unsigned hi;
    unsigned lo;
    split_bf16x2(v0, v1, hi, lo);
    const int o = at + (p / 8) * 128 + (p % 8) * 2;
    *reinterpret_cast<unsigned*>(whi + o) = hi;
    *reinterpret_cast<unsigned*>(wlo + o) = lo;
  }
}

// The bfloat16 df1, one tile a block of two warpgroups, every level. Per
// 256-channel pass, warpgroup wg accumulates all 64 positions x channels
// [128 wg, +128) of the pass in registers (64 a thread: the wgmma
// m64n128 accumulators) over every level. Per level: the tile's windows
// and box, its tap weights (wt), then the tile path (box sides <=
// kMaxBox): per box row, over the 16-pixel k steps that the tile's
// windows reach there, two wgmma.mma_async (hi and lo weights) with A
// from the weight matrices and B the staged row read transposed, while
// the block writes the next row's weights (build_weights); or the
// per-position body, whose sums reach the accumulators through buf.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
wcp_df1_tile_kernel(const float* __restrict__ dout, Levels lv, int n_levels,
                    const float* __restrict__ coords, float* __restrict__ df1,
                    int h, int w, int c, int tiles_x, int tiles_per_image,
                    int* path_counts) {
  constexpr int kStages = kDf1Stages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);   // ring and weight rows
  // hi and lo weights of two box rows: [row & 1][hi, lo]
  unsigned char* wrows = smem + kDf1Ring;
  float* wt = reinterpret_cast<float*>(smem + kDf1Ring + 4 * kWBytes);
  __shared__ Window wins[kTilePos];
  __shared__ int box[4];
  __shared__ int rlo[kMaxBox];   // per box row: the first and last column
  __shared__ int rhi[kMaxBox];   // that a window holding it reaches
  const unsigned ring = smem_u32(smem);
  const unsigned wring = smem_u32(wrows);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int qa = (warp % 4) * 16 + g;  // the lane's accumulator rows
  const int qb = qa + 8;
  const Tile tile = tile_at(blockIdx.x, tiles_x, tiles_per_image, h, w);

  for (int c0 = 0; c0 < c; c0 += kDf1Chunk) {
    const int gc = c - c0 < kDf1Chunk ? c - c0 : kDf1Chunk;
    const int nch = gc / 8;
    const bool active = 128 * wg < gc;   // the warpgroup has channels
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;

    for (int lvl = 0; lvl < n_levels; ++lvl) {
      const int h2 = lv.h2[lvl];
      const int w2 = lv.w2[lvl];
      const __nv_bfloat16* img =
          static_cast<const __nv_bfloat16*>(lv.f2[lvl])
          + tile.bi * h2 * static_cast<int64_t>(w2) * c;
      // dout's 81 values of each position of the tile, staged in the room
      // of the weight rows (the ring is taking rows) before the windows
      // are known
      float* gd = reinterpret_cast<float*>(wrows);
      __syncthreads();  // the last level's reads of the weight rows are done
      for (int i = tid; i < kTilePos * kWin; i += kThreads) {
        const int q = i / kWin;
        const int64_t pos = tile.pos(q);
        if (pos >= 0) {
          cp_async4(wring + 4 * i,
                    dout + (pos * n_levels + lvl) * kWin + i - q * kWin);
        }
      }
      cp_async_commit();
      tile_windows(coords, tile, lvl, h2, w2, wins, box);
      const int by0 = box[0];
      const int bx0 = box[2];
      const bool any = by0 != INT_MAX;
      const int bh = any ? box[1] - by0 + 1 : 0;
      const int bw = any ? box[3] - bx0 + 1 : 0;
      const bool tile_path = any && bh <= kMaxBox && bw <= kMaxBox;
      if (c0 == 0) count_path(path_counts, lvl, tile_path ? 0 : any ? 1 : 2);
      if (!any) {
        cp_async_wait<0>();
        continue;
      }

      const int nks = (bw + 15) / 16;   // 16-pixel k steps of a row
      const int np = nks * 16;
      const __nv_bfloat16* src = img
          + (by0 * static_cast<int64_t>(w2) + bx0) * c + c0;
      const int64_t row_elems = static_cast<int64_t>(w2) * c;
      const RowCopy rc = row_copy(nch, c, kThreads);
      if (tile_path) {
        // pixels [bw, np) pad the last k step: their weights are 0, and
        // their f2 values must be finite, so zero them in every stage; the
        // first rows' copies go out before the weights are made
        for (int i = tid; i < kStages * (np - bw) * nch; i += kThreads) {
          const int s = i / ((np - bw) * nch);
          const int k = i - s * (np - bw) * nch;
          const int p = bw + k / nch;
          *reinterpret_cast<uint4*>(smem + s * kDf1StageBytes
                                    + (p / 8) * nch * kCm + (k % nch) * kCm
                                    + (p % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < bh) {
            stage_row_cm(rc, src + s * row_elems, c, bw,
                         ring + s * kDf1StageBytes, kThreads);
          }
          cp_async_commit();
        }
      }
      if (tile_path) cp_async_wait<kStages - 1>();   // dout, not the rows
      else cp_async_wait<0>();
      if (tid < kMaxBox) {
        rlo[tid] = INT_MAX;
        rhi[tid] = INT_MIN;
      }
      __syncthreads();
      tile_tap_weights(wins, gd, wt, kThreads);
      if (tile_path && tid < kTilePos && wins[tid].rows) {
        const Window& win = wins[tid];
        const int x0 = win.x0 + __ffs(win.cols) - 1 - bx0;
        const int x1 = win.x0 + 31 - __clz(win.cols) - bx0;
        for (int ty = 0; ty < kT; ++ty) {
          if ((win.rows >> ty) & 1u) {
            atomicMin(&rlo[win.y0 + ty - by0], x0);
            atomicMax(&rhi[win.y0 + ty - by0], x1);
          }
        }
      }
      __syncthreads();

      if (tile_path) {
        build_weights(wins, wt, 0, by0, bx0, np, wrows, wrows + kWBytes);
        for (int r = 0; r < bh; ++r) {
          cp_async_wait<kStages - 2>();   // row r has landed
          fence_async_shared();           // ... and row r's weights
          __syncthreads();                // for every thread
          if (r + kStages - 1 < bh) {
            stage_row_cm(rc, src + (r + kStages - 1) * row_elems, c, bw,
                         ring + ((r + kStages - 1) % kStages) * kDf1StageBytes,
                         kThreads);
          }
          cp_async_commit();
          const int lo = rlo[r];
          const int hi = rhi[r];
          if (active && lo <= hi) {
            const unsigned wa = wring + (r & 1) * 2 * kWBytes;
            const unsigned rb = ring + (r % kStages) * kDf1StageBytes
                                + 16 * wg * kCm;
            wgmma_fence();
            for (int ks = lo / 16; ks <= hi / 16; ++ks) {
              // A: 2 core matrices (256 bytes) a k step; B: 2 pixel groups
              const uint64_t b = wgmma_desc(rb + 2 * ks * nch * kCm,
                                            nch * kCm, kCm);
              wgmma_ss_n128(d, wgmma_desc(wa + 256 * ks, 128, kWGroup), b);
              wgmma_ss_n128(d, wgmma_desc(wa + kWBytes + 256 * ks, 128,
                                          kWGroup), b);
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          }
          if (r + 1 < bh) {
            unsigned char* next = wrows + ((r + 1) & 1) * 2 * kWBytes;
            build_weights(wins, wt, r + 1, by0, bx0, np, next,
                          next + kWBytes);
          }
          if (active && lo <= hi) {
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          }
        }
      } else {
        // the level's per-position sums into buf, then into the
        // accumulators (channel 128 wg + 8 j + 2 t (+1) of rows qa, qb)
        for (int q = warp; q < kTilePos; q += kWarps) {
          if (tile.pos(q) < 0) continue;
          for (int cc = lane * V; cc < gc; cc += 32 * V) {
            float s[V];
#pragma unroll
            for (int j = 0; j < V; ++j) s[j] = 0.0f;
            add_taps<__nv_bfloat16, V>(img, wins[q], w2, c, wt + q * kTaps,
                                       c0 + cc, s);
            store_vec<V>(buf + q * kBufStride + cc, s);
          }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int ch = 128 * wg + 8 * j + 2 * t;
          if (ch < gc) {
            const float2 sa =
                *reinterpret_cast<const float2*>(buf + qa * kBufStride + ch);
            const float2 sb =
                *reinterpret_cast<const float2*>(buf + qb * kBufStride + ch);
            d[4 * j] += sa.x;
            d[4 * j + 1] += sa.y;
            d[4 * j + 2] += sb.x;
            d[4 * j + 3] += sb.y;
          }
        }
      }
    }

    // the pass's df1 rows, through buf, written coalesced
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ch = 128 * wg + 8 * j + 2 * t;
      if (ch < gc) {
        *reinterpret_cast<float2*>(buf + qa * kBufStride + ch) =
            make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(buf + qb * kBufStride + ch) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
    __syncthreads();
    const int vecs = gc / 4;
    for (int i = tid; i < kTilePos * vecs; i += kThreads) {
      const int q = i / vecs;
      const int v = i - q * vecs;
      const int64_t pos = tile.pos(q);
      if (pos >= 0) {
        *reinterpret_cast<float4*>(df1 + pos * c + c0 + 4 * v) =
            *reinterpret_cast<const float4*>(buf + q * kBufStride + 4 * v);
      }
    }
    __syncthreads();  // buf is read before the next pass stages dout in it
  }
}

// -- df2 ---------------------------------------------------------------------

constexpr int kSeg = 8;                   // pixels a warp's row segment
constexpr int kLaneCh = 8;                // channels a lane owns
constexpr int kGroupCh = 32 * kLaneCh;    // channels a warp covers
// the tap weights of a window row, padded with zeros so that the kSeg
// slot weights of a segment the row starts o pixels into (-kT < o < kSeg)
// are the kSeg values from the row's start - o: each row is followed by
// kSeg - 1 zeros, and the table starts with kSeg - 1 zeros
constexpr int kRowPad = kT + kSeg - 1;
constexpr int kFront = kSeg - 1;
constexpr int kWeights = kFront + kTilePos * kT * kRowPad;
// dynamic shared memory: f1 of a channel group (dout's values in phase A),
// then the padded weights
constexpr int kDf2Smem = (kTilePos * kGroupCh + kWeights) * 4;
static_assert(kTilePos * kWin <= kTilePos * kGroupCh, "dout fits f1's room");

// df2 of one level. A block takes an 8x8 tile of positions of one image.
// Phase A: the windows and the tile's box (tile_windows), the 64
// positions' 81 dout values staged in shared memory (stage_dout) and
// turned into the tap weights (tap_weight, as df1), kept as zero-padded
// rows (kRowPad). Then, per group of kGroupCh channels (one at C = 256),
// f1 of the tile is staged in shared memory as float32 and the tile takes
// one of two paths:
// - tile path (box sides <= kMaxBox): the box's rows are cut into kSeg-
//   pixel segments; a warp owns a (row, segment) and keeps kSeg x kLaneCh
//   accumulators (pixel, its lane's channels) in registers. It walks the
//   tile's positions whose windows cover the row (a 64-bit mask per box
//   row, built with two warp ballots) and overlap the segment; a window
//   starting o pixels into the segment adds its row's weights read from
//   the padded row at offset -o (zeros outside the window, so the loop
//   has no branch and the accumulators stay in registers) times the
//   position's f1. Then each touched pixel goes to df2 with one float4
//   reduction per lane and 4 channels (the warp's contiguous 1 KB of the
//   pixel's channels at C = 256). Every df2 element the tile touches is
//   reduced once per tile, not once per tap.
// - direct path (a taller or wider box: a motion boundary or far-flung
//   windows, whose windows share few pixels of the box): a warp takes a
//   tile row of positions and adds each in-bounds tap of non-zero weight
//   with one float4 reduction per lane and 4 channels.
// path_counts, when not null, counts the tiles: [tile path, direct path,
// no in-bounds tap].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wcp_df2_kernel(const float* __restrict__ dout, const T* __restrict__ f1,
               const float* __restrict__ coords, float* __restrict__ df2,
               int lvl, int n_levels, int h2, int w2, int h, int w, int c,
               int tiles_x, int tiles_per_image, int* path_counts) {
  extern __shared__ __align__(16) float f1s[];   // (kTilePos, kGroupCh)
  float* wts = f1s + kTilePos * kGroupCh;         // kWeights, see kRowPad
  __shared__ Window wins[kTilePos];
  __shared__ unsigned long long row_mask[kMaxBox];
  __shared__ int box[4];  // first and last in-bounds tap row, column

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Tile tile = tile_at(blockIdx.x, tiles_x, tiles_per_image, h, w);

  // phase A: the windows (a thread a position), the tile's box, dout's 81
  // values of every position (staged in f1s) and the tap weights
  tile_windows(coords, tile, lvl, h2, w2, wins, box);
  const int by0 = box[0];
  if (by0 == INT_MAX) {  // no in-bounds tap: nothing to add
    count_path(path_counts, 0, 2);
    return;
  }
  stage_dout<kThreads>(dout, tile, lvl, n_levels, wins, f1s);
  __syncthreads();
  for (int i = tid; i < kWeights; i += kThreads) {
    const int at = i - kFront;           // (q, ty, j) of the padded rows
    const int row = at / kRowPad;        // q * kT + ty
    const int j = at - row * kRowPad;
    const int q = row / kT;
    wts[i] = at >= 0 && j < kT && wins[q].rows
                 ? tap_weight(f1s + q * kWin, wins[q],
                              (row - q * kT) * kT + j)
                 : 0.0f;
  }

  const int bh = box[1] - by0 + 1;
  const int bx0 = box[2];
  const int bx1 = box[3];
  const bool tile_path = bh <= kMaxBox && bx1 - bx0 + 1 <= kMaxBox;
  count_path(path_counts, 0, tile_path ? 0 : 1);
  if (tile_path) {
    // row r's mask: the positions whose windows hold box row by0 + r
    for (int r = warp; r < bh; r += kWarps) {
      const int y = by0 + r;
      const Window& lo = wins[lane];
      const Window& hi = wins[lane + 32];
      const unsigned ylo = static_cast<unsigned>(y - lo.y0);
      const unsigned yhi = static_cast<unsigned>(y - hi.y0);
      const unsigned mlo = __ballot_sync(
          kFull, ylo < static_cast<unsigned>(kT) && ((lo.rows >> ylo) & 1u));
      const unsigned mhi = __ballot_sync(
          kFull, yhi < static_cast<unsigned>(kT) && ((hi.rows >> yhi) & 1u));
      if (lane == 0) {
        row_mask[r] = mlo | (static_cast<unsigned long long>(mhi) << 32);
      }
    }
  }

  float* img = df2 + tile.bi * h2 * static_cast<int64_t>(w2) * c;
  const int segs = (bx1 - bx0 + kSeg) / kSeg;
  for (int c0 = 0; c0 < c; c0 += kGroupCh) {
    const int gc = c - c0 < kGroupCh ? c - c0 : kGroupCh;
    __syncthreads();  // the row masks are built; the last group is read
    {
      // every load in flight before the first store
      constexpr int kPer =
          (kTilePos * (kGroupCh / kLaneCh) + kThreads - 1) / kThreads;
      const int vecs = gc / kLaneCh;
      float v[kPer][kLaneCh];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads;
        const int q = i / vecs;
#pragma unroll
        for (int j = 0; j < kLaneCh; ++j) v[k][j] = 0.0f;
        if (q < kTilePos && wins[q].rows) {
          load_vec<kLaneCh>(f1 + tile.pos(q) * c + c0 + (i - q * vecs)
                            * kLaneCh, v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads;
        const int q = i / vecs;
        if (q < kTilePos) {
          float* dst = f1s + q * kGroupCh + (i - q * vecs) * kLaneCh;
#pragma unroll
          for (int j = 0; j < kLaneCh; j += 4) {
            *reinterpret_cast<float4*>(dst + j) =
                make_float4(v[k][j], v[k][j + 1], v[k][j + 2], v[k][j + 3]);
          }
        }
      }
    }
    __syncthreads();
    const bool lane_ok = lane * kLaneCh < gc;
    float* grp = img + c0 + lane * kLaneCh;

    if (tile_path) {
      for (int it = warp; it < bh * segs; it += kWarps) {
        const int r = it / segs;
        const int y = by0 + r;
        const int sx = bx0 + (it - r * segs) * kSeg;
        float acc[kSeg][kLaneCh];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
#pragma unroll
          for (int j = 0; j < kLaneCh; ++j) acc[i][j] = 0.f;
        }
        unsigned touched = 0;
        unsigned long long mask = row_mask[r];
        while (mask) {
          const int q = __ffsll(static_cast<long long>(mask)) - 1;
          mask &= mask - 1;
          const int o = wins[q].x0 - sx;
          if (o <= -kT || o >= kSeg) continue;
          // slot i's weight is the row's tap i - o (0 outside the window)
          const float* wr = wts + kFront
                            + (q * kT + y - wins[q].y0) * kRowPad - o;
          const float* fr = f1s + q * kGroupCh + lane * kLaneCh;
          float f[kLaneCh];
#pragma unroll
          for (int j = 0; j < kLaneCh; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(fr + j);
            f[j] = v.x;
            f[j + 1] = v.y;
            f[j + 2] = v.z;
            f[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            const float wv = wr[i];
#pragma unroll
            for (int j = 0; j < kLaneCh; ++j) {
              acc[i][j] = fmaf(wv, f[j], acc[i][j]);
            }
          }
          touched |= o >= 0 ? (0x3ffu << o) : (0x3ffu >> -o);
        }
        if (lane_ok) {
          float* row = grp + (static_cast<int64_t>(y) * w2 + sx) * c;
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            if (((touched >> i) & 1u) && sx + i <= bx1) {
#pragma unroll
              for (int j = 0; j < kLaneCh; j += 4) {
                atomicAdd(reinterpret_cast<float4*>(row + i * c + j),
                          make_float4(acc[i][j], acc[i][j + 1],
                                      acc[i][j + 2], acc[i][j + 3]));
              }
            }
          }
        }
      }
    } else {
      // warp w takes positions [w, w + 1) * kTilePos / kWarps (a tile
      // row), so that the warps' windows at one time lie rows apart rather
      // than on the same pixels
      for (int i = warp; i < kTilePos; i += kWarps) {
        const int q = (i % kWarps) * (kTilePos / kWarps) + i / kWarps;
        const Window& win = wins[q];
        const unsigned rows = win.rows;
        const unsigned cols = win.cols;
        if (!rows || !lane_ok) continue;
        const float* f = f1s + q * kGroupCh + lane * kLaneCh;
        for (int ty = 0; ty < kT; ++ty) {
          if (!((rows >> ty) & 1u)) continue;
          float* row = grp + (static_cast<int64_t>(win.y0 + ty) * w2
                              + win.x0) * c;
#pragma unroll
          for (int tx = 0; tx < kT; ++tx) {
            const float wv = wts[kFront + (q * kT + ty) * kRowPad + tx];
            if (((cols >> tx) & 1u) && wv != 0.0f) {
#pragma unroll
              for (int j = 0; j < kLaneCh; j += 4) {
                atomicAdd(reinterpret_cast<float4*>(row + tx * c + j),
                          make_float4(wv * f[j], wv * f[j + 1],
                                      wv * f[j + 2], wv * f[j + 3]));
              }
            }
          }
        }
      }
    }
  }
}

// -- launches ----------------------------------------------------------------

unsigned int blocks_for(int64_t positions) {
  return static_cast<unsigned int>((positions + kWarps - 1) / kWarps);
}

bool valid(int radius, int c, int n_levels) {
  return radius == kRadius && c > 0 && c % 32 == 0 && n_levels >= 1
         && n_levels <= kMaxLevels;
}

Levels make_levels(const void* const* f2, const int* dims, int n_levels) {
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.f2[l] = f2[l];
    lv.h2[l] = dims[2 * l];
    lv.w2[l] = dims[2 * l + 1];
  }
  return lv;
}

// the tiles of a launch: tiles_x a row, tiles_per_image, tiles in all
struct Tiles {
  int x;
  int per_image;
  int64_t all;
};

Tiles tiles_of(int b, int h, int w) {
  Tiles t;
  t.x = (w + kTile - 1) / kTile;
  t.per_image = ((h + kTile - 1) / kTile) * t.x;
  t.all = static_cast<int64_t>(b) * t.per_image;
  return t;
}

// the widest vector (16 bytes at most) that divides C into whole
// 32-lane chunks
template <typename T, template <typename, int> class Launch, typename... A>
cudaError_t by_width(int c, A... args) {
  constexpr int kMaxV = 16 / static_cast<int>(sizeof(T));
  if (kMaxV >= 8 && c % (32 * 8) == 0) {
    return Launch<T, (kMaxV >= 8 ? 8 : 1)>::run(args...);
  } else if (c % (32 * 4) == 0) {
    return Launch<T, 4>::run(args...);
  } else if (c % (32 * 2) == 0) {
    return Launch<T, 2>::run(args...);
  }
  return Launch<T, 1>::run(args...);
}

template <typename T, int V>
struct FwdLaunch {
  static cudaError_t run(const void* f1, Levels lv, int n_levels,
                         const void* coords, void* out, int b, int h, int w,
                         int c, int* path_counts, cudaStream_t s) {
    if constexpr (std::is_same<T, float>::value) {
      const int64_t positions = static_cast<int64_t>(b) * h * w;
      wcp_fwd_kernel<T, V><<<blocks_for(positions), kThreads, 0, s>>>(
          static_cast<const T*>(f1), lv, n_levels,
          static_cast<const float*>(coords), static_cast<float*>(out),
          positions, h, w, c, path_counts);
    } else {
      const Tiles t = tiles_of(b, h, w);
      // the ring and the dots exceed the default 48 KB
      const cudaError_t err = cudaFuncSetAttribute(
          wcp_fwd_tile_kernel<V>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
      if (err != cudaSuccess) return err;
      wcp_fwd_tile_kernel<V>
          <<<static_cast<unsigned int>(n_levels * t.all), kThreads, kFwdSmem,
             s>>>(static_cast<const __nv_bfloat16*>(f1), lv, n_levels,
                  static_cast<const float*>(coords),
                  static_cast<float*>(out), h, w, c, t.x, t.per_image, t.all,
                  path_counts);
    }
    return cudaGetLastError();
  }
};

template <typename T, int V>
struct Df1Launch {
  static cudaError_t run(const void* dout, Levels lv, int n_levels,
                         const void* coords, void* df1, int b, int h, int w,
                         int c, int* path_counts, cudaStream_t s) {
    if constexpr (std::is_same<T, float>::value) {
      const int64_t positions = static_cast<int64_t>(b) * h * w;
      wcp_df1_kernel<T, V><<<blocks_for(positions), kThreads, 0, s>>>(
          static_cast<const float*>(dout), lv, n_levels,
          static_cast<const float*>(coords), static_cast<float*>(df1),
          positions, h, w, c, path_counts);
    } else {
      const Tiles t = tiles_of(b, h, w);
      const cudaError_t err = cudaFuncSetAttribute(
          wcp_df1_tile_kernel<V>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kDf1Smem);
      if (err != cudaSuccess) return err;
      wcp_df1_tile_kernel<V>
          <<<static_cast<unsigned int>(t.all), kThreads, kDf1Smem, s>>>(
              static_cast<const float*>(dout), lv, n_levels,
              static_cast<const float*>(coords), static_cast<float*>(df1), h,
              w, c, t.x, t.per_image, path_counts);
    }
    return cudaGetLastError();
  }
};

template <typename T>
int fwd(const void* f1, const void* const* f2, const int* dims, int n_levels,
        const void* coords, void* out, int b, int h, int w, int c, int radius,
        int* path_counts, void* stream) {
  if (!valid(radius, c, n_levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(b) * h * w > 0) {
    return static_cast<int>(by_width<T, FwdLaunch>(
        c, f1, make_levels(f2, dims, n_levels), n_levels, coords, out, b, h,
        w, c, path_counts, static_cast<cudaStream_t>(stream)));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int df1(const void* dout, const void* const* f2, const int* dims,
        int n_levels, const void* coords, void* out, int b, int h, int w,
        int c, int radius, int* path_counts, void* stream) {
  if (!valid(radius, c, n_levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(b) * h * w > 0) {
    return static_cast<int>(by_width<T, Df1Launch>(
        c, dout, make_levels(f2, dims, n_levels), n_levels, coords, out, b,
        h, w, c, path_counts, static_cast<cudaStream_t>(stream)));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int df2(const void* dout, const void* f1, const void* coords, void* out,
        int level, int n_levels, int h2, int w2, int b, int h, int w, int c,
        int radius, int* path_counts, void* stream) {
  if (!valid(radius, c, n_levels) || level < 0 || level >= n_levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tiles t = tiles_of(b, h, w);
  if (t.all > 0) {
    // static shared memory plus the staged f1 exceed the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        wcp_df2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDf2Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wcp_df2_kernel<T><<<static_cast<unsigned int>(t.all), kThreads,
                        kDf2Smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dout), static_cast<const T*>(f1),
        static_cast<const float*>(coords), static_cast<float*>(out), level,
        n_levels, h2, w2, h, w, c, t.x, t.per_image, path_counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f2: host array of n_levels device pointers; dims: host array (h2, w2)
// per level; path_counts: null, or (n_levels, 3) device ints the kernel
// adds its tiles per path to
extern "C" int wcp_fwd_f32(const void* f1, const void* const* f2,
                           const int* dims, int n_levels, const void* coords,
                           void* out, int b, int h, int w, int c, int radius,
                           int* path_counts, void* stream) {
  return fwd<float>(f1, f2, dims, n_levels, coords, out, b, h, w, c, radius,
                    path_counts, stream);
}

extern "C" int wcp_fwd_bf16(const void* f1, const void* const* f2,
                            const int* dims, int n_levels, const void* coords,
                            void* out, int b, int h, int w, int c, int radius,
                            int* path_counts, void* stream) {
  return fwd<__nv_bfloat16>(f1, f2, dims, n_levels, coords, out, b, h, w, c,
                            radius, path_counts, stream);
}

extern "C" int wcp_df1_f32(const void* dout, const void* const* f2,
                           const int* dims, int n_levels, const void* coords,
                           void* out, int b, int h, int w, int c, int radius,
                           int* path_counts, void* stream) {
  return df1<float>(dout, f2, dims, n_levels, coords, out, b, h, w, c, radius,
                    path_counts, stream);
}

extern "C" int wcp_df1_bf16(const void* dout, const void* const* f2,
                            const int* dims, int n_levels, const void* coords,
                            void* out, int b, int h, int w, int c, int radius,
                            int* path_counts, void* stream) {
  return df1<__nv_bfloat16>(dout, f2, dims, n_levels, coords, out, b, h, w,
                            c, radius, path_counts, stream);
}

extern "C" int wcp_df2_f32(const void* dout, const void* f1,
                           const void* coords, void* out, int level,
                           int n_levels, int h2, int w2, int b, int h, int w,
                           int c, int radius, int* path_counts,
                           void* stream) {
  return df2<float>(dout, f1, coords, out, level, n_levels, h2, w2, b, h, w,
                    c, radius, path_counts, stream);
}

extern "C" int wcp_df2_bf16(const void* dout, const void* f1,
                            const void* coords, void* out, int level,
                            int n_levels, int h2, int w2, int b, int h, int w,
                            int c, int radius, int* path_counts,
                            void* stream) {
  return df2<__nv_bfloat16>(dout, f1, coords, out, level, n_levels, h2, w2, b,
                            h, w, c, radius, path_counts, stream);
}

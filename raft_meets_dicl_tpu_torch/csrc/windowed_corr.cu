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
// It follows the JAX contract, not the TPU blocking: the 8-aligned slabs,
// the lane-selection matrices and the band sharing there exist for the
// TPU's vector layout and have no counterpart here.
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
// C = 256 that is ~20 float32 operations per byte moved: above the
// card's bf16 tensor-core ridge (~295) the bytes bound, but the kernels
// run the dots on the float32 CUDA cores (67 TFLOP/s), where the
// operations bound (~33 us at 42,880 positions).
//
// Design. Forward and df1: one warp per position (8 per block,
// neighbouring positions, so their overlapping windows come from L1/L2).
// A lane owns V consecutive channels per 32V-channel chunk (V = 16 bytes
// of the dtype where C allows it: one 16-byte load per tap, the warp
// reading 512 contiguous bytes of a bf16 tap at C = 256).
// - Forward: per group of 32 taps each lane sums its channels' products
//   for all 32 taps in registers, then a transpose reduction (31
//   shuffles for 32 sums, not 5 per tap) leaves tap g*32 + lane's dot in
//   that lane; the 100 dots go to shared memory, and the lanes apply the
//   two lerps and write the 81 outputs of the level contiguously. One
//   launch for all levels.
// - df1: the lanes stage dout's 81 values of each level in shared memory
//   and turn them into the 100 tap weights per level (shared memory), then
//   each lane sums weight * f2 tap over every tap and level for its
//   channels: no reduction across lanes, no atomics (each position owns
//   its df1 row). One launch for all levels.
// - df2: one launch per level; a block takes an 8x8 tile of positions and
//   adds on the chip before it reduces to device memory (the kernel's own
//   note below). The tile's tap weights are computed once (dout read
//   once), its f1 staged in shared memory, and on the tile path each warp
//   owns a row segment of the tile's bounding box of taps and sums every
//   window's contribution to it in registers; each df2 element the tile
//   touches then gets one float4 reduction (red.global.add.v4.f32) per
//   lane and 4 channels, not one atomic per tap and channel. A tile whose
//   box is wider or taller than kMaxBox takes the direct path: one float4
//   reduction per tap.
// Out-of-bounds taps are neither read nor written. Launches go on the
// caller's stream, do not synchronise and allocate nothing; the C entry
// points return cudaGetLastError(), or cudaErrorInvalidValue for a radius
// other than kRadius (every shipped config's corr-radius), C not a
// multiple of 32, or a level count outside [1, kMaxLevels].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kRadius = 4;              // the window radius instantiated
constexpr int kK = 2 * kRadius + 1;     // window width (9)
constexpr int kT = kK + 1;              // taps per axis (10)
constexpr int kTaps = kT * kT;          // taps per window (100)
constexpr int kWin = kK * kK;           // outputs per level (81)
constexpr int kGroups = (kTaps + 31) / 32;
constexpr int kMaxLevels = 6;
constexpr int kWarps = 8;               // positions per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wcp_fwd_kernel(const T* __restrict__ f1, Levels lv, int n_levels,
               const float* __restrict__ coords, float* __restrict__ out,
               int64_t positions, int hw, int c) {
  __shared__ float dots[kWarps][kGroups * 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pos >= positions) return;
  const int64_t bi = pos / hw;
  const T* f1p = f1 + pos * c;
  float* o = out + pos * n_levels * kWin;
  float* d = dots[warp];

  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int h2 = lv.h2[lvl];
    const int w2 = lv.w2[lvl];
    const Window win = window_at(coords, pos, lvl, h2, w2);
    const T* img = static_cast<const T*>(lv.f2[lvl])
                   + bi * h2 * static_cast<int64_t>(w2) * c;

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

    // the two lerps, y first, then x; outputs in (dx, dy) order
    for (int oi = lane; oi < kWin; oi += 32) {
      const int dx = oi / kK;
      const int dy = oi % kK;
      const float t0 = (1.0f - win.fy) * d[dy * kT + dx]
                       + win.fy * d[(dy + 1) * kT + dx];
      const float t1 = (1.0f - win.fy) * d[dy * kT + dx + 1]
                       + win.fy * d[(dy + 1) * kT + dx + 1];
      o[lvl * kWin + oi] = (1.0f - win.fx) * t0 + win.fx * t1;
    }
    __syncwarp();
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wcp_df1_kernel(const float* __restrict__ dout, Levels lv, int n_levels,
               const float* __restrict__ coords, float* __restrict__ df1,
               int64_t positions, int hw, int c) {
  __shared__ float weights[kWarps][kMaxLevels][kTaps];
  __shared__ float staged[kWarps][kWin];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pos >= positions) return;
  const int64_t bi = pos / hw;

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
      const float* wt = weights[warp][lvl];
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
    store_vec<V>(df1 + pos * c + c0, acc);
  }
}

// -- df2 ---------------------------------------------------------------------

constexpr int kTile = 8;                  // positions a df2 tile side
constexpr int kTilePos = kTile * kTile;   // positions a df2 tile (64 bits)
constexpr int kSeg = 8;                   // pixels a warp's row segment
constexpr int kLaneCh = 8;                // channels a lane owns
constexpr int kGroupCh = 32 * kLaneCh;    // channels a warp covers
// tile path: box sides at most (row_mask holds this many box rows). A
// taller or wider box means windows spread over several window widths,
// which share few of its pixels (a motion boundary, far-flung windows):
// adding them on the chip first saves little there
constexpr int kMaxBox = 48;
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
// Phase A: a thread per position computes its window (window_at), the
// block takes the bounding box of the tile's in-bounds taps, stages the
// 64 positions' 81 dout values in shared memory with every load in flight
// at once, and turns them into the tap weights (tap_weight, as df1), kept
// as zero-padded rows (kRowPad). Then, per group of kGroupCh channels
// (one at C = 256), f1 of the tile is staged in shared memory as float32
// and the tile takes one of two paths:
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
// no in-bounds tap] (ops/windowed.py's df2_tile_paths computes the same
// from the centres).
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
  const int64_t bi = blockIdx.x / tiles_per_image;
  const int tile = static_cast<int>(blockIdx.x - bi * tiles_per_image);
  const int ty0 = (tile / tiles_x) * kTile;
  const int tx0 = (tile % tiles_x) * kTile;
  // position q of the tile (y, x), or -1 outside the image
  auto position = [&](int q) -> int64_t {
    const int y = ty0 + q / kTile;
    const int x = tx0 + q % kTile;
    return y < h && x < w ? (bi * h + y) * w + x : -1;
  };

  // phase A: the windows (a thread a position), the tile's box, dout's 81
  // values of every position (staged in f1s) and the tap weights
  if (tid == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  __syncthreads();
  if (tid < kTilePos) {
    const int64_t pos = position(tid);
    Window win = {};
    if (pos >= 0) win = window_at(coords, pos, lvl, h2, w2);
    if (!(win.rows && win.cols)) {
      win.rows = 0;
      win.cols = 0;
    }
    wins[tid] = win;
    if (win.rows) {
      atomicMin(&box[0], win.y0 + __ffs(win.rows) - 1);
      atomicMax(&box[1], win.y0 + 31 - __clz(win.rows));
      atomicMin(&box[2], win.x0 + __ffs(win.cols) - 1);
      atomicMax(&box[3], win.x0 + 31 - __clz(win.cols));
    }
  }
  __syncthreads();
  const int by0 = box[0];
  if (by0 == INT_MAX) {  // no in-bounds tap: nothing to add
    if (path_counts != nullptr && tid == 0) atomicAdd(path_counts + 2, 1);
    return;
  }
  {
    // every load in flight before the first store
    constexpr int kPer = (kTilePos * kWin + kThreads - 1) / kThreads;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      const int q = i / kWin;
      v[j] = i < kTilePos * kWin && wins[q].rows
                 ? __ldg(dout + (position(q) * n_levels + lvl) * kWin + i
                         - q * kWin)
                 : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (tid + j * kThreads < kTilePos * kWin) f1s[tid + j * kThreads] = v[j];
    }
  }
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
  if (path_counts != nullptr && tid == 0) {
    atomicAdd(path_counts + (tile_path ? 0 : 1), 1);
  }
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

  float* img = df2 + bi * h2 * static_cast<int64_t>(w2) * c;
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
          load_vec<kLaneCh>(f1 + position(q) * c + c0 + (i - q * vecs)
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

// the widest vector (16 bytes at most) that divides C into whole
// 32-lane chunks
template <typename T, template <typename, int> class Launch, typename... A>
void by_width(int c, A... args) {
  constexpr int kMaxV = 16 / static_cast<int>(sizeof(T));
  if (kMaxV >= 8 && c % (32 * 8) == 0) {
    Launch<T, (kMaxV >= 8 ? 8 : 1)>::run(args...);
  } else if (c % (32 * 4) == 0) {
    Launch<T, 4>::run(args...);
  } else if (c % (32 * 2) == 0) {
    Launch<T, 2>::run(args...);
  } else {
    Launch<T, 1>::run(args...);
  }
}

template <typename T, int V>
struct FwdLaunch {
  static void run(const void* f1, Levels lv, int n_levels, const void* coords,
                  void* out, int64_t positions, int hw, int c,
                  cudaStream_t s) {
    wcp_fwd_kernel<T, V><<<blocks_for(positions), kThreads, 0, s>>>(
        static_cast<const T*>(f1), lv, n_levels,
        static_cast<const float*>(coords), static_cast<float*>(out),
        positions, hw, c);
  }
};

template <typename T, int V>
struct Df1Launch {
  static void run(const void* dout, Levels lv, int n_levels,
                  const void* coords, void* df1, int64_t positions, int hw,
                  int c, cudaStream_t s) {
    wcp_df1_kernel<T, V><<<blocks_for(positions), kThreads, 0, s>>>(
        static_cast<const float*>(dout), lv, n_levels,
        static_cast<const float*>(coords), static_cast<float*>(df1),
        positions, hw, c);
  }
};

template <typename T>
int fwd(const void* f1, const void* const* f2, const int* dims, int n_levels,
        const void* coords, void* out, int b, int h, int w, int c, int radius,
        void* stream) {
  if (!valid(radius, c, n_levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t positions = static_cast<int64_t>(b) * h * w;
  if (positions > 0) {
    by_width<T, FwdLaunch>(c, f1, make_levels(f2, dims, n_levels), n_levels,
                           coords, out, positions, h * w, c,
                           static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int df1(const void* dout, const void* const* f2, const int* dims,
        int n_levels, const void* coords, void* out, int b, int h, int w,
        int c, int radius, void* stream) {
  if (!valid(radius, c, n_levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t positions = static_cast<int64_t>(b) * h * w;
  if (positions > 0) {
    by_width<T, Df1Launch>(c, dout, make_levels(f2, dims, n_levels),
                           n_levels, coords, out, positions, h * w, c,
                           static_cast<cudaStream_t>(stream));
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
  const int tiles_x = (w + kTile - 1) / kTile;
  const int64_t tiles_per_image =
      static_cast<int64_t>((h + kTile - 1) / kTile) * tiles_x;
  const int64_t blocks = b * tiles_per_image;
  if (blocks > 0) {
    // static shared memory plus the staged f1 exceed the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        wcp_df2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDf2Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wcp_df2_kernel<T><<<static_cast<unsigned int>(blocks), kThreads,
                        kDf2Smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dout), static_cast<const T*>(f1),
        static_cast<const float*>(coords), static_cast<float*>(out), level,
        n_levels, h2, w2, h, w, c, tiles_x,
        static_cast<int>(tiles_per_image), path_counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f2: host array of n_levels device pointers; dims: host array (h2, w2)
// per level
extern "C" int wcp_fwd_f32(const void* f1, const void* const* f2,
                           const int* dims, int n_levels, const void* coords,
                           void* out, int b, int h, int w, int c, int radius,
                           void* stream) {
  return fwd<float>(f1, f2, dims, n_levels, coords, out, b, h, w, c, radius,
                    stream);
}

extern "C" int wcp_fwd_bf16(const void* f1, const void* const* f2,
                            const int* dims, int n_levels, const void* coords,
                            void* out, int b, int h, int w, int c, int radius,
                            void* stream) {
  return fwd<__nv_bfloat16>(f1, f2, dims, n_levels, coords, out, b, h, w, c,
                            radius, stream);
}

extern "C" int wcp_df1_f32(const void* dout, const void* const* f2,
                           const int* dims, int n_levels, const void* coords,
                           void* out, int b, int h, int w, int c, int radius,
                           void* stream) {
  return df1<float>(dout, f2, dims, n_levels, coords, out, b, h, w, c, radius,
                    stream);
}

extern "C" int wcp_df1_bf16(const void* dout, const void* const* f2,
                            const int* dims, int n_levels, const void* coords,
                            void* out, int b, int h, int w, int c, int radius,
                            void* stream) {
  return df1<__nv_bfloat16>(dout, f2, dims, n_levels, coords, out, b, h, w,
                            c, radius, stream);
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

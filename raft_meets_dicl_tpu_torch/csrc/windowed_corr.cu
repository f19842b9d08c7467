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
// Design. One warp per position (8 per block, neighbouring positions, so
// their overlapping windows come from L1/L2). A lane owns V consecutive
// channels per 32V-channel chunk (V = 16 bytes of the dtype where C allows
// it: one 16-byte load per tap, the warp reading 512 contiguous bytes of
// a bf16 tap at C = 256).
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
// - df2: per level, weights as above; then lane ch of the warp adds
//   wt * f1[p, ch] into each in-bounds tap with one atomicAdd per tap and
//   channel, lanes on consecutive channels (one 128-byte reduction in L2
//   per warp and 32 channels). Taps of zero weight are skipped. One
//   launch per level.
// Out-of-bounds taps are neither read nor written. Launches go on the
// caller's stream, do not synchronise and allocate nothing; the C entry
// points return cudaGetLastError(), or cudaErrorInvalidValue for a radius
// other than kRadius (every shipped config's corr-radius), C not a
// multiple of 32, or a level count outside [1, kMaxLevels].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  if constexpr (V == 4) {
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
    static_assert(V == 1, "float32 loads take 1, 2 or 4 elements");
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

// Stage level l's 81 dout values of position pos in shared memory (g) and
// turn them into the 100 tap weights (wt; 0 for taps outside f2_l).
__device__ __forceinline__ void tap_weights(const float* __restrict__ dout,
                                            int64_t pos, int lvl,
                                            int n_levels, const Window& win,
                                            int lane, float* g, float* wt) {
  const float* src = dout + (pos * n_levels + lvl) * kWin;
  for (int o = lane; o < kWin; o += 32) g[o] = __ldg(src + o);
  __syncwarp();
  for (int t = lane; t < kTaps; t += 32) {
    const int ty = t / kT;
    const int tx = t % kT;
    float w = 0.0f;
    if (tap_in(win, ty, tx)) {
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
      w = (1.0f - win.fy) * gy0 + win.fy * gy1;
    }
    wt[t] = w;
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
wcp_df2_kernel(const float* __restrict__ dout, const T* __restrict__ f1,
               const float* __restrict__ coords, float* __restrict__ df2,
               int lvl, int n_levels, int h2, int w2, int64_t positions,
               int hw, int c) {
  __shared__ float weights[kWarps][kTaps];
  __shared__ float staged[kWarps][kWin];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pos >= positions) return;
  const int64_t bi = pos / hw;

  const Window win = window_at(coords, pos, lvl, h2, w2);
  const float* wt = weights[warp];
  tap_weights(dout, pos, lvl, n_levels, win, lane, staged[warp],
              weights[warp]);

  float* img = df2 + bi * h2 * static_cast<int64_t>(w2) * c;
  for (int ch = lane; ch < c; ch += 32) {
    const float a = load_one(f1 + pos * c + ch);
#pragma unroll 1
    for (int ty = 0; ty < kT; ++ty) {
      if (!((win.rows >> ty) & 1u)) continue;
      float* row = img + (win.y0 + ty) * w2 * c + ch;
#pragma unroll
      for (int tx = 0; tx < kT; ++tx) {
        const float w = wt[ty * kT + tx];
        if (((win.cols >> tx) & 1u) && w != 0.0f) {
          atomicAdd(row + (win.x0 + tx) * c, w * a);
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
        int radius, void* stream) {
  if (!valid(radius, c, n_levels) || level < 0 || level >= n_levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t positions = static_cast<int64_t>(b) * h * w;
  if (positions > 0) {
    wcp_df2_kernel<T><<<blocks_for(positions), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dout), static_cast<const T*>(f1),
        static_cast<const float*>(coords), static_cast<float*>(out), level,
        n_levels, h2, w2, positions, h * w, c);
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
                           int c, int radius, void* stream) {
  return df2<float>(dout, f1, coords, out, level, n_levels, h2, w2, b, h, w,
                    c, radius, stream);
}

extern "C" int wcp_df2_bf16(const void* dout, const void* f1,
                            const void* coords, void* out, int level,
                            int n_levels, int h2, int w2, int b, int h, int w,
                            int c, int radius, void* stream) {
  return df2<__nv_bfloat16>(dout, f1, coords, out, level, n_levels, h2, w2, b,
                            h, w, c, radius, stream);
}

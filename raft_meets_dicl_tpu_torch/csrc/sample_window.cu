// sample_window: the DICL displaced-window sampler, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels raft_meets_dicl_tpu/ops/pallas.py::_sw_fwd_kernel
// (launched by _sw_fwd_tpu, reached through _sw and sample_window_fused) and
// ::_sw_bwd_kernel (launched by _sw_bwd_tpu, reached through _sw_vjp_bwd).
//
// What the forward computes, per position (b, y, x) with centre (cx, cy) =
// coords[b, y, x] and K = 2R + 1:
//   centre clamped to [-(R+1), W2 + R] x [-(R+1), H2 + R] (a window wholly
//   outside stays wholly outside: exact zeros, no int overflow)
//   x0 = floor(cx) - R, y0 = floor(cy) - R, fx = cx - floor(cx), fy = ...
//   p[ty][tx] = f2[b, y0 + ty, x0 + tx, c]  (0 outside f2), ty, tx <= K
//   yl[tx]    = (1 - fy) * p[dv][tx] + fy * p[dv + 1][tx]
//   out[b, du, dv, y, x, c] = (1 - fx) * yl[du] + fx * yl[du + 1]
// i.e. f2 bilinearly sampled at (cx + du - R, cy + dv - R) with zero
// padding (grid_sample, align_corners=True, padding_mode="zeros"). f2 and
// out are float32 or bfloat16 (out in f2's dtype), computed in float32 and
// rounded once on write; coords float32.
//
// The backward takes dout = d(loss)/d(out) in f2's dtype and adds each
// tap's share, the transpose of both lerps,
//   df2[b, y0 + ty, x0 + tx, c] += sum over du in {tx-1, tx}, dv in
//     {ty-1, ty} of wx(du, tx) * wy(dv, ty) * dout[b, du, dv, y, x, c]
// (wx = 1 - fx where du = tx, fx where du = tx - 1; wy likewise) into a
// float32 df2 that the caller zeroes and casts to f2's dtype. Coordinates
// get no gradient.
//
// Bound: memory, both ways. The forward reads f2 once and the coords, and
// writes K^2 values per position and channel: at K = 9 and C = 32 that is
// 10,368 B per position in f32 (5,184 B in bf16) against a few hundred
// bytes of f2 it needs, and 4 flops per output value, far below the card's
// operations-per-byte ridge, so the least time is bytes / 3.35 TB/s. The
// backward reads the same dout bytes and writes df2 (81x smaller).
//
// Design: one warp per position, one lane per channel (a loop over chunks
// of 32 for C > 32, masked for the ragged chunk); 8 positions per block.
// Neighbouring warps hold neighbouring positions, so their (K+1)^2 taps
// overlap and come from L1/L2; each tap load is 32 consecutive channels
// (128 B in f32). The forward walks the tap rows: it keeps the previous
// row's K+1 values in registers, lerps y against the current row and
// writes the K outputs of that displacement row, each a coalesced
// 32-channel store (128 B in f32) next to the neighbouring positions' store
// for the same (du, dv). The backward walks the displacement rows dv: it
// reads the K values of dout's row (coalesced, as the forward writes
// them), spreads them over the K+1 tap columns (x transpose), keeps tap row
// dv's pending sum in registers until both displacement rows that touch it
// are in, and then issues one atomicAdd per tap and channel (a warp adds
// 32 consecutive floats, one 128-B reduction in L2). Out-of-bounds taps
// are neither read nor written. Launches go on the caller's stream, do not
// synchronise and allocate nothing; the C entry points return
// cudaGetLastError(), or cudaErrorInvalidValue for a radius other than
// kRadius, the one the kernels are instantiated for (every shipped
// config's corr-radius).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;  // the window radius instantiated
constexpr int kWarps = 8;  // positions per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// top-left tap (in f2's unpadded grid) and bilinear fractions of one
// position's window
struct Window {
  int x0;
  int y0;
  float fx;
  float fy;
};

template <int R>
__device__ __forceinline__ Window window_at(const float* __restrict__ coords,
                                            int64_t pos, int h2, int w2) {
  float cx = __ldg(coords + 2 * pos);
  float cy = __ldg(coords + 2 * pos + 1);
  cx = fminf(fmaxf(cx, -(R + 1.0f)), static_cast<float>(w2 + R));
  cy = fminf(fmaxf(cy, -(R + 1.0f)), static_cast<float>(h2 + R));
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  Window win;
  win.x0 = static_cast<int>(x0f) - R;
  win.y0 = static_cast<int>(y0f) - R;
  win.fx = cx - x0f;
  win.fy = cy - y0f;
  return win;
}

// one tap row (K + 1 values of channel ch), zero outside f2; offsets
// within an image fit 32 bits (the wrapper checks it)
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ img, int x0,
                                         int iy, int ch, int h2, int w2,
                                         int c, float (&v)[N]) {
  const bool row_in = iy >= 0 && iy < h2;
  const T* row = img + (row_in ? iy : 0) * w2 * c + ch;
#pragma unroll
  for (int tx = 0; tx < N; ++tx) {
    const int ix = x0 + tx;
    v[tx] = (row_in && ix >= 0 && ix < w2) ? load_f32(row + ix * c) : 0.0f;
  }
}

// adds one tap row's sums into df2 (channel ch), skipping taps outside f2
template <int N>
__device__ __forceinline__ void add_row(float* __restrict__ img, int x0,
                                        int iy, int ch, int h2, int w2, int c,
                                        const float (&v)[N]) {
  if (iy < 0 || iy >= h2) return;
  float* row = img + iy * w2 * c + ch;
#pragma unroll
  for (int tx = 0; tx < N; ++tx) {
    const int ix = x0 + tx;
    if (ix >= 0 && ix < w2) atomicAdd(row + ix * c, v[tx]);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sample_window_fwd_kernel(const T* __restrict__ f2,
                         const float* __restrict__ coords, T* __restrict__ out,
                         int b, int h2, int w2, int c, int h, int w) {
  constexpr int K = 2 * R + 1;
  constexpr int N = K + 1;  // taps per axis

  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pos =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (pos >= b * hw) return;
  const int lane = threadIdx.x % 32;
  const int64_t bi = pos / hw;
  const int64_t p = pos - bi * hw;
  const Window win = window_at<R>(coords, pos, h2, w2);

  const T* img = f2 + bi * h2 * static_cast<int64_t>(w2) * c;
  // out[bi, du, dv, p, ch]: displacement (du, dv) is (du * K + dv) * hw * c
  // further on
  T* o = out + (bi * K * K * hw + p) * c;
  const int64_t disp = hw * c;

  for (int ch = lane; ch < c; ch += 32) {
    float prev[N];
    float cur[N];
    load_row<T, N>(img, win.x0, win.y0, ch, h2, w2, c, prev);
    // one displacement row per pass, not unrolled: an unrolled walk keeps
    // every tap's address live and spills
#pragma unroll 1
    for (int dv = 0; dv < K; ++dv) {
      load_row<T, N>(img, win.x0, win.y0 + dv + 1, ch, h2, w2, c, cur);
      float yl[N];
#pragma unroll
      for (int tx = 0; tx < N; ++tx) {
        yl[tx] = (1.0f - win.fy) * prev[tx] + win.fy * cur[tx];
        prev[tx] = cur[tx];
      }
      T* od = o + dv * disp + ch;
#pragma unroll
      for (int du = 0; du < K; ++du) {
        store_as(od + du * K * disp,
                 (1.0f - win.fx) * yl[du] + win.fx * yl[du + 1]);
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
sample_window_bwd_kernel(const T* __restrict__ dout,
                         const float* __restrict__ coords,
                         float* __restrict__ df2, int b, int h2, int w2, int c,
                         int h, int w) {
  constexpr int K = 2 * R + 1;
  constexpr int N = K + 1;

  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pos =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (pos >= b * hw) return;
  const int lane = threadIdx.x % 32;
  const int64_t bi = pos / hw;
  const int64_t p = pos - bi * hw;
  const Window win = window_at<R>(coords, pos, h2, w2);

  float* img = df2 + bi * h2 * static_cast<int64_t>(w2) * c;
  const T* g = dout + (bi * K * K * hw + p) * c;
  const int64_t disp = hw * c;

  for (int ch = lane; ch < c; ch += 32) {
    // tap row dv's pending sum: its share of displacement row dv - 1
    float acc[N];
#pragma unroll
    for (int tx = 0; tx < N; ++tx) acc[tx] = 0.0f;

#pragma unroll 1
    for (int dv = 0; dv < K; ++dv) {
      const T* gd = g + dv * disp + ch;
      float d[K];
#pragma unroll
      for (int du = 0; du < K; ++du) d[du] = load_f32(gd + du * K * disp);
      // transpose of the x lerp: tap column tx takes (1 - fx) of du = tx
      // and fx of du = tx - 1
      float gx[N];
      gx[0] = (1.0f - win.fx) * d[0];
#pragma unroll
      for (int tx = 1; tx < K; ++tx) {
        gx[tx] = (1.0f - win.fx) * d[tx] + win.fx * d[tx - 1];
      }
      gx[K] = win.fx * d[K - 1];
      // transpose of the y lerp: tap row dv takes (1 - fy) and is then
      // complete; row dv + 1 starts with fy
#pragma unroll
      for (int tx = 0; tx < N; ++tx) acc[tx] += (1.0f - win.fy) * gx[tx];
      add_row<N>(img, win.x0, win.y0 + dv, ch, h2, w2, c, acc);
#pragma unroll
      for (int tx = 0; tx < N; ++tx) acc[tx] = win.fy * gx[tx];
    }
    add_row<N>(img, win.x0, win.y0 + K, ch, h2, w2, c, acc);
  }
}

template <typename T, int R>
void launch_fwd_r(const void* f2, const void* coords, void* out, int b,
                  int h2, int w2, int c, int h, int w, cudaStream_t stream) {
  const long long positions = static_cast<long long>(b) * h * w;
  const long long blocks = (positions + kWarps - 1) / kWarps;
  sample_window_fwd_kernel<T, R>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(f2), static_cast<const float*>(coords),
          static_cast<T*>(out), b, h2, w2, c, h, w);
}

template <typename T, int R>
void launch_bwd_r(const void* dout, const void* coords, void* df2, int b,
                  int h2, int w2, int c, int h, int w, cudaStream_t stream) {
  const long long positions = static_cast<long long>(b) * h * w;
  const long long blocks = (positions + kWarps - 1) / kWarps;
  sample_window_bwd_kernel<T, R>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(dout), static_cast<const float*>(coords),
          static_cast<float*>(df2), b, h2, w2, c, h, w);
}

// the one radius instantiated; nothing is launched for an empty problem
template <typename T, bool kBackward>
int launch(const void* in, const void* coords, void* out, int b, int h2,
           int w2, int c, int h, int w, int radius, void* stream) {
  if (radius != kRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(b) * h * w * c > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (kBackward) {
      launch_bwd_r<T, kRadius>(in, coords, out, b, h2, w2, c, h, w, s);
    } else {
      launch_fwd_r<T, kRadius>(in, coords, out, b, h2, w2, c, h, w, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sample_window_fwd_f32(const void* f2, const void* coords,
                                     void* out, int b, int h2, int w2, int c,
                                     int h, int w, int radius, void* stream) {
  return launch<float, false>(f2, coords, out, b, h2, w2, c, h, w, radius,
                              stream);
}

extern "C" int sample_window_fwd_bf16(const void* f2, const void* coords,
                                      void* out, int b, int h2, int w2, int c,
                                      int h, int w, int radius, void* stream) {
  return launch<__nv_bfloat16, false>(f2, coords, out, b, h2, w2, c, h, w,
                                      radius, stream);
}

extern "C" int sample_window_bwd_f32(const void* dout, const void* coords,
                                     void* df2, int b, int h2, int w2, int c,
                                     int h, int w, int radius, void* stream) {
  return launch<float, true>(dout, coords, df2, b, h2, w2, c, h, w, radius,
                             stream);
}

extern "C" int sample_window_bwd_bf16(const void* dout, const void* coords,
                                      void* df2, int b, int h2, int w2, int c,
                                      int h, int w, int radius, void* stream) {
  return launch<__nv_bfloat16, true>(dout, coords, df2, b, h2, w2, c, h, w,
                                     radius, stream);
}

// convex_combine_8x: RAFT convex-upsampling combine, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels raft_meets_dicl_tpu/ops/pallas.py::_fwd_kernel
// (launched by _run_fwd, reached through _combine and convex_combine_8x)
// and ::_bwd_kernel (launched by _run_bwd, reached through _combine_bwd).
//
// What the forward computes, per row m (one coarse pixel of one iteration's flow):
//   x[k, s]   = logits[m, k*64 + s] * inv_temp          k < 9 neighbours, s < 64 sub-pixels
//   p[k, s]   = softmax_k(x[k, s])                       (max-subtracted, float32)
//   out[m, c*64 + s] = sum_k p[k, s] * win[m, k*2 + c]   c < 2 flow channels
// logits are float32 or bfloat16, win and out float32.
//
// The backward takes dout = d(loss)/d(out) (float32) and recomputes p from
// the saved logits instead of storing it:
//   dp[k, s]  = dout[m, s] * win[m, 2k] + dout[m, 64 + s] * win[m, 2k + 1]
//   dlogits[m, k*64 + s] = p[k, s] * (dp[k, s] - sum_j p[j, s] * dp[j, s]) * inv_temp
//                          (stored in the logits' dtype, rounded to nearest)
//   dwin[m, 2k + c]      = sum_s p[k, s] * dout[m, c*64 + s]             (float32)
//
// Bound: memory, both ways. The forward reads 576 logits and 18 window
// values and writes 128 outputs per row (2,888 B in f32, 1,736 B with bf16
// logits); the backward reads logits, window and dout and writes dlogits
// and dwin (5,264 B in f32, 2,960 B with bf16 logits). Either does a few
// hundred flops per row's sub-pixel at most, far below the card's
// operations-per-byte ridge, so the least time is bytes / 3.35 TB/s.
//
// Design: one thread per (row, sub-pixel s), 64 threads a row, 4 rows in a
// block of 256. A thread reads its 9 logits at k*64 + s, so the 32 threads
// of a warp read 32 neighbouring elements per k (coalesced). The block's
// 4 x 18 window values are one contiguous 288-byte read into shared memory.
// Each thread keeps its 9 values in registers, takes max, exps and sum in
// float32 and writes out[m, s] and out[m, 64 + s] (coalesced). The
// backward's thread writes its 9 dlogits the same way; dwin, a sum over a
// row's 64 sub-pixels, is a warp-shuffle sum inside each of the row's two
// warps (a row never straddles a warp) and one add of the two warps'
// partials through shared memory, so no atomics are needed. Nothing but the
// inputs and the outputs touches device memory; the ragged last block is
// masked. Launches go on the caller's stream, do not synchronise and
// allocate nothing; the C entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNeighbours = 9;
constexpr int kSub = 64;
constexpr int kChan = 2;
constexpr int kRowsPerBlock = 4;
constexpr int kThreads = kSub * kRowsPerBlock;
constexpr int kWin = kNeighbours * kChan;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convex_combine_8x_fwd_kernel(const T* __restrict__ logits,
                             const float* __restrict__ win,
                             float* __restrict__ out, int64_t rows,
                             float inv_temp) {
  __shared__ float swin[kRowsPerBlock * kWin];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int tid = threadIdx.x;
  if (tid < kRowsPerBlock * kWin && row0 + tid / kWin < rows) {
    swin[tid] = __ldg(win + row0 * kWin + tid);
  }
  __syncthreads();

  const int r = tid / kSub;
  const int s = tid % kSub;
  const int64_t row = row0 + r;
  if (row >= rows) return;

  const T* lg = logits + row * (kNeighbours * kSub) + s;
  float x[kNeighbours];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kNeighbours; ++k) {
    x[k] = load_f32(lg + k * kSub) * inv_temp;
    m = fmaxf(m, x[k]);
  }

  const float* w = swin + r * kWin;
  float denom = 0.0f;
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int k = 0; k < kNeighbours; ++k) {
    const float e = expf(x[k] - m);
    denom += e;
    acc0 += e * w[2 * k];
    acc1 += e * w[2 * k + 1];
  }

  const float inv = 1.0f / denom;
  float* o = out + row * (kChan * kSub) + s;
  o[0] = acc0 * inv;
  o[kSub] = acc1 * inv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convex_combine_8x_bwd_kernel(const T* __restrict__ logits,
                             const float* __restrict__ win,
                             const float* __restrict__ dout,
                             T* __restrict__ dlogits,
                             float* __restrict__ dwin, int64_t rows,
                             float inv_temp) {
  __shared__ float swin[kRowsPerBlock * kWin];
  // per warp (two a row): its 18 partial dwin sums
  __shared__ float spart[kThreads / 32 * kWin];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int tid = threadIdx.x;
  if (tid < kRowsPerBlock * kWin && row0 + tid / kWin < rows) {
    swin[tid] = __ldg(win + row0 * kWin + tid);
  }
  __syncthreads();

  const int r = tid / kSub;
  const int s = tid % kSub;
  const int64_t row = row0 + r;

  // every thread reaches the shuffles and barriers below; a row past the
  // end contributes zeros and writes nothing
  float dw[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) dw[j] = 0.0f;

  if (row < rows) {
    const T* lg = logits + row * (kNeighbours * kSub) + s;
    float x[kNeighbours];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kNeighbours; ++k) {
      x[k] = load_f32(lg + k * kSub) * inv_temp;
      m = fmaxf(m, x[k]);
    }
    float denom = 0.0f;
#pragma unroll
    for (int k = 0; k < kNeighbours; ++k) {
      x[k] = expf(x[k] - m);
      denom += x[k];
    }
    const float inv = 1.0f / denom;

    const float* g = dout + row * (kChan * kSub) + s;
    const float d0 = __ldg(g);
    const float d1 = __ldg(g + kSub);
    const float* w = swin + r * kWin;

    float dp[kNeighbours];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kNeighbours; ++k) {
      x[k] *= inv;  // x now holds p[k, s]
      dp[k] = d0 * w[2 * k] + d1 * w[2 * k + 1];
      dot += x[k] * dp[k];
      dw[2 * k] = x[k] * d0;
      dw[2 * k + 1] = x[k] * d1;
    }

    T* dl = dlogits + row * (kNeighbours * kSub) + s;
#pragma unroll
    for (int k = 0; k < kNeighbours; ++k) {
      store_as(dl + k * kSub, x[k] * (dp[k] - dot) * inv_temp);
    }
  }

  // dwin: sum each partial over the warp's 32 sub-pixels ...
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    float v = dw[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    dw[j] = v;
  }
  const int warp = tid / 32;
  if (tid % 32 == 0) {
#pragma unroll
    for (int j = 0; j < kWin; ++j) spart[warp * kWin + j] = dw[j];
  }
  __syncthreads();

  // ... then add the row's two warps: one thread per (row, window value),
  // 4 x 18 contiguous floats per block
  if (tid < kRowsPerBlock * kWin) {
    const int rr = tid / kWin;
    const int j = tid % kWin;
    if (row0 + rr < rows) {
      dwin[(row0 + rr) * kWin + j] =
          spart[(2 * rr) * kWin + j] + spart[(2 * rr + 1) * kWin + j];
    }
  }
}

template <typename T>
int launch(const void* logits, const void* win, void* out, long long rows,
           float inv_temp, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    convex_combine_8x_fwd_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(logits), static_cast<const float*>(win),
            static_cast<float*>(out), static_cast<int64_t>(rows), inv_temp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const void* win, const void* dout,
               void* dlogits, void* dwin, long long rows, float inv_temp,
               void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    convex_combine_8x_bwd_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(logits), static_cast<const float*>(win),
            static_cast<const float*>(dout), static_cast<T*>(dlogits),
            static_cast<float*>(dwin), static_cast<int64_t>(rows), inv_temp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int convex_combine_8x_fwd_f32(const void* logits, const void* win,
                                         void* out, long long rows,
                                         float inv_temp, void* stream) {
  return launch<float>(logits, win, out, rows, inv_temp, stream);
}

extern "C" int convex_combine_8x_fwd_bf16(const void* logits, const void* win,
                                          void* out, long long rows,
                                          float inv_temp, void* stream) {
  return launch<__nv_bfloat16>(logits, win, out, rows, inv_temp, stream);
}

extern "C" int convex_combine_8x_bwd_f32(const void* logits, const void* win,
                                         const void* dout, void* dlogits,
                                         void* dwin, long long rows,
                                         float inv_temp, void* stream) {
  return launch_bwd<float>(logits, win, dout, dlogits, dwin, rows, inv_temp,
                           stream);
}

extern "C" int convex_combine_8x_bwd_bf16(const void* logits, const void* win,
                                          const void* dout, void* dlogits,
                                          void* dwin, long long rows,
                                          float inv_temp, void* stream) {
  return launch_bwd<__nv_bfloat16>(logits, win, dout, dlogits, dwin, rows,
                                   inv_temp, stream);
}

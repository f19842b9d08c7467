// convex_combine_8x: RAFT convex-upsampling combine, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_meets_dicl_tpu/ops/pallas.py::_fwd_kernel
// (launched by _run_fwd, reached through _combine and convex_combine_8x).
//
// What it computes, per row m (one coarse pixel of one iteration's flow):
//   x[k, s]   = logits[m, k*64 + s] * inv_temp          k < 9 neighbours, s < 64 sub-pixels
//   p[k, s]   = softmax_k(x[k, s])                       (max-subtracted, float32)
//   out[m, c*64 + s] = sum_k p[k, s] * win[m, k*2 + c]   c < 2 flow channels
// logits are float32 or bfloat16, win and out float32.
//
// Bound: memory. Each row reads 576 logits and 18 window values and writes
// 128 outputs (2,888 B in f32, 1,736 B with bf16 logits) for about 9 exps
// and 60 flops per sub-pixel, far below the card's operations-per-byte
// ridge, so the least time is bytes / 3.35 TB/s.
//
// Design: one thread per (row, sub-pixel s), 64 threads a row, 4 rows in a
// block of 256. A thread reads its 9 logits at k*64 + s, so the 32 threads
// of a warp read 32 neighbouring elements per k (coalesced). The block's
// 4 x 18 window values are one contiguous 288-byte read into shared memory.
// Each thread keeps its 9 values in registers, takes max, exps and sum in
// float32 and writes out[m, s] and out[m, 64 + s] (coalesced). Nothing but
// the inputs and the output touches device memory; the ragged last block is
// masked. The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().

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

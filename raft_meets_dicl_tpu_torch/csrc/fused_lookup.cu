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
// Design: a block takes a few positions (ppb, chosen by the launcher so
// that ppb·W2 fills about three passes of its 256 threads); a thread owns
// one (position, column w) pair per pass and keeps K float32 accumulators.
// The rows of wy are staged in shared memory as float32, kHChunk rows at a
// time for every position of the block (a padded stride keeps two
// positions' rows in different banks); then each thread streams its
// column of corr down the chunk, one coalesced load a row (neighbouring
// threads, neighbouring w), and adds K products with the wy values of that
// row (a broadcast read: the threads of one position read one address).
// Stage 1 writes its K values, coalesced along w. The fused kernel instead
// rounds them to the inputs' dtype into a shared (ppb, K, W2) tile, stages
// wx beside it, and one thread per output (position, k, a) sums the W2
// products from shared memory (row strides odd, so the K rows a warp reads
// fall in different banks); the (K, W2) intermediate never reaches device
// memory. Launches go on the caller's stream, do not synchronise and
// allocate nothing; the C entry points return cudaGetLastError(), or
// cudaErrorInvalidValue for K other than kK (radius 4, every shipped
// config's) or a fused tile larger than the card's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 9;          // window rows (2 * radius + 1, radius 4)
constexpr int kThreads = 256;  // threads a block
constexpr int kHChunk = 32;    // rows of wy staged at a time
constexpr int kMaxPositions = 16;  // positions a block, at most
// floats of one position's staged wy chunk; the +1 moves the next
// position's rows to other banks
constexpr int kWyStride = kK * kHChunk + 1;
constexpr int kMaxSharedBytes = 232448;  // a block's limit on Hopper

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

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const T* __restrict__ wy, const T* __restrict__ corr,
                  const T* __restrict__ wx, float* __restrict__ out,
                  long long n, int h2, int w2, int ppb) {
  extern __shared__ float smem[];
  float* s_wy = smem;                     // (ppb, kWyStride)
  float* s_t = smem + ppb * kWyStride;    // fused: (ppb, K, ws)
  const int ws = tile_stride(w2);
  float* s_wx = s_t + ppb * kK * ws;      // fused: (ppb, K, ws)

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
      if (kFused) {
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          s_t[(pl * kK + k) * ws + col] = round_as(acc[k], wy);
        }
      } else {
        float* o = out + ((p0 + pl) * kK) * w2 + col;
#pragma unroll
        for (int k = 0; k < kK; ++k) o[k * w2] = acc[k];
      }
    }
  }

  if (kFused) {
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
}

// positions a block: about three passes of its threads, at most
// kMaxPositions, and (fused) as many as fit the shared memory
int positions_per_block(int w2, bool fused) {
  int ppb = 3 * kThreads / w2;
  ppb = ppb < 1 ? 1 : (ppb > kMaxPositions ? kMaxPositions : ppb);
  if (fused) {
    const int per = (kWyStride + 2 * kK * tile_stride(w2)) * 4;
    while (ppb > 1 && ppb * per > 48 * 1024) --ppb;
  }
  return ppb;
}

template <typename T, bool kFused>
int launch(const void* wy, const void* corr, const void* wx, void* out,
           long long n, int k, int h2, int w2, void* stream) {
  if (k != kK || h2 < 1 || w2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int ppb = positions_per_block(w2, kFused);
    const size_t smem =
        static_cast<size_t>(ppb) *
        (kWyStride + (kFused ? 2 * kK * tile_stride(w2) : 0)) * sizeof(float);
    if (smem > static_cast<size_t>(kMaxSharedBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          lookup_kernel<T, kFused>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks = (n + ppb - 1) / ppb;
    lookup_kernel<T, kFused>
        <<<static_cast<unsigned int>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(wy), static_cast<const T*>(corr),
            static_cast<const T*>(wx), static_cast<float*>(out), n, h2, w2,
            ppb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lookup_stage1_f32(const void* wy, const void* corr, void* out,
                                 long long n, int k, int h2, int w2,
                                 void* stream) {
  return launch<float, false>(wy, corr, nullptr, out, n, k, h2, w2, stream);
}

extern "C" int lookup_stage1_bf16(const void* wy, const void* corr,
                                  void* out, long long n, int k, int h2,
                                  int w2, void* stream) {
  return launch<__nv_bfloat16, false>(wy, corr, nullptr, out, n, k, h2, w2,
                                      stream);
}

extern "C" int lookup_fused_f32(const void* wy, const void* corr,
                                const void* wx, void* out, long long n, int k,
                                int h2, int w2, void* stream) {
  return launch<float, true>(wy, corr, wx, out, n, k, h2, w2, stream);
}

extern "C" int lookup_fused_bf16(const void* wy, const void* corr,
                                 const void* wx, void* out, long long n,
                                 int k, int h2, int w2, void* stream) {
  return launch<__nv_bfloat16, true>(wy, corr, wx, out, n, k, h2, w2,
                                     stream);
}

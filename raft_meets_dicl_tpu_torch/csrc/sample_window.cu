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
// The backward takes dout = d(loss)/d(out) in f2's dtype and gives each
// tap its share, the transpose of both lerps,
//   df2[b, y0 + ty, x0 + tx, c] = sum over the positions whose window holds
//     the tap, and du in {tx-1, tx}, dv in {ty-1, ty}, of
//     wx(du, tx) * wy(dv, ty) * dout[b, du, dv, y, x, c]
// (wx = 1 - fx where du = tx, fx where du = tx - 1; wy likewise), float32,
// cast by the caller to f2's dtype. Coordinates get no gradient.
//
// Bound: memory, both ways. The forward reads f2 once and the coords, and
// writes K^2 values per position and channel: at K = 9 and C = 32 that is
// 10,368 B per position in f32 (5,184 B in bf16) against a few hundred
// bytes of f2 it needs, and 4 flops per output value, far below the card's
// operations-per-byte ridge, so the least time is bytes / 3.35 TB/s. The
// backward reads the same dout bytes and writes df2 (81x smaller).
//
// Forward design: one warp per position, one lane per channel (a loop over
// chunks of 32 for C > 32, masked for the ragged chunk); 8 positions per
// block. Neighbouring warps hold neighbouring positions, so their (K+1)^2
// taps overlap and come from L1/L2; each tap load is 32 consecutive
// channels (128 B in f32). It walks the tap rows: it keeps the previous
// row's K+1 values in registers, lerps y against the current row and
// writes the K outputs of that displacement row, each a coalesced
// 32-channel store (128 B in f32) next to the neighbouring positions' store
// for the same (du, dv).
//
// Backward design: every df2 element is summed in an order fixed by the
// inputs alone, with no float atomics, so two runs give the same bits (as
// the TPU kernel, which adds each position's patch into a VMEM-resident df2
// in grid order). Four kernels:
// - rank (one block of 1024 threads a segment of 1024 positions of an
//   image): each position's cell is its clamped floor(centre), as
//   window_at computes it. Each lane takes its rank among its warp's equal
//   cells (__match_any_sync), and warp 0 adds the warps' counts into a
//   shared counter per cell (up to 40,960 cells a pass) warp after warp:
//   the position's rank among the segment's positions of its cell, in
//   position order, the segment's count of every cell, and (an integer
//   add a cell and segment, which only counts) the image's total.
// - bucket (one block an image): per cell, its start (an exclusive scan
//   of the totals). Then the
//   work: f2 is cut into tiles of 2 x 2 quads (2 x 2 pixels each); the
//   positions whose window reaches a tile are those whose cell lies in the
//   (th + K) x (tw + K) cells from the tile's corner - (R + 1), i.e.
//   th + K contiguous ranges of the records (one a cell row). A tile's
//   list is cut into chunks of one size, a power of two from 32 to kChunk
//   = 256 entries, the smallest that makes about kTargetBlocks items a
//   launch where the tiles alone make fewer than half that; a work item is
//   one chunk of one tile (an empty tile still gets one, which writes its
//   zeros).
// - place (a block a segment): each position's record (index, window
//   corner, fractions: 16 B) goes to its slot, so the records run in order
//   of cell, and within a cell in order of position.
// - Small images skip those three: where an image has at most kDirectPairs
//   (tile, position) pairs or at most kDirectPositions positions, a work
//   item is one tile and one range of positions, whose windows that reach
//   the tile it finds itself, in position order (direct mode, one launch).
// - pull (a block of 4 warps a work item, a warp a quad): the block copies
//   the chunk's records (direct: its range's windows that reach the tile)
//   to shared memory; each warp keeps, in list order, the entries whose
//   window reaches its quad. Its lanes split into groups of LP lanes, LP a
//   power of two >= the channel vectors C / V (V = 16 B of the dtype: 4
//   channels in f32, 8 in bf16; 1 for a C that V does not divide, or an
//   unaligned pointer); group g takes the warp's entries g, g + 32/LP, ...
//   For each it loads the 3 x 3 (du, dv) vectors that reach
//   the quad (16-B loads, whole 32-B sectors: 128 B of a position's (du,
//   dv) in f32 at C = 32), runs the x lerp's transpose then the y lerp's
//   and adds into the quad's 4 pixels in registers. The groups' sums are
//   added by a fixed butterfly of shuffles (a + b = b + a bit for bit, so
//   every group holds the same result) and group 0 writes the quad: into
//   df2 for a one-chunk tile (no zeroing pass), else into a partial in
//   scratch (none for a chunk with no entry); the block that finishes a
//   tile's chunks last (an integer counter, which only counts) adds the
//   partials in chunk order.
// Each (du, dv) vector reaches up to 4 quads (2.25 on average), and each
// loads it: the repeats are left to L1/L2. The scratch is the records (16 B
// a position), the counts and lists, and the partials (64 C B an item).
// Out-of-bounds taps are neither read nor written. Launches go on the
// caller's stream and do not synchronise; the backward's scratch is a
// workspace the caller allocates (sample_window_bwd_workspace gives its
// size). The C entry points return cudaGetLastError() after each launch,
// or cudaErrorInvalidValue for a radius other than kRadius, the one the
// kernels are instantiated for (every shipped config's corr-radius).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

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
void launch_fwd_r(const void* f2, const void* coords, void* out, int b,
                  int h2, int w2, int c, int h, int w, cudaStream_t stream) {
  const long long positions = static_cast<long long>(b) * h * w;
  const long long blocks = (positions + kWarps - 1) / kWarps;
  sample_window_fwd_kernel<T, R>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(f2), static_cast<const float*>(coords),
          static_cast<T*>(out), b, h2, w2, c, h, w);
}

// -- backward ----------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBucketThreads = 1024;  // the bucket kernel's block (an image)
constexpr int kScanSpan = 9 * kBucketThreads;  // cells a scan step takes
constexpr int kMaxKeySpan = 40960;    // cells a pass keeps in shared memory
constexpr int kTileQX = 2;            // quads of a pixel tile, per row
constexpr int kTileQY = 2;            // and per column
constexpr int kTileW = 2 * kTileQX;   // the tile's pixels: 4 wide
constexpr int kTileH = 2 * kTileQY;   // 4 high
constexpr int kPullWarps = kTileQX * kTileQY;  // a warp a quad
constexpr int kPullThreads = 32 * kPullWarps;
constexpr int kPullBlocksF32 = 5;     // pull blocks an SM holds, at least:
constexpr int kPullBlocksBf16 = 4;    // as many as fit without spilling
constexpr int kChunk = 256;           // list entries a work item, at most
constexpr int kMinChunk = 32;         // and at least, where a list has them
constexpr int kTargetBlocks = 2048;   // bucketed: items a launch aims at
constexpr int kDirectBlocks = 660;    // direct: items a launch aims at (one
                                      // wave of 5 blocks an SM on an H100)
// images with at most this many (tile, position) pairs, or at most this
// many positions, skip the bucketing: each item scans a range of positions
// for the windows that reach its tile
constexpr long long kDirectPairs = 65536;
constexpr int kDirectPositions = 1024;

// the backward's shapes and the workspace's layout, computed on the host
struct BwdGeom {
  int h2, w2, c, hw;
  int ncx, ncell;      // cells a row, cells an image (the clamped range)
  int tiles_x, ntiles; // pixel tiles a row, tiles an image
  int direct;          // 1: no bucketing, items are (tile, position range)
  int ranges, range;   // direct: position ranges a tile, positions a range
  int aim;             // bucketed: items an image the chunk size aims at
  int imax;            // work items an image, at most
  int cv, lp, passes;  // channel vectors, lanes a group, channel passes
  int segments;        // rank blocks an image: kBucketThreads positions each
  int key_span;        // cells a bucketing pass counts (1 pass: ncell + 1)
  // byte offsets into the workspace, and its size
  long long rank, counts, totals, starts, records, tfirst, tchunks, tdone,
      titems, items, ientries, partials, bytes;
};

template <int R>
BwdGeom bwd_geom(int b, int h2, int w2, int c, int h, int w, int v) {
  auto align = [](long long x) { return (x + 255) / 256 * 256; };
  BwdGeom g;
  g.h2 = h2;
  g.w2 = w2;
  g.c = c;
  g.hw = h * w;
  g.ncx = w2 + 2 * R + 2;
  g.ncell = (h2 + 2 * R + 2) * g.ncx;
  g.tiles_x = (w2 + kTileW - 1) / kTileW;
  const int tiles_y = (h2 + kTileH - 1) / kTileH;
  g.ntiles = g.tiles_x * tiles_y;
  // each tile's list is cut into chunks of the same size, at least
  // kMinChunk and at most kChunk entries, as small as makes aim items
  // an image (the bucket kernel picks it): at most aim + ntiles items,
  // or where the lists outgrow aim chunks of kChunk, ntiles + their
  // entries / kChunk. A window's K + 1 taps a side touch at most K / side
  // + 2 tiles across and down
  const int fill = (kTargetBlocks + b - 1) / b;
  const bool enough = static_cast<long long>(b) * g.ntiles >= kTargetBlocks / 2;
  g.aim = enough || g.ntiles > fill ? g.ntiles : fill;
  constexpr int across = (2 * R + 1) / kTileW + 2;
  constexpr int down = (2 * R + 1) / kTileH + 2;
  const long long touch =
      static_cast<long long>(g.tiles_x < across ? g.tiles_x : across) *
      (tiles_y < down ? tiles_y : down);
  const long long most = (touch * g.hw + kChunk - 1) / kChunk;
  long long imax = g.ntiles + (most > g.aim ? most : g.aim);
  // direct: as many ranges a tile as make kDirectBlocks items, each of
  // kMinChunk to kChunk positions
  g.direct = static_cast<long long>(g.ntiles) * g.hw <= kDirectPairs ||
             g.hw <= kDirectPositions;
  g.ranges = 1;
  g.range = g.hw;
  if (g.direct) {
    const int few = (g.hw + kChunk - 1) / kChunk;
    const int many = (g.hw + kMinChunk - 1) / kMinChunk;
    const long long want =
        kDirectBlocks / (static_cast<long long>(b) * g.ntiles);
    g.ranges = want < few ? few : want > many ? many : static_cast<int>(want);
    g.range = (g.hw + g.ranges - 1) / g.ranges;
    imax = static_cast<long long>(g.ntiles) * g.ranges;
  }
  g.imax = imax < INT_MAX / 2 ? static_cast<int>(imax) : -1;
  g.cv = c / v;
  g.lp = 1;
  while (g.lp < g.cv && g.lp < 32) g.lp *= 2;
  g.passes = (g.cv + g.lp - 1) / g.lp;
  g.segments = (g.hw + kBucketThreads - 1) / kBucketThreads;
  g.key_span = g.ncell + 1 < kMaxKeySpan ? g.ncell + 1 : kMaxKeySpan;
  const long long sorted = g.direct ? 0 : 1;  // the bucketing's arrays
  long long off = 0;
  g.rank = off;
  off = align(off + sorted * 4LL * b * g.hw);
  g.counts = off;
  off = align(off + sorted * 4LL * b * g.segments * g.ncell);
  g.totals = off;
  off = align(off + sorted * 4LL * b * g.ncell);
  g.starts = off;
  off = align(off + sorted * 4LL * b * (g.ncell + 1));
  g.records = off;
  off = align(off + sorted * 16LL * b * g.hw);
  g.tfirst = off;
  off = align(off + 4LL * b * g.ntiles);
  g.tchunks = off;
  off = align(off + 4LL * b * g.ntiles);
  g.tdone = off;
  off = align(off + 4LL * b * g.ntiles);
  g.titems = off;
  off = align(off + sorted * 4LL * b * (g.imax > 0 ? g.imax : 0));
  g.items = off;
  off = align(off + 8LL * b);  // items and chunk size, an image
  g.ientries = off;
  off = align(off + 4LL * b * (g.imax > 0 ? g.imax : 0));
  g.partials = off;
  off = align(off + 4LL * kTileW * kTileH * c * b * (g.imax > 0 ? g.imax : 0));
  g.bytes = off;
  return g;
}

template <typename U>
__device__ __forceinline__ U* ws_at(void* ws, long long off) {
  return reinterpret_cast<U*>(static_cast<char*>(ws) + off);
}

// exclusive scan of one int a thread over the block (a multiple of 32
// threads); ``total`` gets the sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    tmp[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? tmp[warp - 1] : 0;
  total = tmp[warps - 1];
  __syncthreads();
  return before + incl - v;
}

// a tile's pixels within f2 and its list's cell rows: the rows
// [py0, py0 + th + 2R] of cells, each the cells [px0, px0 + tw + 2R]
struct Tile {
  int px0, py0, tw, th;
};

__device__ __forceinline__ Tile tile_at(int t, const BwdGeom& g) {
  Tile tl;
  tl.px0 = (t % g.tiles_x) * kTileW;
  tl.py0 = (t / g.tiles_x) * kTileH;
  tl.tw = min(kTileW, g.w2 - tl.px0);
  tl.th = min(kTileH, g.h2 - tl.py0);
  return tl;
}

// a position's window and cell: the window's corner shifted into
// [0, ncx) x [0, ncy)
template <int R>
__device__ __forceinline__ int cell_at(const float* __restrict__ coords,
                                       int64_t pos, const BwdGeom& g,
                                       Window& win) {
  win = window_at<R>(coords, pos, g.h2, g.w2);
  return (win.y0 + 2 * R + 1) * g.ncx + win.x0 + 2 * R + 1;
}

// a position's record: its index in the image, its window's corner (two
// 16-bit halves: y0 high, x0 low) and fractions
__device__ __forceinline__ int4 record_of(int p, const Window& win) {
  const unsigned xy = (static_cast<unsigned>(win.y0) << 16) |
                      (static_cast<unsigned>(win.x0) & 0xffffu);
  return make_int4(p, static_cast<int>(xy), __float_as_int(win.fx),
                   __float_as_int(win.fy));
}

// the window corner of a record
__device__ __forceinline__ int record_x0(const int4& rec) {
  return static_cast<int>(static_cast<short>(rec.y & 0xffff));
}

__device__ __forceinline__ int record_y0(const int4& rec) {
  return rec.y >> 16;
}

// one block a segment of kBucketThreads positions of an image: each
// position's rank among the segment's positions of its cell (in position
// order) and the segment's count of every cell. A lane's rank among its
// warp's equal cells comes from __match_any_sync; warp 0 adds the warps'
// counts into a shared counter per cell warp after warp (key_span cells a
// pass)
template <int R>
__global__ void __launch_bounds__(kBucketThreads)
sample_window_rank_kernel(const float* __restrict__ coords, BwdGeom g,
                          void* ws) {
  extern __shared__ int count[];  // key_span cells
  __shared__ int lead_key[kBucketThreads / 32][32];
  __shared__ int lead_n[kBucketThreads / 32][32];
  const int seg = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = seg * kBucketThreads;
  const int p = base + tid;
  int* counts = ws_at<int>(ws, g.counts) +
                (static_cast<int64_t>(bi) * g.segments + seg) * g.ncell;
  int cell = -1;
  if (p < g.hw) {
    Window win;
    cell = cell_at<R>(coords, static_cast<int64_t>(bi) * g.hw + p, g, win);
  }
  const int warps = (min(kBucketThreads, g.hw - base) + 31) / 32;
  for (int k0 = 0; k0 < g.ncell; k0 += g.key_span) {
    const int keys = min(g.key_span, g.ncell - k0);
    for (int k = tid; k < keys; k += kBucketThreads) count[k] = 0;
    const int key = cell >= k0 && cell < k0 + keys ? cell - k0 : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const unsigned lower = peers & ((1u << lane) - 1u);
    lead_key[warp][lane] = key >= 0 && lower == 0 ? key : -1;
    lead_n[warp][lane] = __popc(peers);
    __syncthreads();
    if (warp == 0) {
      // a warp's leaders hold distinct cells: no two lanes meet
      for (int w = 0; w < warps; ++w) {
        const int k = lead_key[w][lane];
        if (k >= 0) {
          const int so_far = count[k];
          count[k] = so_far + lead_n[w][lane];
          lead_n[w][lane] = so_far;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (key >= 0) {
      ws_at<int>(ws, g.rank)[static_cast<int64_t>(bi) * g.hw + p] =
          lead_n[warp][__ffs(peers) - 1] + __popc(lower);
    }
    // the segment's counts, and the image's totals (integer adds, which
    // only count: their order does not matter)
    int* totals = ws_at<int>(ws, g.totals) + static_cast<int64_t>(bi) * g.ncell;
    for (int k = tid; k < keys; k += kBucketThreads) {
      const int n = count[k];
      counts[k0 + k] = n;
      if (n) atomicAdd(totals + k0 + k, n);
    }
    __syncthreads();
  }
}

// one block an image: the cells' starts (the positions sorted by cell),
// each tile's chunks and the work items
template <int R>
__global__ void __launch_bounds__(kBucketThreads)
sample_window_bucket_kernel(BwdGeom g, void* ws) {
  extern __shared__ int starts_s[];  // key_span cells
  __shared__ int tmp[32];
  const int bi = blockIdx.x;
  const int tid = threadIdx.x;
  const int* totals =
      ws_at<const int>(ws, g.totals) + static_cast<int64_t>(bi) * g.ncell;
  int* starts = ws_at<int>(ws, g.starts) +
                static_cast<int64_t>(bi) * (g.ncell + 1);

  // per cell: its start, the exclusive scan of the totals; a pass keeps
  // key_span cells in shared memory, a scan step takes kScanSpan of them
  constexpr int per = kScanSpan / kBucketThreads;
  int placed = 0;
  for (int k0 = 0; k0 < g.ncell; k0 += g.key_span) {
    const int pass_keys = min(g.key_span, g.ncell - k0);
    for (int s0 = 0; s0 < pass_keys; s0 += kScanSpan) {
      const int keys = min(kScanSpan, pass_keys - s0);
      const int64_t first = k0 + s0;
      // the cells' totals into shared memory (coalesced)
      for (int k = tid; k < keys; k += kBucketThreads) {
        starts_s[s0 + k] = totals[first + k];
      }
      __syncthreads();
      // the step's starts: an exclusive scan, a thread per per consecutive
      // cells
      int mine[per];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const int k = tid * per + j;
        mine[j] = k < keys ? starts_s[s0 + k] : 0;
        sum += mine[j];
      }
      int total;
      int at = placed + block_exclusive_scan(sum, tmp, total);
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const int k = tid * per + j;
        if (k < keys) starts_s[s0 + k] = at;
        at += mine[j];
      }
      placed += total;
      __syncthreads();
    }
    // to the workspace, coalesced (and kept in shared memory for the work
    // list when one pass holds every cell)
    for (int k = tid; k < pass_keys; k += kBucketThreads) {
      starts[k0 + k] = starts_s[k];
    }
    __syncthreads();
  }
  const bool one_pass = g.ncell < g.key_span;
  if (tid == 0) {
    starts[g.ncell] = placed;
    if (one_pass) starts_s[g.ncell] = placed;
  }
  __syncthreads();
  const int* cs = one_pass ? starts_s : starts;

  // the work: each tile gets max(1, ceil(n / chunk)) items, n the length
  // of its list, chunk the power of two in [kMinChunk, kChunk] nearest
  // above (the lists' total) / aim
  const int64_t tbase = static_cast<int64_t>(bi) * g.ntiles;
  int* tfirst = ws_at<int>(ws, g.tfirst) + tbase;
  int* tchunks = ws_at<int>(ws, g.tchunks) + tbase;
  int* tdone = ws_at<int>(ws, g.tdone) + tbase;
  int* titems = ws_at<int>(ws, g.titems) + static_cast<int64_t>(bi) * g.imax;
  auto list_length = [&](int t) {
    const Tile tl = tile_at(t, g);
    int n = 0;
#pragma unroll
    for (int j = 0; j < kTileH + 2 * R + 1; ++j) {
      if (j < tl.th + 2 * R + 1) {
        const int row = (tl.py0 + j) * g.ncx + tl.px0;
        n += cs[row + tl.tw + 2 * R + 1] - cs[row];
      }
    }
    return n;
  };
  int entries = 0;
  for (int t = tid; t < g.ntiles; t += kBucketThreads) {
    entries += list_length(t);
  }
  int all_entries;
  block_exclusive_scan(entries, tmp, all_entries);
  int chunk = kMinChunk;
  while (chunk < kChunk &&
         static_cast<long long>(chunk) * g.aim < all_entries) {
    chunk *= 2;
  }
  int items = 0;
  for (int base = 0; base < g.ntiles; base += kBucketThreads) {
    const int t = base + tid;
    int chunks = 0;
    if (t < g.ntiles) {
      const int n = list_length(t);
      chunks = n > chunk ? (n + chunk - 1) / chunk : 1;
    }
    int total;
    const int first = items + block_exclusive_scan(chunks, tmp, total);
    if (t < g.ntiles) {
      tfirst[t] = first;
      tchunks[t] = chunks;
      tdone[t] = 0;
      for (int i = 0; i < chunks; ++i) titems[first + i] = t;
    }
    items += total;
  }
  if (tid == 0) ws_at<int>(ws, g.items)[2 * bi + 1] = chunk;
  if (tid == 0) ws_at<int>(ws, g.items)[2 * bi] = items;
}

// one block a segment of kBucketThreads positions of an image: each
// position's record into its slot, the cell's start + the earlier
// segments' count of the cell + the position's rank among the segment's
template <int R>
__global__ void __launch_bounds__(kBucketThreads)
sample_window_place_kernel(const float* __restrict__ coords, BwdGeom g,
                           void* ws) {
  const int seg = blockIdx.x;
  const int bi = blockIdx.y;
  const int p = seg * kBucketThreads + threadIdx.x;
  if (p >= g.hw) return;
  const int64_t pos0 = static_cast<int64_t>(bi) * g.hw;
  Window win;
  const int cell = cell_at<R>(coords, pos0 + p, g, win);
  const int* starts = ws_at<const int>(ws, g.starts) +
                      static_cast<int64_t>(bi) * (g.ncell + 1);
  const int* counts = ws_at<const int>(ws, g.counts) +
                      static_cast<int64_t>(bi) * g.segments * g.ncell + cell;
  int slot = starts[cell] + ws_at<const int>(ws, g.rank)[pos0 + p];
#pragma unroll 4
  for (int sg = 0; sg < seg; ++sg) {
    slot += counts[sg * static_cast<int64_t>(g.ncell)];
  }
  ws_at<int4>(ws, g.records)[pos0 + slot] = record_of(p, win);
}

// V channels of a (du, dv) vector of dout as float: 16 bytes where V > 1
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const float4*>(p))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ float at(const Raw& r, int v) {
    return v == 0 ? r.x : v == 1 ? r.y : v == 2 ? r.z : r.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ float at(const Raw& r, int v) {
    const unsigned word = v < 2 ? r.x : v < 4 ? r.y : v < 6 ? r.z : r.w;
    return __uint_as_float((v & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p, bool ok) {
    return ok ? load_f32(p) : 0.0f;
  }
  static __device__ __forceinline__ float at(const Raw& r, int) { return r; }
};

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec_cg(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldcg(p + i);
  }
}

// a block a work item: one chunk of one tile's list; a warp a quad of the
// tile (see the header)
template <typename T, int V, int R>
__global__ void __launch_bounds__(kPullThreads,
                                  sizeof(T) == 4 ? kPullBlocksF32
                                                 : kPullBlocksBf16)
sample_window_bwd_kernel(const T* __restrict__ dout,
                         const float* __restrict__ coords,
                         float* __restrict__ df2, BwdGeom g, void* ws) {
  constexpr int K = 2 * R + 1;
  __shared__ int4 s_rec[kChunk];
  __shared__ int s_list[kPullWarps][kChunk];
  __shared__ int s_last;
  __shared__ int s_hits[kPullWarps];

  const int bi = blockIdx.x;
  const int items = g.direct ? g.imax : ws_at<const int>(ws, g.items)[2 * bi];
  const int chunk =
      g.direct ? g.range : ws_at<const int>(ws, g.items)[2 * bi + 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the image's items (blocks past them return at once)
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    __syncthreads();  // the last item's records and lists are read
    const int64_t tbase = static_cast<int64_t>(bi) * g.ntiles;
    int t;
    int first;
    int chunks;
    if (g.direct) {
      t = item / g.ranges;
      first = t * g.ranges;
      chunks = g.ranges;
    } else {
      t = ws_at<const int>(ws, g.titems)[static_cast<int64_t>(bi) * g.imax +
                                         item];
      first = ws_at<const int>(ws, g.tfirst)[tbase + t];
      chunks = ws_at<const int>(ws, g.tchunks)[tbase + t];
    }
    const Tile tl = tile_at(t, g);
    const int qx = tl.px0 + 2 * (warp % kTileQX);
    const int qy = tl.py0 + 2 * (warp / kTileQX);
    const int begin = (item - first) * chunk;

    // the item's entries into shared memory, in a fixed order
    int count = 0;
    if (g.direct) {
      // the windows of positions [begin, begin + chunk) that reach the
      // tile, in position order
      const int span = min(chunk, g.hw - begin);
      for (int base = 0; base < span; base += kPullThreads) {
        bool hit = false;
        int4 rec;
        if (base + tid < span) {
          const int p = begin + base + tid;
          const Window win = window_at<R>(
              coords, static_cast<int64_t>(bi) * g.hw + p, g.h2, g.w2);
          hit = win.x0 <= tl.px0 + tl.tw - 1 && win.x0 + K >= tl.px0 &&
                win.y0 <= tl.py0 + tl.th - 1 && win.y0 + K >= tl.py0;
          rec = record_of(p, win);
        }
        const unsigned mask = __ballot_sync(kFull, hit);
        if (lane == 0) s_hits[warp] = __popc(mask);
        __syncthreads();
        int at = count + __popc(mask & ((1u << lane) - 1u));
        for (int w = 0; w < kPullWarps; ++w) {
          if (w < warp) at += s_hits[w];
          count += s_hits[w];
        }
        if (hit) s_rec[at] = rec;
        __syncthreads();
      }
    } else {
      // the tile's list: its cell rows, one range of records each
      const int* starts = ws_at<const int>(ws, g.starts) +
                          static_cast<int64_t>(bi) * (g.ncell + 1);
      constexpr int max_rows = kTileH + 2 * R + 1;
      const int rows = tl.th + 2 * R + 1;
      int row_first = 0;
      int row_len = 0;
      if (lane < rows) {
        const int row = (tl.py0 + lane) * g.ncx + tl.px0;
        row_first = starts[row];
        row_len = starts[row + tl.tw + 2 * R + 1] - row_first;
      }
      int row_end = row_len;  // the rows' inclusive scan: list index ends
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, row_end, o);
        if (lane >= o) row_end += x;
      }
      const int n = __shfl_sync(kFull, row_end, 31);
      count = min(chunk, n - begin);
      int ends[max_rows];
      int firsts[max_rows];
#pragma unroll
      for (int j = 0; j < max_rows; ++j) {
        ends[j] = __shfl_sync(kFull, row_end, j);
        firsts[j] = __shfl_sync(kFull, row_first, j);
      }
      const int4* records =
          ws_at<const int4>(ws, g.records) + static_cast<int64_t>(bi) * g.hw;
      for (int e = tid; e < count; e += kPullThreads) {
        const int at = begin + e;
        int slot = 0;
        int row_start = 0;
#pragma unroll
        for (int j = 0; j < max_rows; ++j) {
          if (j < rows && at >= row_start && at < ends[j]) {
            slot = firsts[j] + at - row_start;
          }
          row_start = ends[j];
        }
        s_rec[e] = records[slot];
      }
    }
    __syncthreads();

    const int group = lane / g.lp;
    const int groups = 32 / g.lp;
    const int in_group = lane - group * g.lp;
    const T* img = dout + static_cast<int64_t>(bi) * K * K * g.hw * g.c;
    const int hwc = g.hw * g.c;
    float* out = df2 + static_cast<int64_t>(bi) * g.h2 * g.w2 * g.c;
    float* part = ws_at<float>(ws, g.partials) +
                  (static_cast<int64_t>(bi) * g.imax + item) * kTileW *
                      kTileH * g.c;
    // this warp's entries: those whose window reaches its quad, in list order
    int* list = s_list[warp];
    int hits = 0;
    for (int base = 0; base < count; base += 32) {
      const int e = base + lane;
      bool hit = false;
      if (e < count) {
        const int x0 = record_x0(s_rec[e]);
        const int y0 = record_y0(s_rec[e]);
        hit = x0 <= qx + 1 && x0 + K >= qx && y0 <= qy + 1 && y0 + K >= qy;
      }
      const unsigned mask = __ballot_sync(kFull, hit);
      if (hit) list[hits + __popc(mask & ((1u << lane) - 1u))] = e;
      hits += __popc(mask);
    }
    __syncwarp();

    // an empty chunk of a tile of several writes no partial: the tile's
    // last block skips it
    const int64_t at_item = static_cast<int64_t>(bi) * g.imax + item;
    if (chunks > 1 && tid == 0) ws_at<int>(ws, g.ientries)[at_item] = count;
    using Raw = typename Vec<T, V>::Raw;
    const int passes = chunks > 1 && count == 0 ? 0 : g.passes;
    for (int pass = 0; pass < passes; ++pass) {
      const int vec = pass * g.lp + in_group;
      const bool lane_on = vec < g.cv;
      const int ch = vec * V;
      float acc[2][2][V];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][j][v] = 0.0f;

      // entry r's fractions and the 3 x 3 (du, dv) vectors that reach the
      // quad (zero where (du, dv) leaves the window)
      auto fetch = [&](int r, float& fx, float& fy, Raw (&d)[3][3]) {
        const int4 rec = s_rec[list[r]];
        const int x0 = record_x0(rec);
        const int y0 = record_y0(rec);
        fx = __int_as_float(rec.z);
        fy = __int_as_float(rec.w);
        // the quad's top-left tap in the window's tap grid
        const int a = qx - x0;
        const int c0 = qy - y0;
        const T* at = img + rec.x * g.c + ch;
#pragma unroll
        for (int r3 = 0; r3 < 3; ++r3) {
          const int dv = c0 - 1 + r3;
#pragma unroll
          for (int j3 = 0; j3 < 3; ++j3) {
            const int du = a - 1 + j3;
            const bool ok = lane_on && static_cast<unsigned>(du) < K &&
                            static_cast<unsigned>(dv) < K;
            d[r3][j3] = Vec<T, V>::load(at + (du * K + dv) * hwc, ok);
          }
        }
      };
      auto add = [&](float fx, float fy, const Raw (&d)[3][3]) {
        const float gx0 = 1.0f - fx;
        const float gy0 = 1.0f - fy;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          // x lerp's transpose: tap column a + j takes fx of du = a + j - 1
          // and 1 - fx of du = a + j
          float tx[3][2];
#pragma unroll
          for (int r3 = 0; r3 < 3; ++r3) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              tx[r3][j] = fx * Vec<T, V>::at(d[r3][j], v) +
                          gx0 * Vec<T, V>::at(d[r3][j + 1], v);
            }
          }
          // y lerp's: tap row c0 + i takes fy of dv = c0 + i - 1 and 1 - fy
          // of dv = c0 + i
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              acc[i][j][v] += fy * tx[i][j] + gy0 * tx[i + 1][j];
            }
          }
        }
      };
      // group g takes the warp's g-th, (g + groups)-th, ... entry
      for (int r = group; r < hits; r += groups) {
        float fx;
        float fy;
        Raw d[3][3];
        fetch(r, fx, fy, d);
        add(fx, fy, d);
      }

      // the groups' sums, added by a fixed butterfly: every group ends with
      // the same bits
      for (int o = g.lp; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[i][j][v] += __shfl_xor_sync(kFull, acc[i][j][v], o);
      }
      if (group == 0 && lane_on) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int y = qy + i;
            const int x = qx + j;
            if (chunks == 1) {
              if (y < g.h2 && x < g.w2) {
                store_vec<V>(out + (y * g.w2 + x) * g.c + ch, acc[i][j]);
              }
            } else {
              store_vec<V>(part + ((y - tl.py0) * kTileW + x - tl.px0) * g.c +
                               ch,
                           acc[i][j]);
            }
          }
        }
      }
    }
    if (chunks == 1) continue;

    // the tile's last block to finish adds its partials in chunk order
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      s_last = atomicAdd(ws_at<int>(ws, g.tdone) + tbase + t, 1) == chunks - 1;
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    const float* parts = ws_at<const float>(ws, g.partials) +
                         (static_cast<int64_t>(bi) * g.imax + first) * kTileW *
                             kTileH * g.c;
    const int* entries = ws_at<const int>(ws, g.ientries) +
                         static_cast<int64_t>(bi) * g.imax + first;
    const int tile_floats = kTileW * kTileH * g.c;
    for (int e = tid; e < kTileW * kTileH * g.cv; e += kPullThreads) {
      const int px = e / g.cv;
      const int ch = (e - px * g.cv) * V;
      const int y = tl.py0 + px / kTileW;
      const int x = tl.px0 + px % kTileW;
      if (y >= g.h2 || x >= g.w2) continue;
      float sum[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sum[v] = 0.0f;
      for (int k = 0; k < chunks; ++k) {
        if (__ldcg(entries + k) == 0) continue;
        float more[V];
        load_vec_cg<V>(parts + static_cast<int64_t>(k) * tile_floats +
                           px * g.c + ch,
                       more);
#pragma unroll
        for (int v = 0; v < V; ++v) sum[v] += more[v];
      }
      store_vec<V>(out + (y * g.w2 + x) * g.c + ch, sum);
    }
  }
}

template <typename T, int V, int R>
int launch_bwd_r(const void* dout, const void* coords, void* df2, void* ws,
                 const BwdGeom& g, int b, cudaStream_t stream) {
  cudaError_t err;
  if (g.direct) {
    // no bucket kernel: the tiles' counters start at 0 here
    err = cudaMemsetAsync(static_cast<char*>(ws) + g.tdone, 0,
                          4LL * b * g.ntiles, stream);
  } else {
    // a pass's cell counters: above 48 KB only with the attribute set
    const int smem = 4 * g.key_span;
    err = cudaFuncSetAttribute(sample_window_rank_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(sample_window_bucket_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 segments(g.segments, b);
    const float* c = static_cast<const float*>(coords);
    // the rank kernel adds into the totals
    err = cudaMemsetAsync(static_cast<char*>(ws) + g.totals, 0,
                          4LL * b * g.ncell, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    sample_window_rank_kernel<R>
        <<<segments, kBucketThreads, smem, stream>>>(c, g, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sample_window_bucket_kernel<R><<<b, kBucketThreads, smem, stream>>>(g,
                                                                       ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sample_window_place_kernel<R>
        <<<segments, kBucketThreads, 0, stream>>>(c, g, ws);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // item-major: the blocks past an image's items come last
  sample_window_bwd_kernel<T, V, R>
      <<<dim3(b, g.imax < 65535 ? g.imax : 65535), kPullThreads, 0,
         stream>>>(
          static_cast<const T*>(dout), static_cast<const float*>(coords),
          static_cast<float*>(df2), g, ws);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors where C and both pointers allow them, else one channel
template <typename T>
int vector_width(const void* dout, const void* df2, int c) {
  constexpr int v = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(df2) % 16 == 0;
  return aligned && c % v == 0 ? v : 1;
}

bool no_work(int b, int h2, int w2, int c, int h, int w) {
  return static_cast<long long>(b) * h * w * c == 0 ||
         static_cast<long long>(h2) * w2 == 0;
}

// the one radius instantiated; nothing is launched for an empty problem
template <typename T>
int launch_fwd(const void* f2, const void* coords, void* out, int b, int h2,
               int w2, int c, int h, int w, int radius, void* stream) {
  if (radius != kRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(b) * h * w * c > 0) {
    launch_fwd_r<T, kRadius>(f2, coords, out, b, h2, w2, c, h, w,
                             static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* dout, const void* coords, void* df2, void* ws,
               int b, int h2, int w2, int c, int h, int w, int radius,
               void* stream) {
  if (radius != kRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (no_work(b, h2, w2, c, h, w)) {
    return static_cast<int>(cudaGetLastError());
  }
  const int v = vector_width<T>(dout, df2, c);
  const BwdGeom g = bwd_geom<kRadius>(b, h2, w2, c, h, w, v);
  if (g.imax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (v == 1) {
    return launch_bwd_r<T, 1, kRadius>(dout, coords, df2, ws, g, b, s);
  }
  return launch_bwd_r<T, 16 / sizeof(T), kRadius>(dout, coords, df2, ws, g,
                                                  b, s);
}

}  // namespace

extern "C" int sample_window_fwd_f32(const void* f2, const void* coords,
                                     void* out, int b, int h2, int w2, int c,
                                     int h, int w, int radius, void* stream) {
  return launch_fwd<float>(f2, coords, out, b, h2, w2, c, h, w, radius,
                           stream);
}

extern "C" int sample_window_fwd_bf16(const void* f2, const void* coords,
                                      void* out, int b, int h2, int w2, int c,
                                      int h, int w, int radius, void* stream) {
  return launch_fwd<__nv_bfloat16>(f2, coords, out, b, h2, w2, c, h, w,
                                   radius, stream);
}

// bytes of workspace the backward needs (0 for an empty problem), or -1
// for a radius other than kRadius or a problem too large for its lists
extern "C" long long sample_window_bwd_workspace(int b, int h2, int w2, int c,
                                                 int h, int w, int radius) {
  if (radius != kRadius) return -1;
  if (no_work(b, h2, w2, c, h, w)) return 0;
  const BwdGeom g = bwd_geom<kRadius>(b, h2, w2, c, h, w, 1);
  return g.imax > 0 ? g.bytes : -1;
}

extern "C" int sample_window_bwd_f32(const void* dout, const void* coords,
                                     void* df2, void* workspace, int b,
                                     int h2, int w2, int c, int h, int w,
                                     int radius, void* stream) {
  return launch_bwd<float>(dout, coords, df2, workspace, b, h2, w2, c, h, w,
                           radius, stream);
}

extern "C" int sample_window_bwd_bf16(const void* dout, const void* coords,
                                      void* df2, void* workspace, int b,
                                      int h2, int w2, int c, int h, int w,
                                      int radius, void* stream) {
  return launch_bwd<__nv_bfloat16>(dout, coords, df2, workspace, b, h2, w2, c,
                                   h, w, radius, stream);
}

// Stage A's coarse grid search: for every spectrogram row of every
// window, the first maximum of the (time lag x drift) sync grid, for
// sm_90a.
//
// Replaces the grid of rtlsdr_wsprd_tpu/ops/coarse.py:99 coarse_search,
// an XLA program inside the jitted stage A (parallel/multichannel.py
// _stage_a_packed). ops/coarse.py coarse_search_plain is the same
// function in PyTorch: it gathers the (B, 512, 32, 162) lag planes,
// multiplies them by a weight matrix that is mostly zeros and sums 12
// rolled copies. This kernel writes only each row's best value and its
// flat (lag * 9 + drift) index; the 3-row candidate pick stays in
// PyTorch (ops/coarse.py _pick_candidates), shared by both routes.
//
// Grid point (row r, lag l, drift d) of window b, x = sqrt(ps) with
// column k0 + 2i (k0 = l - 10) zero outside [0, 347) and rows taken
// modulo 512 as torch.roll takes them, fd = floor of the float32 drift
// offset chain (ops/coarse.py _fd_int, -3..2), s = +1 where the pr3
// bit is set, else -1. With the pre-summed planes
//   v[r'] = (x[r'-3] + x[r'-1]) + (x[r'+1] + x[r'+3])
//   w[r'] = (x[r'-1] + x[r'+3]) - (x[r'-3] + x[r'+1])
// (each at column k0 + 2i):
//   ss  = sum_i s_i * w[r + fd(d, i)],  tot = sum_i v[r + fd(d, i)]
// summed over i in order, sync = ss / max(tot, 1e-30), and -inf where
// |d - 4| > maxdrift[b]. A row's first maximum in (lag, drift) order: a
// thread compares its drifts in order with a strict '>' from -inf, and
// across the 32 lags a tie goes to the smaller flat index, as
// torch.argmax and the reference's loop order (wsprd/wsprd.c:646-678)
// keep it.
//
// What bounds it on an H100: the FP32 pipe's issue rate. The least work
// is 2 adds a grid point and symbol (one into tot, one signed into ss),
// 2 x 512 x 32 x 9 x 162 a window at maxdrift 4, on 0.71 MB of input
// (tools/torch_measure.py coarse_work). The FP32 peak counts an FMA as
// two operations, so an add-only kernel reaches at most half of the
// bound that count gives. The design:
// - Pre-summed planes: a block stages v and w of its tile's rows with a
//   (-3, +2) halo, 354 columns each, once, as float2 (v, w) in dynamic
//   shared memory, read from the spectrogram in its own layout (the
//   transpose of a (347, 512) array a window: neighbouring threads read
//   neighbouring rows of a column) through a scratch of square roots,
//   taken once each. A grid point then costs one FADD into tot and one
//   FFMA of +-1 into ss (exact: the same rounding as an add or a
//   subtract).
// - All 9 drifts from one set of loaded rows: fd(d, i) is constant on
//   11 runs of symbols (COARSE_RUNS, from _fd_int; a CPU test holds the
//   list to it), and within a run the loop body has compile-time row
//   offsets. A thread takes one lag and R consecutive rows, loads rows
//   -3 .. R+1 of (v, w) for a symbol (R + 5 64-bit shared loads, its
//   32 lanes on 32 neighbouring columns: no bank conflicts; the next
//   symbol's issued before this one's sums) and updates its 9 x 2 x R
//   accumulators: 18R FP32 instructions. R = 4 rows a thread and 8
//   warps a block (tiles of 32 rows, 2 blocks an SM: 16 warps), not R =
//   8 with 4 warps (144 accumulators, 8 warps an SM, too few to keep the
//   two pipes busy) nor 4 warps of 4 rows (3 blocks, 12 warps, and 27
//   staged plane rows for every 16; tools/torch_search_ab.py --variants
//   times all three). The pr3 sign is one broadcast shared load a
//   symbol.
// - A window whose maxdrift is 0 sums only drift 4 (fd = 0 throughout);
//   the drifts a window masks are otherwise summed and then dropped.
// - Batches too small to fill the card take tiles of 8 rows (4 warps
//   of R = 2) instead of 32: 64 blocks a window instead of 16, so a
//   dense chunk of 4 windows or decode_window's one spreads over the
//   SMs.
// - Nothing but the (B, 512) value and index reaches device memory.

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;       // spectrogram rows (frequency bins)
constexpr int kBlocks = 347;     // spectrogram columns (time blocks)
constexpr int kLags = 32;        // k0 in -10..21: a warp's lanes
constexpr int kK0Min = -10;
constexpr int kDrifts = 9;       // idrift in -4..4
constexpr int kMaxDrift = 4;
constexpr int kSyms = 162;
constexpr int kLo = 3;           // -(least fd): (v, w) rows below a row
constexpr int kHi = 2;           // most fd: (v, w) rows above a row
constexpr int kCols = kLags + 2 * (kSyms - 1);            // 354
constexpr int kChunk = 56;       // columns a staging round
// the tiles: rows a thread (R) and row groups a block, one warp each
// (W), on batches that fill the card and on smaller ones
constexpr int kWideRows = 4;
constexpr int kWideWarps = 8;
constexpr int kNarrowRows = 2;
constexpr int kNarrowWarps = 4;

static_assert((kRows & (kRows - 1)) == 0, "rows wrap with a mask");

template <int R, int W>
__host__ __device__ constexpr int tile_rows() { return W * R; }
template <int R, int W>
__host__ __device__ constexpr int stage_rows() {
  return tile_rows<R, W>() + kLo + kHi;
}
// plane rows the staged rows read: 3 on each side
template <int R, int W>
__host__ __device__ constexpr int x_rows() { return stage_rows<R, W>() + 6; }
// (v, w) pairs, the 162 pr3 signs, the staging scratch
template <int R, int W>
__host__ __device__ constexpr int smem_bytes() {
  return stage_rows<R, W>() * kCols * 8 + kSyms * 4 +
         x_rows<R, W>() * kChunk * 4;
}
// blocks an SM holds by shared memory (228 KB, less 1 KB a block the
// card reserves), at most 4; the kernel's launch bounds
template <int R, int W>
__host__ __device__ constexpr int blocks_per_sm() {
  return 228 * 1024 / (smem_bytes<R, W>() + 1024) < 4
             ? 228 * 1024 / (smem_bytes<R, W>() + 1024) : 4;
}

static_assert(kRows % tile_rows<kWideRows, kWideWarps>() == 0 &&
              kRows % tile_rows<kNarrowRows, kNarrowWarps>() == 0,
              "tiles cover the rows");
static_assert(x_rows<kWideRows, kWideWarps>() % 2 == 1 &&
              x_rows<kNarrowRows, kNarrowWarps>() % 2 == 1,
              "an odd scratch stride");
static_assert(blocks_per_sm<kWideRows, kWideWarps>() >= 2,
              "two wide blocks fit an SM");

// The runs of symbols on which (drift -> fd) is constant:
// X(first symbol, end, fd of drifts 0..8), from ops/coarse.py _fd_int.
#define COARSE_RUNS(X)                         \
  X(0, 2, 2, 2, 1, 0, 0, -1, -2, -3, -3)      \
  X(2, 22, 2, 1, 1, 0, 0, -1, -2, -2, -3)     \
  X(22, 42, 1, 1, 0, 0, 0, -1, -1, -2, -2)    \
  X(42, 52, 1, 0, 0, 0, 0, -1, -1, -1, -2)    \
  X(52, 81, 0, 0, 0, 0, 0, -1, -1, -1, -1)    \
  X(81, 82, 0, 0, 0, 0, 0, 0, 0, 0, 0)        \
  X(82, 111, -1, -1, -1, -1, 0, 0, 0, 0, 0)   \
  X(111, 121, -2, -1, -1, -1, 0, 0, 0, 0, 1)  \
  X(121, 141, -2, -2, -1, -1, 0, 0, 0, 1, 1)  \
  X(141, 161, -3, -2, -2, -1, 0, 0, 1, 1, 2)  \
  X(161, 162, -3, -3, -2, -1, 0, 0, 1, 2, 2)

// Stage the block's (v, w) rows r0 - kLo .. r0 + tile + kHi - 1 (staged
// row k is plane row r0 - kLo + k) at staged columns c = 0..353
// (spectrogram column c + kK0Min, zero outside the grid). Every thread
// first issues all its loads of plane rows r0 - kLo - 3 .. (one wait on
// device memory, not one a round); then, kChunk columns a round, their
// square roots go to the scratch xs, [column][row] (neighbouring
// threads on neighbouring rows: coalesced loads, conflict-free stores),
// and staged row k is formed from xs rows k, k + 2, k + 4, k + 6
// (neighbouring threads on neighbouring columns; the scratch's odd
// column stride keeps the reads conflict-free).
template <int R, int W>
__device__ __forceinline__ void stage_planes(const float* __restrict__ psb,
                                             int r0, float2* vw, float* xs) {
  constexpr int kThreads = kLags * W;
  constexpr int kS = stage_rows<R, W>();
  constexpr int kX = x_rows<R, W>();
  constexpr int kRounds = (kCols + kChunk - 1) / kChunk;
  constexpr int kLoads = (kX * kChunk + kThreads - 1) / kThreads;
  constexpr int kForms = (kS * kChunk + kThreads - 1) / kThreads;
  float x[kRounds][kLoads];
#pragma unroll
  for (int c = 0; c < kRounds; ++c) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int cc = c * kChunk + idx / kX;
      const int col = cc + kK0Min;
      const int row = (r0 - kLo - 3 + idx % kX) & (kRows - 1);
      x[c][j] = (idx < kX * kChunk && cc < kCols && col >= 0 &&
                 col < kBlocks) ? psb[col * kRows + row] : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < kRounds; ++c) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      if (idx < kX * kChunk) xs[idx] = sqrtf(x[c][j]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kForms; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int k = idx / kChunk;
      const int cc = idx % kChunk;
      if (k < kS && c * kChunk + cc < kCols) {
        const float* xp = xs + cc * kX + k;
        const float a = xp[0], b = xp[2], g = xp[4], h = xp[6];
        vw[k * kCols + c * kChunk + cc] =
            make_float2((a + b) + (g + h), (b + h) - (a + g));
      }
    }
    // the next round overwrites xs; the last one's (v, w) are read next
    __syncthreads();
  }
}

// Symbols i0 .. i1 - 1 of one run: p points at the thread's first
// staged row and lag; F0..F8 are fd of drifts 0..8 on the run. kAll
// false sums drift 4 alone (fd = 0 on every run).
template <int R, bool kAll, int F0, int F1, int F2, int F3, int F4, int F5,
          int F6, int F7, int F8>
__device__ __forceinline__ void sweep(const float2* p, const float* sgn,
                                      int i0, int i1,
                                      float (&ss)[kDrifts][R],
                                      float (&tot)[kDrifts][R]) {
  constexpr int kF[kDrifts] = {F0, F1, F2, F3, F4, F5, F6, F7, F8};
  constexpr int kE = R + kLo + kHi;
  if (i0 >= i1) return;
  // the next symbol's rows are loaded while this one's are summed
  float2 e[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) e[k] = p[k * kCols + 2 * i0];
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float s = sgn[i];
    const int in = min(i + 1, i1 - 1);
    float2 en[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) en[k] = p[k * kCols + 2 * in];
#pragma unroll
    for (int d = 0; d < kDrifts; ++d) {
      if (!kAll && d != kMaxDrift) continue;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 t = e[q + kF[d] + kLo];
        tot[d][q] += t.x;
        ss[d][q] = fmaf(s, t.y, ss[d][q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) e[k] = en[k];
  }
}

template <int R, int W>
__global__ void __launch_bounds__(kLags * W, (blocks_per_sm<R, W>()))
coarse_rows_kernel(const float* __restrict__ ps,
                   const float* __restrict__ sign,
                   const int32_t* __restrict__ maxdrift,
                   float* __restrict__ row_val,
                   int32_t* __restrict__ row_arg) {
  extern __shared__ float2 smem2[];
  float2* vw = smem2;                                  // [stage rows][354]
  float* sgn =
      reinterpret_cast<float*>(smem2 + stage_rows<R, W>() * kCols);
  float* xs = sgn + kSyms;                             // [column][row]

  constexpr int kTiles = kRows / tile_rows<R, W>();
  const int b = blockIdx.x / kTiles;
  const int r0 = (blockIdx.x % kTiles) * tile_rows<R, W>();
  for (int k = threadIdx.x; k < kSyms; k += kLags * W) sgn[k] = sign[k];
  stage_planes<R, W>(ps + static_cast<size_t>(b) * kRows * kBlocks, r0, vw, xs);

  const int lag = threadIdx.x % kLags;
  const int q0 = (threadIdx.x / kLags) * R;  // the thread's first tile row
  const int md = maxdrift[b];
  float ss[kDrifts][R], tot[kDrifts][R];
#pragma unroll
  for (int d = 0; d < kDrifts; ++d)
#pragma unroll
    for (int q = 0; q < R; ++q) ss[d][q] = tot[d][q] = 0.0f;
  // staged row q0 is the -kLo row of tile row q0 (fd = 0)
  const float2* p = vw + q0 * kCols + lag;
  if (md > 0) {
#define COARSE_SWEEP(a, z, f0, f1, f2, f3, f4, f5, f6, f7, f8) \
    sweep<R, true, f0, f1, f2, f3, f4, f5, f6, f7, f8>(p, sgn, a, z, ss, tot);
    COARSE_RUNS(COARSE_SWEEP)
#undef COARSE_SWEEP
  } else {
    sweep<R, false, 0, 0, 0, 0, 0, 0, 0, 0, 0>(p, sgn, 0, kSyms, ss, tot);
  }

#pragma unroll
  for (int q = 0; q < R; ++q) {
    float v = -INFINITY;  // a masked drift is -inf and never wins
    int a = lag * kDrifts;
#pragma unroll
    for (int d = 0; d < kDrifts; ++d) {
      const int ad = d < kMaxDrift ? kMaxDrift - d : d - kMaxDrift;
      if (ad > md) continue;
      const float s = ss[d][q] / fmaxf(tot[d][q], 1e-30f);
      if (s > v) {
        v = s;
        a = lag * kDrifts + d;
      }
    }
    // across the warp's 32 lags: the larger value, on a tie the smaller
    // flat index
#pragma unroll
    for (int off = kLags / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (ov > v || (ov == v && oa < a)) {
        v = ov;
        a = oa;
      }
    }
    if (lag == 0) {
      const size_t o = static_cast<size_t>(b) * kRows + r0 + q0 + q;
      row_val[o] = v;
      row_arg[o] = a;
    }
  }
}

}  // namespace

// ps float32[n, 512, 347] power spectrogram, the transpose of a
// row-major [n, 347, 512] (as ops/stft.py power_spectrogram returns
// it); sign float32[162], +1 where the pr3 bit is set, else -1;
// maxdrift int32[n]; outputs row_val float32[n, 512], row_arg
// int32[n, 512]. All device pointers, contiguous, on the current
// device. Tiles of 32 rows (8 warps of 4 rows) when the batch fills
// two waves of two blocks an SM, else of 8 rows (4 warps of 2). Launches on ``stream``; returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int coarse_rows(const void* ps, const void* sign,
                           const void* maxdrift, int n_windows,
                           void* row_val, void* row_arg, void* stream) {
  if (n_windows <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the wide tile's shared memory is above the 48 KB default: opt in
  // once a device
  static std::atomic<unsigned long long> opted{0};
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(coarse_rows_kernel<kWideRows, kWideWarps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<kWideRows, kWideWarps>());
    if (err != cudaSuccess) return static_cast<int>(err);
    // the whole unified cache as shared memory, for the most blocks an SM
    err = cudaFuncSetAttribute(coarse_rows_kernel<kWideRows, kWideWarps>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* x = static_cast<const float*>(ps);
  const auto* s = static_cast<const float*>(sign);
  const auto* md = static_cast<const int32_t*>(maxdrift);
  auto* val = static_cast<float*>(row_val);
  auto* arg = static_cast<int32_t*>(row_arg);
  auto* st = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(n_windows);
  const unsigned wide_blocks =
      n * (kRows / tile_rows<kWideRows, kWideWarps>());
  if (wide_blocks >= 2u * blocks_per_sm<kWideRows, kWideWarps>() *
                         static_cast<unsigned>(sms))
    coarse_rows_kernel<kWideRows, kWideWarps>
        <<<wide_blocks, kLags * kWideWarps,
           smem_bytes<kWideRows, kWideWarps>(), st>>>(x, s, md, val, arg);
  else
    coarse_rows_kernel<kNarrowRows, kNarrowWarps>
        <<<n * (kRows / tile_rows<kNarrowRows, kNarrowWarps>()),
           kLags * kNarrowWarps, smem_bytes<kNarrowRows, kNarrowWarps>(),
           st>>>(x, s, md, val, arg);
  return static_cast<int>(cudaGetLastError());
}

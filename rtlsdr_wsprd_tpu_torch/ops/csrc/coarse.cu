// Stage A's coarse grid search: for every spectrogram row of every
// window, the first maximum of the (time lag x drift) sync grid, for
// sm_90a.
//
// Replaces the grid of rtlsdr_wsprd_tpu/ops/coarse.py:99 coarse_search,
// an XLA program inside the jitted stage A (parallel/multichannel.py
// _stage_a_packed). ops/coarse.py coarse_search_plain is the same
// function in PyTorch: it gathers the (B, 512, 32, 162) lag planes,
// multiplies them by a weight matrix that is mostly zeros and sums 12
// rolled copies. This kernel computes each grid point directly and
// writes only each row's best value and its flat (lag * 9 + drift)
// index; the 3-row candidate pick stays in PyTorch (ops/coarse.py
// _pick_candidates), shared by both routes.
//
// Grid point (row r, lag l, drift d) of window b, x = sqrt(ps) with
// column k0 + 2i (k0 = l - 10) zero outside [0, 347) and rows taken
// modulo 512 as torch.roll takes them, fd = floor of the float32 drift
// offset chain (ops/coarse.py _fd_int, -3..2), s = +1 where the pr3
// bit is set, else -1:
//   ss  = sum_i s_i * (x[r+fd-1] + x[r+fd+3] - x[r+fd-3] - x[r+fd+1])
//   tot = sum_i       (x[r+fd-3] + x[r+fd-1] + x[r+fd+1] + x[r+fd+3])
// (the columns are k0 + 2i), sync = ss / max(tot, 1e-30), and -inf
// where |d - 4| > maxdrift[b]. A row's first maximum in (lag, drift)
// order: a thread scans its drifts with a strict '>', and across the
// 32 lags a tie goes to the smaller flat index, as torch.argmax and the
// reference's loop order (wsprd/wsprd.c:646-678) keep it.
//
// What bounds it on an H100: operations. A window's direct work is
// 512 x 32 x 9 x 162 x 4 tone reads, 2 FLOPs each (191 MFLOP), on 0.71
// MB of input; every read is from shared memory. The design:
// - One block per (window, tile of 32 rows); the tile's rows with a
//   6-row halo on each side (|fd + t| <= 6), 354 columns each, are
//   staged once as sqrt(ps) in dynamic shared memory (62 KB), and the
//   per-(drift, symbol) table (2 * fd + pr3 bit, int32) beside them.
//   The spectrogram is read in its own layout (ops/stft.py returns the
//   transpose of a (347, 512) array a window): no copy.
// - A warp takes 32 lags of 4 consecutive rows: its lanes read 32
//   consecutive columns of one staged row (no bank conflicts), and the
//   table entry is one broadcast. The 4 rows share their reads: 10
//   loads give the 16 tone values of a (drift, symbol).
// - Nothing but the (B, 512) value and index reaches device memory.

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;       // spectrogram rows (frequency bins)
constexpr int kBlocks = 347;     // spectrogram columns (time blocks)
constexpr int kLags = 32;        // k0 in -10..21
constexpr int kK0Min = -10;
constexpr int kDrifts = 9;       // idrift in -4..4
constexpr int kMaxDrift = 4;
constexpr int kSyms = 162;
constexpr int kHalo = 6;         // most |fd + tone offset| in rows
constexpr int kTile = 32;        // output rows a block
constexpr int kRowsPerThread = 4;
constexpr int kThreads = kLags * kTile / kRowsPerThread;  // 256
constexpr int kStageRows = kTile + 2 * kHalo;             // 44
constexpr int kCols = kLags + 2 * (kSyms - 1);            // 354
constexpr int kTable = kDrifts * kSyms;
constexpr int kSmemBytes = (kStageRows * kCols + kTable) * 4;

static_assert(kRows % kTile == 0, "tiles cover the rows");
static_assert((kRows & (kRows - 1)) == 0, "rows wrap with a mask");

__global__ void __launch_bounds__(kThreads)
coarse_rows_kernel(const float* __restrict__ ps,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ maxdrift,
                   float* __restrict__ row_val,
                   int32_t* __restrict__ row_arg) {
  extern __shared__ float smem[];
  float* x = smem;                                        // [44][354]
  int32_t* tab = reinterpret_cast<int32_t*>(smem + kStageRows * kCols);

  const int tiles = kRows / kTile;
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kTile;
  const float* psb = ps + static_cast<size_t>(b) * kRows * kBlocks;

  // staged row sr holds spectrogram row r0 - kHalo + sr (mod 512),
  // staged column c its column c + kK0Min (zero outside the grid);
  // neighbouring threads read neighbouring rows of one column, which
  // are neighbouring addresses in the spectrogram's layout
  for (int k = threadIdx.x; k < kStageRows * kCols; k += kThreads) {
    const int c = k / kStageRows;
    const int sr = k - c * kStageRows;
    const int col = c + kK0Min;
    const int row = (r0 - kHalo + sr) & (kRows - 1);
    float v = 0.0f;
    if (col >= 0 && col < kBlocks) v = sqrtf(psb[col * kRows + row]);
    x[sr * kCols + c] = v;
  }
  for (int k = threadIdx.x; k < kTable; k += kThreads) tab[k] = table[k];
  __syncthreads();

  const int lag = threadIdx.x % kLags;
  const int q0 = (threadIdx.x / kLags) * kRowsPerThread;  // first tile row
  const int md = maxdrift[b];

  float best[kRowsPerThread];
  int arg[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    best[q] = -INFINITY;  // a masked drift is -inf and never wins
    arg[q] = lag * kDrifts;
  }
  // the tone offset -3 row of tile row q0 at fd = 0, this lane's lag
  const float* base = x + (q0 + kHalo - 3) * kCols + lag;
  for (int d = 0; d < kDrifts; ++d) {
    const int ad = d < kMaxDrift ? kMaxDrift - d : d - kMaxDrift;
    if (ad > md) continue;
    const int32_t* td = tab + d * kSyms;
    float ss[kRowsPerThread], tot[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) ss[q] = tot[q] = 0.0f;
    for (int i = 0; i < kSyms; ++i) {
      const int e = td[i];
      const float* p = base + (e >> 1) * kCols + 2 * i;
      float v[kRowsPerThread + 6];
#pragma unroll
      for (int k = 0; k < kRowsPerThread + 6; ++k) v[k] = p[k * kCols];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        // rows r + fd + t, t = -3, -1, +1, +3
        const float a = v[q], bq = v[q + 2], c = v[q + 4], g = v[q + 6];
        const float diff = (bq + g) - (a + c);
        ss[q] += (e & 1) ? diff : -diff;
        tot[q] += (a + bq) + (c + g);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float s = ss[q] / fmaxf(tot[q], 1e-30f);
      if (s > best[q]) {
        best[q] = s;
        arg[q] = lag * kDrifts + d;
      }
    }
  }

  // across the warp's 32 lags: the larger value, on a tie the smaller
  // flat index
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    float v = best[q];
    int a = arg[q];
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
// it); table int32[9, 162],
// 2 * fd_int[i, d] + pr3[i] (fd_int in [-3, 3]); maxdrift int32[n];
// outputs row_val float32[n, 512], row_arg int32[n, 512]. All device
// pointers, contiguous, on the current device. Launches on ``stream``;
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int coarse_rows(const void* ps, const void* table,
                           const void* maxdrift, int n_windows,
                           void* row_val, void* row_arg, void* stream) {
  if (n_windows <= 0) return 0;
  // a block's shared memory is above the 48 KB default: opt in once a
  // device
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(coarse_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const unsigned blocks = static_cast<unsigned>(n_windows) * (kRows / kTile);
  coarse_rows_kernel<<<blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ps), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(maxdrift), static_cast<float*>(row_val),
      static_cast<int32_t*>(row_arg));
  return static_cast<int>(cudaGetLastError());
}

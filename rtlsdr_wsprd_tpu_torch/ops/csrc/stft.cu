// Stage A's power spectrogram: 347 windowed 512-point FFTs a window at
// a quarter-symbol hop, each bin's squared magnitude written in
// fftshifted order, for sm_90a.
//
// Replaces rtlsdr_wsprd_tpu/ops/stft.py:49 power_spectrogram, an XLA
// program inside the jitted stage A (parallel/multichannel.py
// _stage_a_packed). ops/stft.py power_spectrogram_plain is the same
// function in PyTorch: the DFT as four (347, 512) @ (512, 512) float32
// products against constant cos/sin matrices (the TPU's formulation,
// 4 x 2 x 512 FLOPs a bin); here an FFT does it in 5 log2(512) a bin.
//
// For window b (a row of the planes i, q, at least 44,800 samples):
// frame k = 0..346 is the 512 complex samples (i + j q)[128 k + n],
// n = 0..511, times hann[n]; Z_k[m] = sum_n x[n] exp(-2 pi j n m / 512);
// out[b, k, c] = |Z_k[(c + 256) mod 512]|^2, row-major (n, 347, 512):
// the transpose of the (512, 347) layout the plain version returns.
//
// What bounds it on the H100: bytes. A window reads its 44,800 samples
// a plane (358 KB) and writes 347 x 512 powers (711 KB); at B=128 that
// is 137 MB, 41 us at 3.35 TB/s (49 us at the ~2.8 TB/s a fill or a copy
// reaches), against ~17 us of FP32 work. The design spends its effort
// on bytes, barriers and overlap; tools/torch_search_ab.py --variants
// times it with its stores, its loads or its FFT taken out, and its
// loads and stores alone take as long as the whole kernel:
// - A warp takes a frame (512 = 16 x 32, 16 points a lane) and
//   synchronises only itself (__syncwarp, warp shuffles): the warps of a
//   block never wait for each other inside an FFT. Lane t loads points
//   t + 32 r (r = 0..15) of the staged samples times the window, runs a
//   16-point DFT over r in registers and multiplies output m1 by
//   exp(-2 pi j t m1 / 512) (the twiddle table). One exchange through
//   the warp's scratch (float2, 64-bit accesses) gives lane
//   s = 2 m1 + v the values of lanes 2 u + v (u = 0..15) at m1; a second
//   16-point DFT over u, in registers, leaves B_v[q]; the last radix 2,
//   Z[m1 + 16 q + 256 p] = B_0[q] + (-1)^p exp(-2 pi j q / 32) B_1[q],
//   pairs lanes s and s ^ 1 by __shfl_xor_sync, each lane finishing
//   q = 8 v .. 8 v + 7. A frame moves 12 KB through shared memory (4 KB
//   of samples read, 4 KB written and read in the exchange), against 20
//   KB in two exchanges of a radix-8 Stockham FFT.
// - The scratch rows are 34 float2 apart, so the writes (row m1, lane t)
//   and the reads (row m1, column 2 u + v) meet no bank twice in a half
//   warp. The powers go out as each warp store's two runs of 16
//   consecutive floats (full 32-byte sectors), at constant offsets from
//   one pointer a lane (no address arithmetic a store: ~2% at B=128).
//   16-byte stores through the scratch measured no faster.
// - Staging is asynchronous and the grid persistent: as many blocks as
//   fit the SMs (read once a device with the occupancy API), each
//   walking (window, tile) pairs blockIdx.x, blockIdx.x + gridDim.x, ...
//   through a ring of kSlots = 2 staged tiles. While the warps run tile
//   t's frames, tile t + 1's (frames + 3) x 128 samples of both planes
//   are in flight (cp.async, 16 bytes a copy, a commit group a tile). A
//   block a tile, with no walk, measured 40% slower at B=128, and a
//   third slot 3% slower. __syncthreads() is left only around the
//   staging: once the tile has landed, and once its frames are done
//   with the slot the next copy overwrites.
// - A tile is 4 frames, a frame a warp, 4 warps a block: 87 tiles a
//   window, so a dense-step chunk (B=4) or one window (B=1) spreads over
//   the SMs instead of running serial FFT rounds on a few blocks, and at
//   B=128 more, smaller blocks an SM (the barriers couple 4 warps, not
//   8) measured 5-6% faster than tiles of 8 or 16 frames on 8 warps and
//   2% faster than 2 on 2, the halo of 3 x 128 samples each tile stages
//   again coming from L2. ptxas gives 103 registers a thread (16 warps
//   an SM); capping them for 20 or 24 warps measured slower.
// - Twiddles exp(-2 pi j k / 512) come from a float32 table of cos and
//   sin of 2 pi k / 512, k < 256, rounded from float64 (ops/stft.py
//   TWIDDLE: DFT_COS and DFT_SIN's bin 1); k >= 256 is the negated entry
//   k - 256. A lane's window values and twiddles are the same for every
//   frame it takes: loaded once. The 16-point DFTs' and the last radix
//   2's constants are float literals. No fast math.
// - Frames past 346 are not run, so samples past a row's 44,800 are
//   never staged or read. A window of zeros gives zeros exactly.
//
// The device-only primitives (cp.async and its groups) sit behind small
// named helpers that the host emulation in the tests defines for itself.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kN = 512;                 // FFT points, bins a frame
constexpr int kHop = 128;               // samples between frames
constexpr int kFrames = 347;            // frames a window
constexpr int kSpan = (kFrames + 3) * kHop;   // 44,800 samples read a row
constexpr int kPoints = 16;             // points a lane
constexpr int kRow = 34;                // scratch row stride, in float2
constexpr int kScratch = kPoints * kRow;      // a warp's scratch, float2
constexpr int kTile = 4;                // frames a tile
constexpr int kWarps = 4;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 2;               // staged tiles a block
constexpr int kTiles = (kFrames + kTile - 1) / kTile;   // 87 a window
constexpr int kStage = (kTile + 3) * kHop;    // staged floats a plane
constexpr int kSmemBytes = kSlots * 2 * kStage * 4 + kWarps * kScratch * 8;

static_assert(kN == kPoints * 32, "a warp of 16 points a lane");
static_assert(kSpan % 4 == 0 && kHop % 4 == 0, "16-byte staging copies");

#ifdef __CUDACC__
// the device's asynchronous copy, behind names the host emulation
// defines for itself: 16 bytes global -> shared, a commit group, and a
// wait until at most N of this thread's groups are pending
__device__ __forceinline__ void stage_copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

struct alignas(8) Cx {  // a float2 in the scratch
  float re, im;
};

__device__ __forceinline__ Cx cadd(Cx a, Cx b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ Cx csub(Cx a, Cx b) {
  return {a.re - b.re, a.im - b.im};
}
__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// exp(-2 pi j k / 512), k in 0..511, from cos/sin of k < 256
__device__ __forceinline__ Cx twiddle(const float* __restrict__ cs, int k) {
  const float c = cs[k & 255], s = cs[256 + (k & 255)];
  return k < 256 ? Cx{c, -s} : Cx{-c, s};
}

// In place: v[m] = sum_n v[n] exp(-2 pi j n m / 8), natural order in and
// out (decimation in frequency: two radix-2 stages, then a radix-2 of
// each pair).
__device__ __forceinline__ void fft8(Cx (&v)[8]) {
  constexpr float h = 0.70710678118654752f;  // cos(pi / 4)
  Cx a[8];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    a[n] = cadd(v[n], v[n + 4]);
    a[n + 4] = csub(v[n], v[n + 4]);
  }
  // (x - x[n + 4]) exp(-2 pi j n / 8), n = 1, 2, 3
  a[5] = {h * (a[5].re + a[5].im), h * (a[5].im - a[5].re)};
  a[6] = {a[6].im, -a[6].re};
  a[7] = {h * (a[7].im - a[7].re), -h * (a[7].re + a[7].im)};
  // the two 4-point DFTs, of a[0..3] (even bins) and a[4..7] (odd bins)
#pragma unroll
  for (int o = 0; o < 8; o += 4) {
    const Cx b0 = cadd(a[o], a[o + 2]);
    const Cx b2 = csub(a[o], a[o + 2]);
    const Cx b1 = cadd(a[o + 1], a[o + 3]);
    // (a1 - a3) times -j
    const Cx b3 = {a[o + 1].im - a[o + 3].im, a[o + 3].re - a[o + 1].re};
    const int m = o / 4;  // even bins 0, 2, 4, 6; odd 1, 3, 5, 7
    v[m] = cadd(b0, b1);
    v[m + 4] = csub(b0, b1);
    v[m + 2] = cadd(b2, b3);
    v[m + 6] = csub(b2, b3);
  }
}

// cos of 2 pi k / 32, k = 0..8, and sin, k = 0..7 (literals of the
// float64 values)
__host__ __device__ constexpr float cos32(int k) {
  return k == 0   ? 1.0f
         : k == 1 ? 0.98078528040323044913f
         : k == 2 ? 0.92387953251128675613f
         : k == 3 ? 0.83146961230254523708f
         : k == 4 ? 0.70710678118654752440f
         : k == 5 ? 0.55557023301960222474f
         : k == 6 ? 0.38268343236508977173f
         : k == 7 ? 0.19509032201612826785f
                  : 0.0f;
}
__host__ __device__ constexpr float sin32(int k) { return cos32(8 - k); }

// In place: v[m] = sum_n v[n] exp(-2 pi j n m / 16), natural order in
// and out (a radix-2 step in frequency, then two 8-point DFTs).
__device__ __forceinline__ void fft16(Cx (&v)[16]) {
  Cx e[8], o[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    e[n] = cadd(v[n], v[n + 8]);
    const Cx d = csub(v[n], v[n + 8]);
    // d exp(-2 pi j n / 16): -j for n = 4; otherwise exp(-2 pi j 2n / 32),
    // for 2n >= 8 the angle's quarter turn taken out (-j) first
    if (n == 0)
      o[n] = d;
    else if (n == 4)
      o[n] = {d.im, -d.re};
    else if (n < 4)
      o[n] = cmul(d, Cx{cos32(2 * n), -sin32(2 * n)});
    else
      o[n] = cmul(Cx{d.im, -d.re}, Cx{cos32(2 * n - 8), -sin32(2 * n - 8)});
  }
  fft8(e);
  fft8(o);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    v[2 * m] = e[m];
    v[2 * m + 1] = o[m];
  }
}

// One frame's powers, by the warp: si, sq the frame's 512 staged
// samples a plane; w, tw the lane's window values and pass-1 twiddles;
// scr the warp's scratch; o the frame's 512 output columns.
__device__ __forceinline__ void frame_powers(
    const float* si, const float* sq, const float (&w)[kPoints],
    const Cx (&tw)[kPoints], Cx* scr, int lane, float* __restrict__ o) {
  Cx a[kPoints];
  // pass 1: points lane + 32 r; a[m1] = sum_r x[lane + 32 r] W16^(r m1)
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    const int n = lane + 32 * r;
    a[r] = {si[n] * w[r], sq[n] * w[r]};
  }
  fft16(a);
  __syncwarp();  // the last frame's reads of the scratch are done
#pragma unroll
  for (int m = 0; m < kPoints; ++m) scr[m * kRow + lane] = cmul(a[m], tw[m]);
  __syncwarp();
  // pass 2: lane s = 2 m1 + v takes lanes 2 u + v's values at m1;
  // a[q] = B_v[q] = sum_u A[2 u + v] W16^(u q)
  const int v = lane & 1, m1 = lane >> 1;
#pragma unroll
  for (int u = 0; u < kPoints; ++u) a[u] = scr[m1 * kRow + 2 * u + v];
  fft16(a);
  // the last radix 2 with lane s ^ 1: this lane finishes q = 8 v + k and
  // sends its partner its other half; bin m1 + 16 q goes to column
  // m1 + 16 q + 256 and bin m1 + 16 q + 256 to column m1 + 16 q, each at
  // a constant offset from the lane's first
  float* __restrict__ ob = o + m1 + 128 * v;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const Cx send = v ? a[k] : a[k + 8];
    const Cx got = {__shfl_xor_sync(0xffffffffu, send.re, 1),
                    __shfl_xor_sync(0xffffffffu, send.im, 1)};
    const Cx b0 = v ? got : a[k];
    // B_1[q] exp(-2 pi j q / 32): exp(-2 pi j k / 32), then -j for v = 1
    Cx b1 = cmul(v ? a[k + 8] : got, Cx{cos32(k), -sin32(k)});
    if (v) b1 = {b1.im, -b1.re};
    const Cx z0 = cadd(b0, b1), z1 = csub(b0, b1);
    ob[16 * k + 256] = z0.re * z0.re + z0.im * z0.im;
    ob[16 * k] = z1.re * z1.re + z1.im * z1.im;
  }
}

// tiles of kTile frames, kWarps warps a block, persistent: blocks walk
// the (window, tile) pairs blockIdx.x + i gridDim.x through a ring of
// kSlots staged tiles; at least 16 warps an SM (<= 128 registers)
__global__ void __launch_bounds__(kThreads, 16 / kWarps)
stft_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
            long long stride_i, long long stride_q,
            const float* __restrict__ hann, const float* __restrict__ cs,
            int n_windows, float* __restrict__ out) {
  extern __shared__ float4 stft_smem[];
  // [kSlots][i, q][kStage], then a scratch a warp
  float* ring = reinterpret_cast<float*>(stft_smem);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  Cx* scr = reinterpret_cast<Cx*>(ring + kSlots * 2 * kStage) +
            warp * kScratch;

  // tile p's samples, both planes, into ring slot ``slot``; the last
  // tile of a window stops at the row's 44,800th sample
  const int total = n_windows * kTiles;
  auto stage = [&](int p, int slot) {
    const int b = p / kTiles;
    const int s0 = (p % kTiles) * kTile * kHop;
    const int n4 = min(kStage, kSpan - s0) / 4;
    const float* gi = xi + b * stride_i + s0;
    const float* gq = xq + b * stride_q + s0;
    float* ti = ring + slot * 2 * kStage;
    float* tq = ti + kStage;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      stage_copy16(ti + 4 * c, gi + 4 * c);
      stage_copy16(tq + 4 * c, gq + 4 * c);
    }
  };

  // the lane's window values and twiddles, the same every frame
  float w[kPoints];
  Cx tw[kPoints];
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    w[r] = hann[lane + 32 * r];
    tw[r] = twiddle(cs, lane * r);
  }

  // the block's tiles: p = blockIdx.x + i gridDim.x, i = 0, 1, ..., tile
  // i in slot i % kSlots; the first kSlots - 1 go out before any frame
  // runs, and tile i + kSlots - 1 before tile i's frames
  const int step = gridDim.x;
  int p = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) {
    if (p + s * step < total) stage(p + s * step, s);
    stage_commit();
  }
  for (int i = 0; p < total; p += step, ++i) {
    const int ahead = p + (kSlots - 1) * step;
    if (ahead < total) stage(ahead, (i + kSlots - 1) % kSlots);
    stage_commit();
    stage_wait<kSlots - 1>();  // tile i's group has landed
    __syncthreads();
    const float* si = ring + (i % kSlots) * 2 * kStage;
    const float* sq = si + kStage;
    const int b = p / kTiles;
    const int k0 = (p % kTiles) * kTile;
    for (int f = warp; f < kTile && k0 + f < kFrames; f += kWarps)
      frame_powers(si + f * kHop, sq + f * kHop, w, tw, scr, lane,
                   out + (static_cast<size_t>(b) * kFrames + k0 + f) * kN);
    // every warp is done with the slot the next iteration's copy fills
    __syncthreads();
  }
}

}  // namespace

// xi, xq float32 planes of n_windows rows, row r at x + r * stride
// (floats), at least 44,800 samples a row, each 16-byte aligned (the
// base and the stride); hann float32[512]; cos_sin float32[2][256], cos
// and sin of 2 pi k / 512; out float32[n_windows, 347, 512], contiguous.
// All device pointers on the current device. As many blocks as fit the
// SMs, or one a tile when there are fewer tiles. Launches on ``stream``;
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int stft_power(const void* xi, const void* xq, long long stride_i,
                          long long stride_q, const void* hann,
                          const void* cos_sin, int n_windows, void* out,
                          void* stream);

namespace {

// the blocks that fit the SMs of device ``dev`` at once, read once a
// device (0 on an error)
int resident_blocks(int dev) {
  static std::atomic<int> resident[64];
  int fit = dev < 64 ? resident[dev].load() : 0;
  if (fit > 0) return fit;
  // above the 48 KB default only if a tile grows: opt in all the same
  if (cudaFuncSetAttribute(stft_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) != cudaSuccess ||
      cudaFuncSetAttribute(stft_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return 0;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stft_kernel, kThreads, kSmemBytes) != cudaSuccess)
    return 0;
  fit = per_sm * sms;
  if (dev < 64) resident[dev].store(fit);
  return fit;
}

}  // namespace

extern "C" int stft_power(const void* xi, const void* xq, long long stride_i,
                          long long stride_q, const void* hann,
                          const void* cos_sin, int n_windows, void* out,
                          void* stream) {
  if (n_windows <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fit = resident_blocks(dev);
  if (fit <= 0) {
    err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess
                                ? err
                                : cudaErrorInvalidConfiguration);
  }
  const int total = n_windows * kTiles;
  stft_kernel<<<total < fit ? total : fit, kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xq), stride_i,
      stride_q, static_cast<const float*>(hann),
      static_cast<const float*>(cos_sin), n_windows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

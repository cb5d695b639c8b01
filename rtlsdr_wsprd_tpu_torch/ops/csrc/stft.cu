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
// The design, simple first:
// - A block of 256 threads takes a tile of kTile consecutive frames of
//   one window. It stages the tile's (kTile + 3) x 128 samples of both
//   planes in shared memory once, 16 bytes a load (a frame starts at a
//   multiple of 512 bytes), zero past the last frame's samples.
// - Four groups of 64 threads each take a frame at a time: a radix-8
//   Stockham FFT (512 = 8^3), each thread 8 points in registers, three
//   passes, two exchanges through a shared scratch a group. Pass 1 reads
//   the staged samples j + 64 r (r = 0..7) of its frame times the
//   window; pass 3 writes bins j + 64 r, so a frame's 512 powers go out
//   together (coalesced), at column (bin + 256) mod 512.
// - Twiddles exp(-2 pi j k / 512) come from a float32 table of cos and
//   sin of 2 pi k / 512, k < 256, rounded from float64 (ops/stft.py
//   TWIDDLE: DFT_COS and DFT_SIN's bin 1); k >= 256 is the negated entry
//   k - 256. A thread's window values and twiddles are the same for
//   every frame it takes: loaded once.
// - The scratch is indexed e + e / 8 (one pad word every 8), which
//   spreads pass 1's stores (e = 8 j + r) and pass 2's (e = 64 (j / 8) +
//   j % 8 + 8 r) over all 32 banks; the loads (e = j + 64 r) meet at most
//   2 to a bank.
// - A window of zeros gives zeros exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 512;                 // FFT points, bins a frame
constexpr int kHop = 128;               // samples between frames
constexpr int kFrames = 347;            // frames a window
constexpr int kSpan = (kFrames + 3) * kHop;   // 44,800 samples read a row
constexpr int kRadix = 8;
constexpr int kGroup = kN / kRadix;     // 64 threads an FFT
constexpr int kGroups = 4;              // FFTs a block runs at a time
constexpr int kThreads = kGroup * kGroups;    // 256
constexpr int kTile = 16;               // frames a block
constexpr int kTiles = (kFrames + kTile - 1) / kTile;   // 22 a window
constexpr int kStage = (kTile + 3) * kHop;    // staged samples a plane
constexpr int kScratch = kN + kN / 8;   // a group's scratch, padded
constexpr int kSmemFloats = 2 * kStage + 2 * kGroups * kScratch;

static_assert(kTile % kGroups == 0, "every group takes as many frames");
static_assert(kStage % 4 == 0 && kSpan % 4 == 0 && kHop % 4 == 0,
              "16-byte staging loads");
static_assert(kSmemFloats * 4 <= 48 * 1024, "no shared memory opt-in");

__host__ __device__ constexpr int pad(int e) { return e + (e >> 3); }

struct Cx {
  float re, im;
};

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
__device__ __forceinline__ void fft8(Cx (&v)[kRadix]) {
  constexpr float h = 0.70710678118654752f;  // cos(pi / 4)
  Cx a[8];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    a[n] = {v[n].re + v[n + 4].re, v[n].im + v[n + 4].im};
    a[n + 4] = {v[n].re - v[n + 4].re, v[n].im - v[n + 4].im};
  }
  // (x - x[n + 4]) exp(-2 pi j n / 8), n = 1, 2, 3
  a[5] = {h * (a[5].re + a[5].im), h * (a[5].im - a[5].re)};
  a[6] = {a[6].im, -a[6].re};
  a[7] = {h * (a[7].im - a[7].re), -h * (a[7].re + a[7].im)};
  // the two 4-point DFTs, of a[0..3] (even bins) and a[4..7] (odd bins)
#pragma unroll
  for (int o = 0; o < 8; o += 4) {
    const Cx b0 = {a[o].re + a[o + 2].re, a[o].im + a[o + 2].im};
    const Cx b2 = {a[o].re - a[o + 2].re, a[o].im - a[o + 2].im};
    const Cx b1 = {a[o + 1].re + a[o + 3].re, a[o + 1].im + a[o + 3].im};
    // (a1 - a3) times -j
    const Cx b3 = {a[o + 1].im - a[o + 3].im, a[o + 3].re - a[o + 1].re};
    const int m = o / 4;  // even bins 0, 2, 4, 6; odd 1, 3, 5, 7
    v[m] = {b0.re + b1.re, b0.im + b1.im};
    v[m + 4] = {b0.re - b1.re, b0.im - b1.im};
    v[m + 2] = {b2.re + b3.re, b2.im + b3.im};
    v[m + 6] = {b2.re - b3.re, b2.im - b3.im};
  }
}

__global__ void __launch_bounds__(kThreads)
stft_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
            long long stride_i, long long stride_q,
            const float* __restrict__ hann, const float* __restrict__ cs,
            float* __restrict__ out) {
  extern __shared__ float4 stft_smem[];
  float* si = reinterpret_cast<float*>(stft_smem);   // [kStage]
  float* sq = si + kStage;                            // [kStage]
  const int j = threadIdx.x % kGroup;
  const int g = threadIdx.x / kGroup;
  float* sre = sq + kStage + g * 2 * kScratch;        // the group's scratch
  float* sim = sre + kScratch;

  const int b = blockIdx.x / kTiles;
  const int k0 = (blockIdx.x % kTiles) * kTile;
  const int s0 = k0 * kHop;
  const int n4 = min(kStage, kSpan - s0) / 4;         // float4s to load
  const float4* gi = reinterpret_cast<const float4*>(xi + b * stride_i + s0);
  const float4* gq = reinterpret_cast<const float4*>(xq + b * stride_q + s0);
  float4* ti = reinterpret_cast<float4*>(si);
  float4* tq = reinterpret_cast<float4*>(sq);
  for (int t = threadIdx.x; t < kStage / 4; t += kThreads) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ti[t] = t < n4 ? gi[t] : z;
    tq[t] = t < n4 ? gq[t] : z;
  }

  // the thread's window values and twiddles, the same every frame
  float w[kRadix];
  Cx tw2[kRadix], tw3[kRadix];
#pragma unroll
  for (int r = 0; r < kRadix; ++r) {
    w[r] = hann[j + kGroup * r];
    tw2[r] = twiddle(cs, 8 * r * (j % 8));  // pass 2: Ns = 8
    tw3[r] = twiddle(cs, r * j);            // pass 3: Ns = 64
  }
  __syncthreads();

  for (int f = g; f < kTile; f += kGroups) {
    const int k = k0 + f;
    Cx v[kRadix];
    // pass 1 (Ns = 1): points j + 64 r, no twiddle; out to 8 j + r
#pragma unroll
    for (int r = 0; r < kRadix; ++r) {
      const int n = f * kHop + j + kGroup * r;
      v[r] = {si[n] * w[r], sq[n] * w[r]};
    }
    fft8(v);
#pragma unroll
    for (int r = 0; r < kRadix; ++r) {
      sre[pad(kRadix * j + r)] = v[r].re;
      sim[pad(kRadix * j + r)] = v[r].im;
    }
    __syncthreads();
    // pass 2 (Ns = 8): out to 64 (j / 8) + j % 8 + 8 r
#pragma unroll
    for (int r = 0; r < kRadix; ++r)
      v[r] = cmul({sre[pad(j + kGroup * r)], sim[pad(j + kGroup * r)]},
                  tw2[r]);
    fft8(v);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRadix; ++r) {
      const int e = (j / 8) * 64 + j % 8 + 8 * r;
      sre[pad(e)] = v[r].re;
      sim[pad(e)] = v[r].im;
    }
    __syncthreads();
    // pass 3 (Ns = 64): bin j + 64 r
#pragma unroll
    for (int r = 0; r < kRadix; ++r)
      v[r] = cmul({sre[pad(j + kGroup * r)], sim[pad(j + kGroup * r)]},
                  tw3[r]);
    fft8(v);
    if (k < kFrames) {
      float* o = out + (static_cast<size_t>(b) * kFrames + k) * kN;
#pragma unroll
      for (int r = 0; r < kRadix; ++r)
        o[j + kGroup * ((r + 4) % kRadix)] =
            v[r].re * v[r].re + v[r].im * v[r].im;
    }
    // the next frame's pass 1 overwrites the scratch pass 3 read
    __syncthreads();
  }
}

}  // namespace

// xi, xq float32 planes of n_windows rows, row r at x + r * stride
// (floats), at least 44,800 samples a row, each 16-byte aligned (the
// base and the stride); hann float32[512]; cos_sin float32[2][256], cos
// and sin of 2 pi k / 512; out float32[n_windows, 347, 512], contiguous.
// All device pointers on the current device. Launches on ``stream``;
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int stft_power(const void* xi, const void* xq, long long stride_i,
                          long long stride_q, const void* hann,
                          const void* cos_sin, int n_windows, void* out,
                          void* stream) {
  if (n_windows <= 0) return 0;
  stft_kernel<<<static_cast<unsigned>(n_windows) * kTiles, kThreads,
                kSmemFloats * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xq), stride_i,
      stride_q, static_cast<const float*>(hann),
      static_cast<const float*>(cos_sin), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Stage B's tone correlator: the magnitudes of the 4 WSPR tones of every
// symbol of every lane, at each of L static window offsets, for sm_90a.
//
// Replaces rtlsdr_wsprd_tpu/ops/sync.py:241 _tone_mags_offsets (with
// _double_frames, _cand_phasor_conj, _derotate and _offset_tone_matrix),
// an XLA program inside the jitted stage B and the dense step.
// ops/sync.py _tone_mags_offsets_plain is the same function in PyTorch:
// it materialises the (G, 162, 512) double frames, the per-lane phasor
// and the derotated frames, then multiplies them by a (512, 4L) offset
// tone matrix that is zero on 256 of each column's 512 rows.
//
// For lane g, symbol i, offset o_l (in [0, 256]) and tone t:
//   fp    = f0 + (drift / 2) * (i - 81) / 81     (float32, in that order)
//   y[u]  = w[256 i + u] * (cosf(fp * 2 pi dt * u), -sinf(...)), u < 512
//   z     = sum_{j < 256} y[o_l + j] * E_TONE[j, t]
//   out[g, i, l, t] = sqrt(re(z)^2 + im(z)^2)
// The phase, the derotation's products and the magnitude are rounded
// as the plain version's float32 elementwise ops round them (no
// fast-math: cosf/sinf, and __fmul_rn where a product must not fuse
// into an FMA); only the order of the 256-term sums differs.
//
// What bounds it on an H100: operations. A lane's dot products are
// 162 x L x 4 x 256 complex multiply-adds (8 FLOPs each, 57 MFLOP at
// L = 43), half of the plain route's products; its input is 334 KB and
// its output 162 x L x 4 floats. The design:
// - One block per (lane, group of ns symbols); the launcher picks ns so
//   that ns x L work items fill up to 512 threads (ns <= 16; at least
//   256 threads, which share the derotation). Each
//   symbol's 512-sample double frame is derotated once into shared
//   memory (planar, 1,025 floats a symbol, so that neighbouring symbols
//   fall on neighbouring banks), with E_TONE (8 KB) beside it.
// - A thread takes one (symbol, offset) and all 4 tones: per j, two
//   loads of y and two broadcast float4 loads of E_TONE feed 16 FMAs.
//   It keeps the plain version's four real sums (yr.er, yi.ei, yr.ei,
//   yi.er) and forms re = yr.er - yi.ei, im = yr.ei + yi.er at the end.
// - Neighbouring threads take neighbouring symbols of one offset, so
//   the output's float4 stores are L x 16 bytes apart (not coalesced;
//   the output is a small part of the traffic).
// - No (G, 162, 512) plane reaches device memory.

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSpS = 256;                 // samples a symbol
constexpr int kFrame = 2 * kSpS;          // double frame
constexpr int kSyms = 162;
constexpr int kHalfBits = 81;             // the drift ramp's centre and scale
constexpr int kWlen = kSyms * kSpS + kSpS;  // 41,728: a lane's window
constexpr int kMaxGroup = 16;             // most symbols a block
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 256;
constexpr int kFrameStride = 2 * kFrame + 1;  // yr[512], yi[512], 1 pad
constexpr int kToneFloats = 2 * kSpS * 4;     // E_TONE re, im: 2 x 256 x 4
constexpr int kHeadBytes = kToneFloats * 4 + kMaxGroup * 4;

__global__ void __launch_bounds__(kMaxThreads)
correlator_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                  const float* __restrict__ freq,
                  const float* __restrict__ drift,
                  const int32_t* __restrict__ offsets, int n_offsets,
                  int group, const float* __restrict__ etone,
                  float twopidt, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* e_re = smem4;                 // E_TONE_R[j, 0..3]
  float4* e_im = smem4 + kSpS;          // E_TONE_I[j, 0..3]
  float* dphi = reinterpret_cast<float*>(smem4 + 2 * kSpS);  // [group]
  float* y = dphi + kMaxGroup;          // [group][kFrameStride]

  const int g = blockIdx.x;
  const int i0 = blockIdx.y * group;
  const int nsym = min(group, kSyms - i0);

  {
    float* e = reinterpret_cast<float*>(smem4);
    for (int k = threadIdx.x; k < kToneFloats; k += blockDim.x)
      e[k] = etone[k];
  }
  if (threadIdx.x < nsym) {
    const float f0 = freq[g];
    const float half = drift[g] / 2.0f;
    const int i = i0 + threadIdx.x;
    const float fp = f0 + (half * static_cast<float>(i - kHalfBits)) /
                              static_cast<float>(kHalfBits);
    dphi[threadIdx.x] = twopidt * fp;
  }
  __syncthreads();

  const float* xr = wr + static_cast<size_t>(g) * kWlen;
  const float* xi = wi + static_cast<size_t>(g) * kWlen;
  for (int k = threadIdx.x; k < nsym * kFrame; k += blockDim.x) {
    const int s = k / kFrame;
    const int u = k - s * kFrame;
    const float ph = dphi[s] * static_cast<float>(u);
    const float ecr = cosf(ph);
    const float eci = -sinf(ph);
    const size_t n = static_cast<size_t>(i0 + s) * kSpS + u;
    const float ar = xr[n];
    const float ai = xi[n];
    float* ys = y + s * kFrameStride;
    ys[u] = __fmul_rn(ar, ecr) - __fmul_rn(ai, eci);
    ys[kFrame + u] = __fmul_rn(ar, eci) + __fmul_rn(ai, ecr);
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nsym * n_offsets; k += blockDim.x) {
    const int s = k % nsym;
    const int l = k / nsym;
    const float* yr = y + s * kFrameStride + offsets[l];
    const float* yi = yr + kFrame;
    float rr[4] = {0.f, 0.f, 0.f, 0.f}, ii[4] = {0.f, 0.f, 0.f, 0.f};
    float ri[4] = {0.f, 0.f, 0.f, 0.f}, ir[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < kSpS; ++j) {
      const float a = yr[j];
      const float b = yi[j];
      const float4 er = e_re[j];
      const float4 ei = e_im[j];
      const float erv[4] = {er.x, er.y, er.z, er.w};
      const float eiv[4] = {ei.x, ei.y, ei.z, ei.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        rr[t] = fmaf(a, erv[t], rr[t]);
        ii[t] = fmaf(b, eiv[t], ii[t]);
        ri[t] = fmaf(a, eiv[t], ri[t]);
        ir[t] = fmaf(b, erv[t], ir[t]);
      }
    }
    float m[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float zr = rr[t] - ii[t];
      const float zi = ri[t] + ir[t];
      m[t] = sqrtf(__fmul_rn(zr, zr) + __fmul_rn(zi, zi));
    }
    const size_t o =
        ((static_cast<size_t>(g) * kSyms + i0 + s) * n_offsets + l) * 4;
    *reinterpret_cast<float4*>(out + o) = make_float4(m[0], m[1], m[2], m[3]);
  }
}

// symbols a block for ``n_offsets`` offsets: ns x L work items fill up
// to kMaxThreads threads
int correlator_group(int n_offsets) {
  const int g = kMaxThreads / (n_offsets > 0 ? n_offsets : 1);
  return g < 1 ? 1 : (g > kMaxGroup ? kMaxGroup : g);
}

// threads a block: the work items rounded up to whole warps, and at
// least kMinThreads, which derotate the block's frames (16 x 512
// samples, a cosf and a sinf each, when L is small)
int correlator_threads(int n_offsets) {
  const int items = correlator_group(n_offsets) * n_offsets;
  const int t = (items + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : (t < kMinThreads ? kMinThreads : t);
}

// dynamic shared memory a block takes, in bytes
int correlator_shared_bytes(int n_offsets) {
  return kHeadBytes + correlator_group(n_offsets) * kFrameStride * 4;
}

}  // namespace

// wr, wi float32[n, 41728] lane windows; freq, drift float32[n];
// offsets int32[n_offsets] in [0, 256]; etone float32[2, 256, 4]
// (E_TONE_R then E_TONE_I); output float32[n, 162, n_offsets, 4]. All
// device pointers, contiguous, on the current device. Launches on
// ``stream``; returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int tone_correlator(const void* wr, const void* wi,
                               const void* freq, const void* drift,
                               const void* offsets, int n_offsets,
                               const void* etone, float twopidt,
                               int n_lanes, void* out, void* stream) {
  if (n_lanes <= 0 || n_offsets <= 0) return 0;
  // the largest block's shared memory is above the 48 KB default: opt
  // in once a device
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(correlator_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kHeadBytes + kMaxGroup * kFrameStride * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const int group = correlator_group(n_offsets);
  const dim3 grid(static_cast<unsigned>(n_lanes),
                  static_cast<unsigned>((kSyms + group - 1) / group));
  correlator_kernel<<<grid, correlator_threads(n_offsets),
                      correlator_shared_bytes(n_offsets),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const float*>(freq), static_cast<const float*>(drift),
      static_cast<const int32_t*>(offsets), n_offsets, group,
      static_cast<const float*>(etone), twopidt, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Polyphase complex FIR decimator for Hopper (sm_90a): float32 planes
// through a shared-memory slab and per-phase register tiles.
//
// Replaces rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:78
// (decimate_stage1_pallas, the TPU kernel) for every float32 call, beside
// polyphase_tc.cu, which takes the raw front end's uint8 stage-1 calls.
// Two instantiations of one kernel, fixed here:
//   stage 1: R = 80, T = 640 = 8 x 80 complex taps (fs/4 mixer folded in);
//   stage 2: R = 80, T = 2400 = 30 x 80 real taps (gi = 0).
//
// For every row c and output frame m, with conv-ordered taps g = gr + i gi:
//   yI[c, m] = sum_k gr[k] xI[c, R m + k] - gi[k] xQ[c, R m + k]
//   yQ[c, m] = sum_k gi[k] xI[c, R m + k] + gr[k] xQ[c, R m + k]
// With k = t R + r (phase r < R, tap block t < tpp = T / R) and slab row
// s = m + t, x[c, R m + k] = x[c, R s + r], so
//   y[m] = sum_r p_r[m],   p_r[m] = sum_t g[t R + r] x[c, R (m + t) + r]:
// each phase r is a tpp-tap convolution of the samples of that phase.
//
// Bound on an H100 SXM. The main path's stage-2 call (C = 8 x 3,700 frames)
// reads 19.1 MB of float32 I/Q and writes 0.24 MB: 0.0058 ms at 3.35 TB/s.
// Its real taps cost 2 FMA per tap and frame, 284 MFLOP, 0.0042 ms at
// 67 TFLOP/s. A float32 stage-1 call of C = 8 x 8,000 frames reads 41.0 MB
// (0.0124 ms) for 0.0049 ms of complex FMAs (4 a tap). So bytes bound both,
// and the FP32 cores suffice: a kernel that reads each input sample from
// the slab a few times, not T / R times, can reach the byte floor.
//
// Design, against the five costs of the direct form it replaces (one warp
// per output frame, lanes over the taps):
// 1. Every sample was loaded T / R times through L1 (30 in stage 2, 8 in
//    stage 1), since neighbouring frames overlap by T - R samples. Here a
//    block owns kFrames output frames of one row and copies their slab,
//    (kFrames + tpp - 1) x R samples of each plane, into shared memory
//    once: 16-byte cp.async copies where both planes' rows start 16-byte
//    aligned (the main path's do: torch.cat output, row stride 80 n + 2320
//    floats), 4-byte ones otherwise. Only the tpp - 1 halo rows are
//    read again, by the next block, mostly from L2.
// 2. Loads set the pace (2 global and 2 shared loads per 4 FMAs). Here
//    thread (r, grp) owns phase r and a group of kGroup consecutive frames.
//    Its tpp taps of phase r sit in registers; it walks the kGroup + tpp - 1
//    slab samples of its phase in order, and each sample feeds up to tpp
//    FMAs into a register tile of kGroup outputs per plane: one shared load
//    feeds 6.5 FMAs in stage 2 and 8.5 in stage 1 (kGroup = 8), where it
//    fed one. Neighbouring lanes take neighbouring phases, so
//    a warp reads neighbouring words. Every kGroup slab rows are followed by
//    16 floats of padding: a warp that spans two frame groups (R = 80 is not
//    a multiple of 32) then reads two disjoint half-bank sets.
// 3. Stage 2 ran the complex body on real taps. The real instantiation runs
//    2 FMAs and holds 1 tap per tap block; the complex one 4 and 2.
// 4. A 5-step shuffle reduction per frame and plane. Here the cross-phase
//    sum writes the R partials of every frame and plane to shared memory
//    (over the slab) and one thread per frame and plane adds them, r = 0 to
//    R - 1: R adds a frame, against tpp R FMAs.
// 5. 128-frame blocks left small calls on a few SMs. Both instantiations
//    take 32 frames a block, 8 a thread (320 threads), the fastest of six
//    shapes each over the front end's calls (PERF.md keeps the timings):
//    C = 8 x 99 stage-2 frames launch 32 blocks and C = 1 x 3,750 launch
//    118, at the price of re-reading a halo of (tpp - 1) / 32 of the slab
//    from L2.
// Ragged edge: slab rows past the row's last needed input row are zero,
// and frames past n are not written. A bank of filters: row c takes its
// own taps, taps_stride floats after row c - 1's (the channelizer's
// folded dials when its raw carry is float32); stride 0 is one filter.
//
// Variants timed on the card and found no faster (PERF.md): a persistent
// walk in which each block copies its next tile's slab while it computes
// the current one; the slab copied in two parts, half the groups starting
// their FMAs on the first; the cross-phase sum split over lanes, or summed
// by shuffles within half-warps. So a block loads its slab, then runs its
// FMAs, then the sum; on the card the three phases' times add up
// (tools/polyphase_blocks.py times each one left out).
//
// Plain C interface, loaded with ctypes. The function launches on the
// caller's stream, does not synchronise and allocates nothing; it returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 80;     // decimation: samples per slab row
constexpr int kPad = 16;   // floats of padding after every kGroup slab rows

// the two instantiations: taps per phase, output frames per block and
// frames per thread (chosen by timing on the card with
// tools/polyphase_blocks.py, PERF.md)
constexpr int kStage1Tpp = 8;
constexpr int kStage1Frames = 32;
constexpr int kStage1Group = 8;
constexpr int kStage2Tpp = 30;
constexpr int kStage2Frames = 32;
constexpr int kStage2Group = 8;

template <int kTpp, bool kComplex, int kFrames, int kGroup>
struct Block {
  static_assert(kFrames % kGroup == 0 && kFrames % 32 == 0, "block shape");
  static constexpr int kThreads = kR * (kFrames / kGroup);
  static_assert(kThreads <= 1024, "too many threads");
  static constexpr int kRows = kFrames + kTpp - 1;  // slab rows
  // one plane's slab in floats, padding included (a multiple of 4)
  static constexpr int kPlane =
      kRows * kR + kPad * ((kRows + kGroup - 1) / kGroup);
  static constexpr int kLdP = kFrames + 1;  // partials row, floats
  static_assert(2 * kR * kLdP <= 2 * kPlane, "partials fit over the slab");
  static constexpr size_t kSmem = 2 * kPlane * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int kTpp, bool kComplex, int kFrames, int kGroup>
__global__ void __launch_bounds__(
    (Block<kTpp, kComplex, kFrames, kGroup>::kThreads))
polyphase_kernel(const float* __restrict__ xI, const float* __restrict__ xQ,
                 long long in_stride, int vec, const float* __restrict__ gr,
                 const float* __restrict__ gi, long long taps_stride,
                 long long n_frames, float* __restrict__ yI,
                 float* __restrict__ yQ, long long out_stride) {
  using B = Block<kTpp, kComplex, kFrames, kGroup>;
  extern __shared__ __align__(16) float s_slab[];  // [2][kPlane]

  const int tid = threadIdx.x;
  const long long c = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFrames;
  // the row's slab rows are 0 .. n_frames + tpp - 2
  const long long left = n_frames + (kTpp - 1) - m0;
  const int rows_valid = left < B::kRows ? static_cast<int>(left) : B::kRows;
  const float* pI = xI + c * in_stride + m0 * kR;
  const float* pQ = xQ + c * in_stride + m0 * kR;
  gr += c * taps_stride;  // row c's filter (stride 0: one for all)
  gi += c * taps_stride;

  // 1. the slab of both planes, once; element (s, r) of a plane at
  // s R + r + kPad (s / kGroup), rows past rows_valid zero. A slab row is
  // kCols 16-byte chunks (both planes): thread tid copies chunk tid % kCols
  // of rows tid / kCols + k kRowStep.
  {
    constexpr int kCols = 2 * kR / 4;
    constexpr int kRowStep = B::kThreads / kCols;
    static_assert(B::kThreads % kCols == 0, "whole slab rows per pass");
    const int cc = tid % kCols;
    const int plane = cc >= kCols / 2;
    const int col = 4 * (cc - plane * (kCols / 2));
    const int s0 = tid / kCols;
    const float* src = (plane ? pQ : pI) + s0 * kR + col;
    float* dst = s_slab + plane * B::kPlane + col;
#pragma unroll
    for (int k = 0; k < (B::kRows + kRowStep - 1) / kRowStep; ++k) {
      const int s = s0 + k * kRowStep;
      if (s < B::kRows) {
        float* d = dst + s * kR + kPad * (s / kGroup);
        const float* g = src + k * kRowStep * kR;
        if (s >= rows_valid) {
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (vec) {
          cp_async16(d, g);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) cp_async4(d + u, g + u);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // 2. thread (r, grp): phase r's taps in registers, kGroup frames of
  // partials per plane
  const int r = tid % kR;
  const int grp = tid / kR;
  float tr[kTpp];
  float ti[kComplex ? kTpp : 1];
#pragma unroll
  for (int t = 0; t < kTpp; ++t) {
    tr[t] = __ldg(gr + t * kR + r);
    if constexpr (kComplex) ti[t] = __ldg(gi + t * kR + r);
  }
  const float* sI = s_slab + grp * (kGroup * kR + kPad) + r;
  const float* sQ = sI + B::kPlane;
  float aI[kGroup] = {};
  float aQ[kGroup] = {};
#pragma unroll
  for (int j = 0; j < kGroup + kTpp - 1; ++j) {
    // slab row grp kGroup + j
    const int off = j * kR + kPad * (j / kGroup);
    const float xi = sI[off];
    const float xq = sQ[off];
#pragma unroll
    for (int t = 0; t < kTpp; ++t) {
      const int i = j - t;  // the frame of the group this tap block feeds
      if (i >= 0 && i < kGroup) {
        aI[i] = fmaf(tr[t], xi, aI[i]);
        aQ[i] = fmaf(tr[t], xq, aQ[i]);
        if constexpr (kComplex) {
          aI[i] = fmaf(-ti[t], xq, aI[i]);
          aQ[i] = fmaf(ti[t], xi, aQ[i]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the slab; partials go over it

  // 3. cross-phase sum: partials [plane][r][frame], then one thread per
  // frame and plane adds the R phases in order
  float* s_p = s_slab;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    s_p[r * B::kLdP + grp * kGroup + i] = aI[i];
    s_p[(kR + r) * B::kLdP + grp * kGroup + i] = aQ[i];
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * kFrames; idx += B::kThreads) {
    const int comp = idx >= kFrames;
    const int f = idx - comp * kFrames;
    if (m0 + f >= n_frames) continue;
    const float* p = s_p + comp * kR * B::kLdP + f;
    float y = 0.0f;
#pragma unroll 16
    for (int rr = 0; rr < kR; ++rr) y += p[rr * B::kLdP];
    (comp ? yQ : yI)[c * out_stride + m0 + f] = y;
  }
}

template <int kTpp, bool kComplex, int kFrames, int kGroup>
int launch(const float* xI, const float* xQ, long long rows,
           long long in_stride, int vec, const float* gr, const float* gi,
           long long taps_stride, long long n_frames, float* yI, float* yQ,
           long long out_stride, cudaStream_t stream) {
  using B = Block<kTpp, kComplex, kFrames, kGroup>;
  auto kernel = polyphase_kernel<kTpp, kComplex, kFrames, kGroup>;
  if (B::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(B::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>((n_frames + kFrames - 1) / kFrames),
            static_cast<unsigned>(rows));
  kernel<<<grid, B::kThreads, B::kSmem, stream>>>(
      xI, xQ, in_stride, vec, gr, gi, taps_stride, n_frames, yI, yQ,
      out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xI/xQ: float32 (rows, >= n_frames*R + T - R) planar input, row stride
// in_stride elements; vec = 1 only if both base pointers and the row
// stride in bytes are multiples of 16. gr/gi: float32[T] conv-ordered taps,
// one filter per row taps_stride floats apart (0: every row takes the one
// filter). (T, R) must be (640, 80) (complex taps) or (2400, 80) (real
// taps; gi is not read). yI/yQ: float32 outputs, row stride out_stride
// elements. Returns 0 on a good launch, else the CUDA error code.
int polyphase_decimate(const void* xI, const void* xQ, long long rows,
                       long long in_stride, int vec, const void* gr,
                       const void* gi, long long taps_stride, int T, int R,
                       long long n_frames, void* yI, void* yQ,
                       long long out_stride, void* stream) {
  if (rows <= 0 || n_frames <= 0) return 0;
  if (rows > 65535 || R != kR) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const float*>(xI);
  const auto* q = static_cast<const float*>(xQ);
  const auto* tr = static_cast<const float*>(gr);
  const auto* ti = static_cast<const float*>(gi);
  auto* oI = static_cast<float*>(yI);
  auto* oQ = static_cast<float*>(yQ);
  const auto s = static_cast<cudaStream_t>(stream);
  if (T == kStage1Tpp * kR) {
    return launch<kStage1Tpp, true, kStage1Frames, kStage1Group>(
        i, q, rows, in_stride, vec, tr, ti, taps_stride, n_frames, oI, oQ,
        out_stride, s);
  }
  if (T == kStage2Tpp * kR) {
    return launch<kStage2Tpp, false, kStage2Frames, kStage2Group>(
        i, q, rows, in_stride, vec, tr, ti, taps_stride, n_frames, oI, oQ,
        out_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

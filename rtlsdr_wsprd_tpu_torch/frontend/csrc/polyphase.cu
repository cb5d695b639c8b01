// Polyphase complex FIR decimator for Hopper (sm_90a), direct form.
//
// Replaces rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:
// decimate_stage1_pallas (the TPU kernel), and serves both stages of
// the port's front end through one code path:
//   stage 1: R = 80, T = 640 complex taps (fs/4 mixer folded in),
//            uint8 (centred on load, -128) or float32 input;
//   stage 2: R = 80, T = 2400 real taps (gi = 0), float32 input.
//
// For every row c and output frame m, with conv-ordered taps g = gr + i gi:
//   yI[c, m] = sum_k gr[k] xI[c, R m + k] - gi[k] xQ[c, R m + k]
//   yQ[c, m] = sum_k gi[k] xI[c, R m + k] + gr[k] xQ[c, R m + k]
//
// Bound on an H100: stage 1 costs 640 taps x 4 FMA = 5,120 FLOP per output
// frame and reads 160 B of uint8 I/Q, i.e. 32 FLOP per input byte, well
// above the card's ~20 FLOP/B fp32 ridge (67 TFLOP/s over 3.35 TB/s on the
// SXM part). So the FP32 CUDA-core rate bounds it, not HBM.
//
// Design against that bound. The Pallas kernel im2cols each 512-frame
// block into VMEM, which replays every input sample tpp = 8 times into
// the matmul operand; here nothing is replicated. One warp computes one
// output frame: the 32 lanes split the T taps (lane l takes taps
// l, l + 32, ...), so each load instruction of the warp reads 32
// neighbouring samples (coalesced), every lane spends its time on FMAs,
// and a warp-shuffle reduction ends the frame. The taps sit in shared
// memory (5 KB complex for stage 1, 19 KB for stage 2), read
// conflict-free because lanes read neighbouring words. Neighbouring
// frames overlap by T - R samples; those re-reads hit L1/L2, not HBM.
// A block of 8 warps walks kFramesPerBlock frames of one row, so the
// taps are staged once per block. Speed beyond this simple form
// (register tiling several frames per warp, vector loads) is later work.
//
// Plain C interface, loaded with ctypes. The function launches on the
// caller's stream, does not synchronise and allocates nothing; it
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFramesPerBlock = 128;

__device__ __forceinline__ float load_sample(const uint8_t* p) {
  return static_cast<float>(*p) - 128.0f;
}

__device__ __forceinline__ float load_sample(const float* p) { return *p; }

template <typename In>
__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const In* __restrict__ xI, const In* __restrict__ xQ,
                 long long in_stride, const float* __restrict__ gr,
                 const float* __restrict__ gi, int T, int R,
                 long long n_frames, float* __restrict__ yI,
                 float* __restrict__ yQ, long long out_stride) {
  extern __shared__ float s_taps[];  // [0, T): gr, [T, 2T): gi
  for (int k = threadIdx.x; k < T; k += kThreads) {
    s_taps[k] = gr[k];
    s_taps[T + k] = gi[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = blockIdx.y;
  const In* rowI = xI + c * in_stride;
  const In* rowQ = xQ + c * in_stride;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFramesPerBlock;

  for (int f = warp; f < kFramesPerBlock; f += kWarps) {
    const long long m = m0 + f;
    if (m >= n_frames) break;
    const In* pI = rowI + m * R;
    const In* pQ = rowQ + m * R;
    float aI = 0.0f;
    float aQ = 0.0f;
    for (int k = lane; k < T; k += 32) {
      const float xi = load_sample(pI + k);
      const float xq = load_sample(pQ + k);
      const float r = s_taps[k];
      const float im = s_taps[T + k];
      aI = fmaf(r, xi, aI);
      aI = fmaf(-im, xq, aI);
      aQ = fmaf(im, xi, aQ);
      aQ = fmaf(r, xq, aQ);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      aI += __shfl_down_sync(0xffffffffu, aI, off);
      aQ += __shfl_down_sync(0xffffffffu, aQ, off);
    }
    if (lane == 0) {
      yI[c * out_stride + m] = aI;
      yQ[c * out_stride + m] = aQ;
    }
  }
}

template <typename In>
int launch(const void* xI, const void* xQ, long long rows,
           long long in_stride, const float* gr, const float* gi, int T,
           int R, long long n_frames, float* yI, float* yQ,
           long long out_stride, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(T) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        polyphase_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>((n_frames + kFramesPerBlock - 1) /
                                  kFramesPerBlock),
            static_cast<unsigned>(rows));
  polyphase_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(xI), static_cast<const In*>(xQ), in_stride, gr,
      gi, T, R, n_frames, yI, yQ, out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xI/xQ: (rows, >= n_frames*R + T - R) planar input, row stride in_stride
// elements; is_u8 = 1 for uint8 (centred on load), 0 for float32.
// gr/gi: float32[T] conv-ordered taps, T a multiple of R.
// yI/yQ: float32 outputs, row stride out_stride elements.
// Returns 0 on a good launch, else the CUDA error code.
int polyphase_decimate(const void* xI, const void* xQ, int is_u8,
                       long long rows, long long in_stride, const void* gr,
                       const void* gi, int T, int R, long long n_frames,
                       void* yI, void* yQ, long long out_stride,
                       void* stream) {
  if (rows <= 0 || n_frames <= 0) return 0;
  if (rows > 65535 || T <= 0 || R <= 0 || T % R != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g_r = static_cast<const float*>(gr);
  const float* g_i = static_cast<const float*>(gi);
  float* y_i = static_cast<float*>(yI);
  float* y_q = static_cast<float*>(yQ);
  if (is_u8) {
    return launch<uint8_t>(xI, xQ, rows, in_stride, g_r, g_i, T, R, n_frames,
                           y_i, y_q, out_stride, s);
  }
  return launch<float>(xI, xQ, rows, in_stride, g_r, g_i, T, R, n_frames, y_i,
                       y_q, out_stride, s);
}

}  // extern "C"

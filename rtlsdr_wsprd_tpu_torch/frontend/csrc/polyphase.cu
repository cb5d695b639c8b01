// Polyphase complex FIR decimator for Hopper (sm_90a), direct form.
//
// Replaces rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:
// decimate_stage1_pallas (the TPU kernel) beside polyphase_tc.cu, which
// takes the raw front end's uint8 stage-1 calls. This one takes every
// float32 call, through one code path:
//   stage 1: R = 80, T = 640 complex taps (fs/4 mixer folded in);
//   stage 2: R = 80, T = 2400 real taps (gi = 0).
//
// For every row c and output frame m, with conv-ordered taps g = gr + i gi:
//   yI[c, m] = sum_k gr[k] xI[c, R m + k] - gi[k] xQ[c, R m + k]
//   yQ[c, m] = sum_k gi[k] xI[c, R m + k] + gr[k] xQ[c, R m + k]
//
// Bound on an H100: stage 1 costs 640 taps x 4 FMA = 5,120 FLOP per output
// frame and reads 640 B of float32 I/Q, 8 FLOP per input byte; stage 2
// costs 2,400 x 2 FMA = 9,600 FLOP per frame and reads 640 B, 15 FLOP per
// byte. Both sit under the card's ~20 FLOP/B fp32 ridge (67 TFLOP/s over
// 3.35 TB/s on the SXM part), so HBM bounds them, not the FP32 cores.
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

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFramesPerBlock = 128;

__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const float* __restrict__ xI, const float* __restrict__ xQ,
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
  const float* rowI = xI + c * in_stride;
  const float* rowQ = xQ + c * in_stride;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFramesPerBlock;

  for (int f = warp; f < kFramesPerBlock; f += kWarps) {
    const long long m = m0 + f;
    if (m >= n_frames) break;
    const float* pI = rowI + m * R;
    const float* pQ = rowQ + m * R;
    float aI = 0.0f;
    float aQ = 0.0f;
    for (int k = lane; k < T; k += 32) {
      const float xi = pI[k];
      const float xq = pQ[k];
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

}  // namespace

extern "C" {

// xI/xQ: float32 (rows, >= n_frames*R + T - R) planar input, row stride
// in_stride elements. gr/gi: float32[T] conv-ordered taps, T a multiple
// of R. yI/yQ: float32 outputs, row stride out_stride elements.
// Returns 0 on a good launch, else the CUDA error code.
int polyphase_decimate(const void* xI, const void* xQ, long long rows,
                       long long in_stride, const void* gr, const void* gi,
                       int T, int R, long long n_frames, void* yI, void* yQ,
                       long long out_stride, void* stream) {
  if (rows <= 0 || n_frames <= 0) return 0;
  if (rows > 65535 || T <= 0 || R <= 0 || T % R != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(T) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        polyphase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>((n_frames + kFramesPerBlock - 1) /
                                  kFramesPerBlock),
            static_cast<unsigned>(rows));
  polyphase_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xI), static_cast<const float*>(xQ),
      in_stride, static_cast<const float*>(gr), static_cast<const float*>(gi),
      T, R, n_frames, static_cast<float*>(yI), static_cast<float*>(yQ),
      out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

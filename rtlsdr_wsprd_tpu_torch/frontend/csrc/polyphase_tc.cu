// Stage-1 polyphase decimator on Hopper's tensor cores (sm_90a): raw
// uint8 planar I/Q at 2.4 Msps, R = 80, T = 640 complex taps (the fs/4
// mixer folded in), a partial-product GEMM in split TF32.
//
// Replaces rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:78
// (decimate_stage1_pallas, the TPU kernel) for the front end's uint8
// stage-1 calls; polyphase.cu, the direct form, keeps stage 2 and float32
// input.
//
// What it computes. Cut a channel's input into rows of R = 80 samples.
// Row n of A holds the 80 centred I samples, then the 80 centred Q
// samples, of input row n (A is rows x 160). B = [Htop; Hbot] (160 x 16)
// holds the taps: column 2t is the I partial and 2t+1 the Q partial of
// tap block t. With P = A B, output frame m is
//   yI[m] = sum_t P[m + t, 2t],   yQ[m] = sum_t P[m + t, 2t + 1],   t = 0..7,
// which is what the plain version (polyphase.py: polyphase_plain) and the
// JAX package's _polyphase_pp compute.
//
// Bound on an H100 SXM. The main path's 10 s push (C = 8 x 296,000
// frames) reads 378.9 MB of uint8 and writes 18.9 MB of float32: 0.119 ms
// at 3.35 TB/s. Done as direct-form FMAs its 12.1 GFLOP take 0.181 ms on
// the FP32 cores, above that byte floor, and the direct form reaches about
// a sixth of that rate. On the tensor cores the two split products are
// 24.2 GFLOP, 0.05 ms at 495 TFLOP/s dense TF32. So bytes bound this
// kernel; the design reads each input byte from HBM about once and keeps
// the arithmetic off the FP32 pipe.
//
// Precision. TF32 keeps 10 explicit mantissa bits. Centred uint8 values
// are integers in [-128, 127], exact in TF32, so A needs no split. A tap
// rounded to TF32 is off by up to 2^-11 of itself, which over 640 taps at
// +-128 input misses the 1e-3 tolerance (2.5e-3 in a float64 emulation
// on 4,000 frames); split as B = B_hi + B_lo, both exact in TF32, the two
// products A B_hi + A B_lo, summed in float32, stay within 5.2e-7 there.
// The host makes the split (polyphase.py: tf32_split) and lays both parts
// out in B-fragment order (tc_fragments), so this kernel rounds nothing.
//
// Design.
// - One block per (row c, tile of kRows input rows). Its kWarps warps own
//   kMTiles tiles of 16 rows each: kRows = 16 kWarps kMTiles input rows
//   yield kRows - 7 output frames, and the grid is (ceil(n / (kRows - 7)),
//   C). (kWarps, kMTiles) = (8, 2), 256 rows and 249 frames a block, was
//   the fastest of five shapes timed at the 10 s push (PERF.md; 9,512
//   blocks there, 264 at 8,000 frames).
// - The A tile sits in shared memory as the raw bytes, in rows of 176
//   bytes (160 used, 16 of padding, so the eight rows that one fragment
//   load touches fall in distinct banks). Each 16-byte chunk is stored
//   4x4-transposed, so one 32-bit load gives a lane its four A values of
//   two k-steps. A byte b becomes the TF32 operand b - 128 by a byte
//   permute (b under the exponent of 2^23) and one float subtract, not by
//   the quarter-rate int-to-float conversion.
// - Loads: 16 bytes a thread where both planes' rows start 16-byte
//   aligned (the main path's do: row stride 80 n + 560), else one byte a
//   thread. Each input byte is read from HBM about once; the 7-row halo
//   that neighbouring tiles share is re-read, mostly from L2. A thread
//   issues all its loads (5 kMTiles) before it uses the first; that and
//   occupancy, not a copy pipeline, hide the loads' latency.
// - mma.sync.m16n8k8 TF32: per k-step (20) and column tile (2) a lane
//   loads its B fragments (hi and lo, 16 bytes, in the order tc_fragments
//   lays out) from global memory, where the 20 KB table stays in L1, and
//   the warp's kMTiles row tiles share them: 4 kMTiles mma per load.
// - The accumulators go to shared memory over the A tile; one thread per
//   output frame and component takes the diagonal sum (in the plain
//   version's order) and stores it, coalesced.
// - Ragged edge: input rows past the channel's last needed row are not
//   loaded and read as centred 0; frames past n are not written.
//
// Plain C interface, loaded with ctypes. The function launches on the
// caller's stream, does not synchronise and allocates nothing; it returns
// cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 80;             // samples per input row (decimation)
constexpr int kTpp = 8;            // tap blocks: T = 640 = 8 x 80
constexpr int kK = 2 * kR;         // GEMM depth: the I row, then the Q row
constexpr int kN = 2 * kTpp;       // GEMM width: I and Q partial per block
constexpr int kKSteps = kK / 8;    // 20 mma k-steps
constexpr int kNTiles = kN / 8;    // 2 mma column tiles
constexpr int kLdA = kK + 16;      // A row in shared memory, bytes
constexpr int kLdP = kN + 1;       // P row in shared memory, floats
constexpr int kChunks = kR / 16;   // 16-byte chunks per plane row
constexpr uint32_t kPad = 0x80808080u;  // four bytes of 128: centred 0
constexpr int kWarps = 8;          // warps per block
constexpr int kMTiles = 2;         // tiles of 16 input rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * kMTiles * 16;  // input rows per block
constexpr int kFrames = kRows - (kTpp - 1);   // output frames per block
constexpr int kSmem = kRows * kLdA;           // the A tile, bytes
static_assert(kSmem <= 48 * 1024, "no opt-in shared memory needed");

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// byte j of w as the TF32 operand byte - 128 (exact): the bytes
// (b, 0, 0, 0x4B) are the float 2^23 + b
template <int j>
__device__ __forceinline__ uint32_t centred(uint32_t w) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | j));
  return __float_as_uint(f - 8388736.0f);  // 2^23 + 128
}

// 4x4 byte transpose of a 16-byte chunk: word t of the result holds
// bytes t, t + 4, t + 8 and t + 12, a lane's A values for two k-steps
__device__ __forceinline__ uint4 transpose4x4(uint4 v) {
  const uint32_t lo01 = __byte_perm(v.x, v.y, 0x5140);
  const uint32_t hi01 = __byte_perm(v.x, v.y, 0x7362);
  const uint32_t lo23 = __byte_perm(v.z, v.w, 0x5140);
  const uint32_t hi23 = __byte_perm(v.z, v.w, 0x7362);
  return make_uint4(
      __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
      __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
}

__global__ void __launch_bounds__(kThreads)
polyphase_tc_kernel(const uint8_t* __restrict__ xI,
                    const uint8_t* __restrict__ xQ, long long in_stride,
                    int vec, const float4* __restrict__ bfrag,
                    long long n_frames, float* __restrict__ yI,
                    float* __restrict__ yQ, long long out_stride) {
  static_assert(kLdP * sizeof(float) <= kLdA, "P must fit over the A tile");
  extern __shared__ __align__(16) uint8_t s_a[];  // kRows * kLdA bytes

  const int tid = threadIdx.x;
  const long long c = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFrames;
  // the channel's input rows are 0 .. n_frames + 6
  const long long left = n_frames + (kTpp - 1) - m0;
  const int rows_valid = left < kRows ? static_cast<int>(left) : kRows;
  const uint8_t* pI = xI + c * in_stride + m0 * kR;
  const uint8_t* pQ = xQ + c * in_stride + m0 * kR;

  // 1. the A tile's bytes, each 16-byte chunk transposed, into shared memory
  if (vec) {
    // all of a thread's loads are issued before the first is used, so
    // each thread keeps kLoads 16-byte loads in flight
    constexpr int kLoads = kRows * 2 * kChunks / kThreads;  // 5 kMTiles
    static_assert(kLoads * kThreads == kRows * 2 * kChunks, "even split");
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int row = i / (2 * kChunks);
      const int part = i - row * 2 * kChunks;
      const int plane = part / kChunks;  // 0: I, 1: Q
      const int col = (part - plane * kChunks) * 16;
      v[u] = make_uint4(kPad, kPad, kPad, kPad);
      if (row < rows_valid) {
        v[u] = __ldg(reinterpret_cast<const uint4*>((plane ? pQ : pI) +
                                                    row * kR + col));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int row = i / (2 * kChunks);
      const int part = i - row * 2 * kChunks;
      const int plane = part / kChunks;
      const int col = (part - plane * kChunks) * 16;
      *reinterpret_cast<uint4*>(s_a + row * kLdA + plane * kR + col) =
          transpose4x4(v[u]);
    }
  } else {
    for (int i = tid; i < kRows * kK; i += kThreads) {
      const int row = i / kK;
      const int k = i - row * kK;
      const int plane = k >= kR;
      const int r = k & 15;
      uint8_t v = 0x80;
      if (row < rows_valid) v = (plane ? pQ : pI)[row * kR + k - plane * kR];
      s_a[row * kLdA + (k - r) + 4 * (r & 3) + (r >> 2)] = v;
    }
  }
  __syncthreads();

  // 2. P = A B_hi + A B_lo for this warp's kMTiles tiles of 16 rows
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // lane (g, t): rows g and g + 8 of each tile; in chunk q the word at
  // byte 4t holds A[., 16q + t], A[., 16q + t + 4], A[., 16q + t + 8] and
  // A[., 16q + t + 12]: a0/a2 of k-step 2q, then of k-step 2q + 1
  const uint8_t* a_lane = s_a + (warp * kMTiles * 16 + g) * kLdA + 4 * t;
  float acc[kMTiles][kNTiles][4] = {};
#pragma unroll 2
  for (int q = 0; q < kKSteps / 2; ++q) {
    float4 b[2][kNTiles];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        b[h][j] = __ldg(bfrag + ((2 * q + h) * kNTiles + j) * 32 + lane);
      }
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const uint8_t* p = a_lane + i * 16 * kLdA + 16 * q;
      const uint32_t top = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t bot = *reinterpret_cast<const uint32_t*>(p + 8 * kLdA);
      const uint32_t a0[4] = {centred<0>(top), centred<0>(bot),
                              centred<1>(top), centred<1>(bot)};
      const uint32_t a1[4] = {centred<2>(top), centred<2>(bot),
                              centred<3>(top), centred<3>(bot)};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        mma_tf32(acc[i][j], a0, b[0][j].x, b[0][j].y);  // B_hi
        mma_tf32(acc[i][j], a0, b[0][j].z, b[0][j].w);  // B_lo
        mma_tf32(acc[i][j], a1, b[1][j].x, b[1][j].y);
        mma_tf32(acc[i][j], a1, b[1][j].z, b[1][j].w);
      }
    }
  }
  __syncthreads();  // every warp is done with A; P goes over it

  float* s_p = reinterpret_cast<float*>(s_a);
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      float* p = s_p + ((warp * kMTiles + i) * 16 + g) * kLdP + 8 * j + 2 * t;
      p[0] = acc[i][j][0];
      p[1] = acc[i][j][1];
      p[8 * kLdP] = acc[i][j][2];
      p[8 * kLdP + 1] = acc[i][j][3];
    }
  }
  __syncthreads();

  // 3. diagonal sums: the tile's yI frames, then its yQ frames
  for (int idx = tid; idx < 2 * kFrames; idx += kThreads) {
    const int comp = idx >= kFrames;
    const int m = idx - comp * kFrames;
    if (m0 + m >= n_frames) continue;
    float y = 0.0f;
#pragma unroll
    for (int tt = 0; tt < kTpp; ++tt) y += s_p[(m + tt) * kLdP + 2 * tt + comp];
    (comp ? yQ : yI)[c * out_stride + m0 + m] = y;
  }
}

}  // namespace

extern "C" {

// xI/xQ: uint8 (rows, >= n_frames*80 + 560) planar input, row stride
// in_stride bytes; vec = 1 only if both base pointers and in_stride are
// multiples of 16. bfrag: float32 [20, 2, 32, 4], polyphase.py's
// tc_fragments of the stage-1 taps. yI/yQ: float32 outputs, row stride
// out_stride elements. Returns 0 on a good launch, else the CUDA error.
int polyphase_tc_decimate(const void* xI, const void* xQ, long long rows,
                          long long in_stride, int vec, const void* bfrag,
                          long long n_frames, void* yI, void* yQ,
                          long long out_stride, void* stream) {
  if (rows <= 0 || n_frames <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((n_frames + kFrames - 1) / kFrames),
            static_cast<unsigned>(rows));
  polyphase_tc_kernel<<<grid, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xI), static_cast<const uint8_t*>(xQ),
      in_stride, vec, static_cast<const float4*>(bfrag), n_frames,
      static_cast<float*>(yI), static_cast<float*>(yQ), out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

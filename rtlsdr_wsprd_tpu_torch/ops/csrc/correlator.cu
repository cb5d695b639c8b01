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
// E_TONE[j, t] = exp(-i w_t j), so z = exp(i w_t o_l) (S_t[o_l + 256] -
// S_t[o_l]) with the prefix sums S_t[u] = sum_{u' < u} y[u'] E512[u', t],
// E512 the same phasors for u' < 512 (ops/sync.py _prefix_tone_table,
// rounded from float64 as E_TONE is; its first 256 rows are E_TONE's).
// The unit factor goes under the magnitude, so a symbol's 4 x L
// magnitudes take 4 x 512 complex multiply-adds and 4 x L differences,
// not 4 x L x 256 multiply-adds. The phase, the derotation's products
// and the magnitude are rounded as the plain version's float32
// elementwise ops round them (no fast-math: cosf/sinf, and __fmul_rn
// where a product must not fuse into an FMA); the sums are taken in
// another order.
//
// What bounds it on an H100: bytes. Reading the two window planes once
// and writing the magnitudes is 0.017 ms at 128 lanes x L = 43; the
// work is the derotation (a cosf and a sinf a sample, 162 x 512 a lane)
// and 4 x 512 complex multiply-adds a symbol (tools/torch_measure.py
// correlator_work). The design, a blocked prefix-sum correlator:
// - One block per (lane, group of 24 symbols), 4 warps; a warp takes
//   one symbol at a time, all 4 tones. Lane k takes the 16 consecutive
//   samples 16k .. 16k + 15 of the double frame: 8 16-byte loads, the
//   next symbol's issued before this one's arithmetic. It derotates
//   them and runs the 4 tones' sums over them, storing the exclusive
//   partial (the in-block prefix) at each position an offset reads (o
//   and o + 256: 86 of the 513 at the 43 jitters, 2 in quickmode), one
//   slot each, in ascending order (the wrapper's plan). E512 is staged
//   once a block, [sample in block][lane], so that a warp's 32 lanes
//   read 32 neighbouring entries.
// - A shuffle scan over the 32 lane totals gives each block's prefix:
//   S at position p is block prefix p / 16 plus partial p. No sum chain
//   is longer than 16 + 32 terms, and a difference is taken as
//   (prefix difference) + (partial difference).
// - Then the warp's lanes take the L offsets: 8 shared loads, 4
//   differences and magnitudes, one 16-byte store each, neighbouring
//   lanes on neighbouring offsets (coalesced).
// - The precise cosf/sinf of the derotation are most of a symbol's
//   instructions and latency (a branch to the slow path, never taken
//   here, keeps a warp from overlapping one sample's with the next):
//   sincosf shares their argument reduction, and keeping only the read
//   positions leaves 31 KB a block at the 43 jitters, so that 4 blocks
//   (16 warps) fit an SM to hide the latency.
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
constexpr int kLanes = 32;
constexpr int kPer = kFrame / kLanes;     // 16 samples a lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kLanes;
constexpr int kSymsPerWarp = 6;
constexpr int kGroup = kWarps * kSymsPerWarp;  // 24 symbols a block
constexpr int kPrefixes = kLanes + 1;     // block prefixes 0..32
constexpr int kPositions = kFrame + 1;    // S is read at positions 0..512
constexpr int kToneF4 = 2 * kFrame;       // E512 re, im: [16][32] each

// dynamic shared memory a block takes for ``n_slots`` stored positions:
// E512, then a warp's partials re, im [n_slots] and prefixes re, im [33]
int correlator_shared_bytes(int n_slots) {
  return (kToneF4 + kWarps * (2 * n_slots + 2 * kPrefixes)) * 16;
}

static_assert(kPer % 4 == 0, "a lane's samples are whole float4s");

__device__ __forceinline__ float comp(const float4& v, int t) {
  return t == 0 ? v.x : (t == 1 ? v.y : (t == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kThreads, 4)
correlator_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                  const float* __restrict__ freq,
                  const float* __restrict__ drift,
                  const int32_t* __restrict__ plan, int n_offsets,
                  int n_slots, const float* __restrict__ etone,
                  float twopidt, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* e_re = smem4;                   // E512[16k + m] at m * 32 + k
  float4* e_im = smem4 + kFrame;
  const int warp = threadIdx.x / kLanes;
  const int k = threadIdx.x % kLanes;
  float4* p_re = smem4 + kToneF4 + warp * (2 * n_slots + 2 * kPrefixes);
  float4* p_im = p_re + n_slots;                    // [slot]
  float4* b_re = p_im + n_slots;                    // [block]
  float4* b_im = b_re + kPrefixes;
  // the positions of lane k's samples that an offset reads (bit m for
  // position 16k + m) and the slot of the first; position 512's slot
  const unsigned need = static_cast<unsigned>(plan[k]);
  const int base = plan[kLanes + k];
  const int slot512 = plan[2 * kLanes];
  const int32_t* triples = plan + 2 * kLanes + 1;   // (o, slot o, slot o+256)

  const int g = blockIdx.x;
  const int i0 = blockIdx.y * kGroup;
  {
    const float4* et = reinterpret_cast<const float4*>(etone);
    for (int u = threadIdx.x; u < kFrame; u += kThreads) {
      const int s = (u % kPer) * kLanes + u / kPer;
      e_re[s] = et[u];
      e_im[s] = et[kFrame + u];
    }
  }
  // position 512 (offset 256's end): block prefix 32, partial 0
  if (k == 0 && slot512 >= 0)
    p_re[slot512] = p_im[slot512] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int iend = min(i0 + kGroup, kSyms);
  int i = i0 + warp;
  if (i >= iend) return;
  const float f0 = freq[g];
  const float half = drift[g] / 2.0f;
  const float* xr = wr + static_cast<size_t>(g) * kWlen + kPer * k;
  const float* xi = wi + static_cast<size_t>(g) * kWlen + kPer * k;
  float4 cr[kPer / 4], ci[kPer / 4];
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    cr[q] = reinterpret_cast<const float4*>(xr + i * kSpS)[q];
    ci[q] = reinterpret_cast<const float4*>(xi + i * kSpS)[q];
  }
  for (; i < iend; i += kWarps) {
    // the next symbol's samples, in flight while this one is summed
    float4 nr[kPer / 4] = {}, ni[kPer / 4] = {};
    if (i + kWarps < iend) {
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        nr[q] = reinterpret_cast<const float4*>(xr + (i + kWarps) * kSpS)[q];
        ni[q] = reinterpret_cast<const float4*>(xi + (i + kWarps) * kSpS)[q];
      }
    }
    const float fp = f0 + (half * static_cast<float>(i - kHalfBits)) /
                              static_cast<float>(kHalfBits);
    const float dphi = twopidt * fp;
    float sr[4] = {0.f, 0.f, 0.f, 0.f}, si[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      if ((need >> m) & 1u) {
        const int slot = base + __popc(need & ((1u << m) - 1u));
        p_re[slot] = make_float4(sr[0], sr[1], sr[2], sr[3]);
        p_im[slot] = make_float4(si[0], si[1], si[2], si[3]);
      }
      const float ar = comp(cr[m / 4], m % 4);
      const float ai = comp(ci[m / 4], m % 4);
      const float ph = dphi * static_cast<float>(kPer * k + m);
      // cosf and sinf with one argument reduction, bit for bit theirs
      float sn, ecr;
      sincosf(ph, &sn, &ecr);
      const float eci = -sn;
      const float yr = __fmul_rn(ar, ecr) - __fmul_rn(ai, eci);
      const float yi = __fmul_rn(ar, eci) + __fmul_rn(ai, ecr);
      const float4 er = e_re[m * kLanes + k];
      const float4 ei = e_im[m * kLanes + k];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        sr[t] = fmaf(yr, comp(er, t), sr[t]);
        sr[t] = fmaf(-yi, comp(ei, t), sr[t]);
        si[t] = fmaf(yr, comp(ei, t), si[t]);
        si[t] = fmaf(yi, comp(er, t), si[t]);
      }
    }
    // the lanes' block sums: an inclusive scan, then each lane's
    // exclusive prefix (the previous lane's inclusive one)
    float inc[8] = {sr[0], sr[1], sr[2], sr[3], si[0], si[1], si[2], si[3]};
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float o = __shfl_up_sync(0xffffffffu, inc[j], off);
        if (k >= off) inc[j] += o;
      }
    }
    float ex[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ex[j] = __shfl_up_sync(0xffffffffu, inc[j], 1);
      if (k == 0) ex[j] = 0.0f;
    }
    b_re[k] = make_float4(ex[0], ex[1], ex[2], ex[3]);
    b_im[k] = make_float4(ex[4], ex[5], ex[6], ex[7]);
    if (k == kLanes - 1) {
      b_re[kLanes] = make_float4(inc[0], inc[1], inc[2], inc[3]);
      b_im[kLanes] = make_float4(inc[4], inc[5], inc[6], inc[7]);
    }
    __syncwarp();

    float4* o_sym = reinterpret_cast<float4*>(
        out + (static_cast<size_t>(g) * kSyms + i) * n_offsets * 4);
    for (int l = k; l < n_offsets; l += kLanes) {
      const int o = triples[3 * l];
      const int k0 = o / kPer;
      const int k1 = k0 + kSpS / kPer;  // o + 256 lies 16 blocks on
      const int s0 = triples[3 * l + 1];
      const int s1 = triples[3 * l + 2];
      const float4 br0 = b_re[k0], br1 = b_re[k1];
      const float4 bi0 = b_im[k0], bi1 = b_im[k1];
      const float4 pr0 = p_re[s0], pr1 = p_re[s1];
      const float4 pi0 = p_im[s0], pi1 = p_im[s1];
      float mag[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float zr = (comp(br1, t) - comp(br0, t)) +
                         (comp(pr1, t) - comp(pr0, t));
        const float zi = (comp(bi1, t) - comp(bi0, t)) +
                         (comp(pi1, t) - comp(pi0, t));
        mag[t] = sqrtf(__fmul_rn(zr, zr) + __fmul_rn(zi, zi));
      }
      o_sym[l] = make_float4(mag[0], mag[1], mag[2], mag[3]);
    }
    // the next symbol overwrites the partials the offsets read
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      cr[q] = nr[q];
      ci[q] = ni[q];
    }
  }
}

}  // namespace

// wr, wi float32[n, 41728] lane windows, 16-byte aligned; freq, drift
// float32[n]; plan int32[65 + 3 * n_offsets] (ops/sync.py
// _correlator_plan: for each lane k of a warp the bit mask of the
// positions 16k .. 16k + 15 an offset reads and the slot of the first,
// position 512's slot or -1, then for each offset (o, the slot of o,
// the slot of o + 256)), n_slots (1..513) the positions stored; etone
// float32[2, 512, 4] (E512 re then im); output float32[n, 162,
// n_offsets, 4]. All device pointers, contiguous, on the current
// device. Launches on ``stream``; returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int tone_correlator(const void* wr, const void* wi,
                               const void* freq, const void* drift,
                               const void* plan, int n_offsets, int n_slots,
                               const void* etone, float twopidt,
                               int n_lanes, void* out, void* stream) {
  if (n_lanes <= 0 || n_offsets <= 0) return 0;
  if (n_slots < 1 || n_slots > kPositions)
    return static_cast<int>(cudaErrorInvalidValue);
  // a block's shared memory may pass the 48 KB default: opt in once a
  // device, for the most positions
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(correlator_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               correlator_shared_bytes(kPositions));
    if (err != cudaSuccess) return static_cast<int>(err);
    // the whole unified cache as shared memory, for the most blocks an SM
    err = cudaFuncSetAttribute(correlator_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const dim3 grid(static_cast<unsigned>(n_lanes),
                  static_cast<unsigned>((kSyms + kGroup - 1) / kGroup));
  correlator_kernel<<<grid, kThreads, correlator_shared_bytes(n_slots),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const float*>(freq), static_cast<const float*>(drift),
      static_cast<const int32_t*>(plan), n_offsets, n_slots,
      static_cast<const float*>(etone), twopidt, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

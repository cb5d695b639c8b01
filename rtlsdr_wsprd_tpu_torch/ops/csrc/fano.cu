// Batched Fano sequential decoder for the WSPR K=32 r=1/2 code, one
// lane per thread, for sm_90a.
//
// Replaces rtlsdr_wsprd_tpu/ops/fano.py:91 batched_fano, an XLA
// while-loop program (no Pallas kernel) that steps every lane in
// lockstep over (B, 82) node arrays. Here each thread runs one lane's
// search as the sequential C does (native/hostdsp.cpp wspr_fano_decode,
// the reference's wsprd/fano.c semantics, bit for bit): the current
// node lives in registers, the node stack (gamma, encoder state, the
// two sorted branch metrics, the branch index; 82 nodes) in the
// thread's local memory, and the threshold is tightened by an add loop.
// The tail explores only the 0-branch; ties go to the 1-branch.
//
// Memory: the metric table (2 x 256 int32, 2 KB) is loaded into shared
// memory once per block, and so are the block's symbol rows (162 bytes
// a lane). A node's two branch metrics are computed from the lane's two
// symbol bytes and the shared table when the walk first reaches the
// node, instead of from a 1.3 KB per-lane table.
//
// What bounds it on an H100: each lane's serial dependency chain. A
// step (one forward look or one backtrack move) is a few tens of
// dependent integer instructions and a local-memory access, and a lane
// that times out at the full budget takes ~1.2M of them. The work is
// small (bytes and integer operations are both far below the card's
// rates); a call of 512 lanes at 128 threads a block fills 4 blocks on
// 4 of the 132 SMs, and a warp runs as long as its slowest lane
// (divergence). Making it fast is later work: warp-cooperative lanes,
// more lanes a call, or a register-resident window of the node stack.
//
// Outputs follow the C: success (break iteration < maxcycles*81),
// metric, cycles (break iteration + 1, or maxcycles*81 + 2 on timeout),
// maxnp (the position at the top of every cycle, its maximum), the 11
// decoded bytes (zero where the lane did not succeed), and optionally
// the lane's flat step count. Padding lanes (valid false) write zeros.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;
constexpr int kNBits = 81;
constexpr int kTail = kNBits - 31;  // first node of the all-zero tail
constexpr int kSyms = 2 * kNBits;   // 162 soft symbols a lane
constexpr int kThreads = 128;

__device__ __forceinline__ int encode_sym(uint32_t state) {
  return ((__popc(state & kPoly1) & 1) << 1) | (__popc(state & kPoly2) & 1);
}

struct Node {
  int32_t gamma;
  uint32_t enc;
  int32_t tm0, tm1;
  int32_t branch;
};

__global__ void __launch_bounds__(kThreads)
fano_kernel(const uint8_t* __restrict__ symbols,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ mettab, int n_lanes, int32_t delta,
            uint32_t maxcycles, uint8_t* __restrict__ out_data,
            uint8_t* __restrict__ out_success,
            int32_t* __restrict__ out_metric,
            int32_t* __restrict__ out_cycles,
            int32_t* __restrict__ out_maxnp,
            int32_t* __restrict__ out_steps) {
  __shared__ int32_t met[2 * 256];
  __shared__ uint8_t sym_s[kThreads * kSyms];

  const int lane0 = blockIdx.x * kThreads;
  const int lanes_here = min(kThreads, n_lanes - lane0);
  for (int k = threadIdx.x; k < 2 * 256; k += kThreads) met[k] = mettab[k];
  const uint8_t* src = symbols + static_cast<size_t>(lane0) * kSyms;
  for (int k = threadIdx.x; k < lanes_here * kSyms; k += kThreads) {
    sym_s[k] = src[k];
  }
  __syncthreads();

  const int lane = lane0 + threadIdx.x;
  if (threadIdx.x >= lanes_here) return;
  uint8_t* data = out_data + static_cast<size_t>(lane) * 11;
  if (valid != nullptr && !valid[lane]) {
    for (int k = 0; k < 11; ++k) data[k] = 0;
    out_success[lane] = 0;
    out_metric[lane] = 0;
    out_cycles[lane] = 0;
    out_maxnp[lane] = 0;
    if (out_steps != nullptr) out_steps[lane] = 0;
    return;
  }
  const uint8_t* sym = sym_s + threadIdx.x * kSyms;
  const int32_t* m0 = met;
  const int32_t* m1 = met + 256;
  // branch metric of node n for the 2-bit transmitted symbol s
  auto branch_metric = [&](int n, int s) -> int32_t {
    const int s0 = sym[2 * n];
    const int s1 = sym[2 * n + 1];
    return ((s & 2) ? m1[s0] : m0[s0]) + ((s & 1) ? m1[s1] : m0[s1]);
  };

  Node nd[kNBits + 1];
  int32_t cg, ctm0, ctm1, cbr;
  uint32_t cenc;
  {
    // root: the 0-branch of the all-zero state sends symbol 0, the
    // complement branch symbol 3
    const int32_t b0 = branch_metric(0, 0);
    const int32_t b1 = branch_metric(0, 3);
    cg = 0;
    cbr = 0;
    if (b0 > b1) {
      cenc = 0;
      ctm0 = b0;
      ctm1 = b1;
    } else {
      cenc = 1;
      ctm0 = b1;
      ctm1 = b0;
    }
  }

  int pos = 0;
  int32_t t = 0;
  int32_t maxnp = 0;
  int32_t steps = 0;
  const unsigned long long max_total =
      static_cast<unsigned long long>(maxcycles) * kNBits;

  for (unsigned long long i = 1;; ++i) {
    ++steps;
    maxnp = pos > maxnp ? pos : maxnp;
    const int32_t ngamma = cg + (cbr ? ctm1 : ctm0);
    if (ngamma >= t) {
      // forward move; tighten the threshold on first visits
      if (cg < t + delta) {
        while (ngamma >= t + delta) t += delta;
      }
      nd[pos].gamma = cg;
      nd[pos].enc = cenc;
      nd[pos].tm0 = ctm0;
      nd[pos].tm1 = ctm1;
      nd[pos].branch = cbr;
      const int newpos = pos + 1;
      const uint32_t enc_new = cenc << 1;
      if (newpos == kNBits) {
        const bool ok = i < max_total;
        for (int k = 0; k < 10; ++k) {
          data[k] = ok ? static_cast<uint8_t>(nd[7 + 8 * k].enc & 0xFFu) : 0;
        }
        data[10] = 0;
        out_success[lane] = ok ? 1 : 0;
        out_metric[lane] = ngamma;
        out_cycles[lane] = static_cast<int32_t>(i + 1);
        out_maxnp[lane] = maxnp;
        if (out_steps != nullptr) out_steps[lane] = steps;
        return;
      }
      const int lsym = encode_sym(enc_new);
      const int32_t b0 = branch_metric(newpos, lsym);
      const int32_t b1 = branch_metric(newpos, 3 ^ lsym);
      cg = ngamma;
      if (newpos >= kTail) {
        cenc = enc_new;
        ctm0 = b0;  // the tail explores only the 0-branch
      } else {
        // best branch first; the complement encoder bit when the
        // 1-branch wins (ties go to the 1-branch, as the reference)
        ctm0 = b0 > b1 ? b0 : b1;
        ctm1 = b0 > b1 ? b1 : b0;
        cenc = enc_new + (b0 <= b1 ? 1u : 0u);
      }
      cbr = 0;
      pos = newpos;
    } else {
      // backtrack walk; each move is one flat step
      for (;;) {
        ++steps;
        if (pos == 0 || nd[pos - 1].gamma < t) {
          t -= delta;  // origin (or first visit below threshold): relax
          if (cbr != 0) {
            cbr = 0;
            cenc ^= 1u;
          }
          break;
        }
        --pos;
        cg = nd[pos].gamma;
        cenc = nd[pos].enc;
        ctm0 = nd[pos].tm0;
        ctm1 = nd[pos].tm1;
        cbr = nd[pos].branch;
        if (pos < kTail && cbr != 1) {
          cbr += 1;
          cenc ^= 1u;
          break;
        }
      }
    }
    if (i >= max_total) {
      for (int k = 0; k < 11; ++k) data[k] = 0;
      out_success[lane] = 0;
      out_metric[lane] = cg;
      out_cycles[lane] = static_cast<int32_t>(max_total + 2);
      out_maxnp[lane] = maxnp;
      if (out_steps != nullptr) out_steps[lane] = steps;
      return;
    }
  }
}

}  // namespace

// symbols uint8[n, 162] deinterleaved, valid uint8/bool[n] or null,
// mettab int32[2, 256]; outputs data uint8[n, 11], success uint8/bool[n],
// metric/cycles/maxnp int32[n], steps int32[n] or null. All device
// pointers, contiguous. Launches on ``stream``; returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int fano_decode_lanes(const void* symbols, const void* valid,
                                 const void* mettab, int n_lanes, int delta,
                                 unsigned maxcycles, void* out_data,
                                 void* out_success, void* out_metric,
                                 void* out_cycles, void* out_maxnp,
                                 void* out_steps, void* stream) {
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  fano_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(symbols),
      static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(mettab), n_lanes, delta, maxcycles,
      static_cast<uint8_t*>(out_data), static_cast<uint8_t*>(out_success),
      static_cast<int32_t*>(out_metric), static_cast<int32_t*>(out_cycles),
      static_cast<int32_t*>(out_maxnp), static_cast<int32_t*>(out_steps));
  return static_cast<int>(cudaGetLastError());
}

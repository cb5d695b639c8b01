// Batched Fano sequential decoder for the WSPR K=32 r=1/2 code, one
// lane per thread, for sm_90a.
//
// Replaces rtlsdr_wsprd_tpu/ops/fano.py:91 batched_fano, an XLA
// while-loop program (no Pallas kernel) that steps every lane in
// lockstep over (B, 82) node arrays. Each thread runs one lane's search
// with the semantics of the reference's wsprd/fano.c (as
// native/hostdsp.cpp wspr_fano_decode), bit for bit, written as that
// program's flattened state machine: one loop iteration is one flat
// step of every live lane, a forward look where `back` is false and one
// backtrack move where it is true. ops/fano.py batched_fano_plain is the
// same machine in PyTorch, and the per-lane step counts agree.
//
// What bounds it on an H100: each lane's serial dependency chain. A
// call's bytes (162 a lane in, 24 out) and instructions (under a
// hundred a step) are far below the card's rates, while a lane that times
// out at the full budget takes ~1.2M dependent steps and a warp runs as
// long as its slowest lane. So the design shortens a step's chain and
// keeps a warp's lanes in step:
// - The node stack is in shared memory, one 16-byte record a node
//   (gamma, encoder state, the two sorted branch metrics as int16, the
//   branch index) laid out [node][lane]: a forward move is one 128-bit
//   store and a backtrack move one 128-bit load. With lanes a block a
//   multiple of 8, a quarter-warp's 16-byte accesses fall on distinct
//   bank groups whatever each lane's depth. Nothing is in local memory.
// - Each lane's branch metrics are precomputed in a prologue: 81 nodes
//   x 4 transmitted symbols as int16, [node][lane]. A forward look reads
//   its two metrics with one 64-bit load whose address depends only on
//   the position, so it issues before the encoder parity is known.
// - One converged step an iteration: both paths are computed with
//   selects and a predicated store, so a warp pays one step a lane and
//   not the sum of both paths. The threshold is tightened in closed form
//   (a reciprocal multiply with an exact correction: no division, no
//   add loop), and the counters are 32-bit.
// Hopper's matrix units (wgmma, mma.sync) and its TMA have nothing to do
// here: there is no matrix product, and a lane's input is 162 bytes.
// What the kernel uses is shared memory and its banks, registers, and
// short chains; a step (two shared loads, one predicated store and
// some 90 instructions that one warp issues with little overlap) is
// what bounds it now.
//
// Branch metrics are int16: a sum of two metric-table entries must fit,
// so the wrapper (ops/fano.py) refuses tables with entries outside
// [-2^14, 2^14). METTAB's lie in -137..5. gamma and the threshold stay
// int32.
//
// Shared memory (dynamic): kLanes x 1,968 bytes, 82 rows of node
// records (16 bytes) and 82 of branch metrics (8 bytes). Record row
// p + 1 holds node p and metric row n node n, so that the loads of the
// node above and of the next node's metrics need no clamp: row 0 of the
// records is read at the origin and metric row 81 at the last node, and
// neither value is used. The prologue stages the metric table and the
// block's symbol rows inside the record area, which the search writes
// only after a barrier.
//
// Outputs follow the C: success (break iteration < maxcycles*81),
// metric, cycles (break iteration + 1, or maxcycles*81 + 2 on timeout),
// maxnp (the position at every forward look, its maximum), the 11
// decoded bytes (zero where the lane did not succeed), and optionally
// the lane's flat step count. A lane times out only once it is out of
// its backtrack walk. Padding lanes (valid false) write zeros.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;
constexpr int kNBits = 81;
constexpr int kTail = kNBits - 31;  // first node of the all-zero tail
constexpr int kSyms = 2 * kNBits;   // 162 soft symbols a lane
constexpr int kLanes = 32;          // lanes (threads) a block
constexpr int kRows = kNBits + 1;
// node records uint4[kRows][kLanes], then branch metrics
// uint2[kRows][kLanes]
constexpr int kRecBytes = kRows * 16 * kLanes;
constexpr int kSmemBytes = kRecBytes + kRows * 8 * kLanes;
static_assert(kLanes % 16 == 0,
              "conflict-free 64-bit metric loads need lanes a multiple of 16");
static_assert(2 * 256 * 4 + kSyms * kLanes <= kRecBytes,
              "the prologue's staging must fit in the record area");

__device__ __forceinline__ int encode_sym(uint32_t state) {
  return ((__popc(state & kPoly1) & 1) << 1) | (__popc(state & kPoly2) & 1);
}

__device__ __forceinline__ uint32_t pack16(int32_t lo, int32_t hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) | (static_cast<uint32_t>(hi) << 16);
}

// The metrics of transmitted symbols lsym and 3 ^ lsym from a node's
// four, packed as int16 (x = m0 | m1 << 16, y = m2 | m3 << 16).
__device__ __forceinline__ void branch_pair(uint2 m, int lsym, int32_t& b0,
                                            int32_t& b1) {
  const uint32_t w0 = (lsym & 2) ? m.y : m.x;  // holds lsym
  const uint32_t w1 = (lsym & 2) ? m.x : m.y;  // holds 3 ^ lsym
  const int sh = (lsym & 1) ? 0 : 16;          // lift the wanted half high
  b0 = static_cast<int32_t>(w0 << sh) >> 16;
  b1 = static_cast<int32_t>(w1 << (16 - sh)) >> 16;
}

// The C's threshold tightening on a first visit,
//   while (ngamma >= t + delta) t += delta;
// in closed form for ngamma >= t: t + delta * ((ngamma - t) / delta),
// that is ngamma - r with r = (ngamma - t) mod delta. The difference is
// taken in uint32 (exact below 2^32); the quotient by a multiply with
// dinv = (2^32 - 1) / delta is low by at most one, corrected once.
__device__ __forceinline__ int32_t tighten(int32_t t, int32_t ngamma,
                                           uint32_t delta, uint32_t dinv) {
  const uint32_t n = static_cast<uint32_t>(ngamma) - static_cast<uint32_t>(t);
  uint32_t r = n - __umulhi(n, dinv) * delta;
  r = r >= delta ? r - delta : r;
  return static_cast<int32_t>(static_cast<uint32_t>(ngamma) - r);
}

__global__ void __launch_bounds__(kLanes)
fano_kernel(const uint8_t* __restrict__ symbols,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ mettab, int n_lanes, int32_t delta,
            uint32_t maxcycles, uint8_t* __restrict__ out_data,
            uint8_t* __restrict__ out_success,
            int32_t* __restrict__ out_metric,
            int32_t* __restrict__ out_cycles,
            int32_t* __restrict__ out_maxnp,
            int32_t* __restrict__ out_steps) {
  extern __shared__ uint4 smem[];
  uint4* const rec = smem;  // node p of lane l at rec[(p + 1) * kLanes + l]
  uint2* const bm = reinterpret_cast<uint2*>(smem + kRows * kLanes);
  // prologue staging, inside the record area
  int32_t* const met = reinterpret_cast<int32_t*>(smem);  // [2][256]
  uint8_t* const sym_s = reinterpret_cast<uint8_t*>(smem) + 2 * 256 * 4;

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int lanes_here = min(kLanes, n_lanes - lane0);
  for (int k = tid; k < 2 * 256; k += kLanes) met[k] = mettab[k];
  // the block's symbol rows are contiguous: 16-byte copies where aligned
  const uint8_t* src = symbols + static_cast<size_t>(lane0) * kSyms;
  const int nbytes = lanes_here * kSyms;
  int copied = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    copied = nbytes / 16 * 16;
    for (int k = tid; k < copied / 16; k += kLanes) {
      reinterpret_cast<uint4*>(sym_s)[k] = reinterpret_cast<const uint4*>(src)[k];
    }
  }
  for (int k = copied + tid; k < nbytes; k += kLanes) sym_s[k] = src[k];
  __syncthreads();

  const int lane = lane0 + tid;
  const bool live = tid < lanes_here && (valid == nullptr || valid[lane]);
  if (live) {
    // branch metrics by transmitted symbol (wsprd/fano.c:118-124)
    const uint8_t* sy = sym_s + tid * kSyms;
    for (int n = 0; n < kNBits; ++n) {
      const int s0 = sy[2 * n];
      const int s1 = sy[2 * n + 1];
      const int32_t a0 = met[s0], a1 = met[256 + s0];
      const int32_t c0 = met[s1], c1 = met[256 + s1];
      bm[n * kLanes + tid] =
          make_uint2(pack16(a0 + c0, a0 + c1), pack16(a1 + c0, a1 + c1));
    }
    bm[kNBits * kLanes + tid] = make_uint2(0u, 0u);  // the pad row
  }
  __syncthreads();  // the record area is the node stack from here on
  if (tid >= lanes_here) return;
  uint8_t* data = out_data + static_cast<size_t>(lane) * 11;
  if (!live) {
    for (int k = 0; k < 11; ++k) data[k] = 0;
    out_success[lane] = 0;
    out_metric[lane] = 0;
    out_cycles[lane] = 0;
    out_maxnp[lane] = 0;
    if (out_steps != nullptr) out_steps[lane] = 0;
    return;
  }

  uint4* const my_rec = rec + tid;
  const uint2* const my_bm = bm + tid;
  const uint32_t udelta = static_cast<uint32_t>(delta);
  const uint32_t dinv = 0xFFFFFFFFu / udelta;
  const uint32_t max_total = maxcycles * kNBits;

  // current node (the record of node pos lives in registers; the stack
  // holds nodes 0..pos-1). The root: the 0-branch of the all-zero state
  // sends symbol 0, the complement symbol 3; ties go to the 1-branch.
  int32_t b0, b1;
  branch_pair(my_bm[0], 0, b0, b1);
  int32_t cg = 0;
  uint32_t cenc = b0 <= b1 ? 1u : 0u;
  int32_t ctm0 = b0 > b1 ? b0 : b1;
  int32_t ctm1 = b0 > b1 ? b1 : b0;
  uint32_t cbr = 0;
  int off = 0;      // pos * kLanes: the row offset of the position
  int off_max = 0;  // maxnp * kLanes
  int32_t t = 0;
  int32_t steps = 0;
  uint32_t i = 0;   // the C's cycle index: forward looks so far
  bool back = false;

  for (;;) {
    ++steps;
    // both loads' addresses depend only on the position: the node above
    // (for a backtrack move) and the next node's metrics (for a forward
    // move)
    const uint4 up = my_rec[off];
    const uint2 nm = my_bm[off + kLanes];

    // forward look (wsprd/fano.c:152-197)
    const int32_t ngamma = cg + (cbr ? ctm1 : ctm0);
    const bool fwd = !back && ngamma >= t;
    if (fwd) my_rec[off + kLanes] = make_uint4(cg, cenc, pack16(ctm0, ctm1), cbr);
    // tighten the threshold on first visits
    const int32_t t_fwd =
        cg < t + delta ? tighten(t, ngamma, udelta, dinv) : t;
    const uint32_t enc0 = cenc << 1;
    branch_pair(nm, encode_sym(enc0), b0, b1);
    // best branch first, the complement encoder bit when the 1-branch
    // wins (ties to the 1-branch); the tail explores only the 0-branch
    const bool swap = off < (kTail - 1) * kLanes && b0 <= b1;

    // one backtrack move (wsprd/fano.c:199-219): relax at the origin or
    // where the node above lies below the threshold, else move up and
    // take its other branch where it has one
    const bool relax = off == 0 || static_cast<int32_t>(up.x) < t;
    const bool b_relax = back && relax;
    const bool b_up = back && !relax;
    const bool alt = b_up && off <= kTail * kLanes && up.w == 0u;

    if (!back) {
      i += 1;
      off_max = off > off_max ? off : off_max;
    }
    t = fwd ? t_fwd : (b_relax ? t - delta : t);
    cg = fwd ? ngamma : (b_up ? static_cast<int32_t>(up.x) : cg);
    ctm0 = fwd ? (swap ? b1 : b0)
               : (b_up ? static_cast<int32_t>(up.z << 16) >> 16 : ctm0);
    ctm1 = fwd ? (swap ? b0 : b1)
               : (b_up ? static_cast<int32_t>(up.z) >> 16 : ctm1);
    // encoder state: the new node's, with the 1-branch's bit where it
    // won; the node above's, flipped where its other branch is taken;
    // or the relaxed node's, back on its 0-branch
    const uint32_t enc = fwd ? enc0 : (b_up ? up.y : cenc);
    const uint32_t flip = fwd ? swap : (b_up ? alt : (b_relax ? cbr : 0u));
    cenc = enc ^ flip;
    cbr = b_up ? (up.w | alt) : ((fwd || b_relax) ? 0u : cbr);
    off += fwd ? kLanes : (b_up ? -kLanes : 0);
    back = back ? !(relax || alt) : !fwd;

    // the last node reached, or the budget spent out of a walk
    if (off == kNBits * kLanes || (!back && i >= max_total)) break;
  }

  // gamma of the current node: the path metric at the end, or where
  // the budget ran out
  out_metric[lane] = cg;
  out_maxnp[lane] = off_max / kLanes;
  if (out_steps != nullptr) out_steps[lane] = steps;
  const bool reached = off == kNBits * kLanes;
  const bool ok = reached && i < max_total;
  for (int k = 0; k < 10; ++k) {  // nodes 7, 15, ..., 79: rows 8, ..., 80
    data[k] = ok ? static_cast<uint8_t>(my_rec[(8 + 8 * k) * kLanes].y & 0xFFu)
                 : 0;
  }
  data[10] = 0;
  out_success[lane] = ok ? 1 : 0;
  out_cycles[lane] = static_cast<int32_t>(reached ? i + 1 : max_total + 2);
}

}  // namespace

// symbols uint8[n, 162] deinterleaved, valid uint8/bool[n] or null,
// mettab int32[2, 256] (entries in [-2^14, 2^14)); outputs data
// uint8[n, 11], success uint8/bool[n], metric/cycles/maxnp int32[n],
// steps int32[n] or null. All device pointers, contiguous, on the
// current device. Launches on ``stream``; returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int fano_decode_lanes(const void* symbols, const void* valid,
                                 const void* mettab, int n_lanes, int delta,
                                 unsigned maxcycles, void* out_data,
                                 void* out_success, void* out_metric,
                                 void* out_cycles, void* out_maxnp,
                                 void* out_steps, void* stream) {
  if (n_lanes <= 0) return 0;
  // a block's shared memory is above the 48 KB default: opt in once a
  // device
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(fano_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const int blocks = (n_lanes + kLanes - 1) / kLanes;
  fano_kernel<<<blocks, kLanes, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(symbols),
      static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(mettab), n_lanes, delta, maxcycles,
      static_cast<uint8_t*>(out_data), static_cast<uint8_t*>(out_success),
      static_cast<int32_t*>(out_metric), static_cast<int32_t*>(out_cycles),
      static_cast<int32_t*>(out_maxnp), static_cast<int32_t*>(out_steps));
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a block of fano_kernel takes, in bytes
extern "C" int fano_shared_bytes() { return kSmemBytes; }

"""Stage A's coarse grid kernel and stage B's tone correlator
(ops/csrc/coarse.cu, ops/csrc/correlator.cu) against their plain
PyTorch versions, on the CPU.

- The wrappers (``coarse_search``/``coarse_rows``, ``_tone_mags_offsets``)
  send CPU tensors to the plain versions and launch nothing.
- On a CUDA tensor they launch the kernel or raise: with the loader made
  to fail, a call raises instead of returning the plain result, and the
  argument checks raise on a wrong dtype, shape or stride. CUDA tensors
  are stood in for by CPU tensors that report a CUDA device; everything
  the wrappers do before loading the kernel reads only that.
- The shared 3-row candidate pick, fed the plain version's rows (as the
  kernel's int32 indices too), equals ``coarse_search_plain``.
- Each kernel's own source, compiled with g++ over a small emulation of
  the CUDA constructs it uses (threads of a block as std::threads meeting
  at a std::barrier, warp shuffles and __syncwarp through a per-warp
  exchange, gridDim set by the launcher, and stft.cu's asynchronous
  staging helpers as a memcpy done at once with no-op commit and wait;
  tests/test_torch_stft_kernel.py runs that source), against the plain
  version: coarse at B=2 in its wide tiles
  and at B=1 and B=4 (a zero-padded window at maxdrift 0) in its small
  ones, the correlator at G=3 and L = 1, 17, 33 and 43. The coarse
  source's runs of symbols are ``_fd_int``'s.
- The correlator's algebra: the blocked prefix-sum form, in float64,
  equals the plain version's direct form within 1e-9 of its scale.
- The work formulas of tools/torch_measure.py: the direct form's FLOPs
  (``*_direct_work``), and the kernels' own counts at most those.
- On a card (marked ``cuda``; chip_smoke.py's ``search`` phase is the
  check there), each kernel against its plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu_torch.ops import coarse as pcoarse
from rtlsdr_wsprd_tpu_torch.ops import stft as pstft
from rtlsdr_wsprd_tpu_torch.ops import sync as psync

from torch_parity import import_tools, windows3

CSRC = Path(pcoarse.__file__).resolve().parent / "csrc"
# the correlator's tolerance against the plain version: the JAX
# package's own for its correlator against the direct form (float32
# sums of 256 terms in another order)
CORR_RTOL, CORR_ATOL = 2e-4, 2e-3
# a coarse row's value against the plain version's: float32 sums of
# 648 terms in another order
COARSE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this file's tests: they hold two runs of a
    plain version equal bit for bit, and on a loaded host MKL may split
    one run's product over another number of threads and round it
    differently."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spectrogram():
    """The power spectrograms of the first 2 of windows3() (two
    signals; one signal), in the layout power_spectrogram returns, with
    rows 100-139 of window 1 zeroed: rows 106-134 read only those, and
    every grid point of theirs ties."""
    wi, wq = windows3()
    ps = pstft.power_spectrogram(_t(wi[:2]), _t(wq[:2])).clone()
    ps[1, 100:140] = 0.0
    return ps


def _offsets(kind: str) -> tuple:
    if kind.startswith("lags"):
        rel = psync._rel_lags(int(kind[4:]))
    else:
        rel = psync.jitter_offsets(3, quickmode=(kind == "quick"))
    return tuple(int(r) + psync.HALF_SPAN for r in rel)


OFFSET_SETS = {1: "quick", 17: "lags16", 33: "lags8", 43: "jitter"}


def _lanes(G: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    wr = rng.normal(0, 1, (G, psync.WLEN)).astype(np.float32)
    wi = rng.normal(0, 1, (G, psync.WLEN)).astype(np.float32)
    freq = np.linspace(-110, 105, G).astype(np.float32)
    drift = np.linspace(-4, 3, G).astype(np.float32)
    return wr, wi, freq, drift


# ---- routing on the CPU, no fallback on the card -------------------------


def test_coarse_wrapper_routes_cpu_to_plain(spectrogram):
    """coarse_search on CPU tensors is coarse_search_plain, field for
    field, and launches nothing."""
    bins = torch.tensor([[40, 80, 200], [10, 95, 300]], dtype=torch.int32)
    md = torch.tensor([4, 2], dtype=torch.int32)
    before = pcoarse.coarse_search.launches
    got = pcoarse.coarse_search(spectrogram, bins, md)
    want = pcoarse.coarse_search_plain(spectrogram, bins, md)
    assert pcoarse.coarse_search.launches == before
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_correlator_wrapper_routes_cpu_to_plain():
    """_tone_mags_offsets on CPU tensors is _tone_mags_offsets_plain,
    bit for bit, and launches nothing."""
    wr, wi, freq, drift = (_t(a) for a in _lanes(2))
    offs = _offsets("lags8")
    before = psync._tone_mags_offsets.launches
    got = psync._tone_mags_offsets(wr, wi, freq, drift, offs)
    want = psync._tone_mags_offsets_plain(wr, wi, freq, drift, offs)
    assert psync._tone_mags_offsets.launches == before
    assert torch.equal(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports device cuda:0."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


class _LoaderCalled(Exception):
    pass


@pytest.fixture()
def failing_loaders(monkeypatch):
    """torch.cuda.is_available() true, and both kernels' loaders raising
    _LoaderCalled."""
    def boom():
        raise _LoaderCalled

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pcoarse, "_load_kernel", boom)
    monkeypatch.setattr(psync, "_load_kernel", boom)


def test_no_fallback_when_the_kernel_cannot_load(failing_loaders,
                                                 spectrogram):
    """A CUDA-typed call whose kernel does not load raises; it never
    returns the plain result. The plain versions stay reachable on the
    CPU."""
    bins = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(_LoaderCalled):
        pcoarse.coarse_search(_card(spectrogram), bins, 4)
    wr, wi, freq, drift = (_card(_t(a)) for a in _lanes(2))
    with pytest.raises(_LoaderCalled):
        psync._tone_mags_offsets(wr, wi, freq, drift, _offsets("jitter"))
    pcoarse.coarse_search(spectrogram, bins, 4)


def test_no_fallback_without_nvcc(monkeypatch, spectrogram):
    """Without a CUDA compiler (as on this host) the kernels' first use
    fails to build, and the CUDA-typed call raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        pcoarse.coarse_rows(_card(spectrogram), 4)
    wr, wi, freq, drift = (_card(_t(a)) for a in _lanes(1))
    with pytest.raises(RuntimeError, match="not found"):
        psync._tone_mags_offsets(wr, wi, freq, drift, (0, 128))


def test_coarse_argument_checks(failing_loaders, spectrogram):
    """float32 (B, 512, 347) in the spectrogram's transposed layout, and
    maxdrift an int or 1 or B ints; anything else, a row-major copy
    included, raises before the kernel is loaded."""
    with pytest.raises(_LoaderCalled):
        pcoarse.coarse_rows(_card(spectrogram), torch.tensor([4, 0]))
    bad = {
        "dtype": spectrogram.double(),
        "row-major": spectrogram.contiguous(),
        "shape": spectrogram[:, :256],
        "stride": torch.zeros((2, 512, 400))[:, :, :347],
        "rank": spectrogram[0],
    }
    for what, ps in bad.items():
        with pytest.raises(ValueError):
            pcoarse.coarse_rows(_card(ps), 4)
    for md in (torch.tensor([4, 4, 4]), torch.tensor([4.0, 4.0])):
        with pytest.raises(ValueError):
            pcoarse._maxdrift_rows(md, 2, torch.device("cpu"))
    assert pcoarse._maxdrift_rows(3, 2, torch.device("cpu")).tolist() == \
        [3, 3]


def test_correlator_argument_checks(failing_loaders):
    """float32 (G, 41728) windows and (G,) freq/drift, all contiguous,
    the windows 16-byte aligned, offsets in [0, 256]; anything else
    raises before the kernel is loaded."""
    wr, wi, freq, drift = (_t(a) for a in _lanes(2))
    offs = _offsets("lags8")
    with pytest.raises(_LoaderCalled):
        psync._tone_mags_offsets(*map(_card, (wr, wi, freq, drift)), offs)
    bad = [
        (wr.double(), wi, freq, drift, offs),
        (wr[:, :-1], wi, freq, drift, offs),
        (wr, wi, freq[:1], drift, offs),
        (torch.zeros((psync.WLEN, 2)).t(), wi, freq, drift, offs),
        (wr, wi, torch.zeros(4)[::2], drift, offs),
        (torch.zeros(2 * psync.WLEN + 1)[1:].reshape(2, -1), wi, freq,
         drift, offs),
        (wr, wi, freq, drift.to(torch.float64), offs),
        (wr, wi, freq, drift, (0, 257)),
        (wr, wi, freq, drift, (-1,)),
        (wr, wi, freq, drift, ()),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            psync._tone_mags_offsets(*map(_card, args[:4]), args[4])


# ---- the shared candidate pick -------------------------------------------


@pytest.mark.parametrize("maxdrift", [4, 0, "per-window"])
def test_pick_from_plain_rows_equals_plain(spectrogram, maxdrift):
    """_pick_candidates fed the plain version's row values and indices
    (int64, and as the kernel's int32) equals coarse_search_plain,
    candidates at the band edges (rows clamped to 0 and 511) included."""
    md = torch.tensor([4, 1]) if maxdrift == "per-window" else maxdrift
    bins = torch.tensor([[-52, 40, 80, 200, 410, 460],
                         [10, 60, 95, 300, 49, -51]], dtype=torch.int32)
    want = pcoarse.coarse_search_plain(spectrogram, bins, md)
    val, arg = pcoarse._row_max_plain(spectrogram, md)
    for a in (arg, arg.to(torch.int32)):
        got = pcoarse._pick_candidates(val, a, bins)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- the kernels' own sources on the host --------------------------------

_SHIM = textwrap.dedent("""\
    #include <algorithm>
    #include <barrier>
    #include <cmath>
    #include <cstdint>
    #include <cstring>
    #include <thread>
    #include <vector>
    #define __global__
    #define __device__
    #define __host__
    #define __forceinline__ inline
    #define __launch_bounds__(...)
    #define __restrict__
    struct Dim3 { unsigned x, y; };
    thread_local Dim3 threadIdx, blockIdx, blockDim;
    static Dim3 gridDim;  // set by a launcher before its blocks run
    static std::barrier<>* g_bar;
    static std::vector<std::barrier<>*> g_warp_bar;
    // a warp's shuffles alternate between two exchanges, so one barrier
    // a shuffle suffices: a lane writes an exchange only after the
    // barrier of the shuffle between, which every lane reaches after
    // reading it
    static uint64_t g_slot[2][1024];
    thread_local unsigned t_shuffles;
    inline void __syncthreads() { g_bar->arrive_and_wait(); }
    // lane t + delta's value (t ^ delta's when xor); a lane past the
    // warp's edge keeps its own
    template <class T>
    T exchange(T v, int src) {
      const unsigned t = threadIdx.x;
      uint64_t* slot = g_slot[t_shuffles++ & 1];
      std::memcpy(&slot[t], &v, sizeof(T));
      g_warp_bar[t / 32]->arrive_and_wait();
      T r = v;
      if (src >= 0 && src < 32)
        std::memcpy(&r, &slot[t - t % 32 + src], sizeof(T));
      return r;
    }
    template <class T>
    T __shfl_xor_sync(unsigned, T v, int lane_mask) {
      return exchange(v, int(threadIdx.x % 32) ^ lane_mask);
    }
    template <class T>
    T __shfl_down_sync(unsigned, T v, int delta) {
      return exchange(v, int(threadIdx.x % 32) + delta);
    }
    template <class T>
    T __shfl_up_sync(unsigned, T v, int delta) {
      return exchange(v, int(threadIdx.x % 32) - delta);
    }
    inline void __syncwarp() { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
    // an asynchronous 16-byte copy into shared memory, done at once: its
    // commit groups have nothing left to wait for
    inline void stage_copy16(void* smem, const void* gmem) {
      std::memcpy(smem, gmem, 16);
    }
    inline void stage_commit() {}
    template <int N>
    void stage_wait() {}
    inline int __popc(unsigned v) { return __builtin_popcount(v); }
    inline float __fmul_rn(float a, float b) { return a * b; }
    struct alignas(8) float2 { float x, y; };
    inline float2 make_float2(float x, float y) { return {x, y}; }
    struct alignas(16) float4 { float x, y, z, w; };
    inline float4 make_float4(float x, float y, float z, float w) {
      return {x, y, z, w};
    }
    alignas(16) static unsigned char g_smem[232448];  // a block's most
    using std::min;
    // one block of ``threads`` threads at a time, each running body()
    template <class F>
    void run_block(unsigned bx, unsigned by, unsigned threads, F body) {
      std::barrier<> bar(threads);
      g_bar = &bar;
      std::vector<std::barrier<>*> warps;
      for (unsigned w = 0; w < (threads + 31) / 32; ++w)
        warps.push_back(new std::barrier<>(std::min(32u, threads - 32 * w)));
      g_warp_bar = warps;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([=] {
          threadIdx = {t, 0};
          blockIdx = {bx, by};
          blockDim = {threads, 1};
          body();
        });
      for (auto& th : ts) th.join();
      for (auto* w : warps) delete w;
    }
    """)

_COARSE_LAUNCHER = textwrap.dedent("""\
    static_assert(smem_bytes<kWideRows, kWideWarps>() <= sizeof(g_smem));
    // the launch csrc/coarse.cu's entry point makes, its tile chosen by
    // ``wide`` instead of the card's SM count
    template <int R, int W>
    void launch(const float* ps, const float* sign, const int32_t* maxdrift,
                int n, float* row_val, int32_t* row_arg) {
      for (unsigned b = 0; b < unsigned(n) * (kRows / tile_rows<R, W>());
           ++b)
        run_block(b, 0, kLags * W, [=] {
          coarse_rows_kernel<R, W>(ps, sign, maxdrift, row_val, row_arg);
        });
    }
    extern "C" void emu_coarse(const float* ps, const float* sign,
                               const int32_t* maxdrift, int n, int wide,
                               float* row_val, int32_t* row_arg) {
      if (wide)
        launch<kWideRows, kWideWarps>(ps, sign, maxdrift, n, row_val,
                                      row_arg);
      else
        launch<kNarrowRows, kNarrowWarps>(ps, sign, maxdrift, n, row_val,
                                          row_arg);
    }
    // COARSE_RUNS as rows of (first, end, fd of drifts 0..8); returns
    // the number of runs
    extern "C" int emu_runs(int* out) {
      int n = 0;
    #define EMU_RUN(...) { const int r[] = {__VA_ARGS__}; \\
                           for (int v : r) out[n++] = v; }
      COARSE_RUNS(EMU_RUN)
      return n / 11;
    }
    """)

_CORRELATOR_LAUNCHER = textwrap.dedent("""\
    extern "C" void emu_correlator(const float* wr, const float* wi,
                                   const float* freq, const float* drift,
                                   const int32_t* plan, int L, int n_slots,
                                   const float* etone, float twopidt,
                                   int n, float* out) {
      for (int g = 0; g < n; ++g)
        for (int y = 0; y < (kSyms + kGroup - 1) / kGroup; ++y)
          run_block(g, y, kThreads, [=] {
            correlator_kernel(wr, wi, freq, drift, plan, L, n_slots, etone,
                              twopidt, out);
          });
    }
    extern "C" int emu_shared_bytes(int n_slots) {
      return correlator_shared_bytes(n_slots);
    }
    """)


def _build(tmp: Path, source: str, shared_decl: str, shared_ptr: str,
           launcher: str):
    """``csrc/<source>``'s kernel (everything before its first
    ``extern "C"``), its dynamic shared array pointed at the shim's
    buffer, compiled with g++ over the shim; returns the library."""
    src = (CSRC / source).read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    assert src.count(shared_decl) == 1
    src = src.replace(shared_decl, shared_ptr)
    body = src[:src.index('extern "C"')]
    cpp = tmp / (source + ".cpp")
    cpp.write_text(_SHIM + body + launcher)
    lib = tmp / ("lib" + source + ".so")
    r = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-o", str(lib),
                        str(cpp)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def coarse_lib(tmp_path_factory):
    lib = _build(tmp_path_factory.mktemp("coarse_emu"), "coarse.cu",
                 "extern __shared__ float2 smem2[];",
                 "float2* const smem2 = reinterpret_cast<float2*>(g_smem);",
                 _COARSE_LAUNCHER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.emu_coarse.argtypes = [vp, vp, vp, ci, ci, vp, vp]
    lib.emu_runs.argtypes = [vp]
    lib.emu_runs.restype = ci
    return lib


@pytest.fixture(scope="module")
def emulated_coarse(coarse_lib):
    def run(ps: torch.Tensor, maxdrift: np.ndarray, wide: bool = True):
        # the kernel reads the transposed layout: (B, 347, 512) row-major
        host = ps.transpose(1, 2).contiguous().numpy()
        B = host.shape[0]
        md = np.ascontiguousarray(maxdrift, np.int32)
        sign = np.ascontiguousarray(pcoarse._PR3_SIGN, np.float32)
        val = np.zeros((B, 512), np.float32)
        arg = np.zeros((B, 512), np.int32)
        coarse_lib.emu_coarse(host.ctypes.data, sign.ctypes.data,
                              md.ctypes.data, B, int(wide), val.ctypes.data,
                              arg.ctypes.data)
        return val, arg

    return run


@pytest.fixture(scope="module")
def emulated_correlator(tmp_path_factory):
    lib = _build(tmp_path_factory.mktemp("correlator_emu"), "correlator.cu",
                 "extern __shared__ float4 smem4[];",
                 "float4* const smem4 = reinterpret_cast<float4*>(g_smem);",
                 _CORRELATOR_LAUNCHER)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.emu_correlator.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp,
                                   ctypes.c_float, ci, vp]
    lib.emu_shared_bytes.argtypes = [ci]
    lib.emu_shared_bytes.restype = ci
    # the most shared memory a block can take (every position kept)
    assert lib.emu_shared_bytes(513) <= 232448

    def run(wr, wi, freq, drift, offsets):
        G, L = wr.shape[0], len(offsets)
        # the kernel reads the windows 16 bytes at a time
        assert wr.ctypes.data % 16 == 0 and wi.ctypes.data % 16 == 0
        plan, n_slots = psync._correlator_plan(tuple(offsets))
        etone = psync._prefix_tone_table()
        out = np.zeros((G, 162, L, 4), np.float32)
        lib.emu_correlator(wr.ctypes.data, wi.ctypes.data, freq.ctypes.data,
                           drift.ctypes.data, plan.ctypes.data, L, n_slots,
                           etone.ctypes.data, float(np.float32(psync.TWOPIDT)),
                           G, out.ctypes.data)
        return out

    return run


def assert_rows_match(val, arg, ps, maxdrift):
    """Row values within COARSE_RTOL of the plain version's; indices
    equal wherever the plain row's best and second best differ by more
    than that, and on rows where both are exactly equal (zero power):
    there the first index must win. Returns the number of near-ties."""
    want_val, want_arg = pcoarse._row_max_plain(ps, maxdrift)
    want_val, want_arg = want_val.numpy(), want_arg.numpy()
    np.testing.assert_allclose(val, want_val, rtol=COARSE_RTOL, atol=1e-7)
    top2 = torch.topk(pcoarse._sync_grid_plain(ps, maxdrift), 2,
                      dim=-1).values
    best, second = top2[..., 0].numpy(), top2[..., 1].numpy()
    tol = COARSE_RTOL * np.abs(best) + 1e-7
    # a row of zero power ties exactly: there the first index must win
    near = (best - second <= tol) & ~((best == second) & (best == 0))
    np.testing.assert_array_equal(arg[~near], want_arg[~near])
    return int(near.sum())


@pytest.mark.parametrize("maxdrift", [(4, 4), (0, 0), (4, 2)],
                         ids=["md4", "md0", "per-window"])
def test_coarse_source_emulated_matches_plain(emulated_coarse, spectrogram,
                                              maxdrift):
    """csrc/coarse.cu run on the host at B=2 in its wide tiles (32 rows
    a block), in the spectrogram's own layout: each row's value within
    1e-5 of the plain version's, its (lag, drift) index equal outside
    near-ties, the zeroed rows' index the first unmasked one, and the
    candidates' (freq, shift, drift) equal to coarse_search_plain's."""
    md = np.asarray(maxdrift)
    val, arg = emulated_coarse(spectrogram, md)
    near = assert_rows_match(val, arg, spectrogram, torch.from_numpy(md))
    assert near <= 4, near
    # rows that read only zeroed rows (r - 6 .. r + 5): every grid point
    # 0 or -inf, the index lag 0 and the first drift within maxdrift
    np.testing.assert_array_equal(arg[1, 106:135], 4 - min(md[1], 4))
    assert (val[1, 106:135] == 0).all()

    from rtlsdr_wsprd_tpu_torch.ops import candidates as pcand
    bins = pcand.find_candidates(spectrogram).bin_idx
    got = pcoarse._pick_candidates(_t(val), _t(arg), bins)
    want = pcoarse.coarse_search_plain(spectrogram, bins,
                                       torch.from_numpy(md))
    for f in ("freq", "shift", "drift"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_allclose(got.sync.numpy(), want.sync.numpy(),
                               rtol=COARSE_RTOL, atol=1e-7)


@pytest.mark.parametrize("B", [1, 4])
def test_coarse_source_emulated_small_batches(emulated_coarse, B):
    """csrc/coarse.cu's small-batch tiles (8 rows a block), as the
    dense step's chunk of 4 windows (its last one zero-padded, maxdrift
    0 there) and decode_window's one window launch it: rows within 1e-5
    of the plain version's, indices equal outside near-ties, and every
    row of the zero window value 0 at index 4 (lag 0, drift 0)."""
    wi, wq = windows3()
    si = np.zeros((B, wi.shape[1]), np.float32)
    sq = np.zeros_like(si)
    n = B - 1 if B > 1 else 1
    si[:n], sq[:n] = wi[:n], wq[:n]
    ps = pstft.power_spectrogram(_t(si), _t(sq))
    md = np.full(B, 4)
    if B > 1:
        md[-1] = 0
    val, arg = emulated_coarse(ps, md, wide=False)
    assert_rows_match(val, arg, ps, torch.from_numpy(md))
    if B > 1:
        assert (val[-1] == 0).all()
        np.testing.assert_array_equal(arg[-1], 4)


def test_coarse_runs_are_fd_int(coarse_lib):
    """The runs of symbols compiled into csrc/coarse.cu (COARSE_RUNS)
    tile 0..161 in order, and on each run the drifts' offsets are
    _fd_int()'s at every symbol; the signs the wrapper passes are +1
    exactly where PR3_VECTOR is set."""
    out = np.zeros(64 * 11, np.int32)
    n = coarse_lib.emu_runs(out.ctypes.data)
    runs = out[:n * 11].reshape(n, 11)
    assert runs[0, 0] == 0 and runs[-1, 1] == 162
    assert (runs[1:, 0] == runs[:-1, 1]).all()
    fd = pcoarse._fd_int()
    for first, end, *offs in runs:
        assert first < end
        np.testing.assert_array_equal(fd[first:end],
                                      np.broadcast_to(offs, (end - first, 9)))
    # each run is as long as it can be: the offsets change between runs
    assert all((runs[k, 2:] != runs[k + 1, 2:]).any() for k in range(n - 1))
    from rtlsdr_wsprd_tpu_torch.utils.channel import PR3_VECTOR
    assert pcoarse._PR3_SIGN.dtype == np.float32
    np.testing.assert_array_equal(pcoarse._PR3_SIGN, 2.0 * PR3_VECTOR - 1)


@pytest.mark.parametrize("L", sorted(OFFSET_SETS))
def test_correlator_source_emulated_matches_plain(emulated_correlator, L):
    """csrc/correlator.cu run on the host at G=3 lanes and the decode's
    offset sets (L = 1 quickmode jitter, 17 quickmode fine-sync lags, 33
    fine-sync lags, 43 jitters): within rtol 2e-4, atol 2e-3 of the
    plain version."""
    wr, wi, freq, drift = _lanes(3, seed=L)
    offs = _offsets(OFFSET_SETS[L])
    got = emulated_correlator(wr, wi, freq, drift, offs)
    want = psync._tone_mags_offsets_plain(_t(wr), _t(wi), _t(freq),
                                          _t(drift), offs).numpy()
    np.testing.assert_allclose(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)


def _prefix_form(wr, wi, freq, drift, offsets):
    """The correlator as csrc/correlator.cu factors it, in torch at the
    inputs' precision: derotate as the plain version does, multiply by
    exp(-i w_t u) over the 512-sample frame, sum blocks of 16 samples
    (each position's exclusive partial within its block), scan the block
    sums, and take |S(o + 256) - S(o)| with S(p) the prefix of block
    p // 16 plus partial p (S(512) the frame's total)."""
    G, L = wr.shape[0], len(offsets)
    yr, yi = psync._derotate(psync._double_frames(wr),
                             psync._double_frames(wi),
                             *psync._cand_phasor_conj(freq, drift,
                                                      ulen=psync.ULEN))
    ang = psync.TWOPIDT * psync.DF * np.outer(np.arange(psync.ULEN),
                                              psync._t)
    er = torch.from_numpy(np.cos(ang)).to(wr.dtype)
    ei = torch.from_numpy(-np.sin(ang)).to(wr.dtype)
    pr = yr[..., None] * er - yi[..., None] * ei    # (G, 162, 512, 4)
    pi = yr[..., None] * ei + yi[..., None] * er

    def prefix(x):
        blk = x.reshape(G, 162, 32, 16, 4)
        part = torch.nn.functional.pad(torch.cumsum(blk, 3)[:, :, :, :-1],
                                       (0, 0, 1, 0))
        tot = blk.sum(3)                            # (G, 162, 32, 4)
        bp = torch.nn.functional.pad(torch.cumsum(tot, 2), (0, 0, 1, 0))
        pos = torch.tensor(offsets)
        ends = pos + 256
        s0 = bp[:, :, pos // 16] + part[:, :, pos // 16, pos % 16]
        # position 512 is the total: block 32's prefix, partial 0
        s1 = bp[:, :, ends // 16] + torch.where(
            (ends < 512)[:, None],
            part[:, :, torch.clamp(ends // 16, max=31), ends % 16], 0.0)
        return s1 - s0                              # (G, 162, L, 4)

    zr, zi = prefix(pr), prefix(pi)
    return torch.sqrt(zr * zr + zi * zi).reshape(G, 162, L, 4)


def _direct_form64(wr, wi, freq, drift, offsets):
    """_tone_mags_offsets_plain's own steps at float64, its offset tone
    matrix built from the float64 angles (its tables are float32)."""
    L = len(offsets)
    yr, yi = psync._derotate(psync._double_frames(wr),
                             psync._double_frames(wi),
                             *psync._cand_phasor_conj(freq, drift,
                                                      ulen=psync.ULEN))
    tr = np.zeros((psync.ULEN, L, 4))
    ti = np.zeros((psync.ULEN, L, 4))
    for k, o in enumerate(offsets):
        tr[o:o + 256, k] = np.cos(psync._ANG_TONE)
        ti[o:o + 256, k] = -np.sin(psync._ANG_TONE)
    p = psync._tone_mags(yr, yi, _t(tr.reshape(psync.ULEN, -1)),
                         _t(ti.reshape(psync.ULEN, -1)))
    return p.reshape(wr.shape[0], 162, L, 4)


def _windows3_lanes():
    """4 lanes cut from windows3() as stage B cuts them: the two signals
    and the noise window at their coarse shifts, one lane drifting."""
    wi, wq = windows3()
    pi, pq = psync._padded_signals(_t(wi), _t(wq))
    lane_w = torch.tensor([0, 0, 1, 2])
    shift = torch.tensor([256, 128, 512, -384])
    wr_, wi_ = psync._lane_windows(pi, pq, lane_w, shift)
    freq = np.asarray([-40.0, -35.0, 30.0, 0.0], np.float32)
    drift = np.asarray([0.0, 1.0, -0.5, 3.0], np.float32)
    return wr_.numpy(), wi_.numpy(), freq, drift


@pytest.mark.parametrize("lanes", ["_lanes", "windows3"])
def test_correlator_prefix_algebra(lanes):
    """The blocked prefix-sum factorisation the correlator kernel uses,
    run in torch at float64, equals the plain version's direct form at
    float64 within 1e-9 of the output's scale at every offset set
    (noise lanes, and lanes cut from windows3's signals), and the
    float32 plain version within the kernel's tolerance; the kernel's
    512-row phasor table continues E_TONE."""
    table = psync._prefix_tone_table()
    np.testing.assert_array_equal(table[0, :256], psync.E_TONE_R)
    np.testing.assert_array_equal(table[1, :256], psync.E_TONE_I)
    src = _lanes(2, seed=5) if lanes == "_lanes" else _windows3_lanes()
    f64 = [_t(a.astype(np.float64)) for a in src]
    f32 = [_t(a) for a in src]
    for kind in OFFSET_SETS.values():
        offs = _offsets(kind)
        got = _prefix_form(*f64, offs)
        want = _direct_form64(*f64, offs)
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9 * scale)
        plain = psync._tone_mags_offsets_plain(*f32, offs)
        torch.testing.assert_close(got.float(), plain, rtol=CORR_RTOL,
                                   atol=CORR_ATOL)


# ---- the work formulas ----------------------------------------------------


@pytest.fixture(scope="module")
def measure():
    return import_tools("torch_measure", "torch_roofline")


@pytest.mark.parametrize("maxdrift", [4, 0, (4, 1)])
def test_coarse_work_is_the_direct_form(measure, maxdrift):
    """coarse_direct_work at B=2: one add for each nonzero of the plain
    route's weight matrix W in the drifts each window keeps, at every
    (row, lag); the bytes are the spectrogram, maxdrift and table read
    once and the rows written once. coarse_work, the kernel's pre-summed
    form, counts at most as many FLOPs and no more bytes."""
    tm, _ = measure
    B = 2
    nbytes, flops = tm.coarse_direct_work(B, maxdrift)
    new_bytes, new_flops = tm.coarse_work(B, maxdrift)
    assert new_flops <= flops and new_bytes <= nbytes
    Wd = pcoarse.W.reshape(162, 9, -1)
    nnz = 0
    for md in np.broadcast_to(np.asarray(maxdrift), (B,)):
        keep = np.abs(np.arange(-4, 5)) <= md
        nnz += int(np.count_nonzero(Wd[:, keep]))
    assert flops == 512 * 32 * nnz
    assert nbytes == B * 512 * 347 * 4 + B * 4 + 9 * 162 * 4 + B * 512 * 8


@pytest.mark.parametrize("L", sorted(OFFSET_SETS))
def test_correlator_work_is_the_direct_form(measure, L):
    """correlator_direct_work at 3 lanes: the dot products are half the
    plain route's counted matrix-product FLOPs (its tone matrix is zero
    on 256 of each column's 512 rows), plus 6 FLOPs a derotated sample.
    correlator_work, the least of the prefix-sum form and the direct
    one, counts at most as many FLOPs."""
    tm, roof = measure
    G = 3
    wr, wi, freq, drift = (_t(a) for a in _lanes(G))
    offs = _offsets(OFFSET_SETS[L])
    with roof.counting() as c:
        psync._tone_mags_offsets_plain(wr, wi, freq, drift, offs)
    nbytes, flops = tm.correlator_direct_work(G, L)
    assert flops - G * 162 * 512 * 6 == c.mm_flops // 2
    assert nbytes == (2 * G * psync.WLEN * 4 + 8 * G + 4 * L + 8192
                      + G * 162 * L * 16)
    assert tm.correlator_work(G, L)[1] <= flops


# ---- on the card ---------------------------------------------------------


@pytest.mark.cuda
def test_kernels_match_plain_on_card(spectrogram):
    """Both kernels against their plain versions on the card (coarse at
    B=2, maxdrift 4, 0 and per window; the correlator at
    G=3, L = 1, 33, 43), each call counted. Runs only with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    ps = spectrogram.cuda()
    for md in (4, 0, torch.tensor([4, 2])):
        before = pcoarse.coarse_search.launches
        val, arg = pcoarse.coarse_rows(ps, md)
        assert pcoarse.coarse_search.launches == before + 1
        mdh = md if isinstance(md, int) else md.clone()
        assert_rows_match(val.cpu().numpy(), arg.cpu().numpy(),
                          spectrogram, mdh)
    for L, kind in OFFSET_SETS.items():
        wr, wi, freq, drift = (_t(a).cuda() for a in _lanes(3, seed=L))
        before = psync._tone_mags_offsets.launches
        got = psync._tone_mags_offsets(wr, wi, freq, drift, _offsets(kind))
        assert psync._tone_mags_offsets.launches == before + 1
        want = psync._tone_mags_offsets_plain(wr, wi, freq, drift,
                                              _offsets(kind))
        torch.testing.assert_close(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)

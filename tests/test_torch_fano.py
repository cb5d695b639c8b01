"""The port's Fano decoder against the JAX package and the native
decoder: the plain version (bit-exact with JAX's batched_fano and with
native/hostdsp.cpp), the CUDA kernel's source run on the host through a
small emulation of the CUDA constructs it uses, the wrapper's routing,
the hybrid straggler finish, and the native encoder binding."""

import ctypes
import subprocess
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu import native as jnative
from rtlsdr_wsprd_tpu.ops import fano as jfano
from rtlsdr_wsprd_tpu.ops import fano_hybrid as jhybrid
from rtlsdr_wsprd_tpu_torch import native as pnative
from rtlsdr_wsprd_tpu_torch.ops import fano as pfano
from rtlsdr_wsprd_tpu_torch.ops import fano_hybrid as phybrid

MET = pfano.METTAB
FIELDS = ("success", "metric", "cycles", "maxnp")


def hard_symbols(rng) -> np.ndarray:
    """A random 50-bit payload conv-encoded by the native encoder, as
    hard soft bytes (0/255), deinterleaved: 162 bytes, POLY1's first."""
    payload = np.zeros(11, np.uint8)
    payload[:6] = rng.integers(0, 256, 6)
    payload[6] = rng.integers(0, 256) & 0xC0
    enc = pnative.conv_encode(payload, 81)
    out = np.zeros(162, np.uint8)
    out[0::2] = np.where((enc >> 1) & 1, 255, 0)
    out[1::2] = np.where(enc & 1, 255, 0)
    return out


def fano_mix(seed: int, n_clean=3, sigmas=(20, 40, 60, 80), n_garbage=3,
             n_pad=2):
    """(symbols uint8[N, 162], valid bool[N]): clean lanes, noisy copies
    of a clean lane at each sigma, random lanes, then padding lanes
    (random bytes, valid False)."""
    rng = np.random.default_rng(seed)
    rows = [hard_symbols(rng) for _ in range(n_clean)]
    for sigma in sigmas:
        base = hard_symbols(rng).astype(np.float64)
        rows.append(np.clip(base + rng.normal(0, sigma, 162), 0,
                            255).astype(np.uint8))
    rows += [rng.integers(0, 256, 162, dtype=np.uint8)
             for _ in range(n_garbage + n_pad)]
    valid = np.ones(len(rows), bool)
    if n_pad:
        valid[-n_pad:] = False
    return np.stack(rows), valid


def plain(syms, mc, valid=None, steps=False):
    return pfano.batched_fano_plain(
        torch.from_numpy(syms), torch.from_numpy(MET), 60, mc,
        None if valid is None else torch.from_numpy(valid), steps=steps)


def assert_matches(got: dict, ref: dict):
    """``got``/``ref``: field -> numpy array. Success, metric, cycles and
    maxnp equal on every lane; data equal where the lane succeeded."""
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[f]).astype(np.int64),
                                      np.asarray(ref[f]).astype(np.int64),
                                      err_msg=f)
    ok = np.asarray(ref["success"])
    np.testing.assert_array_equal(np.asarray(got["data"])[ok],
                                  np.asarray(ref["data"])[ok])


def as_dict(res) -> dict:
    """A FanoResult of either package (JAX arrays, or torch tensors on
    any device) as field -> numpy array."""
    out = {}
    for f in ("data", *FIELDS):
        v = getattr(res, f)
        out[f] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def native_dict(syms, mc) -> dict:
    ok, data, cycles, metric, maxnp = jnative.fano_decode_many(
        syms, MET, delta=60, maxcycles=mc)
    return dict(success=ok, data=data, cycles=cycles, metric=metric,
                maxnp=maxnp)


@pytest.mark.parametrize("maxcycles", [1, 4, 16])
def test_plain_matches_jax(maxcycles):
    """The plain version against JAX batched_fano on the clean / noisy /
    garbage mix with padding lanes: success, metric, cycles and maxnp
    equal on every lane, data equal where the lane succeeded and all
    zeros in the port elsewhere (padding lanes: every output 0)."""
    syms, valid = fano_mix(21)
    got = plain(syms, maxcycles, valid)
    ref = jfano.batched_fano(jnp.asarray(syms), jnp.asarray(MET), delta=60,
                             maxcycles=maxcycles, valid=jnp.asarray(valid))
    assert_matches(as_dict(got), as_dict(ref))
    data = got.data.numpy()
    assert not data[~got.success.numpy()].any()
    assert got.data.dtype == torch.uint8 and got.success.dtype == torch.bool
    assert all(getattr(got, f).dtype == torch.int32
               for f in ("metric", "cycles", "maxnp"))
    assert not got.cycles.numpy()[~valid].any()
    if maxcycles == 16:
        assert got.success.numpy().sum() >= 3  # the clean lanes decode


@pytest.mark.parametrize("maxcycles", [16, 10000])
def test_plain_matches_native(maxcycles):
    """The plain version against native.fano_decode lane by lane: every
    lane at budget 16; at the full 10000 only the lanes that decode (a
    lane that times out there takes minutes in the plain loop)."""
    syms, _ = fano_mix(22, n_pad=0)
    ref = native_dict(syms, maxcycles)
    if maxcycles == 10000:
        keep = ref["success"]
        assert 3 <= keep.sum() < len(keep)
        syms = syms[keep]
        ref = {k: v[keep] for k, v in ref.items()}
    assert_matches(as_dict(plain(syms, maxcycles)), ref)


def test_lanes_independent():
    """A lane's result does not depend on the batch it runs in (the
    decodable lanes of the mix, full budget, alone and together)."""
    syms, _ = fano_mix(23, n_garbage=0, n_pad=0)
    full = as_dict(plain(syms, 10000))
    assert full["success"].all()
    for k in range(syms.shape[0]):
        solo = as_dict(plain(syms[k:k + 1], 10000))
        for f in ("data", *FIELDS):
            np.testing.assert_array_equal(solo[f][0], full[f][k], err_msg=f)


def test_wrapper_routes_cpu_to_plain():
    """On CPU tensors the wrapper is the plain version (no launch is
    counted); tensors on another device, or split across devices,
    raise."""
    syms, valid = fano_mix(24)
    s, m, v = (torch.from_numpy(a) for a in (syms, MET, valid))
    before = pfano.batched_fano.launches
    got = pfano.batched_fano(s, m, 60, 4, v)
    want = pfano.batched_fano_plain(s, m, 60, 4, v)
    for f in ("data", *FIELDS):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.steps is None
    assert pfano.batched_fano.launches == before
    with pytest.raises(ValueError):
        pfano.batched_fano(s.to("meta"), m.to("meta"), 60, 4)
    with pytest.raises(ValueError):
        pfano.batched_fano(s, m.to("meta"), 60, 4)
    with pytest.raises(ValueError):
        pfano.batched_fano(s, m, 60, 10 ** 8)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """csrc/fano.cu against the plain version on the card at budgets 4
    and 16 (every field, step counts included, padding lanes too) and
    against the native decoder at 10000; each call counted. Runs only
    with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    syms, valid = fano_mix(25)
    s, m, v = (torch.from_numpy(a).cuda() for a in (syms, MET, valid))
    for mc in (4, 16):
        before = pfano.batched_fano.launches
        got = pfano.batched_fano(s, m, 60, mc, v, steps=True)
        assert pfano.batched_fano.launches == before + 1
        want = pfano.batched_fano_plain(s, m, 60, mc, v, steps=True)
        torch.cuda.synchronize()
        for f in ("data", *FIELDS, "steps"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    got = as_dict(pfano.batched_fano(s, m, 60, 10000, v))
    assert_matches({k: a[valid] for k, a in got.items()},
                   native_dict(syms[valid], 10000))


# Host emulation of the CUDA constructs fano.cu uses: a block's threads
# run as std::threads that meet at a std::barrier for __syncthreads(),
# blocks one after another, so __shared__ arrays can be plain statics.
_SHIM = textwrap.dedent("""\
    #include <algorithm>
    #include <barrier>
    #include <cstdint>
    #include <thread>
    #include <vector>
    #define __global__
    #define __device__
    #define __forceinline__ inline
    #define __launch_bounds__(x)
    #define __restrict__
    #define __shared__ static
    struct Dim3 { unsigned x; };
    thread_local Dim3 threadIdx, blockIdx;
    static std::barrier<>* g_bar;
    inline void __syncthreads() { g_bar->arrive_and_wait(); }
    inline int __popc(uint32_t v) { return __builtin_popcount(v); }
    using std::min;
    """)
_LAUNCHER = textwrap.dedent("""\
    extern "C" void emu_fano(const uint8_t* symbols, const uint8_t* valid,
                             const int32_t* mettab, int n, int delta,
                             unsigned maxcycles, uint8_t* data,
                             uint8_t* success, int32_t* metric,
                             int32_t* cycles, int32_t* maxnp,
                             int32_t* steps) {
      for (int b = 0; b < (n + kThreads - 1) / kThreads; ++b) {
        std::barrier<> bar(kThreads);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < kThreads; ++t) {
          ts.emplace_back([=] {
            threadIdx.x = t;
            blockIdx.x = b;
            fano_kernel(symbols, valid, mettab, n, delta, maxcycles, data,
                        success, metric, cycles, maxnp, steps);
          });
        }
        for (auto& th : ts) th.join();
      }
    }
    """)


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/fano.cu's kernel (its launcher cut off) compiled with g++
    over the shim above; returns run(symbols, valid, maxcycles) ->
    field -> numpy array."""
    src = (Path(pfano.__file__).parent / "csrc" / "fano.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    body = src[:src.index('extern "C"')]
    d = tmp_path_factory.mktemp("fano_emu")
    (d / "emu.cpp").write_text(_SHIM + body + _LAUNCHER)
    r = subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                        "-pthread", "-o", str(d / "libemu.so"),
                        str(d / "emu.cpp")], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "libemu.so"))
    vp = ctypes.c_void_p
    lib.emu_fano.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int,
                             ctypes.c_uint] + [vp] * 6

    def run(syms, valid, mc):
        n = syms.shape[0]
        syms = np.ascontiguousarray(syms)
        v = np.ascontiguousarray(valid, np.uint8)
        out = dict(data=np.zeros((n, 11), np.uint8),
                   success=np.zeros(n, np.uint8))
        for f in ("metric", "cycles", "maxnp", "steps"):
            out[f] = np.zeros(n, np.int32)
        lib.emu_fano(syms.ctypes.data, v.ctypes.data, MET.ctypes.data, n, 60,
                     mc, *(out[f].ctypes.data for f in (
                         "data", "success", "metric", "cycles", "maxnp",
                         "steps")))
        out["success"] = out["success"].astype(bool)
        return out

    return run


def test_kernel_source_emulated_matches_plain_and_native(emulated_kernel):
    """The kernel's own source, run on the host, over 150 lanes (two
    blocks, the second ragged; padding lanes among them): equal to the
    plain version in every field and in the flat step counts at budgets
    4 and 16, and to the native decoder at 256 and 10000, with zero data
    wherever a lane did not succeed."""
    syms, valid = fano_mix(26, n_clean=30, sigmas=tuple(range(20, 81, 1)),
                           n_garbage=50, n_pad=9)
    assert syms.shape[0] == 150
    for mc in (4, 16):
        got = emulated_kernel(syms, valid, mc)
        want = plain(syms, mc, valid, steps=True)
        for f in ("data", *FIELDS, "steps"):
            np.testing.assert_array_equal(
                got[f], getattr(want, f).numpy(), err_msg=f"{f} at {mc}")
    for mc in (256, 10000):
        got = emulated_kernel(syms, valid, mc)
        assert_matches({k: a[valid] for k, a in got.items()},
                       native_dict(syms[valid], mc))
        assert not got["data"][~got["success"]].any()
        assert not got["cycles"][~valid].any()
    assert got["success"].sum() >= 60
    # a timeout lane runs the full budget: maxcycles*81 + 2
    assert got["cycles"].max() == 10000 * 81 + 2


def test_host_finish_completes_to_full_budget():
    """host_finish over a 16-cycle plain run gives the full-budget native
    result bit for bit (success, data, cycles), and equals the JAX
    package's host_finish on the same arrays."""
    syms, _ = fano_mix(27, n_pad=0)
    dev = plain(syms, 16)
    succ, data, cycles = (getattr(dev, f).numpy() for f in
                          ("success", "data", "cycles"))
    pend = phybrid.pending_mask(succ, cycles, 16, 10000)
    assert pend.any() and not pend[succ].any()
    got = phybrid.host_finish(syms, succ, data, cycles, pend, 60, 10000)
    ref = native_dict(syms, 10000)
    np.testing.assert_array_equal(got[0], ref["success"])
    np.testing.assert_array_equal(got[1][ref["success"]],
                                  ref["data"][ref["success"]])
    np.testing.assert_array_equal(got[2], ref["cycles"])
    jref = jhybrid.host_finish(syms, succ, data, cycles.astype(np.uint32),
                               pend, 60, 10000)
    for g, r in zip(got, jref):
        np.testing.assert_array_equal(g, r)
    assert phybrid.pending_mask(succ, cycles, 10000, 10000).sum() == 0


def test_pending_mask_keeps_lane_finished_on_last_cycle():
    """A clean lane reaches the last node on cycle 81, which at budget 1
    is the budget's last cycle: the device reports it failed with cycles
    82 (budget*81 + 1), not the timeout marker 83. The port's mask sends
    it to the host, which decodes it; the JAX package's mask drops it."""
    syms = hard_symbols(np.random.default_rng(28))[None]
    dev = plain(syms, 1)
    assert not dev.success[0] and int(dev.cycles[0]) == 82
    succ, data, cycles = (getattr(dev, f).numpy() for f in
                          ("success", "data", "cycles"))
    pend = phybrid.pending_mask(succ, cycles, 1, 10000)
    assert pend[0]
    assert not jhybrid.pending_mask(succ, cycles.astype(np.uint32), 1,
                                    10000)[0]
    ok, _, c = phybrid.host_finish(syms, succ, data, cycles, pend, 60, 10000)
    assert ok[0] and c[0] == 82


def test_native_encoder_and_batch_decode_equal_jax_bindings():
    """conv_encode and fano_decode_many of the port's binding equal the
    JAX package's binding (same native source)."""
    rng = np.random.default_rng(29)
    for _ in range(4):
        payload = rng.integers(0, 256, 11).astype(np.uint8)
        np.testing.assert_array_equal(pnative.conv_encode(payload, 162),
                                      jnative.conv_encode(payload, 162))
    syms, _ = fano_mix(29, n_pad=0)
    for got, ref in zip(pnative.fano_decode_many(syms, MET, 60, 30),
                        jnative.fano_decode_many(syms, MET, 60, 30)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        pnative.conv_encode(np.zeros(10, np.uint8))

"""The port's ctypes binding to the native host runtime.

Binds these pieces of ``native/hostdsp.cpp`` (a file of the repository,
outside either Python package): the WSPR callsign hash ``wspr_nhash``
(lookup3, bit-exact with utils/nhash.py), the sequential host Fano decoder
``wspr_fano_decode`` (the reference's wsprd/fano.c semantics, bit for
bit), the convolutional encoder ``wspr_conv_encode``, the uint8 IQ
ingest ``u8_deinterleave_center/pairs`` (rtlsdr_wsprd.c:158-182) and the
host polyphase decimators ``wspr_pp_decimate_f32/u8`` and
``wspr_fir_decimate_f32`` (the host-placed front end,
frontend/host_decimate.py); and the float32 -> int8/int16 link
quantizers ``wspr_quantize_i8/i16`` of the port's own
``csrc/quantize.cpp`` (SSE2, bit for bit hostdsp.cpp's scalar
``f32_quantize_i8/i16``). Both sources are compiled with ``g++`` into one
library in the port's gitignored build directory at first use
(buildlib.py). Without ``g++`` every call raises: nothing here has a
pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .buildlib import REPO_ROOT, load_library

_SOURCE = REPO_ROOT / "native" / "hostdsp.cpp"
_QUANTIZE_SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cpp"
_ABI = 4  # wspr_hostdsp_abi() of the source this binding was written for

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Build (if needed) and load the library; returns its path."""
    return _load()._name


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_library("hostdsp", "g++", [_SOURCE, _QUANTIZE_SOURCE],
                           ["-O3", "-std=c++17", "-fPIC", "-shared"])
        lib.wspr_hostdsp_abi.restype = ctypes.c_int
        abi = int(lib.wspr_hostdsp_abi())
        if abi != _ABI:
            raise RuntimeError(f"hostdsp ABI {abi}, binding expects {_ABI}")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.wspr_nhash.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wspr_nhash.restype = ctypes.c_uint32
        lib.wspr_fano_decode.argtypes = [
            u8p, i32p, ctypes.c_int32, ctypes.c_uint32, u8p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.wspr_fano_decode.restype = ctypes.c_int
        lib.wspr_conv_encode.argtypes = [u8p, u8p, ctypes.c_int]
        lib.wspr_conv_encode.restype = None
        for fn, dt in ((lib.wspr_quantize_i8, np.int8),
                       (lib.wspr_quantize_i16, np.int16)):
            fn.argtypes = [f32p, ctypes.c_uint64, ctypes.c_float,
                           np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")]
            fn.restype = ctypes.c_uint64
        lib.u8_deinterleave_center.argtypes = [u8p, ctypes.c_uint64, f32p,
                                               f32p]
        lib.u8_deinterleave_center.restype = None
        lib.u8_deinterleave_pairs.argtypes = [u8p, ctypes.c_uint64, u8p, u8p]
        lib.u8_deinterleave_pairs.restype = None
        i64 = ctypes.c_int64
        lib.wspr_pp_decimate_f32.argtypes = [
            f32p, f32p, f32p, f32p, i64, i64, i64, f32p, f32p]
        lib.wspr_pp_decimate_f32.restype = None
        lib.wspr_pp_decimate_u8.argtypes = [
            u8p, u8p, f32p, f32p, i64, i64, i64, f32p, f32p]
        lib.wspr_pp_decimate_u8.restype = None
        lib.wspr_fir_decimate_f32.argtypes = [
            f32p, f32p, f32p, i64, i64, i64, f32p, f32p]
        lib.wspr_fir_decimate_f32.restype = None
        _lib = lib
        return lib


def nhash(callsign: str | bytes) -> int:
    """The 15-bit WSPR hash of a callsign (wsprd/nhash.c, initval 146)."""
    lib = _load()
    if isinstance(callsign, str):
        callsign = callsign.encode("ascii")
    return int(lib.wspr_nhash(callsign, len(callsign)))


def fano_decode(symbols: np.ndarray, mettab: np.ndarray,
                delta: int = 60, maxcycles: int = 10000):
    """Sequential host Fano. symbols: uint8[162] (deinterleaved);
    mettab: int32[2, 256]. Returns (success, data uint8[11], cycles,
    metric, maxnp), as the reference's fano() (wsprd/fano.c:87-95)."""
    lib = _load()
    symbols = np.ascontiguousarray(symbols, np.uint8)
    mettab = np.ascontiguousarray(mettab, np.int32)
    if symbols.shape != (162,) or mettab.shape != (2, 256):
        raise ValueError(f"bad shapes {symbols.shape}, {mettab.shape}")
    data = np.zeros(11, np.uint8)
    cycles = ctypes.c_uint32(0)
    metric = ctypes.c_int32(0)
    maxnp = ctypes.c_int32(0)
    ok = lib.wspr_fano_decode(symbols, mettab.reshape(-1), delta, maxcycles,
                              data, ctypes.byref(cycles),
                              ctypes.byref(metric), ctypes.byref(maxnp))
    return (bool(ok), data, int(cycles.value), int(metric.value),
            int(maxnp.value))


def fano_decode_many(symbols: np.ndarray, mettab: np.ndarray,
                     delta: int = 60, maxcycles: int = 10000,
                     threads: int = 16):
    """``fano_decode`` over a batch, on up to ``threads`` host threads
    (the ctypes call releases the GIL). symbols: uint8[N, 162]
    deinterleaved. Returns (success bool[N], data uint8[N, 11], cycles
    uint32[N], metric int32[N], maxnp int32[N])."""
    from concurrent.futures import ThreadPoolExecutor

    symbols = np.ascontiguousarray(symbols, np.uint8)
    n = symbols.shape[0]
    success = np.zeros(n, bool)
    data = np.zeros((n, 11), np.uint8)
    cycles = np.zeros(n, np.uint32)
    metric = np.zeros(n, np.int32)
    maxnp = np.zeros(n, np.int32)
    mettab = np.ascontiguousarray(mettab, np.int32)

    def run(k):
        (success[k], data[k], cycles[k], metric[k],
         maxnp[k]) = fano_decode(symbols[k], mettab, delta, maxcycles)

    if n <= 1 or threads <= 1:
        for k in range(n):
            run(k)
    else:
        with ThreadPoolExecutor(max_workers=min(threads, n)) as ex:
            list(ex.map(run, range(n)))
    return success, data, cycles, metric, maxnp


def conv_encode(data: np.ndarray, nsym: int = 162) -> np.ndarray:
    """The K=32 r=1/2 convolutional encoder: 11 bytes MSB first ->
    ``nsym`` 2-bit symbols (POLY1 parity in bit 1, POLY2 in bit 0)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8)
    if data.shape != (11,):
        raise ValueError(f"data must be 11 bytes, got {data.shape}")
    out = np.zeros(nsym, np.uint8)
    lib.wspr_conv_encode(data, out, nsym)
    return out


def quantize_into(x: np.ndarray, out: np.ndarray, scale: float) -> int:
    """float32 -> int8/int16: NaN -> 0, round to nearest even (as
    ``nearbyintf``), clamp to the symmetric range (csrc/quantize.cpp).
    Writes ``out``; returns the count of elements that went through the
    SSE2 body (``x.size`` less its tail of ``x.size % 16``; 0 on a host
    without SSE2)."""
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError("x must be C-contiguous float32")
    if not out.flags.c_contiguous or out.shape != x.shape:
        raise ValueError("out must be C-contiguous with x's shape")
    lib = _load()
    if out.dtype == np.int8:
        fn = lib.wspr_quantize_i8
    elif out.dtype == np.int16:
        fn = lib.wspr_quantize_i16
    else:
        raise ValueError(f"unsupported output dtype {out.dtype}")
    return int(fn(x.reshape(-1), x.size, np.float32(scale), out.reshape(-1)))


def u8_deinterleave_center(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved uint8 IQ -> planar float32 (I, Q) centred by -128; an
    odd trailing byte is ignored."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.shape[0] // 2
    lib = _load()
    out_i = np.empty(n, np.float32)
    out_q = np.empty(n, np.float32)
    lib.u8_deinterleave_center(raw, n, out_i, out_q)
    return out_i, out_q


def u8_deinterleave_pairs(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved uint8 IQ -> planar uint8 (I, Q), not centred (the
    stage-1 call centres them); an odd trailing byte is ignored."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.shape[0] // 2
    lib = _load()
    out_i = np.empty(n, np.uint8)
    out_q = np.empty(n, np.uint8)
    lib.u8_deinterleave_pairs(raw, n, out_i, out_q)
    return out_i, out_q


def _check_decimate_input(xI, xQ, taps: int, R: int, n_frames: int):
    want = (n_frames * R + taps - R,)
    if xI.shape != want or xQ.shape != want:
        raise ValueError(f"inputs must be {want} for {n_frames} frames of "
                         f"a {taps}-tap filter, got {xI.shape}, {xQ.shape}")


def pp_decimate(xI: np.ndarray, xQ: np.ndarray, gr: np.ndarray,
                gi: np.ndarray, R: int,
                n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Complex-tap polyphase decimation on the host: one output per R
    inputs, conv-ordered taps (gr + j gi), uint8 inputs centred by -128
    inline. The math of the plain version of frontend/polyphase.py."""
    taps = gr.shape[0]
    _check_decimate_input(xI, xQ, taps, R, n_frames)
    lib = _load()
    gr = np.ascontiguousarray(gr, np.float32)
    gi = np.ascontiguousarray(gi, np.float32)
    yI = np.empty(n_frames, np.float32)
    yQ = np.empty(n_frames, np.float32)
    if xI.dtype == np.uint8:
        lib.wspr_pp_decimate_u8(np.ascontiguousarray(xI),
                                np.ascontiguousarray(xQ, np.uint8),
                                gr, gi, taps, R, n_frames, yI, yQ)
    else:
        lib.wspr_pp_decimate_f32(
            np.ascontiguousarray(xI, np.float32),
            np.ascontiguousarray(xQ, np.float32),
            gr, gi, taps, R, n_frames, yI, yQ)
    return yI, yQ


def fir_decimate(xI: np.ndarray, xQ: np.ndarray, g: np.ndarray, R: int,
                 n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-tap polyphase decimation on the host (both planes share the
    conv-ordered taps ``g``)."""
    taps = g.shape[0]
    _check_decimate_input(xI, xQ, taps, R, n_frames)
    lib = _load()
    yI = np.empty(n_frames, np.float32)
    yQ = np.empty(n_frames, np.float32)
    lib.wspr_fir_decimate_f32(
        np.ascontiguousarray(xI, np.float32),
        np.ascontiguousarray(xQ, np.float32),
        np.ascontiguousarray(g, np.float32), taps, R, n_frames, yI, yQ)
    return yI, yQ

"""The port's ctypes binding to the native host runtime.

Binds three pieces of ``native/hostdsp.cpp`` (a file of the repository,
outside either Python package): the sequential host Fano decoder
``wspr_fano_decode`` (the reference's wsprd/fano.c semantics, bit for
bit), the convolutional encoder ``wspr_conv_encode`` and the float32 ->
int8/int16 transfer quantizers ``f32_quantize_i8/i16``. The source is compiled with ``g++`` into the
port's gitignored build directory at first use (buildlib.py). Without
``g++`` every call raises: the FEC has no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .buildlib import REPO_ROOT, build_shared

_SOURCE = REPO_ROOT / "native" / "hostdsp.cpp"
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
        path = build_shared("hostdsp", "g++", [_SOURCE],
                            ["-O3", "-std=c++17", "-fPIC", "-shared"])
        lib = ctypes.CDLL(str(path))
        lib.wspr_hostdsp_abi.restype = ctypes.c_int
        abi = int(lib.wspr_hostdsp_abi())
        if abi != _ABI:
            raise RuntimeError(f"hostdsp ABI {abi}, binding expects {_ABI}")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.wspr_fano_decode.argtypes = [
            u8p, i32p, ctypes.c_int32, ctypes.c_uint32, u8p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.wspr_fano_decode.restype = ctypes.c_int
        lib.wspr_conv_encode.argtypes = [u8p, u8p, ctypes.c_int]
        lib.wspr_conv_encode.restype = None
        lib.f32_quantize_i8.argtypes = [
            f32p, ctypes.c_uint64, ctypes.c_float,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")]
        lib.f32_quantize_i8.restype = None
        lib.f32_quantize_i16.argtypes = [
            f32p, ctypes.c_uint64, ctypes.c_float,
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")]
        lib.f32_quantize_i16.restype = None
        _lib = lib
        return lib


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


def quantize_into(x: np.ndarray, out: np.ndarray, scale: float) -> None:
    """float32 -> int8/int16: NaN -> 0, round to nearest even
    (``nearbyintf``), clamp to the symmetric range. Writes ``out``."""
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError("x must be C-contiguous float32")
    if not out.flags.c_contiguous or out.shape != x.shape:
        raise ValueError("out must be C-contiguous with x's shape")
    lib = _load()
    if out.dtype == np.int8:
        fn = lib.f32_quantize_i8
    elif out.dtype == np.int16:
        fn = lib.f32_quantize_i16
    else:
        raise ValueError(f"unsupported output dtype {out.dtype}")
    fn(x.reshape(-1), x.size, np.float32(scale), out.reshape(-1))

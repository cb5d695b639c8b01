"""STFT power spectrogram of a 2-minute WSPR window (planar I/Q):
a hand-written CUDA FFT kernel and its plain PyTorch version.

The reference computes 347 sequential 512-point FFTs with a
quarter-symbol hop and a pseudo-Hann window, then fftshifts into a
power array ps[512][347] (wsprd/wsprd.c:496-553).

``power_spectrogram`` is the wrapper. For a CPU tensor it runs
``power_spectrogram_plain``: as in the JAX package, the DFT is four
float32 matmuls against constant cos/sin matrices whose column order
folds in the fftshift, a leading batch dimension riding the same
matmuls. For a CUDA tensor it launches ``csrc/stft.cu`` (a 512-point
FFT a warp with one shared exchange, the window applied on load, the
fftshift folded into the write index; persistent blocks walking
asynchronously staged 4-frame tiles; ``power_rows``) or raises: there
is no fallback.
Both replace ``rtlsdr_wsprd_tpu/ops/stft.py`` ``power_spectrogram``, an
XLA program. The two sum in another order, so a bin's power may differ
by float32 rounding; a window of zeros gives zeros in both.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..buildlib import lazy_cuda_library
from ..config import FFT_SIZE, SIGNAL_SAMPLES
from ..device import const
from .fano import NVCC_FLAGS

# blocks = 4 * floor(samples / 512) - 1 (wsprd/wsprd.c:516)
BLOCKS = 4 * (SIGNAL_SAMPLES // FFT_SIZE) - 1  # = 347
HOP = FFT_SIZE // 4  # quarter-symbol hop = 128
SPAN = (BLOCKS + 3) * HOP  # samples the frames read: 44,800


def _hann() -> np.ndarray:
    # pseudo-Hann: sin(0.006147931 * i) ~= sin(pi*i/511) (wsprd/wsprd.c:510-513)
    return np.sin(0.006147931 * np.arange(FFT_SIZE, dtype=np.float64)).astype(np.float32)


HANN = _hann()


def _dft_matrices() -> tuple[np.ndarray, np.ndarray]:
    """Constant DFT matrices with fftshifted column order: output
    column j is FFT bin (j + 256) mod 512 (wsprd/wsprd.c:547-551)."""
    n = np.arange(FFT_SIZE, dtype=np.float64)
    k = (np.arange(FFT_SIZE) + FFT_SIZE // 2) % FFT_SIZE
    ang = 2.0 * np.pi * np.outer(n, k) / FFT_SIZE
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


DFT_COS, DFT_SIN = _dft_matrices()


def _twiddles() -> np.ndarray:
    """The kernel's twiddle table, float32 (2, 256): cos and sin of
    2 pi k / 512, k < 256, rounded from float64 as ``_dft_matrices``
    rounds its entries (exp(-2 pi i k / 512) = cos - i sin)."""
    k = np.arange(FFT_SIZE // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / FFT_SIZE
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


TWIDDLE = _twiddles()


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., BLOCKS, 512) frames with hop 128."""
    blk = x[..., :(BLOCKS + 3) * HOP].reshape(*x.shape[:-1], BLOCKS + 3, HOP)
    return torch.cat([blk[..., t:t + BLOCKS, :] for t in range(4)], dim=-1)


def power_spectrogram_plain(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``power_spectrogram`` (same arguments)."""
    dev = i.device
    w, C, S = const(HANN, dev), const(DFT_COS, dev), const(DFT_SIN, dev)
    fr = _frames(i) * w
    fi = _frames(q) * w
    zr = fr @ C + fi @ S
    zi = fi @ C - fr @ S
    ps = zr * zr + zi * zi
    return ps.transpose(-1, -2)


_SOURCE = Path(__file__).resolve().parent / "csrc" / "stft.cu"
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(lib) -> None:
    # stft_power(xi, xq, stride_i, stride_q, hann, cos_sin, n, out, stream)
    lib.stft_power.argtypes = [_vp, _vp, _cll, _cll, _vp, _vp, _ci, _vp, _vp]
    lib.stft_power.restype = _ci


_load_kernel = lazy_cuda_library("stft", [_SOURCE], NVCC_FLAGS, _bind)


def build_kernel() -> str:
    """Build (if needed) and load ``csrc/stft.cu``; returns its path."""
    return _load_kernel()._name


def _check_planes(i: torch.Tensor, q: torch.Tensor) -> None:
    """What ``csrc/stft.cu`` reads: two float32 (B, N >= 44,800) planes
    of one shape on one device, unit inner stride, each 16-byte aligned
    (the base and, with more than one row, the row stride)."""
    if i.shape != q.shape or i.device != q.device:
        raise ValueError(f"I and Q differ: {tuple(i.shape)} on {i.device}, "
                         f"{tuple(q.shape)} on {q.device}")
    for name, x in (("i", i), ("q", q)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < SPAN:
            raise ValueError(f"{name} must be float32[B, >= {SPAN}], got "
                             f"{x.dtype}{tuple(x.shape)}")
        if x.stride(1) != 1 or x.data_ptr() % 16 or \
                (x.shape[0] > 1 and x.stride(0) % 4):
            raise ValueError(f"{name} must have unit inner stride and "
                             f"16-byte aligned rows, got strides "
                             f"{x.stride()} at {x.data_ptr():#x}")


def power_rows(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``csrc/stft.cu`` on CUDA planes (float32 (B, N >= 44,800), see
    ``_check_planes``): float32 (B, BLOCKS, 512), row-major, row k the
    fftshifted powers of frame k. One launch, counted in
    ``power_spectrogram.launches``. Raises on anything the kernel cannot
    take and when the kernel does not build or launch."""
    dev = i.device
    if dev.type != "cuda":
        raise ValueError(f"power_rows runs on a CUDA device, not {dev}")
    _check_planes(i, q)
    B = i.shape[0]
    lib = _load_kernel()
    hann, cos_sin = const(HANN, dev), const(TWIDDLE, dev)
    out = torch.empty((B, BLOCKS, FFT_SIZE), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    # launch in the tensors' device, whatever the calling thread's is
    with torch.cuda.device(dev):
        rc = lib.stft_power(i.data_ptr(), q.data_ptr(), i.stride(0),
                            q.stride(0), hann.data_ptr(), cos_sin.data_ptr(),
                            B, out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stft kernel launch failed: CUDA error {rc}")
    power_spectrogram.launches += 1
    return out


def power_spectrogram(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """i, q: float32 (B, SIGNAL_SAMPLES) -> ps float32 (B, 512, BLOCKS),
    the transpose of a row-major (B, BLOCKS, 512) array.

    ps[b, j, k] is the power in fftshifted bin j (bin 256 = DC) of frame
    k of window b (wsprd/wsprd.c:536-553); frame k starts at sample
    128*k. CPU tensors take the plain version (any leading dimensions);
    CUDA tensors launch ``csrc/stft.cu`` (``power_rows``) and count the
    launch in ``power_spectrogram.launches``; any other device raises."""
    dev = i.device
    if dev.type == "cpu":
        return power_spectrogram_plain(i, q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return power_rows(i, q).transpose(1, 2)


power_spectrogram.launches = 0

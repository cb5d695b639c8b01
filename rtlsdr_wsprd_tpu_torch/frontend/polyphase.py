"""Polyphase complex FIR decimation: the hand-written CUDA kernel and its
plain PyTorch version.

``polyphase_decimate`` is the one wrapper both front-end stages call.
For a CPU tensor it runs the plain version; for a CUDA tensor it
launches ``csrc/polyphase.cu`` or raises: there is no fallback.

Kernel note. It replaces ``rtlsdr_wsprd_tpu/frontend/pallas_decimate.py``
``decimate_stage1_pallas``. Stage 1 (R=80, T=640 complex taps) costs
5,120 FLOP per output frame against 160 B of uint8 I/Q read: a 120 s
channel is 3.6 M frames, 18.4 GFLOP and 576 MB, so on an H100 the fp32
CUDA-core rate bounds it (about 0.28 ms per channel-window at the SXM
part's 67 TFLOP/s) rather than HBM (about 0.17 ms at 3.35 TB/s). The
kernel is a direct form (one warp per output frame, lanes split the
taps, coalesced reads, taps in shared memory, warp-shuffle reduction);
unlike the Pallas kernel's im2col it replicates no input sample. See
the source for details.

The plain version is the partial-product form of the JAX package's
``_polyphase_pp``: with T = tpp * R, the input reshapes to rows of R
samples, ``rows @ Htop + rows @ Hbot`` gives every phase's partial
output, and frame m is the sum of tpp shifted diagonals.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..buildlib import build_shared
from ..device import const

_CU_SOURCE = Path(__file__).resolve().parent / "csrc" / "polyphase.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_kernel() -> str:
    """Build (if needed) and load the CUDA library; returns its path."""
    return _load_kernel()._name


def _load_kernel():
    global _lib
    if _lib is None:
        path = build_shared("polyphase", _nvcc(), [_CU_SOURCE], NVCC_FLAGS)
        lib = ctypes.CDLL(str(path))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.polyphase_decimate.argtypes = [
            vp, vp, ci, ll, ll, vp, vp, ci, ci, ll, vp, vp, ll, vp]
        lib.polyphase_decimate.restype = ci
        _lib = lib
    return _lib


def pp_split(g: np.ndarray, R: int) -> tuple[np.ndarray, np.ndarray]:
    """conv-ordered complex taps g[T] -> (Htop, Hbot) float32[R, 2*tpp]
    partial-product matrices: P = rowsI @ Htop + rowsQ @ Hbot, column 2t
    the I partial of phase t and 2t+1 the Q partial (as the JAX
    package's decimate._pp_split)."""
    T = g.shape[0]
    tpp = T // R
    gr = np.real(g).astype(np.float32).reshape(tpp, R)
    gi = np.imag(g).astype(np.float32).reshape(tpp, R)
    top = np.zeros((R, 2 * tpp), np.float32)
    bot = np.zeros((R, 2 * tpp), np.float32)
    top[:, 0::2] = gr.T
    top[:, 1::2] = gi.T
    bot[:, 0::2] = -gi.T
    bot[:, 1::2] = gr.T
    return top, bot


class PolyphaseFilter:
    """One decimating filter: conv-ordered complex taps ``g`` (T,) and
    the decimation R. Holds the kernel's taps (gr, gi) and the plain
    version's partial-product matrices (Htop, Hbot) as numpy tables."""

    def __init__(self, g: np.ndarray, R: int):
        g = np.asarray(g)
        if g.ndim != 1 or g.shape[0] % R:
            raise ValueError(f"taps {g.shape} not a multiple of R={R}")
        self.R = R
        self.T = g.shape[0]
        self.tpp = self.T // R
        self.gr = np.ascontiguousarray(np.real(g), np.float32)
        self.gi = np.ascontiguousarray(np.imag(g), np.float32)
        self.htop, self.hbot = pp_split(g, R)

    def tensors(self, device: torch.device):
        """(gr, gi, Htop, Hbot) on ``device``."""
        return tuple(const(a, device)
                     for a in (self.gr, self.gi, self.htop, self.hbot))


def _center_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 RTL bytes -> centred float32; floats pass through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) - 128.0
    return x.to(torch.float32)


def polyphase_plain(xI: torch.Tensor, xQ: torch.Tensor,
                    filt: PolyphaseFilter, n_frames: int):
    """Plain PyTorch version: (..., L) uint8|float32 planar -> planar
    float32 (..., n_frames), L >= n_frames*R + T - R."""
    R, tpp = filt.R, filt.tpp
    _, _, htop, hbot = filt.tensors(xI.device)
    need = (n_frames + tpp - 1) * R
    fI = _center_f32(xI[..., :need])
    fQ = _center_f32(xQ[..., :need])
    lead = fI.shape[:-1]
    rowsI = fI.reshape(*lead, n_frames + tpp - 1, R)
    rowsQ = fQ.reshape(*lead, n_frames + tpp - 1, R)
    P = rowsI @ htop + rowsQ @ hbot
    yI = P[..., 0:n_frames, 0]
    yQ = P[..., 0:n_frames, 1]
    for t in range(1, tpp):
        yI = yI + P[..., t:t + n_frames, 2 * t]
        yQ = yQ + P[..., t:t + n_frames, 2 * t + 1]
    return yI, yQ


def polyphase_decimate(xI: torch.Tensor, xQ: torch.Tensor,
                       filt: PolyphaseFilter, n_frames: int):
    """(L,) or (C, L) planar uint8|float32 -> planar float32 (C?, n_frames).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (any row stride, unit sample stride) and count the launch in
    ``polyphase_decimate.launches``."""
    if xI.device != xQ.device:
        raise ValueError("xI and xQ on different devices")
    if xI.device.type == "cpu":
        return polyphase_plain(xI, xQ, filt, n_frames)
    if xI.device.type != "cuda":
        raise ValueError(f"unsupported device {xI.device}")
    if xI.dtype != xQ.dtype or xI.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"need uint8 or float32 planes, got "
                        f"{xI.dtype}/{xQ.dtype}")
    if xI.shape != xQ.shape or xI.dim() not in (1, 2):
        raise ValueError(f"bad plane shapes {tuple(xI.shape)}, "
                         f"{tuple(xQ.shape)}")
    single = xI.dim() == 1
    rI = xI[None] if single else xI
    rQ = xQ[None] if single else xQ
    need = n_frames * filt.R + filt.T - filt.R
    if rI.shape[1] < need:
        raise ValueError(f"{rI.shape[1]} samples < {need} needed for "
                         f"{n_frames} frames")
    if rI.stride(1) != 1 or rQ.stride(1) != 1 or rI.stride(0) != rQ.stride(0):
        raise ValueError("planes need unit sample stride and equal row "
                         "strides")
    rows = rI.shape[0]
    out = torch.empty((2, rows, n_frames), dtype=torch.float32,
                      device=xI.device)
    if n_frames <= 0 or rows == 0:
        return (out[0, 0], out[1, 0]) if single else (out[0], out[1])
    gr, gi, _, _ = filt.tensors(xI.device)
    lib = _load_kernel()
    stream = torch.cuda.current_stream(xI.device).cuda_stream
    rc = lib.polyphase_decimate(
        rI.data_ptr(), rQ.data_ptr(), int(xI.dtype == torch.uint8), rows,
        rI.stride(0), gr.data_ptr(), gi.data_ptr(), filt.T, filt.R,
        n_frames, out[0].data_ptr(), out[1].data_ptr(), n_frames, stream)
    if rc != 0:
        raise RuntimeError(f"polyphase kernel launch failed: CUDA error {rc}")
    polyphase_decimate.launches += 1
    return (out[0, 0], out[1, 0]) if single else (out[0], out[1])


polyphase_decimate.launches = 0

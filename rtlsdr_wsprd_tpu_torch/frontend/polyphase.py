"""Polyphase complex FIR decimation: two hand-written CUDA kernels and
their plain PyTorch version.

``polyphase_decimate`` is the one wrapper both front-end stages call.
For a CPU tensor it runs the plain version; for a CUDA tensor it
launches one of two kernels (``_route`` picks) or raises: there is no
fallback.

- ``csrc/polyphase_tc.cu``, the tensor-core kernel: uint8 planes through
  the stage-1 filter (R=80, T=640 complex taps), the raw 2.4 Msps
  front end. It computes the partial product below as a TF32 GEMM on
  the tensor cores, with the taps split into TF32 hi + lo parts on the
  host (``tf32_split``) so the result keeps float32 accuracy.
- ``csrc/polyphase.cu``, the float32 kernel (route ``"direct"``):
  float32 planes through the stage-1 filter or a real-tap stage-2
  filter (``DIRECT_SHAPES``). A block stages its input slab in shared
  memory once; each thread holds one phase's taps in registers and a
  tile of frames.

Either kernel also takes a bank of filters, one per input row (one
launch for all rows): the channelizer's K folded dial filters over its
one raw stream.

Both replace ``rtlsdr_wsprd_tpu/frontend/pallas_decimate.py``
``decimate_stage1_pallas``; each source holds its own note on what
bounds it on an H100 and what its design does about that.

The plain version is the partial-product form of the JAX package's
``_polyphase_pp``: with T = tpp * R, the input reshapes to rows of R
samples, ``rows @ Htop + rows @ Hbot`` gives every phase's partial
output, and frame m is the sum of tpp shifted diagonals.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..buildlib import load_library, nvcc_path
from ..device import const, derived_const

_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# route -> (library name, source, C function, its argument types)
_KERNELS = {
    "direct": ("polyphase", _CSRC / "polyphase.cu", "polyphase_decimate",
               [_vp, _vp, _ll, _ll, _ci, _vp, _vp, _ll, _ci, _ci, _ll, _vp,
                _vp, _ll, _vp]),
    "tc": ("polyphase_tc", _CSRC / "polyphase_tc.cu", "polyphase_tc_decimate",
           [_vp, _vp, _ll, _ll, _ci, _vp, _ll, _ll, _vp, _vp, _ll, _vp]),
}
# the tensor-core kernel's filter (T, R)
TC_SHAPE = (640, 80)
# polyphase.cu's two instantiations: filter (T, R) -> whether it takes
# complex taps (stage 1) or real taps only (stage 2)
DIRECT_SHAPES = {(640, 80): True, (2400, 80): False}

_libs: dict[str, ctypes.CDLL] = {}


def build_kernel(route: str) -> str:
    """Build (if needed) and load one kernel's library, ``"direct"`` or
    ``"tc"``; returns its path."""
    return _load_kernel(route)._name


def _load_kernel(route: str):
    lib = _libs.get(route)
    if lib is None:
        name, src, fn, argtypes = _KERNELS[route]
        lib = load_library(name, nvcc_path(), [src], NVCC_FLAGS)
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _ci
        _libs[route] = lib
    return lib


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


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away
    from zero, as ``cvt.rna.tf32.f32``), kept as float32 with its low 13
    mantissa bits zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_split(htop: np.ndarray, hbot: np.ndarray):
    """B = [Htop; Hbot] (2R, 2*tpp) -> (B_hi, B_lo), both exact in TF32:
    B_hi = tf32(B), B_lo = tf32(B - B_hi). A @ B_hi + A @ B_lo keeps
    about 22 bits of each tap where one TF32 product keeps 11."""
    b = np.concatenate([htop, hbot]).astype(np.float32)
    hi = tf32_round(b)
    return hi, tf32_round(b - hi)


def tc_fragments(htop: np.ndarray, hbot: np.ndarray) -> np.ndarray:
    """The tensor-core kernel's operand table: B_hi and B_lo of
    ``tf32_split`` in ``mma.m16n8k8`` B-fragment order, float32
    [K/8, N/8, 32 lanes, 4]. For k-step s, column tile j and lane
    l = 4*g + t the four values are B_hi[8s+t, 8j+g], B_hi[8s+t+4, 8j+g],
    B_lo[8s+t, 8j+g], B_lo[8s+t+4, 8j+g]: one 16-byte load per lane.
    Columns are zero-padded to a multiple of 8."""
    parts = []
    for b in tf32_split(htop, hbot):
        K, N = b.shape
        b = np.pad(b, ((0, 0), (0, -N % 8)))
        # [s, kk, j, g] -> [s, j, g, kk]
        b = b.reshape(K // 8, 8, -1, 8).transpose(0, 2, 3, 1)
        parts += [b[..., :4], b[..., 4:]]     # kk = t and t + 4
    f = np.stack(parts, axis=-1)              # [s, j, g, t, 4]
    return np.ascontiguousarray(f.reshape(f.shape[0], f.shape[1], 32, 4))


class FilterTensors(NamedTuple):
    gr: torch.Tensor       # conv-ordered taps: polyphase.cu's
    gi: torch.Tensor
    htop: torch.Tensor     # partial-product matrices: the plain version's
    hbot: torch.Tensor
    # tc_fragments: the tensor-core kernel's; None for a filter it
    # cannot take
    b_frag: torch.Tensor | None


class PolyphaseFilter:
    """One decimating filter: conv-ordered complex taps ``g`` (T,) and
    the decimation R. Holds polyphase.cu's taps (gr, gi) and
    the partial-product matrices (Htop, Hbot) as numpy tables; for a
    filter the tensor-core kernel takes, its fragment table is derived
    from the live Htop/Hbot on its way to the device."""

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

    def tensors(self, device: torch.device) -> FilterTensors:
        """Every table of this filter on ``device``; after
        ``convert.load_state_dict`` the derived ones follow the new taps."""
        frag = (derived_const(tc_fragments, (self.htop, self.hbot), device)
                if self.tc_capable else None)
        return FilterTensors(
            const(self.gr, device), const(self.gi, device),
            const(self.htop, device), const(self.hbot, device), frag)

    @property
    def tc_capable(self) -> bool:
        """Whether the tensor-core kernel takes this filter: complex
        taps of shape TC_SHAPE (stage 1)."""
        return (self.T, self.R) == TC_SHAPE and bool(np.any(self.gi))

    @property
    def direct_capable(self) -> bool:
        """Whether polyphase.cu takes this filter: a shape of
        DIRECT_SHAPES, with real taps where that instantiation needs
        them."""
        cplx = DIRECT_SHAPES.get((self.T, self.R))
        return cplx is not None and (cplx or not np.any(self.gi))


def _stack(*tables: np.ndarray) -> np.ndarray:
    return np.stack(tables)


def _bank_fragments(*tables: np.ndarray) -> np.ndarray:
    """(Htop_0, Hbot_0, Htop_1, Hbot_1, ...) -> every filter's
    ``tc_fragments`` table, stacked [K, 20, 2, 32, 4]."""
    return np.stack([tc_fragments(tables[i], tables[i + 1])
                     for i in range(0, len(tables), 2)])


def _split_bank(filt):
    """``filt``: one PolyphaseFilter, or a bank (a sequence of them of one
    shape, one per input row). Returns (the first filter, the bank's list
    or None for one filter)."""
    if isinstance(filt, PolyphaseFilter):
        return filt, None
    bank = list(filt)
    if not bank or not all(isinstance(f, PolyphaseFilter) for f in bank):
        raise TypeError("want a PolyphaseFilter or a sequence of them")
    if len({(f.T, f.R) for f in bank}) != 1:
        raise ValueError("a filter bank needs one (T, R) for every row")
    return bank[0], bank


def _center_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 RTL bytes -> centred float32; floats pass through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) - 128.0
    return x.to(torch.float32)


def polyphase_plain(xI: torch.Tensor, xQ: torch.Tensor, filt,
                    n_frames: int):
    """Plain PyTorch version: (..., L) uint8|float32 planar -> planar
    float32 (..., n_frames), L >= n_frames*R + T - R. ``filt`` is one
    PolyphaseFilter, or a bank of K (then the input is (K, L) and row k
    goes through filter k: a batched product over the rows' own
    Htop/Hbot)."""
    first, bank = _split_bank(filt)
    R, tpp = first.R, first.tpp
    if bank is None:
        tabs = filt.tensors(xI.device)
        htop, hbot = tabs.htop, tabs.hbot
    else:
        _check_bank_rows(xI, bank)
        htop = derived_const(_stack, tuple(f.htop for f in bank), xI.device)
        hbot = derived_const(_stack, tuple(f.hbot for f in bank), xI.device)
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


def _check_bank_rows(xI: torch.Tensor, bank: list) -> None:
    if xI.dim() != 2 or xI.shape[0] != len(bank):
        raise ValueError(f"a bank of {len(bank)} filters needs "
                         f"({len(bank)}, L) planes, got {tuple(xI.shape)}")


def _route(device_type: str, dtype: torch.dtype, filt) -> str:
    """The kernel a CUDA call takes: ``"tc"`` for uint8 planes through
    filters the tensor-core kernel takes (stage 1), ``"direct"`` for
    float32 planes through filters polyphase.cu takes; any other call
    raises. ``filt``: one filter or a bank, every filter of which must
    fit the route."""
    if device_type != "cuda":
        raise ValueError(f"no kernel for device type {device_type!r}")
    first, bank = _split_bank(filt)
    filters = bank or [first]
    if dtype == torch.uint8:
        bad = [f for f in filters if not f.tc_capable]
        if bad:
            raise ValueError(
                f"uint8 planes need the stage-1 filter (T, R) = {TC_SHAPE} "
                f"with complex taps, got ({bad[0].T}, {bad[0].R})")
        return "tc"
    bad = [f for f in filters if not f.direct_capable]
    if bad:
        raise ValueError(
            f"float32 planes need the stage-1 filter (T, R) = (640, 80) or "
            f"a real-tap (2400, 80) one, got ({bad[0].T}, {bad[0].R})")
    return "direct"


def polyphase_decimate(xI: torch.Tensor, xQ: torch.Tensor, filt,
                       n_frames: int):
    """(L,) or (C, L) planar uint8|float32 -> planar float32 (C?, n_frames).

    ``filt``: one PolyphaseFilter for every row, or a bank of C of them,
    row c through filter c (the channelizer passes its one stream as
    ``x.expand(C, L)``, row stride 0). CPU tensors take the plain
    version; CUDA tensors launch the kernel ``_route`` names (any row
    stride, unit sample stride) and count the launch in
    ``polyphase_decimate.launches[route]``: one launch for all rows,
    bank or not."""
    if xI.device != xQ.device:
        raise ValueError("xI and xQ on different devices")
    if xI.device.type == "cpu":
        return polyphase_plain(xI, xQ, filt, n_frames)
    if xI.device.type != "cuda":
        raise ValueError(f"unsupported device {xI.device}")
    if xI.dtype != xQ.dtype or xI.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"need uint8 or float32 planes, got "
                        f"{xI.dtype}/{xQ.dtype}")
    route = _route(xI.device.type, xI.dtype, filt)
    if xI.shape != xQ.shape or xI.dim() not in (1, 2):
        raise ValueError(f"bad plane shapes {tuple(xI.shape)}, "
                         f"{tuple(xQ.shape)}")
    filt, bank = _split_bank(filt)
    if bank is not None:
        _check_bank_rows(xI, bank)
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
    if bank is None:
        tabs = filt.tensors(xI.device)
        b_frag, gr, gi, stride = tabs.b_frag, tabs.gr, tabs.gi, 0
    elif route == "tc":
        b_frag = derived_const(
            _bank_fragments,
            tuple(t for f in bank for t in (f.htop, f.hbot)), xI.device)
        stride = b_frag[0].numel() // 4  # float4 a row
    else:
        gr = derived_const(_stack, tuple(f.gr for f in bank), xI.device)
        gi = derived_const(_stack, tuple(f.gi for f in bank), xI.device)
        stride = filt.T
    lib = _load_kernel(route)
    # 16-byte loads where both planes' rows start 16-byte aligned
    row_bytes = rI.stride(0) * rI.element_size() if rows > 1 else 0
    vec = int((rI.data_ptr() | rQ.data_ptr() | row_bytes) % 16 == 0)
    # launch in the tensors' device, whatever the calling thread's is
    with torch.cuda.device(xI.device):
        stream = torch.cuda.current_stream(xI.device).cuda_stream
        if route == "tc":
            rc = lib.polyphase_tc_decimate(
                rI.data_ptr(), rQ.data_ptr(), rows, rI.stride(0), vec,
                b_frag.data_ptr(), stride, n_frames, out[0].data_ptr(),
                out[1].data_ptr(), n_frames, stream)
        else:
            rc = lib.polyphase_decimate(
                rI.data_ptr(), rQ.data_ptr(), rows, rI.stride(0), vec,
                gr.data_ptr(), gi.data_ptr(), stride, filt.T, filt.R,
                n_frames, out[0].data_ptr(), out[1].data_ptr(), n_frames,
                stream)
    if rc != 0:
        raise RuntimeError(f"polyphase {route} kernel launch failed: CUDA "
                           f"error {rc}")
    polyphase_decimate.launches[route] += 1
    return (out[0, 0], out[1, 0]) if single else (out[0], out[1])


polyphase_decimate.launches = {"tc": 0, "direct": 0}

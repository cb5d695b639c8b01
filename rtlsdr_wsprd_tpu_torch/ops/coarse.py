"""Coarse (freq, time-shift, drift) estimation for all candidates at once:
a hand-written CUDA kernel for the grid and its plain PyTorch version.

The reference runs a triple-nested grid per candidate (wsprd/wsprd.c:
646-678): 3 freq bins x 32 time lags x (2*maxdrift+1) drifts, scoring a
pr3-signed sum of sqrt-power at the 4 tone bins over 162 symbols. As in
the JAX package (its module docstring derives the factorization), the
score at grid point (row r, lag l, drift d) is shared by every
candidate whose frequency row lands on r: the search takes each row's
first maximum over (lag, drift), and each candidate the best of its 3
rows (``_pick_candidates``, shared by both routes). Ties break
first-wins in the C's (ifr, k0, idrift) loop order: every argmax here
returns the first maximum. kindex < 0 contributes zero (the C reads out
of bounds there; a documented divergence).

``coarse_search`` is the wrapper. For a CPU tensor it runs
``coarse_search_plain``; for a CUDA tensor it launches ``csrc/coarse.cu``
(each grid point summed from pre-summed tone planes in shared memory,
all 9 drifts from one set of loaded rows, only the rows' best value and
index written) or raises: there is no fallback. Both replace the grid
of ``rtlsdr_wsprd_tpu/ops/coarse.py`` ``coarse_search``, an XLA program.
The plain version computes the whole (row x lag x drift) table as one
matmul against the weight matrix ``W`` and 12 rolled sums; the kernel
carries the runs of symbols on which ``_fd_int`` is constant in its
source and takes the pr3 signs as an argument. The two sum in another
order, so a row's value may differ by float32 rounding and, where two
grid points of a row tie within it, so may its index.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..buildlib import lazy_cuda_library
from ..config import DF, NBITS, NSYM
from ..device import const
from ..utils.channel import PR3_VECTOR
from .fano import NVCC_FLAGS
from .stft import BLOCKS

N_FREQ = 3          # ifr in if0-1..if0+1
K0_MIN, K0_MAX = -10, 21  # time search (wsprd/wsprd.c:650)
N_LAG = K0_MAX - K0_MIN + 1  # 32
MAX_DRIFT_SPAN = 4  # table width; the actual drift is limited by a mask
N_DRIFT = 2 * MAX_DRIFT_SPAN + 1  # 9
N_ROWS = 512

_TONE_OFFSETS = (-3, -1, 1, 3)   # p0..p3 rows (wsprd/wsprd.c:659-667)
_PR3_SIGN = (2.0 * PR3_VECTOR.astype(np.float32) - 1.0)  # (162,)


class CoarseEstimate(NamedTuple):
    freq: torch.Tensor   # float32[..., C] refined bin freq, Hz
    shift: torch.Tensor  # int32[..., C] sample shift = 128*(k0+1)
    drift: torch.Tensor  # float32[..., C]
    sync: torch.Tensor   # float32[..., C]


def _fd_int() -> np.ndarray:
    """floor of the float32 drift offset chain, (162, 9) int."""
    dfc = np.float32(DF)
    k = np.arange(NSYM, dtype=np.float32)
    d = np.arange(-MAX_DRIFT_SPAN, MAX_DRIFT_SPAN + 1, dtype=np.float32)
    fd = (((k[:, None] - NBITS) / np.float32(NBITS)) * d[None, :]
          / dfc).astype(np.float32)
    return np.floor(fd).astype(np.int64)


def _weights() -> tuple[np.ndarray, np.ndarray, int]:
    """Weight matrix W[i, (d, s, kind)] and the list of row shifts.
    kind 0: pr3-signed tone-difference sum; kind 1: total power sum
    (wsprd/wsprd.c:669-672)."""
    fd_int = _fd_int()
    smin = int(fd_int.min()) + min(_TONE_OFFSETS)
    smax = int(fd_int.max()) + max(_TONE_OFFSETS)
    shifts = list(range(smin, smax + 1))
    n_s = len(shifts)
    W = np.zeros((NSYM, N_DRIFT, n_s, 2), dtype=np.float32)
    ss_coef = {-3: -1.0, -1: +1.0, 1: -1.0, 3: +1.0}
    for d in range(N_DRIFT):
        for t in _TONE_OFFSETS:
            s_idx = fd_int[:, d] + t - smin
            for i in range(NSYM):
                W[i, d, s_idx[i], 0] += ss_coef[t] * _PR3_SIGN[i]
                W[i, d, s_idx[i], 1] += 1.0
    return W.reshape(NSYM, -1), np.asarray(shifts), n_s


W, SHIFTS, NS = _weights()

# column of the zero-padded spectrogram each (lag, symbol) reads:
# sqrtps[:, k0 + 2i] sits at padded column k0 + 2i + 20
_PAD_L = -2 * K0_MIN
_COLS = (np.arange(K0_MIN, K0_MAX + 1)[:, None] + _PAD_L
         + 2 * np.arange(NSYM)[None, :])  # (32, 162)


def _sync_grid_plain(ps: torch.Tensor, maxdrift) -> torch.Tensor:
    """The (row x lag x drift) grid as one matmul and 12 rolled sums,
    -inf where |drift| > ``maxdrift``: float32 (B, 512, 32 * 9), the
    flat index lag*9 + drift."""
    B = ps.shape[0]
    dev = ps.device
    w, cols = const(W, dev), const(_COLS, dev)
    sqrtps = torch.sqrt(ps)
    padded = torch.nn.functional.pad(sqrtps, (_PAD_L, 65))  # (B, 512, 432)
    G = padded[:, :, cols]                                  # (B, 512, 32, 162)
    out = G.reshape(B * N_ROWS * N_LAG, NSYM) @ w
    out = out.reshape(B, N_ROWS, N_LAG, N_DRIFT, NS, 2)

    # S[r, l, d, kind] = sum_s out[r + s, l, d, s_idx]; the roll wrap
    # never reaches the rows of interest (45..467)
    S = torch.zeros((B, N_ROWS, N_LAG, N_DRIFT, 2), dtype=torch.float32,
                    device=dev)
    for s_idx, s in enumerate(SHIFTS):
        S = S + torch.roll(out[:, :, :, :, s_idx, :], -int(s), dims=1)

    sync_grid = S[..., 0] / torch.clamp(S[..., 1], min=1e-30)  # (B,512,32,9)

    idrift = torch.arange(-MAX_DRIFT_SPAN, MAX_DRIFT_SPAN + 1,
                          dtype=torch.int32, device=dev)
    md = torch.as_tensor(maxdrift, device=dev).reshape(-1, 1, 1, 1)
    dmask = torch.abs(idrift)[None, None, None, :] <= md
    sync_grid = torch.where(dmask, sync_grid,
                            torch.full_like(sync_grid, -torch.inf))
    return sync_grid.reshape(B, N_ROWS, N_LAG * N_DRIFT)


def _row_max_plain(ps: torch.Tensor, maxdrift):
    """Each row's first maximum of ``_sync_grid_plain``: (value float32
    (B, 512), flat lag*9 + drift index int64 (B, 512))."""
    row_flat = _sync_grid_plain(ps, maxdrift)
    row_arg = torch.argmax(row_flat, dim=-1, keepdim=True)  # first max wins
    row_val = torch.gather(row_flat, -1, row_arg)[..., 0]
    return row_val, row_arg[..., 0]


def _pick_candidates(row_val: torch.Tensor, row_arg: torch.Tensor,
                     bin_idx: torch.Tensor) -> CoarseEstimate:
    """Each candidate's best of its 3 rows (if0 - 1, if0, if0 + 1), first
    max winning, from every row's best value and flat (lag*9 + drift)
    index (B, 512)."""
    B = row_val.shape[0]
    dev = row_val.device
    if0 = bin_idx.to(torch.int64) + 51              # (B, C)
    ifr = if0[..., None] + torch.arange(-1, 2, device=dev)[None, None, :]
    ifr_c = torch.clamp(ifr, 0, N_ROWS - 1)         # (B, C, 3)
    flat_idx = ifr_c.reshape(B, -1)
    val3 = torch.gather(row_val, 1, flat_idx).reshape(ifr.shape)
    arg3 = torch.gather(row_arg, 1, flat_idx).reshape(ifr.shape)

    bi = torch.argmax(val3, dim=-1, keepdim=True)   # first max = C's ifr order
    best_rd = torch.gather(arg3, -1, bi)[..., 0]
    bk = best_rd // N_DRIFT
    bd = best_rd % N_DRIFT

    best_ifr = torch.gather(ifr, -1, bi)[..., 0]
    freq = (best_ifr - 256).to(torch.float32) * (DF / 2.0)
    shift = (128 * (bk + K0_MIN + 1)).to(torch.int32)
    drift = (bd - MAX_DRIFT_SPAN).to(torch.float32)
    best_sync = torch.gather(val3, -1, bi)[..., 0]
    return CoarseEstimate(freq=freq, shift=shift, drift=drift, sync=best_sync)


def coarse_search_plain(ps: torch.Tensor, bin_idx: torch.Tensor,
                        maxdrift) -> CoarseEstimate:
    """Plain PyTorch version of ``coarse_search`` (same arguments)."""
    return _pick_candidates(*_row_max_plain(ps, maxdrift), bin_idx)


_SOURCE = Path(__file__).resolve().parent / "csrc" / "coarse.cu"
_vp, _ci = ctypes.c_void_p, ctypes.c_int


def _bind(lib) -> None:
    # coarse_rows(ps, sign, maxdrift, n, row_val, row_arg, stream)
    lib.coarse_rows.argtypes = [_vp, _vp, _vp, _ci, _vp, _vp, _vp]
    lib.coarse_rows.restype = _ci


_load_kernel = lazy_cuda_library("coarse", [_SOURCE], NVCC_FLAGS, _bind)


def build_kernel() -> str:
    """Build (if needed) and load ``csrc/coarse.cu``; returns its path."""
    return _load_kernel()._name


def _maxdrift_rows(maxdrift, B: int, dev: torch.device) -> torch.Tensor:
    """``maxdrift`` (int, or an int tensor of 1 or B elements) as int32
    (B,) on ``dev``. An int is filled in on the device: no copy from the
    host, which would wait for the stream."""
    if isinstance(maxdrift, int) and not isinstance(maxdrift, bool):
        return torch.full((B,), maxdrift, dtype=torch.int32, device=dev)
    md = torch.as_tensor(maxdrift, device=dev)
    if md.dtype.is_floating_point or md.dtype == torch.bool or \
            md.numel() not in (1, B):
        raise ValueError(f"maxdrift must be an int or an int tensor of 1 or "
                         f"{B} elements, got {md.dtype}{tuple(md.shape)}")
    return md.to(torch.int32).reshape(-1).expand(B).contiguous()


def coarse_rows(ps: torch.Tensor, maxdrift) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Each row's first maximum over the (lag, drift) grid: (value
    float32 (B, 512), flat lag*9 + drift index (B, 512): int64 from the
    plain version on the CPU, int32 from ``csrc/coarse.cu`` on a CUDA
    tensor, which counts the launch in ``coarse_search.launches``). Any
    other device raises; so does a CUDA call the kernel cannot take."""
    dev = ps.device
    if dev.type == "cpu":
        return _row_max_plain(ps, maxdrift)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if ps.dtype != torch.float32 or ps.dim() != 3 or \
            tuple(ps.shape[1:]) != (N_ROWS, BLOCKS):
        raise ValueError(f"ps must be float32[B, {N_ROWS}, {BLOCKS}], got "
                         f"{ps.dtype}{tuple(ps.shape)}")
    # the layout power_spectrogram returns: the transpose of a row-major
    # (B, 347, 512) array
    if not ps.transpose(1, 2).is_contiguous():
        raise ValueError("ps must be the transpose of a contiguous "
                         "(B, 347, 512) tensor, as power_spectrogram "
                         "returns it")
    B = ps.shape[0]
    lib = _load_kernel()
    md = _maxdrift_rows(maxdrift, B, dev)
    sign = const(_PR3_SIGN, dev)
    row_val = torch.empty((B, N_ROWS), dtype=torch.float32, device=dev)
    row_arg = torch.empty((B, N_ROWS), dtype=torch.int32, device=dev)
    if B == 0:
        return row_val, row_arg
    # launch in the tensors' device, whatever the calling thread's is
    with torch.cuda.device(dev):
        rc = lib.coarse_rows(ps.data_ptr(), sign.data_ptr(), md.data_ptr(),
                             B, row_val.data_ptr(), row_arg.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coarse kernel launch failed: CUDA error {rc}")
    coarse_search.launches += 1
    return row_val, row_arg


def coarse_search(ps: torch.Tensor, bin_idx: torch.Tensor,
                  maxdrift) -> CoarseEstimate:
    """ps float32 (B, 512, BLOCKS); bin_idx int32 (B, C) smspec bins;
    maxdrift: int or int tensor (B,). Best (freq, shift, drift, sync) per
    candidate over the full grid, first max winning in (ifr, k0, idrift)
    order.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/coarse.cu`` for the grid (``coarse_rows``) and count the
    launch in ``coarse_search.launches``; any other device raises."""
    return _pick_candidates(*coarse_rows(ps, maxdrift), bin_idx)


coarse_search.launches = 0

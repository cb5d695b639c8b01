"""Coarse (freq, time-shift, drift) estimation for all candidates at once.

The reference runs a triple-nested grid per candidate (wsprd/wsprd.c:
646-678): 3 freq bins x 32 time lags x (2*maxdrift+1) drifts, scoring a
pr3-signed sum of sqrt-power at the 4 tone bins over 162 symbols. As in
the JAX package (its module docstring derives the factorization), the
score at grid point (row r, lag l, drift d) is shared by every
candidate whose frequency row lands on r, so the whole (row x lag x
drift) table is one matmul and candidates read their 3 rows from it.
Ties break first-wins in the C's (ifr, k0, idrift) loop order: every
argmax here returns the first maximum. kindex < 0 contributes zero
(the C reads out of bounds there; a documented divergence).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DF, NBITS, NSYM
from ..device import const
from ..utils.channel import PR3_VECTOR

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


def coarse_search(ps: torch.Tensor, bin_idx: torch.Tensor,
                  maxdrift) -> CoarseEstimate:
    """ps float32 (B, 512, BLOCKS); bin_idx int32 (B, C) smspec bins;
    maxdrift: int or int tensor (B,). Best (freq, shift, drift, sync) per
    candidate over the full grid, first max winning in (ifr, k0, idrift)
    order."""
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

    row_flat = sync_grid.reshape(B, N_ROWS, N_LAG * N_DRIFT)
    row_arg = torch.argmax(row_flat, dim=-1, keepdim=True)  # first max wins
    row_val = torch.gather(row_flat, -1, row_arg)[..., 0]
    row_arg = row_arg[..., 0]

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

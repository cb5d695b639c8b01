"""Fine sync and soft-symbol demodulation over candidate lanes.

The reference's sync_and_demodulate (wsprd/wsprd.c:101-259) is a
3-mode sequential matched filter. As in the JAX package (whose module
docstring derives it), all candidate lanes run at once and the
per-sample phasor factorizes into a per-lane part and a static tone
part; because the per-lane part is a pure exponential in the sample
index, the correlation at EVERY static lag/jitter offset is one matmul

    (lanes*162, 512) @ (512, n_offsets*4)

against a static offset-shifted tone matrix, and the leftover unit
phase vanishes under the magnitude. The products are plain large
``torch.matmul`` calls in float32 (TF32 off, see device.py).

Only the lane variants of the JAX module are ported: the staged decode
compacts every valid candidate across the window batch into lanes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DF, DT, NBITS, NSPERSYM, NSYM
from ..device import const
from ..utils.channel import PR3_VECTOR

TWOPIDT = 2.0 * np.pi * DT

# E_TONE[j, t] = exp(-i * 2*pi*dt * (t-1.5)*DF * j): static tone phasors
_j = np.arange(NSPERSYM, dtype=np.float64)
_t = np.arange(4, dtype=np.float64) - 1.5
_ANG_TONE = TWOPIDT * DF * np.outer(_j, _t)
E_TONE_R = np.cos(_ANG_TONE).astype(np.float32)   # (256, 4)
E_TONE_I = (-np.sin(_ANG_TONE)).astype(np.float32)

_PR3 = PR3_VECTOR.astype(bool)          # (162,)
_PR3_SIGN = 2.0 * PR3_VECTOR.astype(np.float32) - 1.0

HALF_SPAN = 128                       # max |lag| (mode 0) and |jitter|
NSIG = NSYM * NSPERSYM                # 41472
WLEN = NSIG + 2 * HALF_SPAN           # per-lane window length
ULEN = 2 * NSPERSYM                   # double-length frame: all offsets
_PAD = 2048                           # coarse shift range is [-1152, 2944]


def _cand_phasor_conj(f0: torch.Tensor, drift: torch.Tensor,
                      ulen: int = NSPERSYM):
    """conj of the per-lane base phasor, planar (re, im), (G, 162, ulen).

    fp_i = f0 + (drift/2) * (i - 81)/81 (wsprd/wsprd.c:156); the phase
    accumulates as j * 2*pi*dt*fp_i within each symbol."""
    dev = f0.device
    i = torch.arange(NSYM, dtype=torch.float32, device=dev)
    fp = f0[:, None] + (drift[:, None] / 2.0) * (i[None, :] - NBITS) / NBITS
    dphi = TWOPIDT * fp
    phase = dphi[:, :, None] * torch.arange(ulen, dtype=torch.float32,
                                            device=dev)
    return torch.cos(phase), -torch.sin(phase)


def _padded_signals(sig_i: torch.Tensor, sig_q: torch.Tensor):
    """(B, N) -> (B, N + 2*_PAD) with sample 0 zeroed: the C's strict
    k > 0 bound (wsprd/wsprd.c:199); out-of-range reads hit zeros."""
    def pad(x):
        x = x.clone()
        x[:, 0] = 0.0
        return F.pad(x, (_PAD, _PAD))
    return pad(sig_i), pad(sig_q)


def _lane_windows(pi: torch.Tensor, pq: torch.Tensor, lane_w: torch.Tensor,
                  shifts: torch.Tensor):
    """Padded planes (B, N+2*_PAD), lane_w int[G] window of each lane,
    shifts int[G] -> (G, WLEN) windows starting at shift - HALF_SPAN
    (start clamped into the plane, as a dynamic slice is)."""
    starts = shifts.to(torch.int64) + (_PAD - HALF_SPAN)
    starts = torch.clamp(starts, 0, pi.shape[1] - WLEN)
    idx = starts[:, None] + torch.arange(WLEN, device=pi.device)
    rows = lane_w.to(torch.int64)[:, None]
    return pi[rows, idx], pq[rows, idx]


def _double_frames(w: torch.Tensor) -> torch.Tensor:
    """(G, WLEN) -> (G, 162, 512) double-length symbol frames
    D[g, i, u] = w[g, 256*i + u]."""
    f = w.reshape(w.shape[0], NSYM + 1, NSPERSYM)
    return torch.cat([f[:, :NSYM], f[:, 1:]], dim=2)


def _window_symbols(w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Per-lane offsets (G,) -> (G, 162, 256) symbol frames."""
    idx = offs.to(torch.int64)[:, None] + torch.arange(NSIG, device=w.device)
    return torch.gather(w, 1, idx).reshape(w.shape[0], NSYM, NSPERSYM)


def _tone_mags(yr, yi, er, ei) -> torch.Tensor:
    """y (G, 162, n) de-rotated samples; e (n, K) phasors -> |z| (G, 162, K)."""
    zr = yr @ er - yi @ ei
    zi = yr @ ei + yi @ er
    return torch.sqrt(zr * zr + zi * zi)


def _derotate(xr, xi, ecr, eci):
    """y = x * ec, planar."""
    return xr * ecr - xi * eci, xr * eci + xi * ecr


@lru_cache(maxsize=None)
def _offset_tone_matrix(offsets: tuple):
    """Static planar (ULEN, L*4) matrices T[u, (l,t)] = E_TONE[u-o_l, t]
    (zero outside [o_l, o_l+256)) for absolute offsets o_l in
    [0, 2*HALF_SPAN]."""
    L = len(offsets)
    tr = np.zeros((ULEN, L, 4), np.float32)
    ti = np.zeros((ULEN, L, 4), np.float32)
    for idx, o in enumerate(offsets):
        tr[o:o + NSPERSYM, idx] = E_TONE_R
        ti[o:o + NSPERSYM, idx] = E_TONE_I
    return tr.reshape(ULEN, L * 4), ti.reshape(ULEN, L * 4)


def _tone_mags_offsets(wr: torch.Tensor, wi: torch.Tensor,
                       freq: torch.Tensor, drift: torch.Tensor,
                       offsets: tuple, phasor=None) -> torch.Tensor:
    """Tone magnitudes at every static window offset in one matmul
    pair: (G, WLEN) windows -> (G, 162, L, 4). Offsets are absolute
    (relative lag/jitter + HALF_SPAN)."""
    dr = _double_frames(wr)
    di = _double_frames(wi)
    ecr, eci = (phasor if phasor is not None
                else _cand_phasor_conj(freq, drift, ulen=ULEN))
    yr, yi = _derotate(dr, di, ecr, eci)
    tr_np, ti_np = _offset_tone_matrix(offsets)
    p = _tone_mags(yr, yi, const(tr_np, wr.device), const(ti_np, wr.device))
    return p.reshape(p.shape[0], NSYM, len(offsets), 4)


def _sync_from_powers(p: torch.Tensor) -> torch.Tensor:
    """p (..., 162, 4) tone magnitudes -> sync metric (...)
    (wsprd/wsprd.c:216-227)."""
    cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])
    ss = torch.sum(const(_PR3_SIGN, p.device) * cmet, dim=-1)
    totp = torch.sum(p, dim=(-2, -1))
    return ss / torch.clamp(totp, min=1e-30)


class FineSync(NamedTuple):
    freq: torch.Tensor   # float32[G]
    shift: torch.Tensor  # int32[G]
    sync: torch.Tensor   # float32[G]


@lru_cache(maxsize=None)
def _rel_lags(lagstep: int) -> np.ndarray:
    return np.arange(-128, 129, lagstep, dtype=np.int32)


def _fine_sync_core(wr, wi, freq, shift, drift, lagstep: int) -> FineSync:
    """Mode-0 lag search, then mode-1 freq search, over (G, WLEN) windows."""
    dev = wr.device
    rel_lags = _rel_lags(lagstep)
    offs = tuple(int(r) + HALF_SPAN for r in rel_lags)
    ec512 = _cand_phasor_conj(freq, drift, ulen=ULEN)   # shared 0/1
    p = _tone_mags_offsets(wr, wi, freq, drift, offs, phasor=ec512)
    sync_l = _sync_from_powers(torch.movedim(p, 2, 0))  # (L, G)
    best_l = torch.argmax(sync_l, dim=0)  # first max wins = the C's lag order
    shift1 = shift + const(rel_lags, dev)[best_l]

    # mode 1 reuses mode 0's phasor (pure exponential: identical first
    # NSPERSYM columns)
    ecr, eci = ec512[0][..., :NSPERSYM], ec512[1][..., :NSPERSYM]
    etr = const(E_TONE_R, dev)
    eti = const(E_TONE_I, dev)

    fstep = 0.1
    ifreqs = torch.arange(-2, 3, dtype=torch.float32, device=dev)
    jj = torch.arange(NSPERSYM, dtype=torch.float32, device=dev)
    ph = TWOPIDT * fstep * torch.outer(jj, ifreqs)
    efr, efi = torch.cos(ph), -torch.sin(ph)            # (256, 5)
    er = (efr[:, :, None] * etr[:, None, :]
          - efi[:, :, None] * eti[:, None, :]).reshape(NSPERSYM, 20)
    ei = (efr[:, :, None] * eti[:, None, :]
          + efi[:, :, None] * etr[:, None, :]).reshape(NSPERSYM, 20)

    # shift1 - shift in [-128, 128]: still inside the same windows
    o = shift1 - shift + HALF_SPAN
    xr = _window_symbols(wr, o)
    xi = _window_symbols(wi, o)
    yr, yi = _derotate(xr, xi, ecr, eci)
    p = _tone_mags(yr, yi, er, ei).reshape(xr.shape[0], NSYM, 5, 4)
    sync_f = _sync_from_powers(torch.movedim(p, 2, 0))  # (5, G)
    best_f = torch.argmax(sync_f, dim=0)                # freq ascending, first wins
    freq1 = freq + (best_f.to(torch.float32) - 2.0) * fstep
    sync1 = torch.gather(sync_f, 0, best_f[None, :])[0]
    return FineSync(freq=freq1, shift=shift1, sync=sync1)


def fine_sync_lanes(sig_i, sig_q, lane_w, freq, shift, drift,
                    lagstep: int = 8) -> FineSync:
    """Mode-0 lag search (+/-128 by lagstep) then mode-1 freq search
    (+/-0.2 Hz, step 0.1) over candidate lanes compacted across a window
    batch (wsprd/wsprd.c:709-726): sig_i/sig_q (B, N) planar, lane_w
    int[G] maps each lane to its window. quickmode uses lagstep=16."""
    pi, pq = _padded_signals(sig_i, sig_q)
    wr, wi = _lane_windows(pi, pq, lane_w, shift)
    return _fine_sync_core(wr, wi, freq, shift, drift, lagstep)


def jitter_offsets(iifac: int = 3, quickmode: bool = False) -> np.ndarray:
    """The DT peak-up schedule 0, -1, +1, -2, +2, ... times iifac
    (wsprd/wsprd.c:741-745); quickmode tries only the first."""
    n = 1 if quickmode else (128 // iifac) + 1
    out = []
    for idt in range(n):
        ii = (idt + 1) // 2
        if idt % 2 == 1:
            ii = -ii
        out.append(iifac * ii)
    return np.asarray(out, dtype=np.int32)


class JitteredSymbols(NamedTuple):
    symbols: torch.Tensor  # uint8[J, G, 162] soft symbols (128 = erasure)
    sync: torch.Tensor     # float32[J, G] mode-2 sync metric
    rms: torch.Tensor      # float32[J, G] soft-symbol RMS


def _soft_symbols_core(wr, wi, freq, drift, iifac: int, quickmode: bool,
                       symfac: int) -> JitteredSymbols:
    """Mode 2 for every jitter attempt in one offset matmul; the J axis
    stays in schedule order (0, -ii, +ii, ...) so first-success selection
    keeps the reference's jitter-loop semantics (wsprd/wsprd.c:739-766)."""
    offs = tuple(int(o) + HALF_SPAN
                 for o in jitter_offsets(iifac, quickmode))
    p = _tone_mags_offsets(wr, wi, freq, drift, offs)  # (G,162,J,4)
    pj = torch.movedim(p, 2, 0)                        # (J,G,162,4)
    sync = _sync_from_powers(pj)
    pr3 = const(_PR3, wr.device)
    # fsymb = p3-p1 (pr3=1) else p2-p0 (wsprd/wsprd.c:219-225)
    fsymb = torch.where(pr3[None, None, :],
                        pj[..., 3] - pj[..., 1], pj[..., 2] - pj[..., 0])
    fsum = torch.sum(fsymb / NSYM, dim=-1, keepdim=True)
    f2sum = torch.sum(fsymb * fsymb / NSYM, dim=-1, keepdim=True)
    fac = torch.sqrt(torch.clamp(f2sum - fsum * fsum, min=1e-30))
    fs = symfac * fsymb / fac
    fs = torch.clamp(fs, -128.0, 127.0)
    # C: symbols[i] = (uchar)(fsymb[i] + 128) truncates toward zero;
    # fs + 128 >= 0, so truncation == floor
    sym = torch.floor(fs + 128.0).to(torch.uint8)      # (J,G,162)
    y = sym.to(torch.float32) - 128.0
    rms = torch.sqrt(torch.sum(y * y, dim=-1) / NSYM)  # (J,G)
    return JitteredSymbols(symbols=sym, sync=sync, rms=rms)


def soft_symbols_lanes(sig_i, sig_q, lane_w, freq, shift, drift,
                       iifac: int = 3, quickmode: bool = False,
                       symfac: int = 50) -> JitteredSymbols:
    """Mode-2 soft symbols over candidate lanes compacted across a
    window batch (see fine_sync_lanes)."""
    pi, pq = _padded_signals(sig_i, sig_q)
    wr, wi = _lane_windows(pi, pq, lane_w, shift)
    return _soft_symbols_core(wr, wi, freq, drift, iifac, quickmode, symfac)

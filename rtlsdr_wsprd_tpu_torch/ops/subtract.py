"""Decoded-signal subtraction between decode passes (planar I/Q).

``subtract_signal2`` follows the reference (wsprd/wsprd.c:315-413):
regenerate the decoded transmission as a continuous-phase 4-FSK
reference r(t), estimate the channel's complex envelope
c(t) = LPF[s(t) * conj(r(t))] with a 360-tap half-sine FIR, and
subtract c(t) * r(t) with partial-sum edge normalization. Every
function here is batched over rows (one decode per row); the FIR is
the JAX package's block-Toeplitz matmul. ``subtract_signal2_many``
masks rows (the dense path's subtraction rounds on host copies),
``subtract_rows`` updates rows of a device-resident batch (the staged
path), and ``subtract_signal`` is the simpler per-symbol variant the
reference defines but never calls (wsprd/wsprd.c:263-312), kept for
the JAX package's API.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DF, DT, NSPERSYM, NSYM, SIGNAL_SAMPLES
from ..device import const

TWOPIDT = 2.0 * np.pi * DT
NFILT = 360  # LPF taps (wsprd/wsprd.c:326)
NSIG = NSYM * NSPERSYM  # 41472 reference samples
_PAD = 8192  # headroom around the window for the shifted extract


def _halfsine_taps() -> tuple[np.ndarray, np.ndarray]:
    """Normalized half-sine LPF and its partial sums
    (wsprd/wsprd.c:353-368)."""
    w = np.sin(np.pi * np.arange(NFILT, dtype=np.float64) / (NFILT - 1))
    w = (w / w.sum()).astype(np.float32)
    partial = np.concatenate([[0.0], np.cumsum(w[1:])]).astype(np.float32)
    return w, partial


_W, _PARTIAL = _halfsine_taps()
_NFRAME = SIGNAL_SAMPLES // NFILT  # 125 frames of NFILT samples


def _toeplitz_w3() -> np.ndarray:
    """(1080, 360) block-Toeplitz matrix: with xcat[m, j] = x[(m-1)*360 + j],
    y[m*360 + t] = sum_j xcat[m, j] * W3[j, t], W3[j, t] = w[t + 539 - j]."""
    w3 = np.zeros((3 * NFILT, NFILT), np.float32)
    j = np.arange(3 * NFILT)[:, None]
    t = np.arange(NFILT)[None, :]
    k = t + 539 - j
    ok = (k >= 0) & (k < NFILT)
    w3[ok] = _W[k[ok]]
    return w3


_W3 = _toeplitz_w3()


def _norm() -> np.ndarray:
    """Edge normalization by the filter's partial step response over the
    NSIG reference samples (wsprd/wsprd.c:397-411)."""
    i = np.arange(NSIG)
    h = NFILT // 2
    out = np.ones(NSIG, np.float32)
    out[i < h] = _PARTIAL[h + i[i < h]]
    hi = i > NSIG - 1 - h
    out[hi] = _PARTIAL[np.clip(h + NSIG - 1 - i[hi], 0, NFILT - 1)]
    return out


_NORM = _norm()


def _fir_same(x: torch.Tensor) -> torch.Tensor:
    """numpy-convolve-'same' half-sine FIR along the last axis:
    y[n] = sum_k w[k] x[n+179-k], x (..., 45000)."""
    w3 = const(_W3, x.device)
    xp = F.pad(x, (NFILT, NFILT))
    lead = x.shape[:-1]
    xcat = torch.cat([
        xp[..., o:o + SIGNAL_SAMPLES].reshape(*lead, _NFRAME, NFILT)
        for o in (0, NFILT, 2 * NFILT)], dim=-1)    # (..., 125, 1080)
    return (xcat @ w3).reshape(*lead, SIGNAL_SAMPLES)


def _reference_signal(f0: torch.Tensor, drift: torch.Tensor,
                      symbols: torch.Tensor):
    """Continuous-phase 4-FSK reference r(t), planar (re, im)
    float32 (R, 41472) (wsprd/wsprd.c:339-351)."""
    dev = f0.device
    i = torch.arange(NSYM, dtype=torch.float32, device=dev)
    cs = symbols.to(torch.float32)
    fsym = (f0[:, None] + (drift[:, None] / 2.0) * (i - NSYM / 2.0)
            / (NSYM / 2.0) + (cs - 1.5) * DF)
    dphi = TWOPIDT * fsym
    incr = torch.repeat_interleave(dphi, NSPERSYM, dim=1)   # (R, 41472)
    phi = torch.cat([torch.zeros_like(incr[:, :1]),
                     torch.cumsum(incr, dim=1)[:, :-1]], dim=1)
    return torch.cos(phi), torch.sin(phi)


def subtract_signal2(sig_i, sig_q, f0, shift, drift, symbols):
    """Rows (R, 45000) planar; f0/drift float32 (R,), shift int (R,),
    symbols uint8 (R, 162) -> (i, q) with each row's decode coherently
    removed."""
    R = sig_i.shape[0]
    dev = sig_i.device
    norm = const(_NORM, dev)
    rr, ri = _reference_signal(f0, drift, symbols)
    i = torch.arange(NSIG, device=dev)
    k = shift.to(torch.int64)[:, None] + i
    ok = (k > 0) & (k < SIGNAL_SAMPLES)
    start = torch.clamp(shift.to(torch.int64) + _PAD, 0,
                        SIGNAL_SAMPLES + 2 * _PAD - NSIG)
    pos = start[:, None] + i                      # (R, NSIG) padded positions
    pad_i = F.pad(sig_i, (_PAD, _PAD))
    pad_q = F.pad(sig_q, (_PAD, _PAD))
    zero = torch.zeros((), dtype=sig_i.dtype, device=dev)
    sr = torch.where(ok, torch.gather(pad_i, 1, pos), zero)
    si = torch.where(ok, torch.gather(pad_q, 1, pos), zero)
    cr = torch.zeros((R, SIGNAL_SAMPLES), dtype=sig_i.dtype, device=dev)
    ci = torch.zeros_like(cr)
    cr[:, NFILT:NFILT + NSIG] = sr * rr + si * ri      # s * conj(r)
    ci[:, NFILT:NFILT + NSIG] = si * rr - sr * ri

    # LPF, output restricted to [NFILT/2, SIGNAL_SAMPLES - NFILT/2)
    cfr = _fir_same(cr)
    cfi = _fir_same(ci)
    p = torch.arange(SIGNAL_SAMPLES, device=dev)
    keep = (p >= NFILT // 2) & (p < SIGNAL_SAMPLES - NFILT // 2)
    cfr = torch.where(keep, cfr, zero)
    cfi = torch.where(keep, cfi, zero)

    gr = cfr[:, NFILT:NFILT + NSIG] / norm
    gi = cfi[:, NFILT:NFILT + NSIG] / norm
    dr = torch.where(ok, gr * rr - gi * ri, zero)
    di = torch.where(ok, gr * ri + gi * rr, zero)
    full_i = torch.zeros((R, SIGNAL_SAMPLES + 2 * _PAD), dtype=sig_i.dtype,
                         device=dev)
    full_q = torch.zeros_like(full_i)
    full_i.scatter_(1, pos, dr)
    full_q.scatter_(1, pos, di)
    return (sig_i - full_i[:, _PAD:_PAD + SIGNAL_SAMPLES],
            sig_q - full_q[:, _PAD:_PAD + SIGNAL_SAMPLES])


def subtract_signal2_many(sig_i, sig_q, f0, shift, drift, symbols, enable):
    """``subtract_signal2`` on rows whose ``enable`` (bool (R,)) is set;
    the other rows pass through unchanged (padding of partial rounds).
    Decodes of the SAME window go in separate sequential calls, each
    reading the previous result (wsprd/wsprd.c:781-789)."""
    ni, nq = subtract_signal2(sig_i, sig_q, f0, shift, drift, symbols)
    en = enable[:, None]
    return torch.where(en, ni, sig_i), torch.where(en, nq, sig_q)


def subtract_signal(sig_i, sig_q, f0, shift, drift, symbols):
    """Per-symbol amplitude estimate and subtraction, one decode per row
    (wsprd/wsprd.c:263-312; defined but unused in the reference): the
    per-symbol phasor restarts at each symbol and uses (i - 81)/81 for
    the drift, like sync (wsprd/wsprd.c:274)."""
    R = sig_i.shape[0]
    dev = sig_i.device
    i = torch.arange(NSYM, dtype=torch.float32, device=dev)
    cs = symbols.to(torch.float32)
    fsym = (f0[:, None] + (drift[:, None] / 2.0) * (i - 81.0) / 81.0
            + (cs - 1.5) * DF)                               # (R, 162)
    phase = (TWOPIDT * fsym)[..., None] * torch.arange(
        NSPERSYM, dtype=torch.float32, device=dev)           # (R, 162, 256)
    er, ei = torch.cos(phase), torch.sin(phase)
    k = (shift.to(torch.int64)[:, None, None]
         + NSPERSYM * torch.arange(NSYM, device=dev)[:, None]
         + torch.arange(NSPERSYM, device=dev))
    ok = (k > 0) & (k < SIGNAL_SAMPLES)
    kc = torch.clamp(k, 0, SIGNAL_SAMPLES - 1).reshape(R, -1)
    zero = torch.zeros((), dtype=sig_i.dtype, device=dev)
    sr = torch.where(ok, torch.gather(sig_i, 1, kc).reshape(k.shape), zero)
    si = torch.where(ok, torch.gather(sig_q, 1, kc).reshape(k.shape), zero)
    # amp = mean(s * conj(e)) per symbol
    ar = torch.sum(sr * er + si * ei, dim=2) / NSPERSYM      # (R, 162)
    ai = torch.sum(si * er - sr * ei, dim=2) / NSPERSYM
    dr = ar[..., None] * er - ai[..., None] * ei
    di = ar[..., None] * ei + ai[..., None] * er
    return (sig_i.scatter_add(1, kc, torch.where(ok, -dr, zero).reshape(R, -1)),
            sig_q.scatter_add(1, kc, torch.where(ok, -di, zero).reshape(R, -1)))


def subtract_rows(sig_i, sig_q, bidx, f0, shift, drift, symbols, enable):
    """Apply one decode per ROW of a (B, 45000) window batch; returns new
    planes (the inputs are not modified).

    bidx int[R] selects the row each lane updates; enable bool[R] masks
    padding lanes. Updates are added as deltas, so a disabled lane may
    share a row with an enabled one; two ENABLED lanes must not target
    the same row (the caller's round loop keeps one decode per channel
    per round, wsprd/wsprd.c:781-789)."""
    bidx = bidx.to(torch.int64)
    row_i = sig_i[bidx]
    row_q = sig_q[bidx]
    ni, nq = subtract_signal2(row_i, row_q, f0, shift, drift, symbols)
    en = enable[:, None]
    zero = torch.zeros((), dtype=sig_i.dtype, device=sig_i.device)
    di = torch.where(en, ni - row_i, zero)
    dq = torch.where(en, nq - row_q, zero)
    return sig_i.index_add(0, bidx, di), sig_q.index_add(0, bidx, dq)

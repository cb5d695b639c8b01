"""The decode's signal processing in plain PyTorch, one window at a time.

A frozen copy of the port's plain routes (its CPU versions), which the
benchmark holds the port's CUDA kernels and batched drivers against:
the STFT power spectrogram and the candidate pick (wsprd/wsprd.c:496-631),
the coarse (freq, lag, drift) grid (:646-678), fine sync and the
jittered soft symbols (:101-259, :709-766) and the coherent subtraction
(:315-413). Every product is a plain ``torch`` matmul; on a card the
control takes them at TF32 (``precision``). Nothing
here imports the program.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .channel import PR3_VECTOR
from .constants import (DF, DT, FFT_SIZE, MAX_CANDIDATES, NBITS, NSPERSYM,
                        NSYM, SIGNAL_SAMPLES)
from .precision import mm

_CONSTS: dict = {}


def const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy table as a tensor on ``device``, made once."""
    key = (id(a), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = (a, torch.from_numpy(
            np.ascontiguousarray(a)).to(device))
    return hit[1]


# ---- STFT power spectrogram ----
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
    zr = mm(fr, C) + mm(fi, S)
    zi = mm(fi, C) - mm(fr, S)
    ps = zr * zr + zi * zi
    return ps.transpose(-1, -2)


# ---- candidate pick ----

SMSPEC_BINS = 411          # center bins, +/-150 Hz (wsprd/wsprd.c:564-573)
NOISE_PERCENTILE_IDX = 122  # 30th percentile of 411 (wsprd/wsprd.c:582)
SNR_SCALING = 26.3         # wspr bw -> 2500 Hz bw (wsprd/wsprd.c:591)
MIN_SNR = 10.0 ** (-8.0 / 10.0)  # -8 dB floor (wsprd/wsprd.c:590)


class Candidates(NamedTuple):
    """Fixed-size candidate set, sorted by SNR descending."""

    bin_idx: torch.Tensor  # int32[..., MAX_CANDIDATES] smspec bin j (0..410)
    freq: torch.Tensor     # float32[..., MAX_CANDIDATES] (j-205)*DF/2, Hz
    snr: torch.Tensor      # float32[..., MAX_CANDIDATES] dB
    valid: torch.Tensor    # bool[..., MAX_CANDIDATES]


def smoothed_spectrum(ps: torch.Tensor) -> torch.Tensor:
    """ps (..., 512, BLOCKS) -> renormalized smoothed spectrum (..., 411)."""
    psavg = ps.sum(dim=-1)
    base = 256 - 205
    smspec = psavg[..., base - 3:base - 3 + SMSPEC_BINS]
    for t in range(1, 7):
        smspec = smspec + psavg[..., base - 3 + t:base - 3 + t + SMSPEC_BINS]
    noise_level = torch.sort(smspec, dim=-1).values[
        ..., NOISE_PERCENTILE_IDX:NOISE_PERCENTILE_IDX + 1]
    smspec = smspec / noise_level - 1.0
    return torch.where(smspec < MIN_SNR,
                       torch.full_like(smspec, 0.1 * MIN_SNR), smspec)


def find_candidates(ps: torch.Tensor, fmin: float = -110.0,
                    fmax: float = 110.0) -> Candidates:
    """Pick up to MAX_CANDIDATES local maxima (wsprd/wsprd.c:599-631):
    the first 200 local maxima in bin order are kept (the cap applies
    before band filtering), candidates outside [fmin, fmax] are dropped,
    and the survivors are sorted by SNR descending, stably."""
    smspec = smoothed_spectrum(ps)
    dev = smspec.device
    j = torch.arange(SMSPEC_BINS, device=dev)
    interior = (j >= 1) & (j <= SMSPEC_BINS - 2)
    left = torch.roll(smspec, 1, dims=-1)
    right = torch.roll(smspec, -1, dims=-1)
    is_peak = interior & (smspec > left) & (smspec > right)
    order_rank = torch.cumsum(is_peak.to(torch.int32), dim=-1) - 1
    is_peak = is_peak & (order_rank < MAX_CANDIDATES)

    freq = (j - 205).to(torch.float32) * (DF / 2.0)
    in_band = (freq >= fmin) & (freq <= fmax)
    valid = is_peak & in_band

    snr = 10.0 * torch.log10(smspec) - SNR_SCALING

    key = torch.where(valid, -snr, torch.full_like(snr, math.inf))
    perm = torch.sort(key, dim=-1, stable=True).indices[..., :MAX_CANDIDATES]
    return Candidates(
        bin_idx=perm.to(torch.int32),
        freq=freq[perm],
        snr=torch.gather(snr, -1, perm),
        valid=torch.gather(valid, -1, perm),
    )


# ---- coarse grid ----

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
    out = mm(G.reshape(B * N_ROWS * N_LAG, NSYM), w)
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


# ---- fine sync and soft symbols ----

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
    zr = mm(yr, er) - mm(yi, ei)
    zi = mm(yr, ei) + mm(yi, er)
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
                             offsets: tuple) -> torch.Tensor:
    """Tone magnitudes at every static window offset in one matmul
    pair: (G, WLEN) windows -> (G, 162, L, 4). Offsets are absolute
    (relative lag/jitter + HALF_SPAN)."""
    dr = _double_frames(wr)
    di = _double_frames(wi)
    ecr, eci = _cand_phasor_conj(freq, drift, ulen=ULEN)
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
    p = _tone_mags_offsets(wr, wi, freq, drift, offs)
    sync_l = _sync_from_powers(torch.movedim(p, 2, 0))  # (L, G)
    best_l = torch.argmax(sync_l, dim=0)  # first max wins = the C's lag order
    shift1 = shift + const(rel_lags, dev)[best_l]

    # mode 1's phasor: the first NSPERSYM columns of mode 0's (a pure
    # exponential, each element computed alone)
    ecr, eci = _cand_phasor_conj(freq, drift)
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


# ---- subtraction ----

NFILT = 360  # LPF taps (wsprd/wsprd.c:326)
_SUB_PAD = 8192  # headroom around the window for the shifted extract


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
    return mm(xcat, w3).reshape(*lead, SIGNAL_SAMPLES)


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
    start = torch.clamp(shift.to(torch.int64) + _SUB_PAD, 0,
                        SIGNAL_SAMPLES + 2 * _SUB_PAD - NSIG)
    pos = start[:, None] + i                      # (R, NSIG) padded positions
    pad_i = F.pad(sig_i, (_SUB_PAD, _SUB_PAD))
    pad_q = F.pad(sig_q, (_SUB_PAD, _SUB_PAD))
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
    full_i = torch.zeros((R, SIGNAL_SAMPLES + 2 * _SUB_PAD), dtype=sig_i.dtype,
                         device=dev)
    full_q = torch.zeros_like(full_i)
    full_i.scatter_(1, pos, dr)
    full_q.scatter_(1, pos, di)
    return (sig_i - full_i[:, _SUB_PAD:_SUB_PAD + SIGNAL_SAMPLES],
            sig_q - full_q[:, _SUB_PAD:_SUB_PAD + SIGNAL_SAMPLES])



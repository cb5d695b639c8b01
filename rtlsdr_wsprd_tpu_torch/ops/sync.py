"""Fine sync and soft-symbol demodulation over candidate lanes.

The reference's sync_and_demodulate (wsprd/wsprd.c:101-259) is a
3-mode sequential matched filter. As in the JAX package (whose module
docstring derives it), all candidate lanes run at once and the
per-sample phasor factorizes into a per-lane part and a static tone
part; because the per-lane part is a pure exponential in the sample
index, the correlation at EVERY static lag/jitter offset reads one
derotated 512-sample double frame a symbol, and the leftover unit phase
vanishes under the magnitude.

``_tone_mags_offsets`` is that correlator's wrapper (modes 0 and 2).
For a CPU tensor it runs ``_tone_mags_offsets_plain``, one matmul pair

    (lanes*162, 512) @ (512, n_offsets*4)

against a static offset-shifted tone matrix, in float32 (TF32 off, see
device.py); for a CUDA tensor it launches ``csrc/correlator.cu``, which
derotates each double frame in registers and takes each offset's dot
product as the difference of two prefix sums over the frame (the unit
phase between them vanishes under the magnitude), or raises: there is
no fallback. Both replace ``rtlsdr_wsprd_tpu/ops/sync.py``
``_tone_mags_offsets``, an XLA program. Mode 1's 5-frequency search
(``_tone_mags`` over a (256, 20) product) stays a ``torch.matmul``.

The lane variants (``fine_sync_lanes``, ``soft_symbols_lanes``) serve
both batched decodes: the staged one compacts the valid candidates of a
window batch into lanes, the dense one (parallel/multichannel.py
``multichannel_decode_device``) runs every candidate slot of every
window as a lane. ``fine_sync`` and ``soft_symbols_jittered`` keep the
JAX package's one-window signatures (the per-window ``decode_window``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..buildlib import lazy_cuda_library
from ..config import DF, DT, NBITS, NSPERSYM, NSYM
from ..device import const, derived_const
from ..utils.channel import PR3_VECTOR
from .fano import NVCC_FLAGS

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


def _padded_signal(sig_i: torch.Tensor, sig_q: torch.Tensor):
    """One window's (N,) planes -> (N + 2*_PAD,), as ``_padded_signals``."""
    pi, pq = _padded_signals(sig_i[None], sig_q[None])
    return pi[0], pq[0]


def _candidate_windows(pi: torch.Tensor, pq: torch.Tensor,
                       shifts: torch.Tensor):
    """One window's padded planes, (C,) base shifts -> (C, WLEN) windows
    starting at shift - HALF_SPAN."""
    lane_w = torch.zeros_like(shifts, dtype=torch.int64)
    return _lane_windows(pi[None], pq[None], lane_w, shifts)


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


def _tone_mags_offsets_plain(wr: torch.Tensor, wi: torch.Tensor,
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


_SOURCE = Path(__file__).resolve().parent / "csrc" / "correlator.cu"
_vp, _ci = ctypes.c_void_p, ctypes.c_int


def _bind(lib) -> None:
    # tone_correlator(wr, wi, freq, drift, plan, L, n_slots, etone,
    #                 twopidt, n, out, stream)
    lib.tone_correlator.argtypes = [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _vp,
                                    ctypes.c_float, _ci, _vp, _vp]
    lib.tone_correlator.restype = _ci


_load_kernel = lazy_cuda_library("correlator", [_SOURCE], NVCC_FLAGS, _bind)


def build_kernel() -> str:
    """Build (if needed) and load ``csrc/correlator.cu``; returns its path."""
    return _load_kernel()._name


@lru_cache(maxsize=None)
def _correlator_plan(offsets: tuple) -> tuple[np.ndarray, int]:
    """The positions of the double frame (0..512) whose prefix sums the
    kernel keeps for absolute ``offsets``: o and o + 256, stored in
    ascending order, one slot each. Returns (int32 plan, slots): for
    each of a warp's 32 lanes (lane k sums positions 16k .. 16k + 15)
    the bit mask of its kept positions, then the slot of its first; the
    slot of position 512 (-1 if none reads it); then (o, slot of o,
    slot of o + 256) for each offset."""
    pos = sorted({o for o in offsets} | {o + NSPERSYM for o in offsets})
    slot = {p: i for i, p in enumerate(pos)}
    per = ULEN // 32
    masks, bases = [], []
    for k in range(32):
        kept = [m for m in range(per) if per * k + m in slot]
        masks.append(sum(1 << m for m in kept))
        bases.append(slot[per * k + kept[0]] if kept else 0)
    plan = masks + bases + [slot.get(ULEN, -1)]
    for o in offsets:
        plan += [o, slot[o], slot[o + NSPERSYM]]
    return np.asarray(plan, np.int32), len(pos)


def _prefix_tone_table() -> np.ndarray:
    """The kernel's phasors exp(-i w_t u) for u < 512 (E_TONE continued
    over the double frame), rounded from float64 as E_TONE is: float32
    (2, 512, 4), re then im; its first 256 rows are E_TONE's."""
    ang = TWOPIDT * DF * np.outer(np.arange(ULEN, dtype=np.float64), _t)
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)


def _tone_mags_offsets(wr: torch.Tensor, wi: torch.Tensor,
                       freq: torch.Tensor, drift: torch.Tensor,
                       offsets: tuple) -> torch.Tensor:
    """Tone magnitudes at every static window offset: (G, WLEN) windows,
    freq/drift (G,) -> (G, 162, L, 4). Offsets are absolute (relative
    lag/jitter + HALF_SPAN), in [0, 2*HALF_SPAN].

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/correlator.cu`` (``tone_correlator``) and count the launch in
    ``_tone_mags_offsets.launches``; any other device raises."""
    dev = wr.device
    if dev.type == "cpu":
        return _tone_mags_offsets_plain(wr, wi, freq, drift, offsets)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return tone_correlator(wr, wi, freq, drift, offsets)


def tone_correlator(wr: torch.Tensor, wi: torch.Tensor, freq: torch.Tensor,
                    drift: torch.Tensor, offsets: tuple) -> torch.Tensor:
    """``csrc/correlator.cu`` on CUDA tensors (``_tone_mags_offsets``'s
    arguments, each contiguous): one launch, counted in
    ``_tone_mags_offsets.launches``. Raises on anything the kernel does
    not take, and if the build or the launch fails."""
    dev = wr.device
    G = wr.shape[0] if wr.dim() == 2 else -1
    for name, t, shape in (("wr", wr, (G, WLEN)), ("wi", wi, (G, WLEN)),
                           ("freq", freq, (G,)), ("drift", drift, (G,))):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32{shape} on {dev}, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads the windows 16 bytes at a time
    for name, t in (("wr", wr), ("wi", wi)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    offs = tuple(int(o) for o in offsets)
    if not offs or not all(0 <= o <= 2 * HALF_SPAN for o in offs):
        raise ValueError(f"offsets must be 1 or more in [0, {2 * HALF_SPAN}], "
                         f"got {offsets}")
    lib = _load_kernel()
    L = len(offs)
    plan, n_slots = _correlator_plan(offs)
    plan_t = const(plan, dev)
    etone = derived_const(_prefix_tone_table, (), dev)
    out = torch.empty((G, NSYM, L, 4), dtype=torch.float32, device=dev)
    if G == 0:
        return out
    # launch in the tensors' device, whatever the calling thread's is
    with torch.cuda.device(dev):
        rc = lib.tone_correlator(
            wr.data_ptr(), wi.data_ptr(), freq.data_ptr(), drift.data_ptr(),
            plan_t.data_ptr(), L, n_slots, etone.data_ptr(),
            float(np.float32(TWOPIDT)), G, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"correlator kernel launch failed: CUDA error {rc}")
    _tone_mags_offsets.launches += 1
    return out


_tone_mags_offsets.launches = 0


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


def fine_sync(sig_i, sig_q, freq, shift, drift, lagstep: int = 8) -> FineSync:
    """``fine_sync_lanes`` for the C candidates of one window: sig_i/sig_q
    (N,) planar, freq/shift/drift (C,)."""
    pi, pq = _padded_signal(sig_i, sig_q)
    wr, wi = _candidate_windows(pi, pq, shift)
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


def soft_symbols_jittered(sig_i, sig_q, freq, shift, drift, iifac: int = 3,
                          quickmode: bool = False,
                          symfac: int = 50) -> JitteredSymbols:
    """``soft_symbols_lanes`` for the C candidates of one window
    (wsprd/wsprd.c:739-766 jitter loop; mode-2 body :219-256)."""
    pi, pq = _padded_signal(sig_i, sig_q)
    wr, wi = _candidate_windows(pi, pq, shift)
    return _soft_symbols_core(wr, wi, freq, drift, iifac, quickmode, symfac)

"""Synthetic WSPR signal generation (host, numpy, seedable).

Re-creates the reference self-test generator (rtlsdr_wsprd.c:729-789):
continuous-phase 4-FSK at 375 sps, tone spacing DF = 375/256 Hz, with
additive white Gaussian noise — plus SNR-calibrated window generation
for sensitivity sweeps (the reference only ships one 0 dB capture;
we can synthesize any SNR, drift, time offset, and multi-signal
overlap, which the subtraction tests need).
"""

from __future__ import annotations

import numpy as np

from ..config import DF, DT, NSPERSYM, NSYM, SIGNAL_SAMPLES
from ..utils.channel import get_wspr_channel_symbols
from ..utils.hashtable import WsprHashTable


def synth_wspr_baseband(
    symbols: np.ndarray,
    f0: float = 50.0,
    t0: float = 2.0,
    amp: float = 1.0,
    drift: float = 0.0,
    n_samples: int = SIGNAL_SAMPLES,
    phase0: float = 0.0,
) -> np.ndarray:
    """Synthesize one WSPR transmission as complex64 baseband.

    Mirrors the reference's synthesis loop (rtlsdr_wsprd.c:752-760):
    per-symbol frequency f0 + (sym - 1.5) * DF, phase accumulated
    continuously across symbol boundaries. ``drift`` adds the decoder's
    linear drift model (+/- drift/2 Hz over the transmission,
    wsprd/wsprd.c:156).
    """
    symbols = np.asarray(symbols)
    assert symbols.shape == (NSYM,)
    k = np.arange(NSYM, dtype=np.float64)
    # per-symbol carrier frequency (Hz)
    fsym = f0 + (drift / 2.0) * (k - NSYM / 2.0) / (NSYM / 2.0) + (symbols - 1.5) * DF
    dphi = 2.0 * np.pi * DT * fsym  # per-sample phase increment per symbol
    # continuous phase: repeat each symbol's increment NSPERSYM times
    incr = np.repeat(dphi, NSPERSYM)
    phi = phase0 + np.concatenate(([0.0], np.cumsum(incr)[:-1]))
    sig = amp * np.exp(1j * phi)

    out = np.zeros(n_samples, dtype=np.complex64)
    start = int(round(t0 / DT))
    src0 = max(0, -start)
    dst0 = max(0, start)
    length = min(sig.size - src0, n_samples - dst0)
    if length > 0:
        out[dst0 : dst0 + length] = sig[src0 : src0 + length]
    return out


def add_awgn(iq: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Add independent N(0, sigma^2) noise to I and Q."""
    noise = rng.normal(0.0, sigma, size=(iq.size, 2))
    return (iq + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)


def snr_to_amplitude(snr_db: float, sigma: float) -> float:
    """Tone amplitude for a target SNR in the WSPR-standard 2500 Hz
    reference bandwidth, given per-quadrature noise sigma at 375 sps.

    Noise density N0 = 2*sigma^2/375 (complex noise power 2 sigma^2
    across the 375 Hz Nyquist band); SNR_2500 = amp^2 / (N0 * 2500).
    """
    n0 = 2.0 * sigma * sigma / 375.0
    return float(np.sqrt(10.0 ** (snr_db / 10.0) * n0 * 2500.0))


def selftest_iq(
    message: str = "K1JT FN20QI 20",
    f0: float = 50.0,
    t0: float = 2.0,
    amp: float = 1.0,
    wgn: float = 0.02,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The reference decoder self-test stimulus (rtlsdr_wsprd.c:729-763):
    encode ``message``, synthesize at (f0, t0), add sigma=0.02 noise over
    the signal span only. Returns (i, q) float32."""
    ht = WsprHashTable()
    symbols = get_wspr_channel_symbols(message, ht)
    if symbols is None:
        raise ValueError(f"unencodable message: {message!r}")
    iq = synth_wspr_baseband(symbols, f0=f0, t0=t0, amp=amp)
    rng = np.random.default_rng(seed)
    start = int(round(t0 / DT))
    span = slice(start, start + NSYM * NSPERSYM)
    noise = rng.normal(0.0, wgn, size=(NSYM * NSPERSYM, 2))
    iq[span] += noise[:, 0] + 1j * noise[:, 1]
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


def synth_raw_2400k(
    symbols: np.ndarray,
    f0: float = 50.0,
    t0: float = 2.0,
    amp_counts: float = 20.0,
    noise_counts: float = 4.0,
    duration_s: float = 120.0,
    seed: int = 0,
    chunk_s: float = 10.0,
):
    """Synthesize a raw 2.4 Msps uint8 planar capture of one WSPR signal.

    Front-end convention (frontend/filters.py): the wanted band sits at
    -fs/4 in the raw spectrum (the reference tunes center = dial +
    600 kHz + 1500 Hz, rtlsdr_wsprd.c:1112), so a decoder-frame
    frequency ``f0`` maps to raw frequency f0 - 600 kHz. Yields
    (rawI_u8, rawQ_u8) chunks of ``chunk_s`` seconds (float64 phase
    accumulated across chunks; uint8 centered at 128 like the RTL ADC).
    """
    fs = 2_400_000
    symbols = np.asarray(symbols)
    assert symbols.shape == (NSYM,)
    sps = NSPERSYM * 6400  # raw samples per symbol
    total = int(round(duration_s * fs))
    start = int(round(t0 * fs))
    chunk = int(round(chunk_s * fs))

    rng = np.random.default_rng(seed)
    # per-raw-sample frequency is piecewise constant per symbol
    fsym = (f0 + (symbols - 1.5) * DF - fs / 4.0)  # Hz, per symbol
    dphi = 2.0 * np.pi * fsym / fs                  # rad/sample

    phase = 0.0
    pos = 0
    while pos < total:
        n = min(chunk, total - pos)
        idx = np.arange(pos, pos + n, dtype=np.int64)
        sym_idx = (idx - start) // sps
        in_sig = (sym_idx >= 0) & (sym_idx < NSYM)
        d = np.where(in_sig, dphi[np.clip(sym_idx, 0, NSYM - 1)], 0.0)
        ph = phase + np.concatenate(([0.0], np.cumsum(d[:-1])))
        phase = ph[-1] + d[-1]
        sig = np.where(in_sig, amp_counts, 0.0)
        i = sig * np.cos(ph) + rng.normal(0, noise_counts, n)
        q = sig * np.sin(ph) + rng.normal(0, noise_counts, n)
        rawI = np.clip(np.round(i) + 128.0, 0, 255).astype(np.uint8)
        rawQ = np.clip(np.round(q) + 128.0, 0, 255).astype(np.uint8)
        yield rawI, rawQ
        pos += n


def synth_window_at_snr(
    messages,
    snr_db,
    f0,
    t0=None,
    drift=None,
    sigma: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthesize a full 120 s window holding one or more WSPR signals at
    calibrated SNRs with full-window noise. Arguments may be scalars or
    per-signal sequences. Returns (i, q) float32 (not normalized; pass
    through iqio.normalize_minus3db or write/read an .iq file)."""
    if isinstance(messages, str):
        messages = [messages]
    k = len(messages)
    snr_db = np.broadcast_to(np.asarray(snr_db, dtype=np.float64), (k,))
    f0 = np.broadcast_to(np.asarray(f0, dtype=np.float64), (k,))
    t0 = np.broadcast_to(np.asarray(2.0 if t0 is None else t0, dtype=np.float64), (k,))
    drift = np.broadcast_to(np.asarray(0.0 if drift is None else drift, dtype=np.float64), (k,))

    rng = np.random.default_rng(seed)
    iq = np.zeros(SIGNAL_SAMPLES, dtype=np.complex64)
    ht = WsprHashTable()
    for m, s, f, t, d in zip(messages, snr_db, f0, t0, drift):
        symbols = get_wspr_channel_symbols(m, ht)
        if symbols is None:
            raise ValueError(f"unencodable message: {m!r}")
        amp = snr_to_amplitude(float(s), sigma)
        iq += synth_wspr_baseband(
            symbols, f0=float(f), t0=float(t), amp=amp, drift=float(d),
            phase0=float(rng.uniform(0, 2 * np.pi)),
        )
    iq = add_awgn(iq, sigma, rng)
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)

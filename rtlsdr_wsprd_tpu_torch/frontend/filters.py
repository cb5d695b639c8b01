"""Polyphase filter design for the two-stage 6400:1 decimator.

Pure numpy (no scipy): Kaiser-windowed sinc prototypes.

Stage 1 (2.4 Msps -> 30 ksps, R1=80): the alias bands that matter are
only those folding onto the final +/-~200 Hz, i.e. k*30 kHz +/- ~200 Hz,
so the transition band can be enormously wide (1 kHz -> 29.8 kHz) and
640 taps (8 per phase) give > 80 dB there. The fs/4 downmix — the
reference's byte-swizzle mixer, rtlsdr_wsprd.c:158-182 — is folded in
by rotating the coefficients: since R1 is a multiple of 4,

    y[m] = sum_k h[k] i^{-k} x[m R1 - k]          (i^{m R1} = 1)

so the mixer costs nothing at run time; the filter just becomes
complex.

Stage 2 (30 ksps -> 375 sps, R2=80): the sharp filter. Passband
+/-150 Hz (the decoder's noise/candidate band, wsprd/wsprd.c:564-573),
stopband from 225 Hz (= 375 - 150, where aliases fold in), 2400 taps
(30 per phase) at 30 ksps for > 85 dB rejection.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

FS_IN = 2_400_000       # rtlsdr_wsprd.c:39
R1 = 80                 # stage-1 decimation
FS_MID = FS_IN // R1    # 30_000
R2 = 80                 # stage-2 decimation
FS_OUT = FS_MID // R2   # 375

STAGE1_TAPS = 640       # 8 per phase
STAGE2_TAPS = 2400      # 30 per phase

# output-sample group delay: (T1-1)/2 input samples + (T2-1)/2 mid
# samples, expressed at 375 sps
GROUP_DELAY_375 = ((STAGE1_TAPS - 1) / 2) / 6400 + ((STAGE2_TAPS - 1) / 2) / 80


def kaiser_lowpass(numtaps: int, cutoff_hz: float, fs: float,
                   atten_db: float = 80.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, unity DC gain, float64."""
    if atten_db > 50.0:
        beta = 0.1102 * (atten_db - 8.7)
    elif atten_db >= 21.0:
        beta = 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    else:
        beta = 0.0
    n = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    fc = cutoff_hz / fs  # normalized (cycles/sample)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(numtaps, beta)
    return h / np.sum(h)


@lru_cache(maxsize=None)
def stage1_coeffs() -> np.ndarray:
    """Complex stage-1 coefficients h[k] * i^{-k}, complex64[640].

    Mixer convention: the received spectrum has the wanted band at
    -fs/4 (the reference tunes center = dial + 600 kHz + 1500 Hz,
    rtlsdr_wsprd.c:1112, so dial+1500 lands at -600 kHz); multiplying
    by i^n shifts it to DC.
    """
    h = kaiser_lowpass(STAGE1_TAPS, 1_000.0, FS_IN, atten_db=85.0)
    rot = np.exp(-0.5j * np.pi * np.arange(STAGE1_TAPS))  # i^{-k}
    return (h * rot).astype(np.complex64)


@lru_cache(maxsize=None)
def stage2_coeffs() -> np.ndarray:
    """Real stage-2 coefficients, float32[2000]."""
    h = kaiser_lowpass(STAGE2_TAPS, 187.5, FS_MID, atten_db=85.0)
    return h.astype(np.float32)


def combined_matrix(h_complex: np.ndarray) -> np.ndarray:
    """(T,) complex -> (2T, 2) float32 real matmul form.

    With X = [XI | XQ] (F, 2T) im2col'd input (correlation order:
    column k holds x[mR + k]),  X @ M = [yI | yQ] where
    y[m] = sum_k h[k] x[m R + k].
    """
    hr = np.real(h_complex).astype(np.float32)
    hi = np.imag(h_complex).astype(np.float32)
    top = np.stack([hr, hi], axis=1)      # XI rows: yI += XI hr, yQ += XI hi
    bot = np.stack([-hi, hr], axis=1)     # XQ rows: yI -= XQ hi, yQ += XQ hr
    return np.concatenate([top, bot], axis=0)  # (2T, 2)


def conv_order(h: np.ndarray) -> np.ndarray:
    """Flip coefficients so correlation-ordered im2col computes true
    convolution: y[m] = sum_k h[k] x[mR + T - 1 - k]."""
    return h[::-1].copy()

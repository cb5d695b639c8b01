"""The RTL front end in plain PyTorch: 2.4 Msps uint8 I/Q to 375 sps.

Two decimating FIR stages of 80 (rtlsdr_wsprd.c decimates 6400:1): a
640-tap Kaiser lowpass (1 kHz cutoff, 85 dB) whose taps are turned by
i^-k, which brings the band tuned to -fs/4 (the reference tunes dial +
600 kHz + 1,500 Hz, rtlsdr_wsprd.c:1112) to DC, then a 2,400-tap one
(187.5 Hz). Each output frame m is sum_k h[T-1-k] x[80 m + k]. The taps
are the deployment's float32 values; the arithmetic is float64, or
float32 where the caller asks (the control, whose products take TF32
inputs, ``precision``).

``steady_window`` is a channel's window once a replayed capture runs in
a loop: the stage-1 input starts with the capture's last 560 samples
and the stage-2 input with the last 2,320 mid-rate samples of the same
pass, as every round after the first sees them.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import mm

R = 80
T1, T2 = 640, 2400
FS_IN, FS_MID = 2_400_000, 30_000
OUT = 45_000


def kaiser_lowpass(numtaps: int, cutoff_hz: float, fs: float,
                   atten_db: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, unity DC gain, float64."""
    beta = 0.1102 * (atten_db - 8.7)
    n = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    fc = cutoff_hz / fs
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.kaiser(numtaps, beta)
    return h / np.sum(h)


def taps() -> tuple[np.ndarray, np.ndarray]:
    """(stage 1 complex64 (640,), stage 2 float32 (2400,)) in
    correlation order (reversed)."""
    h1 = kaiser_lowpass(T1, 1_000.0, FS_IN, 85.0)
    g1 = (h1 * np.exp(-0.5j * np.pi * np.arange(T1))).astype(np.complex64)
    g2 = kaiser_lowpass(T2, 187.5, FS_MID, 85.0).astype(np.float32)
    return g1[::-1].copy(), g2[::-1].copy()


def _fir(xi: torch.Tensor, xq: torch.Tensor, gr: torch.Tensor,
         gi: torch.Tensor | None, n: int):
    """n frames of sum_k g[k] x[80 m + k] over planar x (float, len >=
    80 (n - 1) + T); g complex (gr, gi) or real (gi None)."""
    tpp = gr.shape[0] // R
    fi = xi[:(n + tpp - 1) * R].reshape(n + tpp - 1, R)
    fq = xq[:(n + tpp - 1) * R].reshape(n + tpp - 1, R)
    yi = torch.zeros(n, dtype=xi.dtype, device=xi.device)
    yq = torch.zeros_like(yi)
    for t in range(tpp):
        a, b = fi[t:t + n], fq[t:t + n]
        hr = gr[t * R:(t + 1) * R]
        if gi is None:
            yi += mm(a, hr)
            yq += mm(b, hr)
        else:
            hi = gi[t * R:(t + 1) * R]
            yi += mm(a, hr) - mm(b, hi)
            yq += mm(a, hi) + mm(b, hr)
    return yi, yq


def steady_window(raw_i: torch.Tensor, raw_q: torch.Tensor,
                  dtype=torch.float64, chunk: int = 120_000):
    """One channel's 120 s capture (uint8 (288e6,) planes) -> its steady
    375 sps window, float32 planes normalized to a 0.5 peak."""
    dev = raw_i.device
    g1, g2 = taps()
    g1r = torch.as_tensor(g1.real.copy(), dtype=dtype, device=dev)
    g1i = torch.as_tensor(g1.imag.copy(), dtype=dtype, device=dev)
    g2r = torch.as_tensor(g2, dtype=dtype, device=dev)
    n = raw_i.shape[0]
    lead = T1 - R
    n_mid = n // R
    mid_i = torch.empty(n_mid, dtype=dtype, device=dev)
    mid_q = torch.empty_like(mid_i)
    for m0 in range(0, n_mid, chunk):
        m = min(chunk, n_mid - m0)
        s0 = m0 * R - lead  # stream index; the first chunk reaches back
        idx = torch.arange(s0, m0 * R + m * R, device=dev) % n
        xi = raw_i[idx].to(dtype) - 128.0
        xq = raw_q[idx].to(dtype) - 128.0
        mid_i[m0:m0 + m], mid_q[m0:m0 + m] = _fir(xi, xq, g1r, g1i, m)
    carry = T2 - R
    si = torch.cat([mid_i[-carry:], mid_i])
    sq = torch.cat([mid_q[-carry:], mid_q])
    oi, oq = _fir(si, sq, g2r, None, OUT)
    peak = torch.maximum(oi.abs().max(), oq.abs().max())
    scale = 0.5 / torch.clamp(peak, min=1e-24)
    return (oi * scale).to(torch.float32), (oq * scale).to(torch.float32)

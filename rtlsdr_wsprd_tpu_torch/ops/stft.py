"""STFT power spectrogram of a 2-minute WSPR window (planar I/Q).

The reference computes 347 sequential 512-point FFTs with a
quarter-symbol hop and a pseudo-Hann window, then fftshifts into a
power array ps[512][347] (wsprd/wsprd.c:496-553). As in the JAX
package, the DFT is four float32 matmuls against constant cos/sin
matrices whose column order folds in the fftshift; a leading batch
dimension rides the same matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FFT_SIZE, SIGNAL_SAMPLES
from ..device import const

# blocks = 4 * floor(samples / 512) - 1 (wsprd/wsprd.c:516)
BLOCKS = 4 * (SIGNAL_SAMPLES // FFT_SIZE) - 1  # = 347
HOP = FFT_SIZE // 4  # quarter-symbol hop = 128


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


def power_spectrogram(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """i, q: float32 (..., SIGNAL_SAMPLES) -> ps float32 (..., 512, BLOCKS).

    ps[j, b] is the power in fftshifted bin j (bin 256 = DC) of frame b
    (wsprd/wsprd.c:536-553); frame b starts at sample 128*b."""
    dev = i.device
    w, C, S = const(HANN, dev), const(DFT_COS, dev), const(DFT_SIN, dev)
    fr = _frames(i) * w
    fi = _frames(q) * w
    zr = fr @ C + fi @ S
    zi = fi @ C - fr @ S
    ps = zr * zr + zi * zi
    return ps.transpose(-1, -2)

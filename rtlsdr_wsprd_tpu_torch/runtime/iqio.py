"""Window normalization, copied from ``rtlsdr_wsprd_tpu/runtime/iqio.py``.

The decoder's soft-symbol RMS gate is amplitude-sensitive, so every
window is renormalized to a -3 dB peak (max |sample| = 0.5) before it
is decoded (rtlsdr_wsprd.c:574-589).
"""

from __future__ import annotations

import numpy as np


def normalize_minus3db(i: np.ndarray, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Scale so the largest |I| or |Q| equals 0.5 (rtlsdr_wsprd.c:574-589)."""
    max_sig = max(float(np.max(np.abs(i), initial=0.0)),
                  float(np.max(np.abs(q), initial=0.0)), 1e-24)
    scale = np.float32(0.5 / max_sig)
    return (i * scale).astype(np.float32), (q * scale).astype(np.float32)

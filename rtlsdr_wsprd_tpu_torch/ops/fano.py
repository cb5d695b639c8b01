"""Fano metric table for the WSPR K=32 r=1/2 code.

Copied from ``rtlsdr_wsprd_tpu/ops/fano.py`` (``_c_roundf``,
``build_mettab``). The FEC itself runs on the native sequential
decoder (native.py); a device Fano is not part of the port yet.
"""

from __future__ import annotations

import numpy as np

from ..utils.metric_tables import METRIC_TABLES


def _c_roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def build_mettab(bias: float = 0.45) -> np.ndarray:
    """Integer branch metric table (2, 256) int32 (wsprd/wsprd.c:467-473):
    mettab[0][i] = roundf(10*(metric_tables[2][i] - bias)), mettab[1]
    uses the reversed index."""
    t2 = np.asarray(METRIC_TABLES[2], dtype=np.float32)
    sub0 = (t2 - np.float32(bias)).astype(np.float32)
    sub1 = (t2[::-1] - np.float32(bias)).astype(np.float32)
    # C: roundf(10.0 * (float)(v - bias)) — the double product converts
    # to float32 at the roundf call boundary (e.g. -4.4999999 -> -4.5f
    # -> -5), so narrow before rounding.
    m0 = _c_roundf((10.0 * sub0.astype(np.float64)).astype(np.float32))
    m1 = _c_roundf((10.0 * sub1.astype(np.float64)).astype(np.float32))
    return np.stack([m0, m1]).astype(np.int32)

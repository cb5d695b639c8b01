"""The sequential Fano decoder of wsprd/fano.c in plain Python.

The K=32, rate-1/2 code's stack-free search (Phil Karn's ``fano()``,
wsprd/fano.c:87-221) over the 81 bits of a WSPR payload, with the
reference's integer branch metrics (wsprd/wsprd.c:467-473). It returns
what ``fano()`` returns: success, the 11 data bytes (the first 10 read
from every eighth node's encoder state, the 11th zero) and the cycle
count ``i + 1``.
"""

from __future__ import annotations

import numpy as np

from .constants import NBITS
from .metric_tables import METRIC_TABLES

POLY1 = 0xF2D05351
POLY2 = 0xE4613C47
TAIL = NBITS - 31  # first node of the all-zero tail


def _c_roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def build_mettab(bias: float = 0.45) -> np.ndarray:
    """(2, 256) int32: mettab[0][i] = roundf(10 * (table[2][i] - bias)),
    mettab[1] on the reversed index; the float32 difference is narrowed
    before the product is rounded, as the C's float arithmetic does."""
    t2 = np.asarray(METRIC_TABLES[2], dtype=np.float32)
    sub0 = (t2 - np.float32(bias)).astype(np.float32)
    sub1 = (t2[::-1] - np.float32(bias)).astype(np.float32)
    m0 = _c_roundf((10.0 * sub0.astype(np.float64)).astype(np.float32))
    m1 = _c_roundf((10.0 * sub1.astype(np.float64)).astype(np.float32))
    return np.stack([m0, m1]).astype(np.int32)


METTAB = build_mettab()


def _sym(state: int) -> int:
    return (((state & POLY1).bit_count() & 1) << 1) | (
        (state & POLY2).bit_count() & 1)


def fano(symbols: np.ndarray, delta: int = 60,
         maxcycles: int = 10000) -> tuple[bool, bytes, int]:
    """Decode 162 deinterleaved soft symbols (uint8); returns (success,
    data, cycles)."""
    m0t = METTAB[0].tolist()
    m1t = METTAB[1].tolist()
    s = [int(v) for v in symbols]
    met = []
    for n in range(NBITS):
        a, b = s[2 * n], s[2 * n + 1]
        met.append((m0t[a] + m0t[b], m0t[a] + m1t[b], m1t[a] + m0t[b],
                    m1t[a] + m1t[b]))
    gamma = [0] * (NBITS + 1)
    enc = [0] * (NBITS + 1)
    tm0 = [0] * (NBITS + 1)
    tm1 = [0] * (NBITS + 1)
    br = [0] * (NBITS + 1)
    b0, b1 = met[0][0], met[0][3]  # the root's 0-branch sends symbol 0
    if b0 > b1:
        tm0[0], tm1[0] = b0, b1
    else:
        tm0[0], tm1[0], enc[0] = b1, b0, 1
    t = 0
    pos = 0
    limit = maxcycles * NBITS
    i = 1
    while i <= limit:
        ngamma = gamma[pos] + (tm1[pos] if br[pos] else tm0[pos])
        if ngamma >= t:
            if gamma[pos] < t + delta:  # first visit: tighten
                while ngamma >= t + delta:
                    t += delta
            gamma[pos + 1] = ngamma
            state = (enc[pos] << 1) & 0xFFFFFFFF
            pos += 1
            if pos == NBITS:
                break
            lsym = _sym(state)
            m = met[pos]
            if pos >= TAIL:
                tm0[pos] = m[lsym]
            else:
                b0, b1 = m[lsym], m[3 ^ lsym]
                if b0 > b1:
                    tm0[pos], tm1[pos] = b0, b1
                else:
                    tm0[pos], tm1[pos] = b1, b0
                    state += 1
            enc[pos] = state
            br[pos] = 0
        else:
            while True:
                if pos == 0 or gamma[pos - 1] < t:
                    t -= delta
                    if br[pos]:
                        br[pos] = 0
                        enc[pos] ^= 1
                    break
                pos -= 1
                if pos < TAIL and br[pos] != 1:
                    br[pos] += 1
                    enc[pos] ^= 1
                    break
        i += 1
    data = bytes(enc[7 + 8 * k] & 0xFF for k in range(10)) + b"\0"
    return pos == NBITS and i < limit, data, i + 1

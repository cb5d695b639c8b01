"""IQ capture file IO, byte-compatible with the reference.

A copy of ``rtlsdr_wsprd_tpu/runtime/iqio.py``. Formats (rtlsdr_wsprd.c):

* ``.iq`` — raw interleaved float32 (I,Q) pairs at 375 sps; the Q
  channel is negated on BOTH read and write ("wsprsim convention",
  rtlsdr_wsprd.c:571,606). One 120 s window = 45,000 pairs = 360,000 B.
* ``.c2`` — a 14-byte name, an int32 type, a float64 dial frequency,
  then the same interleaved payload (rtlsdr_wsprd.c:620-667).

Both readers renormalize the window to a -3 dB peak (max |sample| =
0.5), which the decoder relies on because its soft-symbol RMS gate is
amplitude-sensitive (rtlsdr_wsprd.c:574-589).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..config import SIGNAL_SAMPLES


def normalize_minus3db(i: np.ndarray, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Scale so the largest |I| or |Q| equals 0.5 (rtlsdr_wsprd.c:574-589)."""
    max_sig = max(float(np.max(np.abs(i), initial=0.0)),
                  float(np.max(np.abs(q), initial=0.0)), 1e-24)
    scale = np.float32(0.5 / max_sig)
    return (i * scale).astype(np.float32), (q * scale).astype(np.float32)


def _planes(raw: np.ndarray, normalize: bool) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved float32 (I, -Q) pairs -> planar (i, q)."""
    n = raw.size // 2
    pairs = raw[: 2 * n].reshape(n, 2)
    i = pairs[:, 0].copy()
    q = -pairs[:, 1]  # wsprsim convention
    if normalize:
        i, q = normalize_minus3db(i, q)
    return i, q


def _interleaved(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    i = np.asarray(i, dtype=np.float32)
    q = np.asarray(q, dtype=np.float32)
    if not i.shape == q.shape == (SIGNAL_SAMPLES,):
        raise ValueError(f"writes are whole windows of {SIGNAL_SAMPLES} "
                         f"samples, got {i.shape} and {q.shape}")
    buf = np.empty(2 * SIGNAL_SAMPLES, dtype=np.float32)
    buf[0::2] = i
    buf[1::2] = -q  # wsprsim convention
    return buf


def read_iq_file(path: str | Path, normalize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Read a .iq capture -> (i, q) float32 arrays (rtlsdr_wsprd.c:555-592).

    Reads at most one window (45,000 samples), negates Q, and by default
    applies the -3 dB normalization the reference reader performs.
    """
    raw = np.fromfile(path, dtype=np.float32, count=2 * SIGNAL_SAMPLES)
    return _planes(raw, normalize)


def write_iq_file(i: np.ndarray, q: np.ndarray, path: str | Path) -> int:
    """Write a full window .iq capture (rtlsdr_wsprd.c:595-617)."""
    _interleaved(i, q).tofile(str(path))
    return SIGNAL_SAMPLES


def read_c2_file(path: str | Path, normalize: bool = True) -> tuple[np.ndarray, np.ndarray, float]:
    """Read a .c2 capture -> (i, q, dial_freq_hz) (rtlsdr_wsprd.c:620-667)."""
    with open(path, "rb") as fd:
        header = fd.read(14 + 4 + 8)
        if len(header) < 26:
            raise ValueError(f"{path}: a .c2 file has a 26-byte header")
        (freq,) = struct.unpack("<d", header[18:26])
        raw = np.fromfile(fd, dtype=np.float32, count=2 * SIGNAL_SAMPLES)
    i, q = _planes(raw, normalize)
    return i, q, freq


def write_c2_file(
    i: np.ndarray, q: np.ndarray, path: str | Path,
    dial_freq_hz: float, name: str = "", c2_type: int = 2,
) -> int:
    """Write a .c2 capture with the reference's 26-byte header."""
    buf = _interleaved(i, q)
    with open(path, "wb") as fd:
        fd.write(name.encode("ascii", "replace")[:14].ljust(14, b"\0"))
        fd.write(struct.pack("<i", c2_type))
        fd.write(struct.pack("<d", float(dial_freq_hz)))
        buf.tofile(fd)
    return SIGNAL_SAMPLES

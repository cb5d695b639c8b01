"""WSPR protocol constants and the reference decoder's options.

The values of wsprd/wsprd.c:59-66, wsprd/wsprd.h:39-52 and the tuning
constants of wsprd/wsprd.c:423-433, frozen here so that the plain
reference depends on nothing of the program it judges.
"""

from __future__ import annotations

from dataclasses import dataclass

SIGNAL_SAMPLES = 120 * 375       # one 120 s window at 375 sps
NBITS = 81                       # FEC payload bits
NSYM = 162                       # channel symbols
NSPERSYM = 256                   # samples per symbol
DF = 375.0 / 256.0               # tone spacing, Hz
DT = 1.0 / 375.0                 # sample period, s
FFT_SIZE = 512                   # STFT size
MAX_CANDIDATES = 200
MAX_UNIQUES = 100


@dataclass(frozen=True)
class Options:
    """The reference decoder's defaults (wsprd/wsprd.h:44-52,
    wsprd/wsprd.c:423-433)."""

    freq: int = 0
    quickmode: bool = False
    npasses: int = 2
    subtraction: bool = True
    minsync1: float = 0.10
    minsync2: float = 0.12
    iifac: int = 3
    symfac: int = 50
    maxdrift: int = 4
    delta: int = 60
    maxcycles: int = 10000
    fmin: float = -110.0
    fmax: float = 110.0

    @property
    def minrms(self) -> float:
        return 52.0 * (self.symfac / 64.0)

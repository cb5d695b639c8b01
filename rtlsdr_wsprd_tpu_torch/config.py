"""Configuration trees for the receiver and decoder.

The reference keeps these as mutable global structs
(rtlsdr_wsprd.c:75-117) with defaults in initrx_options /
initDecoder_options (:341-362); decoder tuning knobs are compile-time
constants (wsprd/wsprd.c:423-433). Here everything is an explicit frozen
dataclass, so a configuration is hashable and safe to share.

A copy of ``rtlsdr_wsprd_tpu/config.py``: the port keeps its own
constants so it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


# -- WSPR protocol constants (fixed by the protocol, not tunable) -----------

SIGNAL_LENGTH_S = 120            # seconds per window (wsprd/wsprd.c:59)
SIGNAL_SAMPLE_RATE = 375         # baseband rate, sps (wsprd/wsprd.c:60)
SIGNAL_SAMPLES = SIGNAL_LENGTH_S * SIGNAL_SAMPLE_RATE  # 45000
NBITS = 81                       # FEC payload bits (wsprd/wsprd.c:62)
NSYM = 162                       # channel symbols (wsprd/wsprd.c:63)
NSPERSYM = 256                   # samples per symbol (wsprd/wsprd.c:64)
DF = 375.0 / 256.0               # tone spacing, Hz (wsprd/wsprd.c:65)
DT = 1.0 / 375.0                 # sample period, s (wsprd/wsprd.c:66)
FFT_SIZE = 512                   # STFT size (wsprd/wsprd.h:39)
MAX_CANDIDATES = 200             # wsprd/wsprd.h:40
MAX_UNIQUES = 100                # wsprd/wsprd.h:41
SAMPLING_RATE = 2_400_000        # RTL front-end rate (rtlsdr_wsprd.c:39)
DOWNSAMPLING = SAMPLING_RATE // SIGNAL_SAMPLE_RATE  # 6400 (rtlsdr_wsprd.c:41)


@dataclass(frozen=True)
class DecoderOptions:
    """Decoder configuration (reference struct decoder_options,
    wsprd/wsprd.h:44-52, plus the tuning constants wsprd/wsprd.c:423-433
    promoted from compile-time to config)."""

    freq: int = 0                 # dial frequency, Hz
    rcall: str = ""               # reporter callsign
    rloc: str = ""                # reporter locator
    quickmode: bool = False       # fewer lags, single jitter attempt
    usehashtable: bool = False    # persist callsign hashtable
    npasses: int = 2              # decode passes (subtraction between)
    subtraction: bool = True      # subtract decoded signals

    # tuning constants (defaults = reference wsprd/wsprd.c:423-433)
    minsync1: float = 0.10        # gate after fine sync
    minsync2: float = 0.12        # gate before Fano
    iifac: int = 3                # jitter step in samples
    symfac: int = 50              # soft-symbol scale
    maxdrift: int = 4             # max +/- drift bins
    delta: int = 60               # Fano threshold step
    maxcycles: int = 10000        # Fano cycles-per-bit budget
    fmin: float = -110.0          # candidate band, Hz
    fmax: float = 110.0

    @property
    def minrms(self) -> float:
        # wsprd/wsprd.c:429 (integer division symfac/64 is intentional
        # float here: C writes 52.0*(symfac/64.0))
        return 52.0 * (self.symfac / 64.0)

    def with_(self, **kw) -> "DecoderOptions":
        return replace(self, **kw)


@dataclass(frozen=True)
class ReceiverOptions:
    """Receiver configuration (reference struct receiver_options,
    rtlsdr_wsprd.c:93-110, defaults :341-354)."""

    dialfreq: int = 0
    realfreq: int = 0
    gain: int = 290               # tenths of dB (29 dB default)
    autogain: bool = False
    ppm: int = 0
    shift: int = 0
    upconverter: int = 0
    directsampling: int = 0
    maxloop: int = 0
    device: int = 0
    noreport: bool = False
    selftest: bool = False
    writefile: bool = False
    readfile: bool = False
    filename: str = ""


# Band name -> dial frequency in Hz; HF bands and below imply direct
# sampling mode 2 (rtlsdr_wsprd.c:862-927).
BAND_TABLE: dict[str, tuple[int, int]] = {
    "lf":   (136_000, 2),
    "mf":   (474_200, 2),
    "160m": (1_836_600, 2),
    "80m":  (3_568_600, 2),
    "60m":  (5_287_200, 2),
    "40m":  (7_038_600, 2),
    "30m":  (10_138_700, 2),
    "20m":  (14_095_600, 2),
    "17m":  (18_104_600, 2),
    "15m":  (21_094_600, 2),
    "12m":  (24_924_600, 2),
    "10m":  (28_124_600, 2),
    "6m":   (50_293_000, 0),
    "4m":   (70_091_000, 0),
    "2m":   (144_489_000, 0),
    "1m25": (222_280_000, 0),
    "70cm": (432_300_000, 0),
    "23cm": (1_296_500_000, 0),
}

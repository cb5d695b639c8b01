"""Host-side helpers: synthetic signals and window normalization (numpy)."""

from .iqio import normalize_minus3db  # noqa: F401
from .synth import (  # noqa: F401
    selftest_iq,
    synth_raw_2400k,
    synth_wspr_baseband,
    synth_window_at_snr,
)

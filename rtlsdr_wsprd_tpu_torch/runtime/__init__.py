"""Host runtime: IQ file IO, synthetic signals, sources, reporting and
the two daemons.

Single-channel live daemon: ``scheduler.WsprDaemon`` (+ ``sources``);
many-channel integrated runtime: ``multidaemon.MultiChannelDaemon``
over a ``banks.RawBank``. Those modules are imported by name, so that
``import rtlsdr_wsprd_tpu_torch.runtime`` stays cheap."""

from .iqio import (  # noqa: F401
    normalize_minus3db,
    read_c2_file,
    read_iq_file,
    write_c2_file,
    write_iq_file,
)
from .synth import (  # noqa: F401
    add_awgn,
    selftest_iq,
    synth_raw_2400k,
    synth_wspr_baseband,
    synth_window_at_snr,
)

"""The attempts the device Fano hands to the host (hybrid FEC,
parallel/multichannel.py ``_fano_rounds``): the ``stragglers`` counts of
the program's ``fano_round`` records in the traced window, a
channel-window completed. Host FEC makes no such record."""

from ._record import counted, window


def read(trace):
    recs = window(trace)
    n = None if recs is None else counted(recs, "fano_round", "stragglers")
    return None if n is None else n / trace.windows

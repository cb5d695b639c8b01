"""The pipelined drivers' calling thread standing idle because the
decode lags it (parallel/multichannel.py
``decode_channels_pipelined_multidevice``, its wait on the oldest batch
in flight): self time of the program's ``await_batch`` spans on the
host clock, in ms a channel-window completed."""

from ._record import per_window_ms


def read(trace):
    return per_window_ms("await_batch", trace)

"""The upload of a host batch (parallel/multichannel.py
``_DeviceWindows``: the host-to-device copies of both planes and the
dequantize launch): self time of the program's ``upload`` spans on the
host clock, in ms a channel-window completed."""

from ._record import per_window_ms


def read(trace):
    return per_window_ms("upload", trace)

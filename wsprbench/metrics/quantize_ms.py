"""The quantize of a host batch to the link's format (parallel/
multichannel.py ``_DeviceWindows``, ``native.quantize_into`` of both
planes): self time of the program's ``quantize`` spans on the host
clock, in ms a channel-window completed."""

from ._record import per_window_ms


def read(trace):
    return per_window_ms("quantize", trace)

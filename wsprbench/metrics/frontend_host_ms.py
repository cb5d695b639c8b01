"""The host's side of the front end's fused step (frontend/decimate.py
``_fused_frontend_step``: its launches and allocations): self time of
the program's ``frontend_step`` spans on the host clock, in ms a
channel-window completed."""

from ._record import per_window_ms


def read(trace):
    return per_window_ms("frontend_step", trace)

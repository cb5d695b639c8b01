"""The kernel behind ``stft``: its share of its roofline, the least
time of every launch in the traced window (work.py's frozen counts at
the launch's shapes, against the card's published peaks) over the
kernel's device time, in percent."""


def read(trace):
    return trace.roofline_pct("stft")

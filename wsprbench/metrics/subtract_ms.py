"""The subtraction (ops/subtract.py): self time of the program's ``subtract``
range(s), summed over threads, in ms a channel-window completed."""

RANGES = ("subtract",)


def read(trace):
    t = trace.self_times()
    if trace.windows == 0 or not any(r in t for r in RANGES):
        return None
    return 1e3 * sum(t.get(r, 0.0) for r in RANGES) / trace.windows

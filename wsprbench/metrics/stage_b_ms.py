"""Stage B (ops/sync.py): self time of the program's ``stage_b_launch stage_b_wait``
range(s), summed over threads, in ms a channel-window completed."""

RANGES = ("stage_b_launch", "stage_b_wait")


def read(trace):
    t = trace.self_times()
    if trace.windows == 0 or not any(r in t for r in RANGES):
        return None
    return 1e3 * sum(t.get(r, 0.0) for r in RANGES) / trace.windows

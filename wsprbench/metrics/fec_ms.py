"""The FEC (ops/fano.py, ops/fano_hybrid.py, native.py): self time of the program's ``fec_device fec_host fec_host_finish``
range(s), summed over threads, in ms a channel-window completed."""

RANGES = ("fec_device", "fec_host", "fec_host_finish")


def read(trace):
    t = trace.self_times()
    if trace.windows == 0 or not any(r in t for r in RANGES):
        return None
    return 1e3 * sum(t.get(r, 0.0) for r in RANGES) / trace.windows

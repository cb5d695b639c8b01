"""The drivers' quantize and upload of a host batch (parallel/
multichannel.py ``prepare_windows``): self time of the harness's
``prepare_windows`` range on the host clock, in ms a channel-window
completed. Cells fed from the card's own windows read nothing."""

RANGES = ("prepare_windows",)


def read(trace):
    t = trace.self_times()
    if trace.windows == 0 or not any(r in t for r in RANGES):
        return None
    return 1e3 * sum(t.get(r, 0.0) for r in RANGES) / trace.windows

"""The rest of the drivers of parallel/multichannel.py (lane compaction,
queueing, the caller's loop): wall time of the traced window in which no
labelled range, ``prepare_windows`` included, runs on any thread, in ms
a channel-window completed."""


def read(trace):
    if trace.windows == 0:
        return None
    return 1e3 * (trace.window_s - trace.covered_s()) / trace.windows

"""One calling thread preparing every card's shard (parallel/
multichannel.py ``decode_channels_pipelined_multidevice``: each shard's
``prepare_windows``, its quantize and upload, inside a
``prepare_shard`` span on the calling thread): the wall time of those
spans inside the traced window over the window's seconds, in percent.
Near 100 the caller alone sets the pace."""

from ._record import inside, window


def read(trace):
    recs = window(trace)
    if recs is None:
        return None
    got = [inside(r, trace) for r in recs if r.name == "prepare_shard"]
    if not got or trace.window_s <= 0.0:
        return None
    return 100.0 * sum(got) / trace.window_s

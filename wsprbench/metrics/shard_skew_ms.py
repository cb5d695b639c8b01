"""The merge of a multi-card pull waiting on its slowest card
(parallel/multichannel.py ``decode_channels_pipelined_multidevice``,
one ``shard`` span a card's decode of its shard, on the worker): for
each batch merged in the traced window (its ``await_batch`` ends there)
with two or more ``shard`` records, the latest shard's end less the
earliest's, in ms, averaged over those batches."""

from collections import defaultdict

from ._record import process


def read(trace):
    recs = process()
    if recs is None or trace.windows == 0:
        return None
    merged = {r.batch for r in recs if r.name == "await_batch"
              and trace.t0 <= r.end <= trace.t1}
    ends = defaultdict(list)
    for r in recs:
        if r.name == "shard" and r.batch in merged:
            ends[r.batch].append(r.end)
    skews = [max(e) - min(e) for e in ends.values() if len(e) >= 2]
    return 1e3 * sum(skews) / len(skews) if skews else None

"""The share of the host's straggler decodes that succeed
(ops/fano_hybrid.py ``host_finish``): the ``decoded`` over the
``stragglers`` counts of the program's ``host_finish`` spans in the
traced window, in percent."""

from ._record import counted, window


def read(trace):
    recs = window(trace)
    if recs is None:
        return None
    tried = counted(recs, "host_finish", "stragglers")
    if not tried:
        return None
    return 100.0 * counted(recs, "host_finish", "decoded") / tried

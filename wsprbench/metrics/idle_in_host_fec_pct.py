"""The card waiting on the host's Fano: the share of the card's idle
time in the traced window (no kernel, copy or set on it) during which
one of the program's ``host_finish`` spans (ops/fano_hybrid.py) is open
on any thread, in percent. Read where the hybrid FEC ran
(``fano_round`` records in the window)."""

from ._record import inside, overlap_s, union, window


def read(trace):
    recs = window(trace)
    if recs is None or not any(r.name == "fano_round" for r in recs):
        return None
    busy = union((max(a, trace.t0), min(b, trace.t1))
                 for _, a, b, _ in trace.device)
    idle, end = [], trace.t0
    for a, b in busy:
        if a > end:
            idle.append([end, a])
        end = max(end, b)
    if trace.t1 > end:
        idle.append([end, trace.t1])
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0.0:
        return None
    fec = union((max(r.start, trace.t0), min(r.end, trace.t1))
                for r in recs if r.name == "host_finish"
                and inside(r, trace) > 0.0)
    return 100.0 * overlap_s(idle, fec) / idle_s

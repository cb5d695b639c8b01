"""What the readers of the program's own span record share
(rtlsdr_wsprd_tpu_torch/tracing.py ``records()``, on the host clock the
trace's window is on): the records of the traced window, or of the
whole process, and their time inside the window. A program without the
record, or whose ring overwrote records, reads nothing (None)."""

from collections import defaultdict


def _tracing():
    try:
        from rtlsdr_wsprd_tpu_torch import tracing
    except ImportError:
        return None
    return None if tracing.dropped() else tracing


def window(trace):
    """The records that overlap the traced window, or None."""
    tr = _tracing()
    if tr is None or trace.windows == 0:
        return None
    return tr.records(trace.t0, trace.t1)


def process():
    """Every record of the process (set-up included), or None."""
    tr = _tracing()
    return None if tr is None else tr.records()


def inside(r, trace) -> float:
    """Seconds of record ``r`` inside the traced window."""
    return max(0.0, min(r.end, trace.t1) - max(r.start, trace.t0))


def self_s(recs, name: str, trace):
    """Seconds of the ``name`` records inside the window, summed over
    threads, less what their nested records cover; None where the
    window holds none."""
    nested = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            nested[r.parent] += inside(r, trace)
    own = [inside(r, trace) - nested[r.id] for r in recs if r.name == name]
    return sum(own) if own else None


def process_self_s(name: str):
    """Wall seconds of every ``name`` record of the process, less what
    their nested records cover; None where there are none."""
    recs = process()
    if recs is None:
        return None
    nested = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            nested[r.parent] += r.wall_s
    own = [r.wall_s - nested[r.id] for r in recs if r.name == name]
    return sum(own) if own else None


def per_window_ms(name: str, trace):
    """Self ms of ``name`` a channel-window completed, or None."""
    recs = window(trace)
    s = None if recs is None else self_s(recs, name, trace)
    return None if s is None else 1e3 * s / trace.windows


def counted(recs, name: str, key: str):
    """The sum of count ``key`` over the ``name`` records; None where
    there are none."""
    got = [r.counts.get(key, 0) for r in recs if r.name == name]
    return sum(got) if got else None


def union(iv) -> list:
    """Sorted, disjoint cover of intervals (a, b)."""
    out: list = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_s(xs, ys) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total

"""How much of the quantize and upload of host batches runs on the CPU:
the thread's CPU time over the wall time of the program's ``quantize``
and ``upload`` spans that start in the traced window, in percent. Below
100 the feeding thread waits (the GIL, a lock, a blocking copy)."""

from ._record import window

NAMES = ("quantize", "upload")


def read(trace):
    recs = window(trace)
    if recs is None:
        return None
    got = [r for r in recs if r.name in NAMES and r.start >= trace.t0]
    wall = sum(r.wall_s for r in got)
    if wall <= 0.0:
        return None
    return 100.0 * sum(r.cpu_s for r in got) / wall

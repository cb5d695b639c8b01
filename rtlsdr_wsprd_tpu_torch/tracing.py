"""The port's span record: where the host's time goes, always on.

A span is a ``with`` block that stores one ``Record`` when it ends: its
name, the thread, the batch it worked for, the enclosing span on the
same thread, its start and end on ``time.perf_counter_ns`` (the clock
``time.perf_counter`` reads, onto which a ``torch.profiler`` trace of
the card can be laid by one marker kernel), the thread's CPU time at
both ends (``time.thread_time_ns``: the wall time less the CPU time is
time spent waiting, on the GIL, a lock or a blocking copy), and integer
counts::

    with tracing.span("host_finish", stragglers=k) as sp:
        ...
        sp.add(decoded=n)
    tracing.event("fano_round", attempts=a, stragglers=k)  # zero length

Records go into one bounded ring in memory (``CAPACITY``); when it is
full the oldest are overwritten and ``dropped()`` counts them. Read them
with ``records(t0, t1)``. There is no switch and no exporter: spans sit
at layer boundaries (a few dozen a batch) and cost about ten
microseconds each, so the record is always on.

Batches: ``new_batch_id()`` numbers a batch, and inside ``with
batch(n):`` every record the thread makes carries ``n``. The pipelined
drivers hold a batch's number on the calling thread while it pulls and
prepares the batch and on the worker thread that decodes it, so the
records of one batch share an id across threads.

``labelled(name)`` is a span that also opens ``torch.profiler``'s
``record_function`` of the same name while a profiler records; the
decode's eight layer ranges (parallel/multichannel.py
``record_function``) use it. Other spans open no profiler label.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import NamedTuple

# records the ring holds: a 51 s run of any benchmark cell and its
# set-up make under 10,000, the four-card farm's 8 workers included (a
# few hundred bytes a record)
CAPACITY = 1 << 16


class Record(NamedTuple):
    name: str
    thread: int            # threading.get_ident() of the recording thread
    batch: int | None      # the batch id held by the thread, if any
    id: int                # the span's own id (process-wide, from 0)
    parent: int | None     # id of the enclosing span on the same thread
    start_ns: int          # time.perf_counter_ns() at entry
    end_ns: int            # ... at exit (== start_ns for an event)
    cpu_start_ns: int      # time.thread_time_ns() at entry
    cpu_end_ns: int        # ... at exit
    counts: dict           # name -> int

    @property
    def start(self) -> float:
        """Entry on the ``time.perf_counter`` clock, in seconds."""
        return self.start_ns * 1e-9

    @property
    def end(self) -> float:
        return self.end_ns * 1e-9

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def cpu_s(self) -> float:
        return (self.cpu_end_ns - self.cpu_start_ns) * 1e-9


class Ring:
    """A bounded list of records: the newest ``capacity`` are kept."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._slots: list = [None] * capacity
        self._n = 0
        self._lock = threading.Lock()

    def append(self, rec: Record) -> None:
        with self._lock:
            self._slots[self._n % self.capacity] = rec
            self._n += 1

    def snapshot(self) -> list[Record]:
        """Every record held, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return self._slots[:n]
            k = n % cap
            return self._slots[k:] + self._slots[:k]

    def dropped(self) -> int:
        return max(0, self._n - self.capacity)


_RING = Ring()
_record = tuple.__new__  # Record(...) without NamedTuple's Python __new__
_ids = itertools.count()
_batch_ids = itertools.count()
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _profiler_on() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "batch", "t0", "c0",
                 "_label")

    def __init__(self, name: str, counts: dict, label: bool = False):
        self.name = name
        self.counts = counts
        self._label = label  # at entry: the profiler's range, or None

    def add(self, **counts: int) -> None:
        """Add to the span's counts (a new name starts at 0)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_ids)
        st.append(self.id)
        self.batch = getattr(_local, "batch", None)
        if self._label and _profiler_on():
            from torch.profiler import record_function
            self._label = record_function(self.name)
            self._label.__enter__()
        else:
            self._label = None
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        if self._label is not None:
            self._label.__exit__(*exc)
        _stack().pop()
        _RING.append(_record(Record, (
            self.name, threading.get_ident(), self.batch, self.id,
            self.parent, self.t0, t1, self.c0, c1, self.counts)))
        return False


def span(name: str, **counts: int) -> _Span:
    """A context manager that records ``name`` with ``counts`` (Python
    ints) when its block ends (an exception included); ``as sp`` gives
    ``sp.add``, which takes any integer."""
    return _Span(name, counts)


def labelled(name: str) -> _Span:
    """``span(name)`` that also opens ``torch.profiler.record_function``
    while a profiler records (a ``torch.profiler`` run sees the label)."""
    return _Span(name, {}, True)


def event(name: str, **counts: int) -> None:
    """A record of zero length, now, with ``counts`` (Python ints)."""
    st = _stack()
    t = time.perf_counter_ns()
    c = time.thread_time_ns()
    _RING.append(_record(Record, (
        name, threading.get_ident(), getattr(_local, "batch", None),
        next(_ids), st[-1] if st else None, t, t, c, c, counts)))


def new_batch_id() -> int:
    """The next batch number of the process."""
    return next(_batch_ids)


class batch:
    """``with batch(n):`` the calling thread's records carry batch ``n``
    (the previous number is restored at the end)."""

    __slots__ = ("n", "_prev")

    def __init__(self, n: int | None):
        self.n = n

    def __enter__(self):
        self._prev = getattr(_local, "batch", None)
        _local.batch = self.n
        return self

    def __exit__(self, *exc):
        _local.batch = self._prev
        return False


def records(t0: float | None = None, t1: float | None = None
            ) -> list[Record]:
    """The ring's records, oldest first (by their end); with ``t0`` /
    ``t1`` (``time.perf_counter`` seconds) only those that overlap
    [t0, t1] (an event: that lies in it)."""
    out = _RING.snapshot()
    if t0 is not None:
        lo = int(t0 * 1e9)
        out = [r for r in out if r.end_ns >= lo]
    if t1 is not None:
        hi = int(t1 * 1e9)
        out = [r for r in out if r.start_ns <= hi]
    return out


def dropped() -> int:
    """Records overwritten since the process started (0: none lost)."""
    return _RING.dropped()


__all__ = ["CAPACITY", "Record", "Ring", "span", "labelled", "event",
           "new_batch_id", "batch", "records", "dropped"]

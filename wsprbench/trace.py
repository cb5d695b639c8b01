"""What a traced run reads: the program's labelled host ranges, the
shapes of its kernel calls, and the card's activity.

* Host ranges: the program labels its layers with
  ``torch.profiler.record_function`` (parallel/multichannel.py). For the
  traced window the harness puts a recorder in that name's place, which
  keeps (name, thread, start, end) on the host clock and costs two clock
  reads a range; nested ranges count as self time. The drivers'
  ``prepare_windows`` (the quantize and the upload of a host batch,
  which the program does not label) is wrapped in a range of that name.
* Batches: each batch's pull to its yield (``batch_ms``), which the
  run's window keeps on the host clock.
* Kernel calls: the wrappers that launch ``stft.cu``, ``coarse.cu``,
  ``correlator.cu`` and ``polyphase_tc.cu`` are wrapped to note each
  launch's shapes, which the frozen counts of ``work.py`` price.
* The cards: ``torch.profiler`` with CUDA activity only (kernels,
  copies, sets) on every card of the cell, each event keeping its card's
  index; the profiler's one clock tied to the host's by one marker
  kernel launched after a synchronize of every card.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import work

KERNELS = {
    "stft": "stft_kernel",
    "coarse": "coarse_rows_kernel",
    "correlator": "correlator_kernel",
    "polyphase_tc": "polyphase_tc_kernel",
    "polyphase": "polyphase_kernel",
}


class _Span:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.spans.append((self.name, threading.get_ident(), self.t0,
                               time.perf_counter()))
        return False


class SpanRecorder:
    """Stands in for ``record_function``: ``SpanRecorder()(name)``."""

    def __init__(self):
        self.spans: list[tuple[str, int, float, float]] = []

    def __call__(self, name: str, *args, **kwargs):
        return _Span(self, name)


@dataclass
class Trace:
    card: str
    t0: float                      # the traced window, host clock
    t1: float
    windows: int                   # channel-windows completed in it
    spans: list = field(default_factory=list)
    calls: dict = field(default_factory=lambda: defaultdict(list))
    device: list = field(default_factory=list)   # (name, start, end, card)
    options_maxdrift: int = 4
    batch_ms: list = field(default_factory=list)  # pull to yield, a batch
    cards: int = 1                 # the cards the run uses

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    # ---- host ranges ----
    def self_times(self) -> dict[str, float]:
        """Seconds of each range name inside the window, summed over
        threads, less the part of each range its nested ranges cover."""
        by_tid = defaultdict(list)
        for name, tid, a, b in self.spans:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                by_tid[tid].append((a, b, name))
        out: dict[str, float] = defaultdict(float)
        for spans in by_tid.values():
            spans.sort(key=lambda s: (s[0], -s[1]))
            stack: list[list] = []
            for a, b, name in spans:
                while stack and stack[-1][1] <= a:
                    top = stack.pop()
                    out[top[2]] += top[3]
                if stack:
                    stack[-1][3] -= b - a
                stack.append([a, b, name, b - a])
            for top in stack:
                out[top[2]] += top[3]
        return dict(out)

    def covered_s(self) -> float:
        """Seconds of the window in which any range runs on any thread."""
        iv = sorted((max(a, self.t0), min(b, self.t1))
                    for _, _, a, b in self.spans)
        return _union(iv)

    def active_at(self, t: float) -> str:
        names = sorted({n for n, _, a, b in self.spans if a <= t < b})
        return "+".join(names) if names else "unlabelled"

    # ---- device ----
    def busy_s(self) -> float:
        """Seconds of the window in which an operation ran on a card,
        each card's own, averaged over the run's cards."""
        by_card = defaultdict(list)
        for _, a, b, c in self.device:
            by_card[c].append((max(a, self.t0), min(b, self.t1)))
        return sum(_union(sorted(iv)) for iv in by_card.values()) / self.cards

    def kernel_s(self, key: str) -> float:
        pat = re.compile(r"\b" + KERNELS[key] + r"\b")
        return sum(max(0.0, min(b, self.t1) - max(a, self.t0))
                   for n, a, b, _ in self.device if pat.search(n))

    def roofline_pct(self, key: str) -> float | None:
        """Sum of each launch's least time over the kernel's device time,
        in percent; None where the window launched none."""
        calls = self.calls.get(key)
        busy = self.kernel_s(key)
        if not calls or busy <= 0.0:
            return None
        fn = {"stft": work.stft_work, "coarse": work.coarse_work,
              "correlator": work.correlator_work,
              "polyphase_tc": work.polyphase_tc_work}[key]
        least = sum(work.roofline_ms(*fn(*shape), self.card)
                    for shape in calls) / 1e3
        return 100.0 * least / busy

    def breakdown(self) -> dict:
        """The device operations that took most time, summed over the
        cards, and the longest gaps in which no card was busy, by the
        host ranges open at their middle."""
        tot: dict[str, float] = defaultdict(float)
        for n, a, b, _ in self.device:
            tot[_short(n)] += max(0.0, min(b, self.t1) - max(a, self.t0))
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        iv = sorted((max(a, self.t0), min(b, self.t1))
                    for _, a, b, _ in self.device
                    if b > self.t0 and a < self.t1)
        gaps, end = [], self.t0
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.active_at(0.5 * (a + b)), b - a]
                              for a, b in gaps[:10]]}


def _union(iv) -> float:
    total, end = 0.0, float("-inf")
    for a, b in iv:
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _short(name: str) -> str:
    n = name.removeprefix("void ").split("(")[0].split("<")[0]
    return n[:64] or name[:64]


@contextlib.contextmanager
def instrument(trace: Trace, cuda: bool = True, devices=None):
    """Within the block: the program's ranges go to ``trace.spans``, its
    kernel wrappers note their shapes in ``trace.calls``, and (``cuda``)
    the profiler records the cards, tied to the host clock. ``devices``:
    the cards synchronized where the block opens and closes (None: the
    current one)."""
    from rtlsdr_wsprd_tpu_torch.frontend import decimate
    from rtlsdr_wsprd_tpu_torch.ops import coarse, stft, sync
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel

    rec = SpanRecorder()
    trace.spans = rec.spans
    calls = trace.calls
    saved = [(multichannel, "record_function"),
             (multichannel, "prepare_windows"), (stft, "power_rows"),
             (coarse, "coarse_rows"), (sync, "tone_correlator"),
             (decimate, "polyphase_decimate")]
    orig = {(m, a): getattr(m, a) for m, a in saved}

    def prepare_windows(*a, **kw):
        with rec("prepare_windows"):
            return orig[(multichannel, "prepare_windows")](*a, **kw)

    def power_rows(i, q):
        calls["stft"].append((int(i.shape[0]),))
        return orig[(stft, "power_rows")](i, q)

    def coarse_rows(ps, maxdrift):
        md = maxdrift if isinstance(maxdrift, int) else trace.options_maxdrift
        calls["coarse"].append((int(ps.shape[0]), int(md)))
        return orig[(coarse, "coarse_rows")](ps, maxdrift)

    def tone_correlator(wr, wi, freq, drift, offsets):
        calls["correlator"].append((int(wr.shape[0]), len(offsets)))
        return orig[(sync, "tone_correlator")](wr, wi, freq, drift, offsets)

    def polyphase_decimate(xI, xQ, filt, n_frames):
        if xI.dtype == torch.uint8:
            rows = int(xI.shape[0]) if xI.dim() == 2 else 1
            calls["polyphase_tc"].append((rows, int(xI.shape[-1]),
                                          int(n_frames)))
        return orig[(decimate, "polyphase_decimate")](xI, xQ, filt, n_frames)

    multichannel.record_function = rec
    multichannel.prepare_windows = prepare_windows
    stft.power_rows = power_rows
    coarse.coarse_rows = coarse_rows
    sync.tone_correlator = tone_correlator
    decimate.polyphase_decimate = polyphase_decimate

    def sync_cards():
        for d in devices or [None]:
            torch.cuda.synchronize(d)

    prof = None
    try:
        if cuda:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            sync_cards()
            mark = time.perf_counter()
            torch.cuda._sleep(1000)
        yield trace
    finally:
        if prof is not None:
            sync_cards()
            prof.__exit__(None, None, None)
        for (m, a), f in orig.items():
            setattr(m, a, f)
    if prof is not None:
        evs = [(e.name, e.time_range.start, e.time_range.end,
                e.device_index)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        spin = [s for n, s, _, _ in evs if "spin" in n or "sleep" in n]
        base = spin[0] if spin else min((s for _, s, _, _ in evs), default=0)
        trace.device = [(n, mark + (s - base) / 1e6, mark + (e - base) / 1e6,
                         c) for n, s, e, c in evs
                        if not ("spin" in n or "sleep" in n)]

"""The per-layer metrics read from the program's own span record
(rtlsdr_wsprd_tpu_torch/tracing.py): traced runs on the CPU that carry
them beside the harness's own metrics, the readers on records of known
times, their silence where the program has no record or lost records,
and (on a card) that a span lies where trace.py puts the card's work
it waited for."""

import importlib
import sys

import pytest
import torch

from wsprbench import run as R
from wsprbench.tests.test_wsprbench_harness import SEED, small_cell
from wsprbench.trace import Trace

from rtlsdr_wsprd_tpu_torch import tracing

OLD = ("batch_p95_ms", "driver_uncovered_ms", "stage_a_ms", "stage_b_ms",
       "fec_ms", "subtract_ms", "spots_ms", "device_idle_pct")


def _read(name, trace):
    return importlib.import_module(f"wsprbench.metrics.{name}").read(trace)


def test_traced_farm_line_carries_the_record_metrics():
    out = R.run(small_cell(), SEED + 21, 2.0, True, device="cpu",
                log=lambda *a: None)
    assert out["correct"] is True and tracing.dropped() == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in OLD + ("prepare_ms", "quantize_ms", "upload_ms",
                       "prepare_cpu_pct", "caller_wait_ms", "kernel_load_s"):
        assert m[name] >= 0, name
    assert m["quantize_ms"] > 0 and m["upload_ms"] > 0
    assert 0 < m["prepare_cpu_pct"] <= 100.5
    # the program's two spans lie inside the harness's range around
    # prepare_windows, and make up most of it
    assert 0.5 * m["prepare_ms"] < m["quantize_ms"] + m["upload_ms"] \
        <= m["prepare_ms"]
    # host FEC on the CPU: no hybrid rounds, so no straggler metrics;
    # the calibration is not measured without a card
    for name in ("fec_stragglers_per_window", "straggler_yield_pct",
                 "idle_in_host_fec_pct", "calibrate_s"):
        assert name not in m


def test_traced_chain_line_carries_the_front_end_span():
    torch.set_num_threads(4)
    cell = small_cell("chain.raw", windows=1, batch=1, check_windows=1)
    out = R.run(cell, SEED + 22, 8.0, True, device="cpu",
                log=lambda *a: None)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["frontend_host_ms"] > 0 and m["caller_wait_ms"] >= 0
    assert "quantize_ms" not in m and "prepare_ms" not in m
    assert all(name in m for name in OLD)


def _rec(name, a, b, k, parent=None, cpu=None, thread=1, **counts):
    c = int((b - a) * 1e9) if cpu is None else int(cpu * 1e9)
    return tracing.Record(name, thread, None, k, parent, int(a * 1e9),
                          int(b * 1e9), 0, c, counts)


@pytest.fixture
def recorded(monkeypatch):
    """Put records of known times in the program's ring."""
    def put(*recs, dropped=0):
        ring = tracing.Ring(max(len(recs), 1))
        for r in list(recs[:1]) * dropped + list(recs):  # first overwritten
            ring.append(r)
        monkeypatch.setattr(tracing, "_RING", ring)
    return put


def test_readers_on_known_records(recorded):
    tr = Trace(card="x", t0=10.0, t1=20.0, windows=100,
               device=[("k", 9.0, 11.0, 0), ("k", 12.0, 14.0, 0),
                       ("k", 13.0, 15.0, 0), ("k", 19.5, 21.0, 0)])
    recorded(
        _rec("kernel_load", 1.0, 1.5, 0, built=1),
        _rec("fec_calibrate", 2.0, 3.5, 1, budget=256, hybrid=1),
        _rec("kernel_load", 2.5, 2.75, 10, parent=1, built=0),
        _rec("quantize", 9.5, 10.5, 2, cpu=0.25),  # half in the window
        _rec("upload", 11.0, 12.0, 3, cpu=0.5),
        _rec("await_batch", 11.0, 13.0, 4, thread=1),
        _rec("frontend_step", 12.5, 13.0, 5, parent=4),  # nested in the wait
        _rec("fano_round", 15.0, 15.0, 6, stragglers=30, attempts=512),
        _rec("fano_round", 21.0, 21.0, 7, stragglers=99, attempts=512),
        _rec("host_finish", 14.5, 16.0, 8, thread=2, stragglers=30,
             decoded=3),
        _rec("host_finish", 15.5, 17.0, 9, thread=3, stragglers=10,
             decoded=1))
    assert _read("quantize_ms", tr) == pytest.approx(1e3 * 0.5 / 100)
    assert _read("upload_ms", tr) == pytest.approx(1e3 * 1.0 / 100)
    # only the upload starts inside the window
    assert _read("prepare_cpu_pct", tr) == pytest.approx(50.0)
    assert _read("caller_wait_ms", tr) == pytest.approx(1e3 * 1.5 / 100)
    assert _read("frontend_host_ms", tr) == pytest.approx(1e3 * 0.5 / 100)
    assert _read("fec_stragglers_per_window", tr) == pytest.approx(0.3)
    assert _read("straggler_yield_pct", tr) == pytest.approx(100 * 4 / 40)
    # idle: 11-12, 15-19.5 (5.5 s); host_finish open 15-17 of it
    assert _read("idle_in_host_fec_pct", tr) == pytest.approx(
        100 * 2.0 / 5.5)
    # the load nested in the calibration counts as a load only
    assert _read("calibrate_s", tr) == pytest.approx(1.25)
    assert _read("kernel_load_s", tr) == pytest.approx(0.75)


def test_readers_are_silent_without_their_records(recorded, monkeypatch):
    tr = Trace(card="x", t0=10.0, t1=20.0, windows=100)
    names = ("quantize_ms", "upload_ms", "prepare_cpu_pct", "caller_wait_ms",
             "fec_stragglers_per_window", "straggler_yield_pct",
             "idle_in_host_fec_pct", "frontend_host_ms", "calibrate_s",
             "kernel_load_s")
    recorded()
    assert all(_read(n, tr) is None for n in names)
    # a ring that overwrote records reads nothing
    recorded(_rec("quantize", 11.0, 12.0, 0), _rec("kernel_load", 1, 2, 1),
             _rec("fano_round", 12, 12, 2, stragglers=1), dropped=1)
    assert all(_read(n, tr) is None for n in names)
    # a program without the record (an older checkout of the port) reads
    # nothing, and raises nothing
    monkeypatch.setitem(sys.modules, "rtlsdr_wsprd_tpu_torch.tracing", None)
    assert all(_read(n, tr) is None for n in names)


def _probe(card, kept):
    """One traced window holding a span around a ~10 ms sleep kernel and
    a synchronize: (lead, tail) in microseconds, the mapped kernel's
    start less the span's and the span's end less the kernel's, with
    the kernel's and the span's lengths."""
    from wsprbench.trace import instrument
    x = torch.empty(1 << 22, device=card)
    tr = Trace(card=torch.cuda.get_device_name(card), t0=0.0, t1=0.0,
               windows=0)
    with instrument(tr):
        x.fill_(1.0)  # a kernel trace.py keeps: its mapping is read off it
        torch.cuda.synchronize(card)
        with tracing.span("probe"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(card)
    rec = [r for r in tracing.records() if r.name == "probe"][-1]
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in kept[-1].events() if e.device_type == cuda]
    fill = next(d for d in tr.device if "fill" in d[0] or "elementwise"
                in d[0])
    raw = next(s for n, s, _ in evs if n == fill[0])
    offset = fill[1] - raw / 1e6  # trace.py's map: host = offset + us/1e6
    sleeps = [(s, e) for n, s, e in evs if "spin" in n or "sleep" in n]
    s, e = sleeps[-1]  # the first is trace.py's marker
    a, b = offset + s / 1e6, offset + e / 1e6
    return 1e6 * (a - rec.start), 1e6 * (rec.end - b), b - a, rec.wall_s


@pytest.mark.cuda
def test_a_span_holds_the_card_work_it_waited_for(card, monkeypatch):
    """A span around ``torch.cuda._sleep`` and a synchronize holds the
    sleep kernel's interval as trace.py maps the card's clock onto the
    host's by its marker kernel: the record and the trace share one host
    clock. The map is early by the marker's launch latency: in a
    process's first traced window that includes loading the sleep
    kernel's module (under a millisecond), afterwards tens of
    microseconds. Prints both."""
    kept = []
    real = torch.profiler.profile

    class Keep(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    monkeypatch.setattr(torch.profiler, "profile", Keep)
    cold = _probe(card, kept)
    warm = _probe(card, kept)
    for name, (lead, tail, sleep_s, span_s) in (("cold", cold),
                                                ("warm", warm)):
        print(f"clock check on {torch.cuda.get_device_name(card)}, {name} "
              f"marker: sleep {1e3 * sleep_s:.3f} ms, span "
              f"{1e3 * span_s:.3f} ms, lead {lead:.1f} us, tail "
              f"{tail:.1f} us")
        assert 1e-3 < sleep_s < span_s
    assert -2000.0 < cold[0] < 200.0 and 0.0 < cold[1] < 2500.0
    assert -100.0 < warm[0] < 200.0 and 0.0 < warm[1] < 500.0

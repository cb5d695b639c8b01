"""The port's span record (rtlsdr_wsprd_tpu_torch/tracing.py): the ring
(bound, overwrite, parent links, counts, batch ids), the spans the
program records (quantize, upload, the caller's wait, the FEC's rounds
and stragglers, the front end, the calibration, the library loads), the
batch id carried across the pipelined driver's threads, and that a
benchmark's tracer, which takes the place of the decode's layer ranges,
sees none of the new spans."""

import logging
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu_torch import buildlib, tracing
from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import CPU, REPO, windows3

QUICK = DecoderOptions(quickmode=True)
# the decode's layer ranges, which go through multichannel.record_function
LAYER_RANGES = {"stage_a", "stage_b_launch", "stage_b_wait", "fec_host",
                "fec_device", "fec_host_finish", "spots", "subtract",
                "dense_step"}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of the default capacity for the test's records."""
    r = tracing.Ring()
    monkeypatch.setattr(tracing, "_RING", r)
    return r


@pytest.fixture(scope="module")
def wins():
    return windows3()


def _hard(message):
    from rtlsdr_wsprd_tpu_torch.utils.channel import (
        INTERLEAVE_PERM, get_wspr_channel_symbols)
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable
    chan = np.asarray(get_wspr_channel_symbols(message, WsprHashTable()))
    soft = np.where(chan >= 2, 255, 0).astype(np.uint8)
    return soft[np.asarray(INTERLEAVE_PERM)]


# ---- the ring


def test_ring_bound_overwrite_and_dropped(monkeypatch):
    r = tracing.Ring(4)
    monkeypatch.setattr(tracing, "_RING", r)
    for k in range(3):
        tracing.event("e", k=k)
    assert [x.counts["k"] for x in tracing.records()] == [0, 1, 2]
    assert tracing.dropped() == 0
    for k in range(3, 10):
        tracing.event("e", k=k)
    # the newest four, oldest first; six overwritten
    assert [x.counts["k"] for x in tracing.records()] == [6, 7, 8, 9]
    assert tracing.dropped() == 6
    assert tracing.CAPACITY >= 1 << 16


def test_ring_under_many_threads(monkeypatch):
    """More threads than cores record at once with the interpreter
    switching threads as often as it can: no record is lost from the
    count, none is held twice, and each thread's parent links stay its
    own."""
    cap, threads, n = 500, 32, 200
    monkeypatch.setattr(tracing, "_RING", tracing.Ring(cap))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with tracing.span("outer"):
                    tracing.event("inner")
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    got = tracing.records()
    assert len(got) == cap
    assert tracing.dropped() == 2 * threads * n - cap
    assert len({r.id for r in got}) == cap
    outer = {r.id: r.thread for r in got if r.name == "outer"}
    for r in got:
        if r.name == "inner" and r.parent in outer:
            assert outer[r.parent] == r.thread
        if r.name == "outer":
            assert r.parent is None


def test_span_parents_counts_and_clocks(ring):
    with tracing.span("outer", a=1) as outer:
        with tracing.span("inner", b=2) as inner:
            inner.add(b=np.int64(3), c=True)
            time.sleep(0.01)
        tracing.event("tick", n=5)
        outer.add(a=1)
    recs = {r.name: r for r in tracing.records()}
    assert [r.name for r in tracing.records()] == ["inner", "tick", "outer"]
    o, i, t = recs["outer"], recs["inner"], recs["tick"]
    assert o.parent is None and i.parent == o.id and t.parent == o.id
    assert o.counts == {"a": 2} and i.counts == {"b": 5, "c": 1}
    assert all(type(v) is int for v in i.counts.values())
    assert t.counts == {"n": 5} and t.start_ns == t.end_ns
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert i.wall_s >= 0.01 and i.cpu_s < i.wall_s  # the sleep waits
    assert i.thread == o.thread == threading.get_ident()
    # the clock is time.perf_counter's
    now = time.perf_counter()
    assert abs(o.end - now) < 1.0 and o.start <= o.end


def test_span_records_when_its_block_raises(ring):
    with pytest.raises(ValueError):
        with tracing.span("boom", k=1):
            raise ValueError("x")
    with tracing.span("after"):
        pass
    got = tracing.records()
    assert [r.name for r in got] == ["boom", "after"]
    assert got[1].parent is None  # the stack was unwound


def test_records_window_and_batch_ids(ring):
    with tracing.span("early"):
        pass
    t0 = time.perf_counter()
    n = tracing.new_batch_id()
    assert tracing.new_batch_id() == n + 1
    with tracing.batch(n):
        with tracing.span("in_batch"):
            with tracing.batch(n + 1):
                tracing.event("nested_batch")
            tracing.event("restored")
    tracing.event("outside")
    t1 = time.perf_counter()
    time.sleep(0.002)
    tracing.event("late")
    got = {r.name: r.batch for r in tracing.records(t0, t1)}
    assert got == {"in_batch": n, "nested_batch": n + 1, "restored": n,
                   "outside": None}


def test_batch_ids_are_per_thread(ring):
    seen = {}

    def work(k):
        with tracing.batch(k):
            time.sleep(0.005)
            with tracing.span("w"):
                seen[k] = threading.get_ident()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = {r.batch: r.thread for r in tracing.records()}
    assert got == seen


def test_labelled_opens_the_profiler_label_and_span_does_not(ring):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.labelled("layer_range"):
            torch.ones(4).sum()
        with tracing.span("plain_span"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "layer_range" in names and "plain_span" not in names
    assert {r.name for r in tracing.records()} == {"layer_range",
                                                   "plain_span"}
    assert pmc.record_function is tracing.labelled


# ---- the program's spans


def test_quantize_and_upload_spans(ring, wins):
    wi, wq = wins
    pmc.native.build()  # loaded before: its kernel_load is not counted
    tracing._RING = tracing.Ring()
    dw = pmc.prepare_windows(wi, wq, device_batch=2, device=CPU)
    got = {r.name: r for r in tracing.records()}
    assert set(got) == {"quantize", "upload"}
    assert got["quantize"].counts == {"windows": 3,
                                      "bytes_in": 2 * 3 * 45000 * 4,
                                      "vector": 2 * (3 * 45000 - 8)}
    assert got["upload"].counts == {"bytes": 2 * dw.n_pad * 45000}
    assert got["quantize"].end_ns <= got["upload"].start_ns
    tracing._RING = tracing.Ring()
    pmc.prepare_windows(wi, wq, device_batch=2, transfer_dtype="float32",
                        device=CPU)
    (only,) = tracing.records()
    assert only.name == "upload"
    assert only.counts == {"bytes": 2 * 4 * 45000 * 4}


def _fano_case(J=6, G=5, seed=31):
    rng = np.random.default_rng(seed)
    good = _hard("K1JT FN20 37")
    noisy = np.clip(good.astype(int) + rng.normal(0, 60, 162), 0,
                    255).astype(np.uint8)
    deint = rng.integers(0, 256, (J, G, 162)).astype(np.uint8)
    gate = rng.random((J, G)) < 0.6
    deint[1, 0], gate[1, 0] = good, True
    deint[4, 0], gate[4, 0] = noisy, True
    deint[3, 2], gate[3, 2] = noisy, True
    deint[:, 3], gate[:, 3] = good, True
    gate[:, 4] = False
    return gate, deint


def test_fano_round_and_host_finish_count_the_handed_stragglers(
        ring, monkeypatch):
    """At device budget 4 most attempts run out: each round's
    ``fano_round.stragglers`` and each ``host_finish.stragglers`` equal
    the attempts handed to ``host_finish``, and ``decoded`` its
    successes."""
    gate, deint = _fano_case()
    handed, masks = [], []
    real_finish, real_mask = pmc.host_finish, pmc.pending_mask

    def finish(syms, succ, data, cycles, pend, delta, maxcycles):
        out = real_finish(syms, succ, data, cycles, pend, delta, maxcycles)
        handed.append((int(pend.sum()), int((out[0] & pend).sum()),
                       int(out[2][pend].astype(np.int64).sum())))
        return out

    def mask(*a):
        m = real_mask(*a)
        masks.append(int(m.sum()))
        return m

    monkeypatch.setattr(pmc, "host_finish", finish)
    monkeypatch.setattr(pmc, "pending_mask", mask)
    pmc._fano_rounds(gate, deint, 60, 4, 10000, torch.device(CPU))
    rounds = [r for r in tracing.records() if r.name == "fano_round"]
    finishes = [r for r in tracing.records() if r.name == "host_finish"]
    assert len(rounds) == len(masks) >= 1
    assert sum(h[0] for h in handed) > 0
    assert [r.counts["stragglers"] for r in rounds if r.counts[
        "stragglers"]] == [h[0] for h in handed]
    assert [r.counts["stragglers"] for r in finishes] == \
        [h[0] for h in handed]
    assert [r.counts["decoded"] for r in finishes] == [h[1] for h in handed]
    assert [r.counts["cycles"] for r in finishes] == [h[2] for h in handed]
    # what pending_mask flagged, less the attempts a lane's earlier
    # success in the same call made moot
    assert all(r.counts["stragglers"] <= m for r, m in zip(rounds, masks))
    assert sum(r.counts["attempts"] for r in rounds) == int(gate.sum())


def test_host_finish_records_nothing_without_stragglers(ring):
    from rtlsdr_wsprd_tpu_torch.ops.fano_hybrid import host_finish
    z = np.zeros(3, bool)
    host_finish(np.zeros((3, 162), np.uint8), z, np.zeros((3, 11), np.uint8),
                np.zeros(3, np.uint32), z, 60, 10000)
    assert tracing.records() == []


@pytest.mark.parametrize("mode", ["hybrid", "host"])
def test_fec_rounds_read_no_clock_without_debug(mode, ring, monkeypatch,
                                                caplog):
    """The FEC rounds read the clock and reduce their debug numbers only
    when DEBUG is on; the phase marks stay."""
    gate, deint = _fano_case()

    def run():
        if mode == "hybrid":
            return pmc._fano_rounds(gate, deint, 60, 4, 10000,
                                    torch.device(CPU))
        G = gate.shape[1]
        M = pmc.PREFETCH_ATTEMPTS
        pre_j = np.full((G, M), gate.shape[0], np.int32)
        pre_syms = np.zeros((G, M, 162), np.uint8)
        return pmc._fano_rounds_host_prefetch(
            gate, pre_j, pre_syms,
            lambda lanes: deint[:, lanes].transpose(1, 0, 2), 60, 10000)

    want = run()
    reads = []
    real = time.perf_counter

    def counting():
        reads.append(1)
        return real()

    monkeypatch.setattr(pmc.time, "perf_counter", counting)
    caplog.set_level(logging.INFO, logger=pmc._LOG.name)
    assert run() == want and reads == []
    caplog.set_level(logging.DEBUG, logger=pmc._LOG.name)
    assert run() == want and reads
    text = caplog.text
    if mode == "hybrid":
        assert "host-finishing" in text and "fano round:" in text
    else:
        assert "fano host:" in text


def test_dense_finish_records_its_round(ring):
    B, K = 2, 3
    out = pmc.ChannelDecode(
        snr=None, valid=None, freq=None, shift=None, sync=None, drift=None,
        sel_cand=None, sel_jit=None,
        sel_valid=np.array([[1, 1, 0], [1, 0, 0]], bool),
        success=np.zeros((B, K), bool),
        data=np.zeros((B, K, 11), np.uint8),
        cycles=np.full((B, K), 16 * 81 + 2, np.uint32),
        deint=np.zeros((B, K, 162), np.uint8), n_gate=None)
    pmc._finish_stragglers(out, QUICK, CPU)
    rounds = [r for r in tracing.records() if r.name == "fano_round"]
    fin = [r for r in tracing.records() if r.name == "host_finish"]
    assert [r.counts for r in rounds] == [{"attempts": 3, "stragglers": 3}]
    # all-zero soft symbols are the all-zero message's: each decodes
    assert fin[0].counts["stragglers"] == 3 and fin[0].counts["decoded"] == 3


def test_frontend_step_span(ring):
    from rtlsdr_wsprd_tpu_torch.frontend import decimate
    from rtlsdr_wsprd_tpu_torch.frontend.filters import (
        R1, R2, STAGE1_TAPS, STAGE2_TAPS)
    C, n_mid = 2, 2 * R2
    raw = torch.full((C, n_mid * R1 + STAGE1_TAPS - R1), 128,
                     dtype=torch.uint8)
    m2 = torch.zeros((C, STAGE2_TAPS - R2))
    decimate._fused_frontend_step(raw, raw, m2, m2, n_mid)
    (r,) = tracing.records()
    assert r.name == "frontend_step"
    assert r.counts == {"channels": C, "frames": n_mid}


def test_calibration_span_records_its_pick(ring, monkeypatch):
    from rtlsdr_wsprd_tpu_torch.ops import calibrate
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC", raising=False)
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", raising=False)
    monkeypatch.setattr(calibrate, "_cuda_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(calibrate, "measure_native_fano_ms",
                        lambda: (0.05, 12.0))
    for cyc_ms, mode, budget in ((0.12, "hybrid", 64), (2.0, "host", 16)):
        tracing._RING = tracing.Ring()
        monkeypatch.setattr(calibrate, "measure_device_fano_cycle_ms",
                            lambda device=None, _c=cyc_ms: _c)
        cal = calibrate._calibrate(None)
        assert (cal.mode, cal.device_maxcycles) == (mode, budget)
        (r,) = tracing.records()
        assert r.name == "fec_calibrate"
        assert r.counts == {"budget": budget, "hybrid": int(mode == "hybrid")}
    # the env and default branches measure nothing and record nothing
    tracing._RING = tracing.Ring()
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    calibrate._calibrate(None)
    assert tracing.records() == []


def test_library_load_span(ring, monkeypatch, tmp_path):
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(buildlib, "BUILD_DIR", tmp_path / "_build")
    flags = ["-O1", "-fPIC", "-shared"]
    lib = buildlib.load_library("one", "g++", [src], flags)
    again = buildlib.load_library("one", "g++", [src], flags)
    assert lib.one() == again.one() == 1
    assert [(r.name, r.counts) for r in tracing.records()] == [
        ("kernel_load", {"built": 1}), ("kernel_load", {"built": 0})]
    assert buildlib.library_path("one", "g++", [src], flags).exists()


# ---- across the pipelined driver's threads


@pytest.fixture
def tiny_budget(monkeypatch):
    """The hybrid FEC's device budget pinned at 1 cycle a bit, so that
    real decodes become stragglers of the host."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "1")
    calibrate._CACHE.clear()
    yield
    calibrate._CACHE.clear()


def test_batch_id_spans_caller_and_worker(ring, wins, tiny_budget):
    """Each batch's quantize and upload (the calling thread), its wait
    (the calling thread) and its decode's FEC records (a worker thread)
    carry one batch id, distinct a batch."""
    wi, wq = wins
    batches = [(wi, wq), (wi[:2], wq[:2]), (wi, wq)]
    out = list(pmc.decode_channels_pipelined(
        batches, QUICK, device_batch=3, device=CPU, fec="hybrid"))
    assert len(out) == 3
    recs = tracing.records()
    caller = threading.get_ident()
    by = {}
    for r in recs:
        by.setdefault(r.batch, []).append(r)
    ids = sorted(k for k in by if k is not None)
    assert len(ids) == 3 and None not in by
    for k, n in zip(ids, (3, 2, 3)):
        names = Counter(r.name for r in by[k])
        assert names["quantize"] == names["upload"] == 1
        assert names["await_batch"] == 1
        assert names["fano_round"] >= 1 and names["stage_a"] >= 1
        q = next(r for r in by[k] if r.name == "quantize")
        w = next(r for r in by[k] if r.name == "await_batch")
        assert q.thread == w.thread == caller
        assert q.counts["windows"] == n and w.counts["windows"] == n
        worker = {r.thread for r in by[k] if r.name in ("fano_round",
                                                        "stage_a")}
        assert worker and caller not in worker
    fin = [r for r in recs if r.name == "host_finish"]
    assert fin and all(r.batch in ids and r.thread != caller for r in fin)
    assert sum(r.counts["decoded"] for r in fin) >= 3  # the real decodes
    # the stragglers handed over are the ones the host took up
    assert sum(r.counts["stragglers"] for r in recs
               if r.name == "fano_round") == \
        sum(r.counts["stragglers"] for r in fin)


def _shard_spans(recs, caller):
    """{batch: {name: [(card, windows, thread)]}} of the shard spans."""
    by: dict = {}
    for r in recs:
        if r.name in ("shard", "prepare_shard"):
            by.setdefault(r.batch, {}).setdefault(r.name, []).append(
                (r.counts["card"], r.counts["windows"], r.thread == caller))
    return by


def test_shard_spans_on_four_cards(ring, wins):
    """Over four (CPU) devices each shard of each batch has one
    ``prepare_shard`` on the caller, around its quantize and upload, and
    one ``shard`` on a worker, around its decode, counting ``card`` 0..3
    and its windows, both under the batch's id."""
    wi, wq = wins
    wi4, wq4 = np.concatenate([wi, wi[:2]]), np.concatenate([wq, wq[:2]])
    out = list(pmc.decode_channels_pipelined_multidevice(
        [(wi4, wq4), (wi4[:4], wq4[:4])], QUICK, device_batch=2,
        devices=[CPU] * 4, fec="host"))
    assert len(out) == 2
    recs = tracing.records()
    caller = threading.get_ident()
    by = _shard_spans(recs, caller)
    waits = [r.batch for r in recs if r.name == "await_batch"]
    assert sorted(by) == sorted(waits) and len(set(waits)) == 2
    for k, sizes in zip(waits, ((1, 1, 1, 2), (1, 1, 1, 1))):
        want = list(enumerate(sizes))
        prep = by[k]["prepare_shard"]
        dec = by[k]["shard"]
        assert [(c, n) for c, n, _ in prep] == want
        assert sorted((c, n) for c, n, _ in dec) == want
        assert all(on_caller for *_, on_caller in prep)
        assert not any(on_caller for *_, on_caller in dec)
    # each shard's quantize and upload sit inside its prepare_shard
    ids = {r.id: r for r in recs}
    for r in recs:
        if r.name in ("quantize", "upload"):
            assert ids[r.parent].name == "prepare_shard"
            assert ids[r.parent].batch == r.batch
    # the decode's layer ranges sit inside the worker's shard span
    for r in recs:
        if r.name == "fec_host":
            top = r
            while top.parent is not None:
                top = ids[top.parent]
            assert top.name == "shard" and top.batch == r.batch


def test_shard_spans_on_one_card(ring, wins):
    """On one device: card 0, one ``shard`` and one ``prepare_shard`` a
    batch, holding the batch's windows; a stream of handles has a
    ``shard`` a batch and no ``prepare_shard``."""
    wi, wq = wins
    list(pmc.decode_channels_pipelined(
        [(wi, wq), (wi[:2], wq[:2])], QUICK, device_batch=3, device=CPU,
        fec="host"))
    by = _shard_spans(tracing.records(), threading.get_ident())
    assert [v for _, v in sorted(by.items())] == [
        {"prepare_shard": [(0, n, True)], "shard": [(0, n, False)]}
        for n in (3, 2)]
    list(pmc.decode_channels_pipelined(
        [pmc.prepare_windows(wi, wq, 3, device=CPU)], QUICK, device=CPU,
        fec="host"))
    last = _shard_spans(tracing.records(), threading.get_ident())
    new = [v for k, v in last.items() if k not in by]
    assert new == [{"shard": [(0, 3, False)]}]


def test_a_generator_batch_is_made_under_its_id(ring, wins):
    """A batch a generator makes when the driver pulls it (as a chain of
    front-end steps does) is recorded under that batch's id."""
    wi, wq = wins

    def items():
        for _ in range(2):
            with tracing.span("make"):
                pass
            yield pmc.prepare_windows_device(
                torch.from_numpy(wi), torch.from_numpy(wq), device_batch=3)

    list(pmc.decode_channels_pipelined(items(), QUICK, device=CPU,
                                       fec="host"))
    made = [r.batch for r in tracing.records() if r.name == "make"]
    waits = [r.batch for r in tracing.records() if r.name == "await_batch"]
    assert made == waits and len(set(made)) == 2 and None not in made


def test_benchmark_tracer_sees_no_new_span(ring, wins):
    """In a traced benchmark run the tracer takes the place of
    ``record_function``: it gets the layer ranges and its own
    ``prepare_windows`` range, and no span of the record; the record
    gets the new spans and none of the layer ranges."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from wsprbench.trace import Trace, instrument
    wi, wq = wins
    tr = Trace(card="cpu", t0=0.0, t1=0.0, windows=0)
    with instrument(tr, cuda=False):
        list(pmc.decode_channels_pipelined(
            [(wi, wq), (wi, wq)], QUICK, device_batch=3, device=CPU,
            fec="hybrid"))
    assert pmc.record_function is tracing.labelled  # put back
    harness = {n for n, *_ in tr.spans}
    assert harness <= LAYER_RANGES | {"prepare_windows"}
    assert {"stage_a", "prepare_windows", "fec_device"} <= harness
    mine = {r.name for r in tracing.records()}
    assert {"quantize", "upload", "await_batch", "fano_round"} <= mine
    assert not mine & (LAYER_RANGES | {"prepare_windows"})

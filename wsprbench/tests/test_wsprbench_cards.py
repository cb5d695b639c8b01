"""The four-card farm (``farm.mixed.x4``, ``feeds/host_cards.py``): the
cell run from a copy of the benchmark on four stand-ins for its cards,
and its two readers of the program's span record on records of known
times, silent where there is nothing to read."""

import importlib
import json
import shutil
import sys

import pytest

from wsprbench import run as R
from wsprbench.tests.test_wsprbench_harness import SEED
from wsprbench.trace import Trace

from rtlsdr_wsprd_tpu_torch import tracing

ROOT = R.ROOT
NEW = ("wsprbench/feeds/host_cards.py", "wsprbench/configs/wsprd_farm_x4.json",
       "wsprbench/traffic/mixed_x4.json", "wsprbench/limits/farm.mixed.x4.json",
       "wsprbench/metrics/shard_skew_ms.py",
       "wsprbench/metrics/caller_busy_pct.py")
READERS = ("shard_skew_ms", "caller_busy_pct")


def _read(name, trace):
    return importlib.import_module(f"wsprbench.metrics.{name}").read(trace)


@pytest.fixture(autouse=True)
def _metrics_unloaded():
    """Leave ``wsprbench.metrics`` as unimported as it was found: the
    package's path is fixed at its first import, and a later test that
    runs a copy of the benchmark must find the copy's readers."""
    before = set(sys.modules)
    yield
    for name in set(sys.modules) - before:
        if name.startswith("wsprbench.metrics"):
            del sys.modules[name]


def test_the_four_card_cell_runs_from_a_copy(tmp_path, monkeypatch):
    """``farm.mixed.x4`` from a copy of the benchmark, its windows cut to
    two pulls of 8 and its cards four CPU stand-ins: the feed is found
    under the copy's root, gets all four, the run reads correct, reports
    4 cards and counts every pull's windows; the run changes no file of
    the copy."""
    root = tmp_path / "co"
    shutil.copytree(ROOT / "wsprbench", root / "wsprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for rel in NEW:
        assert (root / rel).is_file(), rel
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    cell = R.load_cell("farm.mixed.x4", root=root)
    assert cell.chips == 4 and cell.root == root
    assert cell.config["feed"] == "host_cards"
    assert R.feed_class(cell).__module__ == "wsprbench.feeds.host_cards"
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    cell.mix = dict(cell.mix, windows=16, batch=8, check_windows=4)
    cell.config = dict(cell.config, kernels=[])  # the CPU launches none
    pulled, handed = [], []
    real_pulled = R.Window.pulled

    def note(self, key):
        ok = real_pulled(self, key)
        if ok:
            pulled.append(key)
        return ok

    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
    real_driver = mc.decode_channels_pipelined_multidevice

    def driver(items, options, **kw):
        handed.append((kw["devices"], kw["device_batch"]))
        return real_driver(items, options, **kw)

    monkeypatch.setattr(R.Window, "pulled", note)
    monkeypatch.setattr(mc, "decode_channels_pipelined_multidevice", driver)
    sys.path.insert(0, str(root))
    try:
        out = R.run(cell, SEED + 40, 4.0, False, device="cpu",
                    log=lambda *a: None)
    finally:
        sys.path.remove(str(root))
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["count"] == 4
    assert out["attempted"] == 8 * len(pulled) > 0
    assert out["metrics"]["windows_per_s"]["value"] > 0
    assert {(len(d), b) for d, b in handed} == {(4, 2)}
    after = {p.relative_to(root): p.read_bytes()
             for p in root.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before


def _rec(name, a, b, k, batch=None, thread=1, **counts):
    return tracing.Record(name, thread, batch, k, None, int(a * 1e9),
                          int(b * 1e9), 0, int((b - a) * 1e9), counts)


@pytest.fixture
def recorded(monkeypatch):
    """Put records of known times in the program's ring."""
    def put(*recs, dropped=0):
        ring = tracing.Ring(max(len(recs), 1))
        for r in list(recs[:1]) * dropped + list(recs):  # first overwritten
            ring.append(r)
        monkeypatch.setattr(tracing, "_RING", ring)
    return put


def _four_card_records():
    """Three batches of four shards: batch 0 merged before the window,
    batches 1 and 2 inside it (skews 0.4 s and 0.1 s), batch 3 merged
    after it; one-shard batch 4 inside it (no skew); prepare_shard
    spans on the caller, one half in the window."""
    recs, k = [], 0

    def add(*a, **kw):
        nonlocal k
        recs.append(_rec(*a, k, **kw))
        k += 1

    for batch, t, ends in ((0, 8.0, (9.0, 9.5, 9.2, 9.1)),
                           (1, 11.0, (12.0, 12.4, 12.1, 12.2)),
                           (2, 14.0, (15.0, 15.05, 15.1, 15.0)),
                           (3, 19.6, (20.5, 21.0, 20.6, 20.7))):
        for card, end in enumerate(ends):
            add("prepare_shard", t + 0.25 * card, t + 0.25 * card + 0.2,
                batch=batch, card=card, windows=128)
            add("shard", t + 0.25 * card + 0.2, end, batch=batch, thread=2,
                card=card, windows=128)
        add("await_batch", t + 1.0, max(ends) + 0.01, batch=batch)
    add("shard", 16.0, 17.0, batch=4, thread=2, card=0, windows=128)
    add("await_batch", 16.5, 17.01, batch=4)
    return recs


def test_four_card_readers_on_known_records(recorded):
    tr = Trace(card="x", t0=10.0, t1=20.0, windows=1024, cards=4)
    recorded(*_four_card_records())
    # batches 1 and 2 are merged in the window: (0.4 + 0.1) / 2 s
    assert _read("shard_skew_ms", tr) == pytest.approx(250.0)
    # prepare_shard: 4 x 0.2 s for batches 1 and 2, and of batch 3's
    # 19.6-19.8 and 19.85-20.05 the 0.35 s before the window closes at
    # 20.0 (its other two start after it) = 1.95 s of 10
    assert _read("caller_busy_pct", tr) == pytest.approx(19.5)


def test_four_card_readers_are_silent_without_their_records(recorded,
                                                            monkeypatch):
    tr = Trace(card="x", t0=10.0, t1=20.0, windows=1024, cards=4)
    # one card: a shard a batch, no prepare_shard (a stream of handles)
    recorded(_rec("shard", 11.0, 12.0, 0, batch=1, card=0, windows=64),
             _rec("await_batch", 11.5, 12.01, 1, batch=1))
    assert all(_read(n, tr) is None for n in READERS)
    # a ring that overwrote records reads nothing
    recorded(*_four_card_records(), dropped=1)
    assert tracing.dropped() == 1
    assert all(_read(n, tr) is None for n in READERS)
    # a parent checkout's program: the record, but no shard spans
    recorded(*[r for r in _four_card_records()
               if r.name not in ("shard", "prepare_shard")])
    assert all(_read(n, tr) is None for n in READERS)
    # nothing completed in the window
    recorded(*_four_card_records())
    empty = Trace(card="x", t0=10.0, t1=20.0, windows=0, cards=4)
    assert all(_read(n, empty) is None for n in READERS)
    # a program without the record (an older checkout of the port) reads
    # nothing, and raises nothing
    import rtlsdr_wsprd_tpu_torch
    monkeypatch.setitem(sys.modules, "rtlsdr_wsprd_tpu_torch.tracing", None)
    monkeypatch.delattr(rtlsdr_wsprd_tpu_torch, "tracing")
    assert all(_read(n, tr) is None for n in READERS)


def test_the_cell_is_the_one_card_farm_on_four():
    """``farm.mixed.x4`` is ``farm.mixed``'s content, link and limits in
    512-window pulls on four chips."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "farm.mixed.x4")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("wsprd_farm_x4", "mixed_x4", 4)
    x4 = json.loads((ROOT / "wsprbench/configs/wsprd_farm_x4.json").read_text())
    one = json.loads((ROOT / "wsprbench/configs/wsprd_farm.json").read_text())
    for key in ("depth", "transfer_dtype", "fec", "options",
                "decoder_defaults", "kernels"):
        assert x4[key] == one[key], key
    mix = json.loads((ROOT / "wsprbench/traffic/mixed_x4.json").read_text())
    one = json.loads((ROOT / "wsprbench/traffic/mixed.json").read_text())
    assert dict(mix, windows=512, batch=128) == one
    assert (mix["windows"], mix["batch"]) == (2048, 512)
    assert (ROOT / "wsprbench/limits/farm.mixed.x4.json").read_bytes() == \
        (ROOT / "wsprbench/limits/farm.mixed.json").read_bytes()

"""The harness: its result line, the lookups by name, the import rule,
and runs with the timed path broken underneath, which must come out not
correct. Runs here drive the port's plain CPU route at small sizes; the
harness's look for a card is skipped by naming the device."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from wsprbench import run as R

ROOT = R.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 4242


def small_cell(name="farm.mixed", **mix):
    cell = R.load_cell(name)
    cell.mix = dict(cell.mix, **{"windows": 8, "batch": 4,
                                 "check_windows": 8, **mix})
    cell.config = dict(cell.config, kernels=[])  # the CPU launches none
    cell.limits = dict(cell.limits)
    return cell


def test_every_name_resolves_to_a_file():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("wsprbench/")
        feed = json.loads((ROOT / c["file"]).read_text())["feed"]
        assert (ROOT / "wsprbench" / "feeds" / f"{feed}.py").is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "wsprbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "wsprbench" / "limits" / f"{w['name']}.json").is_file()
        assert R.load_cell(w["name"]).config
    names = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (ROOT / "wsprbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in names
    assert names == {"windows_per_s", "setup_s"}


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as new files and new BENCHMARK.json entries, are found by name."""
    root = tmp_path / "co"
    shutil.copytree(ROOT / "wsprbench", root / "wsprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "wsprbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "wsprbench/configs/wsprd_farm.json").read_text())
    cfg["options"] = {"quickmode": True}
    (root / "wsprbench/configs/quick_farm.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "wsprbench/traffic/mixed.json").read_text())
    mix["noise_every"] = 1
    (root / "wsprbench/traffic/quiet.json").write_text(json.dumps(mix))
    (root / "wsprbench/metrics/windows_done.py").write_text(
        "def read(trace):\n    return float(trace.windows)\n")
    (root / "wsprbench/limits/quick.quiet.json").write_text(
        json.dumps({"spots_differ": 0, "snr_gap_median_db": 1e-5,
                    "sync_gap_median": 1e-6}))
    bench["configs"].append(dict(bench["configs"][0], name="quick_farm",
                                 file="wsprbench/configs/quick_farm.json"))
    bench["workloads"].append({"name": "quick.quiet", "config": "quick_farm",
                               "traffic": "quiet", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "windows_done", "unit": "windows",
                               "better": "higher", "source": "program_span",
                               "layer": "the card", "moves": "windows_per_s",
                               "workloads": ["quick.quiet"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = R.load_cell("quick.quiet", root=root)
    assert cell.config["options"] == {"quickmode": True}
    assert cell.mix["noise_every"] == 1
    assert [m["name"] for m in cell.per_layer][-1] == "windows_done"
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "wsprbench").rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before  # nothing that was there changed
    sys.path.insert(0, str(root))
    try:
        cell.mix = dict(cell.mix, windows=4, batch=2, check_windows=4)
        cell.config = dict(cell.config, kernels=[])
        out = R.run(cell, SEED, 1.0, True, device="cpu", log=lambda *a: None)
    finally:
        sys.path.remove(str(root))
    assert out["correct"] is True
    assert "windows_done" in out["metrics"] or out["device"]["busy_s"] == 0


MULTI_FEED = '''"""A throwaway feed: the host farm's pool in pulls of a batch and
of half of one by turns, each through decode_channels_pipelined_multidevice
over the cell's cards."""

from wsprbench.feeds import host


def cuts(P, batch):
    out, a = [], 0
    while a < P:
        b = min(P, a + (batch if len(out) % 2 == 0 else batch // 2))
        out.append((a, b))
        a = b
    return out


class Feed(host.Feed):
    def __init__(self, cell, seed, devices):
        super().__init__(cell, seed, devices)
        self.cuts = cuts(self.pool.wi.shape[0], self.batch)

    def items(self, win, order):
        for k in order(len(self.cuts)):
            if win is not None and not win.pulled(k):
                return
            a, b = self.cuts[k]
            yield self.pool.wi[a:b], self.pool.wq[a:b]

    def windows_of(self, key):
        return list(range(*self.cuts[key]))

    def decode(self, items, options, on_error):
        from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
        cfg = self.cell.config
        return mc.decode_channels_pipelined_multidevice(
            items, options, depth=int(cfg["depth"]), device_batch=self.batch,
            transfer_dtype=cfg["transfer_dtype"], fec=cfg["fec"],
            on_error=on_error, devices=self.devices)
'''


def test_a_new_feed_on_two_cards_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway feed, its configuration and a two-card cell, added as
    new files and new BENCHMARK.json entries in a copy: the run finds the
    feed under the copy's root, hands it both cards, reports them, and
    counts the windows of every pull, whatever each holds."""
    root = tmp_path / "co"
    shutil.copytree(ROOT / "wsprbench", root / "wsprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "wsprbench").rglob("*") if p.is_file()}
    (root / "wsprbench/feeds/multi_host.py").write_text(MULTI_FEED)
    cfg = json.loads((ROOT / "wsprbench/configs/wsprd_farm.json").read_text())
    cfg["feed"] = "multi_host"
    (root / "wsprbench/configs/multi_farm.json").write_text(json.dumps(cfg))
    (root / "wsprbench/limits/multi.mixed.json").write_bytes(
        (ROOT / "wsprbench/limits/farm.mixed.json").read_bytes())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="multi_farm",
                                 file="wsprbench/configs/multi_farm.json"))
    bench["workloads"].append({"name": "multi.mixed", "config": "multi_farm",
                               "traffic": "mixed", "chips": 2, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "wsprbench").rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before  # nothing that was there changed
    assert not (ROOT / "wsprbench/feeds/multi_host.py").exists()

    cell = R.load_cell("multi.mixed", root=root)
    assert cell.chips == 2 and cell.root == root
    cell.mix = dict(cell.mix, windows=8, batch=4, check_windows=8)
    cell.config = dict(cell.config, kernels=[])
    sizes = {0: 4, 1: 2, 2: 2}  # the feed's cuts of 8 windows, batch 4
    pulled = []
    real = R.Window.pulled

    def note(self, key):
        ok = real(self, key)
        if ok:
            pulled.append(key)
        return ok

    monkeypatch.setattr(R.Window, "pulled", note)
    out = R.run(cell, SEED + 6, 1.0, False, device="cpu", log=lambda *a: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["count"] == 2
    assert out["attempted"] == sum(sizes[k] for k in pulled)
    assert out["attempted"] < 4 * len(pulled)  # a half pull is counted half
    assert out["metrics"]["windows_per_s"]["value"] > 0


def test_result_line_keys_and_a_sound_run():
    out = R.run(small_cell(), SEED, 2.0, False, device="cpu",
                log=lambda *a: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"windows_per_s", "setup_s"}
    assert out["metrics"]["windows_per_s"]["unit"] == "windows/s"
    assert out["metrics"]["windows_per_s"]["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["spots_differ"] == {"value": 0, "limit": 0}


def test_traced_line_carries_the_per_layer_metrics():
    out = R.run(small_cell(), SEED + 1, 2.0, True, device="cpu",
                log=lambda *a: None)
    assert out["correct"] is True
    for name in ("stage_a_ms", "stage_b_ms", "spots_ms", "subtract_ms",
                 "driver_uncovered_ms", "device_idle_pct"):
        assert out["metrics"][name]["value"] >= 0
    # the quantize and upload read from their own range, the tail from
    # the batches' pulls and yields
    assert out["metrics"]["prepare_ms"]["value"] > 0
    assert out["metrics"]["batch_p95_ms"]["value"] > 0
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture
def broken(monkeypatch):
    """Break the program's decode underneath the pipelined driver."""
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
    real = mc.decode_channels

    def use(kind):
        def decode_channels(*a, **kw):
            out = real(*a, **kw)
            if kind == "half":  # half of each batch left out
                return out[:len(out) // 2] + [[] for _ in out[len(out) // 2:]]
            if kind == "altered":  # an answer altered where it is made
                for spots in out:
                    for s in spots:
                        s.message = s.message.replace(" ", "X", 1)
                        break
            if kind == "freq":  # a spot's frequency altered, not its message
                for spots in out:
                    for s in spots:
                        s.freq += 1e-6
                        break
            return out
        monkeypatch.setattr(mc, "decode_channels", decode_channels)
    return use


@pytest.mark.parametrize("kind", ["half", "altered", "freq"])
def test_a_broken_decode_is_not_correct(broken, kind):
    broken(kind)
    out = R.run(small_cell(), SEED + 2, 2.0, False, device="cpu",
                log=lambda *a: None)
    assert out["correct"] is False
    name = "freq_gap_hz" if kind == "freq" else "spots_differ"
    assert out["checks"][name]["value"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_judged_windows_hold_signals_in_both_halves(cell):
    """On every seed the sample judges a window that holds a signal in
    each half of its batch, so a batch losing either half fails."""
    mix = R.load_cell(cell).mix
    B = int(mix["batch"])
    for seed in (0, 1, 2**31 + 7, 2**32 + 99, 123456789):
        truth = R.gen.slot_truth(mix, seed)
        got = R.sample_windows(mix, seed)
        assert len(got) == len(set(got)) == int(mix["check_windows"])
        assert got == R.sample_windows(mix, seed)
        for half in (True, False):
            assert any(truth[w] for w in got if (w % B < B // 2) == half)


def test_a_subtraction_that_leaves_the_windows_is_not_correct(monkeypatch):
    """The step between passes returns its state unchanged: on crowded
    windows the second pass then misses what the subtraction uncovers."""
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
    monkeypatch.setattr(mc._DeviceWindows, "subtract",
                        lambda self, *a: None)
    cell = small_cell()  # farm.mixed fed the crowded mix's windows
    cell.mix = dict(R.gen.load_mix(ROOT / "wsprbench/traffic/crowded.json"),
                    windows=8, batch=8, check_windows=8)
    out = R.run(cell, SEED + 3, 2.0, False, device="cpu",
                log=lambda *a: None)
    assert out["correct"] is False


def test_no_card_means_no_result():
    proc = subprocess.run(
        [sys.executable, "wsprbench/run.py", "--workload", "farm.mixed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert proc.returncode == 3 and proc.stdout == ""


def test_only_the_benchmark_files_means_no_result(tmp_path):
    shutil.copytree(ROOT / "wsprbench", tmp_path / "wsprbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "wsprbench/run.py", "--workload", "farm.mixed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "rtlsdr_wsprd_tpu",
                     "rtlsdr_wsprd_tpu_torch"}}))
"""


def _tops(body):
    proc = subprocess.run(
        [sys.executable, "-c", IMPORTS.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_program():
    body = """
from wsprbench import gen, compare, work
from wsprbench.reference import decode, frontend
mix = gen.load_mix({mix!r})
pool = gen.baseband(dict(mix, windows=1), 3)
decode.decode_window(decode.quantize(pool.wi[0]), decode.quantize(pool.wq[0]))
""".format(mix=str(ROOT / "wsprbench/traffic/mixed.json"))
    assert _tops(body) == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    body = """
from wsprbench import run as R
cell = R.load_cell("farm.mixed")
cell.mix = dict(cell.mix, windows=2, batch=2, check_windows=2)
cell.config = dict(cell.config, kernels=[])
R.run(cell, 5, 0.5, True, device="cpu", log=lambda *a: None)
print(R.banned_modules())
"""
    assert _tops(body) == "['rtlsdr_wsprd_tpu_torch']"


def test_a_front_end_step_that_keeps_its_carry_is_not_correct(monkeypatch):
    """chain.raw at one dongle: the fused front-end step returns the
    mid-rate carry it was given, so every window after the first is cut
    from the wrong samples at each step's seam."""
    import torch

    from rtlsdr_wsprd_tpu_torch.frontend import decimate
    real = decimate._fused_frontend_step

    def stuck(rawI, rawQ, m2I, m2Q, n_mid):
        oi, oq, _, _ = real(rawI, rawQ, m2I, m2Q, n_mid)
        return oi, oq, m2I, m2Q

    monkeypatch.setattr(decimate, "_fused_frontend_step", stuck)
    torch.set_num_threads(4)
    cell = small_cell("chain.raw", windows=1, batch=1, check_windows=1)
    out = R.run(cell, SEED + 5, 8.0, False, device="cpu", log=lambda *a: None)
    assert out["correct"] is False
    assert out["checks"]["baseband_err"]["value"] > \
        out["checks"]["baseband_err"]["limit"]

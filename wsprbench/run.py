"""Run one cell of the benchmark once and print its result line.

    python3 wsprbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are looked up by name
in ``BENCHMARK.json``; the configuration's file says how the deployment
feeds the decode (``feed``: a module of ``feeds/``, whose contract
``feeds/__init__.py`` states), the mix's file what it feeds
(``gen.py``). A run hands the feed the cell's ``chips`` cards
(``cuda:0`` onwards), makes its inputs from the seed, warms every shape
up (set-up), then drives the deployment's pipelined decode in a closed
loop for ``--seconds``: the driver pulls the next batch when it has
room. Afterwards it compares a sample of the answers drawn from the
seed with the plain reference (``compare.py``), prints the calibration
and the kernel launches on standard error, the numbers compared beside
their limits as the last lines there, and the result as the last line
of standard output. With ``--trace 1`` the window runs traced
(``trace.py``) and the line carries the per-layer metrics instead.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "rtlsdr_wsprd_tpu")

if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wsprbench import compare, gen  # noqa: E402
from wsprbench.reference.constants import Options  # noqa: E402
from wsprbench.trace import Trace, instrument  # noqa: E402


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    mix: dict               # the traffic mix's file
    end_to_end: list
    per_layer: list
    limits: dict = field(default_factory=dict)
    root: Path = ROOT       # the checkout its files were read from


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    lim = root / "wsprbench" / "limits" / f"{name}.json"
    return Cell(
        name, int(cell["chips"]),
        json.loads((root / cfg["file"]).read_text()),
        gen.load_mix(root / "wsprbench" / "traffic"
                     / f"{cell['traffic']}.json"),
        [m for m in bench["end_to_end"]
         if name in m.get("workloads", [name])],
        [m for m in bench["per_layer"]
         if name in m.get("workloads", [name])],
        json.loads(lim.read_text()) if lim.exists() else {}, root)


def feed_class(cell: Cell):
    """The ``Feed`` of ``feeds/<feed>.py`` under the cell's own root."""
    name = cell.config["feed"]
    path = cell.root / "wsprbench" / "feeds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"wsprbench.feeds.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Feed


def decoder_options(config: dict):
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    return DecoderOptions(**config.get("options", {}))


# ---------------------------------------------------------------- a run

class Window:
    """The closed loop's bookkeeping: when each batch was pulled and when
    its spots were yielded, on the host clock."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = self.t1 = 0.0
        self.pulls: list[float] = []
        self.keys: list = []       # what each batch holds, for the check
        self.yields: list[float] = []
        self.results: list = []
        self.failed = 0

    def open(self):
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds

    def pulled(self, key) -> bool:
        """Note a pull; False once the window has closed."""
        t = time.perf_counter()
        if t >= self.t1:
            return False
        self.pulls.append(t)
        self.keys.append(key)
        return True

    def done(self) -> list[int]:
        """Indices of the batches yielded inside the window."""
        return [k for k, t in enumerate(self.yields) if t <= self.t1]

    def latencies_ms(self) -> list[float]:
        """Each batch yielded inside the window: its pull to its yield."""
        return [1e3 * (self.yields[k] - self.pulls[k]) for k in self.done()]


def sample_windows(mix: dict, seed: int) -> list[int]:
    """The pool slots whose answers are judged, drawn from the seed: half
    from the first half of the slots' places in their batch, half from
    the second, each half's first draw among the slots that hold a
    signal, so that a batch losing either half loses judged spots."""
    rng = np.random.default_rng([seed, 7])
    truth = gen.slot_truth(mix, seed)
    P, B = len(truth), int(mix["batch"])
    k = min(int(mix["check_windows"]), P)
    halves = [[w for w in range(P) if w % B < B // 2],
              [w for w in range(P) if w % B >= B // 2]]
    share = [k - k // 2, k // 2]
    for h in range(2):  # a half too small hands its share over
        over = max(0, share[h] - len(halves[h]))
        share[h] -= over
        share[1 - h] += over
    out: list[int] = []
    for half, n in zip(halves, share):
        if not n:
            continue
        sig = [w for w in half if truth[w]]
        first = int(rng.choice(sig if sig else half))
        rest = [w for w in half if w != first]
        out += [first] + rng.choice(rest, size=n - 1,
                                    replace=False).tolist()
    return sorted(int(w) for w in out)


def reference_spots(inputs: dict, config: dict, tf32: bool = False) -> dict:
    """The plain reference's spots of each sampled window, on the CPU: a
    thread a window, their Fano searches spread over a pool of worker
    processes; ``tf32``: the control's precision."""
    from wsprbench.reference import precision
    from wsprbench.reference.decode import decode_window
    opts = Options(**config.get("options", {}))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(os.cpu_count() or 1, 8),
                             mp_context=ctx) as procs, \
            ThreadPoolExecutor(max(len(inputs), 1)) as threads:
        def one(item):
            w, (i, q) = item
            with precision.tf32() if tf32 else contextlib.nullcontext():
                return w, decode_window(i, q, opts, fano_map=procs.map)
        return dict(threads.map(one, inputs.items()))


def launch_counts() -> dict:
    from rtlsdr_wsprd_tpu_torch.parallel.dryrun import launch_counts as lc
    return lc()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str | None = None, log=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``device``
    names the device that stands for each of the cell's ``chips`` cards
    (None: cuda:0 .. chips-1); the tests pass "cpu"."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    devs = ([torch.device(device)] * cell.chips if device is not None
            else [torch.device("cuda", k) for k in range(cell.chips)])
    dev = devs[0]
    cuda = dev.type == "cuda"
    make_feed = feed_class(cell)
    if cuda:
        for d in devs:
            torch.empty(1, device=d)
            torch.cuda.reset_peak_memory_stats(d)
    t_setup = time.perf_counter()
    from rtlsdr_wsprd_tpu_torch.ops.calibrate import describe
    options = decoder_options(cell.config)
    feed = make_feed(cell, seed, devs)
    checked = sample_windows(cell.mix, seed)
    feed.keep_for_check(checked)
    feed.warm(options)
    if cuda:
        for d in devs:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_setup
    log(f"fec: {describe(cell.config['fec'], dev)}")
    before = launch_counts()

    win = Window(seconds)
    rng = np.random.default_rng([seed, 11])

    def order(n):  # the batches cycle in an order drawn from the seed
        k = 0
        while True:
            for b in rng.permutation(n):
                yield int(b)
                k += 1

    def on_error(exc):
        win.failed += 1
        log(f"batch failed: {exc!r}")

    tr = Trace(card=torch.cuda.get_device_name(dev) if cuda else "cpu",
               t0=0.0, t1=0.0, windows=0, options_maxdrift=options.maxdrift,
               cards=len(devs))
    ctx = (instrument(tr, cuda=cuda, devices=devs) if trace
           else contextlib.nullcontext())
    with ctx:
        win.open()
        for spots in feed.decode(feed.items(win, order), options, on_error):
            win.yields.append(time.perf_counter())
            win.results.append(spots)
    done = win.done()
    after = launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    log(f"launches in the window: {json.dumps(launches)}")
    peak = max(torch.cuda.max_memory_allocated(d) for d in devs) \
        if cuda else 0
    n_windows = sum(len(feed.windows_of(win.keys[k])) for k in done)

    # ---- the check, once the window has closed
    yields = []
    for k in done:
        for w, spots in zip(feed.windows_of(win.keys[k]), win.results[k]):
            if w in checked:
                yields.append((w, spots))
    inputs, numbers = feed.check_inputs(checked, len(done))
    attempted = sum(len(feed.windows_of(key)) for key in win.keys)
    failed = win.failed * feed.batch
    feed.release()
    del feed
    t_ref = time.perf_counter()
    ref = reference_spots(inputs, cell.config)
    numbers.update(compare.spot_numbers(yields, ref))
    log(f"reference: {len(inputs)} windows in "
        f"{time.perf_counter() - t_ref:.1f} s; "
        f"{numbers['spots_judged']} reference spots judged")
    ok, checks = compare.judge(numbers, cell.limits)
    main_kernels = cell.config.get("kernels", [])
    silent = [k for k in main_kernels if launches.get(k, 0) == 0]
    if silent:
        log(f"main kernels not launched in the window: {silent}")
        ok = False
    if not done:
        ok = False

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": tr.card, "count": len(devs),
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok and win.failed == 0),
           "attempted": attempted, "failed": failed}
    if trace:
        tr.t0, tr.t1 = win.t0, win.t1
        tr.windows = n_windows
        tr.batch_ms = win.latencies_ms()
        metrics = {}
        for m in cell.per_layer:
            reader = importlib.import_module(f"wsprbench.metrics.{m['name']}")
            v = reader.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        out["device"] = device_info
        out["breakdown"] = tr.breakdown()
    else:
        values = {"windows_per_s": n_windows / seconds, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = device_info
        # a batch's pull to its yield; the per-layer batch_p95_ms
        lat = win.latencies_ms() or [0.0]
        log(f"batches in the window: {len(done)}; pull to yield ms p50 "
            f"{np.percentile(lat, 50)} p95 {np.percentile(lat, 95)}")
    diag = {k: v for k, v in numbers.items() if k not in checks}
    log(f"not compared: {json.dumps(diag)}")
    out["checks"] = checks
    return out


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    cache = ROOT / "wsprbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = banned_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

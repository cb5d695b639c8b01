"""Host-FEC threading of the PyTorch/CUDA port: how the native Fano
decoder scales over host threads.

The counterpart of tools/fec_scaling.py, on the port's ctypes binding
(``native.py``). The staged decode's host FEC maps independent lanes
over a thread pool (``parallel/multichannel.py`` ``_map_lanes``, at most
16 workers), and the hybrid FEC's stragglers go through the same
decoder. Measured:

1. worker sweep: wall time of that lane map over N budget-exhausting
   lanes (random symbols, the reference's full 10,000-cycle budget) at
   1, 2, 4, 8 and 16 workers and at the host's core count;
2. GIL release: a pure-Python counter thread's rate while another
   thread runs back-to-back full-budget decodes, over its rate alone
   (about 1 with a core to spare, 0 if the call held the GIL);
3. dispatch overhead: microseconds a lane of a plain loop, a 4-worker
   pool and ``native.fano_decode_many`` on clean decodes, where the
   machinery and not the search costs.

Usage: python tools/torch_fec_scaling.py [lanes] [reps] [--device DEV]
Host-only; ``--device`` (default the CUDA card, ``cpu`` without one)
names the machine's card beside the numbers. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch import native  # noqa: E402
from rtlsdr_wsprd_tpu_torch.config import NBITS  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.fano import METTAB  # noqa: E402
from torch_measure import device_banner  # noqa: E402

MAXCYCLES = 10000  # the reference's full budget (wsprd/wsprd.c:747)


def make_lanes(n: int) -> np.ndarray:
    """Budget-exhausting lanes: random symbols burn the full search."""
    rng = np.random.default_rng(20260820)
    return rng.integers(0, 256, (n, 2 * NBITS), dtype=np.uint8)


def make_clean() -> np.ndarray:
    """One clean conv-encoded payload at hard soft bits."""
    rng = np.random.default_rng(7)
    payload = np.zeros(11, np.uint8)
    payload[:6] = rng.integers(0, 256, 6)
    payload[6] = rng.integers(0, 256) & 0xC0
    enc = native.conv_encode(payload, NBITS)
    clean = np.zeros(2 * NBITS, np.uint8)
    clean[0::2] = np.where((enc >> 1) & 1, 230, 25)
    clean[1::2] = np.where(enc & 1, 230, 25)
    return clean


def worker_counts() -> list[int]:
    return sorted({1, 2, 4, 8, 16, os.cpu_count() or 1})


def worker_sweep(lanes: np.ndarray, reps: int) -> dict:
    """Best-of-``reps`` seconds of the lane map at each worker count."""
    n = lanes.shape[0]

    def one_lane(k):
        return native.fano_decode(lanes[k], METTAB, 60, MAXCYCLES)[0]

    out = {}
    for workers in worker_counts():
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            if workers == 1:
                for k in range(n):
                    one_lane(k)
            else:
                with ThreadPoolExecutor(workers) as ex:
                    list(ex.map(one_lane, range(n)))
            best = min(best, time.perf_counter() - t0)
        out[f"w{workers}"] = best
    return out


def gil_release_ratio(noise: np.ndarray, window_s: float = 0.6) -> float:
    """A Python thread's progress while native decodes run, over its
    progress alone."""

    def count(stop, box):
        c = 0
        while not stop.is_set():
            c += 1
        box.append(c)

    def measure(with_decodes: bool) -> float:
        stop = threading.Event()
        box: list[int] = []
        t = threading.Thread(target=count, args=(stop, box))
        t.start()
        t0 = time.perf_counter()
        try:
            if with_decodes:
                while time.perf_counter() - t0 < window_s:
                    native.fano_decode(noise, METTAB, 60, MAXCYCLES)
            else:
                time.sleep(window_s)
        finally:
            stop.set()
            t.join(timeout=60)
        return box[0] / (time.perf_counter() - t0)

    solo = measure(False)
    return measure(True) / solo


def dispatch_overhead(clean: np.ndarray, n: int = 256) -> dict:
    """Microseconds a lane: loop, 4-worker pool, fano_decode_many."""
    many = np.broadcast_to(clean, (n, clean.shape[0])).copy()

    def timed(fn) -> float:
        fn()  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return 1e6 * best / n

    def one(k):
        return native.fano_decode(many[k], METTAB, 60, MAXCYCLES)

    def pooled():
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(one, range(n)))

    return {"loop_us_per_lane": timed(lambda: [one(k) for k in range(n)]),
            "pool_us_per_lane": timed(pooled),
            "decode_many_us_per_lane": timed(lambda: native.fano_decode_many(
                many, METTAB, 60, MAXCYCLES))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lanes", nargs="?", type=int, default=16)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    banner = device_banner(args.device)
    lanes = make_lanes(args.lanes)
    noise = lanes[0]
    t0 = time.perf_counter()
    native.fano_decode(noise, METTAB, 60, MAXCYCLES)
    timeout_ms = 1e3 * (time.perf_counter() - t0)
    print(json.dumps({
        "host_cores": len(os.sched_getaffinity(0)),
        "cpu_count": os.cpu_count(),
        "device": banner,
        "lanes": args.lanes,
        "timeout_lane_ms": timeout_ms,
        "sweep_s": worker_sweep(lanes, args.reps),
        "gil_release_progress_ratio": gil_release_ratio(noise),
        "dispatch": dispatch_overhead(make_clean()),
    }), flush=True)


if __name__ == "__main__":
    main()

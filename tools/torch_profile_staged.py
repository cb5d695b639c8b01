"""Phase timing of the PyTorch/CUDA port's staged decode on the card.

The counterpart of tools/profile_staged.py: ``decode_channels`` on the
bench batch (the port's copy of bench.py's ``make_batch``, full
schedule, 2 passes, subtraction) after two warm runs, each wall interval
given to the phase whose debug mark ends it (the marks the port's
``parallel/multichannel.py`` logs, the JAX package's text). The window
quantize and upload (``prepare_windows``) and the wait for it to land
(``torch.cuda.synchronize()``) are timed apart from the decode.

Usage: python tools/torch_profile_staged.py [B] [DB] [-v] [--device DEV]
B windows (default 256), device_batch DB (default 64); ``-v`` prints
every mark with the interval it ends; ``--device`` defaults to the CUDA
card (``cpu`` runs the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.device import resolve_device  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc  # noqa: E402
from torch_measure import device_banner, make_batch  # noqa: E402


class PhaseLog(logging.Handler):
    """Accumulates (t, message) marks from the staged-path logger."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.marks: list[tuple[float, str]] = []

    def emit(self, record):
        self.marks.append((time.perf_counter(), record.getMessage()))


def summarize(marks, t0, t1):
    """Assign inter-mark intervals to phases by the ENDING mark."""
    phases: dict[str, float] = {}
    prev = t0
    for t, msg in marks:
        if msg.startswith("stage A done"):
            key = "stage A (STFT+cand+coarse)"
        elif msg.startswith("stage B:"):
            key = "lane compaction (host)"
        elif msg.startswith("stage B fetch"):
            key = "stage B (fine+jitter demod)"
        elif msg.startswith("fano rounds"):
            key = "fano rounds (device+host)"
        elif msg.startswith("host-finishing"):
            key = None  # sub-mark inside fano rounds
        elif msg.startswith("subtracting"):
            key = "spot assembly (host)"
        elif msg.startswith("subtraction done"):
            key = "subtraction (device)"
        else:
            key = None
        if key is not None:
            phases[key] = phases.get(key, 0.0) + (t - prev)
            prev = t
    phases["tail (assembly/sort)"] = t1 - prev
    return phases


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(B: int, DB: int, device=None) -> dict:
    """Two warm decodes of the batch, then one profiled: returns the
    upload's and the decode's seconds, the phases, the spot count and
    the marks as (ms since the previous, message)."""
    dev = resolve_device(device)
    wi, wq, _calls = make_batch(B)
    options = DecoderOptions()
    spots = mc.decode_channels(wi, wq, options, device_batch=DB, device=dev)
    mc.decode_channels(wi, wq, options, device_batch=DB, device=dev)

    handler = PhaseLog()
    level = mc._LOG.level
    mc._LOG.addHandler(handler)
    mc._LOG.setLevel(logging.DEBUG)
    try:
        t_up0 = time.perf_counter()
        prepared = mc.prepare_windows(wi, wq, device_batch=DB, device=dev)
        t_up1 = time.perf_counter()
        # the upload lands before the decode's clock starts: a pipelined
        # decode overlaps it with the previous batch
        _sync(dev)
        t_land = time.perf_counter()
        t0 = time.perf_counter()
        mc.decode_channels(None, None, options, windows=prepared)
        _sync(dev)
        t1 = time.perf_counter()
    finally:
        mc._LOG.removeHandler(handler)
        mc._LOG.setLevel(level)
    marks = []
    prev = t0
    for t, msg in handler.marks:
        marks.append((1e3 * (t - prev), msg))
        prev = t
    return {"B": B, "DB": DB, "spots": sum(len(s) for s in spots),
            "prepare_s": t_up1 - t_up0, "landing_s": t_land - t_up1,
            "decode_s": t1 - t0,
            "phases": summarize(handler.marks, t0, t1), "marks": marks}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=256)
    ap.add_argument("DB", nargs="?", type=int, default=64)
    ap.add_argument("-v", action="store_true", help="print every mark")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    banner = device_banner(args.device)
    r = profile(args.B, args.DB, args.device)
    if args.v:
        for ms, msg in r["marks"]:
            print(f"  +{ms:9.3f} ms  {msg}")
    total = r["decode_s"]
    print(f"device {banner} B={r['B']} DB={r['DB']} spots={r['spots']}")
    print(f"{'prepare_windows (quantize+put)':34s} "
          f"{1e3 * r['prepare_s']:10.3f} ms (overlaps decode in steady "
          f"state)")
    print(f"{'window upload landing':34s} {1e3 * r['landing_s']:10.3f} ms "
          f"(also overlapped)")
    for k, v in sorted(r["phases"].items(), key=lambda kv: -kv[1]):
        print(f"{k:34s} {1e3 * v:10.3f} ms  {100 * v / total:5.1f}%")
    print(f"{'TOTAL decode':34s} {1e3 * total:10.3f} ms   "
          f"-> {r['B'] / total:.1f} windows/s ({banner})")


if __name__ == "__main__":
    main()

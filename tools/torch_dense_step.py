"""Device time of the dense decode step of a checkout's port package.

    python3 tools/torch_dense_step.py [--root CHECKOUT] [--windows N]
                                      [--profile]

Imports ``rtlsdr_wsprd_tpu_torch`` from ``CHECKOUT`` (default: the
checkout this tool is in), so that two checkouts' steps can be timed in
turns on one card, one process each. The step as chip_smoke.py's dense
phase takes it: one ``multichannel_decode_device`` call on the first N
windows (default 64) of the port's copy of bench.py's batch
(``torch_measure.make_batch``), ``DecoderOptions()``, the package's
default attempts a window and its calibrated device Fano budget; the
device time between CUDA events (median of 5, torch_measure.cuda_ms)
and the peak memory. ``--profile``: one more call under torch.profiler,
its kernels by device time. Prints one JSON line, then the card's name
and power limit. Needs the CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def kernel_times(fn, top: int = 12) -> list:
    """(name, device ms) of the kernels of one call of ``fn``, largest
    first, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(HERE)]
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
    from torch_measure import cuda_ms, make_batch, nvidia_smi_card

    import rtlsdr_wsprd_tpu_torch as pkg
    if Path(pkg.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    card = nvidia_smi_card()
    dev = torch.device("cuda", 0)
    B = args.windows
    opts = DecoderOptions()
    wi, wq, _ = make_batch(B)
    si = torch.from_numpy(wi).to(dev)
    sq = torch.from_numpy(wq).to(dev)
    md = torch.full((B,), opts.maxdrift, dtype=torch.int32, device=dev)
    kw = dict(mc._decode_kw(opts), max_attempts=mc.DEFAULT_MAX_ATTEMPTS,
              delta=opts.delta,
              maxcycles=mc._device_fano_budget(opts.maxcycles, dev))

    def step():
        return mc.multichannel_decode_device(si, sq, md, **kw)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(step, reps=5, warm=2)
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"metric": "dense_step", "root": str(root), "windows": B,
           "ms": ms, "peak_gib": peak / 2**30,
           "maxcycles": kw["maxcycles"], "card": card}
    if args.profile:
        out["kernels_ms"] = kernel_times(step)
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

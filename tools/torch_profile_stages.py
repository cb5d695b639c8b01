"""Per-op device timing of the PyTorch/CUDA port's decode at the bench
shape.

The counterpart of tools/profile_stages.py: each op of the decode alone
on DB windows of the bench batch (the port's copy of bench.py's
``make_batch``), in the JAX tool's order: ``power_spectrogram``,
``find_candidates``, ``coarse_search``, the fine sync (33 lags,
lagstep 8) and the soft symbols (43 jitters) over every candidate slot
of every window, then ``batched_fano`` on DB x 128 all-noise lanes at a
budget of 16 cycles a bit. Device time between CUDA events, the card
spinning while the host enqueues each call (torch_measure.cuda_ms).
Also prints the valid candidates and the minsync1 passers per window.

Usage: python tools/torch_profile_stages.py [DB] [--device DEV]
DB windows (default 16); ``--device`` defaults to the CUDA card
(``cpu`` runs the plain PyTorch versions, timed by the host clock).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.config import MAX_CANDIDATES  # noqa: E402
from rtlsdr_wsprd_tpu_torch.device import resolve_device  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.candidates import find_candidates  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.coarse import coarse_search  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.fano import (  # noqa: E402
    batched_fano,
    device_mettab,
)
from rtlsdr_wsprd_tpu_torch.ops.stft import power_spectrogram  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.sync import (  # noqa: E402
    fine_sync_lanes,
    soft_symbols_lanes,
)
from torch_measure import cuda_ms, device_banner, make_batch  # noqa: E402

FANO_LANES = 128  # all-noise lanes a window for the Fano call
MINSYNC1 = 0.10   # the JAX tool's minsync1 gate


def timed(name: str, fn, dev, banner: str, reps: int = 10):
    """Run ``fn`` once, print its time (device ms on the card, host ms
    on the CPU) and return its output."""
    out = fn()
    if dev.type == "cuda":
        ms = cuda_ms(fn, reps=reps)
        print(f"{name:34s} {ms:10.4f} ms device ({banner})", flush=True)
    else:
        t0 = time.perf_counter()
        fn()
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"{name:34s} {ms:10.1f} ms host ({banner})", flush=True)
    return out


def lanes(DB: int, dev):
    """Every candidate slot of every window as a lane: window index
    int64 (DB * MAX_CANDIDATES,)."""
    return torch.arange(DB, device=dev).repeat_interleave(MAX_CANDIDATES)


def search(sig_i, sig_q, time_op):
    """The search ops over the DB windows (sig_i, sig_q) in the JAX
    tool's order, each run through ``time_op(name, fn)`` (which returns
    ``fn()``): (candidates, coarse estimate, fine sync over every
    candidate slot)."""
    DB = sig_i.shape[0]
    dev = sig_i.device
    maxdrift = torch.full((DB,), 4, dtype=torch.int32, device=dev)
    lw = lanes(DB, dev)
    ps = time_op("stft power_spectrogram",
                 lambda: power_spectrogram(sig_i, sig_q))
    cd = time_op("find_candidates",
                 lambda: find_candidates(ps, -110.0, 110.0))
    co = time_op("coarse_search",
                 lambda: coarse_search(ps, cd.bin_idx, maxdrift))
    fs = time_op("fine_sync (33 lags + freq)", lambda: fine_sync_lanes(
        sig_i, sig_q, lw, co.freq.reshape(-1), co.shift.reshape(-1),
        co.drift.reshape(-1), lagstep=8))
    return cd, co, fs


def counts(cd, fs) -> tuple[np.ndarray, np.ndarray]:
    """Per window: the valid candidates, and the valid candidates whose
    fine sync passes minsync1."""
    valid = cd.valid.cpu().numpy()
    sync = fs.sync.reshape(valid.shape).cpu().numpy()
    return valid.sum(axis=1), ((sync > MINSYNC1) & valid).sum(axis=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("DB", nargs="?", type=int, default=16)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    DB = args.DB
    banner = device_banner(args.device)
    dev = resolve_device(args.device)
    wi, wq, _calls = make_batch(DB)
    sig_i = torch.from_numpy(wi).to(dev)
    sig_q = torch.from_numpy(wq).to(dev)

    def time_op(name, fn):
        return timed(name, fn, dev, banner)

    print(f"device {banner} DB={DB}")
    cd, co, fs = search(sig_i, sig_q, time_op)
    jt = time_op("soft_symbols_jittered (43)", lambda: soft_symbols_lanes(
        sig_i, sig_q, lanes(DB, dev), fs.freq, fs.shift,
        co.drift.reshape(-1), iifac=3, quickmode=False, symfac=50))
    del jt
    # the Fano call at a large attempt shape, every lane live noise
    # that runs to the budget
    rng = np.random.default_rng(0)
    soft = torch.from_numpy(rng.integers(0, 256, (DB * FANO_LANES, 162))
                            .astype(np.uint8)).to(dev)
    mettab = device_mettab(dev)
    time_op("batched_fano (all-noise, 16cyc)",
            lambda: batched_fano(soft, mettab, delta=60, maxcycles=16))
    n_valid, n_pass = counts(cd, fs)
    print("valid candidates/window:", n_valid)
    print("minsync1 passers/window:", n_pass)


if __name__ == "__main__":
    main()

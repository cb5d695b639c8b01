"""Drift x time-offset sensitivity matrix of the PyTorch/CUDA port.

The counterpart of tools/sensitivity_matrix.py in its ours-only mode:
the same (drift x DT) grid at a fixed SNR, the same windows (its seed
stream, drifts, start offsets and message, synthesized by the port's
runtime/synth.py), each cell decoded by the port's ``decode_channels``
at ``device_batch=32`` (on the card: the hybrid FEC on ops/csrc/fano.cu).
A trial counts when a spot has call K1JT and locator FN20.

Usage: python tools/torch_sensitivity_matrix.py [trials_per_cell] [snr_db]
           [--device DEV]
(defaults: 50 trials, -27 dB; ``--device`` defaults to the CUDA card,
``cpu`` runs the plain PyTorch versions). Prints the table (ours/trials)
and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_snr_sweep import MSG, device_banner, found  # noqa: E402

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    decode_channels,
)
from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db  # noqa: E402
from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr  # noqa: E402

DRIFTS = [-4.0, -2.0, 0.0, 2.0, 4.0]
DTS = [0.0, 1.0, 2.0, 3.0, 4.0]  # t0 seconds (nominal 2.0; +-2 s)
SEED = 20260820


def build_cells(trials: int, snr: float, drifts=DRIFTS, dts=DTS):
    """Yield ``(drift, t0, wi, wq)`` cell by cell (drift rows, DT
    columns), ``trials`` normalized windows a cell, from one seed stream
    drawn as tools/sensitivity_matrix.py draws it."""
    rng = np.random.default_rng(SEED)
    for drift in drifts:
        for t0 in dts:
            wi = np.zeros((trials, 45000), np.float32)
            wq = np.zeros((trials, 45000), np.float32)
            for t in range(trials):
                f0 = float(rng.uniform(-100, 100))
                i, q = synth_window_at_snr(
                    MSG, snr_db=snr, f0=f0, t0=t0, drift=drift,
                    seed=int(rng.integers(1 << 30)))
                wi[t], wq[t] = normalize_minus3db(i, q)
            yield drift, t0, wi, wq


def decode_cell(wi, wq, device=None) -> np.ndarray:
    """Per trial of one cell: found by ``decode_channels`` at
    ``device_batch=32`` (int8 transfer, ``fec="auto"``)."""
    return found(decode_channels(wi, wq, DecoderOptions(), device_batch=32,
                                 device=device))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trials", nargs="?", type=int, default=50)
    ap.add_argument("snr", nargs="?", type=float, default=-27.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(f"device {device_banner(args.device)}")
    print(f"SNR {args.snr} dB, {args.trials} trials/cell; cell = "
          f"ours/trials (drift rows, DT columns)")
    print(f"{'drift':>6} | " + " ".join(f"t0={t:<11}" for t in DTS))
    cells, row = [], []
    secs = 0.0  # decode only, synthesis excluded
    for drift, t0, wi, wq in build_cells(args.trials, args.snr):
        t_dec = time.perf_counter()
        n = int(decode_cell(wi, wq, args.device).sum())
        secs += time.perf_counter() - t_dec
        cells.append({"drift": drift, "t0": t0, "found": n})
        row.append(f"{n:>3}/{args.trials:<3}")
        if len(row) == len(DTS):
            print(f"{drift:>6} | " + " ".join(f"{c:<14}" for c in row),
                  flush=True)
            row = []
    print(json.dumps({"snr": args.snr, "trials": args.trials,
                      "cells": cells,
                      "decode_seconds": secs}), flush=True)


if __name__ == "__main__":
    main()

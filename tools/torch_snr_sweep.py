"""Decode-sensitivity sweep of the PyTorch/CUDA port: how often one
``K1JT FN20 37`` signal is decoded against SNR, at each transfer format.

The counterpart of tools/snr_sweep.py in its ours-only mode: the same
windows (its seed stream, SNR points and message, synthesized by the
port's runtime/synth.py), decoded by the port's ``decode_channels`` in
slices of 128 at ``device_batch=32`` with ``fec="auto"`` (on the card:
the hybrid FEC on ops/csrc/fano.cu). With several ``--formats`` the same
windows decode at each, and each point also prints the windows whose set
of decoded messages differs between two formats and, for windows whose
spots differ beyond float rounding, which spot fields moved.

Usage: python tools/torch_snr_sweep.py [trials_per_point] [transfer_dtype]
           [--floor-trials N] [--formats int8,int16,float32] [--device DEV]
``--floor-trials`` raises the trial count to N at the sensitivity floor
(SNR <= -29 dB); ``--formats`` decodes the same windows at each format
(default: ``transfer_dtype``, int8); ``--device`` defaults to the CUDA
card (``cpu`` runs the plain PyTorch versions). ``--no-oracle`` is
accepted for the JAX tool's command line: this sweep has no oracle.
Prints a row per point and format, then one JSON line per point.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    decode_channels,
)
from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db  # noqa: E402
from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr  # noqa: E402
from torch_measure import device_banner  # noqa: E402

SNRS = [0, -15, -20, -24, -26, -28, -29, -30, -31]
MSG = "K1JT FN20 37"
SEED = 2026
FLOOR_DB = -29
SLICE = 128  # windows a decode call: bounds what is on the device
# spot fields compared between formats, with the float tolerances the
# port's decode paths are held to on the card (float rounding; chip_smoke.py
# holds its paths to this table too); the integer fields must be equal
FIELD_TOL = (("snr", 0.01), ("dt", 1 / 375), ("freq", 1e-7),
             ("sync", 1e-4), ("drift", 0), ("cycles", 0), ("jitter", 0))


def point_windows(rng: np.random.Generator, snr: float, trials: int):
    """``trials`` normalized (I, Q) windows of ``MSG`` at ``snr`` dB, each
    at a random frequency, drawn from ``rng`` as tools/snr_sweep.py
    draws them."""
    wi = np.zeros((trials, 45000), np.float32)
    wq = np.zeros((trials, 45000), np.float32)
    for t in range(trials):
        f0 = float(rng.uniform(-100, 100))
        i, q = synth_window_at_snr(MSG, snr_db=float(snr), f0=f0,
                                   seed=int(rng.integers(1 << 30)))
        wi[t], wq[t] = normalize_minus3db(i, q)
    return wi, wq


def build_windows(trials: int, floor_trials: int = 0, snrs=SNRS):
    """Yield ``(snr, wi, wq)`` point by point, from one seed stream in
    the JAX tool's order: ``trials`` windows a point,
    ``max(trials, floor_trials)`` at or below -29 dB."""
    rng = np.random.default_rng(SEED)
    for snr in snrs:
        T = max(trials, floor_trials) if snr <= FLOOR_DB else trials
        yield (snr, *point_windows(rng, snr, T))


def decode(wi, wq, transfer_dtype: str = "int8", device=None,
           fec: str = "auto"):
    """The port's spots for each window: ``decode_channels`` on slices of
    128 windows, ``device_batch=32``, FEC mode ``fec``."""
    spots = []
    for b0 in range(0, wi.shape[0], SLICE):
        spots += decode_channels(wi[b0:b0 + SLICE], wq[b0:b0 + SLICE],
                                 DecoderOptions(), device_batch=32,
                                 transfer_dtype=transfer_dtype,
                                 device=device, fec=fec)
    return spots


def found(spots) -> np.ndarray:
    """Per window: a spot with call K1JT and locator FN20."""
    return np.array([any(s.call == "K1JT" and s.loc == "FN20" for s in ch)
                     for ch in spots], bool)


def moved_fields(a, b) -> set[str]:
    """The fields in which one window's spot lists differ beyond float
    rounding (FIELD_TOL), the spots matched by message; ``message`` when
    a message is decoded in one list only."""
    ma = {s.message: s for s in a}
    mb = {s.message: s for s in b}
    moved = {"message"} if ma.keys() != mb.keys() else set()
    for m in ma.keys() & mb.keys():
        moved |= {f for f, tol in FIELD_TOL
                  if abs(getattr(ma[m], f) - getattr(mb[m], f)) > tol}
    return moved


def compare_formats(by_format: dict) -> dict:
    """For each pair of formats: the windows whose decoded message sets
    differ, the windows that differ beyond float rounding, and how many
    of those each field moved in."""
    out = {}
    fmts = list(by_format)
    for k, fa in enumerate(fmts):
        for fb in fmts[k + 1:]:
            moved = [moved_fields(a, b)
                     for a, b in zip(by_format[fa], by_format[fb])]
            counts = collections.Counter(f for m in moved for f in m)
            out[f"{fa}/{fb}"] = {
                "messages_differ": counts["message"],
                "beyond_rounding": sum(bool(m) for m in moved),
                "fields_moved": dict(sorted(counts.items())),
            }
    return out


def sweep_point(snr, wi, wq, formats=("int8",), device=None) -> dict:
    """Decode one point's windows at each format: found counts, seconds
    of each format's decode (host clock; the decode ends with its spots
    on the host), the messages other than ``MSG`` that were decoded, and
    ``compare_formats`` of the spots."""
    by_format, secs = {}, {}
    for fmt in formats:
        t0 = time.perf_counter()
        by_format[fmt] = decode(wi, wq, fmt, device)
        secs[fmt] = time.perf_counter() - t0
    return {
        "snr": snr, "trials": int(wi.shape[0]),
        "found": {f: int(found(s).sum()) for f, s in by_format.items()},
        "seconds": secs,
        "other_messages": {f: sorted({x.message for ch in s for x in ch}
                                     - {MSG})
                           for f, s in by_format.items()},
        "between_formats": compare_formats(by_format),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trials", nargs="?", type=int, default=32)
    ap.add_argument("transfer_dtype", nargs="?", default="int8")
    ap.add_argument("--floor-trials", type=int, default=0)
    ap.add_argument("--formats", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-oracle", action="store_true")
    args = ap.parse_args()
    formats = (args.formats.split(",") if args.formats
               else [args.transfer_dtype])
    print(f"device {device_banner(args.device)}")
    print(f"{'SNR dB':>7} {'ours':>9} {'rate':>6}  (formats={formats}, "
          f"trials={args.trials}"
          + (f", floor {args.floor_trials} at <={FLOOR_DB}"
             if args.floor_trials else "") + ")")
    results = []
    for snr, wi, wq in build_windows(args.trials, args.floor_trials):
        r = sweep_point(snr, wi, wq, formats, args.device)
        T = r["trials"]
        for fmt in formats:
            n = r["found"][fmt]
            print(f"{snr:>7} {n:>5}/{T:<3} {n / T:>6.3f}  {fmt}, "
                  f"{r['seconds'][fmt]:.2f} s", flush=True)
        for pair, c in r["between_formats"].items():
            print(f"        {pair}: message sets differ in "
                  f"{c['messages_differ']} windows; beyond float rounding "
                  f"in {c['beyond_rounding']}, fields {c['fields_moved']}")
        if any(r["other_messages"].values()):
            print(f"        messages other than {MSG!r}: "
                  f"{r['other_messages']}")
        results.append(r)
    for r in results:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

"""Crowded-band study of the PyTorch/CUDA port: message-level precision
and recall on dense windows.

The counterpart of tools/crowded_band.py in its ours-only mode: the same
windows (4..max_signals overlapping random type-1 transmissions each at
-25..-3 dB, >= 4 Hz apart; its seed stream and message generator, on the
port's runtime/synth.py, utils/channel.py and utils/hashtable.py),
decoded by the port's ``decode_channels`` at ``device_batch=32`` once a
config (on the card: the hybrid FEC on ops/csrc/fano.cu), and scored
against the ground truth.

Usage: python tools/torch_crowded_band.py [n_windows] [max_signals]
           [cfg,cfg,...] [--device DEV]
where each cfg is ``NPASSES`` or ``NPASSES@MAXCYCLES`` (default
``2,3``); ``--device`` defaults to the CUDA card, ``cpu`` runs the plain
PyTorch versions. Prints a summary line and one JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import os
import string
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_snr_sweep import device_banner  # noqa: E402

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    decode_channels,
)
from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db  # noqa: E402
from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr  # noqa: E402
from rtlsdr_wsprd_tpu_torch.utils.channel import (  # noqa: E402
    get_wspr_channel_symbols,
)
from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable  # noqa: E402

PWRS = [0, 3, 7, 10, 13, 17, 20, 23, 27, 30, 33, 37]
SEED = 424242


def random_message(rng: np.random.Generator, ht: WsprHashTable) -> str:
    """A random encodable type-1 message (call grid4 power)."""
    up = string.ascii_uppercase
    while True:
        call = (rng.choice(list(up)) + str(rng.integers(0, 10))
                + "".join(rng.choice(list(up))
                          for _ in range(int(rng.integers(1, 4)))))
        grid = (up[rng.integers(0, 18)] + up[rng.integers(0, 18)]
                + str(rng.integers(0, 10)) + str(rng.integers(0, 10)))
        msg = f"{call} {grid} {int(rng.choice(PWRS))}"
        if get_wspr_channel_symbols(msg, ht) is not None:
            return msg


def build_windows(n_windows: int, max_sig: int):
    """``(wi, wq, truth)``: ``n_windows`` normalized windows of 4..max_sig
    signals each and every window's set of true messages, drawn as
    tools/crowded_band.py draws them."""
    rng = np.random.default_rng(SEED)
    ht = WsprHashTable()
    wi = np.zeros((n_windows, 45000), np.float32)
    wq = np.zeros((n_windows, 45000), np.float32)
    truth: list[set[str]] = []
    for b in range(n_windows):
        k = int(rng.integers(4, max_sig + 1))
        msgs, f0s, snrs, t0s = [], [], [], []
        used_f: list[float] = []
        for _ in range(k):
            # >= 4 Hz apart so the ground truth is unambiguous (the
            # decoder dedupes one call within 3 Hz)
            for _ in range(50):
                f = float(rng.uniform(-105, 105))
                if all(abs(f - u) > 4.0 for u in used_f):
                    break
            used_f.append(f)
            msgs.append(random_message(rng, ht))
            f0s.append(f)
            snrs.append(float(rng.uniform(-25.0, -3.0)))
            t0s.append(float(rng.uniform(0.0, 4.0)))
        i, q = synth_window_at_snr(msgs, snr_db=snrs, f0=f0s, t0=t0s,
                                   seed=int(rng.integers(1 << 30)))
        wi[b], wq[b] = normalize_minus3db(i, q)
        truth.append(set(msgs))
    return wi, wq, truth


def parse_configs(text: str) -> list[tuple[int, int]]:
    """``"2,3@30000"`` -> [(2, 10000), (3, 30000)]: (npasses, maxcycles)."""
    return [(int(t.partition("@")[0]),
             int(t.partition("@")[2]) if "@" in t else 10000)
            for t in text.split(",")]


def decode(wi, wq, configs, device=None) -> dict:
    """Each window's set of decoded messages, by (npasses, maxcycles):
    ``decode_channels`` at ``device_batch=32`` once a config."""
    return {(np_, mc): [{s.message for s in ch} for ch in decode_channels(
        wi, wq, DecoderOptions(npasses=np_, maxcycles=mc), device_batch=32,
        device=device)] for np_, mc in configs}


def prf(decoded, truth):
    """(tp, fp, fn, precision, recall) of decoded message sets."""
    tp = sum(len(d & t) for d, t in zip(decoded, truth))
    fp = sum(len(d - t) for d, t in zip(decoded, truth))
    fn = sum(len(t - d) for d, t in zip(decoded, truth))
    return tp, fp, fn, tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_windows", nargs="?", type=int, default=100)
    ap.add_argument("max_signals", nargs="?", type=int, default=12)
    ap.add_argument("configs", nargs="?", default="2,3")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    configs = parse_configs(args.configs)
    print(f"device {device_banner(args.device)}")
    wi, wq, truth = build_windows(args.n_windows, args.max_signals)
    t0 = time.perf_counter()
    ours_by_cfg = decode(wi, wq, configs, args.device)
    secs = time.perf_counter() - t0
    total_true = sum(len(t) for t in truth)
    print(f"windows={args.n_windows} true-messages={total_true} "
          f"signals/window<={args.max_signals}; decoded every config in "
          f"{secs:.2f} s")
    first = ours_by_cfg[configs[0]]
    for (np_, mc), ours in ours_by_cfg.items():
        tp, fp, fn, p, r = prf(ours, truth)
        same = sum(a == b for a, b in zip(ours, first))
        print(f"ours(npasses={np_}, maxcycles={mc}): tp={tp} fp={fp} "
              f"fn={fn} precision={p:.3f} recall={r:.3f}; the first "
              f"config's message set in {same}/{args.n_windows} windows")
        print(json.dumps({"windows": args.n_windows,
                          "true_messages": total_true, "npasses": np_,
                          "maxcycles": mc, "ours_precision": round(p, 4),
                          "ours_recall": round(r, 4)}), flush=True)


if __name__ == "__main__":
    main()

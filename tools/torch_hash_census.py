"""Type-2/type-3 census of the PyTorch/CUDA port through its PIPELINED
staged path.

The counterpart of tools/hash_census.py: the same compound-call stream
(pairs of a type-2 teacher ``P/CALL pwr`` and a type-3 user
``<P/CALL> LOC6 pwr`` at batch gaps 1 and 2, a type-1 filler in every
batch, +8 dB; its seed stream, on the port's runtime/synth.py), decoded
by the port's ``decode_channels_pipelined`` (depth 2, ``device_batch=4``,
quick mode, ``usehashtable``) with and without ``strict_hash_order``.
A type-3 spot resolves when the hashtable, taught by its pair's earlier
batch, names its call.

Usage: python tools/torch_hash_census.py [n_pairs] [--device DEV]
(``--device`` defaults to the CUDA card, ``cpu`` runs the plain PyTorch
versions). Prints one JSON line per mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_snr_sweep import device_banner  # noqa: E402

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    decode_channels_pipelined,
)
from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db  # noqa: E402
from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr  # noqa: E402
from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable  # noqa: E402

PREFIXES = ["PJ4", "OH0", "TF3", "ZB2", "EA8", "VP9", "CT3", "5B4"]


def build_stream(n_pairs: int):
    """Batches of (wi, wq) plus the expected type-3 resolutions
    ``(batch, "<P/CALL>", gap)``, as tools/hash_census.py builds them.

    Pair j: its type-2 teacher decodes in batch 2j; its type-3 sits at
    batch 2j + gap, the gap alternating 1 (the pipeline's worst case) and
    2. A type-1 filler rides every batch."""
    slots: dict[int, list[str]] = {}
    expect = []
    for j in range(n_pairs):
        prefix = PREFIXES[j % len(PREFIXES)]
        call = f"K{1 + j % 9}AB{chr(ord('A') + j % 26)}"
        compound = f"{prefix}/{call}"
        teach, gap = 2 * j, 1 + j % 2
        slots.setdefault(teach, []).append(f"{compound} 37")
        slots.setdefault(teach + gap, []).append(
            f"<{compound}> FK52UD 37")
        expect.append((teach + gap, f"<{compound}>", gap))
    n_batches = max(slots) + 1
    batches = []
    rng = np.random.default_rng(99)
    for b in range(n_batches):
        msgs = slots.get(b, []) + [f"K9AN EN50 3{b % 10}"]
        wi = np.zeros((len(msgs), 45000), np.float32)
        wq = np.zeros((len(msgs), 45000), np.float32)
        for c, m in enumerate(msgs):
            i, q = synth_window_at_snr(
                m, snr_db=8.0, f0=float(rng.uniform(-80, 80)),
                seed=int(rng.integers(1 << 30)))
            wi[c], wq[c] = normalize_minus3db(i, q)
        batches.append((wi, wq))
    return batches, expect


def run(batches, expect, strict: bool, device=None) -> dict:
    """One mode's census: the stream through ``decode_channels_pipelined``
    on ``device``; type-3 spots resolved, left as ``<...>`` and not
    decoded, by gap, and the stream's total spots."""
    opts = DecoderOptions(quickmode=True, usehashtable=True)
    out = list(decode_channels_pipelined(
        iter([(wi.copy(), wq.copy()) for wi, wq in batches]), opts,
        WsprHashTable(), depth=2, device_batch=4, device=device,
        strict_hash_order=strict))
    resolved = {1: 0, 2: 0}
    hashed = {1: 0, 2: 0}
    missing = 0
    for b, call, gap in expect:
        calls = {s.call for ch in out[b] for s in ch}
        if call in calls:
            resolved[gap] += 1
        elif "<...>" in calls:
            hashed[gap] += 1
        else:
            missing += 1
    total_spots = sum(len(s) for ch in out for s in ch)
    return {
        "mode": "strict" if strict else "pipelined",
        "type3_resolved_gap1": resolved[1], "type3_hashed_gap1": hashed[1],
        "type3_resolved_gap2": resolved[2], "type3_hashed_gap2": hashed[2],
        "type3_undecoded": missing, "total_spots": total_spots,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(f"device {device_banner(args.device)}")
    batches, expect = build_stream(args.n_pairs)
    n1 = sum(1 for _, _, g in expect if g == 1)
    for strict in (False, True):
        t0 = time.perf_counter()
        r = run(batches, expect, strict, args.device)
        r["seconds"] = time.perf_counter() - t0
        r["pairs_gap1"] = n1
        r["pairs_gap2"] = len(expect) - n1
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

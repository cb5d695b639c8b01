"""Entry points with example arguments: the single-card forward step and
the multi-process dry run.

    python -m rtlsdr_wsprd_tpu_torch.entry

The port's counterpart of the JAX repo's ``__graft_entry__.py``.
``entry()`` returns the forward step of the batched multi-channel WSPR
window decoder, the dense device step ``multichannel_decode_device``
(parallel/multichannel.py), with example arguments on the card.
``dryrun_multichip`` (parallel/dryrun.py, re-exported here) runs the
decode as N gloo ranks on one device, each on its slice of the batch,
and holds the slices against the unsharded decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SIGNAL_SAMPLES
from .device import resolve_device
from .parallel.dryrun import dryrun_multichip
from .parallel.multichannel import multichannel_decode_device

B_EXAMPLE = 2        # windows of entry()'s example batch
MAX_ATTEMPTS = 64    # the forward step's attempt cap a window


def _example_batch(B: int, seed: int = 7):
    """B planar windows, window b one synthetic ``K1JT FN20 37`` at
    +5 dB and f0 = -40 + 17 b Hz plus noise, -3 dB normalized: the JAX
    repo's example batch bit for bit."""
    from .runtime.iqio import normalize_minus3db
    from .runtime.synth import synth_window_at_snr

    wi = np.zeros((B, SIGNAL_SAMPLES), dtype=np.float32)
    wq = np.zeros((B, SIGNAL_SAMPLES), dtype=np.float32)
    for b in range(B):
        i, q = synth_window_at_snr(
            "K1JT FN20 37", snr_db=5.0, f0=-40.0 + 17.0 * b,
            seed=seed + b,
        )
        wi[b], wq[b] = normalize_minus3db(i, q)
    return wi, wq


def entry(device=None):
    """(forward, example_args): the forward step on one device and its
    arguments there (``device=None``: the CUDA card; raises without one
    unless ``device="cpu"``). ``forward(sig_i, sig_q, maxdrift)`` decodes
    float32 (B, 45000) planes at ``maxdrift`` int32 (B,) into a
    ``ChannelDecode`` on their device; the arguments are B=2 example
    windows and a maxdrift of 4."""
    dev = resolve_device(device)

    def forward(sig_i, sig_q, maxdrift):
        return multichannel_decode_device(sig_i, sig_q, maxdrift,
                                          max_attempts=MAX_ATTEMPTS)

    wi, wq = _example_batch(B_EXAMPLE)
    args = (torch.from_numpy(wi).to(dev), torch.from_numpy(wq).to(dev),
            torch.full((B_EXAMPLE,), 4, dtype=torch.int32, device=dev))
    return forward, args


__all__ = ["entry", "dryrun_multichip"]


if __name__ == "__main__":
    fn, args = entry()
    res = fn(*args)
    torch.cuda.synchronize()
    print("entry() forward step OK:", {k: tuple(v.shape) for k, v in
                                       res._asdict().items()})
    ranks = dryrun_multichip(2)
    print("dryrun_multichip OK on 2 processes; kernel launches by rank",
          [r["launches"] for r in ranks])

"""A dry run of the multi-host runtime: N gloo ranks on one device.

    python -m rtlsdr_wsprd_tpu_torch.parallel.dryrun [N] [DEVICE]

The port's analogue of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``, without the dense mesh program (the port leaves
that out). ``dryrun_multichip`` spawns ``n_procs`` processes that join
one ``torch.distributed`` job (gloo, on localhost) and all work on
``device``: the CPU in the tests, ``cuda:0`` on a one-card host (the
ranks share the card). Each rank

- decodes its ``rank_slice`` of a small synthetic window batch through
  ``decode_local_shard`` (quick mode, a small Fano budget), and
- runs both time-sharded decimations (``streaming.py``) on its shard of
  a seeded stream, trading halos with its ring neighbours.

Rank 0 gathers every rank's results and holds them against the
unsharded ones: the decode of the whole batch on one device, and the
unsharded polyphase calls over the circularly extended streams (every
frame, the wrapped ones included). Any mismatch or failed rank raises.
Each rank reports the kernel launches of its own work (its shard's
decode and decimations, before rank 0's reference runs) and the
polyphase calls its sharded decimations made, by shape.
"""

from __future__ import annotations

import contextlib
import socket
import sys

import numpy as np
import torch
import torch.distributed as tdist

from ..config import DecoderOptions
from ..device import resolve_device
from ..frontend.decimate import STAGE1, STAGE2
from ..frontend.filters import R1, R2
from ..frontend.polyphase import polyphase_decimate
from .distributed import (
    decode_local_shard,
    initialize,
    rank_slice,
    shutdown,
)
from . import streaming
from .multichannel import decode_channels

MESSAGES = ("K1JT FN20 37", "K9AN EN50 33", "G4ABC IO91 30",
            "VA2GKA FN35 27")
OPTIONS = DecoderOptions(quickmode=True, maxcycles=1000)
FRAMES1, FRAMES2 = 128, 64  # stage-1 and stage-2 frames a rank


def example_batch(B: int):
    """B normalized windows, window b one strong signal of
    MESSAGES[b % 4] (the same batch on every rank)."""
    from ..runtime.iqio import normalize_minus3db
    from ..runtime.synth import synth_window_at_snr

    wi = np.zeros((B, 45000), np.float32)
    wq = np.zeros((B, 45000), np.float32)
    for b in range(B):
        i, q = synth_window_at_snr(MESSAGES[b % len(MESSAGES)], snr_db=5.0,
                                   f0=-70.0 + 40.0 * (b % 4), seed=100 + b)
        wi[b], wq[b] = normalize_minus3db(i, q)
    return wi, wq


def _streams(n: int):
    """The seeded raw (stage 1) and mid-rate (stage 2) streams of an
    n-rank job, float32 planes (2, L)."""
    rng = np.random.default_rng(42)
    return (rng.normal(0, 30, (2, n * FRAMES1 * R1)).astype(np.float32),
            rng.normal(0, 1, (2, n * FRAMES2 * R2)).astype(np.float32))


def _spot_fields(per_channel):
    return [[(s.message, s.jitter, s.cycles, round(s.freq, 6),
              round(s.dt, 3)) for s in ch] for ch in per_channel]


def _circular(x: np.ndarray, filt, dev: torch.device):
    """The unsharded stage over the stream extended by its own head:
    every frame of the sharded ring, the wrapped ones included."""
    ext = np.concatenate([x, x[:, :filt.T - filt.R]], axis=1)
    yI, yQ = polyphase_decimate(torch.from_numpy(ext[0]).to(dev),
                                torch.from_numpy(ext[1]).to(dev), filt,
                                x.shape[1] // filt.R)
    return np.stack([yI.cpu().numpy(), yQ.cpu().numpy()])


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel."""
    from ..ops.fano import batched_fano

    return dict(polyphase_decimate.launches, fano=batched_fano.launches)


@contextlib.contextmanager
def _noted_shard_calls():
    """Count the polyphase calls the time-sharded decimations make inside
    the block by (stage, input dtype, rows, samples, frames); the
    wrapper, which counts the launches, runs unchanged underneath."""
    calls: dict[tuple, int] = {}

    def noting(xI, xQ, filt, n_frames):
        key = ("stage1" if filt is STAGE1 else "stage2",
               str(xI.dtype).removeprefix("torch."),
               *(xI.shape if xI.dim() == 2 else (1, *xI.shape)), n_frames)
        calls[key] = calls.get(key, 0) + 1
        return polyphase_decimate(xI, xQ, filt, n_frames)

    streaming.polyphase_decimate = noting
    try:
        yield calls
    finally:
        streaming.polyphase_decimate = polyphase_decimate


def _rank_work(rank: int, n: int, dev: torch.device) -> dict:
    B = 2 * n
    wi, wq = example_batch(B)
    sl = rank_slice(B)
    spots = decode_local_shard(wi[sl], wq[sl], OPTIONS, device_batch=2,
                               device=dev)
    x1, x2 = _streams(n)
    ys = []
    with _noted_shard_calls() as calls:
        for x, frames, filt, fn in (
                (x1, FRAMES1, STAGE1, streaming.decimate_stage1_sharded),
                (x2, FRAMES2, STAGE2, streaming.decimate_stage2_sharded)):
            part = x[:, rank * frames * filt.R:(rank + 1) * frames * filt.R]
            yI, yQ = fn(torch.from_numpy(part[0]).to(dev),
                        torch.from_numpy(part[1]).to(dev))
            ys.append(np.stack([yI.cpu().numpy(), yQ.cpu().numpy()]))
    mine = dict(launches=launch_counts(), calls=calls)
    got = [None] * n if rank == 0 else None
    tdist.gather_object((sl.start, sl.stop, _spot_fields(spots), ys), got,
                        dst=0)
    if rank != 0:
        return mine
    starts = [g[0] for g in got] + [got[-1][1]]
    if starts[0] != 0 or starts[-1] != B or any(
            g[1] != starts[k + 1] for k, g in enumerate(got)):
        raise RuntimeError(f"rank slices do not tile the batch: "
                           f"{[(g[0], g[1]) for g in got]}")
    sharded = [ch for g in got for ch in g[2]]
    whole = _spot_fields(decode_channels(wi, wq, OPTIONS, device_batch=2,
                                         device=dev))
    if sharded != whole:
        raise RuntimeError(f"sharded decode {sharded} != unsharded {whole}")
    want_msgs = [[MESSAGES[b % len(MESSAGES)]] for b in range(B)]
    if [[s[0] for s in ch] for ch in sharded] != want_msgs:
        raise RuntimeError(f"decoded {sharded}, want {want_msgs}")
    for k, (x, filt) in enumerate(((x1, STAGE1), (x2, STAGE2))):
        y = np.concatenate([g[3][k] for g in got], axis=1)
        ref = _circular(x, filt, dev)
        err = float(np.abs(y - ref).max())
        if y.shape != ref.shape or not err <= 1e-4 * float(
                np.abs(ref).max()):
            raise RuntimeError(f"sharded stage {k + 1} differs from the "
                               f"unsharded one: max |diff| {err}")
    return mine


def _rank_main(rank: int, n: int, port: int, device: str, results) -> None:
    initialize(f"127.0.0.1:{port}", n, rank)
    try:
        results.put((rank, _rank_work(rank, n, torch.device(device))))
    finally:
        shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_procs: int = 2, device=None) -> list[dict]:
    """Run ``n_procs`` ranks on ``device`` (None: the CUDA card) as the
    module docstring says. Returns, in rank order, each rank's
    ``{"launches": {kernel: n}, "calls": {(stage, dtype, rows, samples,
    frames): n}}`` once every rank has finished and rank 0's checks
    passed; raises otherwise (the other ranks are stopped)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    results = torch.multiprocessing.get_context("spawn").SimpleQueue()
    torch.multiprocessing.spawn(
        _rank_main, args=(n_procs, _free_port(), str(dev), results),
        nprocs=n_procs, join=True)
    got = dict(results.get() for _ in range(n_procs))
    return [got[r] for r in range(n_procs)]


if __name__ == "__main__":
    ranks = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                             sys.argv[2] if len(sys.argv) > 2 else None)
    print("dryrun_multichip: OK; kernel launches by rank "
          f"{[r['launches'] for r in ranks]}")

"""Sequence-parallel streaming front end: time-axis sharding with an
overlap-save halo exchange between ranks.

The port's counterpart of ``rtlsdr_wsprd_tpu/parallel/streaming.py``.
When one stream outgrows one device's ingest, the scaling axis is time:
each rank holds a contiguous shard of the sample axis, sends the first
(taps - R) samples of its shard to its left ring neighbour (one
send/recv pair over ``torch.distributed``, on host tensors: gloo), and
runs the same local polyphase call (``frontend/polyphase.py``, a
hand-written kernel on the card) over [shard, halo] on its own device.

Results equal the unsharded decimation except the last (taps/R - 1)
frames of the last shard, whose halo wraps circularly to the first
shard's head, as in the JAX package's ``shard_map`` ring; callers pad
the input or drop them (``valid_frames`` says how many are exact).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from ..frontend.decimate import STAGE1, STAGE2
from ..frontend.filters import R1, R2, STAGE1_TAPS, STAGE2_TAPS
from ..frontend.polyphase import polyphase_decimate


def valid_frames(total_samples: int) -> int:
    """Stage-1 frames whose inputs never wrap past the stream end."""
    return (total_samples - (STAGE1_TAPS - R1)) // R1


def valid_frames_stage2(total_mid: int) -> int:
    """Stage-2 frames whose inputs never wrap past the mid-stream end."""
    return (total_mid - (STAGE2_TAPS - R2)) // R2


def _halo_from_right(xI: torch.Tensor, xQ: torch.Tensor, halo: int, group):
    """The right ring neighbour's first ``halo`` samples of each plane,
    this rank's own head sent to its left neighbour meanwhile; with one
    rank, this rank's own head (the ring of one)."""
    n = tdist.get_world_size(group)
    head = torch.stack([xI[:halo], xQ[:halo]])
    if n == 1:
        return head[0], head[1]
    r = tdist.get_rank(group)
    send = head.cpu()
    recv = torch.empty_like(send)

    def peer(k):
        return k if group is None else tdist.get_global_rank(group, k)

    ops = [tdist.P2POp(tdist.isend, send, peer((r - 1) % n), group),
           tdist.P2POp(tdist.irecv, recv, peer((r + 1) % n), group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    recv = recv.to(xI.device)
    return recv[0], recv[1]


def _sharded(xI, xQ, filt, group, what: str):
    L = xI.shape[0]
    R = filt.R
    halo = filt.T - R
    if xI.dim() != 1 or xI.shape != xQ.shape or L % R:
        raise ValueError(f"{what}: want two 1-D planes of a multiple of "
                         f"{R} samples, got {tuple(xI.shape)}, "
                         f"{tuple(xQ.shape)}")
    frames_local = L // R
    # single-hop halo: each shard must hold at least the filter tail
    if L < halo:
        n = tdist.get_world_size(group)
        raise ValueError(f"shard too short for the {what} halo: {L} local "
                         f"samples < {halo}; need >= {n * (halo + R)} total")
    hI, hQ = _halo_from_right(xI, xQ, halo, group)
    return polyphase_decimate(torch.cat([xI, hI]), torch.cat([xQ, hQ]),
                              filt, frames_local)


def decimate_stage1_sharded(xI: torch.Tensor, xQ: torch.Tensor,
                            group=None):
    """Stage-1 polyphase over a time-sharded raw stream.

    xI/xQ: THIS rank's shard, float32 (or uint8) [L_local] with L_local
    a multiple of R1, on this rank's device; ``group``: the ranks that
    hold the stream in order (None: the default group). Returns this
    rank's planar float32 [L_local / R1] frames; the stream's trailing
    (STAGE1_TAPS/R1 - 1) frames wrap circularly (module docstring)."""
    return _sharded(xI, xQ, STAGE1, group, "stage-1")


def decimate_stage2_sharded(midI: torch.Tensor, midQ: torch.Tensor,
                            group=None):
    """Stage-2 polyphase over a time-sharded 30 ksps mid-rate stream:
    the same halo exchange with the stage-2 tail (STAGE2_TAPS - R2 =
    2320 mid samples). midI/midQ: this rank's float32 [M_local] shard,
    M_local a multiple of R2. Returns this rank's [M_local / R2] frames;
    the trailing (STAGE2_TAPS/R2 - 1) frames wrap circularly. Chaining
    both stages keeps one stream sequence-parallel from raw 2.4 Msps to
    375 sps baseband."""
    return _sharded(midI, midQ, STAGE2, group, "stage-2")


__all__ = ["valid_frames", "valid_frames_stage2", "decimate_stage1_sharded",
           "decimate_stage2_sharded"]

"""Two-stage polyphase decimation, 2.4 Msps -> 30 ksps -> 375 sps.

The PyTorch counterpart of ``rtlsdr_wsprd_tpu/frontend/decimate.py``.
Both stages go through ``polyphase.polyphase_decimate``: on the card
that is a hand-written CUDA kernel (the tensor-core one for uint8
stage 1, the direct form for the rest), on the CPU the plain version.
uint8 RTL bytes are centred inside the stage-1 call (in the kernel, on
load), so raw bytes cross the host->device link at 1 byte/sample.

Time alignment, work quanta and carries are those of the JAX package:
half a filter of priming so output m ~ input time m*6400, and float32
tails of T - R samples carried between pushes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .filters import (
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
    conv_order,
    stage1_coeffs,
    stage2_coeffs,
)
from .polyphase import PolyphaseFilter, polyphase_decimate

STAGE1 = PolyphaseFilter(conv_order(stage1_coeffs()), R1)
STAGE2 = PolyphaseFilter(conv_order(stage2_coeffs().astype(np.complex64)), R2)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def decimate_stage1(xI, xQ, n_frames: int, device=None):
    """2.4 Msps planar float32 (or raw uint8) -> 30 ksps planar float32
    tensors (fs/4 mix folded in). Input length must be at least
    n_frames*R1 + STAGE1_TAPS - R1; a leading channel dim is allowed."""
    dev = resolve_device(device)
    return polyphase_decimate(_as_tensor(xI, dev), _as_tensor(xQ, dev),
                              STAGE1, n_frames)


def decimate_stage2(midI, midQ, n_frames: int, device=None):
    """30 ksps planar -> 375 sps planar float32 tensors. Input length must
    be at least n_frames*R2 + STAGE2_TAPS - R2; a leading channel dim is
    allowed."""
    dev = resolve_device(device)
    return polyphase_decimate(_as_tensor(midI, dev), _as_tensor(midQ, dev),
                              STAGE2, n_frames)


def decimate_window(rawI: np.ndarray, rawQ: np.ndarray,
                    n_out: int | None = None, device=None):
    """One-shot 2.4 Msps -> 375 sps planar (I, Q) numpy for a whole
    capture (uint8 or float). Output is time-aligned so out[m] ~ input
    time m*6400 (half-filter priming)."""
    dev = resolve_device(device)
    L = rawI.shape[0]
    prime1 = STAGE1_TAPS // 2
    xI = np.zeros(L + prime1, np.float32)
    xQ = np.zeros(L + prime1, np.float32)
    if rawI.dtype == np.uint8:
        xI[prime1:] = rawI.astype(np.float32) - 128.0
        xQ[prime1:] = rawQ.astype(np.float32) - 128.0
    else:
        xI[prime1:] = rawI.astype(np.float32)
        xQ[prime1:] = rawQ.astype(np.float32)
    n_mid = (xI.shape[0] - (STAGE1_TAPS - R1)) // R1
    midI, midQ = decimate_stage1(xI, xQ, n_mid, device=dev)

    prime2 = STAGE2_TAPS // 2
    z = torch.zeros(prime2, dtype=torch.float32, device=dev)
    midI = torch.cat([z, midI])
    midQ = torch.cat([z, midQ])
    n_final = (midI.shape[0] - (STAGE2_TAPS - R2)) // R2
    if n_out is not None:
        n_final = min(n_final, n_out)
    outI, outQ = decimate_stage2(midI, midQ, n_final, device=dev)
    return outI.cpu().numpy(), outQ.cpu().numpy()


class StreamingDecimator:
    """Stateful overlap-save streaming front end for one channel.

    float32 tails of (STAGE1_TAPS - R1) input samples and
    (STAGE2_TAPS - R2) mid-rate samples carry across pushes, primed with
    half a filter of zeros. ``push`` takes arbitrary-size planar chunks
    and returns whatever 375 sps samples became available (numpy)."""

    QUANT1 = 7500   # stage-1 output frames per call (0.25 s of mid-rate)
    QUANT2 = 125    # stage-2 output frames per call (1/3 s of baseband)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._bufI = np.zeros(STAGE1_TAPS // 2, np.float32)
        self._bufQ = np.zeros(STAGE1_TAPS // 2, np.float32)
        self._midI = np.zeros(STAGE2_TAPS // 2, np.float32)
        self._midQ = np.zeros(STAGE2_TAPS // 2, np.float32)
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Feed a chunk; returns newly available planar 375 sps samples.
        ``exact=True`` (flush) processes every whole frame available
        instead of whole work quanta."""
        if rawI.dtype == np.uint8:
            fI = rawI.astype(np.float32) - 128.0
            fQ = rawQ.astype(np.float32) - 128.0
        else:
            fI = rawI.astype(np.float32)
            fQ = rawQ.astype(np.float32)
        self._bufI = np.concatenate([self._bufI, fI])
        self._bufQ = np.concatenate([self._bufQ, fQ])

        n_mid = (self._bufI.shape[0] - self._tail1) // R1
        if not exact:
            n_mid -= n_mid % self.QUANT1
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            mi, mq = decimate_stage1(self._bufI[:need], self._bufQ[:need],
                                     n_mid, device=self.device)
            self._bufI = self._bufI[n_mid * R1:]
            self._bufQ = self._bufQ[n_mid * R1:]
            self._midI = np.concatenate([self._midI, mi.cpu().numpy()])
            self._midQ = np.concatenate([self._midQ, mq.cpu().numpy()])

        n_out = (self._midI.shape[0] - self._tail2) // R2
        if not exact:
            n_out -= n_out % self.QUANT2
        if n_out <= 0:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        need2 = n_out * R2 + self._tail2
        oi, oq = decimate_stage2(self._midI[:need2], self._midQ[:need2],
                                 n_out, device=self.device)
        self._midI = self._midI[n_out * R2:]
        self._midQ = self._midQ[n_out * R2:]
        return oi.cpu().numpy(), oq.cpu().numpy()

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        return self.push(np.zeros(0, np.float32), np.zeros(0, np.float32),
                         exact=True)


def _fused_frontend_step(rawI: torch.Tensor, rawQ: torch.Tensor,
                         m2I: torch.Tensor, m2Q: torch.Tensor, n_mid: int):
    """One stage-1 + stage-2 device step for C channels.

    rawI/rawQ: uint8|float32 (C, n_mid*R1 + tail1) device chunk;
    m2I/m2Q: float32 (C, m) device-resident mid-rate carry. Returns
    (outI, outQ, new m2I, new m2Q); the 30 ksps intermediate never
    leaves the device."""
    tail2 = STAGE2_TAPS - R2
    mi, mq = polyphase_decimate(rawI, rawQ, STAGE1, n_mid)
    midI = torch.cat([m2I, mi], dim=1)
    midQ = torch.cat([m2Q, mq], dim=1)
    n_out = (midI.shape[1] - tail2) // R2
    need2 = n_out * R2
    oi, oq = polyphase_decimate(midI, midQ, STAGE2, n_out)
    return oi, oq, midI[:, need2:].contiguous(), midQ[:, need2:].contiguous()


class BatchedStreamingDecimator:
    """Stateful streaming front end for C channels in lockstep.

    Every channel receives the same-size chunk each ``push``; one fused
    stage-1 + stage-2 step advances every stream, and the mid-rate carry
    stays on the device. uint8 chunks stay uint8 on the host and across
    the link (centred by the stage-1 kernel). Per-row math is that of
    StreamingDecimator; outputs are (C, m) numpy planes."""

    # stage-1 output frames per fused step; a multiple of R2 keeps the
    # device mid carry at a fixed tail2 length
    QUANT1 = 8000

    def __init__(self, n_channels: int, device=None):
        self.device = resolve_device(device)
        C = n_channels
        self._C = C
        self._prime1 = STAGE1_TAPS // 2
        self._bufI: np.ndarray | None = None
        self._bufQ: np.ndarray | None = None
        self._m2I = torch.zeros((C, STAGE2_TAPS // 2), dtype=torch.float32,
                                device=self.device)
        self._m2Q = torch.zeros_like(self._m2I)
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2

    def _prime_raw(self, dtype) -> None:
        fill = 128 if dtype == np.uint8 else 0
        self._bufI = np.full((self._C, self._prime1), fill, dtype)
        self._bufQ = np.full((self._C, self._prime1), fill, dtype)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Feed (C, n) planar chunks (uint8 or float); returns newly
        available (C, m) planar 375 sps samples (m can be 0)."""
        in_dtype = np.uint8 if rawI.dtype == np.uint8 else np.float32
        if self._bufI is None:
            self._prime_raw(in_dtype)
        if in_dtype != self._bufI.dtype and rawI.size > 0:
            if self._bufI.dtype == np.uint8:  # upconvert the carry once
                self._bufI = self._bufI.astype(np.float32) - 128.0
                self._bufQ = self._bufQ.astype(np.float32) - 128.0
            else:  # float carry continues; centre incoming u8 on host
                rawI = rawI.astype(np.float32) - 128.0
                rawQ = rawQ.astype(np.float32) - 128.0
        if rawI.size > 0:
            self._bufI = np.concatenate(
                [self._bufI, np.asarray(rawI, self._bufI.dtype)], axis=1)
            self._bufQ = np.concatenate(
                [self._bufQ, np.asarray(rawQ, self._bufQ.dtype)], axis=1)

        C = self._bufI.shape[0]
        empty = (np.zeros((C, 0), np.float32), np.zeros((C, 0), np.float32))
        n_mid = (self._bufI.shape[1] - self._tail1) // R1
        if not exact:
            n_mid -= n_mid % self.QUANT1
            if n_mid <= 0:
                return empty
            need = n_mid * R1 + self._tail1
            oi, oq, self._m2I, self._m2Q = _fused_frontend_step(
                self._upload(self._bufI[:, :need]),
                self._upload(self._bufQ[:, :need]),
                self._m2I, self._m2Q, n_mid)
            self._bufI = self._bufI[:, n_mid * R1:]
            self._bufQ = self._bufQ[:, n_mid * R1:]
            return oi.cpu().numpy(), oq.cpu().numpy()

        # exact (flush) path: arbitrary remainder sizes
        midI, midQ = self._m2I, self._m2Q
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            mi, mq = polyphase_decimate(
                self._upload(self._bufI[:, :need]),
                self._upload(self._bufQ[:, :need]), STAGE1, n_mid)
            self._bufI = self._bufI[:, n_mid * R1:]
            self._bufQ = self._bufQ[:, n_mid * R1:]
            midI = torch.cat([midI, mi], dim=1)
            midQ = torch.cat([midQ, mq], dim=1)
        n_out = (midI.shape[1] - self._tail2) // R2
        if n_out <= 0:
            self._m2I, self._m2Q = midI, midQ
            return empty
        oi, oq = polyphase_decimate(midI, midQ, STAGE2, n_out)
        self._m2I = midI[:, n_out * R2:].contiguous()
        self._m2Q = midQ[:, n_out * R2:].contiguous()
        return oi.cpu().numpy(), oq.cpu().numpy()

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        C = self._C
        return self.push(np.zeros((C, 0), np.float32),
                         np.zeros((C, 0), np.float32), exact=True)

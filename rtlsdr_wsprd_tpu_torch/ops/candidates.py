"""Noise floor estimation and candidate peak picking (wsprd/wsprd.c:555-631).

7-point boxcar smoothing of the average spectrum over the centre
+/-150 Hz, a 30th-percentile noise floor (the 122nd of 411 sorted
values, no interpolation), SNR renormalization, local-maxima masking,
and a STABLE descending sort into a fixed-size candidate tensor with a
validity mask. A leading batch dimension is allowed throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import DF, MAX_CANDIDATES

SMSPEC_BINS = 411          # center bins, +/-150 Hz (wsprd/wsprd.c:564-573)
NOISE_PERCENTILE_IDX = 122  # 30th percentile of 411 (wsprd/wsprd.c:582)
SNR_SCALING = 26.3         # wspr bw -> 2500 Hz bw (wsprd/wsprd.c:591)
MIN_SNR = 10.0 ** (-8.0 / 10.0)  # -8 dB floor (wsprd/wsprd.c:590)


class Candidates(NamedTuple):
    """Fixed-size candidate set, sorted by SNR descending."""

    bin_idx: torch.Tensor  # int32[..., MAX_CANDIDATES] smspec bin j (0..410)
    freq: torch.Tensor     # float32[..., MAX_CANDIDATES] (j-205)*DF/2, Hz
    snr: torch.Tensor      # float32[..., MAX_CANDIDATES] dB
    valid: torch.Tensor    # bool[..., MAX_CANDIDATES]


def smoothed_spectrum(ps: torch.Tensor) -> torch.Tensor:
    """ps (..., 512, BLOCKS) -> renormalized smoothed spectrum (..., 411)."""
    psavg = ps.sum(dim=-1)
    base = 256 - 205
    smspec = psavg[..., base - 3:base - 3 + SMSPEC_BINS]
    for t in range(1, 7):
        smspec = smspec + psavg[..., base - 3 + t:base - 3 + t + SMSPEC_BINS]
    noise_level = torch.sort(smspec, dim=-1).values[
        ..., NOISE_PERCENTILE_IDX:NOISE_PERCENTILE_IDX + 1]
    smspec = smspec / noise_level - 1.0
    return torch.where(smspec < MIN_SNR,
                       torch.full_like(smspec, 0.1 * MIN_SNR), smspec)


def find_candidates(ps: torch.Tensor, fmin: float = -110.0,
                    fmax: float = 110.0) -> Candidates:
    """Pick up to MAX_CANDIDATES local maxima (wsprd/wsprd.c:599-631):
    the first 200 local maxima in bin order are kept (the cap applies
    before band filtering), candidates outside [fmin, fmax] are dropped,
    and the survivors are sorted by SNR descending, stably."""
    smspec = smoothed_spectrum(ps)
    dev = smspec.device
    j = torch.arange(SMSPEC_BINS, device=dev)
    interior = (j >= 1) & (j <= SMSPEC_BINS - 2)
    left = torch.roll(smspec, 1, dims=-1)
    right = torch.roll(smspec, -1, dims=-1)
    is_peak = interior & (smspec > left) & (smspec > right)
    order_rank = torch.cumsum(is_peak.to(torch.int32), dim=-1) - 1
    is_peak = is_peak & (order_rank < MAX_CANDIDATES)

    freq = (j - 205).to(torch.float32) * (DF / 2.0)
    in_band = (freq >= fmin) & (freq <= fmax)
    valid = is_peak & in_band

    snr = 10.0 * torch.log10(smspec) - SNR_SCALING

    key = torch.where(valid, -snr, torch.full_like(snr, math.inf))
    perm = torch.sort(key, dim=-1, stable=True).indices[..., :MAX_CANDIDATES]
    return Candidates(
        bin_idx=perm.to(torch.int32),
        freq=freq[perm],
        snr=torch.gather(snr, -1, perm),
        valid=torch.gather(valid, -1, perm),
    )

"""The decoded-spot record, the dense per-window decoder and the decoder
facade.

``Spot`` is the reference's struct decoder_results (wsprd/wsprd.h:62-74).

``decode_window`` is the JAX package's dense per-window formulation of
the reference's ``wspr_decode`` (wsprd/wsprd.c:416-855). Per pass:

  device:  STFT power spectrogram -> candidate pick -> coarse (freq,
           lag, drift) grid -> fine lag + freq sync -> mode-2 soft
           symbols for the full jitter schedule, over all 200
           candidate slots (``_analyze_pass``)
  host:    gate (minsync1/minsync2/rms), compact the attempts
           candidate-major in the reference's jitter order
  device:  deinterleave + one Fano call over every attempt at the
           calibrated device budget, padded to a bucket (``_fano_batch``);
           the host finishes the stragglers at the full budget
  host:    first success per candidate, unpack, dedupe (same call
           within 3 Hz)
  device:  coherent subtraction of each new unique decode
           (``subtract_signal2``)

It keeps the JAX package's documented divergences from the reference:
subtraction between passes (not within one), a candidate whose message
fails to unpack or re-encode is skipped, and duplicate decodes are
deduped before subtraction.

``WsprDecoder`` owns the options and the persistent callsign hashtable.
It decodes one window through the staged multi-channel path
(parallel/multichannel.py) with a batch of one, or, with
``staged=False``, through ``decode_window``; the single-channel daemon
(runtime/scheduler.py) and the CLI's ``-t``/``-r`` decode through it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import DT, MAX_UNIQUES, SIGNAL_SAMPLES, DecoderOptions
from ..device import const, resolve_device
from ..ops.calibrate import device_fano_budget
from ..ops.candidates import find_candidates
from ..ops.coarse import coarse_search
from ..ops.fano import batched_fano, device_mettab
from ..ops.fano_hybrid import host_finish, pending_mask
from ..ops.stft import power_spectrogram
from ..ops.subtract import subtract_signal2
from ..ops.sync import fine_sync, jitter_offsets, soft_symbols_jittered
from ..utils.channel import INTERLEAVE_PERM, get_wspr_channel_symbols
from ..utils.codec import unpack_message
from ..utils.hashtable import WsprHashTable

_PERM = np.asarray(INTERLEAVE_PERM, np.int64)

# attempt-batch padding buckets of the per-window Fano call (the JAX
# package's, where they bound recompiles; here they bound the distinct
# launch shapes)
_FANO_BUCKETS = (64, 256, 1024, 4096, 8704)


@dataclass
class Spot:
    """One decoded transmission (wsprd/wsprd.h:62-74)."""

    freq: float      # printed frequency, MHz (dial + (1500+f)/1e6)
    sync: float
    snr: float       # dB
    dt: float        # s (shift*DT - 2.0)
    drift: float
    jitter: int
    message: str
    call: str
    loc: str
    pwr: str
    cycles: int
    noprint: bool = False
    ihash: int = -1  # type-3 spots: the 15-bit hash behind ``call``


def _analyze_pass(sig_i: torch.Tensor, sig_q: torch.Tensor, maxdrift: int,
                  fmin: float, fmax: float, lagstep: int, iifac: int,
                  quickmode: bool, symfac: int):
    """Device part of one pass, everything up to (not including) the Fano
    search, for one window's (N,) planes: (cand, coarse, fine, jit), the
    per-candidate fields (C,) and the soft symbols (J, C, 162)."""
    ps = power_spectrogram(sig_i[None], sig_q[None])
    cand = find_candidates(ps, fmin, fmax)
    md = torch.full((1,), maxdrift, dtype=torch.int32, device=sig_i.device)
    coarse = coarse_search(ps, cand.bin_idx, md)
    cand = type(cand)(*(x[0] for x in cand))
    coarse = type(coarse)(*(x[0] for x in coarse))
    fine = fine_sync(sig_i, sig_q, coarse.freq, coarse.shift, coarse.drift,
                     lagstep=lagstep)
    jit = soft_symbols_jittered(sig_i, sig_q, fine.freq, fine.shift,
                                coarse.drift, iifac=iifac,
                                quickmode=quickmode, symfac=symfac)
    return cand, coarse, fine, jit


def _fano_batch(symbols: torch.Tensor, valid: torch.Tensor, delta: int = 60,
                maxcycles: int = 10000):
    """One Fano call over interleaved soft symbols uint8 (N, 162): the
    deinterleave, then ``batched_fano`` on their device."""
    dev = symbols.device
    return batched_fano(symbols[:, const(_PERM, dev)], device_mettab(dev),
                        delta=delta, maxcycles=maxcycles, valid=valid)


def decode_window(
    i_samples: np.ndarray,
    q_samples: np.ndarray,
    options: DecoderOptions = DecoderOptions(),
    hashtable: WsprHashTable | None = None,
    device=None,
) -> list[Spot]:
    """Decode one 120 s window -> list of Spots sorted by SNR descending,
    on ``device`` (None: the CUDA card).

    ``i_samples``/``q_samples`` are the normalized float32 window (the
    callers apply the -3 dB normalization, as in the reference)."""
    dev = resolve_device(device)
    ht = hashtable if hashtable is not None else WsprHashTable()
    if np.shape(i_samples) != (SIGNAL_SAMPLES,) or \
            np.shape(q_samples) != (SIGNAL_SAMPLES,):
        raise ValueError(f"a window is two ({SIGNAL_SAMPLES},) planes, got "
                         f"{np.shape(i_samples)}, {np.shape(q_samples)}")
    sig_i = torch.from_numpy(np.array(i_samples, np.float32)).to(dev)
    sig_q = torch.from_numpy(np.array(q_samples, np.float32)).to(dev)

    lagstep = 16 if options.quickmode else 8
    jit_offsets = jitter_offsets(options.iifac, options.quickmode)

    uniques: list[Spot] = []
    seen: list[tuple[str, float]] = []  # (callsign, baseband freq Hz)

    for ipass in range(options.npasses):
        if ipass == 1 and not uniques:
            break  # wsprd/wsprd.c:522
        maxdrift = options.maxdrift if ipass < 2 else 0
        minsync2 = options.minsync2 if ipass < 2 else 0.10

        cand, coarse, fine, jit = _analyze_pass(
            sig_i, sig_q, maxdrift, options.fmin, options.fmax, lagstep,
            options.iifac, options.quickmode, options.symfac)
        valid = cand.valid.cpu().numpy()
        snr = cand.snr.cpu().numpy()
        sync_fine = fine.sync.cpu().numpy()
        freq_fine = fine.freq.cpu().numpy()
        shift_fine = fine.shift.cpu().numpy()
        drift_c = coarse.drift.cpu().numpy()
        sync2 = jit.sync.cpu().numpy()      # (J, C)
        rms = jit.rms.cpu().numpy()         # (J, C)

        worth = valid & (sync_fine > options.minsync1)  # wsprd/wsprd.c:733
        gate = (sync2 > minsync2) & (rms > options.minrms)  # :758

        # (candidate, jitter) attempts, candidate-major in the
        # reference's jitter order, at most the largest bucket
        attempts = [(int(c), int(j)) for c in np.nonzero(worth)[0]
                    for j in np.nonzero(gate[:, c])[0]]
        attempts = attempts[:_FANO_BUCKETS[-1]]

        decoded: dict[int, tuple[int, bytes, int]] = {}
        if attempts:
            n = len(attempts)
            bucket = next(b for b in _FANO_BUCKETS if b >= n)
            cs = torch.as_tensor([c for c, _ in attempts], device=dev)
            js = torch.as_tensor([j for _, j in attempts], device=dev)
            batch = torch.zeros((bucket, 162), dtype=torch.uint8, device=dev)
            batch[:n] = jit.symbols[js, cs]
            live = torch.arange(bucket, device=dev) < n
            # hybrid FEC: the calibrated device budget, the host
            # finishes the stragglers bit-exactly (ops/fano_hybrid.py)
            dev_mc = device_fano_budget(options.maxcycles, dev)
            res = _fano_batch(batch, live, delta=options.delta,
                              maxcycles=dev_mc)
            success = res.success.cpu().numpy()
            data = res.data.cpu().numpy()
            cycles = res.cycles.cpu().numpy()
            pend = pending_mask(success, cycles, dev_mc, options.maxcycles)
            pend[n:] = False
            if pend.any():
                deint = batch.cpu().numpy()[:, _PERM]
                success, data, cycles = host_finish(
                    deint, success, data, cycles, pend, options.delta,
                    options.maxcycles)
            for a, (c, j) in enumerate(attempts):
                if success[a] and c not in decoded:
                    decoded[c] = (j, bytes(data[a]), int(cycles[a]))

        # host: unpack, dedupe, collect spots (wsprd/wsprd.c:768-822)
        new_decodes = []
        for c in np.nonzero(worth)[0]:
            if int(c) not in decoded:
                continue
            j, data, cycles = decoded[int(c)]
            msg = unpack_message(
                [b if b < 128 else b - 256 for b in data[:11]], ht)
            if msg is None or msg.loc == "A000AA":
                continue  # divergences: the reference emits / breaks
            if any(msg.callsign == s_call
                   and abs(freq_fine[c] - s_freq) < 3.0
                   for s_call, s_freq in seen):
                continue
            if len(uniques) >= MAX_UNIQUES:
                break  # result buffer bound (wsprd/wsprd.h:41)
            seen.append((msg.callsign, float(freq_fine[c])))
            uniques.append(Spot(
                freq=options.freq / 1e6 + (1500.0 + float(freq_fine[c])) / 1e6,
                sync=float(sync_fine[c]),
                snr=float(snr[c]),
                dt=float(shift_fine[c]) * DT - 2.0,
                drift=float(drift_c[c]),
                jitter=int(jit_offsets[j]),
                message=msg.call_loc_pow,
                call=msg.call, loc=msg.loc, pwr=msg.pwr,
                cycles=cycles, noprint=msg.noprint, ihash=msg.ihash,
            ))
            if options.subtraction and ipass == 0 and not msg.noprint:
                new_decodes.append((c, msg.call_loc_pow))

        # device: coherent subtraction of the new uniques, in candidate
        # (SNR-descending) order
        for c, call_loc_pow in new_decodes:
            chan_syms = get_wspr_channel_symbols(call_loc_pow, ht)
            if chan_syms is None:
                continue  # divergence: the reference breaks the loop
            ni, nq = subtract_signal2(
                sig_i[None], sig_q[None],
                torch.tensor([freq_fine[c]], dtype=torch.float32, device=dev),
                torch.tensor([shift_fine[c]], dtype=torch.int32, device=dev),
                torch.tensor([drift_c[c]], dtype=torch.float32, device=dev),
                torch.as_tensor(np.asarray(chan_syms, np.uint8)[None],
                                device=dev))
            sig_i, sig_q = ni[0], nq[0]

    uniques.sort(key=lambda s: -s.snr)  # wsprd/wsprd.c:826-827
    return uniques


class WsprDecoder:
    """Options + the persistent hashtable; ``decode`` runs one window on
    ``device`` (None = the CUDA card) through the staged path
    (``staged=True``, the production program) or ``decode_window``
    (``staged=False``, the dense per-window formulation)."""

    def __init__(self, options: DecoderOptions = DecoderOptions(),
                 hashtable_path: str = "hashtable.txt", staged: bool = True,
                 device=None):
        self.options = options
        self.hashtable_path = hashtable_path
        self.staged = staged
        self.device = resolve_device(device)
        if options.usehashtable:
            self.hashtable = WsprHashTable.load(hashtable_path)
        else:
            self.hashtable = WsprHashTable()

    def decode(self, i_samples: np.ndarray,
               q_samples: np.ndarray) -> list[Spot]:
        if self.staged:
            from ..parallel.multichannel import decode_channels

            spots = decode_channels(
                i_samples[None, :], q_samples[None, :], self.options,
                self.hashtable, device_batch=1, device=self.device)[0]
        else:
            spots = decode_window(i_samples, q_samples, self.options,
                                  self.hashtable, device=self.device)
        if self.options.usehashtable:
            self.hashtable.save(self.hashtable_path)
        return spots

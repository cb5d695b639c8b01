"""The plain reference decode of one 120 s window (wsprd/wsprd.c:416-855).

One window at a time and in the reference's order: per pass the STFT,
the candidate pick and the coarse grid; fine sync and the jittered soft
symbols of every valid candidate; the gates; per candidate, the
gate-passing jitters in schedule order until the first Fano success;
unpack and dedupe (same call within 3 Hz); then the coherent
subtraction of each new decode, one after another, before the next
pass. The second pass runs only where the first decoded something, and
later passes freeze the drift and relax ``minsync2``
(wsprd/wsprd.c:522-531). Spots come back as dicts sorted by SNR, the
fields of the reference's ``decoder_results`` (wsprd/wsprd.h:62-74).

``quantize`` re-does the int8 link format the farm deployment sends the
windows in (NaN to 0, round half to even, clamp to +-127, scale 254),
so that the reference decodes the samples the deployment decodes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dsp
from .channel import INTERLEAVE_PERM, get_wspr_channel_symbols
from .codec import unpack_message
from .constants import DT, MAX_UNIQUES, Options
from .fano import fano
from .hashtable import WsprHashTable

_PERM = np.asarray(INTERLEAVE_PERM, np.int64)
INT8_SCALE = np.float32(254.0)


def quantize(x: np.ndarray) -> np.ndarray:
    """float32 -> the int8 link's float32 values."""
    v = np.asarray(x, np.float32) * INT8_SCALE
    v = np.where(np.isnan(v), np.float32(0.0), v)
    v = np.clip(np.rint(v), -127.0, 127.0).astype(np.int8)
    return v.astype(np.float32) * (np.float32(1.0) / INT8_SCALE)


def _pass(i: torch.Tensor, q: torch.Tensor, maxdrift: int, minsync2: float,
          o: Options, fano_map=map):
    """Stage A and B of one pass: the per-candidate table and the first
    Fano success of each candidate, {c: (jitter index, data, cycles)}."""
    dev = i.device
    ps = dsp.power_spectrogram_plain(i[None], q[None])
    cand = dsp.find_candidates(ps, o.fmin, o.fmax)
    co = dsp.coarse_search_plain(
        ps, cand.bin_idx, torch.full((1,), maxdrift, dtype=torch.int32,
                                     device=dev))
    snr = cand.snr[0].cpu().numpy()
    valid = cand.valid[0].cpu().numpy()
    tbl = {"snr": snr, "freq": co.freq[0].cpu().numpy().copy(),
           "shift": co.shift[0].cpu().numpy().astype(np.float32),
           "drift": co.drift[0].cpu().numpy(),
           "sync": np.zeros(snr.shape, np.float32)}
    lanes = np.nonzero(valid)[0]
    decoded: dict[int, tuple[int, bytes, int]] = {}
    if lanes.size == 0:
        return tbl, decoded
    sel = torch.as_tensor(lanes, device=dev)
    lane_w = torch.zeros(lanes.size, dtype=torch.int64, device=dev)
    freq, shift = co.freq[0][sel], co.shift[0][sel]
    drift = co.drift[0][sel]
    lagstep = 16 if o.quickmode else 8
    fine = dsp.fine_sync_lanes(i[None], q[None], lane_w, freq, shift, drift,
                               lagstep=lagstep)
    jit = dsp.soft_symbols_lanes(i[None], q[None], lane_w, fine.freq,
                                 fine.shift, drift, iifac=o.iifac,
                                 quickmode=o.quickmode, symfac=o.symfac)
    worth = fine.sync > o.minsync1
    gate = ((jit.sync > minsync2) & (jit.rms > o.minrms)
            & worth[None, :]).cpu().numpy()
    deint = jit.symbols[:, :, torch.as_tensor(_PERM, device=dev)]
    deint = deint.cpu().numpy()
    tbl["freq"][lanes] = fine.freq.cpu().numpy()
    tbl["shift"][lanes] = fine.shift.cpu().numpy().astype(np.float32)
    tbl["sync"][lanes] = fine.sync.cpu().numpy()
    jobs, tried = [], []
    for g, c in enumerate(lanes):
        js = np.nonzero(gate[:, g])[0]
        if js.size:
            jobs.append((deint[js, g], o.delta, o.maxcycles))
            tried.append((int(c), js))
    for (c, js), hit in zip(tried, fano_map(first_success, jobs)):
        if hit is not None:
            k, data, cycles = hit
            decoded[c] = (int(js[k]), data, cycles)
    return tbl, decoded


def first_success(job) -> tuple | None:
    """One candidate's FEC: its gate-passing jitters' symbols (n, 162)
    in schedule order, tried until the first success
    (wsprd/wsprd.c:739-766); (attempt, data, cycles) or None."""
    symbols, delta, maxcycles = job
    for k, s in enumerate(symbols):
        ok, data, cycles = fano(s, delta, maxcycles)
        if ok:
            return k, data, cycles
    return None


def decode_window(i: np.ndarray, q: np.ndarray, options: Options = Options(),
                  fano_map=map):
    """Decode one window of float32 planes (already -3 dB normalized and,
    for the int8 link, ``quantize``d) on the CPU; returns its spots.
    ``fano_map``
    maps ``first_success`` over a pass's candidates (a process pool's
    ``map`` spreads the Fano search over cores)."""
    o = options
    ht = WsprHashTable()
    ti = torch.as_tensor(np.asarray(i, np.float32))
    tq = torch.as_tensor(np.asarray(q, np.float32))
    jit_offs = dsp.jitter_offsets(o.iifac, o.quickmode)
    uniques: list[dict] = []
    seen: list[tuple[str, float]] = []
    sym_cache: dict = {}
    for ipass in range(o.npasses):
        if ipass == 1 and not uniques:
            break
        tbl, decoded = _pass(ti, tq, o.maxdrift if ipass < 2 else 0,
                             o.minsync2 if ipass < 2 else 0.10, o, fano_map)
        new = []
        for c in sorted(decoded):
            j, data, cycles = decoded[c]
            msg = unpack_message(
                [x if x < 128 else x - 256 for x in data[:11]], ht)
            if msg is None or msg.loc == "A000AA":
                continue
            freq_c = float(tbl["freq"][c])
            if any(msg.callsign == sc and abs(freq_c - sf) < 3.0
                   for sc, sf in seen):
                continue
            if len(uniques) >= MAX_UNIQUES:
                break
            seen.append((msg.callsign, freq_c))
            uniques.append({
                "message": msg.call_loc_pow,
                "freq": o.freq / 1e6 + (1500.0 + freq_c) / 1e6,
                "sync": float(tbl["sync"][c]), "snr": float(tbl["snr"][c]),
                "dt": float(tbl["shift"][c]) * DT - 2.0,
                "drift": float(tbl["drift"][c]),
                "jitter": int(jit_offs[j]), "cycles": int(cycles)})
            if o.subtraction and ipass == 0 and not msg.noprint:
                new.append((c, msg.call_loc_pow))
        for c, text in new:
            if text not in sym_cache:
                cs = get_wspr_channel_symbols(text, ht)
                sym_cache[text] = None if cs is None else np.asarray(
                    cs, np.uint8)
            syms = sym_cache[text]
            if syms is None:
                continue
            dev = ti.device
            ni, nq = dsp.subtract_signal2(
                ti[None], tq[None],
                torch.tensor([tbl["freq"][c]], dtype=torch.float32,
                             device=dev),
                torch.tensor([int(tbl["shift"][c])], dtype=torch.int32,
                             device=dev),
                torch.tensor([tbl["drift"][c]], dtype=torch.float32,
                             device=dev),
                torch.as_tensor(syms[None], device=dev))
            ti, tq = ni[0], nq[0]
    uniques.sort(key=lambda s: -s["snr"])
    return uniques


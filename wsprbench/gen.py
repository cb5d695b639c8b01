"""The one traffic generator: windows and raw captures from a mix's data file.

A traffic mix is a JSON file under ``traffic/`` (the cell names it by
its stem). Its keys:

* ``content_seed``: draws the pool's content.
* ``windows``: the pool, the distinct channel-windows a run draws from;
  ``batch``: windows a batch (the drivers' ``device_batch``).
* ``noise_every``: every n-th window (index n-1, 2n-1, ...) holds noise
  only (0: none).
* ``signals``: ``"pattern"`` or ``"random"``.
  - ``pattern`` (the port's bench batch, tools/torch_measure.py
    ``make_batch``): window b's slot s sends ``messages[(b + s) % M]``
    at ``snr_db[s][b % len]``, ``f0_hz[s] = start + step * (b % period)``,
    ``t0_s[s]``.
  - ``random`` (the crowded-band study, tools/torch_crowded_band.py
    ``build_windows``): ``count`` = [lo, hi] signals a window, the counts
    spread evenly over the pool; random encodable type-1 messages; SNR
    in ``snr_db`` = [lo, hi] and start in ``t0_s`` = [lo, hi], both
    stratified over the pool's signals; frequencies uniform in
    ``f0_hz`` = [lo, hi], at least ``min_spacing_hz`` apart.
* ``raw`` (optional): the windows are RTL-SDR captures instead,
  uint8 I/Q at 2.4 Msps made on the card, the wanted band at -fs/4 (the
  reference tunes dial + 600 kHz + 1,500 Hz, rtlsdr_wsprd.c:1112), with
  Gaussian noise of ``noise_counts`` a plane.

The pool's content (noise, phases, random fields) comes from the mix's
``content_seed``; a run's seed draws the order of the pool's slots
(which windows batch together, which channel a dongle feeds), so every
seed asks for the same work in another order. Samples are made on the
given device with a ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import json
import string
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .reference.channel import get_wspr_channel_symbols
from .reference.constants import DF, DT, NSPERSYM, NSYM, SIGNAL_SAMPLES
from .reference.hashtable import WsprHashTable

FS_RAW = 2_400_000
DECIM = FS_RAW // 375           # 6400 raw samples a baseband sample
PWRS = [0, 3, 7, 10, 13, 17, 20, 23, 27, 30, 33, 37]


@dataclass
class Signal:
    window: int
    message: str
    snr_db: float
    f0_hz: float
    t0_s: float


@dataclass
class Pool:
    """What a run feeds: ``wi``/``wq`` float32 (P, 45000) host windows
    (baseband mixes), or ``raw_i``/``raw_q`` uint8 (P, n) device
    captures (raw mixes); and every window's true messages."""
    signals: list[Signal]          # by content window
    truth: list[set[str]]          # by slot
    content_at: np.ndarray         # slot -> content window
    wi: np.ndarray | None = None
    wq: np.ndarray | None = None
    raw_i: torch.Tensor | None = None
    raw_q: torch.Tensor | None = None


def load_mix(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def _random_message(rng: np.random.Generator, ht: WsprHashTable) -> str:
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


def _stratified(rng: np.random.Generator, lo: float, hi: float,
                n: int) -> np.ndarray:
    """n values, one in each of n equal slices of [lo, hi], shuffled."""
    u = (np.arange(n) + rng.uniform(0.0, 1.0, n)) / max(n, 1)
    return lo + (hi - lo) * rng.permutation(u)


def plan(mix: dict) -> tuple[list[Signal], int]:
    """The pool's signals, each in its content window, drawn from the
    mix's ``content_seed``."""
    rng = np.random.default_rng(int(mix["content_seed"]))
    P = int(mix["windows"])
    every = int(mix.get("noise_every", 0))
    spec = mix["signals"]
    out: list[Signal] = []
    if spec["kind"] == "pattern":
        msgs = spec["messages"]
        for b in range(P):
            if every and b % every == every - 1:
                continue
            for s, slot in enumerate(spec["slots"]):
                snrs = slot["snr_db"]
                f = slot["f0_hz"]
                out.append(Signal(
                    b, msgs[(b + s) % len(msgs)], float(snrs[b % len(snrs)]),
                    float(f["start"] + f["step"] * (b % f["period"])),
                    float(slot["t0_s"])))
    elif spec["kind"] == "random":
        ht = WsprHashTable()
        lo, hi = spec["count"]
        busy = [b for b in range(P) if not (every and b % every == every - 1)]
        counts = rng.permutation(np.resize(np.arange(lo, hi + 1), len(busy)))
        n = int(counts.sum())
        snrs = _stratified(rng, *spec["snr_db"], n)
        t0s = _stratified(rng, *spec["t0_s"], n)
        k = 0
        for b, c in zip(busy, counts):
            used: list[float] = []
            for _ in range(int(c)):
                for _ in range(50):
                    f = float(rng.uniform(*spec["f0_hz"]))
                    if all(abs(f - u) > spec["min_spacing_hz"] for u in used):
                        break
                used.append(f)
                out.append(Signal(b, _random_message(rng, ht),
                                  float(snrs[k]), f, float(t0s[k])))
                k += 1
    else:
        raise ValueError(f"unknown signals kind {spec['kind']!r}")
    return out, P


def slots(P: int, seed: int) -> np.ndarray:
    """The run seed's order of the pool: slot k holds content window
    ``slots(P, seed)[k]``."""
    return np.random.default_rng([int(seed), 3]).permutation(P)


def slot_truth(mix: dict, seed: int) -> list[set[str]]:
    """Each slot's true messages under the run seed's order, without
    making a sample."""
    signals, P = plan(mix)
    truth = _truth(signals, P)
    return [truth[int(c)] for c in slots(P, seed)]


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _symbols(signals: list[Signal]) -> np.ndarray:
    ht = WsprHashTable()
    cache: dict[str, np.ndarray] = {}
    rows = []
    for s in signals:
        if s.message not in cache:
            cs = get_wspr_channel_symbols(s.message, ht)
            if cs is None:
                raise ValueError(f"unencodable message {s.message!r}")
            cache[s.message] = np.asarray(cs, np.float64)
        rows.append(cache[s.message])
    return np.stack(rows) if rows else np.zeros((0, NSYM))


def _amplitude(snr_db: np.ndarray, sigma: float, fs: float) -> np.ndarray:
    """Tone amplitude for an SNR in the 2,500 Hz reference band over
    white noise of ``sigma`` a plane at ``fs`` (N0 = 2 sigma^2 / fs)."""
    return np.sqrt(10.0 ** (snr_db / 10.0) * (2.0 * sigma * sigma / fs)
                   * 2500.0)


def baseband(mix: dict, seed: int, device="cpu") -> Pool:
    """The pool as -3 dB normalized host windows (P, 45000) float32:
    unit Gaussian noise a plane plus each window's continuous-phase
    4-FSK signals (rtlsdr_wsprd.c:752-760), made on ``device``."""
    signals, P = plan(mix)
    content = int(mix["content_seed"])
    g = _generator(content, device)
    syms = _symbols(signals)
    phase0 = _phases(content, len(signals))
    amp = _amplitude(np.array([s.snr_db for s in signals]), 1.0, 375.0)
    # both planes of every window on the device, put in the seed's order
    # there and copied to the host once: one pass over the host's pages
    out = torch.empty((2, P, SIGNAL_SAMPLES), dtype=torch.float32,
                      device=device)
    by_window: dict[int, list[int]] = {}
    for k, s in enumerate(signals):
        by_window.setdefault(s.window, []).append(k)
    chunk = 64  # windows made in one set of calls
    for w0 in range(0, P, chunk):
        n = min(chunk, P - w0)
        z = torch.randn((2, n, SIGNAL_SAMPLES), generator=g,
                        dtype=torch.float32, device=device)
        zi, zq = z[0], z[1]
        ks = [k for w in range(w0, w0 + n) for k in by_window.get(w, [])]
        if ks:
            f = torch.as_tensor(
                np.array([signals[k].f0_hz for k in ks])[:, None]
                + (syms[ks] - 1.5) * DF, device=device)     # (S, 162) f64
            dphi = torch.repeat_interleave(2 * np.pi * DT * f, NSPERSYM,
                                           dim=1)
            ph = torch.cumsum(dphi, dim=1) - dphi
            ph = ph + torch.as_tensor(phase0[ks], device=device)[:, None]
            a = torch.as_tensor(amp[ks], device=device)[:, None]
            si = (a * torch.cos(ph)).to(torch.float32)
            sq = (a * torch.sin(ph)).to(torch.float32)
            n_sig = NSYM * NSPERSYM
            for r, k in enumerate(ks):
                s = signals[k]
                start = int(round(s.t0_s / DT))
                src0, dst0 = max(0, -start), max(0, start)
                m = min(n_sig - src0, SIGNAL_SAMPLES - dst0)
                row = s.window - w0
                zi[row, dst0:dst0 + m] += si[r, src0:src0 + m]
                zq[row, dst0:dst0 + m] += sq[r, src0:src0 + m]
        peak = torch.maximum(zi.abs().amax(dim=1), zq.abs().amax(dim=1))
        scale = (0.5 / torch.clamp(peak, min=1e-24))[:, None]
        out[0, w0:w0 + n] = zi * scale
        out[1, w0:w0 + n] = zq * scale
    at = slots(P, seed)
    host = out[:, torch.as_tensor(at, device=device)].cpu().numpy()
    del out
    truth = _truth(signals, P)
    return Pool(signals, [truth[c] for c in at], at, wi=host[0], wq=host[1])


def _phases(content_seed: int, n: int) -> np.ndarray:
    return np.random.default_rng([content_seed, 5]).uniform(0.0, 2 * np.pi, n)


def _truth(signals: list[Signal], P: int) -> list[set[str]]:
    truth: list[set[str]] = [set() for _ in range(P)]
    for s in signals:
        truth[s.window].add(s.message)
    return truth


def raw_capture(mix: dict, seed: int, device, seconds: float = 120.0,
                lead: int = 0, only: list[int] | None = None) -> Pool:
    """The pool as raw RTL-SDR captures on ``device``: uint8 planes
    (P, lead + seconds * 2.4e6), centred at 128, ``lead`` samples of
    128 in front (the stream's priming). Each signal's phase is exact
    within a symbol (float64) and the -fs/4 tuning offset is the
    rotation (-i)^n. ``only``: make just these windows, in this order
    (each window's noise has a generator of its own, so a window's
    bytes do not depend on which others are made)."""
    signals, P = plan(mix)
    content = int(mix["content_seed"])
    raw = mix["raw"]
    sigma = float(raw["noise_counts"])
    n = int(round(seconds * FS_RAW))
    at = slots(P, seed)
    made = list(range(P)) if only is None else list(only)
    syms = _symbols(signals)
    phase0 = _phases(content, len(signals))
    amp = _amplitude(np.array([s.snr_db for s in signals]), sigma, FS_RAW)
    out_i = torch.full((len(made), lead + n), 128, dtype=torch.uint8,
                       device=device)
    out_q = torch.full_like(out_i, 128)
    by_window: dict[int, list[int]] = {}
    for k, s in enumerate(signals):
        by_window.setdefault(s.window, []).append(k)
    sps = NSPERSYM * DECIM
    step = min(n, 1 << 24)
    for row, slot in enumerate(made):
        w = int(at[slot])
        g = _generator(content * 1_000_003 + w, device)
        ks = by_window.get(w, [])
        for p0 in range(0, n, step):
            m = min(step, n - p0)
            z = torch.randn((2, m), generator=g, dtype=torch.float32,
                            device=device) * sigma
            idx = torch.arange(p0, p0 + m, dtype=torch.int64, device=device)
            for k in ks:
                s = signals[k]
                start = int(round(s.t0_s * FS_RAW))
                lo, hi = max(p0, start), min(p0 + m, start + NSYM * sps)
                if lo >= hi:
                    continue
                f = s.f0_hz + (syms[k] - 1.5) * DF              # (162,)
                # phase at each symbol's first sample, accumulated
                d = 2 * np.pi * f / FS_RAW
                ph_start = phase0[k] + np.concatenate(
                    ([0.0], np.cumsum(d * sps)[:-1]))
                rel = idx[lo - p0:hi - p0] - start
                sym = rel // sps
                ph = (torch.as_tensor(ph_start, device=device)[sym]
                      + torch.as_tensor(d, device=device)[sym]
                      * (rel - sym * sps).to(torch.float64))
                ph = torch.remainder(ph, 2 * np.pi).to(torch.float32)
                c = float(amp[k]) * torch.cos(ph)
                sn = float(amp[k]) * torch.sin(ph)
                # (c + i s) * (-i)^n: the band sits at -fs/4
                quarter = idx[lo - p0:hi - p0] % 4
                ri = torch.where(quarter == 0, c, torch.where(
                    quarter == 1, sn, torch.where(quarter == 2, -c, -sn)))
                rq = torch.where(quarter == 0, sn, torch.where(
                    quarter == 1, -c, torch.where(quarter == 2, -sn, c)))
                z[0, lo - p0:hi - p0] += ri
                z[1, lo - p0:hi - p0] += rq
            z = torch.clamp(torch.round(z) + 128.0, 0.0, 255.0)
            out_i[row, lead + p0:lead + p0 + m] = z[0].to(torch.uint8)
            out_q[row, lead + p0:lead + p0 + m] = z[1].to(torch.uint8)
    truth = _truth(signals, P)
    return Pool(signals, [truth[int(at[k])] for k in made], at[made],
                raw_i=out_i, raw_q=out_q)

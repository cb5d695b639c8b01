"""Aligned multi-channel raw ingest: many 2.4 Msps streams in lockstep.

The port's copy of ``rtlsdr_wsprd_tpu/runtime/banks.py``. The reference
serves exactly one dongle with one RX thread (rtlsdr_wsprd.c:255-259).
The production shape here is many simultaneous channels (dongles/bands)
advancing through one batched front-end step on the card, so ingest is
organized as a *bank*: ``read(n)`` returns planar uint8 chunks of
identical length for every channel — the natural input for
frontend.decimate's BatchedStreamingDecimator, which keeps raw bytes
uint8 across the host->device link and centres them in the stage-1
kernel (``frontend/csrc/polyphase_tc.cu``).

Banks:
* ``SyntheticRawBank`` — C independent synthetic WSPR transmissions
  (per-channel message/frequency/amplitude/seed) at 2.4 Msps uint8;
  full-chain testing and load generation without hardware.
* ``RtlTcpBank`` — one RtlTcpConnection (tuning + dedicated RX thread,
  runtime/sources.py) per rtl_tcp server; blocking aligned reads.
"""

from __future__ import annotations

import numpy as np

from ..utils.channel import get_wspr_channel_symbols
from ..utils.hashtable import WsprHashTable
from .sources import RtlTcpConnection
from .synth import synth_raw_2400k


class RawBank:
    """Base: read(n) -> (I, Q) planar uint8[C, m], m <= n, all channels
    aligned to the same m; m < n only when the bank is exhausted."""

    n_channels: int

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def discard_buffered(self) -> None:
        """Drop buffered samples on every channel so the next read
        starts 'now' (wall-clock window alignment); no-op for replay
        banks."""

    def close(self) -> None:
        pass


class SyntheticRawBank(RawBank):
    """C channels of synthetic raw WSPR at 2.4 Msps uint8.

    ``messages``/``f0s``/``amps``/``noises``/``seeds`` broadcast from
    scalars or cycle per channel. Every channel has the same duration,
    so chunks stay aligned until a common EOF.
    """

    def __init__(self, n_channels: int, messages="K1JT FN20QI 20",
                 f0s=50.0, amps=25.0, noises=3.0, seeds=None,
                 duration_s: float = 122.0, chunk_s: float = 2.0):
        def per(v, k):
            if isinstance(v, (list, tuple, np.ndarray)):
                return v[k % len(v)]
            return v

        self.n_channels = n_channels
        ht = WsprHashTable()
        self._gens = []
        for k in range(n_channels):
            msg = per(messages, k)
            symbols = get_wspr_channel_symbols(msg, ht)
            if symbols is None:
                raise ValueError(f"unencodable message: {msg!r}")
            seed = per(seeds, k) if seeds is not None else 1000 + k
            self._gens.append(synth_raw_2400k(
                symbols, f0=per(f0s, k), amp_counts=per(amps, k),
                noise_counts=per(noises, k), duration_s=duration_s,
                seed=seed, chunk_s=chunk_s))
        self._bufs = [(np.zeros(0, np.uint8), np.zeros(0, np.uint8))
                      for _ in range(n_channels)]

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        for k, gen in enumerate(self._gens):
            bi, bq = self._bufs[k]
            while bi.shape[0] < n:
                try:
                    ri, rq = next(gen)
                except StopIteration:
                    break
                bi = np.concatenate([bi, ri])
                bq = np.concatenate([bq, rq])
            self._bufs[k] = (bi, bq)
        m = min(n, min(b[0].shape[0] for b in self._bufs))
        outI = np.empty((self.n_channels, m), np.uint8)
        outQ = np.empty((self.n_channels, m), np.uint8)
        for k, (bi, bq) in enumerate(self._bufs):
            outI[k] = bi[:m]
            outQ[k] = bq[:m]
            self._bufs[k] = (bi[m:], bq[m:])
        return outI, outQ


class WidebandSyntheticRawBank(RawBank):
    """ONE raw 2.4 Msps uint8 stream holding several WSPR signals at
    DIFFERENT dial frequencies (wideband channelizer testing / load
    generation, frontend/channelize.py).

    ``signals``: list of (message, dial_hz, audio_f0_hz, amp_counts).
    ``tuned_dial``: the dial the (virtual) dongle is tuned to — a
    signal for dial d at audio offset a is synthesized at raw offset
    a + (d - tuned_dial) relative to the -600 kHz band slot
    (runtime/synth.synth_raw_2400k's convention). Component signals
    are combined in centered int16 before re-quantizing to uint8.
    """

    n_channels = 1

    def __init__(self, signals, tuned_dial: int,
                 noise_counts: float = 3.0, duration_s: float = 122.0,
                 chunk_s: float = 2.0, seed: int = 7):
        ht = WsprHashTable()
        self._gens = []
        for k, (msg, dial_hz, f0, amp) in enumerate(signals):
            symbols = get_wspr_channel_symbols(msg, ht)
            if symbols is None:
                raise ValueError(f"unencodable message: {msg!r}")
            self._gens.append(synth_raw_2400k(
                symbols, f0=f0 + (dial_hz - tuned_dial), amp_counts=amp,
                noise_counts=noise_counts if k == 0 else 0.0,
                duration_s=duration_s, seed=seed + k, chunk_s=chunk_s))
        self._bufs = [(np.zeros(0, np.uint8), np.zeros(0, np.uint8))
                      for _ in self._gens]

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        for k, gen in enumerate(self._gens):
            bi, bq = self._bufs[k]
            while bi.shape[0] < n:
                try:
                    ri, rq = next(gen)
                except StopIteration:
                    break
                bi = np.concatenate([bi, ri])
                bq = np.concatenate([bq, rq])
            self._bufs[k] = (bi, bq)
        m = min(n, min(b[0].shape[0] for b in self._bufs))
        accI = np.zeros(m, np.int16)
        accQ = np.zeros(m, np.int16)
        for k, (bi, bq) in enumerate(self._bufs):
            accI += bi[:m].astype(np.int16) - 128
            accQ += bq[:m].astype(np.int16) - 128
            self._bufs[k] = (bi[m:], bq[m:])
        outI = np.clip(accI + 128, 0, 255).astype(np.uint8)[None, :]
        outQ = np.clip(accQ + 128, 0, 255).astype(np.uint8)[None, :]
        return outI, outQ


class RtlTcpBank(RawBank):
    """One rtl_tcp connection per channel; aligned blocking reads.

    ``endpoints``: list of (host, port, dialfreq_hz) or (host, port,
    dialfreq_hz, extra_kwargs) tuples — each gets the full reference
    tuning recipe via RtlTcpConnection. Each connection's dedicated RX
    thread keeps draining its socket while ``read`` blocks on the
    slowest channel, so no server's send buffer backs up (the
    many-dongle analog of rtlsdr_wsprd.c:255-259).
    """

    def __init__(self, endpoints, **common_kwargs):
        self._conns = []
        for ep in endpoints:
            host, port, dialfreq = ep[:3]
            kw = dict(common_kwargs)
            if len(ep) > 3:
                kw.update(ep[3])
            self._conns.append(
                RtlTcpConnection(host, port, dialfreq, **kw))
        self.n_channels = len(self._conns)

    @property
    def dropped_bytes(self) -> list[int]:
        return [c.dropped_bytes for c in self._conns]

    def discard_buffered(self) -> None:
        for c in self._conns:
            c.drop_buffered()

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        parts = [c.read_pairs(n) for c in self._conns]
        m = min(p[0].shape[0] for p in parts)
        outI = np.empty((self.n_channels, m), np.uint8)
        outQ = np.empty((self.n_channels, m), np.uint8)
        for k, (pi, pq) in enumerate(parts):
            outI[k] = pi[:m]
            outQ[k] = pq[:m]
            if pi.shape[0] > m:  # sibling EOF'd short; keep the excess
                self._conns[k].unread_pairs(pi[m:], pq[m:])
        return outI, outQ

    def close(self) -> None:
        for c in self._conns:
            c.close()


__all__ = ["RawBank", "SyntheticRawBank", "WidebandSyntheticRawBank",
           "RtlTcpBank"]

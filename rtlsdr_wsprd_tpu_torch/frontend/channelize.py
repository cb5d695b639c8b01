"""Wideband channelizer: N WSPR dials from ONE 2.4 Msps capture.

The port's copy of ``rtlsdr_wsprd_tpu/frontend/channelize.py``. The
reference binds one dongle to one 200 Hz WSPR band
(rtlsdr_wsprd.c:1044-1124). A 2.4 Msps capture spans much more — the
tuned center sits at dial + 601.5 kHz, so the capture covers
dial - 598.5 kHz .. dial + 1801.5 kHz, which can hold several WSPR
dials (137/475 kHz LF+MF under direct sampling, 5.2887 + 7.0386 MHz
60m + 40m, ...). This module decodes ALL of them from the one stream.

Per dial k the needed heterodyne is exp(j*theta_k*n) with
theta_k = 2*pi*(tuned_dial - dial_k)/fs, which moves dial_k's band to
the -600 kHz slot the stage-1 polyphase expects (frontend/filters.py).
The heterodyne is commuted through the decimator:

    sum_t g[t] * x[mR+t] * e^{j theta (mR+t)}
        = e^{j theta R m} * sum_t (g[t] e^{j theta t}) * x[mR+t]

so each dial gets its own folded stage-1 taps g'_k[t] = g[t]*e^{j theta_k t}
and one residual rotation per output frame at the 30 ksps mid-rate.
Stage 2 is shared (the band is at baseband after the rotation).

On the card (placement ``"device"``) a step is one launch of a
hand-written polyphase kernel for ALL K dials: the uploaded stream is
passed as K rows of row stride 0 through the bank of K folded filters
(frontend/polyphase.py; ``polyphase_tc.cu`` for uint8, ``polyphase.cu``
for a float32 carry), so the stream crosses HBM about once. Then the
rotation is an elementwise pass and stage 2 one ``polyphase.cu``
launch over the K rows; the mid-rate carry stays on the card. The host
placement runs the same math through the native C++ polyphase
(native/hostdsp.cpp) with per-dial taps, dials on threads.

Phase bookkeeping: a per-dial float64 scalar carries the stream phase
at the raw-carry buffer's origin (init -theta*prime1 for the zero
pad), advanced by exactly the consumed raw-sample count each step;
frame m's rotation is e^{j(phi + theta*R1*m)}. The window-constant
residual phase per dial is irrelevant to WSPR decode (a zero-offset
channel equals the plain decimator).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from .decimate import STAGE2
from .filters import R1, R2, STAGE1_TAPS, STAGE2_TAPS, conv_order, stage1_coeffs
from .host_decimate import _host_taps
from .polyphase import PolyphaseFilter, polyphase_decimate

FS = 2_400_000


def folded_stage1_taps(offsets_hz: np.ndarray) -> np.ndarray:
    """Per-dial conv-ordered complex stage-1 taps
    g'_k[t] = g[t] * e^{j theta_k t}, complex128[K, STAGE1_TAPS]."""
    g = conv_order(stage1_coeffs()).astype(np.complex128)
    t = np.arange(STAGE1_TAPS, dtype=np.float64)
    theta = 2.0 * np.pi * np.asarray(offsets_hz, np.float64) / FS
    return g[None, :] * np.exp(1j * theta[:, None] * t[None, :])


def _stage2_step(m2I: torch.Tensor, m2Q: torch.Tensor):
    """Stage 2 over every whole output frame of the (K, m) mid-rate
    carry: (outI, outQ, new m2I, new m2Q), outputs (K, 0) when the carry
    holds no whole frame."""
    K = m2I.shape[0]
    n_out = (m2I.shape[1] - (STAGE2_TAPS - R2)) // R2
    if n_out <= 0:
        empty = torch.zeros((K, 0), dtype=torch.float32, device=m2I.device)
        return empty, empty, m2I, m2Q
    oi, oq = polyphase_decimate(m2I, m2Q, STAGE2, n_out)
    return (oi, oq, m2I[:, n_out * R2:].contiguous(),
            m2Q[:, n_out * R2:].contiguous())


def _folded_frontend_step(rawI: torch.Tensor, rawQ: torch.Tensor, bank,
                          rotC, rotS, phC, phS, m2I, m2Q, n_mid: int):
    """One device step of the channelizer for K dials: the folded stage
    1 of every dial in one bank launch over the one raw stream (L =
    n_mid*R1 + tail1, as K rows of stride 0), the residual rotation
    e^{j(phi + theta*R1*m)} (rotC/rotS (K, n_mid) tables, phC/phS (K, 1)
    carried phase), appended to the (K, m) mid carry, then stage 2.
    Returns (outI, outQ, new m2I, new m2Q), the JAX package's
    ``_folded_frontend_step``."""
    K = len(bank)
    L = rawI.shape[-1]
    mi, mq = polyphase_decimate(rawI.expand(K, L), rawQ.expand(K, L), bank,
                                n_mid)
    c = phC * rotC - phS * rotS
    s = phC * rotS + phS * rotC
    return _stage2_step(torch.cat([m2I, mi * c - mq * s], dim=1),
                        torch.cat([m2Q, mi * s + mq * c], dim=1))


class ChannelizingStreamingDecimator:
    """Stateful streaming channelizer: push one raw stream, get K
    375 sps channels.

    ``offsets_hz[k] = tuned_dial - dial_k`` (0 for the tuned dial
    itself). Same push/flush contract as BatchedStreamingDecimator
    except the input is the single stream — (n,) or (1, n) planar
    uint8/float32 — and the output is (K, m) planar float32 numpy.
    ``placement``: ``"device"`` (one stage-1 launch for all dials, the
    rotation and one stage-2 launch per step, on ``device``: None means
    the CUDA card, ``"cpu"`` the plain versions) or ``"host"`` (native
    C++ polyphase with per-dial folded taps, dials on threads).
    """

    # stage-1 frames per device step (a multiple of R2): 0.8 s of
    # stream, 1.92 M raw samples per upload
    QUANT1 = 24_000

    def __init__(self, offsets_hz, placement: str = "device",
                 threads: int = 8, device=None):
        self.offsets = np.asarray(offsets_hz, np.float64)
        K = self.offsets.shape[0]
        self._K = K
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement: {placement!r}")
        self.placement = placement
        self._threads = threads
        prime1 = STAGE1_TAPS // 2
        prime2 = STAGE2_TAPS // 2
        self._prime1 = prime1
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2
        self._theta = 2.0 * np.pi * self.offsets / FS

        gk = folded_stage1_taps(self.offsets)
        if placement == "device":
            self.device = resolve_device(device)
            # one filter per dial: the bank one launch takes
            self._bank = [PolyphaseFilter(gk[k].astype(np.complex64), R1)
                          for k in range(K)]
            self._m2I = torch.zeros((K, prime2), dtype=torch.float32,
                                    device=self.device)
            self._m2Q = torch.zeros_like(self._m2I)
        else:
            native.build()  # raises without g++: there is no stand-in
            self._g1r = np.ascontiguousarray(np.real(gk), np.float32)
            self._g1i = np.ascontiguousarray(np.imag(gk), np.float32)
            self._g2 = _host_taps()[2]
            self._m2I_np = np.zeros((K, prime2), np.float32)
            self._m2Q_np = np.zeros((K, prime2), np.float32)

        # stream phase at buffer origin: the first prime1 entries are
        # the zero pad, so the origin starts at -theta*prime1
        self._phase = np.mod(-self._theta * prime1, 2.0 * np.pi)
        self._bufI: np.ndarray | None = None
        self._bufQ: np.ndarray | None = None
        self._rots: dict[int, tuple] = {}

    # -- shared helpers -----------------------------------------------------

    def _rot_tables(self, n_mid: int):
        """cos/sin(theta_k * R1 * m), m = 0..n_mid-1, float64 math, as
        float32 (K, n_mid) tables: numpy on the host placement, uploaded
        once per n_mid on the device placement."""
        t = self._rots.get(n_mid)
        if t is None:
            if len(self._rots) >= 8:  # bound memory under odd chunking
                self._rots.clear()
            ang = (self._theta[:, None] * R1) * np.arange(
                n_mid, dtype=np.float64)[None, :]
            t = (np.cos(ang).astype(np.float32),
                 np.sin(ang).astype(np.float32))
            if self.placement == "device":
                t = tuple(torch.from_numpy(a).to(self.device) for a in t)
            self._rots[n_mid] = t
        return t

    def _phase_cs(self):
        """cos/sin of the carried phase, float32 (K, 1)."""
        return (np.cos(self._phase).astype(np.float32)[:, None],
                np.sin(self._phase).astype(np.float32)[:, None])

    def _advance_phase(self, n_raw: int) -> None:
        self._phase = np.mod(self._phase + self._theta * n_raw,
                             2.0 * np.pi)

    def _normalize_chunk(self, rawI, rawQ):
        """Prime the carry on first use and reconcile chunk/carry
        dtypes (u8 carry upconverts once to float; float carry centers
        incoming u8). Returns the chunk as contiguous arrays of the
        carry's dtype WITHOUT appending it."""
        in_dtype = (np.uint8 if rawI.dtype == np.uint8 else np.float32)
        if self._bufI is None:
            fill = 128 if in_dtype == np.uint8 else 0
            self._bufI = np.full(self._prime1, fill, in_dtype)
            self._bufQ = np.full(self._prime1, fill, in_dtype)
        if in_dtype != self._bufI.dtype and rawI.size > 0:
            if self._bufI.dtype == np.uint8:  # upconvert carry once
                self._bufI = self._bufI.astype(np.float32) - 128.0
                self._bufQ = self._bufQ.astype(np.float32) - 128.0
            else:
                rawI = rawI.astype(np.float32) - 128.0
                rawQ = rawQ.astype(np.float32) - 128.0
        return (np.ascontiguousarray(rawI, self._bufI.dtype),
                np.ascontiguousarray(rawQ, self._bufQ.dtype))

    @staticmethod
    def _flat(raw: np.ndarray) -> np.ndarray:
        if raw.ndim == 2:
            if raw.shape[0] != 1:
                raise ValueError("the channelizer takes ONE raw stream, got "
                                 f"{raw.shape[0]} rows")
            return raw[0]
        return raw

    # -- device placement ----------------------------------------------------

    def _push_device(self, rawI, rawQ, exact: bool):
        """Append the chunk to the host raw carry, then one step over its
        whole work quanta (every whole frame when ``exact``): the folded
        stage 1 of all K dials in one launch, the residual rotation, and
        one stage-2 launch over the K rows of the device mid carry
        (``_folded_frontend_step``)."""
        rawI, rawQ = self._normalize_chunk(rawI, rawQ)
        if rawI.size > 0:
            self._bufI = np.concatenate([self._bufI, rawI])
            self._bufQ = np.concatenate([self._bufQ, rawQ])
        n_mid = (self._bufI.shape[0] - self._tail1) // R1
        if not exact:
            n_mid -= n_mid % self.QUANT1
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            xI = torch.from_numpy(self._bufI[:need]).to(self.device)
            xQ = torch.from_numpy(self._bufQ[:need]).to(self.device)
            rotC, rotS = self._rot_tables(n_mid)
            phC, phS = (torch.from_numpy(a).to(self.device)
                        for a in self._phase_cs())
            oi, oq, self._m2I, self._m2Q = _folded_frontend_step(
                xI, xQ, self._bank, rotC, rotS, phC, phS, self._m2I,
                self._m2Q, n_mid)
            self._bufI = self._bufI[n_mid * R1:]
            self._bufQ = self._bufQ[n_mid * R1:]
            self._advance_phase(n_mid * R1)
        else:
            oi, oq, self._m2I, self._m2Q = _stage2_step(self._m2I,
                                                        self._m2Q)
        return oi.cpu().numpy(), oq.cpu().numpy()

    # -- host placement --------------------------------------------------------

    def _rotate_mid(self, mi, mq, n_mid: int):
        """Apply the residual per-frame rotation e^{j(phi+theta*R1*m)}
        at the current carried phase (does NOT advance it)."""
        rotC, rotS = self._rot_tables(n_mid)
        cph, sph = self._phase_cs()
        c = cph * rotC - sph * rotS
        s = cph * rotS + sph * rotC
        return mi * c - mq * s, mi * s + mq * c

    def _map_dials(self, fn, n: int):
        if n == 1 or self._threads <= 1:
            for k in range(n):
                fn(k)
        else:
            with ThreadPoolExecutor(max_workers=min(self._threads,
                                                    n)) as ex:
                list(ex.map(fn, range(n)))

    def _push_host(self, rawI, rawQ):
        """Host step: stage 1 reads the caller's chunk in place — only
        frames spanning the carry/chunk boundary (the carry is < taps
        samples, so <= taps/R1 = 8 of them) go through a small stitch
        buffer, the same structure as HostBatchedStreamingDecimator.push.
        Every push processes all whole frames."""
        K = self._K
        rawI, rawQ = self._normalize_chunk(rawI, rawQ)
        nc = self._bufI.shape[0]
        total = nc + rawI.shape[0]
        n_mid = (total - self._tail1) // R1
        if n_mid > 0:
            m_b = min(n_mid, -(-nc // R1))  # frames touching the carry
            take = m_b * R1 + self._tail1 - nc
            stI = np.concatenate([self._bufI, rawI[:take]])
            stQ = np.concatenate([self._bufQ, rawQ[:take]])
            off = m_b * R1 - nc
            n_bulk = n_mid - m_b
            end = off + n_bulk * R1 + self._tail1
            mi = np.empty((K, n_mid), np.float32)
            mq = np.empty((K, n_mid), np.float32)
            g1r, g1i = self._g1r, self._g1i

            def s1(k):
                mi[k, :m_b], mq[k, :m_b] = native.pp_decimate(
                    stI, stQ, g1r[k], g1i[k], R1, m_b)
                if n_bulk > 0:
                    mi[k, m_b:], mq[k, m_b:] = native.pp_decimate(
                        rawI[off:end], rawQ[off:end], g1r[k], g1i[k],
                        R1, n_bulk)

            self._map_dials(s1, K)
            ri, rq = self._rotate_mid(mi, mq, n_mid)
            pos = n_mid * R1
            if pos >= nc:
                self._bufI = rawI[pos - nc:].copy()
                self._bufQ = rawQ[pos - nc:].copy()
            else:
                self._bufI = np.concatenate([self._bufI[pos:], rawI])
                self._bufQ = np.concatenate([self._bufQ[pos:], rawQ])
            self._advance_phase(pos)
            self._m2I_np = np.concatenate([self._m2I_np, ri], axis=1)
            self._m2Q_np = np.concatenate([self._m2Q_np, rq], axis=1)
        elif rawI.size > 0:
            self._bufI = np.concatenate([self._bufI, rawI])
            self._bufQ = np.concatenate([self._bufQ, rawQ])
        n_out = (self._m2I_np.shape[1] - self._tail2) // R2
        if n_out <= 0:
            return (np.zeros((K, 0), np.float32),
                    np.zeros((K, 0), np.float32))
        need2 = n_out * R2 + self._tail2
        oi = np.empty((K, n_out), np.float32)
        oq = np.empty((K, n_out), np.float32)
        midI = np.ascontiguousarray(self._m2I_np[:, :need2])
        midQ = np.ascontiguousarray(self._m2Q_np[:, :need2])
        g2 = self._g2

        def s2(k):
            oi[k], oq[k] = native.fir_decimate(midI[k], midQ[k], g2,
                                               R2, n_out)

        self._map_dials(s2, K)
        self._m2I_np = self._m2I_np[:, n_out * R2:]
        self._m2Q_np = self._m2Q_np[:, n_out * R2:]
        return oi, oq

    # -- public API ------------------------------------------------------------

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Feed a chunk of the one raw stream; returns newly available
        (K, m) planar 375 sps samples (m can be 0). ``exact=True``
        (flush) processes every whole frame instead of whole quanta."""
        rawI, rawQ = self._flat(rawI), self._flat(rawQ)
        if self.placement == "host":
            return self._push_host(rawI, rawQ)
        return self._push_device(rawI, rawQ, exact)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        return self.push(np.zeros(0, np.float32),
                         np.zeros(0, np.float32), exact=True)


__all__ = ["ChannelizingStreamingDecimator", "folded_stage1_taps"]

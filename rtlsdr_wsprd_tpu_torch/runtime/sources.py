"""IQ sample sources: the framework's replacement for librtlsdr.

The port's copy of ``rtlsdr_wsprd_tpu/runtime/sources.py``: the device
argument (``None`` = the CUDA card) takes the place of ``use_pallas``,
and the front end is the port's. A compute host need not hold the USB
dongles, so the device layer
(rtlsdr_wsprd.c:1044-1124) becomes a pluggable source interface with
four implementations:

* ``RtlTcpSource`` — the real-hardware path: the standard rtl_tcp
  network protocol (a 12-byte "RTL0" header, then raw interleaved
  uint8 IQ; 5-byte big-endian command packets). Works against any
  rtl_tcp server, giving dongle support without USB on the host.
  Applies the reference's tuning recipe: center = dial + shift +
  upconverter + 600 kHz + 1500 Hz (fs/4 offset, rtlsdr_wsprd.c:1112),
  2.4 Msps, gain in tenths of dB, ppm correction, direct sampling.
* ``IQFileSource`` — replays 375 sps .iq/.c2 captures (offline path).
* ``SyntheticBasebandSource`` — 375 sps synthetic windows (self-test
  and load generation).
* ``SyntheticRawSource`` — 2.4 Msps uint8 synthetic stream through the
  real front-end decimator (full-chain testing without hardware).

All sources yield 375 sps planar float32 (I, Q) baseband via
``read(n)``. The single-channel front end is ``StreamingDecimator``: it
centres the raw bytes on the host, so both of its stages run float32
on ``frontend/csrc/polyphase.cu``.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
import time

import numpy as np

from ..config import SIGNAL_SAMPLES
from .. import native
from ..frontend.decimate import StreamingDecimator
from ..utils.channel import get_wspr_channel_symbols
from ..utils.hashtable import WsprHashTable
from . import iqio
from .synth import synth_raw_2400k, synth_window_at_snr

SAMPLE_RATE_RAW = 2_400_000


class Source:
    """Base: read(n) -> (i, q) float32[<=n] at 375 sps; empty arrays
    when exhausted."""

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def discard_buffered(self) -> None:
        """Drop samples buffered while the consumer slept so the next
        ``read`` starts 'now'. Live sources override this: the
        reference starts capture AT the 2-minute boundary
        (rtlsdr_wsprd.c:1145-1160 — samples before the boundary never
        enter the window); replay sources deliver their stream
        wherever it stands."""

    def close(self) -> None:
        pass


class IQFileSource(Source):
    def __init__(self, path: str):
        if str(path).endswith(".c2"):
            i, q, _freq = iqio.read_c2_file(path)
        else:
            i, q = iqio.read_iq_file(path)
        self._i, self._q = i, q
        self._pos = 0

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        sl = slice(self._pos, self._pos + n)
        oi, oq = self._i[sl], self._q[sl]
        self._pos += oi.shape[0]
        return oi, oq


class SyntheticBasebandSource(Source):
    """Endless stream of 120 s windows, each regenerated with a fresh
    seed; messages/snr/f0 may be lists (multi-signal windows)."""

    def __init__(self, messages="K1JT FN20QI 20", snr_db=10.0, f0=50.0,
                 seed: int = 1):
        self.messages = messages
        self.snr_db = snr_db
        self.f0 = f0
        self.seed = seed
        self._bi = np.zeros(0, np.float32)
        self._bq = np.zeros(0, np.float32)

    def _refill(self):
        i, q = synth_window_at_snr(self.messages, self.snr_db, self.f0,
                                   seed=self.seed)
        self.seed += 1
        i, q = iqio.normalize_minus3db(i, q)
        self._bi = np.concatenate([self._bi, i])
        self._bq = np.concatenate([self._bq, q])

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        while self._bi.shape[0] < n:
            self._refill()
        oi, self._bi = self._bi[:n], self._bi[n:]
        oq, self._bq = self._bq[:n], self._bq[n:]
        return oi, oq


class SyntheticRawSource(Source):
    """2.4 Msps uint8 synthesis -> streaming polyphase front end."""

    def __init__(self, message="K1JT FN20QI 20", f0=50.0,
                 amp_counts=25.0, noise_counts=3.0, seed: int = 1,
                 device=None):
        symbols = get_wspr_channel_symbols(message, WsprHashTable())
        if symbols is None:
            raise ValueError(f"unencodable message: {message!r}")
        self._gen = synth_raw_2400k(
            symbols, f0=f0, amp_counts=amp_counts,
            noise_counts=noise_counts, duration_s=126.0, seed=seed,
            chunk_s=2.0)
        self._dec = StreamingDecimator(device=device)
        self._bi = np.zeros(0, np.float32)
        self._bq = np.zeros(0, np.float32)

    def _append(self, pair):
        self._bi = np.concatenate([self._bi, pair[0]])
        self._bq = np.concatenate([self._bq, pair[1]])

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        while self._bi.shape[0] < n:
            try:
                rawI, rawQ = next(self._gen)
            except StopIteration:
                self._append(self._dec.flush())
                break
            self._append(self._dec.push(rawI, rawQ))
        oi, self._bi = self._bi[:n], self._bi[n:]
        oq, self._bq = self._bq[:n], self._bq[n:]
        return oi, oq


# ---- rtl_tcp protocol (the real-hardware path) -----------------------------

_CMD_SET_FREQ = 0x01
_CMD_SET_SAMPLE_RATE = 0x02
_CMD_SET_GAIN_MODE = 0x03
_CMD_SET_GAIN = 0x04
_CMD_SET_FREQ_CORRECTION = 0x05
_CMD_SET_AGC_MODE = 0x08
_CMD_SET_DIRECT_SAMPLING = 0x09


class RtlTcpConnection:
    """One rtl_tcp server connection: tuning + a dedicated RX thread.

    Tuning mirrors the reference device setup (rtlsdr_wsprd.c:1044-1124):
    fs/4 + 1500 Hz offset so the wanted band lands at -600 kHz, away
    from the DC spike; the stage-1 polyphase mixes it back (see
    frontend/filters.py).

    The RX thread drains the socket continuously — the reference's RX
    thread (rtlsdr_wsprd.c:255-259) — so the server's send buffer never
    backs up while the consumer sleeps to a 2-minute boundary or blocks
    in a decode. Raw bytes queue in a bounded host ring; if the
    consumer falls behind ``max_buffer_bytes`` the oldest bytes are
    dropped in whole IQ pairs (``dropped_bytes`` counts them, the
    analog of USB overflow on the reference's dongle).

    ``reconnect``: ride out server restarts — on stream loss the RX
    thread redials and replays the full tuning burst (with
    ``reconnect_backoff_s`` between attempts, up to
    ``max_reconnects``); samples lost during the outage are simply
    missing from the ring (``reconnects`` counts the events). The
    reference exits on device loss (rtlsdr_wsprd.c:247-251); a
    long-running many-channel daemon prefers to keep the other
    channels flowing.
    """

    def __init__(self, host: str, port: int, dialfreq_hz: int,
                 shift_hz: int = 0, upconverter_hz: int = 0,
                 gain_tenths_db: int = 290, autogain: bool = False,
                 ppm: int = 0, directsampling: int = 0,
                 max_buffer_bytes: int = 256 << 20,
                 reconnect: bool = False,
                 reconnect_backoff_s: float = 5.0,
                 max_reconnects: int = 0):
        self._addr = (host, port)
        self._tuning = (dialfreq_hz, shift_hz, upconverter_hz,
                        gain_tenths_db, autogain, ppm, directsampling)
        self._reconnect = reconnect
        self._backoff = reconnect_backoff_s
        self._max_reconnects = max_reconnects  # 0 = unlimited
        self.reconnects = 0
        self._closed = False
        self._connect()

        # RX thread state: a deque of byte chunks + condition variable
        # (the reference's cond-var handshake, rtlsdr_wsprd.c:55-66)
        self._max_buffer = max_buffer_bytes
        self._chunks: collections.deque[bytes] = collections.deque()
        self._buffered = 0
        self.dropped_bytes = 0
        self._eof = False
        self._cv = threading.Condition()
        self._carry = b""  # odd-size chunk remainder, keeps IQ pairing
        self._pi = np.zeros(0, np.uint8)
        self._pq = np.zeros(0, np.uint8)
        self._rx = threading.Thread(target=self._rx_loop, daemon=True,
                                    name="rtltcp-rx")
        self._rx.start()

    def _connect(self) -> None:
        """Dial the server, check the header, send the full reference
        tuning burst (rtlsdr_wsprd.c:1044-1124)."""
        (dialfreq_hz, shift_hz, upconverter_hz, gain_tenths_db,
         autogain, ppm, directsampling) = self._tuning
        self._sock = socket.create_connection(self._addr, timeout=10.0)
        hdr = self._recv_exact(12)
        if hdr[:4] != b"RTL0":
            raise IOError(f"not an rtl_tcp server (header {hdr[:4]!r})")

        realfreq = dialfreq_hz + shift_hz + upconverter_hz
        center = realfreq + 600_000 + 1_500  # rtlsdr_wsprd.c:1112
        self._cmd(_CMD_SET_SAMPLE_RATE, SAMPLE_RATE_RAW)
        if directsampling:
            self._cmd(_CMD_SET_DIRECT_SAMPLING, directsampling)
        if ppm:
            self._cmd(_CMD_SET_FREQ_CORRECTION, ppm)
        if autogain:
            self._cmd(_CMD_SET_GAIN_MODE, 0)
            self._cmd(_CMD_SET_AGC_MODE, 1)
        else:
            self._cmd(_CMD_SET_GAIN_MODE, 1)
            self._cmd(_CMD_SET_GAIN, gain_tenths_db)
        self._cmd(_CMD_SET_FREQ, center)

    def _try_reconnect(self) -> bool:
        """Redial after stream loss; True when a new stream is up.
        ``max_reconnects`` bounds dial attempts PER OUTAGE (0 = keep
        trying forever)."""
        attempts = 0
        while not self._closed and (self._max_reconnects == 0
                                    or attempts < self._max_reconnects):
            attempts += 1
            time.sleep(self._backoff)
            if self._closed:
                return False
            try:
                self._sock.close()
            except OSError:
                pass
            try:
                self._connect()
            except OSError:
                continue
            self.reconnects += 1
            return True
        return False

    def _cmd(self, cmd: int, arg: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            b = self._sock.recv(n)
            if not b:
                raise IOError("rtl_tcp connection closed")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _rx_loop(self) -> None:
        """Drain the socket into the ring until EOF/close. 256 KiB reads,
        like the reference's USB buffers (rtlsdr_wsprd.c:42).

        Chunks are normalized to EVEN length before entering the ring
        (odd tail byte carried to the next recv), so the overflow path
        can drop whole chunks without desynchronizing I/Q pairing —
        dropping an odd byte count would swap I and Q for the entire
        rest of the stream."""
        tail = b""
        while True:
            try:
                b = self._sock.recv(262144)
            except OSError:
                b = b""
            lost = not b
            if tail:
                b = tail + b
                tail = b""
            if len(b) & 1:
                tail = b[-1:]
                b = b[:-1]
            eof = lost
            if lost and self._reconnect and not self._closed:
                # server restart: redial + re-tune; the odd tail (if
                # any) belongs to the dead stream — drop it so the new
                # stream starts on an I/Q pair boundary
                tail = b""
                eof = not self._try_reconnect()
            with self._cv:
                if b:
                    self._chunks.append(b)
                    self._buffered += len(b)
                    while self._buffered > self._max_buffer and self._chunks:
                        old = self._chunks.popleft()
                        self._buffered -= len(old)
                        self.dropped_bytes += len(old)
                if eof:
                    self._eof = True
                self._cv.notify_all()
            if eof:
                return

    def _take_raw(self) -> bytes | None:
        """Next queued raw chunk; blocks until data or EOF (None)."""
        with self._cv:
            while not self._chunks and not self._eof:
                self._cv.wait(timeout=1.0)
            if not self._chunks:
                return None
            b = self._chunks.popleft()
            self._buffered -= len(b)
            return b

    def read_pairs(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Blocking read of up to ``n`` IQ pairs as planar uint8
        (I[m], Q[m]); m < n only at EOF. Raw RTL bytes stay uint8 so
        they can cross the host->device link at 1 byte/sample (the
        stage-1 kernel centers on device, frontend/decimate.py)."""
        while self._pi.shape[0] < n:
            b = self._take_raw()
            if b is None:
                break
            if self._carry:
                b = self._carry + b
                self._carry = b""
            if len(b) & 1:  # keep IQ pairing across odd-size chunks
                self._carry = b[-1:]
                b = b[:-1]
            pi, pq = native.u8_deinterleave_pairs(
                np.frombuffer(b, dtype=np.uint8))
            self._pi = np.concatenate([self._pi, pi])
            self._pq = np.concatenate([self._pq, pq])
        take = min(n, self._pi.shape[0])
        oi, self._pi = self._pi[:take], self._pi[take:]
        oq, self._pq = self._pq[:take], self._pq[take:]
        return oi, oq

    def unread_pairs(self, ui: np.ndarray, uq: np.ndarray) -> None:
        """Push unconsumed pairs back to the front (bank alignment:
        when a sibling channel EOFs short, the excess must not drop)."""
        self._pi = np.concatenate([ui, self._pi])
        self._pq = np.concatenate([uq, self._pq])

    def drop_buffered(self) -> None:
        """Discard everything buffered so far (ring + deinterleaved
        pairs); the next read starts from bytes arriving 'now'. Used
        for wall-clock window alignment (the reference's capture
        starts AT the boundary, rtlsdr_wsprd.c:1145-1160)."""
        with self._cv:
            self._chunks.clear()
            self._buffered = 0
        self._carry = b""
        self._pi = np.zeros(0, np.uint8)
        self._pq = np.zeros(0, np.uint8)

    def close(self) -> None:
        self._closed = True  # stop any reconnect attempts first
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if hasattr(self, "_rx"):
            self._rx.join(timeout=5.0)


class RtlTcpSource(Source):
    """Single-channel stream from an rtl_tcp server through the port's
    front end: an RtlTcpConnection + streaming decimator. Multi-dongle
    ingest uses runtime.banks.RtlTcpBank (one batched decimator over
    every connection) instead.

    ``frontend`` places the decimator like the many-channel daemon
    (frontend/host_decimate.py): "device" (and "auto") decimate on
    ``device`` (None = the CUDA card), "host" runs the native C++
    polyphase so only 375 sps baseband reaches the device.
    """

    def __init__(self, host: str, port: int, dialfreq_hz: int,
                 shift_hz: int = 0, upconverter_hz: int = 0,
                 gain_tenths_db: int = 290, autogain: bool = False,
                 ppm: int = 0, directsampling: int = 0,
                 device=None,
                 max_buffer_bytes: int = 256 << 20,
                 frontend: str = "auto", reconnect: bool = False):
        from ..frontend.host_decimate import resolve_placement

        self.frontend_placement = resolve_placement(frontend)
        self._device = device
        # the decimator first: without its device this raises before a
        # connection (and its RX thread) exists
        self._dec = self._make_dec()
        self._conn = RtlTcpConnection(
            host, port, dialfreq_hz, shift_hz=shift_hz,
            upconverter_hz=upconverter_hz, gain_tenths_db=gain_tenths_db,
            autogain=autogain, ppm=ppm, directsampling=directsampling,
            max_buffer_bytes=max_buffer_bytes, reconnect=reconnect)
        self._bi = np.zeros(0, np.float32)
        self._bq = np.zeros(0, np.float32)
        self._eof = False

    def _make_dec(self):
        if self.frontend_placement == "host":
            from ..frontend.host_decimate import HostStreamingDecimator

            return HostStreamingDecimator()
        return StreamingDecimator(device=self._device)

    @property
    def dropped_bytes(self) -> int:
        return self._conn.dropped_bytes

    def discard_buffered(self) -> None:
        """Start the next window from samples arriving 'now': drop the
        connection's ring and reset the decimator chain (carried
        filter state belongs to the discarded stream)."""
        self._conn.drop_buffered()
        self._dec = self._make_dec()
        self._bi = np.zeros(0, np.float32)
        self._bq = np.zeros(0, np.float32)

    # ~1 s of raw stream per decimator push
    _CHUNK_PAIRS = 2_400_000

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        while self._bi.shape[0] < n and not self._eof:
            ui, uq = self._conn.read_pairs(self._CHUNK_PAIRS)
            if ui.shape[0] < self._CHUNK_PAIRS:
                self._eof = True
            if ui.shape[0]:
                oi, oq = self._dec.push(ui, uq)
                self._bi = np.concatenate([self._bi, oi])
                self._bq = np.concatenate([self._bq, oq])
            if self._eof:
                oi, oq = self._dec.flush()
                self._bi = np.concatenate([self._bi, oi])
                self._bq = np.concatenate([self._bq, oq])
        take = min(n, self._bi.shape[0])
        oi, self._bi = self._bi[:take], self._bi[take:]
        oq, self._bq = self._bq[:take], self._bq[take:]
        return oi, oq

    def close(self) -> None:
        self._conn.close()


def read_window(source: Source) -> tuple[np.ndarray, np.ndarray] | None:
    """Pull one full 120 s window; None if the source ran dry."""
    i, q = source.read(SIGNAL_SAMPLES)
    if i.shape[0] == 0:
        return None
    if i.shape[0] < SIGNAL_SAMPLES:
        pad = np.zeros(SIGNAL_SAMPLES - i.shape[0], np.float32)
        i = np.concatenate([i, pad])
        q = np.concatenate([q, pad])
    return i.astype(np.float32), q.astype(np.float32)

"""Shared inputs and helpers of the port's parity tests (tests/test_torch_*).

Inputs are made from a seed with numpy and handed to both packages: the
JAX package (forced to the CPU by tests/conftest.py) and the PyTorch
port with ``device="cpu"`` (its plain versions).
"""

from __future__ import annotations

import numpy as np
import pytest

from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

CPU = "cpu"


def windows3():
    """(B=3, 45000) planar windows: two overlapping signals (the weak
    one decodes only after pass 1's subtraction), one single signal,
    one noise only."""
    wins = []
    i, q = synth_window_at_snr(["K1JT FN20 37", "K9AN EN50 33"],
                               snr_db=[3.0, -12.0], f0=[-40.0, -35.0],
                               t0=[2.0, 1.0], seed=1)
    wins.append(normalize_minus3db(i, q))
    i, q = synth_window_at_snr("G4ABC IO91 30", snr_db=0.0, f0=30.0, seed=2)
    wins.append(normalize_minus3db(i, q))
    z = np.random.default_rng(3).normal(0, 1, (45000, 2)).astype(np.float32)
    wins.append(normalize_minus3db(z[:, 0], z[:, 1]))
    return (np.stack([w[0] for w in wins]), np.stack([w[1] for w in wins]))


@pytest.fixture()
def jax_host_fec(monkeypatch):
    """Pin the JAX package's FEC to the host decoder (no calibration
    run), and leave its calibration cache as it was found: empty."""
    from rtlsdr_wsprd_tpu.ops import calibrate

    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    calibrate._CACHE.clear()
    yield
    calibrate._CACHE.clear()


@pytest.fixture(autouse=True)
def port_calibration(monkeypatch):
    """Give the port's FEC calibration a cache of its own for each test
    of a module that imports this fixture (it is autouse there), so that
    what a test resolves never reaches the next test."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate

    monkeypatch.setattr(calibrate, "_CACHE", {})


def spot_key(s):
    """The fields that must be equal between the two packages."""
    return (s.call, s.loc, s.pwr, s.message, s.jitter, s.cycles, s.drift,
            s.noprint, s.ihash)


def assert_spots_match(port, ref):
    """Spot lists equal in call, loc, pwr, message, jitter, cycles and
    drift; freq within 1e-7 MHz (0.1 Hz), dt within one sample (1/375
    s), snr within 0.01 dB and sync within 1e-4. The float tolerances
    cover float32 sums taken in another order; the shift and the fine
    frequency come out identical in practice."""
    assert [[spot_key(s) for s in ch] for ch in port] == \
        [[spot_key(s) for s in ch] for ch in ref]
    for pc, rc in zip(port, ref):
        for p, r in zip(pc, rc):
            assert p.freq == pytest.approx(r.freq, abs=1e-7)
            assert p.dt == pytest.approx(r.dt, abs=1.0 / 375.0)
            assert p.snr == pytest.approx(r.snr, abs=0.01)
            assert p.sync == pytest.approx(r.sync, abs=1e-4)


def unpack_commands(b: bytes) -> list[tuple[int, int]]:
    """rtl_tcp command bytes -> [(command, argument)] (5-byte packets)."""
    import struct

    return [struct.unpack(">BI", b[k:k + 5])
            for k in range(0, len(b) - len(b) % 5, 5)]


class LoopbackRtlTcp:
    """An rtl_tcp server on 127.0.0.1 for ``connections`` successive
    connections: each gets the RTL0 header, has its command bytes
    (5-byte packets) recorded until ``n_commands`` have arrived (in
    ``command_log``; the first connection's is ``command_bytes``), and
    is sent ``payload`` in odd-sized chunks (so the client must keep I/Q
    pairing across them), at most ``bytes_per_s`` when given, then
    closed."""

    def __init__(self, payload: bytes, n_commands: int = 4,
                 bytes_per_s: float | None = None, connections: int = 1):
        import socket
        import threading

        self.payload = payload
        self.n_commands = n_commands
        self.bytes_per_s = bytes_per_s
        self.connections = connections
        self.command_log: list[bytes] = []
        self.sent = 0
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def command_bytes(self) -> bytes:
        return self.command_log[0] if self.command_log else b""

    def _serve(self):
        try:
            for _ in range(self.connections):
                conn, _ = self._srv.accept()
                with conn:
                    self._serve_one(conn)
        finally:
            self._srv.close()

    def _serve_one(self, conn):
        import time

        conn.settimeout(10.0)
        conn.sendall(b"RTL0" + bytes(8))
        commands = b""
        while len(commands) < 5 * self.n_commands:
            got = conn.recv(4096)
            if not got:
                break
            commands += got
        self.command_log.append(commands)
        t0 = time.perf_counter()
        pos = 0
        while pos < len(self.payload):
            n = min(65537, len(self.payload) - pos)
            conn.sendall(self.payload[pos:pos + n])
            self.sent += n
            pos += n
            if self.bytes_per_s:
                ahead = pos / self.bytes_per_s - (time.perf_counter() - t0)
                if ahead > 0:
                    time.sleep(ahead)
        conn.shutdown(1)
        try:  # drain until the client closes, so sendall never resets
            while conn.recv(4096):
                pass
        except OSError:
            pass

    def join(self, timeout: float = 20.0) -> None:
        self._thread.join(timeout)
        assert not self._thread.is_alive(), "loopback server did not finish"


def tone_payload(f_baseband_hz: float, seconds: float,
                 amp: float = 40.0) -> bytes:
    """Interleaved uint8 IQ of a tone that lands at ``f_baseband_hz``
    after the front end (raw frequency f - 600 kHz, the fs/4 offset of
    runtime/synth.py)."""
    fs = 2_400_000
    n = int(seconds * fs)
    t = np.arange(n, dtype=np.float64) / fs
    ph = 2.0 * np.pi * (f_baseband_hz - 600_000.0) * t
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.rint(128 + amp * np.cos(ph)), 0, 255)
    raw[1::2] = np.clip(np.rint(128 + amp * np.sin(ph)), 0, 255)
    return raw.tobytes()

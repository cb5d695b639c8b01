"""Soak/fault run of the port's many-channel daemon: the mirror of
tests/test_soak_faults.py on rtlsdr_wsprd_tpu_torch, on the CPU.

ONE continuous MultiChannelDaemon run over a loopback rtl_tcp server
(the JAX test's scripted server and stream: message A, a server restart,
a noise window, message C, then an unpaced burst) survives, in order,
(a) the server restart (one auto-reconnect), (b) a poisoned window batch
(the port has no crash-retry envelope, so the batch's decode_channels
raises directly; the pipelined on_error isolates it) and (c) a forced
RX-ring overflow, with the same decoded messages and stats counts as
the JAX test asserts.
"""

import pytest

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.runtime.banks import RtlTcpBank
from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon

from test_soak_faults import FS, RING, _ScriptedServer


@pytest.mark.slow
def test_port_daemon_survives_restart_poison_and_overflow(monkeypatch):
    import rtlsdr_wsprd_tpu_torch.parallel.multichannel as pmc

    srv = _ScriptedServer()
    bank = RtlTcpBank([("127.0.0.1", srv.port, 14_095_600, dict(
        reconnect=True, reconnect_backoff_s=0.1, max_reconnects=2,
        max_buffer_bytes=RING))])

    # fault (b): the second window batch's decode raises; depth=1 makes
    # batch order the call order
    real = pmc.decode_channels
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("poisoned window batch")
        return real(*args, **kwargs)

    monkeypatch.setattr(pmc, "decode_channels", flaky)

    # stall the consumer once every scripted window's content is read
    # (360 s of stream): the filler burst then lands while reads wait,
    # overflowing the bounded ring deterministically
    orig_read = bank.read
    state = {"pairs": 0}

    def gated_read(n):
        if state["pairs"] >= 360 * FS:
            srv.burst_done.wait(timeout=300.0)
        oi, oq = orig_read(n)
        state["pairs"] += oi.shape[1]
        return oi, oq

    bank.read = gated_read

    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           device_batch=1, chunk_s=2.0, depth=1,
                           device="cpu")
    out = d.run()
    bank.close()
    assert srv.error is None, (srv.stage, srv.error, d.stats,
                               bank._conns[0].reconnects, len(out))

    # three full windows: the post-overflow filler never fills one
    assert len(out) == 3
    # (a) one reconnect rode out the server restart
    assert bank._conns[0].reconnects == 1
    # (b) the poisoned batch is counted and isolated
    assert d.stats.errors == 1
    assert out[1] == [[]]
    # (c) the burst overflowed the bounded ring and was counted
    assert bank.dropped_bytes[0] >= (8 << 20)
    got1 = {(s.call, s.loc, s.pwr) for s in out[0][0]}
    got3 = {(s.call, s.loc, s.pwr) for s in out[2][0]}
    assert ("K1JT", "FN20", "37") in got1
    assert ("W1AW", "FN31", "30") in got3

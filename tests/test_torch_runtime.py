"""The port's runtime layer against the JAX package's, on the CPU: IQ
file formats, wsprnet report strings and the reporter's queue, the
rtl_tcp source and the host-placed front end, the single-channel
daemon, the many-channel daemon's window assembly and reporting, and
the callsign hashtable file they share.

The JAX side runs as its own tests run it (tests/conftest.py forces the
CPU); the port runs with ``device="cpu"``. No test here takes the JAX
package's native-library paths as its reference."""

import time

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.models.decoder import Spot as JSpot
from rtlsdr_wsprd_tpu.runtime import iqio as jiqio
from rtlsdr_wsprd_tpu.runtime import multidaemon as jmd
from rtlsdr_wsprd_tpu.runtime import reporting as jrep
from rtlsdr_wsprd_tpu.runtime import scheduler as jsched
from rtlsdr_wsprd_tpu.runtime import sources as jsrc
from rtlsdr_wsprd_tpu_torch.config import SIGNAL_SAMPLES, DecoderOptions
from rtlsdr_wsprd_tpu_torch.models.decoder import Spot
from rtlsdr_wsprd_tpu_torch.runtime import iqio as piqio
from rtlsdr_wsprd_tpu_torch.runtime import multidaemon as pmd
from rtlsdr_wsprd_tpu_torch.runtime import reporting as prep
from rtlsdr_wsprd_tpu_torch.runtime import scheduler as psched
from rtlsdr_wsprd_tpu_torch.runtime import sources as psrc

from torch_parity import (
    CPU,
    LoopbackRtlTcp,
    assert_spots_match,
    tone_payload,
    unpack_commands,
)
from torch_parity import jax_host_fec  # noqa: F401  (fixture)
from torch_parity import port_calibration  # noqa: F401  (fixture)

GTM = time.struct_time((2026, 8, 16, 12, 34, 0, 0, 0, 0))


def _window(seed: int = 5):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 0.2, (2, SIGNAL_SAMPLES)).astype(np.float32)
    return z[0], z[1]


# ---- IQ files ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["iq", "c2"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_iq_files_cross_read_bit_equal(tmp_path, fmt, writer):
    """A capture written by one package reads back bit-equal in the
    other (Q negated both ways, -3 dB normalization on read), and both
    packages write the same bytes."""
    i, q = _window()
    files = {}
    for name, mod in (("jax", jiqio), ("port", piqio)):
        f = tmp_path / f"{name}.{fmt}"
        if fmt == "iq":
            mod.write_iq_file(i, q, f)
        else:
            mod.write_c2_file(i, q, f, 14_095_600.0, name="K1JT-test")
        files[name] = f
    assert files["jax"].read_bytes() == files["port"].read_bytes()
    reader = piqio if writer == "jax" else jiqio
    ref = jiqio if writer == "jax" else piqio
    for normalize in (True, False):
        if fmt == "iq":
            got = reader.read_iq_file(files[writer], normalize=normalize)
            want = ref.read_iq_file(files[writer], normalize=normalize)
        else:
            got = reader.read_c2_file(files[writer], normalize=normalize)
            want = ref.read_c2_file(files[writer], normalize=normalize)
            assert got[2] == want[2] == 14_095_600.0
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)
    raw = piqio.read_iq_file(files[writer], normalize=False) if fmt == "iq" \
        else piqio.read_c2_file(files[writer], normalize=False)[:2]
    assert np.array_equal(raw[0], i) and np.array_equal(raw[1], q)


def test_iq_write_rejects_partial_window(tmp_path):
    i, q = _window()
    with pytest.raises(ValueError, match="whole windows"):
        piqio.write_iq_file(i[:100], q[:100], tmp_path / "x.iq")


# ---- report strings ---------------------------------------------------------

SPOTS = {
    "plain": dict(freq=14.097101, sync=0.5, snr=-19.0, dt=0.3, drift=-1.0,
                  jitter=0, message="K1JT FN20 37", call="K1JT", loc="FN20",
                  pwr="37", cycles=1234),
    "type3": dict(freq=7.040112, sync=0.41, snr=-24.6, dt=1.9, drift=2.0,
                  jitter=-3, message="<PJ4/K1ABC> FK52UD 37",
                  call="<PJ4/K1ABC>", loc="FK52UD", pwr="37", cycles=88,
                  ihash=12345),
    "negative dt": dict(freq=0.001547, sync=0.9, snr=-0.6, dt=-1.05,
                        drift=0.0, jitter=5, message="G4ABC IO91 30",
                        call="G4ABC", loc="IO91", pwr="30", cycles=81),
    "noprint": dict(freq=14.097050, sync=0.3, snr=-28.4, dt=0.0, drift=-4.0,
                    jitter=0, message="<...> JO22AB 23", call="<...>",
                    loc="JO22AB", pwr="23", cycles=500, noprint=True,
                    ihash=77),
}


@pytest.mark.parametrize("kind", sorted(SPOTS))
def test_report_strings_equal_jax(kind, capsys):
    """Console lines, the printed window and both wsprnet URLs are the
    JAX package's, character for character."""
    p, j = Spot(**SPOTS[kind]), JSpot(**SPOTS[kind])
    assert prep.WSPRNET_BASE == jrep.WSPRNET_BASE
    assert prep.WSPRNET_APP_VERSION == jrep.WSPRNET_APP_VERSION
    assert prep.format_spot_line(p, GTM) == jrep.format_spot_line(j, GTM)
    assert prep.format_table_line(p) == jrep.format_table_line(j)
    assert prep.format_table_header() == jrep.format_table_header()
    assert prep.format_no_spot_line(GTM) == jrep.format_no_spot_line(GTM)
    for rcall, rloc in (("A1XYZ", "AB12cd"), ("W1AW/P", "FN31")):
        assert prep.spot_url(p, rcall, rloc, GTM) == \
            jrep.spot_url(j, rcall, rloc, GTM)
        assert prep.heartbeat_url(rcall, rloc, p.freq * 1e6) == \
            jrep.heartbeat_url(rcall, rloc, j.freq * 1e6)
    for spots in ([p], []):
        prep.print_spots(spots, GTM)
        mine = capsys.readouterr().out
        jrep.print_spots([j] if spots else [], GTM)
        assert mine == capsys.readouterr().out


# ---- the reporter's queue ---------------------------------------------------

def _scripted(outcomes):
    """A transport that fails or succeeds by ``outcomes`` (True =
    deliver), recording what it delivered; past the script it
    delivers."""
    delivered = []
    it = iter(outcomes)

    def transport(url):
        if not next(it, True):
            raise OSError("wsprnet down")
        delivered.append(url)

    return transport, delivered


def test_reporter_retry_backoff_drop_match_jax(capsys):
    """Under the same scripted outage the port's reporter goes through
    the JAX reporter's states: pending, dropped, the backoff interval
    after every drain, and what it delivered in the end."""
    # two spots fail twice, the heartbeat once; then both spots fail a
    # third time (dropped) and the heartbeat goes through
    outcomes = [False] * 7 + [True]
    trace = {}
    for name, mod, S in (("port", prep, Spot), ("jax", jrep, JSpot)):
        transport, delivered = _scripted(outcomes)
        rep = mod.WsprnetReporter("A1XYZ", "AB12cd", 14_095_600,
                                  transport=transport)
        rep.MAX_ATTEMPTS = 3
        states = []
        rep.post([S(**SPOTS["plain"]), S(**SPOTS["type3"])], GTM)
        states.append((rep.pending, rep.dropped, rep._backoff))
        rep.post([], GTM)  # a spotless window: one wsprstat heartbeat
        states.append((rep.pending, rep.dropped, rep._backoff))
        for _ in range(4):
            rep.flush()
            states.append((rep.pending, rep.dropped, rep._backoff))
        trace[name] = (states, delivered)
    assert trace["port"] == trace["jax"]
    states, delivered = trace["port"]
    assert states[-1][:2] == (0, 2)   # two reports ran out of attempts
    assert len(delivered) == 1 and "function=wsprstat" in delivered[0]
    assert capsys.readouterr().err.count("report dropped after") == 4


def test_reporter_queue_overflow_counts_dropped(capsys):
    """The bounded queue evicts its oldest report when full, and every
    eviction counts as a drop, announced on stderr only."""

    class Tiny(prep.WsprnetReporter):
        MAX_QUEUE = 2

    rep = Tiny("A1XYZ", "AB12cd", 14_095_600,
               transport=_scripted([False] * 10)[0])
    rep._thread = object()  # enqueue only: no inline drain
    rep._wake = type("E", (), {"set": lambda self: None})()
    for _ in range(3):
        rep.post([Spot(**SPOTS["plain"])], GTM)
    assert (rep.pending, rep.dropped) == (2, 1)
    cap = capsys.readouterr()
    assert "retry queue full" in cap.err and not cap.out


def test_reporter_background_delivery_and_close():
    """With a background worker, post() only enqueues (a slow wsprnet
    never holds the caller), the worker retries a failed report, and
    close() joins the worker and delivers what is left."""
    delivered = []
    fails = {"n": 1}

    def slow(url):
        time.sleep(0.05)
        if fails["n"]:
            fails["n"] -= 1
            raise OSError("transient")
        delivered.append(url)

    rep = prep.WsprnetReporter("A1XYZ", "AB12cd", 14_095_600,
                               transport=slow, background=True)
    t0 = time.perf_counter()
    for _ in range(3):
        rep.post([Spot(**SPOTS["plain"])], GTM)
    assert time.perf_counter() - t0 < 0.05
    deadline = time.time() + 5.0
    while fails["n"] and time.time() < deadline:
        time.sleep(0.01)  # the worker's first, failing, attempt
    rep.close()
    assert rep._thread is None
    assert len(delivered) == 3 and rep.pending == 0 and rep.dropped == 0


# ---- rtl_tcp source and front ends -----------------------------------------

def test_rtltcp_source_commands_and_samples_match_jax():
    """The port's RtlTcpSource sends the JAX source's tuning bytes (the
    reference's recipe, rtlsdr_wsprd.c:1044-1124: rate, direct
    sampling, ppm, gain mode and gain, centre = dial + 600 kHz + 1500
    Hz), and its 375 sps samples of a streamed tone lie within 1e-3 of
    the output scale of the JAX device-placed StreamingDecimator's."""
    payload = tone_payload(62.5, seconds=2.0)
    got = {}
    for name in ("port", "jax"):
        srv = LoopbackRtlTcp(payload, n_commands=6)
        kw = dict(dialfreq_hz=7_038_600, gain_tenths_db=330, ppm=-7,
                  directsampling=2, frontend="device")
        if name == "port":
            src = psrc.RtlTcpSource("127.0.0.1", srv.port, device=CPU, **kw)
        else:
            src = jsrc.RtlTcpSource("127.0.0.1", srv.port, **kw)
        i, q = src.read(700)
        rest = src.read(10_000)
        src.close()
        srv.join()
        got[name] = (srv.command_bytes, i, q, rest[0].shape[0],
                     src.dropped_bytes)
    cmds, pi, pq, prest, pdrop = got["port"]
    jcmds, ji, jq, jrest, jdrop = got["jax"]
    assert cmds == jcmds
    assert unpack_commands(cmds) == [(0x02, 2_400_000), (0x09, 2),
                             (0x05, (-7) & 0xFFFFFFFF), (0x03, 1),
                             (0x04, 330), (0x01, 7_038_600 + 601_500)]
    assert pi.shape == ji.shape == (700,) and prest == jrest
    scale = float(np.abs(ji).max())
    assert scale > 1.0
    np.testing.assert_allclose(pi, ji, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(pq, jq, rtol=0, atol=1e-3 * scale)
    assert pdrop == jdrop == 0


def test_rtltcp_overflow_drop_keeps_iq_pairing():
    """A ring of 1 MiB against a 9.6 MB stream sent in odd-sized chunks:
    the port's connection drops whole I/Q pairs only, so the surviving
    raw samples still hold the tone at +f (a one-byte slip would mirror
    it)."""
    f_b = 62.5
    srv = LoopbackRtlTcp(tone_payload(f_b, seconds=2.0))
    conn = psrc.RtlTcpConnection("127.0.0.1", srv.port, 14_095_600,
                                 max_buffer_bytes=1 << 20)
    deadline = time.time() + 20.0
    while not conn._eof and time.time() < deadline:
        time.sleep(0.05)
    assert conn.dropped_bytes > 0 and conn.dropped_bytes % 2 == 0
    i, q = conn.read_pairs(1 << 19)
    conn.close()
    srv.join()
    assert i.shape[0] >= 200_000
    z = (i.astype(np.float32) - 128) + 1j * (q.astype(np.float32) - 128)
    t = np.arange(z.shape[0]) / 2_400_000.0
    z = z * np.exp(-2j * np.pi * (f_b - 600_000.0) * t)
    alt = z * np.exp(-2j * np.pi * 2 * (600_000.0 - f_b) * t)
    assert np.abs(z.mean()) > 10 * np.abs(alt.mean())


def test_rtltcp_source_rejects_bad_header():
    """A server that does not answer RTL0 is refused before any tuning,
    and no RX thread is left behind."""
    import socket
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"NOPE" + bytes(8))
        conn.close()
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    before = {th.name for th in threading.enumerate()}
    with pytest.raises(IOError, match="not an rtl_tcp server"):
        psrc.RtlTcpSource("127.0.0.1", srv.getsockname()[1], 14_095_600,
                          device=CPU)
    t.join(10.0)
    assert "rtltcp-rx" not in {th.name for th in threading.enumerate()} \
        - before


def test_rtltcp_reconnect_rides_out_server_restart():
    """reconnect=True: on stream loss the RX thread redials, replays the
    whole tuning burst, and nothing of either stream is lost."""
    srv = LoopbackRtlTcp(tone_payload(62.5, seconds=0.5), connections=2)
    conn = psrc.RtlTcpConnection("127.0.0.1", srv.port, 14_095_600,
                                 reconnect=True, reconnect_backoff_s=0.1,
                                 max_reconnects=3)
    total = len(srv.payload)  # two streams of len/2 pairs each
    i, q = conn.read_pairs(total)  # EOF once the retry budget is spent
    conn.close()
    srv.join()
    assert i.shape[0] == total and conn.reconnects == 1
    assert len(srv.command_log) == 2
    assert srv.command_log[0] == srv.command_log[1]
    assert unpack_commands(srv.command_log[1])[-1] == (
        0x01, 14_095_600 + 601_500)


def test_rtltcp_bank_aligned_reads_through_batched_frontend():
    """Two loopback servers -> RtlTcpBank aligned uint8 reads -> the
    port's BatchedStreamingDecimator (on the CPU): each channel's tone
    lands at its own baseband frequency, nothing dropped."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.runtime.banks import RtlTcpBank

    tones = [62.5, -93.75]
    servers = [LoopbackRtlTcp(tone_payload(f, seconds=2.0)) for f in tones]
    bank = RtlTcpBank([("127.0.0.1", s.port, 14_095_600) for s in servers])
    dec = BatchedStreamingDecimator(2, device=CPU)
    outs = []
    while True:
        ri, rq = bank.read(1_200_000)
        assert ri.dtype == np.uint8 and ri.shape == rq.shape
        outs.append(dec.push(ri, rq))
        if ri.shape[1] < 1_200_000:
            break
    outs.append(dec.flush())
    bank.close()
    for s in servers:
        s.join()
    bi = np.concatenate([o[0] for o in outs], axis=1)
    bq = np.concatenate([o[1] for o in outs], axis=1)
    assert bi.shape[0] == 2 and bi.shape[1] >= 700
    for ch, f_b in enumerate(tones):
        z = (bi[ch] + 1j * bq[ch]) * np.hanning(bi.shape[1])
        spec = np.fft.fftshift(np.abs(np.fft.fft(z)))
        freqs = np.fft.fftshift(np.fft.fftfreq(bi.shape[1], 1 / 375.0))
        assert abs(freqs[int(np.argmax(spec))] - f_b) < 1.0
    assert bank.dropped_bytes == [0, 0]


def test_native_ingest_bindings():
    """The port's uint8 ingest bindings split interleaved bytes into
    planes (centred by -128 or not) and ignore an odd trailing byte;
    the host decimators refuse inputs of the wrong length."""
    from rtlsdr_wsprd_tpu_torch import native

    raw = np.random.default_rng(4).integers(0, 256, 2 * 1000 + 1,
                                            dtype=np.uint8)
    i, q = native.u8_deinterleave_pairs(raw)
    assert i.dtype == np.uint8 and np.array_equal(i, raw[0:2000:2])
    assert np.array_equal(q, raw[1:2000:2])
    ci, cq = native.u8_deinterleave_center(raw)
    assert ci.dtype == np.float32
    assert np.array_equal(ci, raw[0:2000:2].astype(np.float32) - 128)
    assert np.array_equal(cq, raw[1:2000:2].astype(np.float32) - 128)
    g = np.ones(640, np.float32)
    with pytest.raises(ValueError, match="inputs must be"):
        native.pp_decimate(ci, cq, g, g, 80, 10)
    with pytest.raises(ValueError, match="inputs must be"):
        native.fir_decimate(ci, cq, g, 80, 10)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_host_frontend_matches_device_frontend(dtype):
    """The host-placed front end (native C++ polyphase) against the
    port's device front end run on the CPU (its plain versions), both
    batched and single-lane, over odd-sized pushes: the same 375 sps
    samples within 2e-4 of the output scale."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
        StreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.frontend.host_decimate import (
        HostBatchedStreamingDecimator,
        HostStreamingDecimator,
        resolve_placement,
    )

    rng = np.random.default_rng(9)
    n = 2_400_000 + 12_345
    if dtype == "uint8":
        raw = rng.integers(0, 256, (2, 2, n), dtype=np.uint8)
    else:
        raw = rng.normal(0, 20, (2, 2, n)).astype(np.float32)
    cuts = [0, 777_777, 1_600_001, n]

    def run(dec, rows):
        outs = [dec.push(raw[0][rows, a:b], raw[1][rows, a:b])
                for a, b in zip(cuts, cuts[1:])]
        outs.append(dec.flush())
        axis = 1 if raw[0][rows].ndim == 2 else 0
        return (np.concatenate([o[0] for o in outs], axis=axis),
                np.concatenate([o[1] for o in outs], axis=axis))

    pairs = [(run(HostBatchedStreamingDecimator(2, threads=2), slice(None)),
              run(BatchedStreamingDecimator(2, device=CPU), slice(None))),
             (run(HostStreamingDecimator(), 0),
              run(StreamingDecimator(device=CPU), 0))]
    for (hi, hq), (di, dq) in pairs:
        assert hi.shape == di.shape and hi.shape[-1] >= 350
        scale = float(np.abs(di).max())
        np.testing.assert_allclose(hi, di, rtol=0, atol=2e-4 * scale)
        np.testing.assert_allclose(hq, dq, rtol=0, atol=2e-4 * scale)
    assert resolve_placement("auto") == "device"
    assert resolve_placement("host") == "host"
    with pytest.raises(ValueError):
        resolve_placement("tpu")


# ---- the single-channel daemon ---------------------------------------------

def test_wsprdaemon_matches_jax(tmp_path, jax_host_fec, capsys):
    """Two windows of a seeded SyntheticBasebandSource (two signals a
    window) through each package's WsprDaemon (align=False): the same
    spots within torch_parity's tolerances, the same printed lines and
    one wsprnet URL per spot."""
    msgs, snrs, f0s = ["K1JT FN20 37", "K9AN EN50 33"], [6.0, -8.0], \
        [20.0, -45.0]
    out = {}
    for name, src_mod, sched, O in (("port", psrc, psched, DecoderOptions),
                                    ("jax", jsrc, jsched, JOptions)):
        posted = []
        rep = (prep if name == "port" else jrep).WsprnetReporter(
            "A1XYZ", "AB12cd", 14_095_600, transport=posted.append)
        kw = dict(device=CPU) if name == "port" else {}
        d = sched.WsprDaemon(
            src_mod.SyntheticBasebandSource(msgs, snrs, f0s, seed=42),
            O(freq=14_095_600, rcall="A1XYZ", rloc="AB12cd",
              quickmode=True),
            reporter=rep, hashtable_path=str(tmp_path / f"{name}.txt"),
            **kw)
        res = d.run(maxloop=2, align=False, _now=lambda: 1_000_000.0)
        out[name] = (res, posted, d.stats, capsys.readouterr().out)
    pres, pposted, pstats, pout = out["port"]
    jres, jposted, jstats, jout = out["jax"]
    assert len(pres) == 2 and all(r.error is None for r in pres)
    assert_spots_match([r.spots for r in pres], [r.spots for r in jres])
    assert {s.message for r in pres for s in r.spots} == set(msgs)
    assert (pstats.windows, pstats.spots, pstats.errors) == \
        (jstats.windows, jstats.spots, jstats.errors) == (2, 4, 0)
    assert len(pposted) == len(jposted) == 4
    assert pposted == [prep.spot_url(s, "A1XYZ", "AB12cd", r.gtm)
                       for r in pres for s in r.spots]
    assert pout.count("Spot :  ") == jout.count("Spot :  ") == 4


def test_wsprdaemon_isolates_a_failed_window(capsys):
    """A window whose decode raises counts in stats.errors, posts
    nothing, and the stream goes on to the next window."""
    src = psrc.SyntheticBasebandSource("K1JT FN20 37", 8.0, 20.0, seed=3)
    posted = []
    rep = prep.WsprnetReporter("A1XYZ", "AB12cd", 14_095_600,
                               transport=posted.append)
    d = psched.WsprDaemon(src, DecoderOptions(quickmode=True),
                          reporter=rep, device=CPU)
    real = d.decoder.decode
    calls = {"n": 0}

    def flaky(i, q):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("poisoned window")
        return real(i, q)

    d.decoder.decode = flaky
    res = d.run(maxloop=2, align=False)
    assert res[0].error and "poisoned window" in res[0].error
    assert res[1].error is None
    assert [s.message for s in res[1].spots] == ["K1JT FN20 37"]
    assert (d.stats.windows, d.stats.errors) == (2, 1)
    assert len(posted) == 1
    assert "Window decode failed" in capsys.readouterr().out


def test_wsprdaemon_align_discards_preboundary_once():
    """align=True sleeps to each 2-minute boundary and drops the
    pre-boundary backlog before the first window only."""

    class Src(psrc.Source):
        discards = 0
        windows = 0

        def read(self, n):
            if self.windows >= 2:
                return np.zeros(0, np.float32), np.zeros(0, np.float32)
            self.windows += 1
            return (np.zeros(SIGNAL_SAMPLES, np.float32),) * 2

        def discard_buffered(self):
            self.discards += 1

    sleeps = []
    src = Src()
    d = psched.WsprDaemon(src, DecoderOptions(quickmode=True), quiet=True,
                          device=CPU)
    d.run(maxloop=2, align=True, _sleep=sleeps.append, _now=lambda: 1000.0)
    assert src.discards == 1
    assert sleeps == [pytest.approx(120.0 - 1000.0 % 120.0)] * 2


# ---- the many-channel daemon -----------------------------------------------

def test_normalize_rows_matches_jax():
    rng = np.random.default_rng(3)
    wi = rng.normal(size=(3, 1000)).astype(np.float32)
    wq = rng.normal(size=(3, 1000)).astype(np.float32)
    wq[1] *= 7.0
    got = pmd.normalize_rows_minus3db(wi, wq)
    ref = jmd.normalize_rows_minus3db(wi, wq)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    for r in range(3):
        ri, rq = piqio.normalize_minus3db(wi[r], wq[r])
        np.testing.assert_allclose(got[0][r], ri, rtol=1e-6)
        np.testing.assert_allclose(got[1][r], rq, rtol=1e-6)


class _ZeroBank:
    """A raw bank of C channels that serves ``reads`` full chunks of
    zero bytes, then a short one (its end)."""

    def __init__(self, n_channels: int, reads: int):
        self.n_channels = n_channels
        self.reads = reads

    def read(self, n):
        m = n if self.reads > 0 else n // 2
        self.reads -= 1
        return (np.zeros((self.n_channels, m), np.uint8),) * 2

    def discard_buffered(self):
        pass

    def close(self):
        pass


class _BasebandFrontEnd:
    """Stands in for the front end: each push hands out the next piece
    of prepared 375 sps baseband (C, L), flush the rest."""

    def __init__(self, bi, bq, pieces: int):
        self.parts = np.array_split(np.arange(bi.shape[1]), pieces)
        self.bi, self.bq, self.k = bi, bq, 0

    def push(self, ri, rq):
        if self.k >= len(self.parts):
            return self.bi[:, :0], self.bq[:, :0]
        idx = self.parts[self.k]
        self.k += 1
        return self.bi[:, idx], self.bq[:, idx]

    def flush(self):
        rest = np.concatenate(self.parts[self.k:]) if \
            self.k < len(self.parts) else np.zeros(0, int)
        self.k = len(self.parts)
        return self.bi[:, rest], self.bq[:, rest]


@pytest.mark.parametrize("tail", [44_000, 40_000])
def test_window_batches_assembly_and_padding_match_jax(tail):
    """Window assembly from 375 sps pieces: whole windows, then a final
    partial window zero-padded when it holds at least 117 s (44,000
    samples) and dropped when shorter (40,000); each row normalized to
    a 0.5 peak. The port's batches equal the JAX daemon's bit for bit
    on the same pieces."""
    rng = np.random.default_rng(tail)
    L = SIGNAL_SAMPLES + tail
    bi = rng.normal(0, 3, (2, L)).astype(np.float32)
    bq = rng.normal(0, 3, (2, L)).astype(np.float32)
    got = {}
    for name, mod, O in (("port", pmd, DecoderOptions),
                         ("jax", jmd, JOptions)):
        kw = dict(device=CPU) if name == "port" else {}
        d = mod.MultiChannelDaemon(_ZeroBank(2, reads=6), O(quickmode=True),
                                   chunk_s=0.001, frontend="device", **kw)
        d._dec = _BasebandFrontEnd(bi, bq, pieces=7)
        got[name] = list(d.window_batches())
    assert len(got["port"]) == len(got["jax"]) == (2 if tail >= 117 * 375
                                                   else 1)
    for (pi, pq), (ji, jq) in zip(got["port"], got["jax"]):
        assert pi.shape == (2, SIGNAL_SAMPLES)
        assert np.array_equal(pi, ji) and np.array_equal(pq, jq)
        peaks = np.maximum(np.abs(pi).max(axis=1), np.abs(pq).max(axis=1))
        np.testing.assert_allclose(peaks, 0.5, rtol=1e-6)
    if tail >= 117 * 375:
        assert not got["port"][1][0][:, tail:].any()


def _report_pair(reporters_for, dialfreqs):
    """The port's and the JAX daemon's _report on the same two-channel
    spot lists (channel 0 has a spot, channel 1 none)."""
    out = {}
    for name, mod, O, S in (("port", pmd, DecoderOptions, Spot),
                            ("jax", jmd, JOptions, JSpot)):
        reps, posted = reporters_for(name)
        kw = dict(device=CPU) if name == "port" else {}
        d = mod.MultiChannelDaemon(
            _ZeroBank(2, reads=0),
            O(freq=14_095_600, rcall="A1XYZ", rloc="AB12"),
            dialfreqs=dialfreqs, frontend="device", **kw, **reps)
        per = [d._report([[S(**SPOTS["plain"])], []], GTM),
               d._report([[], []], time.gmtime(120))]
        out[name] = (per, posted, d.stats)
    return out


def test_dial_rebase_and_heartbeats_match_jax():
    """A two-band bank: channel 1's spots rebase from the decode dial
    (20 m) to its own (40 m), each channel posts through its own
    reporter, and a spotless channel-window posts the wsprstat
    heartbeat at its own dial (rtlsdr_wsprd.c:389-411); URLs equal the
    JAX daemon's."""
    dials = [14_095_600, 7_038_600]

    def reporters_for(name):
        mod = prep if name == "port" else jrep
        posted = [[], []]
        return dict(reporters=[
            mod.WsprnetReporter("A1XYZ", "AB12", df,
                                transport=posted[k].append)
            for k, df in enumerate(dials)]), posted

    out = _report_pair(reporters_for, dials)
    (pper, pposted, pstats), (jper, jposted, _) = out["port"], out["jax"]
    assert pposted == jposted
    assert "function=wspr&" in pposted[0][0]
    assert "function=wsprstat" in pposted[1][0]
    assert "rqrg=7.038600" in pposted[1][0]
    assert [len(p) for p in pposted] == [2, 2]
    assert [[s.freq for s in ch] for ch in pper[0]] == \
        [[s.freq for s in ch] for ch in jper[0]]
    # rebasing channel 1 a spot of the 20 m decode dial
    d = pmd.MultiChannelDaemon(_ZeroBank(2, reads=0),
                               DecoderOptions(freq=14_095_600),
                               dialfreqs=dials, device=CPU)
    moved = d._rebase([Spot(**SPOTS["plain"])], 1)[0]
    assert moved.freq == pytest.approx(
        SPOTS["plain"]["freq"] - (dials[0] - dials[1]) / 1e6)
    assert (pstats.window_batches, pstats.channel_windows,
            pstats.spots) == (2, 4, 1)


def test_dropped_reports_count_matches_jax(capsys):
    """Reports a reporter gives up on surface in
    MultiStats.dropped_reports, as in the JAX daemon."""

    def reporters_for(name):
        mod = prep if name == "port" else jrep
        rep = mod.WsprnetReporter("A1XYZ", "AB12", 14_095_600,
                                  transport=_scripted([False] * 10)[0])
        rep.MAX_ATTEMPTS = 1
        return dict(reporter=rep), []

    out = _report_pair(reporters_for, None)
    # a spot and a heartbeat, then two heartbeats: four reports, none
    # delivered
    assert out["port"][2].dropped_reports == \
        out["jax"][2].dropped_reports == 4
    assert "report dropped" in capsys.readouterr().err


def test_multichannel_daemon_run_matches_jax(jax_host_fec):
    """MultiChannelDaemon.run end to end after the front end: two
    channels of 375 sps synthetic baseband (one signal each, the second
    channel on 40 m) through window assembly, the pipelined decode and
    reporting, in both packages: the same spots within torch_parity's
    tolerances, rebased to each channel's dial, one URL per spot, no
    error."""
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr

    wins = [synth_window_at_snr("K1JT FN20 37", 6.0, 20.0, seed=7),
            synth_window_at_snr("G4ABC IO91 30", 4.0, -50.0, seed=8)]
    bi = np.stack([w[0] for w in wins]) * 40.0
    bq = np.stack([w[1] for w in wins]) * 40.0
    dials = [14_095_600, 7_038_600]
    got = {}
    for name, mod, O in (("port", pmd, DecoderOptions),
                         ("jax", jmd, JOptions)):
        kw = dict(device=CPU) if name == "port" else {}
        posted = [[], []]
        reps = [(prep if name == "port" else jrep).WsprnetReporter(
            "A1XYZ", "AB12", df, transport=posted[k].append)
            for k, df in enumerate(dials)]
        d = mod.MultiChannelDaemon(
            _ZeroBank(2, reads=4), O(freq=dials[0], quickmode=True),
            chunk_s=0.001, device_batch=2, fec="host", dialfreqs=dials,
            reporters=reps, frontend="device", **kw)
        d._dec = _BasebandFrontEnd(bi, bq, pieces=5)
        got[name] = (d.run(), posted, d.stats)
    (pout, pposted, pstats), (jout, jposted, jstats) = got["port"], \
        got["jax"]
    assert len(pout) == len(jout) == 1
    assert_spots_match(pout[0], jout[0])
    assert [[s.message for s in ch] for ch in pout[0]] == \
        [["K1JT FN20 37"], ["G4ABC IO91 30"]]
    assert pout[0][1][0].freq == pytest.approx(7.038600 + 1450e-6,
                                               abs=2e-6)
    assert [len(p) for p in pposted] == [len(p) for p in jposted] == [1, 1]
    assert (pstats.errors, pstats.spots, pstats.channel_windows) == \
        (jstats.errors, jstats.spots, jstats.channel_windows) == (0, 2, 2)


def test_multichannel_daemon_counts_a_failed_batch():
    """A window batch whose decode raises counts one error; the stream
    goes on, and the failed batch yields empty spot lists."""
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

    rng = np.random.default_rng(1)
    L = 2 * SIGNAL_SAMPLES
    bi = rng.normal(0, 1, (1, L)).astype(np.float32)
    bq = rng.normal(0, 1, (1, L)).astype(np.float32)
    d = pmd.MultiChannelDaemon(_ZeroBank(1, reads=4),
                               DecoderOptions(quickmode=True),
                               chunk_s=0.001, device_batch=1, fec="host",
                               device=CPU)
    d._dec = _BasebandFrontEnd(bi, bq, pieces=4)
    real = pmc.decode_channels
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("poisoned batch")
        return real(*a, **kw)

    pmc.decode_channels = flaky
    try:
        out = d.run(ingest_thread=False)
    finally:
        pmc.decode_channels = real
    assert len(out) == 2 and out[0] == [[]]
    assert (d.stats.errors, d.stats.window_batches) == (1, 2)


@pytest.mark.parametrize("kw, checks", [
    (dict(devices="all"), "devices all is the CPU device"),
    (dict(devices=["cuda:0", "cuda:1"]), "absent cards raise"),
    (dict(channelize=[14_095_600, 7_038_600]), "channelizer in front"),
])
def test_multichannel_daemon_later_slices_raise(kw, checks):
    """The settings that raised NotImplementedError in an earlier slice
    now configure the daemon (``checks`` names the case):
    ``devices="all"`` on the CPU decodes on the one CPU device, a list
    of cards that are not there raises (nothing falls back to the CPU),
    and ``channelize`` puts the channelizer in front, one output channel
    per dial at offset ``options.freq - dial``, the dials as
    ``dialfreqs``."""
    from rtlsdr_wsprd_tpu_torch.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )

    opts = DecoderOptions(freq=14_095_600)
    if kw.get("devices") == ["cuda:0", "cuda:1"]:
        with pytest.raises((RuntimeError, ValueError)):
            pmd.MultiChannelDaemon(_ZeroBank(1, reads=0), opts, device=CPU,
                                   **kw)
        return
    d = pmd.MultiChannelDaemon(_ZeroBank(1, reads=0), opts, device=CPU,
                               **kw)
    if "devices" in kw:
        assert d.devices == [torch.device("cpu")]
        return
    assert isinstance(d._dec, ChannelizingStreamingDecimator)
    assert d.n_out_channels == 2 and d.dialfreqs == kw["channelize"]
    np.testing.assert_array_equal(d._dec.offsets, [0.0, 7_057_000.0])
    with pytest.raises(ValueError, match="single-stream"):
        pmd.MultiChannelDaemon(_ZeroBank(2, reads=0), opts, device=CPU, **kw)


def test_host_frontend_daemon_placement(monkeypatch):
    """frontend='host' puts the native host decimator in front of the
    decode; 'auto' is the device front end on its device. The FEC
    banner names the daemon's device: the CPU is never measured."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate

    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC", raising=False)
    monkeypatch.setattr(calibrate, "_CACHE", {})
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.frontend.host_decimate import (
        HostBatchedStreamingDecimator,
    )

    host = pmd.MultiChannelDaemon(_ZeroBank(2, reads=0), DecoderOptions(),
                                  frontend="host", device=CPU)
    auto = pmd.MultiChannelDaemon(_ZeroBank(2, reads=0), DecoderOptions(),
                                  device=CPU)
    assert isinstance(host._dec, HostBatchedStreamingDecimator)
    assert isinstance(auto._dec, BatchedStreamingDecimator)
    assert (host.frontend_placement, auto.frontend_placement) == \
        ("host", "device")
    assert auto.describe_fec().startswith("host (method=default")


# ---- the callsign hashtable file -------------------------------------------

@pytest.mark.parametrize("teacher", ["jax", "port"])
def test_hashtable_file_carries_type3_between_packages(tmp_path, teacher,
                                                       jax_host_fec):
    """The daemons' persistent state: one package's WsprDaemon decodes a
    type-1 'PJ4/K1ABC 37' window and saves hashtable.txt (-H); the other
    package's daemon loads that file and decodes a type-3 window to
    '<PJ4/K1ABC> FK52UD 37'. Both packages write the same file."""
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr

    def window(msg, seed):
        return piqio.normalize_minus3db(
            *synth_window_at_snr(msg, snr_db=8.0, f0=20.0, seed=seed))

    def daemon(name, path):
        O, sched = (DecoderOptions, psched) if name == "port" else \
            (JOptions, jsched)
        kw = dict(device=CPU) if name == "port" else {}
        return sched.WsprDaemon(
            psrc.Source(), O(quickmode=True, usehashtable=True),
            hashtable_path=str(path), quiet=True, **kw)

    learner = "port" if teacher == "jax" else "jax"
    path = tmp_path / "hashtable.txt"
    taught = daemon(teacher, path).process_window(*window("PJ4/K1ABC 37", 41))
    assert [s.message for s in taught.spots] == ["PJ4/K1ABC 37"]
    other = tmp_path / "other.txt"
    daemon(learner, other).process_window(*window("PJ4/K1ABC 37", 41))
    assert path.read_text() == other.read_text() != ""
    res = daemon(learner, path).process_window(
        *window("<PJ4/K1ABC> FK52UD 37", 42))
    assert [(s.call, s.message) for s in res.spots] == \
        [("<PJ4/K1ABC>", "<PJ4/K1ABC> FK52UD 37")]

"""The port's two command lines against the JAX package's, on the CPU:
the flags each accepts, unit and band parsing, the self-test, file
decodes, the live daemon's wiring (synthetic source and rtl_tcp), the
device rule and the flags of later slices.

The port runs with ``--compute-device cpu``; the JAX CLIs run as their
own tests run them (tests/conftest.py forces the CPU)."""

import os
import time

import numpy as np
import pytest
import torch

import rtlsdr_wsprd_tpu.cli as jcli
import rtlsdr_wsprd_tpu.multicli as jmulti
import rtlsdr_wsprd_tpu_torch.cli as pcli
import rtlsdr_wsprd_tpu_torch.multicli as pmulti
from rtlsdr_wsprd_tpu.config import BAND_TABLE as JBANDS
from rtlsdr_wsprd_tpu_torch.config import BAND_TABLE

from torch_parity import LoopbackRtlTcp, tone_payload, unpack_commands
from torch_parity import jax_host_fec  # noqa: F401  (fixture)
from torch_parity import port_calibration  # noqa: F401  (fixture)

CPU_FLAG = ["--compute-device", "cpu"]


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("jmod, pmod", [(jcli, pcli), (jmulti, pmulti)],
                         ids=["cli", "multicli"])
def test_parsers_accept_the_jax_flags(jmod, pmod):
    """Every flag of the JAX CLI is a flag of the port's, with the same
    destination, default and choices; the port adds --compute-device
    only."""
    jp, pp = jmod.build_parser(), pmod.build_parser()
    assert _options(pp) - _options(jp) == {"--compute-device"}
    assert _options(jp) <= _options(pp)
    jact = {a.option_strings[0]: a for a in jp._actions}
    for a in pp._actions:
        if a.option_strings[0] in jact:
            b = jact[a.option_strings[0]]
            assert (a.dest, a.default, a.choices, a.nargs) == \
                (b.dest, b.default, b.choices, b.nargs)
    assert pp.parse_args(CPU_FLAG).compute_device == "cpu"
    assert pp.parse_args([]).compute_device is None


@pytest.mark.parametrize("text", [
    "125M", "2k", "1.5G", "42", "14.0956M", "-4.2k", " 7038600 ", "10m",
    "23cm", "LF", "2m", "1M25", "1296.5M"])
def test_atofs_and_frequencies_match_jax(text):
    if text.strip().lower() not in BAND_TABLE:
        assert pcli.atofs(text) == jcli.atofs(text)
    assert pcli.parse_frequency(text) == jcli.parse_frequency(text)


def test_band_table_equals_jax():
    assert BAND_TABLE == JBANDS and len(BAND_TABLE) == 18
    for band in BAND_TABLE:
        assert pcli.parse_frequency(band.upper()) == BAND_TABLE[band]


def _run_in(tmp_path, name, fn, capsys):
    d = tmp_path / name
    d.mkdir()
    old = os.getcwd()
    os.chdir(d)
    try:
        rc = fn()
    finally:
        os.chdir(old)
    return rc, capsys.readouterr(), d


def test_selftest_matches_jax(tmp_path, jax_host_fec, capsys):
    """-t: the same selftest.iq bytes, the same printed table and
    'Self-test SUCCESS!', exit 0."""
    prc, pout, pdir = _run_in(tmp_path, "port",
                              lambda: pcli.main(["-t", *CPU_FLAG]), capsys)
    jrc, jout, jdir = _run_in(tmp_path, "jax", lambda: jcli.main(["-t"]),
                              capsys)
    assert prc == jrc == 0
    assert pout.out == jout.out
    assert "Self-test SUCCESS!" in pout.out
    assert (pdir / "selftest.iq").read_bytes() == \
        (jdir / "selftest.iq").read_bytes()


@pytest.mark.parametrize("ext", ["iq", "c2"])
def test_readfile_table_matches_jax(tmp_path, ext, jax_host_fec, capsys):
    """-r FILE -Q: the printed table equals the JAX CLI's on the same
    two-signal capture (a .c2 file also sets the dial from its
    header)."""
    from rtlsdr_wsprd_tpu_torch.runtime import iqio
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr

    i, q = synth_window_at_snr(["K1JT FN20 37", "G4ABC IO91 30"],
                               snr_db=[4.0, -6.0], f0=[30.0, -70.0],
                               seed=17)
    f = tmp_path / f"capture.{ext}"
    if ext == "iq":
        iqio.write_iq_file(i, q, f)
    else:
        iqio.write_c2_file(i, q, f, 10_138_700.0, name="capture")
    argv = ["-r", str(f), "-Q"]
    assert pcli.main(argv + CPU_FLAG) == 0
    mine = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert mine == capsys.readouterr().out
    lines = mine.splitlines()
    assert lines[0] == "Number of samples: 45000"
    assert sum(line.startswith("Spot : ") for line in lines) == 2
    if ext == "c2":
        assert " 10.1402" in mine


def test_readfile_rejects_other_extensions(tmp_path, capsys):
    f = tmp_path / "capture.wav"
    f.write_bytes(b"\0" * 64)
    assert pcli.main(["-r", str(f), *CPU_FLAG]) == 1
    assert "Not a valid extension" in capsys.readouterr().err


def test_cli_validation_exits_like_jax(capsys):
    """The live daemon's argument checks (rtlsdr_wsprd.c:992-1013) and
    -i without a port: exit 1 with the JAX CLI's messages."""
    for argv in (["-f", "20m"], ["-f", "20m", "-c", "A1XYZ"],
                 ["-c", "A1XYZ", "-l", "AB12cd"],
                 ["-f", "20m", "-c", "A1XYZ", "-l", "AB12cd", "-i", "host"]):
        if argv[-2:] == ["-i", "host"]:
            # past validation the JAX CLI prints its banner (and
            # calibrates) first; only the error line is compared
            assert pcli.main(argv + CPU_FLAG) == 1
            assert "rtl_tcp source needs -i HOST:PORT" in \
                capsys.readouterr().err
            continue
        assert pcli.main(argv + CPU_FLAG) == 1
        mine = capsys.readouterr().err
        assert jcli.main(argv) == 1
        assert mine == capsys.readouterr().err


def test_entry_points_raise_without_a_card(tmp_path):
    """Without --compute-device and without a card, every mode of both
    CLIs raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is it")
    f = tmp_path / "x.iq"
    f.write_bytes(b"\0" * 16)
    for argv in (["-t"], ["-r", str(f)],
                 ["-f", "20m", "-c", "A1XYZ", "-l", "AB12", "--source",
                  "synth", "-n", "1", "--no-align"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmulti.main(["--synth", "1", "-n", "1", "-x"])
    assert not (tmp_path / "selftest.iq").exists()


class _RecordingReporter:
    """Stands in for WsprnetReporter in the CLI: records what the daemon
    posts; ``close`` reports two drops, as a reporter that ran out of
    retries would."""

    made = []

    def __init__(self, rcall, rloc, dialfreq, noreport=False,
                 background=True):
        self.posted = []
        self.dropped = 0
        self.dialfreq = dialfreq
        self.made.append(self)

    def post(self, spots, gtm):
        self.posted.append([s.message for s in spots])

    def close(self):
        self.dropped = 2


@pytest.mark.parametrize("name", ["port", "jax"])
def test_cli_synth_daemon_session(name, monkeypatch, capsys, jax_host_fec):
    """The live daemon on the synthetic 375 sps source, one window,
    --no-align: the spot, the session line, and the reporter's drops on
    stderr only; the two packages print the same spot fields."""
    mod = pcli if name == "port" else jcli
    _RecordingReporter.made = []
    monkeypatch.setattr(mod, "WsprnetReporter", _RecordingReporter)
    argv = ["-f", "20m", "-c", "A1XYZ", "-l", "AB12cd", "--source", "synth",
            "-n", "1", "--no-align", "-Q"]
    rc = mod.main(argv + (CPU_FLAG if name == "port" else []))
    cap = capsys.readouterr()
    assert rc == 0
    [rep] = _RecordingReporter.made
    assert rep.posted == [["K1JT FN20 20"]] and rep.dialfreq == 14_095_600
    spot = [line for line in cap.out.splitlines() if line.startswith("Spot")]
    assert len(spot) == 1 and spot[0].endswith("K1JT   FN20 20")
    assert "Session: 1 windows, 1 spots, 0 errors" in cap.out
    assert "2 report(s) dropped" in cap.err and "dropped" not in cap.out
    if name == "port":
        assert "FEC strategy : host (" in cap.out


def test_cli_rtltcp_tuning_matches_jax(monkeypatch, capsys, jax_host_fec):
    """The live daemon over a loopback rtl_tcp server (-f 40m -g 33 -p 5
    -o -200 -u 125M): the port's CLI sends the JAX CLI's tuning bytes; a
    2 s stream is shorter than the first window's 117 s, so the session
    ends with 0 windows and 0 errors."""
    sent = {}
    for name, mod in (("port", pcli), ("jax", jcli)):
        _RecordingReporter.made = []
        monkeypatch.setattr(mod, "WsprnetReporter", _RecordingReporter)
        srv = LoopbackRtlTcp(tone_payload(50.0, seconds=2.0), n_commands=6)
        argv = ["-f", "40m", "-c", "A1XYZ", "-l", "AB12cd", "-g", "33",
                "-p", "5", "-o", "-200", "-u", "125M", "-i",
                f"127.0.0.1:{srv.port}", "-n", "1", "--no-align", "-x"]
        rc = mod.main(argv + (CPU_FLAG if name == "port" else []))
        srv.join()
        sent[name] = srv.command_bytes
        out = capsys.readouterr().out
        assert rc == 0
        assert "Session: 0 windows, 0 spots, 0 errors" in out
    assert sent["port"] == sent["jax"]
    assert unpack_commands(sent["port"]) == [(0x02, 2_400_000), (0x09, 2), (0x05, 5), (0x03, 1),
                    (0x04, 330),
                    (0x01, 7_038_600 - 200 + 125_000_000 + 601_500)]


def test_multicli_argument_checks(capsys):
    """--endpoint and --synth are exclusive, reporting needs a callsign
    and a locator, and a malformed endpoint exits 1, as in the JAX
    multicli."""
    for argv in ([], ["--synth", "2", "--endpoint", "h:1:20m", "-x"],
                 ["--synth", "2"], ["--endpoint", "h:1", "-x"],
                 ["--endpoint", "h:1:0", "-x"]):
        assert pmulti.main(argv + CPU_FLAG) == 1
        mine = capsys.readouterr().err
        assert jmulti.main(argv) == 1
        assert mine == capsys.readouterr().err


class _FakeDaemon:
    """Stands in for MultiChannelDaemon in multicli: records how the CLI
    configured it and runs nothing."""

    made = []

    def __init__(self, bank, options, **kw):
        from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiStats

        self.bank, self.options, self.kw = bank, options, kw
        self.stats = MultiStats()
        self.frontend_placement = "device"
        self.made.append(self)

    def describe_fec(self):
        return "host (fake)"

    def run(self, max_windows=0):
        return []


class _FakeBank:
    """Stands in for RtlTcpBank: records its endpoints, connects to
    nothing."""

    def __init__(self, endpoints):
        self.endpoints = endpoints
        self.n_channels = len(endpoints)

    def close(self):
        pass


class _FakeDist:
    """Stands in for parallel.distributed: a 2-rank job of one device a
    rank, with no process group."""

    def __init__(self):
        self.calls = []

    def initialize(self, coordinator, num_processes, process_id):
        self.calls.append(("initialize", coordinator, num_processes,
                           process_id))

    def global_device_count(self, n_local):
        self.calls.append(("global_device_count", n_local))
        return 2 * n_local

    def shutdown(self):
        self.calls.append(("shutdown",))


@pytest.fixture()
def fake_multicli(monkeypatch):
    """multicli with its daemon, rtl_tcp bank and distributed module
    replaced by the fakes above; yields the fake distributed module."""
    from rtlsdr_wsprd_tpu_torch.parallel import distributed

    fd = _FakeDist()
    _FakeDaemon.made = []
    monkeypatch.setattr(pmulti, "MultiChannelDaemon", _FakeDaemon)
    monkeypatch.setattr(pmulti, "RtlTcpBank", _FakeBank)
    for name in ("initialize", "global_device_count", "shutdown"):
        monkeypatch.setattr(distributed, name, getattr(fd, name))
    yield fd


@pytest.mark.parametrize("argv, item", [
    (["--devices", "all"], "Queue 1 item 4"),
    (["--coordinator", "127.0.0.1:1234", "--nprocs", "2"], "Queue 1 item 5"),
    (["--nprocs", "2", "--rank", "1"], "Queue 1 item 5"),
    (["--dial", "40m"], "channelizer"),
])
def test_multicli_later_slices_raise(argv, item, fake_multicli, capsys):
    """The flags that raised NotImplementedError until their ROADMAP item
    (``item``) landed now run as in the JAX multicli: --devices all
    reaches the daemon; --coordinator/--nprocs joins the job and prints
    the distributed banner; --nprocs without --coordinator and a --dial
    outside the capture's span exit 1 with the JAX messages, before any
    channel is made."""
    rc = pmulti.main(["--endpoint", "127.0.0.1:1:20m", "-x", *argv,
                      *CPU_FLAG])
    cap = capsys.readouterr()
    if argv[0] == "--devices":
        assert rc == 0 and _FakeDaemon.made[0].kw["devices"] == "all"
    elif argv[0] == "--coordinator":
        assert rc == 0
        assert fake_multicli.calls == [
            ("initialize", "127.0.0.1:1234", 2, 0),
            ("global_device_count", 1), ("shutdown",)]
        assert ("Distributed: rank 0/2 serving channels [0, 1) on 1 local "
                "device(s), 2 global.") in cap.out
        assert "[rank 0] Processed 0 window batch(es)" in cap.out
    elif argv[0] == "--nprocs":
        assert rc == 1 and not fake_multicli.calls
        assert "Multi-host mode needs --coordinator HOST:PORT" in cap.err
    else:
        assert rc == 1 and not _FakeDaemon.made
        assert cap.err.startswith("Bad --dial '40m' (unknown or outside "
                                  "the 2.4 Msps span")


@pytest.mark.parametrize("argv", [
    ["--synth", "2", "--dial", "mf", "-x"],
    ["--synth", "2", "--dial", "mf", "-x", "--coordinator", "h:1",
     "--nprocs", "2"],
    ["--synth", "2", "-x", "--coordinator", "h:1", "--nprocs", "2",
     "--rank", "2"],
    ["--synth", "2", "-x", "--nprocs", "3"],
], ids=["dial-needs-one-endpoint", "dial-refused-across-ranks",
        "rank-outside-job", "nprocs-without-coordinator"])
def test_multicli_dial_and_distributed_checks_match_jax(argv, capsys):
    """Exits for --dial and the multi-host flags that come before any
    channel or process group is made: exit 1 and the JAX multicli's
    message."""
    assert pmulti.main(argv + CPU_FLAG) == 1
    mine = capsys.readouterr().err
    assert jmulti.main(argv) == 1
    assert mine == capsys.readouterr().err and mine


def test_multicli_dial_configures_the_channelizer(fake_multicli, capsys):
    """--endpoint at LF (direct sampling) with --dial mf --dial 160m: one
    rtl_tcp channel tuned for LF, three output channels at the three
    dials (the wideband deployment of frontend/channelize.py), decoded
    against the endpoint's dial; unknown or out-of-span dials exit 1,
    as do two endpoints."""
    from rtlsdr_wsprd_tpu_torch.config import BAND_TABLE as B

    rc = pmulti.main(["--endpoint", "127.0.0.1:1:lf", "--dial", "mf",
                      "--dial", "160m", "-x", *CPU_FLAG])
    assert rc == 0
    [d] = _FakeDaemon.made
    assert [e[2] for e in d.bank.endpoints] == [B["lf"][0]]
    assert d.bank.endpoints[0][3]["directsampling"] == 2
    dials = [B["lf"][0], B["mf"][0], B["160m"][0]]
    assert d.kw["channelize"] == dials and d.kw["dialfreqs"] == dials
    assert d.options.freq == B["lf"][0]
    for argv in (["--endpoint", "127.0.0.1:1:lf", "--dial", "40m"],
                 ["--endpoint", "127.0.0.1:1:20m", "--dial", "13.4M"],
                 ["--endpoint", "127.0.0.1:1:20m", "--dial", "0"],
                 ["--endpoint", "127.0.0.1:1:20m", "--endpoint",
                  "127.0.0.1:2:30m", "--dial", "20m"]):
        capsys.readouterr()
        assert pmulti.main(argv + ["-x", *CPU_FLAG]) == 1
        err = capsys.readouterr().err
        assert "Bad --dial" in err or "exactly one --endpoint" in err
    assert len(_FakeDaemon.made) == 1


def test_multicli_ranks_serve_their_slices(fake_multicli, capsys):
    """Multi-host mode over three endpoints and two ranks: rank 0 serves
    channels [0, 2), rank 1 [2, 3) (rank_slice), each prints its banner
    and tags its summary line; every rank validates the whole endpoint
    list first."""
    eps = ["127.0.0.1:1:20m", "127.0.0.1:2:40m", "127.0.0.1:3:30m"]
    argv = [a for ep in eps for a in ("--endpoint", ep)]
    for rank, span, n in ((0, "[0, 2)", 2), (1, "[2, 3)", 1)):
        _FakeDaemon.made = []
        assert pmulti.main(argv + ["-x", "--coordinator", "h:9", "--nprocs",
                                   "2", "--rank", str(rank), "--devices",
                                   "all", *CPU_FLAG]) == 0
        out = capsys.readouterr().out
        assert (f"Distributed: rank {rank}/2 serving channels {span} on 1 "
                "local device(s), 2 global.") in out
        assert f"[rank {rank}] Processed" in out
        [d] = _FakeDaemon.made
        assert len(d.bank.endpoints) == n == len(d.kw["dialfreqs"])
    bad = argv[:-1] + ["127.0.0.1:3:0"]
    assert pmulti.main(bad + ["-x", "--coordinator", "h:9", "--nprocs", "2",
                              "--rank", "0", *CPU_FLAG]) == 1
    assert "Bad frequency in --endpoint" in capsys.readouterr().err
    # more ranks than channels: the idle rank still joins the device
    # count (a collective), then exits 1
    fake_multicli.calls.clear()
    assert pmulti.main(argv[:2] + ["-x", "--coordinator", "h:9", "--nprocs",
                                   "2", "--rank", "1", *CPU_FLAG]) == 1
    assert "Rank 1: no channels to serve" in capsys.readouterr().err
    assert fake_multicli.calls == [("initialize", "h:9", 2, 1),
                                   ("global_device_count", 1),
                                   ("shutdown",)]


@pytest.mark.slow
def test_multicli_synth_two_channels_end_to_end(capsys):
    """The many-channel CLI on raw 2.4 Msps synthesis (2 channels x
    122 s): both channels decode their message, no error."""
    rc = pmulti.main(["--synth", "2", "-n", "1", "-x", "-Q",
                      "--device-batch", "2", *CPU_FLAG])
    out = capsys.readouterr().out
    assert rc == 0
    assert "2 channel-windows, 2 spot(s), 0 error(s)" in out
    assert out.count("K1JT   FN20 20") == 2


@pytest.mark.slow
def test_cli_rtltcp_daemon_decodes_a_raw_capture(monkeypatch, capsys):
    """The single-dongle daemon end to end on the CPU: a 120 s raw
    2.4 Msps capture served by a loopback rtl_tcp server decodes to
    K1JT FN20 20 with 0 errors and 0 dropped bytes."""
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_raw_2400k
    from rtlsdr_wsprd_tpu_torch.utils.channel import get_wspr_channel_symbols
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable

    symbols = get_wspr_channel_symbols("K1JT FN20 20", WsprHashTable())
    raw = []
    for ri, rq in synth_raw_2400k(symbols, f0=30.0, t0=2.0, amp_counts=25.0,
                                  noise_counts=2.0, duration_s=120.0,
                                  seed=3):
        b = np.empty(2 * ri.size, np.uint8)
        b[0::2], b[1::2] = ri, rq
        raw.append(b.tobytes())
    # 10x real time: the client's 256 MB ring never overflows
    srv = LoopbackRtlTcp(b"".join(raw), n_commands=5, bytes_per_s=48e6)
    t0 = time.perf_counter()
    rc = pcli.main(["-f", "20m", "-c", "A1XYZ", "-l", "AB12cd", "-i",
                    f"127.0.0.1:{srv.port}", "-n", "1", "--no-align", "-x",
                    *CPU_FLAG])
    srv.join()
    out = capsys.readouterr().out
    print(f"rtl_tcp daemon window in {time.perf_counter() - t0:.1f} s")
    assert rc == 0
    assert "Session: 1 windows, 1 spots, 0 errors" in out
    assert "K1JT   FN20 20" in out


@pytest.mark.slow
def test_multicli_two_ranks_end_to_end():
    """Two multicli rank processes on the CPU form one gloo job over 4
    synthetic raw channels (122 s each): each prints its banner, serves
    its 2 channels (1 local device, 2 global) and decodes their 2 spots
    at the frequencies of its own channels, with 0 errors."""
    import re
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rtlsdr_wsprd_tpu_torch.multicli", "--synth",
         "4", "-n", "1", "-x", "-Q", "--device-batch", "2", "--devices",
         "all", "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
         "--rank", str(rank), *CPU_FLAG],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=1500)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want_mhz = [14.095600 + (1500.0 + (37 * k) % 180 - 90.0) / 1e6
                for k in range(4)]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert (f"Distributed: rank {rank}/2 serving channels "
                f"[{2 * rank}, {2 * rank + 2}) on 1 local device(s), "
                "2 global.") in out
        assert (f"[rank {rank}] Processed 1 window batch(es), "
                "2 channel-windows, 2 spot(s), 0 error(s).") in out
        got = sorted(float(m) for m in re.findall(r"14\.09\d{4}", out))
        assert len(got) == 2
        for g, w in zip(got, sorted(want_mhz[2 * rank:2 * rank + 2])):
            assert abs(g - w) < 5e-6

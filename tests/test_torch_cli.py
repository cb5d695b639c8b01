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


@pytest.mark.parametrize("argv, item", [
    (["--devices", "all"], "Queue 1 item 4"),
    (["--coordinator", "127.0.0.1:1234", "--nprocs", "2"], "Queue 1 item 5"),
    (["--nprocs", "2", "--rank", "1"], "Queue 1 item 5"),
    (["--dial", "40m"], "channelizer"),
])
def test_multicli_later_slices_raise(argv, item):
    """Flags of later slices parse and raise NotImplementedError naming
    their ROADMAP item; no channel is made first."""
    with pytest.raises(NotImplementedError, match=item):
        pmulti.main(["--endpoint", "127.0.0.1:1:20m", "-x", *argv,
                     *CPU_FLAG])


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

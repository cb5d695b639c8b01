"""Command-line interface, flag-compatible with the reference daemon.

The port's copy of ``rtlsdr_wsprd_tpu/cli.py``:

    python -m rtlsdr_wsprd_tpu_torch.cli -t
    python -m rtlsdr_wsprd_tpu_torch.cli -r capture.c2
    python -m rtlsdr_wsprd_tpu_torch.cli -f 20m -c A1XYZ -l AB12cd \
        -i sdr-host:1234

Same short options, band table, unit-suffix parsing and exit behavior
as rtlsdr_wsprd.c:829-1206 (usage text :792-826, band table :862-927,
atofs :499-524), plus extensions under ``--source`` (the device layer
is a pluggable source: rtl_tcp for real dongles over the network, file
replay, synthetic; see runtime/sources.py) and ``--compute-device``,
the card that decodes (default: the CUDA card; ``cpu`` runs the plain
PyTorch versions, as the tests do). Without a card and without
``--compute-device cpu`` every mode raises: nothing falls back to the
CPU.

Modes, in the reference's precedence order (rtlsdr_wsprd.c:1015-1029):
  -t          decoder self-test (exit 0 on success)
  -r FILE     decode a recorded .iq/.c2 file and exit
  (otherwise) live daemon on the selected source
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np

from . import __version__
from .config import BAND_TABLE, DecoderOptions, ReceiverOptions
from .device import resolve_device
from .models.decoder import WsprDecoder
from .runtime import iqio
from .runtime.reporting import (
    WsprnetReporter,
    format_table_header,
    format_table_line,
)
from .runtime.scheduler import WsprDaemon
from .runtime.sources import (
    IQFileSource,
    RtlTcpSource,
    SyntheticBasebandSource,
    SyntheticRawSource,
)
from .runtime.synth import selftest_iq


def atofs(s: str) -> float:
    """Unit-suffix number: 'k'/'M'/'G' (rtlsdr_wsprd.c:499-524)."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1e3, "m": 1e6, "g": 1e9}[s[-1].lower()]
        s = s[:-1]
    return float(s) * mult


def parse_frequency(value: str) -> tuple[int, int]:
    """-f argument: band name or frequency; returns (dialfreq_hz,
    directsampling) (rtlsdr_wsprd.c:862-927)."""
    key = value.strip().lower()
    if key in BAND_TABLE:
        return BAND_TABLE[key]
    return int(atofs(value)), 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtlsdr_wsprd_tpu_torch",
        description="WSPR daemon on a CUDA card (capabilities of "
                    "rtlsdr_wsprd)",
        add_help=False,
    )
    p.add_argument("-f", dest="frequency", metavar="FREQ|BAND",
                   help="dial frequency [(,k,M) Hz] or band string "
                        "(LF MF 160m..23cm)")
    p.add_argument("-c", dest="rcall", default="", metavar="CALLSIGN",
                   help="your callsign (12 chars max)")
    p.add_argument("-l", dest="rloc", default="", metavar="LOCATOR",
                   help="your locator grid (6 chars max)")
    p.add_argument("-g", dest="gain", type=int, default=29,
                   help="gain [0-49] (default: 29)")
    p.add_argument("-a", dest="autogain", action="store_true",
                   help="auto gain")
    p.add_argument("-o", dest="shift", type=int, default=0,
                   help="frequency offset (default: 0)")
    p.add_argument("-p", dest="ppm", type=int, default=0,
                   help="crystal correction factor (ppm)")
    p.add_argument("-u", dest="upconverter", type=str, default="0",
                   help="upconverter frequency (example: 125M)")
    p.add_argument("-d", dest="directsampling", type=int, default=None,
                   choices=(0, 1, 2), help="direct sampling mode")
    p.add_argument("-n", dest="maxloop", type=str, default="0",
                   help="max iterations (0 = infinite)")
    p.add_argument("-i", dest="device", type=str, default="0",
                   help="device index / rtl_tcp HOST:PORT")
    p.add_argument("-H", dest="usehashtable", action="store_true",
                   help="use the callsign hash table")
    p.add_argument("-Q", dest="quickmode", action="store_true",
                   help="quick mode")
    p.add_argument("-S", dest="singlepass", action="store_true",
                   help="single pass, no subtraction (same as original "
                        "wsprd)")
    p.add_argument("-x", dest="noreport", action="store_true",
                   help="do not report spots to WSPRnet")
    p.add_argument("-t", dest="selftest", action="store_true",
                   help="decoder self-test")
    p.add_argument("-w", dest="writefile", metavar="PREFIX",
                   help="write received windows as PREFIX_date_time.iq")
    p.add_argument("-r", dest="readfile", metavar="FILE",
                   help="read and decode a .iq/.c2 file, then exit")
    # extensions
    p.add_argument("--source", default="rtl_tcp",
                   choices=("rtl_tcp", "synth", "synth-raw"),
                   help="live sample source (default rtl_tcp; -i HOST:PORT)")
    p.add_argument("--reconnect", action="store_true",
                   help="ride out rtl_tcp server restarts: redial + "
                        "re-tune instead of ending the stream")
    p.add_argument("--no-align", action="store_true",
                   help="backpressure mode: decode windows as fast as the "
                        "source supplies them (file/synth replay)")
    add_compute_device(p)
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("--version", action="version",
                   version=f"rtlsdr_wsprd_tpu_torch {__version__}")
    return p


def add_compute_device(p: argparse.ArgumentParser) -> None:
    """``--compute-device``: the port's counterpart of JAX_PLATFORMS
    (``-i`` already owns the ``device`` destination)."""
    p.add_argument("--compute-device", dest="compute_device", default=None,
                   metavar="DEVICE",
                   help="torch device that decodes (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch versions)")


def run_selftest(device=None) -> int:
    """-t: encode K1JT FN20QI 20, synthesize, write selftest.iq, decode,
    verify (decoderSelfTest, rtlsdr_wsprd.c:729-789)."""
    i, q = selftest_iq()
    iqio.write_iq_file(i, q, "selftest.iq")
    i, q = iqio.normalize_minus3db(i, q)
    decoder = WsprDecoder(DecoderOptions(), device=device)
    spots = decoder.decode(i, q)
    print(format_table_header())
    for k, s in enumerate(spots):
        print("Spot(%d) %6.2f %6.2f %10.6f %2d %7s %6s %2s" % (
            k, s.snr, s.dt, s.freq, int(s.drift), s.call, s.loc, s.pwr))
    ok = bool(spots) and (spots[0].call, spots[0].loc, spots[0].pwr) == (
        "K1JT", "FN20", "20")
    if ok:
        print("Self-test SUCCESS!")
        return 0
    print("Self-test FAILED!", file=sys.stderr)
    return 1


def run_readfile(filename: str, options: DecoderOptions,
                 device=None) -> int:
    """-r: decode a recorded capture (decodeRecordedFile,
    rtlsdr_wsprd.c:670-703)."""
    if filename.endswith(".iq"):
        i, q = iqio.read_iq_file(filename)
    elif filename.endswith(".c2"):
        i, q, freq = iqio.read_c2_file(filename)
        if options.freq == 0:
            options = options.with_(freq=int(freq))
    else:
        print("Not a valid extension!! (only .iq & .c2 files)",
              file=sys.stderr)
        return 1
    print(f"Number of samples: {i.shape[0]}")
    if i.shape[0] == 0:
        return 1
    from .config import SIGNAL_SAMPLES
    if i.shape[0] < SIGNAL_SAMPLES:
        pad = SIGNAL_SAMPLES - i.shape[0]
        i = np.concatenate([i, np.zeros(pad, np.float32)])
        q = np.concatenate([q, np.zeros(pad, np.float32)])
    decoder = WsprDecoder(options, device=device)
    spots = decoder.decode(i, q)
    print(format_table_header())
    for s in spots:
        print(format_table_line(s))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    dialfreq = 0
    directsampling = args.directsampling or 0
    if args.frequency:
        dialfreq, band_ds = parse_frequency(args.frequency)
        if args.directsampling is None:
            directsampling = band_ds

    dec = DecoderOptions(
        freq=dialfreq,
        rcall=args.rcall[:12].upper(),
        rloc=args.rloc[:6],
        quickmode=args.quickmode,
        usehashtable=args.usehashtable,
        npasses=1 if args.singlepass else 2,
        subtraction=not args.singlepass,
    )

    # every mode decodes on this device: without it, raise here
    device = resolve_device(args.compute_device)
    if args.selftest:
        return run_selftest(device)
    if args.readfile:
        return run_readfile(args.readfile, dec, device)

    # live daemon: validation mirrors rtlsdr_wsprd.c:992-1013,1126-1133
    if dialfreq == 0:
        print("Please specify a dial frequency.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not dec.rcall:
        print("Please specify your callsign.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not dec.rloc:
        print("Please specify your locator.\n --help for usage...",
              file=sys.stderr)
        return 1

    rx = ReceiverOptions(
        dialfreq=dialfreq,
        realfreq=dialfreq + args.shift + int(atofs(args.upconverter)),
        gain=max(0, min(49, args.gain)) * 10,
        autogain=args.autogain,
        ppm=args.ppm,
        shift=args.shift,
        upconverter=int(atofs(args.upconverter)),
        directsampling=directsampling,
        maxloop=int(atofs(args.maxloop)),
        noreport=args.noreport,
    )

    gtm = time.gmtime()
    print(f"\nStarting rtlsdr_wsprd_tpu_torch "
          f"({gtm.tm_year:04d}-{gtm.tm_mon:02d}-{gtm.tm_mday:02d}, "
          f"{gtm.tm_hour:02d}:{gtm.tm_min:02d}z) -- Version {__version__}")
    print(f"  Callsign     : {dec.rcall}")
    print(f"  Locator      : {dec.rloc}")
    print(f"  Dial freq.   : {dialfreq} Hz")
    print(f"  Real freq.   : {rx.realfreq} Hz")
    print(f"  PPM factor   : {rx.ppm}")
    if rx.autogain:
        print("  Auto gain    : enable")
    else:
        print(f"  Gain         : {rx.gain // 10} dB")
    from .ops import calibrate
    print(f"  FEC strategy : {calibrate.describe(device=device)}")

    if args.source == "rtl_tcp":
        host, _, port = args.device.partition(":")
        if not port:
            print("rtl_tcp source needs -i HOST:PORT", file=sys.stderr)
            return 1
        source = RtlTcpSource(
            host, int(port), dialfreq_hz=dialfreq, shift_hz=args.shift,
            upconverter_hz=rx.upconverter, gain_tenths_db=rx.gain,
            autogain=rx.autogain, ppm=rx.ppm,
            directsampling=directsampling, device=device,
            reconnect=args.reconnect)
    elif args.source == "synth":
        source = SyntheticBasebandSource()
    else:
        source = SyntheticRawSource(device=device)

    # background delivery: a slow wsprnet never eats the 2-min cadence
    # (the C's decoder thread blocks on curl, rtlsdr_wsprd.c:324)
    reporter = WsprnetReporter(dec.rcall, dec.rloc, dialfreq,
                               noreport=rx.noreport, background=True)
    daemon = WsprDaemon(source, dec, reporter=reporter,
                        write_prefix=args.writefile, device=device)
    align = not args.no_align
    if align:
        wait = 120.0 - (time.time() % 120.0)
        print(f"Wait for time sync (start in {int(wait)} sec)\n")

    # graceful shutdown on SIGTERM too (the reference traps INT/TERM/
    # ILL/FPE/SEGV, rtlsdr_wsprd.c:1037-1042)
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        daemon.run(maxloop=rx.maxloop, align=align)
    except KeyboardInterrupt:
        print("Shutting down...")
    finally:
        reporter.close()  # join worker + final delivery attempt
        source.close()
        st = daemon.stats
        up = time.time() - st.started
        print(f"Session: {st.windows} windows, {st.spots} spots, "
              f"{st.errors} errors, decode {st.decode_seconds:.1f} s, "
              f"uptime {up:.0f} s")
        if reporter.dropped:
            print(f"WARNING: {reporter.dropped} report(s) dropped "
                  "(wsprnet unreachable past the retry horizon)",
                  file=sys.stderr)
        if getattr(source, "dropped_bytes", 0):
            # the RX ring overflowed: windows spanning the gaps will not
            # decode (the multi-channel CLI warns the same way)
            print(f"WARNING: ingest ring overflow, dropped "
                  f"{source.dropped_bytes} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

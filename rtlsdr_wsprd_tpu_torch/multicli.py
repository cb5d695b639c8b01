"""Many-channel daemon CLI: the terminal surface of the integrated
ingest->spots chain (runtime/multidaemon.MultiChannelDaemon).

The port's copy of ``rtlsdr_wsprd_tpu/multicli.py``. The reference
daemon serves exactly one dongle per process (rtlsdr_wsprd.c:961-1203);
this entry point drives a BANK of channels — one rtl_tcp server per
dongle/band, or synthetic channels for load generation — through one
batched pipeline on one CUDA card.

    python -m rtlsdr_wsprd_tpu_torch.multicli \
        --endpoint sdr0:1234:20m --endpoint sdr1:1234:40m \
        -c A1XYZ -l AB12cd

    python -m rtlsdr_wsprd_tpu_torch.multicli --synth 8 -n 1 -x

Frequency accepts the same band names / unit suffixes as the main CLI
(-f). Reporting posts each channel's spots with that channel's dial
frequency. ``--compute-device`` as in the main CLI. The JAX package's
flags of later slices parse and raise ``NotImplementedError``:
``--devices all`` (ROADMAP Queue 1 item 4, multi-device),
``--coordinator``/``--nprocs``/``--rank`` (item 5, distributed) and
``--dial`` (the channelizer).
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .cli import add_compute_device, parse_frequency
from .config import DecoderOptions
from .device import resolve_device
from .runtime.banks import RtlTcpBank, SyntheticRawBank
from .runtime.multidaemon import MultiChannelDaemon
from .runtime.reporting import WsprnetReporter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtlsdr_wsprd_tpu_torch.multicli",
        description="many-channel WSPR daemon on a CUDA card",
        add_help=False,
    )
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="HOST:PORT:FREQ|BAND",
                   help="rtl_tcp server + dial frequency; repeat per "
                        "channel")
    p.add_argument("--synth", type=int, default=0, metavar="N",
                   help="N synthetic channels instead of rtl_tcp "
                        "(self-test / load generation)")
    p.add_argument("-c", dest="rcall", default="", metavar="CALLSIGN")
    p.add_argument("-l", dest="rloc", default="", metavar="LOCATOR")
    p.add_argument("-g", dest="gain", type=int, default=29,
                   help="gain [0-49] for every dongle (default 29)")
    p.add_argument("-a", dest="autogain", action="store_true")
    p.add_argument("-p", dest="ppm", type=int, default=0)
    p.add_argument("-n", dest="maxloop", type=int, default=0,
                   help="stop after N window batches (0 = infinite)")
    p.add_argument("-H", dest="usehashtable", action="store_true")
    p.add_argument("-Q", dest="quickmode", action="store_true")
    p.add_argument("-S", dest="singlepass", action="store_true")
    p.add_argument("-x", dest="noreport", action="store_true")
    p.add_argument("--device-batch", type=int, default=64,
                   help="windows per device decode batch (default 64)")
    p.add_argument("--dial", action="append", default=[],
                   metavar="FREQ|BAND", dest="dials",
                   help="wideband: decode this ADDITIONAL dial from the "
                        "single --endpoint capture (repeatable; the "
                        "2.4 Msps span covers endpoint dial -593.5 kHz "
                        "to +1796.5 kHz)")
    p.add_argument("--reconnect", action="store_true",
                   help="ride out rtl_tcp server restarts: redial + "
                        "re-tune instead of ending the stream")
    p.add_argument("--no-align", dest="noalign", action="store_true",
                   help="skip the 2-minute wall-clock capture alignment "
                        "(replay/faster-than-realtime rtl_tcp servers)")
    p.add_argument("--frontend", choices=("auto", "device", "host"),
                   default="auto",
                   help="where the 6400:1 decimator runs: device (raw "
                        "uint8 to the card; auto is the same), or host "
                        "(native C++; only 375 sps baseband crosses the "
                        "link)")
    p.add_argument("-w", dest="writefile", metavar="PREFIX", default=None,
                   help="save each channel's normalized window as "
                        "PREFIX_chNN_<timestamp>.iq (reference -w)")
    p.add_argument("--fec", choices=("auto", "host", "hybrid"),
                   default="auto",
                   help="FEC strategy: auto = per-card calibration "
                        "(ops/calibrate.py; RTLSDR_WSPRD_TPU_FEC also "
                        "pins it), host = native sequential decoder, "
                        "hybrid = batched device search + native "
                        "straggler finish")
    p.add_argument("--devices", choices=("default", "all"),
                   default="default",
                   help="decode on the default device; 'all' (every "
                        "local card) is not ported yet")
    p.add_argument("--strict-hash-order", action="store_true",
                   help="with -H: compatibility mode serializing window "
                        "batches (disables the pipeline overlap). Type-3 "
                        "<hash> spots already resolve race-free at yield "
                        "time by default; this additionally matches the "
                        "reference's decode-time side effects (dedupe "
                        "key / subtraction of a then-unresolved type-3)")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-host mode (not ported yet)")
    p.add_argument("--nprocs", type=int, default=1, metavar="N",
                   help="multi-host mode (not ported yet)")
    p.add_argument("--rank", type=int, default=0, metavar="K",
                   help="multi-host mode (not ported yet)")
    add_compute_device(p)
    p.add_argument("--help", action="help")
    p.add_argument("--version", action="version",
                   version=f"rtlsdr_wsprd_tpu_torch {__version__}")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if bool(args.endpoint) == bool(args.synth):
        print("Specify either --endpoint (one per channel) or "
              "--synth N.\n --help for usage...", file=sys.stderr)
        return 1
    if not args.noreport and (not args.rcall or not args.rloc):
        print("Please specify your callsign and locator (or -x).\n"
              " --help for usage...", file=sys.stderr)
        return 1

    # flags of later slices: refuse rather than run something else
    if args.coordinator is not None or args.nprocs > 1:
        raise NotImplementedError(
            "--coordinator/--nprocs/--rank: multi-host decode is not "
            "ported yet (ROADMAP Queue 1 item 5, distributed)")
    if args.devices != "default":
        raise NotImplementedError(
            f"--devices {args.devices}: the multi-device decode is not "
            "ported yet (ROADMAP Queue 1 item 4, multi-device)")
    if args.dials:
        raise NotImplementedError(
            "--dial: the wideband channelizer is not ported yet (ROADMAP "
            "Queue 1, the channelizer, frontend/channelize.py)")
    device = resolve_device(args.compute_device)

    dialfreqs: list[int] = []
    if args.synth:
        f0s = [(37 * k) % 180 - 90.0 for k in range(args.synth)]
        seeds = list(range(1000, 1000 + args.synth))
        bank = SyntheticRawBank(len(f0s), f0s=f0s, seeds=seeds)
        dialfreqs = [14_095_600] * len(f0s)
    else:
        endpoints = []
        for ep in args.endpoint:
            try:
                host, port, freq = ep.rsplit(":", 2)
            except ValueError:
                print(f"Bad --endpoint {ep!r} (HOST:PORT:FREQ)",
                      file=sys.stderr)
                return 1
            dialfreq, directsampling = parse_frequency(freq)
            dialfreqs.append(dialfreq)
            if dialfreq == 0:
                print(f"Bad frequency in --endpoint {ep!r}",
                      file=sys.stderr)
                return 1
            endpoints.append((host, int(port), dialfreq, dict(
                gain_tenths_db=max(0, min(49, args.gain)) * 10,
                autogain=args.autogain, ppm=args.ppm,
                directsampling=directsampling,
                reconnect=args.reconnect)))
        bank = RtlTcpBank(endpoints)

    options = DecoderOptions(
        freq=dialfreqs[0],
        rcall=args.rcall[:12].upper(),
        rloc=args.rloc[:6],
        quickmode=args.quickmode,
        usehashtable=args.usehashtable,
        npasses=1 if args.singlepass else 2,
        subtraction=not args.singlepass,
    )
    reporters = None
    if not args.noreport:
        # background delivery: a slow wsprnet never stalls the decode
        # pipeline (join-on-shutdown in the finally below)
        reporters = [WsprnetReporter(options.rcall, options.rloc, df,
                                     background=True)
                     for df in dialfreqs]

    daemon = MultiChannelDaemon(
        bank, options, quiet=False,
        device_batch=args.device_batch,
        fec=args.fec, dialfreqs=dialfreqs, reporters=reporters,
        align=not args.synth and not args.noalign,
        frontend=args.frontend,
        strict_hash_order=args.strict_hash_order,
        write_prefix=args.writefile, device=device)
    print(f"FEC strategy : {daemon.describe_fec()}")
    print(f"Front end    : {daemon.frontend_placement}")
    try:
        daemon.run(max_windows=args.maxloop)
    finally:
        bank.close()
        if reporters is not None:
            for r in reporters:
                r.close()  # join worker + final delivery attempt
            # include anything dropped during the shutdown drain
            daemon.stats.dropped_reports = sum(r.dropped
                                               for r in reporters)
    s = daemon.stats
    print(f"Processed {s.window_batches} window batch(es), "
          f"{s.channel_windows} channel-windows, {s.spots} spot(s), "
          f"{s.errors} error(s).")
    if s.dropped_reports:
        print(f"WARNING: {s.dropped_reports} report(s) dropped "
              "(wsprnet unreachable past the retry horizon)",
              file=sys.stderr)
    dropped = getattr(bank, "dropped_bytes", None)
    if dropped and any(dropped):
        # the RX ring overflowed: the host fell behind the stream and
        # whole chunks were discarded (the dongle-overflow analog) —
        # windows spanning the gaps will not decode
        print("WARNING: ingest ring overflow, dropped bytes per "
              f"channel: {dropped}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

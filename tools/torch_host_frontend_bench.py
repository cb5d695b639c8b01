"""Host front end of the PyTorch/CUDA port: native C++ polyphase
throughput per core.

The counterpart of tools/host_frontend_bench.py, on the port's
``frontend/host_decimate.py`` and ``frontend/channelize.py`` host
placement (one thread, so the numbers are per core):

1. the plain decimator chain, ``HostBatchedStreamingDecimator(1,
   threads=1)``: uint8 2.4 Msps -> 375 sps, in Msps a core and realtime
   channels a core;
2. the wideband channelizer, ``ChannelizingStreamingDecimator(...,
   placement="host", threads=1)`` at K = 1 and 4 dials 50 kHz apart
   over one stream: decoded dials a core (K x Msps / 2.4).

Usage: python tools/torch_host_frontend_bench.py [seconds_per_case]
           [--device DEV]
Host-only; ``--device`` (default the CUDA card, ``cpu`` without one)
names the machine's card beside the numbers. Run on an idle host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.frontend.channelize import (  # noqa: E402
    ChannelizingStreamingDecimator,
)
from rtlsdr_wsprd_tpu_torch.frontend.host_decimate import (  # noqa: E402
    HostBatchedStreamingDecimator,
)
from torch_measure import device_banner  # noqa: E402

CHUNK = 2_400_000  # 1 s of raw stream a push


def stream_msps(make, secs: float) -> float:
    """Msps of one decimator made by ``make`` pushed 1 s chunks of
    uniform uint8 bytes for ``secs`` seconds (after one priming push)."""
    rng = np.random.default_rng(5)
    ci = rng.integers(0, 256, (1, CHUNK), dtype=np.uint8)
    cq = rng.integers(0, 256, (1, CHUNK), dtype=np.uint8)
    dec = make()
    dec.push(ci, cq)  # prime carries + warm
    n = 0
    t0 = time.perf_counter()
    while (dt := time.perf_counter() - t0) < secs:
        dec.push(ci, cq)
        n += 1
    return n * CHUNK / dt / 1e6


def cases():
    """(label, dials, maker) of each case."""
    yield ("plain decimator", 1,
           lambda: HostBatchedStreamingDecimator(1, threads=1))
    for K in (1, 4):
        offs = [50_000.0 * i for i in range(K)]
        yield (f"channelizer K={K}", K,
               lambda offs=offs: ChannelizingStreamingDecimator(
                   offs, placement="host", threads=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("secs", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    banner = device_banner(args.device)
    print(f"host cores {len(os.sched_getaffinity(0))} (cpu_count "
          f"{os.cpu_count()}); card {banner}")
    for label, k, make in cases():
        msps = stream_msps(make, args.secs)
        print(f"{label:<28} {msps:7.2f} Msps/core   "
              f"{k * msps / 2.4:7.2f} realtime "
              f"{'dials' if k > 1 else 'channels'}/core (host of {banner})",
              flush=True)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. env      torch/CUDA versions, the card's name and power limit, TF32 off.
2. build    the three CUDA kernels (nvcc: polyphase_tc.cu, the
            tensor-core stage-1 kernel for uint8 input, polyphase.cu, the
            FP32-core kernel for float32 input, and fano.cu, the batched
            Fano decoder) and the host Fano library (g++), built at the
            same time from this checkout.
3. frontend the main path: a 120 s synthetic raw 2.4 Msps uint8 capture
            streamed in 10 s chunks through BatchedStreamingDecimator (8
            lanes, each fed the same capture), lane 0's window decoded by
            decode_channels; each kernel's launch count is read around
            this phase (every uint8 stage-1 call on polyphase_tc, every
            stage-2 call on polyphase.cu), and the shape of every
            launch is recorded.
   single   the same capture through the single-channel
            StreamingDecimator, which centres the bytes on the host, so
            both of its stages run float32 on polyphase.cu: its launch
            counts are read around this phase (every call on
            polyphase.cu, none on polyphase_tc), the shape of every launch is
            recorded, and its output must equal the batched lane 0
            within 2e-4 of the output scale.
4. kernel   each kernel against the plain PyTorch version on the card at
            every shape either path launched it with, plus uint8 stage-1
            calls of 1, 129 and 8,000 frames, a float32 stage-1 call of
            8,000 frames, a 100-frame stage-2 call, and calls whose rows
            are not 16-byte aligned (one per stage and input type); with
            the device times of the kernel, the plain version, one torch
            conv1d call (a yardstick the port never calls) and the card's
            bound for the same work.
5. fano     the FEC calibration (ops/calibrate.py), its device_cycle_ms
            beside the most that budget 256 allows (native timeout /
            160), then the Fano kernel, on tensors placed on cuda:0
            named explicitly, on two 512-lane inputs: a synthetic mix
            (clean encoded messages, noisy copies at sigma 20-80, random
            symbols, 16 padding lanes), the attempts the B=512 hybrid
            decode hands to its first device Fano call and, where
            another is heavier, its heaviest call (caught by wrapping
            _fano_batch_packed here). Kernel against the plain
            version on the card at budgets 16 and 64 (every field and
            the step counts) and against native.fano_decode at 256 and
            10000: zero mismatches. Device times at 16, 64, 256 and the
            calibrated budget, the plain version's time at 16, the host
            time of native.fano_decode_many on the same lanes, the bound
            (the search's integer operations for the forward looks and
            backtrack moves these inputs take, read from the outputs),
            the slowest lane's step count and the SM clock cycles a flat
            step takes on it.
6. decode   512 mixed windows through decode_channels (full jitter
            schedule, 2 passes, device_batch=128): the calibration and
            its describe() line; fec="host", then fec="hybrid" (the
            Fano kernel's launches counted from 0 around these runs, its
            main path), each one warm-up and three timed runs with
            decode windows/s, every expected message found and no spot
            on a noise window, the hybrid spot lists equal to host's in
            message, jitter, cycles, freq, snr, dt and sync; then
            decode_channels_pipelined (depth 2, device cuda:0 named
            explicitly) over 4 batches of those windows, each equal to
            the host result, with windows/s; then one run in the mode
            fec="auto" picks under torch.profiler (host time per
            labelled range, the card's kernel time and busy share).
   dense    the dense program on the batch's first 64 windows:
            multichannel_decode_device once (device time between CUDA
            events, peak memory, one Fano launch over 64 x 128 attempt
            lanes); decode_channels(sharding=channel_sharding(make_mesh(
            ["cuda:0"]))), the Fano kernel's launches counted from 0
            around its 3 timed runs, its spot lists equal to the staged
            host decode's in message, jitter and cycles (freq within
            0.5e-6 MHz, snr 0.5 dB, dt 0.05 s), every expected message
            found, none on a noise window, its windows/s beside the
            staged host and hybrid rates on the same windows; the step
            on two shards of cuda:0 equal to one shard in every
            ChannelDecode field; WsprDecoder(staged=False) on windows
            0-3 equal to the mesh path's spots; the step's own Fano
            lanes through the fano phase's checks (plain at 16 and 64,
            native at 256 and 10000) and times; one mesh-path run under
            torch.profiler.
7. daemon   the two daemons and their CLIs, as a user starts them,
            each path driven with every kernel's count set to 0 just
            before it and read just after: cli -t (Self-test SUCCESS!);
            cli -r on an .iq and a .c2 of the front end's lane 0 (the
            table equal to WsprDecoder's on the same window, K1JT FN20
            20); the single-dongle daemon (cli -f 20m -i HOST:PORT -n 1
            --no-align -x) over a loopback rtl_tcp server that serves
            the raw capture at 10x real time (one window, 0 errors, 0
            dropped bytes, K1JT FN20 20; every front-end call float32 on
            polyphase.cu); MultiChannelDaemon over a replay bank of the
            capture on 8 channels at 8 dials (fec="auto",
            device_batch=64, frontend="device"; every channel decodes
            K1JT FN20 20 at its own dial, one wsprnet URL per spot to an
            injected transport, 0 errors, uint8 stage 1 on polyphase_tc,
            stage 2 on polyphase.cu, the Fano kernel launched), its
            channel-windows/s, then the same run once more under
            torch.profiler (the card's busy share); multicli --synth 2
            -n 1 -x (2 channel-windows, 2 spots, 0 errors). Then each
            polyphase kernel against the plain version at every shape
            the daemon paths launched it with. The calibration must have
            been measured once in the whole run, whichever name of the
            card each caller used.
8. multidevice
            decode_channels_multidevice on the 512 windows with devices
            [cuda:0] and [cuda:0, cuda:0], each equal to decode_channels
            in every spot field; decode_channels_pipelined_multidevice
            over 4 batches on two shards of the card, with windows/s
            (run right after the decode phase); its transfer part on the
            first 128 windows: decode_channels_pipelined over 2 batches
            at transfer_dtype int16 and float32,
            decode_channels_multidevice on [cuda:0, cuda:0] at int16 and
            decode_channels_pipelined_multidevice fed 2 batches of two
            prepare_windows_device(..., device="cuda:0") shard handles,
            each equal in every spot field to decode_channels at the
            same format (the whole batch, or each half), the windows that
            differ between int8, int16 and float32 and the seconds of
            each run, prepare_windows_device(<card planes>, device="cpu")
            raising; and, inside the daemon
            phase, the 8-channel daemon again with devices [cuda:0,
            cuda:0], its spots equal to the default run's.
   e2e_device
            the device-resident ingest -> spots chain
            (tools/torch_e2e_sweep.py) on the batch's first 128 windows,
            one counted path: raw uint8 made on the card, 30 fused
            front-end steps of 120,000 frames a window (uint8 stage 1 on
            polyphase_tc, stage 2 on polyphase.cu), the window assembled
            on the card and decoded from its prepare_windows_device
            handle; one checked round, its spots equal in every field to
            decode_channels on a host copy of the same planes at
            float32, every +3 dB message found; then measure_e2e_device
            over 2 timed windows (realtime channels per card, seconds
            and steps a window); all three kernels launched; each
            polyphase kernel against the plain version at the chain's
            shapes.
   entry    entry() (rtlsdr_wsprd_tpu_torch/entry.py, the counterpart
            of __graft_entry__.py) on the card, one counted path: its
            forward on its two example windows, every ChannelDecode field
            of the JAX contract's shape, both windows decoding K1JT FN20
            37 and nothing else, the Fano kernel launched.
   bench    tools/torch_bench.py's bench() (bench.py's sections) on the
            512 windows with 3 headline runs, one counted path: every
            key of bench.py's JSON line and card present, spots_per_batch
            equal to the host decode's spot count on those windows, the
            headline finite and above 0, 129 float32 stage-1 calls at
            C=128 x 9,375 frames, every noted front-end call on its
            kernel (those on polyphase.cu), the Fano kernel launched; then
            each polyphase kernel against the plain version at every
            shape of the path that no earlier phase checked.
9. channelize
            ChannelizingStreamingDecimator at offset 0 against
            BatchedStreamingDecimator(1) on the capture (within 1e-5 of
            scale); the 3-dial wideband capture made on the card (LF
            136.0 kHz tuned, copies rotated up to MF 474.2 kHz and 160 m
            1,836.6 kHz, requantised to uint8); multicli --endpoint
            HOST:PORT:lf --dial mf --dial 160m -n 1 --no-align -x over a
            loopback rtl_tcp server serving it at 10x real time: each
            channel decodes K1JT FN20 20 within 0.5 Hz of its dial +
            1,530 Hz, 0 errors, 0 dropped bytes, one polyphase_tc launch
            a step for all 3 dials and stage 2 on polyphase.cu.
10. distributed
            dryrun_multichip(2, cuda:0) (two gloo ranks on the card, each
            decoding its slice, staged and through the dense step (quick
            and full schedule), and running both sharded decimations,
            rank 0 checking them against the unsharded ones, the dense
            steps field for field; each rank's launches must be its own
            noted sharded calls, and its dense runs decode both its
            windows); two multicli
            rank processes (--coordinator, --nprocs 2, --devices all)
            over two loopback rtl_tcp servers at the 20 m and 40 m dials:
            each prints its banner and decodes 1 channel-window with one
            K1JT spot at its own dial, 0 errors, all three kernels
            launched. Then each polyphase kernel against the plain
            version at every shape the daemon and channelizer paths
            launched it with (a bank's shapes on one stream expanded to
            its K rows, beside the time of K one-filter launches), and
            every one-filter shape against a bank of C copies of its
            filter, bit for bit.
   scaling  tools/torch_scaling.py on the card, one counted path (the
            processes' own launches added): the mesh mode in this process
            (the dense step on 8 windows unsharded and over 8 shards of
            cuda:0, equal in every ChannelDecode field, every window
            decoded, the Fano kernel launched) and the dist mode (one
            process on the 8 windows, one on 4, two gloo ranks on 4 each,
            every window spotted in each).
11. quality the port's decode-quality studies (tools/torch_*.py) at
            reduced sizes on the card, through their own builders and
            decode functions with device=None, every Fano launch counted
            from 0 around them: the SNR sweep on the same windows at
            int8, int16 and float32 (-24 and -28 dB, 50 trials each, at
            least 49 and 47 found at every format; -29, -30 and -31 dB,
            100 trials each, at least 86, 36 and 2 found: the JAX
            package's recorded 274/300, 138/300 and 20/300 less their 2
            sigma binomial band at 100 trials), the windows whose decoded
            message sets differ between formats, the fields that move
            and any other message printed; the drift x DT matrix at
            -27 dB, 10 trials a cell, at least 8 found in every cell;
            the crowded band on 40 windows at npasses 2 and 3, precision
            and recall at least 0.68 each; the hash census on 8 pairs,
            every type-3 spot resolved in both modes. The -30 dB
            windows also decode with fec="host": as many found at int8
            as with fec="auto". The handle of
            prepare_windows(device=None), make_mesh(["cuda"]) and
            MultiChannelDaemon(device=None) must name cuda:0.

Then a JSON line per kernel, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
non-zero without one. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_measure import (  # noqa: E402
    card_peaks,
    cuda_ms,
    int32_rate,
    make_batch,
    nvidia_smi_card,
    polyphase_bound,
    polyphase_work,
    spin_cycles_per_ms,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_env():
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import rtlsdr_wsprd_tpu_torch as port
    from rtlsdr_wsprd_tpu_torch.device import resolve_device

    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail(f"the port was imported from {port.__file__}, not this checkout")
    dev = resolve_device(None)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("TF32 is on")
    card = nvidia_smi_card()
    name = torch.cuda.get_device_name(0)
    log(f"[env] device {name} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; TF32 off")
    return dev, name, card


def phase_build():
    from rtlsdr_wsprd_tpu_torch import native
    from rtlsdr_wsprd_tpu_torch.frontend import polyphase
    from rtlsdr_wsprd_tpu_torch.ops import fano

    took: dict[str, float] = {}
    errors: list[Exception] = []

    def run(label, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported after both builds end
            errors.append(e)
        took[label] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in (
        ("polyphase_tc.cu (nvcc)", lambda: polyphase.build_kernel("tc")),
        ("polyphase.cu (nvcc)", lambda: polyphase.build_kernel("direct")),
        ("fano.cu (nvcc)", fano.build_kernel),
        ("hostdsp.cpp (g++)", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors[0]}")
    for label, s in took.items():
        log(f"[build] {label}: {s:.1f} s")


def _planes(rng, dt, C, L, offset=0):
    """uint8 (uniform bytes) or float32 N(0, 10) planes (C, L) on the
    host; with ``offset`` each row is a view starting that many elements
    into a (C, L + offset) array."""
    if dt == "uint8":
        h = rng.integers(0, 256, (2, C, L + offset), dtype=np.uint8)
    else:
        h = rng.normal(0, 10.0, (2, C, L + offset)).astype(np.float32)
    return h[0], h[1]


def phase_kernel(dev, name, paths, extras: bool = True):
    """Each kernel vs plain at every shape of ``paths`` (path name ->
    launches by shape, from the phases that drive a front end) and, with
    ``extras``, at the extra calls the module docstring lists; returns
    one row per shape."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import STAGE1, STAGE2
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
        _route,
        polyphase_decimate,
        polyphase_plain,
    )

    card_peaks(name)  # raises for a card without published peaks
    rng = np.random.default_rng(1)
    rows = []
    filters = {"stage1": STAGE1, "stage2": STAGE2, **BANKS}

    def s1(n):
        return n * STAGE1.R + STAGE1.T - STAGE1.R

    def s2(n):
        return n * STAGE2.R + STAGE2.T - STAGE2.R

    # path, stage, input dtype, C, L, frames, launches on that path, offset
    cases = []
    for path, shapes in paths.items():
        cases += sorted(((path, st, dt, C, L, n, k, 0) for (st, dt, C, L, n), k
                         in shapes.items()), key=lambda c: (c[1], -c[5]))
    if extras:
        cases += [("extra", "stage1", "uint8", 8, s1(n), n, 0, 0)
                  for n in (8000, 129, 1)]
        cases += [("extra", "stage1", "uint8", 8, s1(8000), 8000, 0, 1),
                  ("extra", "stage1", "float32", 8, s1(8000), 8000, 0, 0),
                  ("extra", "stage1", "float32", 8, s1(8000), 8000, 0, 1),
                  ("extra", "stage2", "float32", 8, s2(100), 100, 0, 0),
                  ("extra", "stage2", "float32", 8, s2(3700), 3700, 0, 1)]
    atol = 1e-3
    for path, stage, dt, C, L, n, launched, offset in cases:
        filt = filters[stage]
        bank = isinstance(filt, list)
        first = filt[0] if bank else filt
        route = _route("cuda", getattr(torch, dt), filt)
        label = (f"{stage} {dt} C={C} x {n} frames, L={L}"
                 f"{', one stream (row stride 0)' if bank else ''}"
                 f"{f', rows at a {offset}-element offset' if offset else ''}"
                 f" ({launched} launches on the {path} path)")
        # a bank's rows are one stream expanded, as the channelizer's
        hI, hQ = _planes(rng, dt, 1 if bank else C, L, offset)
        xI = torch.from_numpy(hI).to(dev)[:, offset:].expand(C, L)
        xQ = torch.from_numpy(hQ).to(dev)[:, offset:].expand(C, L)
        before = dict(polyphase_decimate.launches)
        kI, kQ = polyphase_decimate(xI, xQ, filt, n)
        if polyphase_decimate.launches[route] != before[route] + 1:
            fail(f"{label}: the call did not launch the {route} kernel")
        pI, pQ = polyphase_plain(xI, xQ, filt, n)
        torch.cuda.synchronize()
        err = max(float((kI - pI).abs().max()), float((kQ - pQ).abs().max()))
        if not (err <= atol):
            fail(f"{route} kernel vs plain, {label}: max |diff| {err} > "
                 f"{atol}")
        if not bank:
            # one filter for every row (filter stride 0) is bit for bit
            # the bank whose rows all hold that filter
            sI, sQ = polyphase_decimate(xI, xQ, [filt] * C, n)
            if not (torch.equal(sI, kI) and torch.equal(sQ, kQ)):
                fail(f"{label}: the stride-0 call differs from the bank of "
                     f"{C} copies of its filter")

        # yardstick: one conv1d over the centred float planes, weight
        # (2K, 2, T), [[gr, -gi], [gi, gr]] of each of the K filters (1
        # for a one-filter call over C rows), stride R
        g = torch.from_numpy(np.concatenate([np.stack([
            np.stack([f.gr, -f.gi]), np.stack([f.gi, f.gr])])
            for f in (filt if bank else [filt])])).to(dev)
        xs = (xI[:1], xQ[:1]) if bank else (xI, xQ)
        xf = torch.stack(xs, dim=1).to(torch.float32)
        if dt == "uint8":
            xf -= 128.0
        lib = torch.nn.functional.conv1d(xf, g, stride=first.R)[..., :n]
        lib = lib.reshape(C, 2, n) if bank else lib
        lib_err = max(float((lib[:, 0] - pI).abs().max()),
                      float((lib[:, 1] - pQ).abs().max()))

        ms = cuda_ms(lambda: polyphase_decimate(xI, xQ, filt, n))
        plain_ms = cuda_ms(lambda: polyphase_plain(xI, xQ, filt, n))
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv1d(
            xf, g, stride=first.R))
        separate_ms = None
        if bank:
            # the same work as K one-filter launches over the stream
            separate_ms = cuda_ms(lambda: [polyphase_decimate(
                xI[0], xQ[0], f, n) for f in filt])
        # each input read once: a bank's one stream, else C rows
        nbytes, flops = polyphase_work(filt, C, L, n, hI.itemsize,
                                       one_stream=bank)
        bd = polyphase_bound(nbytes, flops, route, name)
        bytes_ms, fp32_core_ms = bd["bytes_ms"], bd["fp32_core_ms"]
        row = dict(shape=label, path=path, route=route, stage=stage,
                   dtype=dt, C=C,
                   L=L, frames=n, row_offset=offset, launches=launched,
                   max_abs_err=err, atol=atol, ms=ms, plain_ms=plain_ms,
                   separate_launches_ms=separate_ms,
                   library_ms=lib_ms, library_max_abs_err=lib_err,
                   bytes_ms=bytes_ms, fp32_core_ms=fp32_core_ms,
                   bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                   bytes=nbytes, flop=flops)
        rows.append(row)
        log(f"[kernel] {route} {label}: max|kernel-plain| {err:.3g} (atol "
            f"{atol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, conv1d "
            f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; bytes {bytes_ms:.4f}, fp32 cores "
            f"{fp32_core_ms:.4f})"
            f"{f'; {C} one-filter launches {separate_ms:.4f} ms' if bank else ''}")
        del xI, xQ, xf, lib
    torch.cuda.empty_cache()
    return rows


# the filter banks the front ends launched, by the stage name
# noted_calls gives them ("stage1 bank of K")
BANKS: dict = {}


def _stage_of(filt) -> str:
    from rtlsdr_wsprd_tpu_torch.frontend import decimate

    if isinstance(filt, (list, tuple)):
        name = f"stage1 bank of {len(filt)}"
        BANKS[name] = list(filt)
        return name
    return "stage1" if filt is decimate.STAGE1 else "stage2"


@contextlib.contextmanager
def noted_calls():
    """Set every kernel's launch count to 0 and note the (stage, input
    dtype, C, L, frames) of every polyphase call the front ends (the
    batched and single-lane decimators and the channelizer) make inside
    the block, counted by shape (the wrapper itself, which counts the
    launches, runs unchanged underneath)."""
    from rtlsdr_wsprd_tpu_torch.frontend import channelize, decimate
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate

    shapes: dict[tuple, int] = {}

    def noting(xI, xQ, filt, n_frames):
        key = (_stage_of(filt), str(xI.dtype).removeprefix("torch."),
               *(xI.shape if xI.dim() == 2 else (1, *xI.shape)), n_frames)
        shapes[key] = shapes.get(key, 0) + 1
        return polyphase_decimate(xI, xQ, filt, n_frames)

    decimate.polyphase_decimate = noting
    channelize.polyphase_decimate = noting
    for route in polyphase_decimate.launches:
        polyphase_decimate.launches[route] = 0
    try:
        yield shapes
    finally:
        decimate.polyphase_decimate = polyphase_decimate
        channelize.polyphase_decimate = polyphase_decimate


def _check_routes(label, launches, shapes, stage1_dtype):
    """Every stage-1 call of ``stage1_dtype`` went to its kernel (uint8:
    polyphase_tc, float32: polyphase.cu), every stage-2 call to
    polyphase.cu, and nothing else was called."""
    s1 = sum(k for key, k in shapes.items()
             if key[:2] == ("stage1", stage1_dtype))
    s2 = sum(k for key, k in shapes.items() if key[0] == "stage2")
    want = ({"tc": s1, "direct": s2} if stage1_dtype == "uint8"
            else {"tc": 0, "direct": s1 + s2})
    got = {"tc": launches["tc"], "direct": launches["direct"]}
    if (got != want or not s1 or not s2
            or sum(shapes.values()) != s1 + s2):
        fail(f"{label}: front-end calls {shapes} do not match launches "
             f"{got}: want {want}")


def synth_capture():
    """The 120 s raw 2.4 Msps capture of one K1JT FN20 20 signal, as
    10 s (I, Q) uint8 chunks."""
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_raw_2400k
    from rtlsdr_wsprd_tpu_torch.utils.channel import get_wspr_channel_symbols
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable

    symbols = get_wspr_channel_symbols("K1JT FN20 20", WsprHashTable())
    t0 = time.perf_counter()
    chunks = list(synth_raw_2400k(symbols, f0=30.0, t0=2.0, amp_counts=25.0,
                                  noise_counts=2.0, duration_s=120.0,
                                  seed=3))
    log(f"[frontend] synthesized 120 s raw capture in "
        f"{time.perf_counter() - t0:.1f} s")
    return chunks


def phase_frontend(dev, chunks, C: int = 8):
    """The main path: raw 120 s capture -> C-lane streaming front end ->
    decode of lane 0. Returns each kernel's launches ({route: count}),
    the count of launches per (stage, input dtype, C, L, frames) and
    lane 0's output planes."""
    from rtlsdr_wsprd_tpu_torch.config import SIGNAL_SAMPLES, DecoderOptions
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import decode_channels
    from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db

    with noted_calls() as shapes:
        t0 = time.perf_counter()
        fe = BatchedStreamingDecimator(C, device=dev)
        outs = [fe.push(np.broadcast_to(ri, (C, ri.size)),
                        np.broadcast_to(rq, (C, rq.size)))
                for ri, rq in chunks]
        outs.append(fe.flush())
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
    launches = dict(polyphase_decimate.launches)
    bI = np.concatenate([o[0] for o in outs], axis=1)
    bQ = np.concatenate([o[1] for o in outs], axis=1)
    if not all(np.array_equal(bI[c], bI[0]) and np.array_equal(bQ[c], bQ[0])
               for c in range(C)):
        fail("front-end lanes fed the same capture differ")
    if not (np.isfinite(bI).all() and np.isfinite(bQ).all()):
        fail("front-end output is not finite")
    wi = np.zeros(SIGNAL_SAMPLES, np.float32)
    wq = np.zeros(SIGNAL_SAMPLES, np.float32)
    n = min(SIGNAL_SAMPLES, bI.shape[1])
    wi[:n], wq[:n] = bI[0, :n], bQ[0, :n]
    i, q = normalize_minus3db(wi, wq)
    spots = decode_channels(i[None], q[None], DecoderOptions(),
                            device_batch=1, device=dev)[0]
    torch.cuda.synchronize()
    log(f"[frontend] {C} lanes x 120 s raw -> {bI.shape[1]} samples at "
        f"375 sps in {fe_s:.2f} s ({C * 120 / fe_s:.1f} channel-s per s, "
        f"host synthesis excluded); polyphase launches by kernel "
        f"{launches}; spots "
        f"{[(s.message, round(s.dt, 3), round(s.freq * 1e6 - 1500, 3)) for s in spots]}")
    if len(spots) != 1:
        fail(f"raw capture decoded {len(spots)} spots, want 1")
    s = spots[0]
    if (s.call, s.loc, s.pwr) != ("K1JT", "FN20", "20"):
        fail(f"raw capture decoded {s.message!r}")
    if abs(s.dt) >= 0.3 or abs((s.freq * 1e6 - 1500.0) - 30.0) >= 0.5:
        fail(f"raw capture spot off: dt {s.dt}, freq {s.freq}")
    _check_routes("front end", launches, shapes, "uint8")
    log(f"[frontend] launches by (stage, dtype, C, L, frames): "
        f"{sorted(shapes.items())}")
    return launches, shapes, bI[0], bQ[0]


def phase_single(dev, chunks, refI, refQ):
    """The single-channel front end: the same capture through
    StreamingDecimator, which centres the bytes on the host, so both of
    its stages are float32 calls on polyphase.cu. Its output must
    equal the batched front end's lane 0 (refI, refQ) within 2e-4 of the
    output scale. Returns its launches and launches by shape."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import StreamingDecimator
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate

    with noted_calls() as shapes:
        t0 = time.perf_counter()
        fe = StreamingDecimator(device=dev)
        outs = [fe.push(ri, rq) for ri, rq in chunks]
        outs.append(fe.flush())
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
    launches = dict(polyphase_decimate.launches)
    sI = np.concatenate([o[0] for o in outs])
    sQ = np.concatenate([o[1] for o in outs])
    if sI.shape != refI.shape or sQ.shape != refQ.shape:
        fail(f"single-lane output {sI.shape} != batched lane 0 {refI.shape}")
    scale = float(max(np.abs(refI).max(), np.abs(refQ).max()))
    err = float(max(np.abs(sI - refI).max(), np.abs(sQ - refQ).max()))
    log(f"[single] 1 lane x 120 s raw -> {sI.shape[0]} samples at 375 sps "
        f"in {fe_s:.2f} s ({120 / fe_s:.1f} channel-s per s); max |single - "
        f"batched lane 0| {err:.3g} (scale {scale:.4g}, tolerance "
        f"{2e-4 * scale:.3g}); polyphase launches by kernel {launches}")
    if not err <= 2e-4 * scale:
        fail(f"single-lane output differs from batched lane 0 by {err}")
    _check_routes("single lane", launches, shapes, "float32")
    log(f"[single] launches by (stage, dtype, C, L, frames): "
        f"{sorted(shapes.items())}")
    return launches, shapes


# integer operations (arithmetic, compares, selects; loads, stores and
# branches run on other units and are not counted) of the search itself,
# wsprd/fano.c as native/hostdsp.cpp writes it, whatever the kernel
# issues: every forward look 7 (the deepest-node update 2, the branch
# metric's select and add 2, the threshold test 1, the cycle count and
# its test 2); a look that moves 17 more (the first-visit test 2, the
# encoder shift 1, the position step and end test 2, the encoder parity
# 6, the complement symbol 1, the tail test 1, the branch sort 4); a
# backtrack move 5 (the origin and threshold tests 3, then a relax's
# threshold step and branch test, or the cheaper of that and a move up's
# decrement, tail and branch tests). The threshold's tightening (first
# visits only) and a relax's encoder flip are left out: the counts of
# those are not known from the outputs.
FANO_LOOK_OPS, FANO_MOVE_OPS, FANO_BACK_OPS = 7, 17, 5
FANO_BUDGETS = (16, 64, 256)
FANO_FIELDS = ("data", "success", "metric", "cycles", "maxnp")


def fano_step_kinds(cycles: np.ndarray, steps: np.ndarray, maxcycles: int):
    """Per lane (forward looks, backtrack moves, the fewest looks that
    can have moved) from a call's ``cycles`` and ``steps`` outputs.
    ``cycles`` is the looks + 1 where the last node was reached and
    maxcycles*81 + 2 on a timeout (after maxcycles*81 looks); padding
    lanes took no step. Every walk that a failed look starts ends in one
    relax or one move up to another branch, and the final depth is the
    moves forward less the moves up, so looks - backtrack moves = final
    depth + walks that ended moving up, which is at least 0 and at most
    the looks that moved."""
    max_total = maxcycles * 81
    looks = np.where(cycles == max_total + 2, max_total, cycles - 1)
    looks = np.where(steps == 0, 0, looks).astype(np.int64)
    back = steps.astype(np.int64) - looks
    if (back < 0).any() or (looks < back).any():
        fail(f"step counts do not fit the search at budget {maxcycles}")
    return looks, back, looks - back


def fano_mix(n: int = 512, n_pad: int = 16, seed: int = 5):
    """(symbols uint8[n, 162], valid bool[n]): in turn a clean encoded
    random payload (hard bytes), a noisy copy of one at sigma 20-80 and
    random symbols; the last ``n_pad`` lanes are padding."""
    from rtlsdr_wsprd_tpu_torch import native

    rng = np.random.default_rng(seed)

    def hard():
        p = np.zeros(11, np.uint8)
        p[:6] = rng.integers(0, 256, 6)
        p[6] = rng.integers(0, 256) & 0xC0
        e = native.conv_encode(p, 81)
        o = np.zeros(162)
        o[0::2] = np.where((e >> 1) & 1, 255, 0)
        o[1::2] = np.where(e & 1, 255, 0)
        return o

    rows = []
    for k in range(n):
        if k % 3 == 0:
            rows.append(hard())
        elif k % 3 == 1:
            rows.append(hard() + rng.normal(0, rng.uniform(20, 80), 162))
        else:
            rows.append(rng.integers(0, 256, 162))
    valid = np.ones(n, bool)
    valid[n - n_pad:] = False
    return np.clip(np.stack(rows), 0, 255).astype(np.uint8), valid


def capture_fano_calls(dev, wi, wq, opts, DB):
    """One hybrid decode of the batch (a warm-up), returning the
    (attempts, valid) of each of its device Fano calls, caught by
    wrapping multichannel._fano_batch_packed here."""
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc

    real = mc._fano_batch_packed
    caught = []

    def catching(deint, valid, **kw):
        caught.append((deint.cpu().numpy(), valid.cpu().numpy()))
        return real(deint, valid, **kw)

    mc._fano_batch_packed = catching
    try:
        t0 = time.perf_counter()
        mc.decode_channels(wi, wq, opts, device_batch=DB, device=dev,
                           fec="hybrid")
        torch.cuda.synchronize()
    finally:
        mc._fano_batch_packed = real
    if not caught:
        fail("the hybrid decode made no device Fano call")
    log(f"[fano] hybrid decode (capture, warm-up) "
        f"{time.perf_counter() - t0:.2f} s: {len(caught)} device Fano "
        f"calls of {[int(v.sum()) for _, v in caught]} attempts")
    return caught


def phase_fano(dev, name, card, wi, wq, opts, DB):
    """The Fano kernel against its plain version and the native decoder
    on the synthetic mix and the decode's own calls, with times and
    bounds; returns one row per (input, budget) and the calibration."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate
    from rtlsdr_wsprd_tpu_torch.ops.fano import batched_fano, device_mettab

    # measured at the first decode with fec="auto" (the front-end phase)
    cal = calibrate.get_fec_calibration(dev)
    log(f"[fano] calibration {json.dumps(cal.as_dict())} ({card})")
    if cal.method == "measured":
        # _bucket_budget: timeout / device_cycle_ms >= 160 -> budget 256
        log(f"[fano] device_cycle_ms {cal.device_cycle_ms} against "
            f"{cal.native_timeout_ms / 160:.4f} ms that budget 256 allows "
            f"(native timeout {cal.native_timeout_ms} ms / 160): budget "
            f"{cal.device_maxcycles} ({card})")
    # the kernel's checks and times on the card named with its index,
    # so that the launcher selects it from the tensors' device
    dev = torch.device("cuda", 0)
    mt = device_mettab(dev)
    calls = capture_fano_calls(dev, wi, wq, opts, DB)
    # the decode's heaviest call: the most flat steps at the budget the
    # decode ran
    work = [int(batched_fano(torch.from_numpy(a).to(dev), mt, 60,
                             cal.device_maxcycles, torch.from_numpy(v).to(dev),
                             steps=True).steps.sum()) for a, v in calls]
    inputs = {"synthetic mix": fano_mix(), "decode attempts": calls[0]}
    heavy = int(np.argmax(work))
    if heavy:
        inputs["decode attempts, heaviest call"] = calls[heavy]
    log(f"[fano] flat steps of the decode's calls at budget "
        f"{cal.device_maxcycles}: {work}")
    rows = []
    for label, (syms, valid) in inputs.items():
        rows += fano_input_rows(dev, name, label, syms, valid, cal)
    return rows, cal


def fano_input_rows(dev, name, label, syms, valid, cal, phase: str = "fano"):
    """The Fano kernel on one input (symbols uint8[n, 162], valid
    bool[n]) on ``dev``: against the plain version on the card at
    budgets 16 and 64 (every field and the step counts) and against
    native.fano_decode at 256 and 10000, failing on any mismatch; then
    one row per budget (16, 64, 256 and the calibrated one) with the
    kernel's device time, the plain version's (at 16), the native
    decoder's host time and the bound."""
    from rtlsdr_wsprd_tpu_torch import native
    from rtlsdr_wsprd_tpu_torch.ops.fano import (
        METTAB,
        batched_fano,
        batched_fano_plain,
        device_mettab,
    )

    mt = device_mettab(dev)
    bw = card_peaks(name)[2]
    int_rate = int32_rate(name)
    threads = os.cpu_count() or 1
    cycles_per_ms = spin_cycles_per_ms()
    budgets = sorted(set(FANO_BUDGETS) | {cal.device_maxcycles})
    rows = []
    s = torch.from_numpy(syms).to(dev)
    v = torch.from_numpy(valid).to(dev)
    live = int(valid.sum())
    # kernel vs plain on the card: every field and the step counts
    plain_ms = None
    for mc in (16, 64):
        k = batched_fano(s, mt, 60, mc, v, steps=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = batched_fano_plain(s, mt, 60, mc, v, steps=True)
        torch.cuda.synchronize()
        if mc == 16:
            plain_ms = 1e3 * (time.perf_counter() - t0)
        bad = {f: int((getattr(k, f) != getattr(p, f)).sum())
               for f in (*FANO_FIELDS, "steps")}
        log(f"[{phase}] {label}: kernel vs plain at {mc}: mismatches {bad}")
        if any(bad.values()):
            fail(f"fano kernel vs plain, {label} at {mc}: {bad}")
    # kernel vs the native decoder, lane by lane
    for mc in (256, 10000):
        k = batched_fano(s, mt, 60, mc, v)
        got = {f: getattr(k, f).cpu().numpy()[valid] for f in FANO_FIELDS}
        ok, data, cyc, met, mnp = native.fano_decode_many(
            syms[valid], METTAB, 60, mc, threads=threads)
        bad = {"success": int((got["success"] != ok).sum()),
               "cycles": int((got["cycles"] != cyc).sum()),
               "metric": int((got["metric"] != met).sum()),
               "maxnp": int((got["maxnp"] != mnp).sum()),
               "data": int((got["data"][ok] != data[ok]).sum())}
        log(f"[{phase}] {label}: kernel vs native at {mc}: mismatches "
            f"{bad}; {int(ok.sum())} of {live} lanes decode")
        if any(bad.values()):
            fail(f"fano kernel vs native, {label} at {mc}: {bad}")
    for mc in budgets:
        k = batched_fano(s, mt, 60, mc, v, steps=True)
        steps = k.steps.cpu().numpy()
        looks, back, moved = fano_step_kinds(k.cycles.cpu().numpy(),
                                             steps, mc)
        ops = (FANO_LOOK_OPS * int(looks.sum()) + FANO_BACK_OPS
               * int(back.sum()) + FANO_MOVE_OPS * int(moved.sum()))
        ms = cuda_ms(lambda: batched_fano(s, mt, 60, mc, v),
                     reps=5 if mc > 64 else 25)
        t0 = time.perf_counter()
        native.fano_decode_many(syms[valid], METTAB, 60, mc,
                                threads=threads)
        host_ms = 1e3 * (time.perf_counter() - t0)
        n = syms.shape[0]
        nbytes = n * 162 + METTAB.nbytes + n + n * (11 + 1 + 3 * 4)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = ops / int_rate * 1e3
        row = dict(input=label, lanes=n, live_lanes=live, maxcycles=mc,
                   calibrated=mc == cal.device_maxcycles, ms=ms,
                   plain_ms=plain_ms if mc == 16 else None,
                   host_ms=host_ms, host_threads=threads,
                   steps_total=int(steps.sum()),
                   steps_max_lane=int(steps.max()),
                   forward_looks=int(looks.sum()),
                   backtrack_moves=int(back.sum()),
                   forward_moves_least=int(moved.sum()), ops=ops,
                   cycles_per_step=ms * cycles_per_ms / int(steps.max()),
                   bytes=nbytes,
                   bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms
                   else "operations", mismatches=0)
        rows.append(row)
        log(f"[{phase}] {label} x {n} lanes at {mc}: kernel {ms:.4f} ms, "
            f"plain {'-' if row['plain_ms'] is None else round(plain_ms, 1)}"
            f" ms, native on {threads} threads {host_ms:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {ops} "
            f"integer operations: {row['forward_looks']} forward looks, "
            f"at least {row['forward_moves_least']} of them moving, "
            f"{row['backtrack_moves']} backtrack moves; "
            f"{row['steps_total']} steps, slowest lane "
            f"{row['steps_max_lane']}: "
            f"{row['cycles_per_step']:.1f} cycles a step at "
            f"{cycles_per_ms / 1e6:.3f} GHz)")
    return rows


def _fields(spots):
    """Every field of per-channel spot lists (the equality the decode
    paths are held to)."""
    return [[(x.message, x.jitter, x.cycles, x.freq, x.snr, x.dt, x.sync,
              x.drift) for x in ch] for ch in spots]


def phase_decode(dev, card, wi, wq, calls, cal, DB: int = 128):
    """Host, hybrid and pipelined decode of the batch; returns the Fano
    kernel's launches on the hybrid runs."""
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.ops import calibrate
    from rtlsdr_wsprd_tpu_torch.ops.fano import batched_fano
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (
        decode_channels,
        decode_channels_pipelined,
    )

    B = wi.shape[0]
    opts = DecoderOptions()
    log(f"[decode] FEC: {calibrate.describe()}; {json.dumps(cal.as_dict())}")

    def run(fec):
        out = decode_channels(wi, wq, opts, device_batch=DB, device=dev,
                              fec=fec)
        torch.cuda.synchronize()
        return out

    def timed(fec):
        t0 = time.perf_counter()
        spots = run(fec)
        log(f"[decode] fec={fec}: warm-up run {time.perf_counter() - t0:.2f} s")
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = run(fec)
            secs.append(time.perf_counter() - t0)
            if _fields(got) != _fields(spots):
                fail(f"fec={fec}: decode runs disagree")
        med = statistics.median(secs)
        missing = [b for b in range(B) if b % 4 != 3 and calls[b % 4]
                   not in [x.message for x in spots[b]]]
        noisy = [b for b in range(B) if b % 4 == 3 and spots[b]]
        if missing:
            fail(f"fec={fec}: strong message missing in windows "
                 f"{missing[:10]}")
        if noisy:
            fail(f"fec={fec}: noise-only windows gave spots: {noisy[:10]}")
        bad = [x for ch in spots for x in ch
               if not all(np.isfinite([x.freq, x.snr, x.dt, x.sync]))]
        if bad:
            fail(f"fec={fec}: non-finite spot fields: {bad[:3]}")
        log(f"[decode] fec={fec} B={B} device_batch={DB}: runs "
            f"{[round(x, 3) for x in secs]} s, median {med:.3f} s = "
            f"{B / med:.1f} decode windows/s ({card}); spots "
            f"{sum(len(ch) for ch in spots)} (first 32 windows: "
            f"{sum(len(ch) for ch in spots[:32])})")
        return spots, B / med

    host, host_rate = timed("host")
    batched_fano.launches = 0
    hybrid, hybrid_rate = timed("hybrid")
    launches = batched_fano.launches
    if not launches:
        fail("the hybrid decode launched the Fano kernel no time")
    if _fields(hybrid) != _fields(host):
        diff = [b for b in range(B)
                if _fields(hybrid)[b] != _fields(host)[b]]
        fail(f"hybrid spots differ from host in windows {diff[:10]}")
    log(f"[decode] hybrid spot lists equal host's; {launches} Fano kernel "
        f"launches over the 4 hybrid runs ({launches // 4} a run)")

    n_batches = 4
    want = _fields(host)
    t0 = time.perf_counter()
    out = list(decode_channels_pipelined(
        [(wi, wq)] * n_batches, opts, depth=2, device_batch=DB,
        device="cuda:0"))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    if len(out) != n_batches or any(_fields(o) != want for o in out):
        fail("a pipelined batch differs from the host decode")
    pipe_rate = n_batches * B / pipe_s
    log(f"[decode] decode_channels_pipelined depth 2 on cuda:0, {n_batches}"
        f" x {B} windows (fec=auto: {cal.mode}): {pipe_s:.2f} s = {pipe_rate:.1f} "
        f"decode windows/s ({card}); every batch equals the host decode")
    phase_profile(lambda: run("auto"), card)
    return dict(host=host_rate, hybrid=hybrid_rate, pipelined=pipe_rate,
                hybrid_launches=launches, host_spots=host)


DENSE_B = 64  # windows of the dense phase (the batch's first)


def _dense_mismatches(got, want) -> list[int]:
    """Channels whose spot lists differ beyond the JAX package's
    dense-vs-staged tolerances (tests/test_multichannel.py): message,
    jitter and cycles equal, freq within 0.5e-6 MHz, snr within 0.5 dB,
    dt within 0.05 s."""
    bad = [b for b, (g, w) in enumerate(zip(got, want))
           if len(g) != len(w) or any(
               (x.message, x.jitter, x.cycles)
               != (y.message, y.jitter, y.cycles)
               or abs(x.freq - y.freq) > 0.5e-6 or abs(x.snr - y.snr) > 0.5
               or abs(x.dt - y.dt) > 0.05 for x, y in zip(g, w))]
    return bad + list(range(min(len(got), len(want)),
                            max(len(got), len(want))))


def phase_dense(dev, name, card, wi, wq, calls, host_spots, cal):
    """The dense program on the first DENSE_B windows of the batch: one
    multichannel_decode_device call (device time, peak memory, Fano
    launches); decode_channels(sharding=channel_sharding(make_mesh(
    ["cuda:0"]))), its main path, with the Fano kernel's launches counted
    from 0 around its timed runs, its spot lists held against the staged
    host decode of the same windows (_dense_mismatches) and its windows/s
    beside the staged host and hybrid rates on them; the step on two
    shards of cuda:0 equal in every ChannelDecode field to one shard;
    WsprDecoder(staged=False) on 4 windows against the mesh path's
    spots; and the step's own Fano lanes through fano_input_rows. One
    more mesh-path run goes under torch.profiler (phase_profile). Returns the
    Fano rows of the dense call and the launches of each path."""
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.models.decoder import WsprDecoder
    from rtlsdr_wsprd_tpu_torch.ops.fano import batched_fano
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
    from rtlsdr_wsprd_tpu_torch.parallel.mesh import (
        channel_sharding,
        make_mesh,
    )

    B = DENSE_B
    wi, wq = wi[:B], wq[:B]
    opts = DecoderOptions()
    dev = torch.device("cuda", 0)
    kw = dict(mc._decode_kw(opts), max_attempts=mc.DEFAULT_MAX_ATTEMPTS,
              delta=opts.delta,
              maxcycles=mc._device_fano_budget(opts.maxcycles, dev))
    si = torch.from_numpy(wi).to(dev)
    sq = torch.from_numpy(wq).to(dev)
    md = torch.full((B,), opts.maxdrift, dtype=torch.int32, device=dev)

    # one step with its Fano call's lanes caught (and a warm-up)
    real = mc.batched_fano
    caught = []

    def catching(symbols, mettab, **fkw):
        caught.append((symbols.cpu().numpy(), fkw["valid"].cpu().numpy()))
        return real(symbols, mettab, **fkw)

    mc.batched_fano = catching
    try:
        mc.multichannel_decode_device(si, sq, md, **kw)
        torch.cuda.synchronize()
    finally:
        mc.batched_fano = real
    if len(caught) != 1 or caught[0][0].shape != (
            B * mc.DEFAULT_MAX_ATTEMPTS, 162):
        fail(f"the dense step made {len(caught)} Fano calls of "
             f"{[c[0].shape for c in caught]}")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    batched_fano.launches = 0
    out = mc.multichannel_decode_device(si, sq, md, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    step_launches = batched_fano.launches
    n_gate = out.n_gate.cpu().numpy()
    live = int(out.sel_valid.sum())
    if step_launches != 1:
        fail(f"the dense step launched the Fano kernel {step_launches} "
             "times")
    log(f"[dense] multichannel_decode_device B={B} (chunks of "
        f"{mc.DENSE_WINDOWS} windows, max_attempts "
        f"{mc.DEFAULT_MAX_ATTEMPTS}, Fano budget {kw['maxcycles']}): "
        f"peak memory {peak / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before it; 1 Fano launch of "
        f"{B * mc.DEFAULT_MAX_ATTEMPTS} lanes, {live} live; gate-passing "
        f"attempts a window max {int(n_gate.max())}, total "
        f"{int(n_gate.sum())} ({card})")
    del out
    step_ms = cuda_ms(lambda: mc.multichannel_decode_device(si, sq, md, **kw),
                      reps=5, warm=1)
    log(f"[dense] multichannel_decode_device B={B}: {step_ms:.2f} ms of "
        f"device time between CUDA events (median of 5) ({card})")

    # the main path: the mesh path's host loop on one shard of the card
    mesh1 = make_mesh(["cuda:0"])

    def dense_run():
        got = mc.decode_channels(wi, wq, opts,
                                 sharding=channel_sharding(mesh1))
        torch.cuda.synchronize()
        return got

    t0 = time.perf_counter()
    spots = dense_run()
    log(f"[dense] decode_channels(sharding=[cuda:0]): warm-up run "
        f"{time.perf_counter() - t0:.2f} s")
    counts = {}
    batched_fano.launches = 0
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = dense_run()
        secs.append(time.perf_counter() - t0)
        if _fields(got) != _fields(spots):
            fail("dense decode runs disagree")
    counts["dense"] = {"fano": batched_fano.launches}
    if not counts["dense"]["fano"]:
        fail("the dense decode launched the Fano kernel no time")
    dense_rate = B / statistics.median(secs)
    bad = _dense_mismatches(spots, host_spots[:B])
    if bad:
        b0 = bad[0]
        fail(f"dense spots differ from the staged host decode in windows "
             f"{bad[:10]}: {_fields(spots[b0:b0 + 1])} != "
             f"{_fields(host_spots[b0:b0 + 1])}")
    missing = [k for k in range(B) if k % 4 != 3 and calls[k % 4]
               not in [x.message for x in spots[k]]]
    noisy = [k for k in range(B) if k % 4 == 3 and spots[k]]
    if missing or noisy:
        fail(f"dense decode: strong message missing in windows "
             f"{missing[:10]}, spots on noise windows {noisy[:10]}")
    n_float = sum(_fields([x]) != _fields([y])
                  for x, y in zip(spots, host_spots[:B]))
    staged = {}
    for fec in ("host", "hybrid"):
        mc.decode_channels(wi, wq, opts, device_batch=DENSE_B, device=dev,
                           fec=fec)
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            mc.decode_channels(wi, wq, opts, device_batch=DENSE_B,
                               device=dev, fec=fec)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        staged[fec] = B / statistics.median(t)
    log(f"[dense] decode_channels(sharding=[cuda:0]) B={B}: runs "
        f"{[round(x, 3) for x in secs]} s = {dense_rate:.1f} decode "
        f"windows/s; staged on the same windows: host {staged['host']:.1f}, "
        f"hybrid {staged['hybrid']:.1f} windows/s ({card}); "
        f"{counts['dense']['fano']} Fano launches over the 3 runs; spots "
        f"{sum(len(ch) for ch in spots)}, equal to the staged host decode "
        f"in message, jitter and cycles ({n_float} windows differ in a "
        f"float field, all within the tolerances)")

    phase_profile(dense_run, card, label="dense profile")

    # two shards of the card against one, every field
    mesh2 = make_mesh(["cuda:0", "cuda:0"])
    steps = [mc._mesh_step(*mc.shard_windows(wi, wq, m),
                           channel_sharding(m), opts.maxdrift, kw)
             for m in (mesh1, mesh2)]
    diff = [f for f, x, y in zip(mc.ChannelDecode._fields, *steps)
            if not np.array_equal(x, y)]
    if diff:
        fail(f"the dense step on two shards differs from one in {diff}")
    log("[dense] the step on 2 shards of cuda:0 equals 1 shard in every "
        "ChannelDecode field")

    # the per-window dense decoder against the mesh path
    batched_fano.launches = 0
    dec = WsprDecoder(opts, staged=False, device=dev)
    per = [dec.decode(wi[k], wq[k]) for k in range(4)]
    counts["decode_window (4 windows)"] = {"fano": batched_fano.launches}
    bad = _dense_mismatches(per, spots[:4])
    if bad:
        fail(f"WsprDecoder(staged=False) differs from the mesh path in "
             f"windows {bad}: {_fields(per)} != {_fields(spots[:4])}")
    log(f"[dense] WsprDecoder(staged=False) on windows 0-3 equals the mesh "
        f"path's spots ({sum(len(x) for x in per)} spots, "
        f"{batched_fano.launches} Fano launches)")

    rows = fano_input_rows(dev, name, "dense call", *caught[0], cal,
                           phase="dense")
    log(json.dumps({"dense": {
        "card": card, "B": B, "step_ms": step_ms,
        "step_peak_bytes": peak, "decode_windows_per_s": dense_rate,
        "staged_host_windows_per_s": staged["host"],
        "staged_hybrid_windows_per_s": staged["hybrid"],
        "fano_launches": counts}}))
    return rows, counts, dense_rate


RANGES = ("stage_a", "stage_b_launch", "stage_b_wait", "fec_host",
          "fec_device", "fec_host_finish", "spots", "subtract", "dense_step")


def phase_profile(run, card, label: str = "profile"):
    """One more decode run under torch.profiler: the host time inside
    each labelled range of decode_channels, the card's total kernel time
    and its busy share of the run, and the heaviest kernels; logged as
    one JSON line under ``label``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))

    # the device-side entries are the kernels and copies themselves (the
    # host ops that launched them carry the same time again) plus, under
    # each range's name, the device span of that range
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in ka if e.device_type == cuda and e.key not in RANGES]
    kernel_ms = sum(dev_us(e) for e in kernels) / 1e3
    host_ms = {e.key: round(e.cpu_time_total / 1e3, 3) for e in ka
               if e.key in RANGES and e.device_type != cuda}
    span_ms = {e.key: round(dev_us(e) / 1e3, 3) for e in ka
               if e.key in RANGES and e.device_type == cuda}
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    log(json.dumps({label: {
        "card": card, "wall_ms": round(wall * 1e3, 3),
        "kernel_ms": round(kernel_ms, 3),
        "device_busy_share": round(kernel_ms / (wall * 1e3), 4),
        "host_ms_in_range": host_ms, "device_span_ms_of_range": span_ms,
        "top_kernels_ms": [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count]
                           for e in top]}}))


# ---- the daemons ------------------------------------------------------------

DAEMON_CALL, DAEMON_LOC = "K1ABC", "FN42"
# the 8 channels' dials: one WSPR band each (the JAX package's band table)
DAEMON_BANDS = ("20m", "40m", "30m", "80m", "17m", "15m", "12m", "10m")


class LoopbackRtlTcp:
    """An rtl_tcp server on 127.0.0.1 for one connection: the RTL0
    header, the client's ``n_commands`` tuning commands (kept in
    ``commands``), then the capture's interleaved uint8 bytes in 1 MB
    pieces at most ``bytes_per_s`` (10x real time: the client's 256 MB
    ring never overflows), then EOF."""

    def __init__(self, chunks, n_commands: int, bytes_per_s: float = 48e6):
        import socket

        self._chunks = chunks
        self._n_commands = n_commands
        self._rate = bytes_per_s
        self.commands: list[tuple[int, int]] = []
        self.sent = 0
        self.error: Exception | None = None
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(60.0)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="loopback-rtl_tcp")
        self._thread.start()

    def _serve(self):
        import struct

        try:
            conn, _ = self._srv.accept()
            with conn:
                conn.settimeout(60.0)
                conn.sendall(b"RTL0" + bytes(8))
                buf = b""
                while len(buf) < 5 * self._n_commands:
                    got = conn.recv(4096)
                    if not got:
                        raise IOError("client closed during tuning")
                    buf += got
                self.commands = [struct.unpack(">BI", buf[k:k + 5])
                                 for k in range(0, len(buf), 5)]
                t0 = time.perf_counter()
                for ri, rq in self._chunks:
                    b = np.empty(2 * ri.size, np.uint8)
                    b[0::2], b[1::2] = ri, rq
                    view = memoryview(b)
                    for k in range(0, len(view), 1 << 20):
                        piece = view[k:k + (1 << 20)]
                        conn.sendall(piece)
                        self.sent += len(piece)
                        ahead = self.sent / self._rate - (
                            time.perf_counter() - t0)
                        if ahead > 0:
                            time.sleep(ahead)
                conn.shutdown(1)
                while conn.recv(1 << 16):  # until the client closes
                    pass
        except Exception as e:  # reported by close()
            self.error = e
        finally:
            self._srv.close()

    def close(self):
        self._thread.join(timeout=120.0)
        if self._thread.is_alive():
            fail("the loopback rtl_tcp server did not finish")
        if self.error is not None:
            fail(f"the loopback rtl_tcp server failed: {self.error!r}")


def replay_bank(chunks, n_channels: int):
    """A RawBank that serves one raw capture (uint8 (I, Q) chunks) to
    every one of ``n_channels`` channels, then ends."""
    from rtlsdr_wsprd_tpu_torch.runtime.banks import RawBank

    class ReplayBank(RawBank):
        def __init__(self):
            self.n_channels = n_channels
            self._I = np.concatenate([c[0] for c in chunks])
            self._Q = np.concatenate([c[1] for c in chunks])
            self._pos = 0

        def read(self, n):
            sl = slice(self._pos, self._pos + n)
            ri, rq = self._I[sl], self._Q[sl]
            self._pos += ri.size
            return (np.broadcast_to(ri, (n_channels, ri.size)),
                    np.broadcast_to(rq, (n_channels, rq.size)))

    return ReplayBank()


def _captured(fn):
    """fn() with its standard output caught; returns (result, text). The
    text is logged too, each line tagged [daemon] >."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            log(f"[daemon] > {line}")
    return rc, text


def _recording(cls, made: list):
    """A subclass of ``cls`` whose instances are appended to ``made``;
    where ``cls`` has a ``run``, its result is kept as ``result``."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    if hasattr(cls, "run"):
        def run(self, *a, **kw):
            self.result = cls.run(self, *a, **kw)
            return self.result

        Recording.run = run
    return Recording


def _spot_lines(text: str) -> list[str]:
    return [x for x in text.splitlines() if x.startswith("Spot")]


@contextlib.contextmanager
def counted_path(label: str, counts: dict, shapes_by_path: dict,
                 phase: str = "daemon"):
    """Drive one path with every kernel's count set to 0 just before it;
    after it, note its launches by kernel (``counts[label]``) and the
    front end's calls by shape (``shapes_by_path[label]``)."""
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate
    from rtlsdr_wsprd_tpu_torch.ops.fano import batched_fano

    with noted_calls() as shapes:
        batched_fano.launches = 0
        yield shapes
        torch.cuda.synchronize()
    counts[label] = dict(polyphase_decimate.launches,
                         fano=batched_fano.launches)
    shapes_by_path[label] = shapes
    log(f"[{phase}] {label}: launches {counts[label]}; front-end calls by "
        f"(stage, dtype, C, L, frames) {sorted(shapes.items())}")


def phase_daemon(dev, card, chunks, laneI, laneQ):
    """The daemons and CLIs, as a user starts them: cli -t, cli -r on an
    .iq and a .c2 of the front end's lane 0, the single-dongle daemon
    over a loopback rtl_tcp server, the 8-channel MultiChannelDaemon
    over a replay bank (then once more under torch.profiler), and
    multicli --synth 2. Returns the launches and the front end's calls
    by shape of each path, and the numbers for the summary line."""
    import tempfile

    from rtlsdr_wsprd_tpu_torch import cli, multicli
    from rtlsdr_wsprd_tpu_torch.config import (
        BAND_TABLE,
        SIGNAL_SAMPLES,
        DecoderOptions,
    )
    from rtlsdr_wsprd_tpu_torch.models.decoder import WsprDecoder
    from rtlsdr_wsprd_tpu_torch.runtime import iqio
    from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon
    from rtlsdr_wsprd_tpu_torch.runtime.reporting import (
        WSPRNET_BASE,
        WsprnetReporter,
        format_table_header,
        format_table_line,
    )

    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    summary: dict = {"card": card}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        # 1. self-test
        with counted_path("cli -t", counts, shapes_by_path):
            rc, text = _captured(lambda: cli.main(["-t"]))
        if rc != 0 or "Self-test SUCCESS!" not in text:
            fail(f"cli -t returned {rc}")

        # 2. file decodes of lane 0's window: the table equals the port's
        # WsprDecoder on the same window
        wi = np.zeros(SIGNAL_SAMPLES, np.float32)
        wq = np.zeros(SIGNAL_SAMPLES, np.float32)
        n = min(SIGNAL_SAMPLES, laneI.shape[0])
        wi[:n], wq[:n] = laneI[:n], laneQ[:n]
        iqio.write_iq_file(wi, wq, "lane0.iq")
        iqio.write_c2_file(wi, wq, "lane0.c2", BAND_TABLE["20m"][0],
                           name="lane0")
        with counted_path("cli -r", counts, shapes_by_path):
            for f, freq in (("lane0.iq", 0), ("lane0.c2",
                                               BAND_TABLE["20m"][0])):
                rc, text = _captured(lambda: cli.main(["-r", f]))
                i, q = (iqio.read_iq_file(f) if f.endswith(".iq")
                        else iqio.read_c2_file(f)[:2])
                want = WsprDecoder(DecoderOptions(freq=freq),
                                   device=dev).decode(i, q)
                lines = text.splitlines()
                table = [format_table_header()] + [format_table_line(s)
                                                   for s in want]
                if rc != 0 or lines[1:] != table:
                    fail(f"cli -r {f}: rc {rc}, table {lines[1:]} != {table}")
                if [(s.call, s.loc, s.pwr) for s in want] != [
                        ("K1JT", "FN20", "20")]:
                    fail(f"cli -r {f} decoded {[s.message for s in want]}")

        # 3. the single-dongle daemon over rtl_tcp; the CLI's source and
        # daemon are kept, to read their counters
        made: list = []
        real = cli.RtlTcpSource, cli.WsprDaemon
        cli.RtlTcpSource, cli.WsprDaemon = (_recording(c, made)
                                            for c in real)
        dial = BAND_TABLE["20m"][0]
        srv = LoopbackRtlTcp(chunks, n_commands=5)
        try:
            with counted_path("rtl_tcp daemon", counts, shapes_by_path):
                t0 = time.perf_counter()
                rc, text = _captured(lambda: cli.main([
                    "-f", "20m", "-c", DAEMON_CALL, "-l", DAEMON_LOC,
                    "-i", f"127.0.0.1:{srv.port}", "-n", "1", "--no-align",
                    "-x"]))
                wall = time.perf_counter() - t0
        finally:
            cli.RtlTcpSource, cli.WsprDaemon = real
            srv.close()
        session = [x for x in text.splitlines() if x.startswith("Session:")]
        source = [m for m in made if isinstance(m, real[0])]
        daemon = [m for m in made if isinstance(m, real[1])]
        dropped = source[0].dropped_bytes if source else -1
        spots = _spot_lines(text)
        log(f"[daemon] rtl_tcp: {srv.sent} bytes served, commands "
            f"{srv.commands}, {session}, dropped bytes {dropped}, "
            f"{wall:.2f} s wall (the stream is paced at 10x real time)")
        if (rc != 0 or len(made) != 2 or dropped != 0 or not session
                or "Session: 1 windows, 1 spots, 0 errors" not in session[0]
                or len(spots) != 1 or not spots[0].endswith(
                    "   K1JT   FN20 20")):
            fail(f"rtl_tcp daemon: rc {rc}, session {session}, spots "
                 f"{spots}, dropped bytes {dropped}")
        if (0x01, dial + 601_500) not in srv.commands:
            fail(f"rtl_tcp daemon tuned {srv.commands}")
        _check_routes("rtl_tcp daemon", counts["rtl_tcp daemon"],
                      shapes_by_path["rtl_tcp daemon"], "float32")
        st = daemon[0].stats
        log(f"[daemon] rtl_tcp daemon: its window decoded in "
            f"{st.decode_seconds:.4f} s ({card})")
        summary["rtl_tcp_daemon"] = {
            "windows": st.windows, "errors": st.errors,
            "wall_s": round(wall, 3),
            "window_decode_s": round(st.decode_seconds, 4),
            "dropped_bytes": dropped}

        # 4. the 8-channel daemon at full width over a replay bank
        C = len(DAEMON_BANDS)
        dials = [BAND_TABLE[b][0] for b in DAEMON_BANDS]

        def make_daemon(urls, devices="default"):
            reps = [WsprnetReporter(DAEMON_CALL, DAEMON_LOC, df,
                                    transport=urls[k].append)
                    for k, df in enumerate(dials)]
            return MultiChannelDaemon(
                replay_bank(chunks, C),
                DecoderOptions(freq=dials[0], rcall=DAEMON_CALL,
                               rloc=DAEMON_LOC),
                device_batch=64, fec="auto", frontend="device",
                dialfreqs=dials, reporters=reps, device=dev,
                devices=devices)

        urls = [[] for _ in range(C)]
        with counted_path("multi daemon", counts, shapes_by_path):
            t0 = time.perf_counter()
            daemon = make_daemon(urls)
            fec = daemon.describe_fec()
            out = daemon.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        st = daemon.stats
        log(f"[daemon] multi: FEC {fec}; stats {st}; {secs:.2f} s = "
            f"{st.channel_windows / secs:.3f} channel-windows/s on the host "
            f"clock, replay of the raw capture included ({card})")
        if st.errors or len(out) != 1 or len(out[0]) != C:
            fail(f"multi daemon: {st.errors} errors, {len(out)} batches")
        for ch, spots in enumerate(out[0]):
            hit = [s for s in spots if (s.call, s.loc, s.pwr) == (
                "K1JT", "FN20", "20") and abs(s.freq * 1e6 - dials[ch]
                                              - 1530.0) < 0.5]
            if len(hit) != 1:
                fail(f"multi daemon channel {ch} (dial {dials[ch]}): spots "
                     f"{[(s.message, s.freq) for s in spots]}")
            if len(urls[ch]) != len(spots) or not all(
                    u.startswith(WSPRNET_BASE + "?function=wspr&")
                    and f"rqrg={s.freq:.6f}" in u
                    for u, s in zip(urls[ch], spots)):
                fail(f"multi daemon channel {ch}: URLs {urls[ch]} for "
                     f"{len(spots)} spots")
        _check_routes("multi daemon", counts["multi daemon"],
                      shapes_by_path["multi daemon"], "uint8")
        if not counts["multi daemon"]["fano"]:
            fail("the multi daemon launched the Fano kernel no time")
        summary["multi_daemon"] = {
            "channels": C, "channel_windows": st.channel_windows,
            "spots": st.spots, "errors": st.errors, "wall_s": round(secs, 3),
            "channel_windows_per_s": round(st.channel_windows / secs, 4),
            "ingest_s": round(st.ingest_seconds, 3), "fec": fec}

        # the same daemon decoding on two shards of the one card
        # (devices=[cuda:0, cuda:0]): the spots of the default run
        with counted_path("multidevice daemon", counts, shapes_by_path,
                          phase="multidevice"):
            t0 = time.perf_counter()
            two = make_daemon([[] for _ in range(C)],
                              devices=["cuda:0", "cuda:0"])
            out2 = two.run()
            torch.cuda.synchronize()
            secs2 = time.perf_counter() - t0
        if (two.stats.errors or len(out2) != 1
                or _mismatches(out2[0], out[0])):
            fail(f"multidevice daemon: {two.stats.errors} errors, spots "
                 f"{_fields(out2[0]) if out2 else None} != the default "
                 f"run's {_fields(out[0])}")
        _check_routes("multidevice daemon", counts["multidevice daemon"],
                      shapes_by_path["multidevice daemon"], "uint8")
        if not counts["multidevice daemon"]["fano"]:
            fail("the multidevice daemon launched the Fano kernel no time")
        log(f"[multidevice] 8-channel daemon on 2 shards of cuda:0: "
            f"{two.stats.channel_windows} channel-windows in {secs2:.2f} s "
            f"= {two.stats.channel_windows / secs2:.4f} channel-windows/s "
            f"(host clock, replay included; {card}); spots "
            f"{'equal to' if _fields(out2[0]) == _fields(out[0]) else 'within float rounding of'}"
            f" the default run's")
        summary["multidevice_daemon"] = {
            "shards": 2, "channel_windows": two.stats.channel_windows,
            "wall_s": round(secs2, 3), "channel_windows_per_s": round(
                two.stats.channel_windows / secs2, 4)}
        del daemon, out, two, out2
        phase_profile(lambda: make_daemon([[] for _ in range(C)]).run(),
                      card, label="multi_daemon_profile")

        # 5. multicli on two synthetic raw channels
        with counted_path("multicli", counts, shapes_by_path):
            t0 = time.perf_counter()
            rc, text = _captured(lambda: multicli.main(
                ["--synth", "2", "-n", "1", "-x"]))
            secs = time.perf_counter() - t0
        if rc != 0 or "2 channel-windows, 2 spot(s), 0 error(s)" not in text:
            fail(f"multicli --synth 2: rc {rc}")
        if sum("K1JT   FN20 20" in x for x in _spot_lines(text)) != 2:
            fail(f"multicli --synth 2 spots {_spot_lines(text)}")
        _check_routes("multicli", counts["multicli"],
                      shapes_by_path["multicli"], "uint8")
        summary["multicli_synth2_wall_s"] = round(secs, 3)
    log(json.dumps({"daemon": summary}))
    return counts, shapes_by_path


def _mismatches(got, want) -> list[int]:
    """Channels whose spot lists differ beyond float rounding: message
    equal, every other field within tools/torch_snr_sweep.py's FIELD_TOL
    (freq 1e-7 MHz, dt one sample, snr 0.01 dB, sync 1e-4, since sums
    over lane buckets of other sizes round otherwise on the card; drift,
    cycles and jitter exact)."""
    from torch_snr_sweep import FIELD_TOL

    bad = []
    for b, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w) or any(
                x.message != y.message
                or any(abs(getattr(x, f) - getattr(y, f)) > tol
                       for f, tol in FIELD_TOL)
                for x, y in zip(g, w)):
            bad.append(b)
    return bad + list(range(min(len(got), len(want)),
                            max(len(got), len(want))))


# ---- the channelizer, the multi-device decode, the multi-host runtime ------

# one dongle in direct sampling, tuned to LF, decoding LF, MF and 160 m
# from its one 2.4 Msps stream (the channelizer's own deployment)
WIDE_BANDS = ("lf", "mf", "160m")


def wideband_capture(dev, chunks):
    """The 3-dial capture, made on the card from the 120 s capture: the
    centred capture plus copies rotated up by each other dial's distance
    from LF (the signal then sits at every dial + 1,530 Hz), the phase
    continuous across chunks, requantised to uint8. Returns the dials
    and the chunks."""
    from rtlsdr_wsprd_tpu_torch.config import BAND_TABLE
    from rtlsdr_wsprd_tpu_torch.frontend.channelize import FS

    dials = [BAND_TABLE[b][0] for b in WIDE_BANDS]
    out = []
    n0 = 0
    for ri, rq in chunks:
        zi = torch.from_numpy(ri).to(dev).to(torch.float32) - 128.0
        zq = torch.from_numpy(rq).to(dev).to(torch.float32) - 128.0
        n = torch.arange(n0, n0 + ri.size, device=dev, dtype=torch.int64)
        ai, aq = zi.clone(), zq.clone()
        for d in dials[1:]:
            # (f n) mod fs is exact in int64, and below 2^24
            ph = ((n * (d - dials[0])) % FS).to(torch.float32) * (
                2.0 * np.pi / FS)
            c, s = torch.cos(ph), torch.sin(ph)
            ai += zi * c - zq * s
            aq += zi * s + zq * c
        out.append(tuple(
            torch.clamp(torch.round(a) + 128.0, 0, 255).to(torch.uint8)
            .cpu().numpy() for a in (ai, aq)))
        n0 += ri.size
    torch.cuda.synchronize()
    return dials, out


def phase_channelize(dev, card, chunks):
    """The wideband channelizer: a zero-offset dial against the plain
    batched front end, then multicli --dial over a loopback rtl_tcp
    server serving the 3-dial capture. Returns the launches and the
    front end's calls by shape of each path, and the summary."""
    import tempfile

    from rtlsdr_wsprd_tpu_torch import multicli
    from rtlsdr_wsprd_tpu_torch.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.runtime import banks

    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    summary: dict = {"card": card}

    # 1. the tuned dial's channel is the plain front end
    def run(fe, src):
        outs = [fe.push(ri[None], rq[None]) for ri, rq in src]
        outs.append(fe.flush())
        return (np.concatenate([o[0] for o in outs], axis=1),
                np.concatenate([o[1] for o in outs], axis=1))

    with counted_path("channelizer, zero offset", counts, shapes_by_path,
                      phase="channelize"):
        t0 = time.perf_counter()
        cI, cQ = run(ChannelizingStreamingDecimator([0.0], device=dev),
                     chunks)
        secs = time.perf_counter() - t0
    pI, pQ = run(BatchedStreamingDecimator(1, device=dev), chunks)
    scale = float(np.abs(pI).max())
    err = float(max(np.abs(cI - pI).max(), np.abs(cQ - pQ).max())) if (
        cI.shape == pI.shape) else float("inf")
    log(f"[channelize] zero-offset dial vs BatchedStreamingDecimator(1): "
        f"max |diff| {err:.3g} (scale {scale:.4g}, tolerance "
        f"{1e-5 * scale:.3g}); {sum(c[0].size for c in chunks) / 2.4e6:.0f} "
        f"s of capture in {secs:.2f} s")
    if not err <= 1e-5 * scale:
        fail(f"the zero-offset channelizer differs from the plain front end "
             f"by {err}")

    # 2. the 3-dial capture through the channelizer alone (unpaced)
    t0 = time.perf_counter()
    dials, wide = wideband_capture(dev, chunks)
    log(f"[channelize] made the {len(dials)}-dial capture (dials {dials}) "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    offsets = [dials[0] - d for d in dials]
    with counted_path(f"channelizer, {len(dials)} dials", counts,
                      shapes_by_path, phase="channelize"):
        t0 = time.perf_counter()
        wI, wQ = run(ChannelizingStreamingDecimator(offsets, device=dev),
                     wide)
        secs = time.perf_counter() - t0
    if wI.shape[0] != len(dials) or wI.shape[1] != pI.shape[1] or not (
            np.isfinite(wI).all() and np.isfinite(wQ).all()):
        fail(f"the {len(dials)}-dial channelizer gave {wI.shape}")
    rate = len(dials) * sum(c[0].size for c in wide) / 2.4e6 / secs
    log(f"[channelize] {len(dials)} dials x 120 s raw in {secs:.2f} s = "
        f"{rate:.1f} channel-s per s in 10 s pushes ({card})")
    summary["channel_s_per_s_3_dials"] = round(rate, 1)

    # a float32 carry takes polyphase.cu's bank route: the first 20 s,
    # centred to float32, equal the uint8 run's first outputs
    f32 = [(ri.astype(np.float32) - 128.0, rq.astype(np.float32) - 128.0)
           for ri, rq in wide[:2]]
    label = f"channelizer, {len(dials)} dials, float32 carry"
    with counted_path(label, counts, shapes_by_path, phase="channelize"):
        fI, fQ = run(ChannelizingStreamingDecimator(offsets, device=dev),
                     f32)
    c, sh = counts[label], shapes_by_path[label]
    n = fI.shape[1]
    scale = float(np.abs(wI[:, :n]).max())
    err = float(max(np.abs(fI - wI[:, :n]).max(),
                    np.abs(fQ - wQ[:, :n]).max()))
    log(f"[channelize] float32 carry, 20 s: {n} samples a dial, max |diff| "
        f"against the uint8 run {err:.3g} (scale {scale:.4g}, tolerance "
        f"{2e-4 * scale:.3g}); launches {c}")
    if (not n or not err <= 2e-4 * scale or c["tc"]
            or c["direct"] != sum(sh.values())):
        fail(f"the float32-carry channelizer: max |diff| {err}, launches "
             f"{c}, calls {sh}")

    # 3. multicli --dial: one rtl_tcp dongle at LF, three dials
    made: list = []
    real = multicli.MultiChannelDaemon, multicli.RtlTcpBank
    multicli.MultiChannelDaemon, multicli.RtlTcpBank = (
        _recording(c, made) for c in real)
    # sample rate, direct sampling, gain mode, gain, frequency
    srv = LoopbackRtlTcp(wide, n_commands=5)
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                counted_path("multicli --dial", counts, shapes_by_path,
                             phase="channelize"):
            t0 = time.perf_counter()
            rc, text = _captured(lambda: multicli.main([
                "--endpoint", f"127.0.0.1:{srv.port}:{WIDE_BANDS[0]}",
                *[a for b in WIDE_BANDS[1:] for a in ("--dial", b)],
                "-n", "1", "--no-align", "-x"]))
            wall = time.perf_counter() - t0
    finally:
        multicli.MultiChannelDaemon, multicli.RtlTcpBank = real
        srv.close()
    daemon = [m for m in made if isinstance(m, real[0])]
    bank = [m for m in made if isinstance(m, banks.RawBank)]
    dropped = bank[0].dropped_bytes if bank else [-1]
    if rc != 0 or len(daemon) != 1 or dropped != [0]:
        fail(f"multicli --dial: rc {rc}, {len(daemon)} daemons, dropped "
             f"bytes {dropped}")
    st, out = daemon[0].stats, daemon[0].result
    if (st.errors or len(out) != 1 or len(out[0]) != len(dials)
            or "3 channel-windows, 3 spot(s), 0 error(s)" not in text):
        fail(f"multicli --dial: {st.errors} errors, {len(out)} batches")
    for ch, spots in enumerate(out[0]):
        hit = [x for x in spots if (x.call, x.loc, x.pwr) == (
            "K1JT", "FN20", "20") and abs(x.freq * 1e6 - dials[ch] - 1530.0)
            < 0.5]
        if len(hit) != 1:
            fail(f"multicli --dial channel {ch} (dial {dials[ch]}): spots "
                 f"{[(x.message, x.freq) for x in spots]}")
    if (0x01, dials[0] + 601_500) not in srv.commands or (
            0x09, 2) not in srv.commands:
        fail(f"multicli --dial tuned {srv.commands}")
    c, sh = counts["multicli --dial"], shapes_by_path["multicli --dial"]
    bank_name = f"stage1 bank of {len(dials)}"
    s1 = sum(k for key, k in sh.items()
             if key[:3] == (bank_name, "uint8", len(dials)))
    s2 = sum(k for key, k in sh.items()
             if key[:3] == ("stage2", "float32", len(dials)))
    if (c["tc"] != s1 or c["direct"] != s2 or not s1 or not s2
            or sum(sh.values()) != s1 + s2 or not c["fano"]):
        fail(f"multicli --dial: front-end calls {sh} do not match launches "
             f"{c}: want one tc launch for all {len(dials)} dials a step, "
             f"stage 2 on direct, the Fano kernel launched")
    log(f"[channelize] multicli --dial: {st.channel_windows} "
        f"channel-windows, {st.spots} spots, 0 errors, 0 dropped bytes, "
        f"{wall:.2f} s wall (the stream is paced at 10x real time), "
        f"{st.ingest_seconds:.2f} s of ingest; spots "
        f"{[(x.message, round(x.freq * 1e6 - d, 3)) for d, ch in zip(dials, out[0]) for x in ch]} "
        f"(Hz above each dial; {card})")
    summary["multicli_dial"] = {
        "dials": dials, "channel_windows": st.channel_windows,
        "spots": st.spots, "errors": st.errors, "wall_s": round(wall, 3),
        "ingest_s": round(st.ingest_seconds, 3),
        "window_decode_s": round(wall - st.ingest_seconds, 3)}
    log(json.dumps({"channelize": summary}))
    return counts, shapes_by_path


def phase_multidevice(dev, card, wi, wq, host_spots, DB: int = 128):
    """decode_channels_multidevice on one and on two shards of the card,
    each equal in every spot field to decode_channels on the same
    windows (one shard: the whole batch, host mode's spots, which
    hybrid's equal; two shards: decode_channels on each half), and the
    two-shard run within float rounding of the whole batch's decode
    (_mismatches); then the pipelined multi-device decode over 4
    batches on two shards, held the same way. Returns the launches of
    each path and the summary."""
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (
        decode_channels,
        decode_channels_multidevice,
        decode_channels_pipelined_multidevice,
    )

    B = wi.shape[0]
    opts = DecoderOptions()
    whole = _fields(host_spots)
    # two shards decode each half as decode_channels does alone: its lane
    # buckets hold one half's candidates, so its sums can round
    # otherwise than the whole batch's
    halves = [ch for s0, s1 in ((0, B // 2), (B // 2, B))
              for ch in decode_channels(wi[s0:s1], wq[s0:s1], opts,
                                        device_batch=DB, device=dev)]
    far = _mismatches(halves, host_spots)
    n_float = sum(_fields([a]) != _fields([b])
                  for a, b in zip(halves, host_spots))
    log(f"[multidevice] decode_channels on each half vs the whole batch: "
        f"{n_float} windows differ in a float field, {len(far)} beyond "
        f"rounding")
    if far:
        fail(f"decode_channels on each half differs from the whole batch "
             f"beyond float rounding in windows {far[:10]}")
    halves = _fields(halves)
    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    summary: dict = {"card": card}
    for devs, want in ((["cuda:0"], whole), (["cuda:0", "cuda:0"], halves)):
        label = f"decode_channels_multidevice x{len(devs)}"
        with counted_path(label, counts, shapes_by_path, phase="multidevice"):
            t0 = time.perf_counter()
            got = decode_channels_multidevice(wi, wq, opts, devices=devs,
                                              device_batch=DB)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        bad = [b for b in range(B) if _fields(got[b:b + 1]) != want[b:b + 1]]
        if bad:
            fail(f"{label}: spots differ from decode_channels in windows "
                 f"{bad[:10]}: {_fields(got[bad[0]:bad[0] + 1])} != "
                 f"{want[bad[0]:bad[0] + 1]}")
        if not counts[label]["fano"]:
            fail(f"{label} launched the Fano kernel no time")
        log(f"[multidevice] {label} on {devs}: {B} windows in {secs:.2f} s "
            f"= {B / secs:.1f} decode windows/s ({card}); every spot field "
            f"equals decode_channels on {'the batch' if len(devs) == 1 else 'each shard'}")
        summary[label] = round(B / secs, 1)

    n_batches = 4
    label = "pipelined multidevice x2"
    with counted_path(label, counts, shapes_by_path, phase="multidevice"):
        t0 = time.perf_counter()
        out = list(decode_channels_pipelined_multidevice(
            [(wi, wq)] * n_batches, opts, depth=2, device_batch=DB,
            devices=["cuda:0", "cuda:0"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if len(out) != n_batches or any(_fields(o) != halves for o in out):
        fail(f"{label}: a batch differs from decode_channels on its shards")
    if not counts[label]["fano"]:
        fail(f"{label} launched the Fano kernel no time")
    rate = n_batches * B / secs
    log(f"[multidevice] decode_channels_pipelined_multidevice depth 2 on 2 "
        f"shards of cuda:0, {n_batches} x {B} windows: {secs:.2f} s = "
        f"{rate:.1f} decode windows/s ({card}); every batch equals "
        f"decode_channels on its shards")
    summary["pipelined_multidevice_x2"] = round(rate, 1)
    summary["transfer"] = phase_transfer(dev, card, wi, wq, counts,
                                         shapes_by_path, DB)
    log(json.dumps({"multidevice": summary}))
    return counts, summary


TRANSFER_N = 128  # windows of the multidevice phase's transfer part
# a spot as _fields gives it, for _mismatches
_Spot = collections.namedtuple(
    "_Spot", "message jitter cycles freq snr dt sync drift")


def phase_transfer(dev, card, wi, wq, counts, shapes_by_path, DB,
                   shard: str = "cuda:0"):
    """The decode entry points' transfer formats on the batch's first
    TRANSFER_N windows (fec 'auto'): decode_channels_pipelined over 2
    batches at int16 and at float32, decode_channels_multidevice on two
    shards of ``shard`` at int16, and decode_channels_pipelined_multidevice
    fed per-shard prepare_windows_device handles (float32 planes already
    on ``shard``, the device-fed front end's layout); each equal in every
    spot field to decode_channels at the same format on the same windows
    (the whole batch, or each half). A handle asked for on another device
    than its planes' must raise. Every decode run is one counted path,
    ``transfer``. Returns the seconds of each run and the windows that
    differ between the formats."""
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (
        decode_channels,
        decode_channels_multidevice,
        decode_channels_pipelined,
        decode_channels_pipelined_multidevice,
        prepare_windows_device,
    )

    N = TRANSFER_N
    H = N // 2
    wi, wq = wi[:N], wq[:N]
    opts = DecoderOptions()
    secs: dict[str, float] = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    whole, halves = {}, {}
    for td in ("int8", "int16", "float32"):
        whole[td] = _fields(timed(f"decode_channels {td}", lambda: (
            decode_channels(wi, wq, opts, device_batch=DB,
                            transfer_dtype=td, device=dev))))
    for td in ("int16", "float32"):
        halves[td] = _fields([
            ch for s0, s1 in ((0, H), (H, N))
            for ch in decode_channels(wi[s0:s1], wq[s0:s1], opts,
                                      device_batch=DB, transfer_dtype=td,
                                      device=dev)])
    pairs = (("int8", "int16"), ("int8", "float32"), ("int16", "float32"))
    differ = {f"{a}/{b}": sum(x != y for x, y in zip(whole[a], whole[b]))
              for a, b in pairs}
    beyond = {f"{a}/{b}": len(_mismatches(*(
        [[_Spot(*f) for f in ch] for ch in whole[t]] for t in (a, b))))
        for a, b in pairs}
    messages = {f"{a}/{b}": sum({x[0] for x in p} != {y[0] for y in q}
                                for p, q in zip(whole[a], whole[b]))
                for a, b in pairs}
    log(f"[transfer] windows of {N} whose spots differ between transfer "
        f"formats in any field: {differ}; beyond float rounding "
        f"(_mismatches): {beyond}; in the set of decoded messages: "
        f"{messages}")

    def handles():
        return [prepare_windows_device(
            torch.from_numpy(wi[s0:s1]).to(shard),
            torch.from_numpy(wq[s0:s1]).to(shard),
            device_batch=s1 - s0, device=shard)
            for s0, s1 in ((0, H), (H, N))]

    def check(label, got, want):
        bad = [b for b in range(N) if got[b:b + 1] != want[b:b + 1]]
        if len(got) != N or bad:
            fail(f"[transfer] {label}: spots differ from decode_channels at "
                 f"the same format in windows {bad[:10]} (of {len(got)})")

    label = "transfer"
    with counted_path(label, counts, shapes_by_path, phase="multidevice"):
        for td in ("int16", "float32"):
            out = timed(f"pipelined {td}", lambda: list(
                decode_channels_pipelined(
                    [(wi, wq)] * 2, opts, device_batch=DB,
                    transfer_dtype=td, device=dev)))
            if len(out) != 2:
                fail(f"[transfer] pipelined {td}: {len(out)} batches of 2")
            for k, o in enumerate(out):
                check(f"decode_channels_pipelined {td}, batch {k}",
                      _fields(o), whole[td])
        got = timed("multidevice x2 int16", lambda: (
            decode_channels_multidevice(wi, wq, opts,
                                        devices=[shard, shard],
                                        device_batch=DB,
                                        transfer_dtype="int16")))
        check("decode_channels_multidevice x2 int16", _fields(got),
              halves["int16"])
        fed = [handles(), handles()]
        out = timed("pipelined multidevice, shard handles", lambda: list(
            decode_channels_pipelined_multidevice(iter(fed), opts)))
        if len(out) != 2:
            fail(f"[transfer] shard handles: {len(out)} batches of 2")
        for k, o in enumerate(out):
            check(f"pipelined multidevice, shard handles, batch {k}",
                  _fields(o), halves["float32"])
    if not counts[label]["fano"]:
        fail("[transfer] the decodes launched the Fano kernel no time")
    planes = torch.zeros((1, wi.shape[1]), dtype=torch.float32, device=dev)
    try:
        prepare_windows_device(planes, planes, device="cpu")
    except ValueError as exc:
        log(f"[transfer] prepare_windows_device(<{dev} planes>, "
            f"device='cpu') raised: {exc}")
    else:
        fail("[transfer] prepare_windows_device(device='cpu') took planes "
             "that lie on the card")
    log(f"[transfer] seconds of each run on {N} windows ({card}): {secs}; "
        f"every decode's spots equal decode_channels at its format")
    return {"windows": N, "differ": differ, "differ_beyond_rounding": beyond,
            "differ_in_messages": messages, "seconds": secs}


E2E_DC = 128        # channels of the e2e_device phase (the batch's first)
E2E_NMID = 120_000  # stage-1 frames a fused front-end step (30 a window)
E2E_DWIN = 2        # timed windows


def phase_e2e_device(dev, name, card, wi, wq, calls):
    """The device-resident ingest -> spots chain (tools/torch_e2e_sweep.py)
    on the batch's first E2E_DC windows, one counted path: one checked
    round (its spots equal in every field to decode_channels on a host
    copy of the same planes at float32, every +3 dB content message
    found), then measure_e2e_device over E2E_DWIN timed windows. Returns
    the path's launches, the kernel rows of its polyphase shapes and the
    summary."""
    import torch_e2e_sweep as e2e

    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import decode_channels

    opts = DecoderOptions()
    DC = E2E_DC
    cont_i = torch.from_numpy(wi[:DC]).to(dev)
    cont_q = torch.from_numpy(wq[:DC]).to(dev)
    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    label = "e2e_device"
    t0 = time.perf_counter()
    with counted_path(label, counts, shapes_by_path, phase=label):
        (handle,) = e2e.device_windows(cont_i, cont_q, 1, 0, E2E_NMID, [dev])
        host = [a.cpu().numpy().copy() for a in handle.arrays]
        got = _fields(decode_channels(None, None, opts, windows=handle))
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        per_card, secs, steps, n_dev = e2e.measure_e2e_device(
            wi, wq, opts, DC=DC, DWIN=E2E_DWIN, N_MID=E2E_NMID, device=dev)
    want = _fields(decode_channels(*host, opts, device_batch=DC,
                                   transfer_dtype="float32", device=dev))
    bad = [b for b in range(DC) if got[b] != want[b]]
    if bad:
        fail(f"[e2e_device] the chain's spots differ from decode_channels "
             f"on a host copy of its planes in windows {bad[:10]}: "
             f"{got[bad[0]]} != {want[bad[0]]}")
    strong = {b: calls[b % 4] for b in range(DC) if b % 4 != 3 and b % 3 == 0}
    missed = [b for b, msg in strong.items()
              if all(x[0] != msg for x in got[b])]
    if missed:
        fail(f"[e2e_device] +3 dB content messages not found in windows "
             f"{missed[:10]}")
    c = counts[label]
    if not (c["tc"] and c["direct"] and c["fano"]):
        fail(f"[e2e_device] a kernel of the chain was not launched: {c}")
    log(f"[e2e_device] checked round: {DC} windows from {E2E_NMID}-frame "
        f"steps in {round_s:.2f} s, spots equal in every field to "
        f"decode_channels on a host copy at float32, {len(strong)} +3 dB "
        f"messages found, {sum(len(ch) for ch in got)} spots ({card})")
    log(f"[e2e_device] measure_e2e_device DC={DC} DWIN={E2E_DWIN}: "
        f"{per_card:.1f} realtime channels per card, {secs / E2E_DWIN:.4f} "
        f"s a window, {steps} steps a window, {n_dev} card ({card})")
    rows = phase_kernel(dev, name, shapes_by_path, extras=False)
    summary = {"realtime_channels_per_card": per_card,
               "s_per_window": secs / E2E_DWIN, "steps_per_window": steps,
               "checked_round_s": round_s, "card": card}
    log(json.dumps({"e2e_device": summary}))
    return counts, rows, summary


def _routes_match(launches: dict, shapes: dict) -> bool:
    """Every noted front-end call launched its kernel: uint8 stage 1 on
    polyphase_tc, float32 stage 1 and stage 2 on polyphase.cu."""
    tc = sum(k for key, k in shapes.items()
             if key[0].startswith("stage1") and key[1] == "uint8")
    return (launches["tc"] == tc
            and launches["direct"] == sum(shapes.values()) - tc)


def phase_entry(dev, card):
    """entry() (rtlsdr_wsprd_tpu_torch/entry.py), one counted path: its
    forward on its example arguments; every ChannelDecode field of the
    JAX contract's shape, both windows decoding K1JT FN20 37 and no
    other message. Returns the path's launches."""
    from rtlsdr_wsprd_tpu_torch.config import MAX_CANDIDATES
    from rtlsdr_wsprd_tpu_torch.entry import B_EXAMPLE, MAX_ATTEMPTS, entry
    from rtlsdr_wsprd_tpu_torch.utils.codec import unpack_message
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable

    counts: dict[str, dict] = {}
    t0 = time.perf_counter()
    with counted_path("entry", counts, {}, phase="entry"):
        fn, args = entry()
        out = fn(*args)
    secs = time.perf_counter() - t0
    B, C, K = B_EXAMPLE, MAX_CANDIDATES, MAX_ATTEMPTS
    want = dict(snr=(B, C), valid=(B, C), freq=(B, C), shift=(B, C),
                sync=(B, C), drift=(B, C), sel_cand=(B, K), sel_jit=(B, K),
                sel_valid=(B, K), success=(B, K), data=(B, K, 11),
                cycles=(B, K), deint=(B, K, 162), n_gate=(B,))
    got = {k: tuple(v.shape) for k, v in out._asdict().items()}
    if got != want or any(a.device != dev for a in (*args, *out)):
        fail(f"[entry] forward output {got} on "
             f"{sorted({str(v.device) for v in out})}, want {want} on {dev}")
    ht = WsprHashTable()
    msgs = []
    for data, ok in zip(out.data.cpu().numpy(), out.success.cpu().numpy()):
        decoded = [unpack_message(bytes(d), ht) for d in data[ok]]
        msgs.append(sorted({m.call_loc_pow if m else "(no message)"
                            for m in decoded}))
    if msgs != [["K1JT FN20 37"]] * B:
        fail(f"[entry] the example windows decoded {msgs}")
    if not counts["entry"]["fano"]:
        fail(f"[entry] the Fano kernel was not launched: {counts['entry']}")
    log(f"[entry] entry() forward on {dev}: {B} windows, {K} attempts a "
        f"window, {int(out.success.sum())} successful attempts, each "
        f"window K1JT FN20 37, {secs:.2f} s with the example batch "
        f"({card})")
    return counts


def _bench_py_keys() -> set[str]:
    """The keys of bench.py's JSON line, read from its source (no import:
    bench.py belongs to the JAX package's side)."""
    import ast

    with open(os.path.join(HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    fail("bench.py has no json.dumps({...}) line")


def phase_bench(dev, name, card, wi, wq, host_spots: int, rows: list):
    """tools/torch_bench.py's bench() on the decode phase's batch, 3
    headline runs, one counted path; then each polyphase kernel against
    the plain version at every shape of the path that ``rows`` (the
    kernel rows so far) lacks. Returns the path's launches and the new
    kernel rows."""
    import torch_bench

    from rtlsdr_wsprd_tpu_torch.frontend.filters import R1, STAGE1_TAPS

    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    t0 = time.perf_counter()
    with counted_path("bench", counts, shapes_by_path, phase="bench"):
        line = torch_bench.bench(dev, runs=3, batch=(wi, wq))
    secs = time.perf_counter() - t0
    log(f"[bench] {secs:.1f} s: {json.dumps(line)}")
    keys = _bench_py_keys() | {"card"}
    if set(line) != keys:
        fail(f"[bench] keys {sorted(set(line) ^ keys)} differ from "
             "bench.py's line and card")
    if line["spots_per_batch"] != host_spots:
        fail(f"[bench] spots_per_batch {line['spots_per_batch']} != the host "
             f"decode's {host_spots} on the same windows")
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        fail(f"[bench] headline {line['value']}")
    shapes = shapes_by_path["bench"]
    n = torch_bench.FE_FRAMES
    fe_key = ("stage1", "float32", 128, n * R1 + STAGE1_TAPS - R1, n)
    c = counts["bench"]
    if (shapes.get(fe_key) != torch_bench.FE_ITERS + 1
            or not _routes_match(c, shapes) or not c["fano"]):
        fail(f"[bench] launches {c} against the front-end calls {shapes}: "
             f"want {torch_bench.FE_ITERS + 1} float32 stage-1 calls "
             f"{fe_key} on polyphase.cu, every call on its kernel, the "
             "Fano kernel launched")
    seen = {(r["stage"], r["dtype"], r["C"], r["L"], r["frames"])
            for r in rows}
    new = {k: v for k, v in shapes.items() if k not in seen}
    log(f"[bench] launches {c}; float32 stage 1 C=128 x {n} frames: "
        f"{shapes.get(fe_key)} calls on polyphase.cu ({card})")
    return counts, phase_kernel(dev, name, {"bench": new}, extras=False)


# the rank processes of the 2-rank multicli run: multicli.main as a user
# starts it, its front-end calls noted by shape, then the process's
# kernel launches and those shapes as one line each
RANK_MAIN = (
    "import json, sys\n"
    "import chip_smoke\n"
    "from rtlsdr_wsprd_tpu_torch import multicli\n"
    "from rtlsdr_wsprd_tpu_torch.parallel.dryrun import launch_counts\n"
    "with chip_smoke.noted_calls() as shapes:\n"
    "    rc = multicli.main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps(launch_counts()), flush=True)\n"
    "print('SHAPES ' + json.dumps(sorted(shapes.items())), flush=True)\n"
    "sys.exit(rc)\n")


def phase_distributed(card, chunks):
    """The multi-host runtime on one card: dryrun_multichip(2, cuda:0),
    then two multicli rank processes (one gloo job, both ranks on
    cuda:0) over two loopback rtl_tcp servers (20 m and 40 m dials,
    the 120 s capture). Returns the launches of each path (each rank's
    summed), the front end's calls by shape of each path (each rank's
    own, summed) and the summary."""
    import socket

    from rtlsdr_wsprd_tpu_torch.config import BAND_TABLE
    from rtlsdr_wsprd_tpu_torch.parallel.dryrun import dryrun_multichip

    counts: dict[str, dict] = {}
    shapes_by_path: dict[str, dict] = {}
    summary: dict = {"card": card}
    t0 = time.perf_counter()
    ranks = dryrun_multichip(2, "cuda:0")
    secs = time.perf_counter() - t0
    launches = [r["launches"] for r in ranks]
    log(f"[distributed] dryrun_multichip(2, cuda:0): every check passed in "
        f"{secs:.2f} s (2 process starts included); launches by rank "
        f"{launches}; sharded polyphase calls by rank "
        f"{[r['calls'] for r in ranks]}; windows each dense run (quick, "
        f"full schedule) decoded by rank "
        f"{[r['dense_windows_decoded'] for r in ranks]}")
    if any(r["dense_windows_decoded"] != [2, 2] for r in ranks):
        fail("a dry-run rank's dense steps did not decode both its windows")
    by = shapes_by_path["dryrun_multichip"] = {}
    for r in ranks:
        for key, n in r["calls"].items():
            by[key] = by.get(key, 0) + n
    counts["dryrun_multichip"] = {k: sum(r[k] for r in launches)
                                  for k in launches[0]}
    # every float32 call of a sharded decimation goes to polyphase.cu:
    # each rank's launches are its noted calls, one a stage, no more
    if (any(not r["fano"] or r["tc"] for r in launches)
            or any(sorted(k[0] for k in r["calls"]) != ["stage1", "stage2"]
                   or sum(r["calls"].values()) != r["launches"]["direct"]
                   for r in ranks)):
        fail(f"a dry-run rank's launches {launches} do not match its "
             f"sharded calls {[r['calls'] for r in ranks]} (want one "
             "polyphase.cu launch a stage, none on the tensor-core kernel, "
             "and the Fano kernel launched)")
    summary["dryrun_s"] = round(secs, 3)

    bands = ("20m", "40m")
    dials = [BAND_TABLE[b][0] for b in bands]
    # sample rate, gain mode, gain, frequency
    srvs = [LoopbackRtlTcp(chunks, n_commands=4) for _ in bands]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    eps = [a for srv, b in zip(srvs, bands)
           for a in ("--endpoint", f"127.0.0.1:{srv.port}:{b}")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, *eps, "--coordinator",
         f"127.0.0.1:{port}", "--nprocs", "2", "--rank", str(k),
         "--devices", "all", "-n", "1", "--no-align", "-x"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for srv in srvs:
            srv.close()
    wall = time.perf_counter() - t0
    launches = []
    for k, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.strip():
                log(f"[distributed] rank {k} > {line}")
        spots = _spot_lines(text)
        lines = [x for x in text.splitlines() if x.startswith("LAUNCHES ")]
        if (p.returncode != 0 or not lines
                or f"Distributed: rank {k}/2 serving channels [{k}, {k + 1}) "
                "on 1 local device(s), 2 global." not in text
                or f"[rank {k}] Processed 1 window batch(es), 1 "
                "channel-windows, 1 spot(s), 0 error(s)." not in text
                or "WARNING" in text or len(spots) != 1
                or not spots[0].endswith("   K1JT   FN20 20")
                or f" {(dials[k] + 1530) / 1e6:10.6f} " not in spots[0]):
            fail(f"multicli rank {k}: rc {p.returncode}")
        launches.append(json.loads(lines[-1].split(" ", 1)[1]))
        shapes = [x for x in text.splitlines() if x.startswith("SHAPES ")]
        for key, n in json.loads(shapes[-1].split(" ", 1)[1]):
            by = shapes_by_path.setdefault("multicli 2 ranks", {})
            by[tuple(key)] = by.get(tuple(key), 0) + n
    if any(not r["tc"] or not r["direct"] or not r["fano"]
           for r in launches):
        fail(f"a multicli rank did not launch all three kernels: {launches}")
    counts["multicli 2 ranks"] = {k: sum(r[k] for r in launches)
                                  for k in launches[0]}
    log(f"[distributed] multicli, 2 ranks on cuda:0: 1 channel-window and "
        f"1 K1JT spot at its own dial each, 0 errors, {wall:.2f} s wall "
        f"(the streams are paced at 10x real time); launches by rank "
        f"{launches} ({card})")
    summary["multicli_2_ranks_wall_s"] = round(wall, 3)
    log(json.dumps({"distributed": summary}))
    return counts, shapes_by_path


def phase_scaling(dev, card):
    """tools/torch_scaling.py's mesh mode in this process and its dist
    mode (4 processes on the card), one counted path: the processes'
    own launches added to this one's. Returns the path's launches."""
    import torch_scaling

    counts: dict[str, dict] = {}
    t0 = time.perf_counter()
    with counted_path("scaling", counts, {}, phase="scaling"):
        mesh = torch_scaling.mesh_mode(dev)
    t_mesh = time.perf_counter() - t0
    if not counts["scaling"]["fano"]:
        fail(f"[scaling] the mesh mode's dense steps launched no Fano "
             f"kernel: {counts['scaling']}")
    log(f"[scaling] mesh, {t_mesh:.1f} s: sharded output equal to the "
        f"unsharded one in every ChannelDecode field, every window decoded;"
        f" {json.dumps(mesh)} ({card})")
    t0 = time.perf_counter()
    out, procs = torch_scaling.dist_mode(dev, timeout_s=400)
    for proc in procs:
        for k, v in proc["launches"].items():
            counts["scaling"][k] += v
    log(f"[scaling] dist, {time.perf_counter() - t0:.1f} s (4 process "
        f"starts): every window spotted in every process; launches and "
        f"runs a timed sample by process {procs}; {json.dumps(out)} "
        f"({card})")
    return counts


# (SNR dB, trials, least found at every format): above the floor the
# JAX package's records are 100/100; at the floor its 274/300, 138/300
# and 20/300 less 2 binomial sigma at n = 100
QUALITY_SWEEP = ((-24, 50, 49), (-28, 50, 47), (-29, 100, 86),
                 (-30, 100, 36), (-31, 100, 2))
QUALITY_FORMATS = ("int8", "int16", "float32")
QUALITY_HOST_DB = -30  # the point also decoded with fec="host"
# drift x DT at -27 dB: (trials a cell, least found; JAX: 47-50/50)
QUALITY_MATRIX = (10, 8)
# crowded band: (windows, least precision and recall; JAX: 0.7385/0.7356
# on 100 windows, less 2 sigma at ~300 messages)
QUALITY_CROWDED = (40, 0.68)
QUALITY_PAIRS = 8  # hash census pairs (JAX: every type-3 resolved)


def phase_quality(card):
    """The decode-quality studies at reduced sizes (see the module
    docstring), each through its tool's builder and decode function on
    the card (device=None), then the handles that device=None makes.
    Returns the studies' launches by kernel, as counted_path notes them."""
    import torch_crowded_band as crowded
    import torch_hash_census as census
    import torch_sensitivity_matrix as matrix
    import torch_snr_sweep as sweep

    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel.mesh import make_mesh
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import prepare_windows
    from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon

    t_phase = time.perf_counter()
    summary: dict = {"card": card}
    counts: dict[str, dict] = {}
    with counted_path("quality", counts, {}, phase="quality"):
        t0 = time.perf_counter()
        trials, floor = QUALITY_SWEEP[0][1], QUALITY_SWEEP[-1][1]
        points = []
        for (snr, wi, wq), (_, T, least) in zip(
                sweep.build_windows(trials, floor,
                                    [p[0] for p in QUALITY_SWEEP]),
                QUALITY_SWEEP):
            if wi.shape[0] != T:
                fail(f"[quality] sweep point {snr} dB: {wi.shape[0]} "
                     f"windows, want {T}")
            r = sweep.sweep_point(snr, wi, wq, QUALITY_FORMATS)
            secs = {f: round(x, 3) for f, x in r["seconds"].items()}
            log(f"[quality] sweep {snr} dB: found {r['found']} of {T} "
                f"(least {least}); seconds {secs} ({card}); between "
                f"formats {r['between_formats']}; messages other than "
                f"{sweep.MSG!r}: {r['other_messages']}")
            low = {f: n for f, n in r["found"].items() if n < least}
            if low:
                fail(f"[quality] sweep {snr} dB: found {low} of {T}, "
                     f"fewer than {least}")
            if snr == QUALITY_HOST_DB:
                # hybrid spots equal host spots, so the floor's count
                # does not depend on the FEC mode fec="auto" picked
                n_host = int(sweep.found(
                    sweep.decode(wi, wq, "int8", fec="host")).sum())
                log(f"[quality] sweep {snr} dB, int8: found {n_host} with "
                    f"fec='host', {r['found']['int8']} with fec='auto'")
                if n_host != r["found"]["int8"]:
                    fail(f"[quality] sweep {snr} dB: fec='host' finds "
                         f"{n_host}, fec='auto' {r['found']['int8']}")
                r["found_int8_fec_host"] = n_host
            points.append(r)
        summary["sweep"] = points
        summary["sweep_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cells = []
        T, least = QUALITY_MATRIX
        for drift, dt0, wi, wq in matrix.build_cells(T, -27.0):
            n = int(matrix.decode_cell(wi, wq).sum())
            cells.append({"drift": drift, "t0": dt0, "found": n})
            if n < least:
                fail(f"[quality] matrix drift {drift} Hz, t0 {dt0} s: "
                     f"{n}/{T} found, fewer than {least}")
        log(f"[quality] drift x DT at -27 dB, int8, {T} trials a cell: "
            f"{[c['found'] for c in cells]} (drift rows "
            f"{matrix.DRIFTS}, t0 columns {matrix.DTS}); every cell >= "
            f"{least} ({time.perf_counter() - t0:.1f} s)")
        summary["matrix"] = cells
        summary["matrix_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_win, least = QUALITY_CROWDED
        wi, wq, truth = crowded.build_windows(n_win, 12)
        by_cfg = crowded.decode(wi, wq, crowded.parse_configs("2,3"))
        summary["crowded"] = {}
        for cfg, ours in by_cfg.items():
            tp, fp, fn, prec, rec = crowded.prf(ours, truth)
            log(f"[quality] crowded band, {n_win} windows, "
                f"{sum(map(len, truth))} true messages, npasses={cfg[0]}: "
                f"tp={tp} fp={fp} fn={fn} precision={prec:.4f} "
                f"recall={rec:.4f}")
            if min(prec, rec) < least:
                fail(f"[quality] crowded band npasses={cfg[0]}: precision "
                     f"{prec:.4f}, recall {rec:.4f}, below {least}")
            summary["crowded"][f"npasses={cfg[0]}"] = [prec, rec]
        same = sum(a == b for a, b in zip(*by_cfg.values()))
        log(f"[quality] crowded band: npasses=3 decodes the npasses=2 "
            f"message set in {same}/{n_win} windows "
            f"({time.perf_counter() - t0:.1f} s)")
        summary["crowded"]["npasses3_equal_windows"] = same
        summary["crowded_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        batches, expect = census.build_stream(QUALITY_PAIRS)
        summary["census"] = []
        for strict in (False, True):
            r = census.run(batches, expect, strict)
            log(f"[quality] hash census, {QUALITY_PAIRS} pairs: "
                f"{json.dumps(r)}")
            if (r["type3_resolved_gap1"] + r["type3_resolved_gap2"]
                    != QUALITY_PAIRS
                    or r["type3_hashed_gap1"] or r["type3_hashed_gap2"]
                    or r["type3_undecoded"]):
                fail(f"[quality] hash census {r['mode']}: not every type-3 "
                     f"spot resolved: {r}")
            summary["census"].append(r)
        summary["census_s"] = time.perf_counter() - t0
    if not counts["quality"]["fano"]:
        fail("[quality] the studies launched the Fano kernel no time")

    card0 = torch.device("cuda", 0)
    handle = prepare_windows(wi[:1], wq[:1], 1, device=None)
    named = {"prepare_windows": handle.device,
             "make_mesh": make_mesh(["cuda"]).devices,
             "MultiChannelDaemon": MultiChannelDaemon(
                 type("Bank", (), {"n_channels": 1})(), DecoderOptions(),
                 device=None).devices}
    log(f"[quality] device=None names: {named}")
    if named != {"prepare_windows": card0, "make_mesh": (card0,),
                 "MultiChannelDaemon": [card0]}:
        fail(f"[quality] device=None does not name cuda:0: {named}")
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[quality] phase {summary['seconds']:.1f} s ({card})")
    log(json.dumps({"quality": summary}))
    return counts


def counting_calibrations() -> list:
    """Wrap ops/calibrate.py's measurement so that each one is noted
    (the device it was asked for); returns the list it fills."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate

    real = calibrate._calibrate
    measured = []

    def counting(device):
        measured.append(str(device))
        return real(device)

    calibrate._calibrate = counting
    return measured


def main() -> None:
    t_start = time.perf_counter()
    dev, name, card = phase_env()
    measured = counting_calibrations()
    phase_build()
    chunks = synth_capture()
    launches, shapes, refI, refQ = phase_frontend(dev, chunks)
    launches1, shapes1 = phase_single(dev, chunks, refI, refQ)
    rows = phase_kernel(dev, name, {"batched": shapes, "single": shapes1})
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions

    t0 = time.perf_counter()
    wi, wq, calls = make_batch(512, seed=11)
    log(f"[decode] made 512 windows in {time.perf_counter() - t0:.1f} s")
    fano_rows, cal = phase_fano(dev, name, card, wi, wq, DecoderOptions(),
                                128)
    dec = phase_decode(dev, card, wi, wq, calls, cal)
    dense_rows, dense_counts, dec["dense_B64"] = phase_dense(
        dev, name, card, wi, wq, calls, dec["host_spots"], cal)
    host_spot_count = sum(len(ch) for ch in dec["host_spots"])
    md_counts, _ = phase_multidevice(dev, card, wi, wq, dec.pop("host_spots"))
    e2e_counts, e2e_rows, _ = phase_e2e_device(dev, name, card, wi, wq, calls)
    rows += e2e_rows
    entry_counts = phase_entry(dev, card)
    bench_counts, bench_rows = phase_bench(
        dev, name, card, wi, wq, host_spot_count, rows)
    rows += bench_rows
    del wi, wq
    daemon_counts, daemon_shapes = phase_daemon(dev, card, chunks, refI,
                                                 refQ)
    chan_counts, chan_shapes = phase_channelize(dev, card, chunks)
    dist_counts, dist_shapes = phase_distributed(card, chunks)
    del chunks
    scaling_counts = phase_scaling(dev, card)
    rows += phase_kernel(dev, name, {
        p: s for p, s in {**daemon_shapes, **chan_shapes,
                          **dist_shapes}.items() if s}, extras=False)
    quality_counts = phase_quality(card)
    # every path counted from 0 after the front-end phases, by kernel
    paths = {**daemon_counts, **chan_counts, **md_counts, **e2e_counts,
             **dist_counts, **entry_counts, **bench_counts,
             **scaling_counts}
    # cuda, cuda:0 and None (describe, the CLIs) name one card: one
    # measurement in the whole run
    log(f"[decode] FEC calibrations measured in this run: {measured}")
    if len(measured) != 1:
        fail(f"the FEC calibration was measured {len(measured)} times: "
             f"{measured}")
    kernels = []
    for kname, route, src in (
            ("polyphase_tc", "tc", "polyphase_tc.cu"),
            ("polyphase_decimate", "direct", "polyphase.cu")):
        mine = [r for r in rows if r["route"] == route]
        # headline: the shape the batched front end launched this kernel
        # with most (the 10 s push for tc, its stage-2 call for direct)
        main_row = max((r for r in mine if r["path"] == "batched"),
                       key=lambda r: (r["launches"], r["frames"]))
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"rtlsdr_wsprd_tpu_torch/frontend/csrc/{src}",
            "replaces": "rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:78",
            "launches": (launches[route] + launches1[route]
                         + sum(c[route] for c in paths.values())),
            "launches_by_path": {"batched": launches[route],
                                 "single": launches1[route],
                                 **{p: c[route] for p, c in paths.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shapes": mine,
        })
    # headline: the decode's heaviest device call (its first where that
    # is the heaviest) at the calibrated budget; the plain version's
    # time is the budget-16 run's on the same lanes
    main_input = "decode attempts, heaviest call"
    if all(r["input"] != main_input for r in fano_rows):
        main_input = "decode attempts"
    fano_main = next(r for r in fano_rows if r["input"] == main_input
                     and r["calibrated"])
    fano_paths = {**dense_counts, **paths, **quality_counts}
    kernels.append({
        "name": "batched_fano",
        "route": "cuda",
        "source": "rtlsdr_wsprd_tpu_torch/ops/csrc/fano.cu",
        "replaces": "rtlsdr_wsprd_tpu/ops/fano.py:91",
        "launches": (dec["hybrid_launches"]
                     + sum(c["fano"] for c in fano_paths.values())),
        "launches_by_path": {"decode (4 hybrid runs)": dec["hybrid_launches"],
                             **{p: c["fano"] for p, c in fano_paths.items()}},
        "mismatches": 0,
        "max_abs_err": 0,
        "ms": fano_main["ms"],
        "maxcycles": fano_main["maxcycles"],
        "input": main_input,
        "plain_ms": next(r["plain_ms"] for r in fano_rows
                         if r["input"] == main_input
                         and r["maxcycles"] == 16),
        "bound_ms": fano_main["bound_ms"],
        "bound_by": fano_main["bound_by"],
        "host_ms": fano_main["host_ms"],
        "library_ms": None,
        "runs": fano_rows + dense_rows,
    })
    log(json.dumps({"decode_windows_per_s": {
        k: round(v, 1) for k, v in dec.items() if k != "hybrid_launches"},
        "card": card}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

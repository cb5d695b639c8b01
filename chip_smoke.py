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
5. fano     the FEC calibration (ops/calibrate.py), then the Fano
            kernel on two 512-lane inputs: a synthetic mix (clean
            encoded messages, noisy copies at sigma 20-80, random
            symbols, 16 padding lanes), the attempts the B=512 hybrid
            decode hands to its first device Fano call and, where
            another is heavier, its heaviest call (caught by wrapping
            _fano_batch_packed here). Kernel against the plain
            version on the card at budgets 16 and 64 (every field and
            the step counts) and against native.fano_decode at 256 and
            10000: zero mismatches. Device times at 16, 64, 256 and the
            calibrated budget, the plain version's time at 16, the host
            time of native.fano_decode_many on the same lanes, the bound
            and the slowest lane's step count.
6. decode   512 mixed windows through decode_channels (full jitter
            schedule, 2 passes, device_batch=128): the calibration and
            its describe() line; fec="host", then fec="hybrid" (the
            Fano kernel's launches counted from 0 around these runs, its
            main path), each one warm-up and three timed runs with
            decode windows/s, every expected message found and no spot
            on a noise window, the hybrid spot lists equal to host's in
            message, jitter, cycles, freq, snr, dt and sync; then
            decode_channels_pipelined (depth 2) over 4 batches of those
            windows, each equal to the host result, with windows/s;
            then one run in the mode fec="auto" picks under
            torch.profiler (host time per labelled range, the card's
            kernel time and busy share).

Then a JSON line per kernel, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
non-zero without one. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks by card name (NVIDIA data sheets, dense, no sparsity):
# float32 outside the tensor cores, TF32 on the tensor cores, and
# device-memory bandwidth. The int32 operation rate is a quarter of the
# float32 rate: an SM has half as many INT32 lanes as FP32 lanes, and
# the float32 peak counts an FMA as two operations.
PEAKS = (
    ("H100 PCIe", 51e12, 378e12, 2.0e12),
    ("H100 NVL", 60e12, 378e12, 3.9e12),
    ("H100", 67e12, 495e12, 3.35e12),   # SXM5
    ("H200", 67e12, 495e12, 4.8e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[float, float, float]:
    for key, flops, tf32, bw in PEAKS:
        if key in name:
            return flops, tf32, bw
    fail(f"no published peaks for card {name!r}")


def _spin_cycles_per_ms() -> float:
    """Clock cycles per ms of torch.cuda._sleep on this card."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / a.elapsed_time(b)


def int32_rate(name: str) -> float:
    return card_peaks(name)[0] / 4


def cuda_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median over ``reps`` of one call's device time between CUDA events.

    Before each timed call the card spins (torch.cuda._sleep) for longer
    than the host takes to enqueue the call, so event ``a`` is reached
    only after the whole call is queued: the interval holds the call's
    device work, not the host's argument checks, allocation and launch."""
    host = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin_ms = max(1.0, 4e3 * max(host[1:] or host))
    cycles = int(spin_ms * _spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_batch(B: int, seed: int = 11):
    """B windows with mixed content: most hold 2 signals at varied SNR,
    every fourth is noise only (the port's copy of bench.py's batch)."""
    from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr

    calls = ["K1JT FN20 37", "K9AN EN50 33", "G4ABC IO91 30",
             "VK2XYZ QF56 27"]
    wi = np.zeros((B, 45000), dtype=np.float32)
    wq = np.zeros((B, 45000), dtype=np.float32)
    for b in range(B):
        if b % 4 == 3:
            rng = np.random.default_rng(seed + b)
            z = rng.normal(0, 1.0, (45000, 2)).astype(np.float32)
            i, q = z[:, 0], z[:, 1]
        else:
            msgs = [calls[b % len(calls)], calls[(b + 1) % len(calls)]]
            i, q = synth_window_at_snr(
                msgs, snr_db=[3.0 - (b % 3) * 4.0, -8.0],
                f0=[-60.0 + 13.0 * (b % 9), 45.0 - 11.0 * (b % 7)],
                t0=[2.0, 1.0], seed=seed + b,
            )
        wi[b], wq[b] = normalize_minus3db(i, q)
    return wi, wq, calls


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
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


def phase_kernel(dev, name, paths):
    """Each kernel vs plain at every shape of ``paths`` (path name ->
    launches by shape, from phase_frontend and phase_single) and at the
    extra calls the module docstring lists; returns one row per shape."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import STAGE1, STAGE2
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
        _route,
        polyphase_decimate,
        polyphase_plain,
    )

    peak_flops, peak_tf32, peak_bw = card_peaks(name)
    rng = np.random.default_rng(1)
    rows = []
    filters = {"stage1": STAGE1, "stage2": STAGE2}

    def s1(n):
        return n * STAGE1.R + STAGE1.T - STAGE1.R

    def s2(n):
        return n * STAGE2.R + STAGE2.T - STAGE2.R

    # path, stage, input dtype, C, L, frames, launches on that path, offset
    cases = []
    for path, shapes in paths.items():
        cases += sorted(((path, st, dt, C, L, n, k, 0) for (st, dt, C, L, n), k
                         in shapes.items()), key=lambda c: (c[1], -c[5]))
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
        route = _route("cuda", getattr(torch, dt), filt)
        # real taps (stage 2) need 2 FMA per tap and frame, complex 4
        flop_tap = 8 if np.any(filt.gi) else 4
        label = (f"{stage} {dt} C={C} x {n} frames, L={L}"
                 f"{f', rows at a {offset}-element offset' if offset else ''}"
                 f" ({launched} launches on the {path} path)")
        hI, hQ = _planes(rng, dt, C, L, offset)
        xI = torch.from_numpy(hI).to(dev)[:, offset:]
        xQ = torch.from_numpy(hQ).to(dev)[:, offset:]
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

        # yardstick: one conv1d over the centred float planes, weight
        # (2, 2, T) = [[gr, -gi], [gi, gr]], stride R
        g = torch.from_numpy(np.stack([
            np.stack([filt.gr, -filt.gi]), np.stack([filt.gi, filt.gr])
        ])).to(dev)
        xf = torch.stack([xI, xQ], dim=1).to(torch.float32)
        if dt == "uint8":
            xf -= 128.0
        lib = torch.nn.functional.conv1d(xf, g, stride=filt.R)[..., :n]
        lib_err = max(float((lib[:, 0] - pI).abs().max()),
                      float((lib[:, 1] - pQ).abs().max()))

        ms = cuda_ms(lambda: polyphase_decimate(xI, xQ, filt, n))
        plain_ms = cuda_ms(lambda: polyphase_plain(xI, xQ, filt, n))
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv1d(
            xf, g, stride=filt.R))
        nbytes = 2 * C * L * hI.itemsize + 2 * C * n * 4
        flops = flop_tap * filt.T * C * n
        bytes_ms = nbytes / peak_bw * 1e3
        fp32_core_ms = flops / peak_flops * 1e3
        # the tensor-core kernel does its work as two TF32 products
        t_ops = 2 * flops / peak_tf32 * 1e3 if route == "tc" else fp32_core_ms
        row = dict(shape=label, path=path, route=route, stage=stage,
                   dtype=dt, C=C,
                   L=L, frames=n, row_offset=offset, launches=launched,
                   max_abs_err=err, atol=atol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_max_abs_err=lib_err,
                   bytes_ms=bytes_ms, fp32_core_ms=fp32_core_ms,
                   bound_ms=max(bytes_ms, t_ops),
                   bound_by="bytes" if bytes_ms >= t_ops else "operations",
                   bytes=nbytes, flop=flops)
        rows.append(row)
        log(f"[kernel] {route} {label}: max|kernel-plain| {err:.3g} (atol "
            f"{atol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, conv1d "
            f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; bytes {bytes_ms:.4f}, fp32 cores "
            f"{fp32_core_ms:.4f})")
        del xI, xQ, xf, lib
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def noted_calls():
    """Set every kernel's launch count to 0 and note the (stage, input
    dtype, C, L, frames) of every polyphase call the front end makes
    inside the block, counted by shape (the wrapper itself, which counts
    the launches, runs unchanged underneath)."""
    from rtlsdr_wsprd_tpu_torch.frontend import decimate
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate

    shapes: dict[tuple, int] = {}

    def noting(xI, xQ, filt, n_frames):
        key = ("stage1" if filt is decimate.STAGE1 else "stage2",
               str(xI.dtype).removeprefix("torch."),
               *(xI.shape if xI.dim() == 2 else (1, *xI.shape)), n_frames)
        shapes[key] = shapes.get(key, 0) + 1
        return polyphase_decimate(xI, xQ, filt, n_frames)

    decimate.polyphase_decimate = noting
    for route in polyphase_decimate.launches:
        polyphase_decimate.launches[route] = 0
    try:
        yield shapes
    finally:
        decimate.polyphase_decimate = polyphase_decimate


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
    # every uint8 stage-1 call on the tensor-core kernel, every stage-2
    # call on polyphase.cu, and no other call
    want = {"tc": sum(k for key, k in shapes.items()
                      if key[:2] == ("stage1", "uint8")),
            "direct": sum(k for key, k in shapes.items()
                          if key[0] == "stage2")}
    if (launches != want or not all(launches.values())
            or sum(shapes.values()) != sum(want.values())
            or any(len(k) != 5 for k in shapes)):
        fail(f"front-end calls {shapes} do not match launches {launches}: "
             f"want {want}")
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
    # every call, both stages, float32 on polyphase.cu
    want = {"tc": 0, "direct": sum(shapes.values())}
    if (launches != want or not want["direct"]
            or any(k[1] != "float32" for k in shapes)):
        fail(f"single-lane calls {shapes} do not match launches {launches}: "
             f"want {want}")
    log(f"[single] launches by (stage, dtype, C, L, frames): "
        f"{sorted(shapes.items())}")
    return launches, shapes


# integer instructions of one flat Fano step (a forward look or one
# backtrack move), counted from csrc/fano.cu: a forward look ~55 (the
# threshold test and tighten, five node stores, the encoder symbol, two
# branch metrics from shared memory, the sort), a backtrack move ~15
# (the threshold test, five node loads, the branch test); the walks take
# them about one for one
FANO_STEP_OPS = 35
FANO_BUDGETS = (16, 64, 256)
FANO_FIELDS = ("data", "success", "metric", "cycles", "maxnp")


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
    from rtlsdr_wsprd_tpu_torch import native
    from rtlsdr_wsprd_tpu_torch.ops import calibrate
    from rtlsdr_wsprd_tpu_torch.ops.fano import (
        METTAB,
        batched_fano,
        batched_fano_plain,
    )

    # measured at the first decode with fec="auto" (the front-end phase)
    cal = calibrate.get_fec_calibration(dev)
    log(f"[fano] calibration {json.dumps(cal.as_dict())} ({card})")
    mt = torch.from_numpy(METTAB).to(dev)
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
    bw = card_peaks(name)[2]
    int_rate = int32_rate(name)
    threads = os.cpu_count() or 1
    budgets = sorted(set(FANO_BUDGETS) | {cal.device_maxcycles})
    rows = []
    for label, (syms, valid) in inputs.items():
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
            log(f"[fano] {label}: kernel vs plain at {mc}: mismatches {bad}")
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
            log(f"[fano] {label}: kernel vs native at {mc}: mismatches "
                f"{bad}; {int(ok.sum())} of {live} lanes decode")
            if any(bad.values()):
                fail(f"fano kernel vs native, {label} at {mc}: {bad}")
        for mc in budgets:
            steps = batched_fano(s, mt, 60, mc, v,
                                 steps=True).steps.cpu().numpy()
            ms = cuda_ms(lambda: batched_fano(s, mt, 60, mc, v),
                         reps=5 if mc > 64 else 25)
            t0 = time.perf_counter()
            native.fano_decode_many(syms[valid], METTAB, 60, mc,
                                    threads=threads)
            host_ms = 1e3 * (time.perf_counter() - t0)
            n = syms.shape[0]
            nbytes = n * 162 + METTAB.nbytes + n + n * (11 + 1 + 3 * 4)
            bytes_ms = nbytes / bw * 1e3
            ops_ms = int(steps.sum()) * FANO_STEP_OPS / int_rate * 1e3
            row = dict(input=label, lanes=n, live_lanes=live, maxcycles=mc,
                       calibrated=mc == cal.device_maxcycles, ms=ms,
                       plain_ms=plain_ms if mc == 16 else None,
                       host_ms=host_ms, host_threads=threads,
                       steps_total=int(steps.sum()),
                       steps_max_lane=int(steps.max()), bytes=nbytes,
                       bytes_ms=bytes_ms, ops_ms=ops_ms,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", mismatches=0)
            rows.append(row)
            log(f"[fano] {label} x {n} lanes at {mc}: kernel {ms:.4f} ms, "
                f"plain {'-' if row['plain_ms'] is None else round(plain_ms, 1)}"
                f" ms, native on {threads} threads {host_ms:.3f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}; "
                f"{row['steps_total']} steps, slowest lane "
                f"{row['steps_max_lane']})")
        del s, v
    return rows, cal


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

    def fields(spots):
        return [[(x.message, x.jitter, x.cycles, x.freq, x.snr, x.dt, x.sync)
                 for x in ch] for ch in spots]

    def timed(fec):
        t0 = time.perf_counter()
        spots = run(fec)
        log(f"[decode] fec={fec}: warm-up run {time.perf_counter() - t0:.2f} s")
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = run(fec)
            secs.append(time.perf_counter() - t0)
            if fields(got) != fields(spots):
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
    if fields(hybrid) != fields(host):
        diff = [b for b in range(B) if fields(hybrid)[b] != fields(host)[b]]
        fail(f"hybrid spots differ from host in windows {diff[:10]}")
    log(f"[decode] hybrid spot lists equal host's; {launches} Fano kernel "
        f"launches over the 4 hybrid runs ({launches // 4} a run)")

    n_batches = 4
    want = fields(host)
    t0 = time.perf_counter()
    out = list(decode_channels_pipelined(
        [(wi, wq)] * n_batches, opts, depth=2, device_batch=DB, device=dev))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    if len(out) != n_batches or any(fields(o) != want for o in out):
        fail("a pipelined batch differs from the host decode")
    pipe_rate = n_batches * B / pipe_s
    log(f"[decode] decode_channels_pipelined depth 2, {n_batches} x {B} "
        f"windows (fec=auto: {cal.mode}): {pipe_s:.2f} s = {pipe_rate:.1f} "
        f"decode windows/s ({card}); every batch equals the host decode")
    phase_profile(lambda: run("auto"), card)
    return dict(host=host_rate, hybrid=hybrid_rate, pipelined=pipe_rate,
                hybrid_launches=launches)


RANGES = ("stage_a", "stage_b_launch", "stage_b_wait", "fec_host",
          "fec_device", "fec_host_finish", "spots", "subtract")


def phase_profile(run, card):
    """One more decode run under torch.profiler: the host time inside
    each labelled range of decode_channels, the card's total kernel time
    and its busy share of the run, and the heaviest kernels."""
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
    log(json.dumps({"profile": {
        "card": card, "wall_ms": round(wall * 1e3, 3),
        "kernel_ms": round(kernel_ms, 3),
        "device_busy_share": round(kernel_ms / (wall * 1e3), 4),
        "host_ms_in_range": host_ms, "device_span_ms_of_range": span_ms,
        "top_kernels_ms": [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count]
                           for e in top]}}))


def main() -> None:
    t_start = time.perf_counter()
    dev, name, card = phase_env()
    phase_build()
    chunks = synth_capture()
    launches, shapes, refI, refQ = phase_frontend(dev, chunks)
    launches1, shapes1 = phase_single(dev, chunks, refI, refQ)
    del chunks
    rows = phase_kernel(dev, name, {"batched": shapes, "single": shapes1})
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions

    t0 = time.perf_counter()
    wi, wq, calls = make_batch(512, seed=11)
    log(f"[decode] made 512 windows in {time.perf_counter() - t0:.1f} s")
    fano_rows, cal = phase_fano(dev, name, card, wi, wq, DecoderOptions(),
                                128)
    dec = phase_decode(dev, card, wi, wq, calls, cal)
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
            "launches": launches[route] + launches1[route],
            "launches_by_path": {"batched": launches[route],
                                 "single": launches1[route]},
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
    kernels.append({
        "name": "batched_fano",
        "route": "cuda",
        "source": "rtlsdr_wsprd_tpu_torch/ops/csrc/fano.cu",
        "replaces": "rtlsdr_wsprd_tpu/ops/fano.py:91",
        "launches": dec["hybrid_launches"],
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
        "runs": fano_rows,
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

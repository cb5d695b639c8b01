"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. env      torch/CUDA versions, the card's name and power limit, TF32 off.
2. build    the stage-1/2 polyphase CUDA kernel (nvcc) and the host Fano
            library (g++), built at the same time from this checkout.
3. frontend the main path: a 120 s synthetic raw 2.4 Msps uint8 capture
            streamed in 10 s chunks through BatchedStreamingDecimator (8
            lanes, each fed the same capture), lane 0's window decoded by
            decode_channels; the kernel's launch count is read around
            this phase, and the shape of every launch is recorded.
4. kernel   the kernel against its plain PyTorch version on the card at
            every shape the main path launched it with (plus a QUANT1
            stage-1 step and a 100-frame stage-2 call), with the device
            times of the kernel, the plain version, one torch conv1d call
            (a yardstick the port never calls) and the card's bound for
            the same work.
5. decode   512 mixed windows through decode_channels (full jitter
            schedule, 2 passes, device_batch=128): one warm-up and three
            timed runs, decode windows/s, every expected message found;
            then one run under torch.profiler (host time per labelled
            range, the card's kernel time and busy share).

Then a JSON line per kernel, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
non-zero without one. Imports nothing of JAX.
"""

from __future__ import annotations

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
# float32 outside the tensor cores, and device-memory bandwidth
PEAKS = (
    ("H100 PCIe", 51e12, 2.0e12),
    ("H100 NVL", 60e12, 3.9e12),
    ("H100", 67e12, 3.35e12),   # SXM5
    ("H200", 67e12, 4.8e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[float, float]:
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
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
        ("polyphase.cu (nvcc)", polyphase.build_kernel),
        ("hostdsp.cpp (g++)", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors[0]}")
    for label, s in took.items():
        log(f"[build] {label}: {s:.1f} s")


def phase_kernel(dev, name, main_shapes):
    """Kernel vs plain at every shape of ``main_shapes`` (the main path's
    launches, from phase_frontend) and at two smaller calls of the
    streaming front end; returns one row per shape."""
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import STAGE1, STAGE2
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
        polyphase_decimate,
        polyphase_plain,
    )

    peak_flops, peak_bw = card_peaks(name)
    rng = np.random.default_rng(1)
    rows = []
    filters = {"stage1": STAGE1, "stage2": STAGE2}
    # stage, input dtype, C, L, frames, launches on the main path
    cases = sorted(((st, dt, C, L, n, k) for (st, dt, C, L, n), k
                    in main_shapes.items()), key=lambda c: (c[0], -c[4]))
    cases += [("stage1", "uint8", 8, 8000 * STAGE1.R + STAGE1.T - STAGE1.R,
               8000, 0),
              ("stage2", "float32", 8, 100 * STAGE2.R + STAGE2.T - STAGE2.R,
               100, 0)]
    atol = 1e-3
    for stage, dt, C, L, n, launched in cases:
        filt = filters[stage]
        # real taps (stage 2) need 2 FMA per tap and frame, complex 4
        flop_tap = 8 if np.any(filt.gi) else 4
        label = (f"{stage} {dt} C={C} x {n} frames, L={L} "
                 f"({launched} launches on the main path)")
        if dt == "uint8":
            hI = rng.integers(0, 256, (C, L), dtype=np.uint8)
            hQ = rng.integers(0, 256, (C, L), dtype=np.uint8)
        else:
            hI = rng.normal(0, 10.0, (C, L)).astype(np.float32)
            hQ = rng.normal(0, 10.0, (C, L)).astype(np.float32)
        xI = torch.from_numpy(hI).to(dev)
        xQ = torch.from_numpy(hQ).to(dev)
        kI, kQ = polyphase_decimate(xI, xQ, filt, n)
        pI, pQ = polyphase_plain(xI, xQ, filt, n)
        torch.cuda.synchronize()
        err = max(float((kI - pI).abs().max()), float((kQ - pQ).abs().max()))
        if not (err <= atol):
            fail(f"kernel vs plain, {label}: max |diff| {err} > {atol}")

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
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = flops / peak_flops * 1e3
        row = dict(shape=label, stage=stage, dtype=dt, C=C, L=L, frames=n,
                   launches=launched, max_abs_err=err, atol=atol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_max_abs_err=lib_err,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flop=flops)
        rows.append(row)
        log(f"[kernel] {label}: max|kernel-plain| {err:.3g} (atol {atol}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, conv1d "
            f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        del xI, xQ, xf, lib
    torch.cuda.empty_cache()
    return rows


def phase_frontend(dev, C: int = 8):
    """The main path: raw 120 s capture -> C-lane streaming front end ->
    decode of lane 0. Returns the kernel launches it made and the count
    of launches per (stage, input dtype, C, L, frames)."""
    from rtlsdr_wsprd_tpu_torch.config import SIGNAL_SAMPLES, DecoderOptions
    from rtlsdr_wsprd_tpu_torch.frontend import decimate
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu_torch.frontend.polyphase import polyphase_decimate
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import decode_channels
    from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db
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

    # note the shape of every call the front end makes (the wrapper
    # itself, which counts the launches, runs unchanged underneath)
    shapes: dict[tuple, int] = {}

    def noting(xI, xQ, filt, n_frames):
        key = ("stage1" if filt is decimate.STAGE1 else "stage2",
               str(xI.dtype).removeprefix("torch."), *xI.shape, n_frames)
        shapes[key] = shapes.get(key, 0) + 1
        return polyphase_decimate(xI, xQ, filt, n_frames)

    decimate.polyphase_decimate = noting
    polyphase_decimate.launches = 0
    try:
        t0 = time.perf_counter()
        fe = BatchedStreamingDecimator(C, device=dev)
        outs = [fe.push(np.broadcast_to(ri, (C, ri.size)),
                        np.broadcast_to(rq, (C, rq.size)))
                for ri, rq in chunks]
        outs.append(fe.flush())
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
    finally:
        decimate.polyphase_decimate = polyphase_decimate
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
    launches = polyphase_decimate.launches
    log(f"[frontend] {C} lanes x 120 s raw -> {bI.shape[1]} samples at "
        f"375 sps in {fe_s:.2f} s ({C * 120 / fe_s:.1f} channel-s per s, "
        f"host synthesis excluded); polyphase launches {launches}; spots "
        f"{[(s.message, round(s.dt, 3), round(s.freq * 1e6 - 1500, 3)) for s in spots]}")
    if len(spots) != 1:
        fail(f"raw capture decoded {len(spots)} spots, want 1")
    s = spots[0]
    if (s.call, s.loc, s.pwr) != ("K1JT", "FN20", "20"):
        fail(f"raw capture decoded {s.message!r}")
    if abs(s.dt) >= 0.3 or abs((s.freq * 1e6 - 1500.0) - 30.0) >= 0.5:
        fail(f"raw capture spot off: dt {s.dt}, freq {s.freq}")
    if launches <= 0:
        fail("the main path never launched the polyphase kernel")
    if sum(shapes.values()) != launches or any(len(k) != 5 for k in shapes):
        fail(f"front-end calls {shapes} do not match {launches} launches")
    log(f"[frontend] launches by (stage, dtype, C, L, frames): "
        f"{sorted(shapes.items())}")
    return launches, shapes


def phase_decode(dev, card, B: int = 512, DB: int = 128):
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel.multichannel import decode_channels

    t0 = time.perf_counter()
    wi, wq, calls = make_batch(B, seed=11)
    log(f"[decode] made {B} windows in {time.perf_counter() - t0:.1f} s")
    opts = DecoderOptions()

    def run():
        out = decode_channels(wi, wq, opts, device_batch=DB, device=dev)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    spots = run()
    log(f"[decode] warm-up run {time.perf_counter() - t0:.2f} s")
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = run()
        secs.append(time.perf_counter() - t0)
        if [[x.message for x in ch] for ch in got] != \
                [[x.message for x in ch] for ch in spots]:
            fail("decode runs disagree")
    med = statistics.median(secs)
    missing = [b for b in range(B) if b % 4 != 3 and calls[b % 4]
               not in [x.message for x in spots[b]]]
    noisy = [b for b in range(B) if b % 4 == 3 and spots[b]]
    if missing:
        fail(f"strong message missing in windows {missing[:10]}")
    if noisy:
        fail(f"noise-only windows gave spots: {noisy[:10]}")
    bad = [x for ch in spots for x in ch
           if not all(np.isfinite([x.freq, x.snr, x.dt, x.sync]))]
    if bad:
        fail(f"non-finite spot fields: {bad[:3]}")
    total = sum(len(ch) for ch in spots)
    first32 = sum(len(ch) for ch in spots[:32])
    log(f"[decode] B={B} device_batch={DB}: runs {[round(s, 3) for s in secs]}"
        f" s, median {med:.3f} s = {B / med:.1f} decode windows/s "
        f"({card}); spots {total} (first 32 windows: {first32})")
    phase_profile(run, card)
    return B / med


RANGES = ("stage_a", "stage_b_launch", "stage_b_wait", "fec_host", "spots",
          "subtract")


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
    launches, shapes = phase_frontend(dev)
    rows = phase_kernel(dev, name, shapes)
    phase_decode(dev, card)
    # headline: the stage-1 shape the main path launched most (10 s push)
    main_row = max((r for r in rows if r["stage"] == "stage1"),
                   key=lambda r: (r["launches"], r["frames"]))
    kernels = [{
        "name": "polyphase_decimate",
        "route": "cuda",
        "source": "rtlsdr_wsprd_tpu_torch/frontend/csrc/polyphase.cu",
        "replaces": "rtlsdr_wsprd_tpu/frontend/pallas_decimate.py:78",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

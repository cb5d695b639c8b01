"""Measurement helpers shared by chip_smoke.py and the port's tools
(tools/torch_*.py): the card's published peaks, device timing between
CUDA events, the card banner every time is stated beside, the port's
copy of bench.py's window batch, and the work of one call of each
hand-written kernel (the bytes and operations its bound is computed
from: ``polyphase_work``, ``coarse_work``, ``correlator_work``, and the
search kernels' direct forms beside them, ``coarse_direct_work`` and
``correlator_direct_work``).

Imports nothing of JAX; importing it touches no device.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

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


def card_peaks(name: str) -> tuple[float, float, float]:
    """(float32 FLOP/s, TF32 FLOP/s, bytes/s) of the card ``name``."""
    for key, flops, tf32, bw in PEAKS:
        if key in name:
            return flops, tf32, bw
    raise ValueError(f"no published peaks for card {name!r}")


def int32_rate(name: str) -> float:
    return card_peaks(name)[0] / 4


def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of torch.cuda._sleep on the current card."""
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
    cycles = int(spin_ms * spin_cycles_per_ms())
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


def nvidia_smi_card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0].strip() if smi else "nvidia-smi gave nothing"


def device_banner(device) -> str:
    """The device a tool ran on: for the card, its name and power limit
    as nvidia-smi gives them, beside which every time is stated. Raises
    without CUDA unless ``device`` is the CPU (device.resolve_device)."""
    from rtlsdr_wsprd_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"{dev} (plain PyTorch versions; no device time)"
    return f"{dev}: {nvidia_smi_card()}"


def make_batch(B: int, seed: int = 11):
    """B windows with mixed content: most hold 2 signals at varied SNR,
    every fourth is noise only (the port's copy of bench.py's batch).
    Returns (wi, wq, calls)."""
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


def polyphase_work(filt, C: int, L: int, n: int, itemsize: int,
                   one_stream: bool = False) -> tuple[int, int]:
    """(bytes, FLOPs) of one polyphase call: C rows of L input samples
    of ``itemsize`` bytes a plane through ``filt`` (one filter, or a
    bank whose first filter sets T) to n frames. Each input is read
    once (``one_stream``: a bank's rows are one stream expanded, read
    once for all of them) and each float32 output written once; a
    complex tap costs 8 FLOPs a frame, a real one 4."""
    first = filt[0] if isinstance(filt, (list, tuple)) else filt
    flop_tap = 8 if np.any(first.gi) else 4
    nbytes = 2 * (1 if one_stream else C) * L * itemsize + 2 * C * n * 4
    return nbytes, flop_tap * first.T * C * n


def coarse_work(B: int, maxdrift) -> tuple[int, int]:
    """(bytes, FLOPs) of one ``ops.coarse.coarse_rows`` call on B windows
    (csrc/coarse.cu): the least work of its pre-summed form. Bytes: the
    (B, 512, 347) float32 spectrogram, the maxdrift row and the 162 pr3
    signs read once, each row's value and index written once. FLOPs: 2
    adds for each (row, lag, symbol) and each drift within the window's
    ``maxdrift`` (an int, or one per window; the drifts a run masks cost
    nothing): one into the total, one signed into the sync sum; plus
    the two pre-summed planes of each window that keeps a drift, 3 adds
    each for every (row, column) of the spectrogram. The FP32 peak
    counts an FMA as 2 FLOPs, so a kernel of adds reaches at most half
    of the bound these give."""
    md = np.broadcast_to(np.asarray(maxdrift, dtype=np.int64), (B,))
    drifts = int(np.sum(np.clip(2 * md + 1, 0, 9)))
    planes = int(np.sum(md >= 0)) * 512 * 347 * 6
    nbytes = B * 512 * 347 * 4 + B * 4 + 162 * 4 + B * 512 * 8
    return nbytes, 512 * 32 * 162 * 2 * drifts + planes


def coarse_direct_work(B: int, maxdrift) -> tuple[int, int]:
    """(bytes, FLOPs) of the direct form of ``coarse_work``'s call, each
    grid point's 4 tone reads summed from a (9, 162) int32 table of
    drift offsets and signs: one add for each of the 4 tone reads of a
    symbol into the signed sum and one into the total, 162 symbols, at
    every (row, lag) and each drift within the window's ``maxdrift``."""
    md = np.broadcast_to(np.asarray(maxdrift, dtype=np.int64), (B,))
    drifts = int(np.sum(np.clip(2 * md + 1, 0, 9)))
    nbytes = B * 512 * 347 * 4 + B * 4 + 9 * 162 * 4 + B * 512 * 8
    return nbytes, 512 * 32 * 162 * 4 * 2 * drifts


def correlator_work(G: int, L: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one ``ops.sync.tone_correlator`` call on G lanes
    at L offsets (csrc/correlator.cu): the least work of its prefix-sum
    form. Bytes: the two (G, 41,728) float32 window planes, freq and
    drift, the offsets and the (2, 512, 4) phasor table read once, the
    (G, 162, L, 4) magnitudes written once. FLOPs a symbol: the
    derotation of its 512-sample double frame (4 multiplies and 2 adds a
    sample), then the lesser of the prefix sums (4 tones x 512 complex
    multiply-adds, 8 FLOPs each, and for each offset and tone a complex
    difference and a squared magnitude, 5 FLOPs) and the direct form's
    dot products (``correlator_direct_work``: fewer only at L = 1)."""
    nbytes = (2 * G * 41_728 * 4 + 2 * G * 4 + L * 4 + 2 * 512 * 4 * 4
              + G * 162 * L * 4 * 4)
    sums = min(4 * 512 * 8 + L * 4 * 5, L * 4 * 256 * 8)
    return nbytes, G * 162 * (sums + 512 * 6)


def correlator_direct_work(G: int, L: int) -> tuple[int, int]:
    """(bytes, FLOPs) of the direct form of ``correlator_work``'s call:
    the (2, 256, 4) tone table read, and a 256-term
    complex dot product (8 FLOPs a term) for each (symbol, offset,
    tone), plus the derotation of each symbol's 512-sample double frame
    (4 multiplies and 2 adds a sample)."""
    nbytes = (2 * G * 41_728 * 4 + 2 * G * 4 + L * 4 + 2 * 256 * 4 * 4
              + G * 162 * L * 4 * 4)
    return nbytes, G * 162 * (L * 4 * 256 * 8 + 512 * 6)


def stft_work(B: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one ``ops.stft.power_rows`` call on B windows
    (csrc/stft.cu), the FFT form. Bytes: the 44,800 samples of each
    window's two float32 planes that its 347 frames read, the 512-point
    window and the (2, 256) twiddle table read once, the (B, 347, 512)
    float32 powers written once. FLOPs a frame: 5 N log2 N for the
    512-point complex FFT, 2 a sample for the window (a real times a
    complex) and 3 a bin for the squared magnitude."""
    nbytes = 2 * B * 44_800 * 4 + 512 * 4 + 2 * 256 * 4 + B * 347 * 512 * 4
    per_frame = 5 * 512 * 9 + 2 * 512 + 3 * 512
    return nbytes, B * 347 * per_frame


def stft_direct_work(B: int) -> tuple[int, int]:
    """(bytes, FLOPs) of the direct (matrix-product) form of
    ``stft_work``'s call, ops/stft.py ``power_spectrogram_plain``: four
    (347, 512) @ (512, 512) float32 products a window (2 FLOPs a
    multiply-add), the two (512, 512) DFT matrices read beside the
    planes, the window and the powers."""
    nbytes = (2 * B * 44_800 * 4 + 512 * 4 + 2 * 512 * 512 * 4
              + B * 347 * 512 * 4)
    return nbytes, 4 * 2 * B * 347 * 512 * 512


def polyphase_bound(nbytes: int, flops: int, route: str,
                    name: str) -> dict:
    """The card's least time for that work: bytes over the memory rate,
    and the FLOPs over the FP32 cores' rate, or, for the tensor-core
    kernel (``route == "tc"``), as two TF32 products over the tensor
    cores' rate; the larger bounds it."""
    peak_flops, peak_tf32, peak_bw = card_peaks(name)
    bytes_ms = nbytes / peak_bw * 1e3
    fp32_core_ms = flops / peak_flops * 1e3
    ops_ms = 2 * flops / peak_tf32 * 1e3 if route == "tc" else fp32_core_ms
    return dict(bytes_ms=bytes_ms, fp32_core_ms=fp32_core_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")

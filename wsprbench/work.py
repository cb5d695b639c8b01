"""Frozen work counts of the port's kernels, and the card's published peaks.

Each count is what the operation needs at a launch's shapes, whatever
kernel computes it: bytes are every input byte read once and every
output byte written once; operations are the fewest that known
algorithms need, so that no redesign of a kernel can do less work than
the count says. A roofline share is the least time (the larger of
bytes over bandwidth and operations over the float32 peak) over the
measured time; it cannot pass 100% unless a count is too high.
"""

from __future__ import annotations

import numpy as np

# published peaks, dense (NVIDIA data sheets): float32 outside the
# tensor cores, device-memory bandwidth
PEAKS = (
    ("H100 PCIe", 51e12, 2.0e12),
    ("H100 NVL", 60e12, 3.9e12),
    ("H100", 67e12, 3.35e12),   # SXM5, 700 W
)

SAMPLES = 45_000
NSYM = 162
STFT_N = 512
STFT_FRAMES = 347
STFT_SPAN = (STFT_FRAMES + 3) * 128       # 44,800 samples the frames read
ROWS = 512                                # spectrogram rows (bins)
LAGS = 32                                 # coarse time lags
WLEN = NSYM * 256 + 2 * 128               # a lane's window, 41,728 samples


def card_peaks(name: str) -> tuple[float, float]:
    """(float32 FLOP/s, bytes/s) of the card ``name``."""
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise ValueError(f"no published peaks for card {name!r}")


def fft_flops(n: int) -> int:
    """Real operations of an n-point complex split-radix FFT, the fewest
    a known algorithm needs (4 n log2 n - 6 n + 8)."""
    return 4 * n * int(np.log2(n)) - 6 * n + 8


def stft_work(B: int) -> tuple[int, int]:
    """``stft.cu`` on B windows: 347 frames of 512 points a window, each
    windowed (2 multiplies a point), transformed and squared (3
    operations a bin). Bytes: the 44,800 samples of both float32 planes
    a window read once, the (347, 512) float32 powers written once."""
    nbytes = B * (2 * STFT_SPAN * 4 + STFT_FRAMES * STFT_N * 4)
    ops = B * STFT_FRAMES * (2 * STFT_N + fft_flops(STFT_N) + 3 * STFT_N)
    return nbytes, ops


# runs of symbols on which the drift offset floor(((i - 81)/81) d / DF)
# stays constant, for d = -4..4 (the reference's grid, wsprd/wsprd.c:
# 659-667); a drift's sums change only at a run's ends
DRIFT_RUNS = (6, 6, 4, 2, 1, 2, 4, 6, 6)


def coarse_work(B: int, maxdrift: int) -> tuple[int, int]:
    """``coarse.cu`` on B windows: every (row, lag, drift) point's sync
    ratio of a pr3-signed and a total sum over 162 symbols. Operations
    are the adds, as every form the repository names counts them (the
    square roots and the ratios left out alike): the two tone planes, 3
    adds each a spectrogram cell; then per (row, lag) the fewer of the
    drifts' direct sums (2 x 162 adds a drift) and a running sum of each
    plane along the lag's symbols (2 x 162) from which each drift's two
    sums come at its runs' ends (a subtraction and an add a run a plane).
    No more than the kernel's pre-summed form, its direct form or the
    per-run form PERF.md proposes. Bytes: the (512, 347) float32
    spectrogram a window read once, each row's best value and index
    written once."""
    runs = sum(DRIFT_RUNS[4 - maxdrift:5 + maxdrift])
    drifts = 2 * maxdrift + 1
    per_row_lag = min(2 * NSYM * drifts, 2 * NSYM + 2 * 2 * runs)
    ops = B * (ROWS * STFT_FRAMES * 6 + ROWS * LAGS * per_row_lag)
    nbytes = B * ROWS * STFT_FRAMES * 4 + B * ROWS * 8
    return nbytes, ops


def correlator_work(G: int, L: int) -> tuple[int, int]:
    """``correlator.cu`` on G lanes at L offsets: a lane symbol's
    512-sample double frame derotated (6 operations a sample), each of
    the 4 tones' products summed once along the frame (8 a sample), and
    each offset's tone sum taken as a difference of two partial sums
    with its squared magnitude (5); the direct 256-term dot products
    where that is fewer (L = 1). Bytes: both (G, 41,728) float32 window
    planes and the lanes' freq and drift read once, the (G, 162, L, 4)
    magnitudes written once."""
    sums = min(4 * 512 * 8 + L * 4 * 5, L * 4 * 256 * 8)
    ops = G * NSYM * (512 * 6 + sums)
    nbytes = 2 * G * WLEN * 4 + 2 * G * 4 + G * NSYM * L * 4 * 4
    return nbytes, ops


def polyphase_tc_work(C: int, L: int, n: int, taps: int = 640) -> tuple[
        int, int]:
    """``polyphase_tc.cu``: C rows of L uint8 I/Q samples through the
    640-tap complex stage-1 filter to n frames. The taps are a real
    lowpass times i^-k, so a tap is a real multiply-add on each plane of
    a sign-swapped sample (4 operations), and the lowpass is symmetric,
    so tap pairs share one multiply after an add: 3 operations a tap.
    Bytes: the uint8 planes read once, the float32 frames written once."""
    return 2 * C * L + 2 * C * n * 4, 3 * taps * C * n


def roofline_ms(nbytes: int, ops: int, card: str) -> float:
    flops, bw = card_peaks(card)
    return 1e3 * max(nbytes / bw, ops / flops)

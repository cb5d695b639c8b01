"""The frozen work counts: held to the plain route's shapes, and no
more than any form of the kernels the repository names."""

import importlib.util
import sys

import numpy as np
import pytest
import torch

from wsprbench import work
from wsprbench.reference import dsp, frontend


def _measure():
    path = work.__file__.replace("wsprbench/work.py", "tools/torch_measure.py")
    spec = importlib.util.spec_from_file_location("torch_measure", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError as exc:  # the tool imports the port
        pytest.skip(f"tools/torch_measure.py: {exc}")
    return mod


def test_stft_counts_the_plain_routes_shapes():
    x = torch.zeros(2, 45000)
    ps = dsp.power_spectrogram_plain(x, x)
    assert ps.shape == (2, work.ROWS, work.STFT_FRAMES)
    assert dsp.SPAN == work.STFT_SPAN and dsp.BLOCKS == work.STFT_FRAMES
    nbytes, ops = work.stft_work(2)
    assert nbytes == 2 * (2 * dsp.SPAN * 4 + ps[0].numel() * 4)
    # fewer than the plain route's four matmuls
    assert ops < 2 * dsp.BLOCKS * 4 * 2 * 512 * 512
    assert work.fft_flops(512) == 15368


def test_coarse_counts_the_plain_routes_grid():
    fd = dsp._fd_int()
    runs = tuple(1 + int(np.count_nonzero(np.diff(fd[:, d])))
                 for d in range(fd.shape[1]))
    assert runs == work.DRIFT_RUNS
    ps = torch.rand(1, 512, 347)
    grid = dsp._sync_grid_plain(ps, 4)
    assert grid.shape == (1, work.ROWS, work.LAGS * 9)
    m = _measure()
    for md in (0, 2, 4):
        nb, ops = work.coarse_work(128, md)
        kb, kops = m.coarse_work(128, md)
        db, dops = m.coarse_direct_work(128, md)
        assert ops <= min(kops, dops) and nb <= min(kb, db)
    # the coarse-drift idea (PERF.md): the kernel's form cut ~2.4x
    assert work.coarse_work(128, 4)[1] < m.coarse_work(128, 4)[1] / 2.4


def test_correlator_counts_the_plain_routes_shapes():
    G, L = 3, 5
    w = torch.zeros(G, work.WLEN)
    out = dsp._tone_mags_offsets(w, w, torch.zeros(G), torch.zeros(G),
                                 tuple(range(0, 5 * L, 5)))
    assert out.shape == (G, work.NSYM, L, 4) and dsp.WLEN == work.WLEN
    m = _measure()
    for L in (1, 17, 33, 43):
        nb, ops = work.correlator_work(128, L)
        for form in (m.correlator_work, m.correlator_direct_work):
            fb, fops = form(128, L)
            assert ops <= fops and nb <= fb


def test_polyphase_tc_count_rests_on_the_filters_symmetry():
    h = frontend.kaiser_lowpass(640, 1000.0, 2.4e6, 85.0)
    assert np.allclose(h, h[::-1])          # tap pairs share a multiply
    g1, _ = frontend.taps()
    turned = g1[::-1] / h.astype(np.complex64)
    assert np.allclose(np.abs(turned), 1.0, atol=1e-3)  # i^-k: a sign swap
    nb, ops = work.polyphase_tc_work(64, 9_600_560, 120_000)
    assert nb == 2 * 64 * 9_600_560 + 2 * 64 * 120_000 * 4
    m = _measure()
    from rtlsdr_wsprd_tpu_torch.frontend.decimate import STAGE1
    kb, kops = m.polyphase_work(STAGE1, 64, 9_600_560, 120_000, 1)
    assert ops <= kops and nb == kb


def test_roofline_takes_the_larger_bound():
    nb, ops = work.stft_work(128)
    ms = work.roofline_ms(nb, ops, "NVIDIA H100 80GB HBM3")
    assert ms == pytest.approx(1e3 * nb / 3.35e12)
    with pytest.raises(ValueError):
        work.card_peaks("cpu")

"""Stage A's power spectrogram kernel (ops/csrc/stft.cu) against its
plain PyTorch version, on the CPU.

- The wrapper (``power_spectrogram``) sends CPU tensors to
  ``power_spectrogram_plain`` and launches nothing.
- On a CUDA tensor it launches the kernel or raises: with the loader made
  to fail, or no CUDA compiler, a call raises instead of returning the
  plain result; the argument checks (dtype, shape, inner stride,
  alignment) raise before the kernel is loaded. CUDA tensors are stood
  in for by CPU tensors that report a CUDA device
  (tests/test_torch_kernels_ab.py's ``_card``).
- The kernel's own source, compiled with g++ over
  tests/test_torch_kernels_ab.py's emulation shim (its asynchronous
  staging copies done at once), against the plain version within rtol
  1e-4 and atol 1e-6 of each window's peak (the tolerance the plain
  version is held to against the JAX package), its grid chosen
  by the test instead of the card's SMs: one window of windows3(); two
  windows in padded rows whose second is all zeros, which must give
  exactly 0; fewer persistent blocks than tiles, each walking many
  (window, tile) pairs through its ring of staged tiles, bit for bit
  the output of a block a tile; a dense-step chunk of 4 windows, the
  last zero, on persistent blocks.
- The kernel's twiddle table is bin 1 of the plain version's DFT
  matrices; the work formulas of tools/torch_measure.py.
- On a card (marked ``cuda``; chip_smoke.py's ``search`` phase is the
  check there), the kernel against the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu_torch.ops import stft as pstft

from test_torch_kernels_ab import (  # noqa: F401 (a fixture)
    _build,
    _card,
    _LoaderCalled,
    _t,
    one_intra_op_thread,
)
from torch_parity import import_tools, windows3

RTOL, ATOL_OF_PEAK = 1e-4, 1e-6
N = pstft.SIGNAL_SAMPLES

_STFT_LAUNCHER = """\
// the launch csrc/stft.cu's entry point makes, one block at a time, its
// grid chosen by ``grid`` (0: a block a tile) instead of the card's SMs
extern "C" void emu_stft(const float* xi, const float* xq, long long si,
                         long long sq, const float* hann,
                         const float* cos_sin, int n, int grid, float* out) {
  static_assert(kSmemBytes <= sizeof(g_smem));
  const int total = n * kTiles;
  gridDim = {unsigned(grid > 0 && grid < total ? grid : total), 1};
  for (unsigned b = 0; b < gridDim.x; ++b)
    run_block(b, 0, kThreads, [=] {
      stft_kernel(xi, xq, si, sq, hann, cos_sin, n, out);
    });
}
// (frames a tile, tiles a window)
extern "C" void emu_tiles(int* out) {
  out[0] = kTile;
  out[1] = kTiles;
}
"""


def assert_matches_plain(got: np.ndarray, si: torch.Tensor,
                         sq: torch.Tensor) -> None:
    """got (B, 512, 347) within RTOL and ATOL_OF_PEAK x each window's
    peak of the plain version's; a window whose plain peak is 0 exactly
    0."""
    want = pstft.power_spectrogram_plain(si, sq).numpy()
    for b in range(want.shape[0]):
        peak = float(want[b].max())
        np.testing.assert_allclose(got[b], want[b], rtol=RTOL,
                                   atol=ATOL_OF_PEAK * peak)
        if peak == 0:
            assert (got[b] == 0).all()


# ---- routing on the CPU, no fallback on the card -------------------------


def test_stft_wrapper_routes_cpu_to_plain():
    """power_spectrogram on CPU tensors is power_spectrogram_plain, bit
    for bit, at any leading dimensions, and launches nothing."""
    wi, wq = windows3()
    before = pstft.power_spectrogram.launches
    for si, sq in ((_t(wi[:2]), _t(wq[:2])), (_t(wi[2]), _t(wq[2]))):
        got = pstft.power_spectrogram(si, sq)
        assert torch.equal(got, pstft.power_spectrogram_plain(si, sq))
    assert got.shape == (512, pstft.BLOCKS)
    assert pstft.power_spectrogram.launches == before


@pytest.fixture()
def failing_loader(monkeypatch):
    def boom():
        raise _LoaderCalled

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pstft, "_load_kernel", boom)


def test_stft_no_fallback(failing_loader):
    """A CUDA-typed call whose kernel does not load raises; it never
    returns the plain result, and counts no launch."""
    si, sq = (torch.zeros((2, N)) for _ in range(2))
    before = pstft.power_spectrogram.launches
    with pytest.raises(_LoaderCalled):
        pstft.power_spectrogram(_card(si), _card(sq))
    assert pstft.power_spectrogram.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pstft.power_rows(si, sq)


def test_stft_no_fallback_without_nvcc(monkeypatch):
    """Without a CUDA compiler the kernel's first use fails to build, and
    the CUDA-typed call raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("shutil.which", lambda name: None)
    si, sq = (torch.zeros((1, N)) for _ in range(2))
    with pytest.raises(RuntimeError, match="not found"):
        pstft.power_spectrogram(_card(si), _card(sq))


def test_stft_argument_checks(failing_loader):
    """float32 (B, N >= 44,800) planes of one shape, unit inner stride,
    16-byte aligned base and row stride; anything else raises
    ValueError before the kernel is loaded. What the decode passes is
    taken: row slices of padded planes, gathered rows, one window's
    row (any row stride), rows of exactly 44,800 samples."""
    padded = torch.zeros((8, N))
    good = [
        (padded[2:6], padded[4:8]),
        (padded[torch.tensor([5, 1, 1])], padded[torch.tensor([0, 2, 3])]),
        (torch.zeros(N + 3)[None, :N], torch.zeros(N)[None]),
        (torch.zeros((2, N + 4))[:, :N], torch.zeros((2, N))),
        (torch.zeros((2, pstft.SPAN)), torch.zeros((2, pstft.SPAN))),
    ]
    for si, sq in good:
        with pytest.raises(_LoaderCalled):
            pstft.power_spectrogram(_card(si), _card(sq))
    z = torch.zeros((2, N))
    bad = {
        "dtype": (z.double(), z.double()),
        "rank 1": (z[0], z[0]),
        "rank 3": (z[None], z[None]),
        "short rows": (z[:, :pstft.SPAN - 4], z[:, :pstft.SPAN - 4]),
        "I/Q shapes": (z, z[:1]),
        "inner stride": (torch.zeros((2, 2 * N))[:, ::2], z),
        "transposed": (torch.zeros((N, 2)).t(), z),
        "unaligned base": (torch.zeros(2 * N + 1)[1:].reshape(2, N), z),
        "unaligned rows": (torch.zeros((2, N + 1))[:, :N], z),
    }
    for what, (si, sq) in bad.items():
        for a, b in ((si, sq), (sq, si)):
            with pytest.raises(ValueError):
                pstft.power_spectrogram(_card(a), _card(b))


# ---- the kernel's own source on the host ---------------------------------


@pytest.fixture(scope="module")
def emulated_stft(tmp_path_factory):
    lib = _build(tmp_path_factory.mktemp("stft_emu"), "stft.cu",
                 "extern __shared__ float4 stft_smem[];",
                 "float4* const stft_smem = "
                 "reinterpret_cast<float4*>(g_smem);",
                 _STFT_LAUNCHER)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.emu_stft.argtypes = [vp, vp, ll, ll, vp, vp, ci, ci, vp]
    lib.emu_tiles.argtypes = [vp]

    def run(si: torch.Tensor, sq: torch.Tensor, grid: int = 0) -> np.ndarray:
        """The kernel on (B, >= 44,800) planes as the wrapper passes them
        (row strides in floats), on ``grid`` persistent blocks (0: a
        block a tile): (B, 512, 347), the wrapper's layout."""
        pstft._check_planes(si, sq)
        B = si.shape[0]
        cos_sin = np.ascontiguousarray(pstft.TWIDDLE)
        hann = np.ascontiguousarray(pstft.HANN)
        out = np.full((B, pstft.BLOCKS, 512), np.nan, np.float32)
        lib.emu_stft(si.data_ptr(), sq.data_ptr(), si.stride(0),
                     sq.stride(0), hann.ctypes.data, cos_sin.ctypes.data, B,
                     grid, out.ctypes.data)
        return out.transpose(0, 2, 1)

    tiles = np.zeros(2, np.int32)
    lib.emu_tiles(tiles.ctypes.data)
    run.tile, run.tiles = (int(t) for t in tiles)
    return run


def test_stft_source_emulated_one_window(emulated_stft):
    """csrc/stft.cu run on the host on one window of windows3() (two
    signals), as decode_window launches it (a block a tile, 4 frames a
    tile, a frame a warp): within rtol 1e-4 and atol 1e-6 of the peak
    of the plain version."""
    assert (emulated_stft.tile, emulated_stft.tiles) == (4, 87)
    wi, wq = windows3()
    si, sq = _t(wi[:1]), _t(wq[:1])
    assert_matches_plain(emulated_stft(si, sq), si, sq)


def _padded_pair():
    """Two windows in rows of a padded plane (row stride 45,004 floats):
    windows3()'s second, then all zeros as the dense step pads its
    chunk; NaN past each row's 44,800 samples."""
    wi, wq = windows3()
    pi = torch.full((2, N + 4), float("nan"))
    pq = torch.full((2, N + 4), float("nan"))
    pi[:, :N], pq[:, :N] = 0.0, 0.0
    pi[0, :N], pq[0, :N] = _t(wi[1]), _t(wq[1])
    pi[:, pstft.SPAN:], pq[:, pstft.SPAN:] = float("nan"), float("nan")
    return pi[:, :N], pq[:, :N]


def test_stft_source_emulated_zero_window(emulated_stft):
    """csrc/stft.cu on two windows in rows of a padded plane (row stride
    45,004 floats), the second all zeros as the dense step pads its
    chunk: the first within the tolerance of the plain version, the
    second exactly 0; the bytes past each row's 44,800 samples are never
    read (NaN there changes nothing)."""
    si, sq = _padded_pair()
    got = emulated_stft(si, sq)
    assert np.isfinite(got).all()
    assert (got[1] == 0).all()
    assert_matches_plain(got, si[:, :pstft.SPAN], sq[:, :pstft.SPAN])


@pytest.mark.parametrize("grid", [1, 5, 13])
def test_stft_source_emulated_persistent_walk(emulated_stft, grid):
    """csrc/stft.cu on fewer persistent blocks than tiles (the padded
    pair's 174 tiles on 1, 5 or 13 blocks), so each block walks many
    (window, tile) pairs, across the window boundary, through both
    slots of its ring of staged tiles: bit for bit the output of a block
    a tile, within the tolerance of the plain version, the zero window
    exactly 0."""
    si, sq = _padded_pair()
    got = emulated_stft(si, sq, grid=grid)
    np.testing.assert_array_equal(got, emulated_stft(si, sq))
    assert (got[1] == 0).all()
    assert_matches_plain(got, si[:, :pstft.SPAN], sq[:, :pstft.SPAN])


def test_stft_source_emulated_dense_chunk(emulated_stft):
    """csrc/stft.cu on a dense-step chunk as the dense step launches it:
    4 windows of windows3() (the third noise only), the last zero-padded,
    on 7 persistent blocks: within the tolerance of the plain version,
    the padded window exactly 0."""
    wi, wq = windows3()
    si = torch.zeros((4, N))
    sq = torch.zeros((4, N))
    si[:3], sq[:3] = _t(wi), _t(wq)
    got = emulated_stft(si, sq, grid=7)
    assert (got[3] == 0).all()
    assert_matches_plain(got, si, sq)


def test_twiddle_table_is_dft_bin_one():
    """The kernel's twiddle table is column 257 (FFT bin 1) of DFT_COS
    and DFT_SIN at rows 0..255, as float32 values; the window it reads
    is HANN."""
    assert pstft.TWIDDLE.dtype == np.float32
    assert pstft.TWIDDLE.shape == (2, 256)
    np.testing.assert_array_equal(pstft.TWIDDLE[0], pstft.DFT_COS[:256, 257])
    np.testing.assert_array_equal(pstft.TWIDDLE[1], pstft.DFT_SIN[:256, 257])


# ---- the work formulas ----------------------------------------------------


@pytest.mark.parametrize("B", [1, 2])
def test_stft_work_formulas(B):
    """stft_direct_work is the plain route's counted matrix-product
    FLOPs; stft_work, the FFT form, counts the bytes of the planes' read
    span, the two tables and the powers once, and fewer FLOPs."""
    tm, roof = import_tools("torch_measure", "torch_roofline")
    rng = np.random.default_rng(4)
    si, sq = (_t(rng.normal(0, 0.1, (B, N)).astype(np.float32))
              for _ in range(2))
    with roof.counting() as c:
        pstft.power_spectrogram(si, sq)
    assert c.kernel_flops == 0
    nbytes, flops = tm.stft_direct_work(B)
    assert flops == c.mm_flops
    new_bytes, new_flops = tm.stft_work(B)
    assert new_bytes == (2 * B * pstft.SPAN * 4 + 512 * 4 + 256 * 2 * 4
                         + B * pstft.BLOCKS * 512 * 4)
    assert new_flops == B * pstft.BLOCKS * (5 * 512 * 9 + 5 * 512)
    assert new_flops * 80 < flops and new_bytes < nbytes


# ---- on the card ---------------------------------------------------------


@pytest.mark.cuda
def test_stft_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card at B=2 (the
    second window zero), the call counted. Runs only with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    wi, wq = windows3()
    si, sq = _t(wi[:2]).cuda(), _t(wq[:2]).cuda()
    si[1], sq[1] = 0.0, 0.0
    before = pstft.power_spectrogram.launches
    got = pstft.power_spectrogram(si, sq)
    assert pstft.power_spectrogram.launches == before + 1
    assert_matches_plain(got.cpu().numpy(), si.cpu(), sq.cpu())

"""Port stage A against the JAX package: the STFT power grid, the
candidate pick, the coarse (freq, lag, drift) grid and the packed
(B, 5, C) stage-A output."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.ops import candidates as jcand
from rtlsdr_wsprd_tpu.ops import coarse as jcoarse
from rtlsdr_wsprd_tpu.ops import stft as jstft
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu_torch.ops import candidates as pcand
from rtlsdr_wsprd_tpu_torch.ops import coarse as pcoarse
from rtlsdr_wsprd_tpu_torch.ops import stft as pstft
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import windows3


@pytest.fixture(scope="module")
def wins():
    return windows3()


@pytest.fixture(scope="module")
def jax_ps(wins):
    wi, wq = wins
    return [np.asarray(jstft.power_spectrogram(jnp.asarray(wi[b]),
                                               jnp.asarray(wq[b])))
            for b in range(wi.shape[0])]


def test_power_spectrogram_matches_jax(wins, jax_ps):
    """The matmul DFT power grid (512 x 347) per window, batched in the
    port: within 1e-4 relative to each grid's peak (float32 matmuls
    summed in another order)."""
    wi, wq = wins
    ps = pstft.power_spectrogram(torch.from_numpy(wi), torch.from_numpy(wq))
    assert ps.shape == (3, 512, pstft.BLOCKS)
    for b in range(3):
        ref = jax_ps[b]
        np.testing.assert_allclose(ps[b].numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * float(ref.max()))


def test_find_candidates_identical_given_jax_grid(jax_ps):
    """Given the JAX package's power grid, the candidate bins, their
    validity and frequencies are identical (stable SNR sort, the 122nd
    of 411 sorted values as the noise floor); SNR within 1e-4 dB."""
    ps = torch.from_numpy(np.stack(jax_ps))
    got = pcand.find_candidates(ps)
    for b in range(3):
        ref = jcand.find_candidates(jnp.asarray(jax_ps[b]))
        np.testing.assert_array_equal(got.bin_idx[b].numpy(),
                                      np.asarray(ref.bin_idx))
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_array_equal(got.freq[b].numpy(),
                                      np.asarray(ref.freq))
        np.testing.assert_allclose(got.snr[b].numpy(), np.asarray(ref.snr),
                                   rtol=0, atol=1e-4)
    # smoothed spectrum itself: within float32 rounding of the JAX one
    sm = pcand.smoothed_spectrum(ps)
    for b in range(3):
        np.testing.assert_allclose(
            sm[b].numpy(), np.asarray(jcand.smoothed_spectrum(
                jnp.asarray(jax_ps[b]))), rtol=1e-5, atol=1e-7)


def test_find_candidates_ties_keep_bin_order():
    """Equal SNRs keep ascending bin order (stable sort, never topk):
    a flat spectrum with spikes of equal height at several bins."""
    ps = np.ones((512, pstft.BLOCKS), np.float32)
    for j in (100, 140, 180, 300, 330):
        ps[j, :] = 50.0
    got = pcand.find_candidates(torch.from_numpy(ps[None]))
    ref = jcand.find_candidates(jnp.asarray(ps))
    np.testing.assert_array_equal(got.bin_idx[0].numpy(),
                                  np.asarray(ref.bin_idx))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(ref.valid))


@pytest.mark.parametrize("maxdrift", [4, 0])
def test_coarse_search_identical_given_jax_grid(jax_ps, maxdrift):
    """Given the JAX grid and candidate bins, the plain version's coarse
    freq, shift and drift are identical (first maximum wins in (ifr, k0, idrift) order);
    the sync metric within 1e-5."""
    ps = np.stack(jax_ps)
    bins = np.stack([np.asarray(jcand.find_candidates(jnp.asarray(p)).bin_idx)
                     for p in jax_ps])
    got = pcoarse.coarse_search_plain(
        torch.from_numpy(ps), torch.from_numpy(bins),
        torch.full((3,), maxdrift, dtype=torch.int32))
    for b in range(3):
        ref = jcoarse.coarse_search(jnp.asarray(ps[b]), jnp.asarray(bins[b]),
                                    maxdrift)
        np.testing.assert_array_equal(got.freq[b].numpy(),
                                      np.asarray(ref.freq))
        np.testing.assert_array_equal(got.shift[b].numpy(),
                                      np.asarray(ref.shift))
        np.testing.assert_array_equal(got.drift[b].numpy(),
                                      np.asarray(ref.drift))
        np.testing.assert_allclose(got.sync[b].numpy(), np.asarray(ref.sync),
                                   rtol=0, atol=1e-5)


def test_stage_a_pack_matches_jax(wins):
    """The packed (B, 5, C) stage A from the windows themselves: valid,
    freq, shift and drift identical; snr within 1e-4 dB."""
    wi, wq = wins
    B = wi.shape[0]
    ref = np.asarray(jmc._stage_a_packed(
        jnp.asarray(wi), jnp.asarray(wq), jnp.full((B,), 4, jnp.int32),
        fmin=-110.0, fmax=110.0))
    got = pmc._stage_a_packed(
        torch.from_numpy(wi), torch.from_numpy(wq),
        torch.full((B,), 4, dtype=torch.int32), fmin=-110.0,
        fmax=110.0).numpy()
    assert got.shape == ref.shape == (B, 5, 200)
    np.testing.assert_array_equal(got[:, 1:], ref[:, 1:])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=1e-4)
    assert (ref[:, 1] != 0).sum() >= 2


def test_stage_a_rows_matches_packed(wins):
    """The row-sliced stage A of later passes equals the packed form on
    the same rows, exactly."""
    wi, wq = wins
    si, sq = torch.from_numpy(wi), torch.from_numpy(wq)
    md = torch.full((2,), 4, dtype=torch.int32)
    rows = torch.tensor([2, 0])
    got = pmc._stage_a_rows(si, sq, rows, md, fmin=-110.0, fmax=110.0)
    ref = pmc._stage_a_packed(si[rows], sq[rows], md, fmin=-110.0,
                              fmax=110.0)
    assert torch.equal(got, ref)

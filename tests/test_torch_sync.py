"""Port stage B against the JAX package: the offset-tensorized tone
correlator, fine sync over lanes, the jittered soft symbols and the
packed stage-B output with its FEC gates and attempt prefetch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.ops import sync as jsync
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu_torch.ops import sync as psync
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import windows3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_tone_mags_offsets_matches_jax_and_bruteforce(rng):
    """The one-matmul correlator at every static offset equals the JAX
    package's (rtol 1e-5: the same float32 products in another order)
    and the direct per-offset form (slice, derotate with the 256-sample
    phasor, correlate with E_TONE), with the tolerance the JAX package
    holds its own correlator to (rtol 2e-4, atol 2e-3)."""
    C = 3
    wr = rng.normal(0, 1, (C, psync.WLEN)).astype(np.float32)
    wi = rng.normal(0, 1, (C, psync.WLEN)).astype(np.float32)
    freq = np.linspace(-90, 100, C).astype(np.float32)
    drift = np.linspace(-3, 3, C).astype(np.float32)
    offsets = (0, 8, 127, 129, 256)

    p = psync._tone_mags_offsets(_t(wr), _t(wi), _t(freq), _t(drift),
                                 offsets).numpy()
    assert p.shape == (C, 162, len(offsets), 4)
    ref = np.asarray(jsync._tone_mags_offsets(
        jnp.asarray(wr), jnp.asarray(wi), jnp.asarray(freq),
        jnp.asarray(drift), offsets))
    np.testing.assert_allclose(p, ref, rtol=1e-5, atol=1e-4)

    ecr, eci = psync._cand_phasor_conj(_t(freq), _t(drift))
    etr, eti = _t(psync.E_TONE_R), _t(psync.E_TONE_I)
    for k, o in enumerate(offsets):
        xr = _t(wr[:, o:o + psync.NSIG].reshape(C, 162, 256))
        xi = _t(wi[:, o:o + psync.NSIG].reshape(C, 162, 256))
        yr, yi = psync._derotate(xr, xi, ecr, eci)
        direct = psync._tone_mags(yr, yi, etr, eti).numpy()
        np.testing.assert_allclose(p[:, :, k], direct, rtol=2e-4, atol=2e-3)


def test_jitter_offsets_equal_jax():
    for quick in (True, False):
        for iifac in (1, 3, 5):
            np.testing.assert_array_equal(
                psync.jitter_offsets(iifac, quick),
                jsync.jitter_offsets(iifac, quick))


def test_lane_variants_match_jax_per_window(rng):
    """fine_sync_lanes / soft_symbols_lanes over lanes that span two
    windows against the JAX package's per-window fine_sync and
    soft_symbols_jittered: fine shift and freq identical, sync within
    1e-5, soft symbols identical (random windows, quickmode)."""
    B = 2
    sig_i = rng.normal(0, .1, (B, 45000)).astype(np.float32)
    sig_q = rng.normal(0, .1, (B, 45000)).astype(np.float32)
    lane_w = np.repeat(np.arange(B), 2)
    freq = np.linspace(-80, 90, 2 * B).astype(np.float32)
    shift = (np.arange(2 * B) * 313 - 500).astype(np.int32)
    drift = np.linspace(-2, 2, 2 * B).astype(np.float32)

    fl = psync.fine_sync_lanes(_t(sig_i), _t(sig_q), _t(lane_w), _t(freq),
                               _t(shift), _t(drift), lagstep=16)
    jl = psync.soft_symbols_lanes(_t(sig_i), _t(sig_q), _t(lane_w), fl.freq,
                                  fl.shift, _t(drift), quickmode=True)
    for b in range(B):
        m = lane_w == b
        fw = jsync.fine_sync(jnp.asarray(sig_i[b]), jnp.asarray(sig_q[b]),
                             jnp.asarray(freq[m]), jnp.asarray(shift[m]),
                             jnp.asarray(drift[m]), lagstep=16)
        jw = jsync.soft_symbols_jittered(
            jnp.asarray(sig_i[b]), jnp.asarray(sig_q[b]), fw.freq, fw.shift,
            jnp.asarray(drift[m]), quickmode=True)
        np.testing.assert_array_equal(fl.shift.numpy()[m], np.asarray(fw.shift))
        np.testing.assert_array_equal(fl.freq.numpy()[m], np.asarray(fw.freq))
        np.testing.assert_allclose(fl.sync.numpy()[m], np.asarray(fw.sync),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(jl.symbols.numpy()[:, m],
                                      np.asarray(jw.symbols))


@pytest.fixture(scope="module")
def lanes():
    """Stage-A lanes of the 3-window batch (the JAX package's stage A),
    padded to a 16-lane bucket."""
    wi, wq = windows3()
    B = wi.shape[0]
    sA = np.asarray(jmc._stage_a_packed(
        jnp.asarray(wi), jnp.asarray(wq), jnp.full((B,), 4, jnp.int32),
        fmin=-110.0, fmax=110.0))
    wa, cc = np.nonzero(sA[:, 1] != 0)
    n, G = wa.size, 16
    lw = np.zeros(G, np.int32)
    lf = np.zeros(G, np.float32)
    ls = np.zeros(G, np.int32)
    ld = np.zeros(G, np.float32)
    lv = np.zeros(G, bool)
    lw[:n], lf[:n] = wa, sA[wa, 2, cc]
    ls[:n], ld[:n], lv[:n] = sA[wa, 3, cc].astype(np.int32), sA[wa, 4, cc], True
    return wi, wq, (lw, lf, ls, ld, lv)


@pytest.mark.parametrize("quickmode", [True, False])
def test_stage_b_packed_matches_jax(lanes, quickmode):
    """The packed stage B: fine freq and shift identical, sync within
    1e-5, gate masks and prefetched jitter indices identical, and the
    deinterleaved uint8 soft symbols identical except for +-1 flips where
    floor(fs + 128) sits on an integer boundary. Measured: 0 flips of
    10,368 symbols (quickmode) and 1 of 445,824 (43-jitter schedule); the
    bound is 1 in 10^4, and no flip may exceed 1."""
    wi, wq, lane_arrays = lanes
    kw = dict(lagstep=16 if quickmode else 8, iifac=3, quickmode=quickmode,
              symfac=50, minsync1=0.10, minsync2=0.12, minrms=52.0 * 50 / 64)
    ref = [np.asarray(x) for x in jmc._stage_b_packed(
        jnp.asarray(wi), jnp.asarray(wq),
        *(jnp.asarray(a) for a in lane_arrays), **kw)]
    got = [x.numpy() for x in pmc._stage_b_packed(
        _t(wi), _t(wq), *(_t(a) for a in lane_arrays), **kw)]
    np.testing.assert_array_equal(got[0][:2], ref[0][:2])
    np.testing.assert_allclose(got[0][2], ref[0][2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    assert ref[1].any()  # some attempts pass the gates
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[3].dtype == got[4].dtype == np.uint8
    flips = got[4].astype(int) - ref[4].astype(int)
    assert np.abs(flips).max() <= 1
    assert np.count_nonzero(flips) <= 1e-4 * flips.size
    pre = got[3].astype(int) - ref[3].astype(int)
    assert np.abs(pre).max() <= 1
    assert np.count_nonzero(pre) <= 1e-4 * pre.size


def test_compact_lane_columns_matches_jax():
    """Full jitter columns of chosen lanes, exactly."""
    rng = np.random.default_rng(6)
    deint = rng.integers(0, 256, (5, 16, 162), dtype=np.uint8)
    sel = np.array([3, 0, 3, 15])
    got = pmc._compact_lane_columns(_t(deint), _t(sel.astype(np.int64)))
    ref = jmc._compact_lane_columns(jnp.asarray(deint),
                                    jnp.asarray(sel.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

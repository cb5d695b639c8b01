"""Port coherent subtraction against the JAX package: the half-sine FIR,
the continuous-phase reference, subtract_signal2 and the batched
subtract_rows with its padding lanes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.ops import subtract as jsub
from rtlsdr_wsprd_tpu.utils.channel import get_wspr_channel_symbols
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable
from rtlsdr_wsprd_tpu_torch.ops import subtract as psub

SYMS = get_wspr_channel_symbols("K1JT FN20 37", WsprHashTable())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_fir_same_matches_jax(rng):
    """The block-Toeplitz 360-tap FIR, batched: within 1e-6 (float32
    matmul sums in another order, unit-scale input)."""
    x = rng.normal(0, 1, (2, 45000)).astype(np.float32)
    got = psub._fir_same(_t(x)).numpy()
    for r in range(2):
        np.testing.assert_allclose(got[r], np.asarray(jsub._fir_same(
            jnp.asarray(x[r]))), rtol=0, atol=1e-6)


def test_reference_signal_matches_jax():
    """The 4-FSK reference r(t). Its phase is a float32 running sum that
    reaches ~7e4 rad, where one float32 ulp is ~8e-3 rad, and the two
    packages sum in another order: agreement within 5e-3 per sample."""
    rr, ri = psub._reference_signal(_t(np.float32([12.0])),
                                    _t(np.float32([0.5])), _t(SYMS[None]))
    jr, ji = jsub._reference_signal(jnp.float32(12.0), jnp.float32(0.5),
                                    jnp.asarray(SYMS))
    np.testing.assert_allclose(rr[0].numpy(), np.asarray(jr), rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(ri[0].numpy(), np.asarray(ji), rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("shift", [400, -700, 3000])
def test_subtract_signal2_matches_jax(rng, shift):
    """One row, shifts inside and across the window's edges: within 1e-4
    of the JAX result (the removed component is ~2e-2; see the phase
    note of test_reference_signal_matches_jax)."""
    ci = rng.normal(0, .1, 45000).astype(np.float32)
    cq = rng.normal(0, .1, 45000).astype(np.float32)
    pi, pq = psub.subtract_signal2(
        _t(ci[None]), _t(cq[None]), _t(np.float32([12.0])),
        _t(np.int32([shift])), _t(np.float32([0.5])), _t(SYMS[None]))
    ji, jq = jsub.subtract_signal2(jnp.asarray(ci), jnp.asarray(cq),
                                   jnp.float32(12.0), jnp.int32(shift),
                                   jnp.float32(0.5), jnp.asarray(SYMS))
    np.testing.assert_allclose(pi[0].numpy(), np.asarray(ji), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pq[0].numpy(), np.asarray(jq), rtol=0,
                               atol=1e-4)


def test_subtract_rows_matches_jax_with_padding(rng):
    """Three lanes over a 3-row batch: two enabled lanes on rows 2 and 0,
    and a disabled padding lane that shares row 0. The update is added
    as a delta, so the padding lane changes nothing; row 1 is untouched
    bit for bit; the updated rows are within 1e-4 of the JAX package's
    subtract_rows."""
    B = 3
    cur_i = rng.normal(0, .1, (B, 45000)).astype(np.float32)
    cur_q = rng.normal(0, .1, (B, 45000)).astype(np.float32)
    args = (np.array([2, 0, 0], np.int32),
            np.array([12.0, -30.0, 0.0], np.float32),
            np.array([400, 900, 0], np.int32),
            np.array([0.5, -1.0, 0.0], np.float32),
            np.stack([SYMS, SYMS, np.zeros(162, np.uint8)]),
            np.array([True, True, False]))
    pi, pq = psub.subtract_rows(_t(cur_i), _t(cur_q), *(_t(a) for a in args))
    ji, jq = jsub.subtract_rows(jnp.asarray(cur_i), jnp.asarray(cur_q),
                                *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=0, atol=1e-4)
    assert np.array_equal(pi[1].numpy(), cur_i[1])
    # the padding lane does not clobber row 0's update
    one, _ = psub.subtract_signal2(
        _t(cur_i[:1]), _t(cur_q[:1]), _t(args[1][1:2]), _t(args[2][1:2]),
        _t(args[3][1:2]), _t(args[4][1:2]))
    np.testing.assert_allclose(pi[0].numpy(), one[0].numpy(), rtol=0,
                               atol=1e-6)
    assert not np.allclose(pi[0].numpy(), cur_i[0])
    # inputs are not modified
    assert not np.shares_memory(pi.numpy(), cur_i)

"""Port front end against the JAX package: constant tables, the stage-1
and stage-2 polyphase decimator (the CUDA kernel's plain version on the
CPU), the one-shot and streaming decimators."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.frontend import decimate as jdec
from rtlsdr_wsprd_tpu.frontend.filters import R1, R2, STAGE1_TAPS, STAGE2_TAPS
from rtlsdr_wsprd_tpu.frontend.pallas_decimate import decimate_stage1_pallas
from rtlsdr_wsprd_tpu_torch import convert
from rtlsdr_wsprd_tpu_torch.frontend import decimate as pdec
from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
    polyphase_decimate,
    polyphase_plain,
)

from torch_parity import CPU


def _jax_tables() -> dict:
    """The JAX package's constant tables under the port's names."""
    from rtlsdr_wsprd_tpu.frontend.filters import (
        conv_order,
        stage1_coeffs,
        stage2_coeffs,
    )
    from rtlsdr_wsprd_tpu.ops import coarse, fano, stft, sync

    h1t, h1b, h2t, h2b = jdec._pp_mats()
    g1 = conv_order(stage1_coeffs())
    g2 = conv_order(stage2_coeffs().astype(np.complex64))
    out = {
        "frontend.stage1.htop": h1t, "frontend.stage1.hbot": h1b,
        "frontend.stage2.htop": h2t, "frontend.stage2.hbot": h2b,
        "frontend.stage1.taps_re": np.real(g1).astype(np.float32),
        "frontend.stage1.taps_im": np.imag(g1).astype(np.float32),
        "frontend.stage2.taps_re": np.real(g2).astype(np.float32),
        "frontend.stage2.taps_im": np.imag(g2).astype(np.float32),
        "ops.stft.hann": stft.HANN,
        "ops.stft.dft_cos": stft._DFT_COS, "ops.stft.dft_sin": stft._DFT_SIN,
        "ops.coarse.weights": coarse._W,
        "ops.fano.mettab": fano.build_mettab(),
    }
    for name, offs in convert.tone_offsets().items():
        tr, ti = sync._offset_tone_matrix(offs)
        out[f"ops.sync.tone_re.{name}"] = tr
        out[f"ops.sync.tone_im.{name}"] = ti
    return out


def test_tables_equal_jax_bit_for_bit():
    """Every constant table of the port equals the JAX package's exactly
    (same dtype, same bits): the copied filter design, DFT, coarse
    weights, tone matrices and Fano metric table."""
    mine = convert.state_dict()
    ref = _jax_tables()
    assert set(mine) == set(ref)
    for name in ref:
        assert mine[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(mine[name], ref[name], err_msg=name)


def test_load_state_dict_runs_port_from_jax_tables():
    """Loading the JAX package's tables into the port leaves its output
    unchanged (they are equal) and rejects a table of another shape;
    a perturbed stage-1 table changes the output, so the load is live."""
    rng = np.random.default_rng(4)
    n = 50
    L = n * R1 + STAGE1_TAPS - R1
    xI = torch.from_numpy(rng.normal(0, 1, L).astype(np.float32))
    xQ = torch.from_numpy(rng.normal(0, 1, L).astype(np.float32))
    before = pdec.decimate_stage1(xI, xQ, n, device=CPU)[0].clone()
    saved = convert.state_dict()
    try:
        convert.load_state_dict(_jax_tables())
        after = pdec.decimate_stage1(xI, xQ, n, device=CPU)[0]
        torch.testing.assert_close(after, before, rtol=0, atol=0)
        bumped = dict(saved)
        bumped["frontend.stage1.htop"] = saved["frontend.stage1.htop"] * 2
        convert.load_state_dict(bumped)
        changed = pdec.decimate_stage1(xI, xQ, n, device=CPU)[0]
        assert not torch.equal(changed, before)
        with pytest.raises(ValueError):
            convert.load_state_dict(
                {"ops.stft.hann": np.zeros(3, np.float32)})
        with pytest.raises(KeyError):
            convert.load_state_dict({"no.such.table": np.zeros(1)})
    finally:
        convert.load_state_dict(saved)
    assert torch.equal(pdec.decimate_stage1(xI, xQ, n, device=CPU)[0],
                       before)


def test_hashtable_contents_cross_over():
    from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable

    jht = WsprHashTable()
    jht.put(123, "K1JT", "FN20")
    jht.put(32767, "VK2XYZ")
    jht.put(5, "PJ4/K1ABC", "AB12")
    state = convert.hashtable_state(jht)
    pht = convert.hashtable_from_state(state)
    assert convert.hashtable_state(pht).keys() == state.keys()
    for k in (123, 32767, 5, 6):
        assert pht.get_call(k) == jht.get_call(k)
        assert pht.get_grid(k) == jht.get_grid(k)
    assert len(pht) == len(jht)


def test_stage1_float_matches_xla_and_pallas():
    """700 frames (more than one Pallas program of 512), float32 N(0,1):
    within 1e-4 of both the XLA partial-product path and the Pallas
    kernel in interpret mode, the tolerance the JAX package holds those
    two to (float32 sums over 640 taps taken in another order)."""
    rng = np.random.default_rng(5)
    n = 700
    L = n * R1 + STAGE1_TAPS - R1
    i = rng.normal(0, 1, L).astype(np.float32)
    q = rng.normal(0, 1, L).astype(np.float32)
    pI, pQ = pdec.decimate_stage1(i, q, n, device=CPU)
    xI, xQ = jdec.decimate_stage1_xla(jnp.asarray(i), jnp.asarray(q), n)
    kI, kQ = decimate_stage1_pallas(jnp.asarray(i), jnp.asarray(q), n,
                                    interpret=True)
    for ref in ((xI, xQ), (kI, kQ)):
        np.testing.assert_allclose(pI.numpy(), np.asarray(ref[0]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(pQ.numpy(), np.asarray(ref[1]), rtol=0,
                                   atol=1e-4)


def test_stage1_uint8_batched_matches_xla():
    """Raw uint8 rows (3, L), centred inside the call: within 1e-3 of
    the XLA path (the +-128 input scale makes the float32 rounding of a
    640-tap sum about 128x that of N(0,1) input)."""
    rng = np.random.default_rng(17)
    n = 400
    L = n * R1 + STAGE1_TAPS - R1
    u8I = rng.integers(0, 256, (3, L), dtype=np.uint8)
    u8Q = rng.integers(0, 256, (3, L), dtype=np.uint8)
    pI, pQ = pdec.decimate_stage1(u8I, u8Q, n, device=CPU)
    assert pI.shape == (3, n) and pI.dtype == torch.float32
    xI, xQ = jdec.decimate_stage1_xla(jnp.asarray(u8I), jnp.asarray(u8Q), n)
    np.testing.assert_allclose(pI.numpy(), np.asarray(xI), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pQ.numpy(), np.asarray(xQ), rtol=0, atol=1e-3)
    # uint8 in == host-centred float32 in, exactly (same subtract-128)
    fI, fQ = pdec.decimate_stage1(u8I.astype(np.float32) - 128.0,
                                  u8Q.astype(np.float32) - 128.0, n,
                                  device=CPU)
    assert torch.equal(fI, pI) and torch.equal(fQ, pQ)


def test_stage2_matches_xla():
    """Real 2400-tap stage 2 on float32 N(0,30) mid-rate rows: within
    1e-4 relative to the output scale (float32 sums over 2400 taps)."""
    rng = np.random.default_rng(8)
    n = 60
    L = n * R2 + STAGE2_TAPS - R2
    i = rng.normal(0, 30, (2, L)).astype(np.float32)
    q = rng.normal(0, 30, (2, L)).astype(np.float32)
    pI, pQ = pdec.decimate_stage2(i, q, n, device=CPU)
    xI, xQ = jdec.decimate_stage2_xla(jnp.asarray(i), jnp.asarray(q), n)
    scale = float(np.abs(np.asarray(xI)).max())
    np.testing.assert_allclose(pI.numpy(), np.asarray(xI), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(pQ.numpy(), np.asarray(xQ), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_decimate_window_matches_jax(dtype):
    """One-shot 2.4 Msps -> 375 sps of 400 output samples: same length,
    within 2e-4 relative to the output scale (two float32 stages)."""
    rng = np.random.default_rng(9)
    n_raw = 6400 * 400
    if dtype == np.uint8:
        i = rng.integers(0, 256, n_raw, dtype=np.uint8)
        q = rng.integers(0, 256, n_raw, dtype=np.uint8)
    else:
        i = rng.normal(0, 20, n_raw).astype(np.float32)
        q = rng.normal(0, 20, n_raw).astype(np.float32)
    pI, pQ = pdec.decimate_window(i, q, device=CPU)
    jI, jQ = jdec.decimate_window(i, q)
    assert pI.shape == jI.shape and pI.dtype == np.float32
    scale = float(np.abs(jI).max())
    np.testing.assert_allclose(pI, jI, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(pQ, jQ, rtol=0, atol=2e-4 * scale)


def _chunks(C, sizes, seed):
    rng = np.random.default_rng(seed)
    ci = [rng.integers(0, 256, (C, n), dtype=np.uint8) for n in sizes]
    cq = [rng.integers(0, 256, c.shape, dtype=np.uint8) for c in ci]
    return ci, cq


def _drain(dec, ci, cq, axis):
    outs = [dec.push(a, b) for a, b in zip(ci, cq)]
    outs.append(dec.flush())
    return (np.concatenate([o[0] for o in outs], axis=axis),
            np.concatenate([o[1] for o in outs], axis=axis))


def test_streaming_matches_jax():
    """StreamingDecimator on ragged uint8 chunks, flush included: the
    same number of samples as the JAX one, within 2e-4 relative."""
    ci, cq = _chunks(1, (700_000, 137, 500_000, 900_000), seed=9)
    ci, cq = [c[0] for c in ci], [c[0] for c in cq]
    pI, pQ = _drain(pdec.StreamingDecimator(device=CPU), ci, cq, 0)
    jI, jQ = _drain(jdec.StreamingDecimator(), ci, cq, 0)
    assert pI.shape == jI.shape and pI.shape[0] > 300
    scale = float(np.abs(jI).max())
    np.testing.assert_allclose(pI, jI, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(pQ, jQ, rtol=0, atol=2e-4 * scale)


def test_batched_streaming_matches_jax():
    """BatchedStreamingDecimator (fused stage-1+2 step, device-resident
    mid-rate carry) on ragged uint8 (C=2) chunks, flush included,
    against the JAX one: same shape, within 2e-4 relative; and each row
    equals the port's own single-channel StreamingDecimator within the
    same tolerance."""
    C = 2
    ci, cq = _chunks(C, (700_000, 500_000, 900_000), seed=9)
    pI, pQ = _drain(pdec.BatchedStreamingDecimator(C, device=CPU), ci, cq, 1)
    jI, jQ = _drain(jdec.BatchedStreamingDecimator(C), ci, cq, 1)
    assert pI.shape == jI.shape == (C, pI.shape[1]) and pI.shape[1] > 300
    scale = float(np.abs(jI).max())
    np.testing.assert_allclose(pI, jI, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(pQ, jQ, rtol=0, atol=2e-4 * scale)
    for c in range(C):
        sI, sQ = _drain(pdec.StreamingDecimator(device=CPU),
                        [x[c] for x in ci], [x[c] for x in cq], 0)
        np.testing.assert_allclose(pI[c], sI, rtol=0, atol=2e-4 * scale)
        np.testing.assert_allclose(pQ[c], sQ, rtol=0, atol=2e-4 * scale)


def test_wrapper_takes_plain_version_only_on_cpu():
    """On CPU tensors the wrapper is the plain version (no launch is
    counted); on another device it raises."""
    rng = np.random.default_rng(2)
    n = 20
    L = n * R1 + STAGE1_TAPS - R1
    x = torch.from_numpy(rng.integers(0, 256, (2, L), dtype=np.uint8))
    before = polyphase_decimate.launches
    a = polyphase_decimate(x, x, pdec.STAGE1, n)
    b = polyphase_plain(x, x, pdec.STAGE1, n)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert polyphase_decimate.launches == before
    with pytest.raises(ValueError):
        polyphase_decimate(x.to("meta"), x.to("meta"), pdec.STAGE1, n)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The hand-written CUDA kernel against its plain version on the
    card, uint8 stage 1 and float32 stage 2: within 1e-3 (float32 sums
    in another order at +-128 input scale). Runs only with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    rng = np.random.default_rng(3)
    for filt, n, u8 in ((pdec.STAGE1, 8000, True), (pdec.STAGE2, 100, False)):
        L = n * filt.R + filt.T - filt.R
        if u8:
            h = rng.integers(0, 256, (2, 8, L), dtype=np.uint8)
        else:
            h = rng.normal(0, 10, (2, 8, L)).astype(np.float32)
        xI, xQ = (torch.from_numpy(a).cuda() for a in h)
        before = polyphase_decimate.launches
        kI, kQ = polyphase_decimate(xI, xQ, filt, n)
        assert polyphase_decimate.launches == before + 1
        pI, pQ = polyphase_plain(xI, xQ, filt, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(kI, pI, rtol=0, atol=1e-3)
        torch.testing.assert_close(kQ, pQ, rtol=0, atol=1e-3)

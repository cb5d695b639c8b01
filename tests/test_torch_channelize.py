"""The port's wideband channelizer against the JAX package's, on the CPU:
the folded taps, the device placement (the plain versions of the
polyphase kernels' filter bank), the host placement, the float32 carry,
the zero-offset channel, and the filter-bank form of the polyphase
wrapper."""

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu import native as jnative
from rtlsdr_wsprd_tpu.frontend import channelize as jch
from rtlsdr_wsprd_tpu_torch.frontend import channelize as pch
from rtlsdr_wsprd_tpu_torch.frontend import decimate as pdec
from rtlsdr_wsprd_tpu_torch.frontend.filters import R1
from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
    PolyphaseFilter,
    _route,
    polyphase_decimate,
    polyphase_plain,
)

from torch_parity import CPU

# chunk sizes that hit the carry-append branch (137, 63: no whole
# stage-1 frame of their own) and the stitch branch (frames straddling
# the carry and the chunk), then a flush
SIZES = (900_000, 137, 700_123, 63, 800_000)
OFFSETS = [0.0, 50_000.0]


def _chunks(seed: int, sizes=SIZES, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if dtype == np.uint8:
            ci, cq = rng.integers(0, 256, (2, 1, n)).astype(np.uint8)
        else:
            ci, cq = rng.normal(0, 30, (2, 1, n)).astype(np.float32)
        out.append((ci, cq))
    return out


def _run(dec, chunks):
    outs = [dec.push(ci, cq) for ci, cq in chunks]
    outs.append(dec.flush())
    return (np.concatenate([o[0] for o in outs], axis=1),
            np.concatenate([o[1] for o in outs], axis=1))


def _assert_close(got, want, rel):
    """Planes equal in shape, within ``rel`` of the reference's scale."""
    assert got[0].shape == want[0].shape
    scale = float(np.abs(want[0]).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def test_folded_taps_equal_jax():
    offs = np.array([0.0, -338_200.0, -1_700_600.0, 50_000.0])
    np.testing.assert_array_equal(pch.folded_stage1_taps(offs),
                                  jch.folded_stage1_taps(offs))


def test_device_placement_matches_jax():
    """K = 2 dials 50 kHz apart through the device placement (on the CPU:
    the filter bank's plain version) equal JAX's device placement within
    2e-4 of the output scale (float32 sums in another order, and the
    flush remainder rotated from a larger frame index), output length
    included."""
    chunks = _chunks(37)
    got = _run(pch.ChannelizingStreamingDecimator(OFFSETS, device=CPU),
               chunks)
    want = _run(jch.ChannelizingStreamingDecimator(OFFSETS,
                                                   placement="device"),
                chunks)
    assert got[0].shape[0] == 2 and got[0].shape[1] > 0
    _assert_close(got, want, 2e-4)


def test_zero_offset_equals_plain_decimator():
    """A zero-offset dial is the plain batched front end: the carried
    unit phasor does not perturb the tuned dial (within 1e-5 of scale)."""
    chunks = _chunks(31, (900_000, 700_123))
    got = _run(pch.ChannelizingStreamingDecimator([0.0], device=CPU), chunks)
    want = _run(pdec.BatchedStreamingDecimator(1, device=CPU), chunks)
    _assert_close(got, want, 1e-5)


def test_host_placement_matches_device_and_jax():
    """The host placement (native C++ polyphase, folded taps, dials on
    threads) equals the device placement, and JAX's host placement
    (its device placement where the JAX package's native library is
    not built), within 2e-4 of scale."""
    chunks = _chunks(37)
    host = _run(pch.ChannelizingStreamingDecimator(OFFSETS,
                                                   placement="host"), chunks)
    dev = _run(pch.ChannelizingStreamingDecimator(OFFSETS, device=CPU),
               chunks)
    _assert_close(host, dev, 2e-4)
    jplace = "host" if jnative.HAS_DECIMATE else "device"
    ref = _run(jch.ChannelizingStreamingDecimator(OFFSETS, placement=jplace),
               chunks)
    _assert_close(host, ref, 2e-4)


@pytest.mark.parametrize("placement", ["device", "host"])
def test_float32_carry_matches_jax(placement):
    """A float32 chunk after uint8 ones upconverts the uint8 carry once;
    uint8 chunks after it are centred onto the float carry. Both
    placements equal JAX's device placement within 2e-4 of scale."""
    u8 = _chunks(41, (300_000, 77))
    f32 = _chunks(43, (250_001,), np.float32)
    chunks = u8 + f32 + _chunks(47, (200_000,))
    kw = dict(device=CPU) if placement == "device" else {}
    dec = pch.ChannelizingStreamingDecimator(OFFSETS, placement=placement,
                                             **kw)
    got = _run(dec, chunks)
    assert dec._bufI.dtype == np.float32
    want = _run(jch.ChannelizingStreamingDecimator(OFFSETS,
                                                   placement="device"),
                chunks)
    _assert_close(got, want, 2e-4)


def test_refuses_more_than_one_stream():
    dec = pch.ChannelizingStreamingDecimator(OFFSETS, device=CPU)
    x = np.zeros((2, 1000), np.uint8)
    with pytest.raises(ValueError, match="ONE raw stream"):
        dec.push(x, x)
    with pytest.raises(ValueError, match="placement"):
        pch.ChannelizingStreamingDecimator(OFFSETS, placement="tpu")


def _bank(offsets):
    g = pch.folded_stage1_taps(np.asarray(offsets))
    return [PolyphaseFilter(gk.astype(np.complex64), R1) for gk in g]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_plain_bank_equals_single_filter_calls(dtype):
    """polyphase_plain through a bank of K = 3 folded filters over one
    stream expanded to K rows (row stride 0) equals K single-filter
    calls, bit for bit; the wrapper on CPU tensors is that plain
    version, and a one-filter call over the K rows is unchanged."""
    rng = np.random.default_rng(5)
    n = 37
    L = n * R1 + 640 - R1
    if dtype == "uint8":
        h = rng.integers(0, 256, (2, L), dtype=np.uint8)
    else:
        h = rng.normal(0, 10, (2, L)).astype(np.float32)
    xI, xQ = (torch.from_numpy(a) for a in h)
    bank = _bank([0.0, -338_200.0, -1_700_600.0])
    K = len(bank)
    bI, bQ = polyphase_plain(xI.expand(K, L), xQ.expand(K, L), bank, n)
    for k, f in enumerate(bank):
        sI, sQ = polyphase_plain(xI, xQ, f, n)
        assert torch.equal(bI[k], sI) and torch.equal(bQ[k], sQ)
    wI, wQ = polyphase_decimate(xI.expand(K, L), xQ.expand(K, L), bank, n)
    assert torch.equal(wI, bI) and torch.equal(wQ, bQ)
    oI, _ = polyphase_plain(xI.expand(K, L), xQ.expand(K, L), bank[1], n)
    assert all(torch.equal(oI[k], polyphase_plain(xI, xQ, bank[1], n)[0])
               for k in range(K))


def test_bank_routes_and_refuses():
    """A bank of folded stage-1 filters routes like one: uint8 to the
    tensor-core kernel, float32 to polyphase.cu; a bank that mixes
    shapes, holds no filter or does not match the rows raises."""
    bank = _bank([0.0, 50_000.0])
    assert _route("cuda", torch.uint8, bank) == "tc"
    assert _route("cuda", torch.float32, bank) == "direct"
    with pytest.raises(ValueError, match="one \\(T, R\\)"):
        _route("cuda", torch.float32, [pdec.STAGE1, pdec.STAGE2])
    with pytest.raises(ValueError, match="uint8 planes need"):
        _route("cuda", torch.uint8, [pdec.STAGE2, pdec.STAGE2])
    with pytest.raises(TypeError):
        _route("cuda", torch.uint8, [])
    x = torch.zeros((3, 640), dtype=torch.float32)
    with pytest.raises(ValueError, match="bank of 2 filters"):
        polyphase_plain(x, x, bank, 1)


@pytest.mark.cuda
def test_bank_kernels_match_plain_on_cuda():
    """Both kernels through a bank of K = 3 folded filters over one
    stream (row stride 0) against the plain bank version on the card,
    one launch each, within 1e-3; a stride-0 call (one filter) equals
    the bank call whose rows all hold that filter, bit for bit. Runs
    only with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    rng = np.random.default_rng(9)
    bank = _bank([0.0, -338_200.0, -1_700_600.0])
    K, n = len(bank), 24_000
    L = n * R1 + 640 - R1
    for u8, route in ((True, "tc"), (False, "direct")):
        h = (rng.integers(0, 256, (2, L), dtype=np.uint8) if u8 else
             rng.normal(0, 10, (2, L)).astype(np.float32))
        xI, xQ = (torch.from_numpy(a).cuda().expand(K, L) for a in h)
        before = polyphase_decimate.launches[route]
        kI, kQ = polyphase_decimate(xI, xQ, bank, n)
        assert polyphase_decimate.launches[route] == before + 1
        pI, pQ = polyphase_plain(xI, xQ, bank, n)
        torch.testing.assert_close(kI, pI, rtol=0, atol=1e-3)
        torch.testing.assert_close(kQ, pQ, rtol=0, atol=1e-3)
        one = polyphase_decimate(xI, xQ, bank[1], n)
        same = polyphase_decimate(xI, xQ, [bank[1]] * K, n)
        assert torch.equal(one[0], same[0]) and torch.equal(one[1], same[1])


@pytest.mark.slow
def test_wideband_daemon_two_dials_end_to_end():
    """The wideband daemon on the CPU: TWO WSPR dials 50 kHz apart from
    ONE raw 2.4 Msps capture (122 s), channelized, windowed and decoded;
    each dial's message decodes on its own channel at its own audio
    frequency (+-0.5 Hz), as the JAX package's wideband daemon test."""
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.runtime.banks import WidebandSyntheticRawBank
    from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon

    d0, d1 = 14_095_600, 14_045_600
    bank = WidebandSyntheticRawBank(
        [("K1JT FN20QI 20", d0, 30.0, 25.0),
         ("W1AW FN31 30", d1, -40.0, 25.0)],
        tuned_dial=d0, noise_counts=3.0, duration_s=122.0)
    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True, freq=d0),
                           device_batch=2, fec="host", channelize=[d0, d1],
                           frontend="device", device=CPU)
    out = d.run()
    assert d.stats.errors == 0 and len(out) == 1 and len(out[0]) == 2
    f0 = next(s for s in out[0][0] if s.call == "K1JT")
    f1 = next(s for s in out[0][1] if s.call == "W1AW")
    assert (f0.loc, f0.pwr, f1.loc, f1.pwr) == ("FN20", "20", "FN31", "30")
    assert abs(f0.freq * 1e6 - (d0 + 1500 + 30.0)) < 0.5
    assert abs(f1.freq * 1e6 - (d1 + 1500 - 40.0)) < 0.5

"""The plain reference: its Fano decoder against the port's native one,
its decode against the port's plain CPU decode and against the planted
messages, and the raw front end against its own messages."""

import numpy as np
import pytest
import torch

from wsprbench import gen
from wsprbench.reference.decode import decode_window, quantize
from wsprbench.reference.fano import METTAB, fano
from wsprbench.run import load_cell


def test_fano_matches_the_native_decoder():
    native = pytest.importorskip("rtlsdr_wsprd_tpu_torch.native")
    from rtlsdr_wsprd_tpu_torch.ops.fano import METTAB as PM
    from rtlsdr_wsprd_tpu_torch.utils.channel import conv_encode
    assert np.array_equal(METTAB, PM)
    rng = np.random.default_rng(5)
    cases = [rng.integers(0, 256, 162).astype(np.uint8) for _ in range(12)]
    for _ in range(6):  # clean codewords, a few symbols flipped
        data = np.zeros(11, np.uint8)
        data[:6] = rng.integers(0, 256, 6)
        data[6] = rng.integers(0, 256) & 0xC0
        enc = conv_encode(bytes(data), 11)[:162]
        s = np.where(enc == 1, 220, 35).astype(np.uint8)
        s[rng.integers(0, 162, 12)] ^= 0xFF
        cases.append(s)
    for s in cases:
        for mc in (40, 400):
            a = fano(s, 60, mc)
            b = native.fano_decode(s, PM, 60, mc)
            assert a[0] == b[0] and a[2] == b[2]
            if a[0]:
                assert a[1] == bytes(b[1])


def test_quantize_matches_the_int8_link():
    native = pytest.importorskip("rtlsdr_wsprd_tpu_torch.native")
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.6, 0.6, 4096).astype(np.float32)
    x[:3] = [np.nan, 0.5 / 254 * 3, -0.5 / 254 * 5]
    q = np.zeros(x.size, np.int8)
    native.quantize_into(x, q, np.float32(254.0))
    want = q.astype(np.float32) * (np.float32(1.0) / np.float32(254.0))
    assert np.array_equal(quantize(x), want)


def test_reference_decode_equals_the_port_plain_decode():
    mc = pytest.importorskip("rtlsdr_wsprd_tpu_torch.parallel.multichannel")
    mix = dict(load_cell("farm.mixed").mix, windows=4)
    pool = gen.baseband(mix, 77)
    prog = mc.decode_channels(pool.wi, pool.wq, device="cpu", fec="host",
                              device_batch=4)
    for w in range(4):
        ref = decode_window(quantize(pool.wi[w]), quantize(pool.wq[w]))
        assert {s["message"] for s in ref} == pool.truth[w]
        got = [(s.message, s.snr, s.freq, s.dt, s.drift, s.cycles, s.jitter)
               for s in prog[w]]
        want = [(s["message"], s["snr"], s["freq"], s["dt"], s["drift"],
                 s["cycles"], s["jitter"]) for s in ref]
        assert got == want


def test_raw_capture_through_the_plain_front_end_decodes():
    """One dongle's 120 s capture made by the torch synthesizer, cut to
    375 sps by the reference front end, decodes to its messages."""
    from wsprbench.reference.frontend import steady_window
    mix = dict(load_cell("chain.raw").mix, windows=1)
    torch.set_num_threads(4)
    pool = gen.raw_capture(mix, 31, "cpu")
    wi, wq = steady_window(pool.raw_i[0], pool.raw_q[0])
    spots = decode_window(wi.numpy(), wq.numpy())
    assert {s["message"] for s in spots} == pool.truth[0]
    assert len(pool.truth[0]) == 2

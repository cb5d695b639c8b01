"""Shared inputs and helpers of the port's parity tests (tests/test_torch_*).

Inputs are made from a seed with numpy and handed to both packages: the
JAX package (forced to the CPU by tests/conftest.py) and the PyTorch
port with ``device="cpu"`` (its plain versions).
"""

from __future__ import annotations

import numpy as np
import pytest

from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

CPU = "cpu"


def windows3():
    """(B=3, 45000) planar windows: two overlapping signals (the weak
    one decodes only after pass 1's subtraction), one single signal,
    one noise only."""
    wins = []
    i, q = synth_window_at_snr(["K1JT FN20 37", "K9AN EN50 33"],
                               snr_db=[3.0, -12.0], f0=[-40.0, -35.0],
                               t0=[2.0, 1.0], seed=1)
    wins.append(normalize_minus3db(i, q))
    i, q = synth_window_at_snr("G4ABC IO91 30", snr_db=0.0, f0=30.0, seed=2)
    wins.append(normalize_minus3db(i, q))
    z = np.random.default_rng(3).normal(0, 1, (45000, 2)).astype(np.float32)
    wins.append(normalize_minus3db(z[:, 0], z[:, 1]))
    return (np.stack([w[0] for w in wins]), np.stack([w[1] for w in wins]))


@pytest.fixture()
def jax_host_fec(monkeypatch):
    """Pin the JAX package's FEC to the host decoder (no calibration
    run), and leave its calibration cache as it was found: empty."""
    from rtlsdr_wsprd_tpu.ops import calibrate

    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    calibrate._CACHE.clear()
    yield
    calibrate._CACHE.clear()


def spot_key(s):
    """The fields that must be equal between the two packages."""
    return (s.call, s.loc, s.pwr, s.message, s.jitter, s.cycles, s.drift,
            s.noprint, s.ihash)


def assert_spots_match(port, ref):
    """Spot lists equal in call, loc, pwr, message, jitter, cycles and
    drift; freq within 1e-7 MHz (0.1 Hz), dt within one sample (1/375
    s), snr within 0.01 dB and sync within 1e-4. The float tolerances
    cover float32 sums taken in another order; the shift and the fine
    frequency come out identical in practice."""
    assert [[spot_key(s) for s in ch] for ch in port] == \
        [[spot_key(s) for s in ch] for ch in ref]
    for pc, rc in zip(port, ref):
        for p, r in zip(pc, rc):
            assert p.freq == pytest.approx(r.freq, abs=1e-7)
            assert p.dt == pytest.approx(r.dt, abs=1.0 / 375.0)
            assert p.snr == pytest.approx(r.snr, abs=0.01)
            assert p.sync == pytest.approx(r.sync, abs=1e-4)

"""The port's FEC calibration (ops/calibrate.py) against the JAX
package's rule: overrides, the decision rule on given measurements, the
budget buckets, the banner, and the rule that without a CUDA device
nothing is measured."""

import logging

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu.ops import calibrate as jcal
from rtlsdr_wsprd_tpu_torch.ops import calibrate as pcal
from rtlsdr_wsprd_tpu_torch.ops.fano_hybrid import DEVICE_MAXCYCLES


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC", raising=False)
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", raising=False)
    pcal._CACHE.clear()
    yield
    pcal._CACHE.clear()


def _no_measuring(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("measured without a CUDA device")

    monkeypatch.setattr(pcal, "measure_device_fano_cycle_ms", boom)
    monkeypatch.setattr(pcal, "measure_native_fano_ms", boom)


def test_env_override(monkeypatch):
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "8")
    cal = pcal.get_fec_calibration()
    assert (cal.mode, cal.device_maxcycles, cal.method) == ("host", 8, "env")
    assert pcal.get_fec_calibration() is cal  # memoized


def test_malformed_env_budget_is_ignored(monkeypatch, caplog):
    """A typo'd RTLSDR_WSPRD_TPU_FEC_BUDGET warns and falls back to the
    default budget."""
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "banana")
    with caplog.at_level(logging.WARNING, "rtlsdr_wsprd_tpu_torch.calibrate"):
        cal = pcal.get_fec_calibration()
    assert (cal.mode, cal.device_maxcycles) == ("hybrid", DEVICE_MAXCYCLES)
    assert any("FEC_BUDGET" in r.message for r in caplog.records)


def test_device_budget_never_exceeds_full(monkeypatch):
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "64")
    assert pcal.device_fano_budget(10000) == 64
    assert pcal.device_fano_budget(4) == 4


@pytest.mark.parametrize("device", [None, "cpu"])
def test_no_cuda_device_resolves_to_host_unmeasured(monkeypatch, device):
    """Without a CUDA device (none present, or the CPU asked for) the
    mode is host, method 'default', and nothing is measured: the plain
    version is never timed as if it were the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_measuring(monkeypatch)
    cal = pcal.get_fec_calibration(device)
    assert (cal.mode, cal.method, cal.device_maxcycles) == \
        ("host", "default", DEVICE_MAXCYCLES)
    assert cal.device_cycle_ms == cal.native_timeout_ms == -1.0


@pytest.mark.parametrize("cyc_ms,mode,budget", [
    (3.0, "host", DEVICE_MAXCYCLES),   # 16 * 3.0 = 48 ms > 2 * 12 ms
    (0.12, "hybrid", 64),              # 12 / 0.12 = 100 -> 64
    (0.6, "hybrid", 16),               # 12 / 0.6 = 20 -> 16
    (0.01, "hybrid", 256),             # 12 / 0.01 = 1200 -> 256
])
def test_decision_rule(monkeypatch, cyc_ms, mode, budget):
    """On given measurements (a 12 ms native timeout) the port picks the
    mode and budget the JAX package's rule picks."""
    monkeypatch.setattr(pcal, "_cuda_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(pcal, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32: cyc_ms)
    monkeypatch.setattr(pcal, "measure_native_fano_ms", lambda: (0.03, 12.0))
    cal = pcal.get_fec_calibration()
    assert (cal.mode, cal.device_maxcycles, cal.method) == \
        (mode, budget, "measured")
    assert (cal.device_cycle_ms, cal.native_clean_ms,
            cal.native_timeout_ms) == (cyc_ms, 0.03, 12.0)
    monkeypatch.setattr(jcal, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32, unroll=None: cyc_ms)
    monkeypatch.setattr(jcal, "measure_native_fano_ms", lambda: (0.03, 12.0))
    monkeypatch.setattr(jcal, "_tunneled", lambda: False)
    monkeypatch.setattr(jcal, "_default_unroll", lambda: 2)
    jcal._CACHE.clear()
    try:
        ref = jcal.get_fec_calibration()
    finally:
        jcal._CACHE.clear()
    assert (ref.mode, ref.device_maxcycles) == (mode, budget)


def test_budget_buckets_equal_jax():
    for raw in np.concatenate([np.linspace(0, 400, 801), [1e9]]):
        assert pcal._bucket_budget(raw) == jcal._bucket_budget(raw), raw
    assert pcal._BUDGET_BUCKETS == jcal._BUDGET_BUCKETS == (16, 64, 256)


def test_describe_forms(monkeypatch):
    """Pinned, env, default (no card) and measured banners."""
    assert pcal.describe("host") == "host (pinned by caller)"
    assert pcal.describe("hybrid") == "hybrid (pinned by caller)"
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "64")
    s = pcal.describe()
    assert s == "hybrid (method=env, device budget=64 cycles)"
    pcal._CACHE.clear()
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC")
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC_BUDGET")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_measuring(monkeypatch)
    s = pcal.describe()
    assert s.startswith("host (method=default)")
    assert "no CUDA device" in s
    pcal._CACHE.clear()
    monkeypatch.setattr(pcal, "_cuda_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(pcal, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32: 0.0125)
    monkeypatch.setattr(pcal, "measure_native_fano_ms", lambda: (0.03, 12.0))
    assert pcal.describe() == (
        "hybrid (method=measured, device budget=256 cycles; device "
        "0.0125 ms/cycle, native clean 0.03 / timeout 12 ms)")


def test_device_measurement_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        pcal.measure_device_fano_cycle_ms("cpu")


def test_measure_native_fano_orders_sanely():
    clean_ms, timeout_ms = pcal.measure_native_fano_ms(maxcycles=500)
    assert 0 < clean_ms < timeout_ms

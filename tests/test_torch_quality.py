"""The port's decode-quality studies (tools/torch_snr_sweep.py,
torch_sensitivity_matrix.py, torch_crowded_band.py, torch_hash_census.py)
against the JAX package's tools, on the CPU: each builder gives the JAX
tool's windows bit for bit from the same seeds, and each decode function
gives what the JAX package's decode gives on the same windows."""

import numpy as np
import pytest

from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable as JHashTable
from rtlsdr_wsprd_tpu_torch.utils.hashtable import WsprHashTable

from torch_parity import CPU, import_tools
from torch_parity import jax_host_fec  # noqa: F401  (fixture)
from torch_parity import port_calibration  # noqa: F401  (fixture)


(jcrowded, jcensus, jmatrix, jsweep,
 pcrowded, pcensus, pmatrix, psweep) = import_tools(
    "crowded_band", "hash_census", "sensitivity_matrix", "snr_sweep",
    "torch_crowded_band", "torch_hash_census", "torch_sensitivity_matrix",
    "torch_snr_sweep")


def _jax_window(msg, rng, **kw):
    """One window as the JAX tools draw it: f0 ~ U(-100, 100), then the
    synthesis seed, over the JAX package's synthesis."""
    f0 = float(rng.uniform(-100, 100))
    i, q = synth_window_at_snr(msg, f0=f0, seed=int(rng.integers(1 << 30)),
                               **kw)
    return normalize_minus3db(i, q)


def _assert_windows(wi, wq, want):
    assert wi.shape == wq.shape == (len(want), 45000)
    for t, (ri, rq) in enumerate(want):
        np.testing.assert_array_equal(wi[t], ri)
        np.testing.assert_array_equal(wq[t], rq)


def test_sweep_windows_equal_jax():
    """tools/snr_sweep.py's loop (main), re-stated over the JAX package's
    synthesis: one window a point above the floor, two at and below
    -29 dB, every point of its SNR list."""
    assert (psweep.SNRS, psweep.MSG) == (jsweep.SNRS, jsweep.MSG)
    rng = np.random.default_rng(2026)
    got = list(psweep.build_windows(1, floor_trials=2))
    assert [g[0] for g in got] == jsweep.SNRS
    for snr, wi, wq in got:
        T = 2 if snr <= -29 else 1
        _assert_windows(wi, wq, [_jax_window(jsweep.MSG, rng,
                                             snr_db=float(snr))
                                 for _ in range(T)])


def test_matrix_windows_equal_jax():
    """tools/sensitivity_matrix.py's loop (main), re-stated over the JAX
    package's synthesis: one window a cell of the whole grid."""
    assert (pmatrix.DRIFTS, pmatrix.DTS) == (jmatrix.DRIFTS, jmatrix.DTS)
    rng = np.random.default_rng(20260820)
    cells = list(pmatrix.build_cells(1, -27.0))
    assert [(d, t) for d, t, _, _ in cells] == \
        [(d, t) for d in jmatrix.DRIFTS for t in jmatrix.DTS]
    for drift, t0, wi, wq in cells:
        _assert_windows(wi, wq, [_jax_window(jmatrix.MSG, rng, snr_db=-27.0,
                                             t0=t0, drift=drift)])


def test_crowded_windows_equal_jax():
    """random_message equals tools/crowded_band.py's on one seed stream,
    and the window builder equals its loop (main) re-stated over the
    JAX package's synthesis and its random_message."""
    assert pcrowded.PWRS == jcrowded.PWRS
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    pht, jht = WsprHashTable(), JHashTable()
    assert [pcrowded.random_message(a, pht) for _ in range(30)] == \
        [jcrowded.random_message(b, jht) for _ in range(30)]

    wi, wq, truth = pcrowded.build_windows(3, 12)
    rng = np.random.default_rng(424242)
    ht = JHashTable()
    want, want_truth = [], []
    for _ in range(3):
        k = int(rng.integers(4, 13))
        msgs, f0s, snrs, t0s = [], [], [], []
        used_f = []
        for _ in range(k):
            for _ in range(50):
                f = float(rng.uniform(-105, 105))
                if all(abs(f - u) > 4.0 for u in used_f):
                    break
            used_f.append(f)
            msgs.append(jcrowded.random_message(rng, ht))
            f0s.append(f)
            snrs.append(float(rng.uniform(-25.0, -3.0)))
            t0s.append(float(rng.uniform(0.0, 4.0)))
        i, q = synth_window_at_snr(msgs, snr_db=snrs, f0=f0s, t0=t0s,
                                   seed=int(rng.integers(1 << 30)))
        want.append(normalize_minus3db(i, q))
        want_truth.append(set(msgs))
    _assert_windows(wi, wq, want)
    assert truth == want_truth


def test_census_stream_equals_jax():
    """build_stream equals tools/hash_census.py's: every batch's windows
    bit for bit, and the expected resolutions."""
    got, expect = pcensus.build_stream(5)
    want, want_expect = jcensus.build_stream(5)
    assert expect == want_expect
    assert len(got) == len(want)
    for (wi, wq), (ri, rq) in zip(got, want):
        np.testing.assert_array_equal(wi, ri)
        np.testing.assert_array_equal(wq, rq)


def test_sweep_decode_matches_jax(jax_host_fec):  # noqa: F811
    """Per trial, found by the port's sweep decode (int8, slices of 128,
    device_batch 32) as by the JAX package's decode_channels at the same
    settings, with the same decoded messages, at -20 and -28 dB."""
    for snr, wi, wq in psweep.build_windows(3, snrs=[-20, -28]):
        got = psweep.decode(wi, wq, "int8", device=CPU)
        ref = jmc.decode_channels(wi, wq, JOptions(), device_batch=32,
                                  transfer_dtype="int8")
        assert list(psweep.found(got)) == list(psweep.found(ref)), snr
        assert [{s.message for s in ch} for ch in got] == \
            [{s.message for s in ch} for ch in ref], snr
    assert psweep.found(got).any()


def test_matrix_decode_matches_jax(jax_host_fec):  # noqa: F811
    """Per trial of two cells at the drift model's ends (+-4 Hz, t0 4 s),
    found by the port's cell decode as by the JAX package's
    decode_channels at device_batch 32."""
    for drift, t0, wi, wq in pmatrix.build_cells(2, -27.0,
                                                 drifts=[-4.0, 4.0],
                                                 dts=[4.0]):
        ref = jmc.decode_channels(wi, wq, JOptions(), device_batch=32)
        assert list(pmatrix.decode_cell(wi, wq, device=CPU)) == \
            list(psweep.found(ref)), (drift, t0)


def test_crowded_decode_matches_jax(jax_host_fec):  # noqa: F811
    """Each window's set of decoded messages, two crowded windows at
    npasses 2, equal to the JAX package's decode_channels'."""
    wi, wq, truth = pcrowded.build_windows(2, 12)
    got = pcrowded.decode(wi, wq, [(2, 10000)], device=CPU)[(2, 10000)]
    ref = jmc.decode_channels(wi, wq, JOptions(npasses=2, maxcycles=10000),
                              device_batch=32)
    assert got == [{s.message for s in ch} for ch in ref]
    assert pcrowded.prf(got, truth)[0] > 0


def test_census_matches_jax(jax_host_fec):  # noqa: F811
    """The census of two pairs through the port's pipelined decode equals
    tools/hash_census.py's run through the JAX package's, in both modes,
    and every type-3 spot resolves. The pipelined mode's spot total is
    left out: whether a type-3 is still unresolved when its own batch
    dedupes and subtracts depends on the worker threads' timing (one
    spot more or less, in either package); strict mode fixes it."""
    batches, expect = pcensus.build_stream(2)
    for strict in (False, True):
        got = pcensus.run(batches, expect, strict, device=CPU)
        ref = jcensus.run(batches, expect, strict)
        if not strict:
            del got["total_spots"], ref["total_spots"]
        assert got == ref
        assert got["type3_resolved_gap1"] + got["type3_resolved_gap2"] == 2


def test_tools_run_on_the_card_by_default():
    """device=None names the CUDA card: without one, each tool's decode
    raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    w = np.zeros((1, 45000), np.float32)
    for call in (lambda: psweep.decode(w, w),
                 lambda: pmatrix.decode_cell(w, w),
                 lambda: pcrowded.decode(w, w, [(2, 10000)]),
                 lambda: pcensus.run([(w, w)], [], False),
                 lambda: psweep.device_banner(None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

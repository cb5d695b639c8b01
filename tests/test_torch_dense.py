"""The port's dense decode program against the JAX package: the one-window
sync forms, the two subtraction variants, the dense device step
(``multichannel_decode_device``), its mesh path through
``decode_channels(sharding=...)`` with the attempt-cap redecode, and the
per-window ``decode_window`` / ``WsprDecoder(staged=False)``.

The inputs are tests/torch_parity.py's ``windows3`` at quick mode, with
the JAX dry run's attempt cap 16 and Fano budget 64 where the dense step
is called on its own. The JAX side runs on the CPU, as its own tests run
it; the port runs its plain versions with CPU devices."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.models.decoder import decode_window as jdecode_window
from rtlsdr_wsprd_tpu.ops import candidates as jcand
from rtlsdr_wsprd_tpu.ops import coarse as jcoarse
from rtlsdr_wsprd_tpu.ops import stft as jstft
from rtlsdr_wsprd_tpu.ops import subtract as jsub
from rtlsdr_wsprd_tpu.ops import sync as jsync
from rtlsdr_wsprd_tpu.parallel import mesh as jmesh
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu.utils.channel import get_wspr_channel_symbols
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable
from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.models.decoder import WsprDecoder, decode_window
from rtlsdr_wsprd_tpu_torch.ops import subtract as psub
from rtlsdr_wsprd_tpu_torch.ops import sync as psync
from rtlsdr_wsprd_tpu_torch.parallel import mesh as pmesh
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import CPU, assert_spots_match, spot_key, windows3
from torch_parity import jax_host_fec  # noqa: F401  (fixture)

QUICK = dict(quickmode=True)
# the JAX dry run's quick dense step (__graft_entry__.py dryrun_multichip)
DENSE_KW = dict(quickmode=True, lagstep=16, max_attempts=16, maxcycles=64)


@pytest.fixture(scope="module")
def wins():
    return windows3()


@pytest.fixture(scope="module")
def jax_dense(wins):
    """The JAX package's dense step on the 3 windows, numpy fields."""
    wi, wq = wins
    out = jmc.multichannel_decode_device(
        jnp.asarray(wi), jnp.asarray(wq), jnp.full((3,), 4, jnp.int32),
        **DENSE_KW)
    return jmc.ChannelDecode(*(np.asarray(x) for x in out))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_coarse(i, q):
    """The JAX package's stage A of one window: candidates and the coarse
    (freq, shift, drift) each (C,)."""
    ps = jstft.power_spectrogram(jnp.asarray(i), jnp.asarray(q))
    cand = jcand.find_candidates(ps, -110.0, 110.0)
    return cand, jcoarse.coarse_search(ps, cand.bin_idx, jnp.int32(4))


@pytest.mark.parametrize("quickmode", [True, False])
def test_one_window_sync_matches_jax(wins, quickmode):
    """fine_sync and soft_symbols_jittered (one window, all 200 candidate
    slots, fed the JAX package's coarse grid) against the JAX functions:
    fine shift and freq equal, sync within atol 1e-5; the soft symbols
    equal except for test_torch_sync's +-1 flips where floor(fs + 128)
    sits on an integer boundary (at most 1 in 10^4, none above 1;
    measured 1 of 32,400 in quick mode, 44 of 1,393,200 on the
    43-jitter schedule, most on invalid candidate slots), the mode-2
    sync within atol 1e-5, and the rms within 1e-5 on every (jitter,
    candidate) row without a flip."""
    wi, wq = wins
    _, co = _jax_coarse(wi[0], wq[0])
    lag = 16 if quickmode else 8
    fj = jsync.fine_sync(jnp.asarray(wi[0]), jnp.asarray(wq[0]), co.freq,
                         co.shift, co.drift, lagstep=lag)
    fp = psync.fine_sync(_t(wi[0]), _t(wq[0]), _t(np.asarray(co.freq)),
                         _t(np.asarray(co.shift)), _t(np.asarray(co.drift)),
                         lagstep=lag)
    np.testing.assert_array_equal(fp.shift.numpy(), np.asarray(fj.shift))
    np.testing.assert_array_equal(fp.freq.numpy(), np.asarray(fj.freq))
    np.testing.assert_allclose(fp.sync.numpy(), np.asarray(fj.sync), rtol=0,
                               atol=1e-5)
    # both fed the JAX fine values, so the comparison is of mode 2 alone
    sj = jsync.soft_symbols_jittered(jnp.asarray(wi[0]), jnp.asarray(wq[0]),
                                     fj.freq, fj.shift, co.drift,
                                     quickmode=quickmode)
    sp = psync.soft_symbols_jittered(_t(wi[0]), _t(wq[0]),
                                     _t(np.asarray(fj.freq)),
                                     _t(np.asarray(fj.shift)),
                                     _t(np.asarray(co.drift)),
                                     quickmode=quickmode)
    assert sp.symbols.shape == (1 if quickmode else 43, 200, 162)
    flips = sp.symbols.numpy().astype(int) - np.asarray(sj.symbols)
    assert np.abs(flips).max() <= 1
    assert np.count_nonzero(flips) <= 1e-4 * flips.size
    np.testing.assert_allclose(sp.sync.numpy(), np.asarray(sj.sync), rtol=0,
                               atol=1e-5)
    clean = ~flips.any(axis=-1)
    np.testing.assert_allclose(sp.rms.numpy()[clean],
                               np.asarray(sj.rms)[clean], rtol=0, atol=1e-5)


def _sub_rows(rng):
    """Three noisy rows with a decode each, the middle one disabled."""
    sig_i = rng.normal(0, .1, (3, 45000)).astype(np.float32)
    sig_q = rng.normal(0, .1, (3, 45000)).astype(np.float32)
    syms = np.stack([get_wspr_channel_symbols(m, WsprHashTable())
                     for m in ("K1JT FN20 37", "K9AN EN50 33",
                               "G4ABC IO91 30")]).astype(np.uint8)
    return (sig_i, sig_q, np.float32([12.0, -40.0, 75.5]),
            np.int32([400, -700, 3000]), np.float32([0.5, -1.0, 0.0]), syms)


def test_subtract_signal2_many_matches_jax(rng):
    """subtract_signal2_many against the JAX package's: within 2e-4 on
    enabled rows, a disabled row passed through unchanged. The reference
    r(t)'s phase is a float32 running sum, summed in another order by
    the two packages; at f0 = 75.5 Hz it reaches ~5e4 rad, where a
    float32 ulp is ~4e-3 rad, twice test_torch_subtract's 12 Hz case
    (1e-4 there) against a removed component of ~2e-2."""
    sig_i, sig_q, f0, shift, drift, syms = _sub_rows(rng)
    enable = np.array([True, False, True])
    pi, pq = psub.subtract_signal2_many(*map(_t, (sig_i, sig_q, f0, shift,
                                                 drift, syms, enable)))
    ji, jq = jsub.subtract_signal2_many(*map(jnp.asarray, (
        sig_i, sig_q, f0, shift, drift, syms, enable)))
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=2e-4)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(pi[1].numpy(), sig_i[1])
    np.testing.assert_array_equal(pq[1].numpy(), sig_q[1])
    assert np.abs(pi[0].numpy() - sig_i[0]).max() > 1e-3  # row 0 changed


def test_subtract_signal_matches_jax(rng):
    """The per-symbol variant, one decode a row (shifts inside and across
    the window's edges), against the JAX package's one-window function
    row by row: within 1e-4."""
    sig_i, sig_q, f0, shift, drift, syms = _sub_rows(rng)
    pi, pq = psub.subtract_signal(*map(_t, (sig_i, sig_q, f0, shift, drift,
                                            syms)))
    for r in range(3):
        ji, jq = jsub.subtract_signal(
            jnp.asarray(sig_i[r]), jnp.asarray(sig_q[r]), jnp.float32(f0[r]),
            jnp.int32(shift[r]), jnp.float32(drift[r]), jnp.asarray(syms[r]))
        np.testing.assert_allclose(pi[r].numpy(), np.asarray(ji), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(pq[r].numpy(), np.asarray(jq), rtol=0,
                                   atol=1e-4)


def test_dense_step_matches_jax(wins, jax_dense):
    """multichannel_decode_device on the 3 windows against the JAX
    package's: every integer and bool field equal in every slot, the
    padding slots of the top-k compaction included; the float fields
    within atol 1e-5. ``data`` is compared where ``success`` is set: the
    port's Fano writes zeros on a failed lane, the JAX program leaves
    stale bytes there (ops/fano.py)."""
    wi, wq = wins
    got = pmc.multichannel_decode_device(wi, wq, np.full(3, 4, np.int32),
                                         device=CPU, **DENSE_KW)
    assert got.sel_cand.shape == (3, DENSE_KW["max_attempts"])
    for name, g, r in zip(pmc.ChannelDecode._fields, got, jax_dense):
        g = g.numpy()
        assert g.shape == r.shape, name
        if name == "data":
            ok = jax_dense.success
            np.testing.assert_array_equal(g[ok], r[ok])
            assert not g[~ok].any()
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          r.astype(np.int64), err_msg=name)
    assert jax_dense.success[:2].any(axis=1).all()  # both signal windows
    assert not jax_dense.sel_valid[2].any()         # the noise window
    assert (~jax_dense.sel_valid).any()             # padding slots exist


def test_dense_step_two_cpu_shards_equal_one(wins):
    """The dense step over make_mesh(["cpu", "cpu"]) (rows [0, 1) and
    [1, 3), each shard from its own thread) equals the unsharded step bit
    for bit in every ChannelDecode field."""
    wi, wq = wins
    kw = dict(pmc._decode_kw(DecoderOptions(**QUICK)), max_attempts=16,
              delta=60, maxcycles=64)
    one = pmc.multichannel_decode_device(
        _t(wi), _t(wq), torch.full((3,), 4, dtype=torch.int32), **kw)
    sh = pmc.channel_sharding(pmesh.make_mesh([CPU, CPU]))
    assert sh.bounds(3) == [(0, 1), (1, 3)]
    two = pmc._mesh_step(*pmc.shard_windows(wi, wq, sh.mesh), sh, 4, kw)
    for name, a, b in zip(pmc.ChannelDecode._fields, one, two):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            a.numpy().dtype), err_msg=name)


def _mesh_spots_match(got, want):
    """The JAX package's dense-vs-staged spot tolerances
    (tests/test_multichannel.py): spot_key equal, freq within 0.5e-6
    MHz, snr within 0.5 dB, dt within 0.05 s."""
    assert [[spot_key(s) for s in ch] for ch in got] == \
        [[spot_key(s) for s in ch] for ch in want]
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert g.freq == pytest.approx(w.freq, abs=0.5e-6)
            assert g.snr == pytest.approx(w.snr, abs=0.5)
            assert g.dt == pytest.approx(w.dt, abs=0.05)


def test_decode_channels_mesh_matches_jax(wins, jax_host_fec):
    """decode_channels(sharding=channel_sharding(make_mesh(["cpu",
    "cpu"]))) over the two passes (the weak signal of window 0 decodes
    only after the subtraction on host copies) against the JAX package's
    mesh path on one device; the caller's arrays are left as they were."""
    wi, wq = wins
    wi0, wq0 = wi.copy(), wq.copy()
    got = pmc.decode_channels(
        wi, wq, DecoderOptions(**QUICK),
        sharding=pmesh.channel_sharding(pmesh.make_mesh([CPU, CPU])))
    ref = jmc.decode_channels(
        wi, wq, JOptions(**QUICK),
        sharding=jmesh.channel_sharding(jmesh.local_mesh(1)))
    _mesh_spots_match(got, ref)
    assert [sorted(s.call for s in ch) for ch in got] == \
        [["K1JT", "K9AN"], ["G4ABC"], []]
    np.testing.assert_array_equal(wi, wi0)
    np.testing.assert_array_equal(wq, wq0)


def _decoy_window():
    """tests/test_multichannel.py's attempt-cap decoy: the top-SNR
    candidate is an undecodable decoy (sync bits right, data bits
    random) that passes every gate, a weaker real K1JT FN20 20 beside
    it."""
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import add_awgn, synth_wspr_baseband
    from rtlsdr_wsprd_tpu.utils.channel import PR3_VECTOR

    rng = np.random.default_rng(77)
    decoy = (PR3_VECTOR.astype(np.uint8)
             + 2 * rng.integers(0, 2, 162).astype(np.uint8))
    real = np.asarray(get_wspr_channel_symbols("K1JT FN20 20",
                                               WsprHashTable()), np.uint8)
    iq = (synth_wspr_baseband(decoy, f0=50.0, amp=2.0)
          + synth_wspr_baseband(real, f0=-50.0, amp=1.0))
    iq = add_awgn(iq, sigma=0.05, rng=rng)
    wi, wq = normalize_minus3db(iq.real.astype(np.float32),
                                iq.imag.astype(np.float32))
    return wi[None], wq[None]


def test_mesh_attempt_cap_overflow_redecodes(caplog, jax_host_fec):
    """With max_attempts=1 the dense compaction keeps only the decoy's
    attempt; the pre-cap gate count sends the window through the uncapped
    staged redecode at float32 transfer, which finds K1JT FN20 20: equal
    to the port's and the JAX package's staged float32 decodes."""
    wi, wq = _decoy_window()
    opts = DecoderOptions(**QUICK)
    with caplog.at_level(logging.INFO, "rtlsdr_wsprd_tpu_torch.multichannel"):
        got = pmc.decode_channels(
            wi, wq, opts, max_attempts=1,
            sharding=pmesh.channel_sharding(pmesh.make_mesh([CPU])))
    assert any("attempt cap overflow" in r.message for r in caplog.records)
    mine = pmc.decode_channels(wi, wq, opts, device_batch=1,
                               transfer_dtype="float32", device=CPU)
    ref = jmc.decode_channels(wi, wq, JOptions(**QUICK), device_batch=1,
                              transfer_dtype="float32")
    assert [(s.call, s.loc, s.pwr) for s in got[0]] == [
        ("K1JT", "FN20", "20")]
    assert_spots_match(got, mine)
    assert_spots_match(mine, ref)


def test_decode_window_matches_jax(wins, jax_host_fec, tmp_path):
    """decode_window per window (two passes, subtraction by
    subtract_signal2) against the JAX package's decode_window: spot lists
    equal within torch_parity's tolerances; WsprDecoder(staged=False)
    equals decode_window."""
    wi, wq = wins
    got = [decode_window(wi[b], wq[b], DecoderOptions(**QUICK), device=CPU)
           for b in range(3)]
    ref = [jdecode_window(wi[b], wq[b], JOptions(**QUICK)) for b in range(3)]
    assert_spots_match(got, ref)
    assert [sorted(s.call for s in ch) for ch in got] == \
        [["K1JT", "K9AN"], ["G4ABC"], []]
    dec = WsprDecoder(DecoderOptions(**QUICK),
                      hashtable_path=str(tmp_path / "h.txt"), staged=False,
                      device=CPU)
    assert_spots_match([dec.decode(wi[0], wq[0])], got[:1])


def test_mesh_placement():
    """make_mesh / channel_sharding / replicated / shard_windows in the
    JAX package's shapes: contiguous row shards (fewer shards than
    devices for a short batch), the whole batch on every device of a
    replicated placement, float32 tensors on the mesh's devices;
    local_mesh never falls back to the CPU."""
    m = pmesh.make_mesh([CPU, CPU, CPU], axis_name="ch")
    assert m.devices == (torch.device(CPU),) * 3 and m.axis_name == "ch"
    x = np.arange(5 * 4, dtype=np.float64).reshape(5, 4)
    parts = pmesh.channel_sharding(m).place(x)
    assert [p.shape[0] for p in parts] == [1, 2, 2]
    assert all(p.dtype == torch.float32 for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    assert [p.shape[0] for p in pmesh.channel_sharding(m).place(x[:2])] == \
        [1, 1]
    assert all(np.array_equal(p.numpy(), x)
               for p in pmesh.replicated(m).place(x))
    si, sq = pmc.shard_windows(x, -x, m)
    np.testing.assert_array_equal(torch.cat(sq).numpy(), -x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.local_mesh(1)


def test_channel_sharding_axis_name():
    """channel_sharding(mesh, axis_name): the mesh's own axis name shards
    the rows as the JAX package's NamedSharding does on a mesh of that
    name; a name the mesh lacks raises ValueError, where the JAX package
    raises ValueError at placement."""
    import jax

    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    m = pmesh.make_mesh([CPU, CPU], axis_name="seq")
    sh = pmesh.channel_sharding(m, axis_name="seq")
    assert sh.mesh is m
    jm = jmesh.make_mesh(jax.devices()[:2], axis_name="seq")
    jidx = jmesh.channel_sharding(jm, axis_name="seq").devices_indices_map(
        x.shape)
    want = [(jidx[d][0].start, jidx[d][0].stop) for d in jax.devices()[:2]]
    assert sh.bounds(4) == want == [(0, 2), (2, 4)]
    np.testing.assert_array_equal(torch.cat(sh.place(x)).numpy(), x)
    with pytest.raises(ValueError, match="axis"):
        pmesh.channel_sharding(m)
    with pytest.raises(ValueError, match="axis"):
        pmesh.channel_sharding(pmesh.make_mesh([CPU]), axis_name="seq")
    with pytest.raises(ValueError, match="seq"):
        jax.device_put(x, jmesh.channel_sharding(jm))
    assert pmesh.channel_sharding(pmesh.make_mesh([CPU])).mesh.axis_name \
        == "ch"

"""The port's measurement tools (tools/torch_e2e_sweep.py,
torch_profile_staged.py, torch_profile_stages.py, torch_roofline.py,
torch_fec_scaling.py, torch_host_frontend_bench.py, and their shared
torch_measure.py) against the JAX package and its tools, on the CPU:
the staged and mesh paths' phase marks, the profiler's phase summary,
the device chain's front end, window assembly and one decoded round,
the roofline's work counter, the host FEC tool's lanes, the per-op
tool's candidate counts, and the card as every tool's default."""

import logging
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu import native as jnative
from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.frontend.decimate import (
    _fused_frontend_step as j_fused_step,
)
from rtlsdr_wsprd_tpu.ops.candidates import find_candidates as j_cands
from rtlsdr_wsprd_tpu.ops.coarse import coarse_search as j_coarse
from rtlsdr_wsprd_tpu.ops.stft import power_spectrogram as j_stft
from rtlsdr_wsprd_tpu.ops.sync import fine_sync as j_fine_sync
from rtlsdr_wsprd_tpu.parallel import mesh as jmesh
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu_torch import native as pnative
from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.parallel import mesh as pmesh
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import CPU, assert_spots_match, import_tools, windows3
from torch_parity import jax_host_fec  # noqa: F401  (fixture)
from torch_parity import port_calibration  # noqa: F401  (fixture)

QUICK = dict(quickmode=True)
# the JAX package's phase marks (rtlsdr_wsprd_tpu/parallel/multichannel.py)
MARKS = ("stage A done", "stage B:", "stage B fetch done", "fano rounds done",
         "host-finishing", "subtracting", "subtraction done")


(pe2e, pstaged, pstages, proof, pfec, phost, pmeasure) = import_tools(
    "torch_e2e_sweep", "torch_profile_staged", "torch_profile_stages",
    "torch_roofline", "torch_fec_scaling", "torch_host_frontend_bench",
    "torch_measure")
(jstaged,) = import_tools("profile_staged", argv=["profile_staged.py"])
(jbench, jfec) = import_tools("bench", "fec_scaling")


class _Marks(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.msgs: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(MARKS):
            self.msgs.append(msg)


def _marks_of(logger, fn) -> list[str]:
    h = _Marks()
    level = logger.level
    logger.addHandler(h)
    logger.setLevel(logging.DEBUG)
    try:
        fn()
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
    return h.msgs


@pytest.fixture(scope="module")
def bench4():
    wi, wq, _calls = pmeasure.make_batch(4)
    return wi, wq


def test_make_batch_equals_bench():
    """The port's copy of bench.py's batch gives its windows bit for bit."""
    wi, wq, calls = pmeasure.make_batch(4)
    ji, jq = jbench.make_batch(4)
    np.testing.assert_array_equal(wi, ji)
    np.testing.assert_array_equal(wq, jq)
    assert calls[0] == "K1JT FN20 37"


def test_staged_phase_marks_match_jax(bench4, jax_host_fec):  # noqa: F811
    """decode_channels(fec='host') on 4 bench windows logs the JAX
    package's phase marks, in order, with equal integers (lanes, active
    windows, gate-passing attempts, decodes, subtraction rounds)."""
    wi, wq = bench4
    got = _marks_of(pmc._LOG, lambda: pmc.decode_channels(
        wi, wq, DecoderOptions(**QUICK), device_batch=4, device=CPU,
        fec="host"))
    ref = _marks_of(jmc._LOG, lambda: jmc.decode_channels(
        wi, wq, JOptions(**QUICK), device_batch=4, fec="host"))
    assert got == ref
    assert [m.split(" (")[0].split(":")[0] for m in got[:2]] == [
        "stage A done", "stage B"]
    assert any(m.startswith("subtracting") for m in got)
    assert got.count("subtraction done") == sum(
        m.startswith("subtracting") for m in got)


def test_mesh_phase_marks_match_jax(jax_host_fec):  # noqa: F811
    """The mesh path's marks (its straggler finish and its subtraction
    rounds on host copies) equal the JAX mesh path's on the same
    windows."""
    wi, wq = windows3()
    got = _marks_of(pmc._LOG, lambda: pmc.decode_channels(
        wi, wq, DecoderOptions(**QUICK),
        sharding=pmesh.channel_sharding(pmesh.make_mesh([CPU]))))
    ref = _marks_of(jmc._LOG, lambda: jmc.decode_channels(
        wi, wq, JOptions(**QUICK),
        sharding=jmesh.channel_sharding(jmesh.local_mesh(1))))
    assert got == ref
    assert "subtraction done" in got
    assert any(m.startswith("subtracting") for m in got)


def test_summarize_matches_jax_tool():
    """torch_profile_staged.summarize gives tools/profile_staged.py's
    phases on a fixed mark list (every mark kind, a sub-mark and a line
    no phase reads)."""
    msgs = ["stage A done (4 windows)", "stage B: 5 lanes over 4 active "
            "windows", "stage B fetch done (9 gate-passing attempts)",
            "fano host: 5 lanes (0 deferred), 3 decodes, 4 ms",
            "host-finishing 2 straggler lanes", "fano rounds done (3 "
            "decodes)", "subtracting 3 decodes in 1 rounds",
            "subtraction done", "stage A done (4 windows)",
            "stage B: 1 lanes over 2 active windows",
            "stage B fetch done (1 gate-passing attempts)",
            "fano rounds done (1 decodes)"]
    marks = [(1.0 + 0.25 * k * k, m) for k, m in enumerate(msgs)]
    got = pstaged.summarize(marks, 0.5, 99.0)
    assert got == jstaged.summarize(marks, 0.5, 99.0)
    assert sum(got.values()) == pytest.approx(98.5)


def test_chain_frontend_matches_jax():
    """Two fused front-end steps of N_MID=120,000 at C=2 over the same
    raw uint8 block, the carry starting at zeros: the port's step loop
    against the JAX package's _fused_frontend_step, outputs and carries
    within 2e-4 of their scale."""
    n_mid, C = 120_000, 2
    rng = np.random.default_rng(4)
    L = n_mid * 80 + 640 - 80
    ri, rq = (rng.integers(0, 256, (C, L), dtype=np.uint8) for _ in range(2))
    tail2 = 2400 - 80
    z = np.zeros((C, tail2), np.float32)
    got = pe2e.frontend_steps(torch.from_numpy(ri), torch.from_numpy(rq),
                              torch.from_numpy(z), torch.from_numpy(z),
                              n_mid, 2)
    ji, jq = jnp.asarray(ri), jnp.asarray(rq)
    m2i = m2q = jnp.asarray(z)
    outs_i, outs_q = [], []
    for _ in range(2):
        oi, oq, m2i, m2q = j_fused_step(ji, jq, m2i, m2q, n_mid)
        outs_i.append(np.asarray(oi))
        outs_q.append(np.asarray(oq))
    ref = (np.concatenate(outs_i, 1), np.concatenate(outs_q, 1),
           np.asarray(m2i), np.asarray(m2q))
    assert got[0].shape == (C, 2 * n_mid // 80)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        scale = float(np.abs(r).max())
        assert float(np.abs(g.numpy() - r).max()) <= 2e-4 * scale


def test_assemble_win_matches_jax():
    """assemble_win against bench.py's _assemble_win lines in jnp."""
    rng = np.random.default_rng(6)
    bb_i, bb_q, ci, cq = (rng.normal(0, s, (3, 45000)).astype(np.float32)
                          for s in (40.0, 40.0, 0.2, 0.2))
    got = pe2e.assemble_win(*(torch.from_numpy(a) for a in
                              (bb_i, bb_q, ci, cq)))
    b_i, b_q, c_i, c_q = (jnp.asarray(a) for a in (bb_i, bb_q, ci, cq))
    m = jnp.maximum(jnp.abs(b_i).max(axis=1), jnp.abs(b_q).max(axis=1))
    s = (0.125 / jnp.maximum(m, 1e-24))[:, None]
    zi = c_i + b_i * s
    zq = c_q + b_q * s
    mx = jnp.maximum(jnp.abs(zi).max(axis=1), jnp.abs(zq).max(axis=1))
    sc = (0.5 / jnp.maximum(mx, 1e-24))[:, None]
    for g, r in zip(got, (zi * sc, zq * sc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def chain_round(bench4):
    """One round of the device chain at C=2 on the CPU (30 steps of
    N_MID=120,000 over a seeded raw block, the first two bench windows
    mixed in): its handle, and host copies of its planes taken before
    any decode."""
    wi, wq = bench4
    cont_i = torch.from_numpy(wi[:2].copy())
    cont_q = torch.from_numpy(wq[:2].copy())
    (handle,) = pe2e.device_windows(cont_i, cont_q, 1, 0, 120_000,
                                    [torch.device(CPU)])
    return handle, [a.numpy().copy() for a in handle.arrays]


def test_chain_round_decodes_like_jax(chain_round,
                                      jax_host_fec):  # noqa: F811
    """The port's decode of one chain round's handle equals the JAX
    package's decode_channels on a host copy of the same planes at
    float32."""
    handle, (hi, hq) = chain_round
    assert hi.shape == (2, 45000)
    assert np.abs(np.stack([hi, hq])).max() == pytest.approx(0.5)
    got = pmc.decode_channels(None, None, DecoderOptions(**QUICK),
                              windows=handle, fec="host")
    ref = jmc.decode_channels(hi, hq, JOptions(**QUICK), device_batch=2,
                              transfer_dtype="float32", fec="host")
    assert_spots_match(got, ref)
    assert all(got)


def test_chain_shards_across_devices(bench4, chain_round):
    """With two devices (two CPU shards here) a round is one handle a
    device over contiguous rows (bench.py:160-170): the shards hold the
    one-device round's rows, and the multi-device pipelined decode of
    them equals the decode of the one-device planes."""
    wi, wq = bench4
    _handle, (hi, hq) = chain_round
    cpu = torch.device(CPU)
    (shards,) = pe2e.device_windows(torch.from_numpy(wi[:2].copy()),
                                    torch.from_numpy(wq[:2].copy()), 1, 0,
                                    120_000, [cpu, cpu])
    assert [(h.B, h.device) for h in shards] == [(1, cpu), (1, cpu)]
    for k, h in enumerate(shards):
        np.testing.assert_array_equal(h.arrays[0].numpy(), hi[k:k + 1])
        np.testing.assert_array_equal(h.arrays[1].numpy(), hq[k:k + 1])
    opts = DecoderOptions(**QUICK)
    (got,) = pmc.decode_channels_pipelined_multidevice(
        [shards], opts, devices=[cpu, cpu], fec="host")
    want = [pmc.decode_channels(None, None, opts, fec="host",
                                windows=pmc.prepare_windows_device(
                                    torch.from_numpy(hi[k:k + 1]),
                                    torch.from_numpy(hq[k:k + 1]),
                                    device_batch=1))[0] for k in range(2)]
    assert [[(x.message, x.freq, x.snr, x.dt, x.sync, x.cycles) for x in ch]
            for ch in got] == \
        [[(x.message, x.freq, x.snr, x.dt, x.sync, x.cycles) for x in ch]
         for ch in want]


def test_work_counter_known_product():
    """The roofline's counter on one product: 2 m k n FLOPs, its inputs
    and output once each in bytes; views count nothing."""
    m, k, n = 7, 11, 13
    a = torch.ones((m, k))
    b = torch.ones((k, n))
    with proof.counting() as c:
        torch.mm(a, b)
        a.view(k, m).t()
    assert c.mm_flops == 2 * m * k * n
    assert c.other_flops == 0
    assert c.bytes == (m * k + k * n + m * n) * 4


def test_work_counter_stage_a_matmuls():
    """Stage A at B=2: the counter's matrix-product FLOPs are the STFT's
    four (347, 512) x (512, 512) products a window and the coarse grid's
    (512 x 32, 162) x (162, 9 x 2 x NS) product a window."""
    from rtlsdr_wsprd_tpu_torch.ops import coarse, stft

    B = 2
    rng = np.random.default_rng(8)
    si, sq = (torch.from_numpy(rng.normal(0, 0.1, (B, 45000))
                               .astype(np.float32)) for _ in range(2))
    md = torch.full((B,), 4, dtype=torch.int32)
    w = proof.work(proof.stage_a_fn(si, sq, md, DecoderOptions()))
    stft_flops = 4 * 2 * B * stft.BLOCKS * 512 * 512
    grid_flops = 2 * B * coarse.N_ROWS * coarse.N_LAG * coarse.NSYM * \
        coarse.W.shape[1]
    assert w.mm_flops == stft_flops + grid_flops
    assert w.other_flops > 0 and w.bytes > 0 and w.kernel_flops == 0


def test_fec_scaling_inputs_match_jax_tool():
    """torch_fec_scaling's budget-exhausting lanes and clean payload are
    the JAX tool's bit for bit, and both bindings decode them alike."""
    lanes = pfec.make_lanes(3)
    np.testing.assert_array_equal(lanes, jfec.make_lanes(3))
    clean = pfec.make_clean()
    np.testing.assert_array_equal(clean, jfec.make_clean())
    mettab = np.ascontiguousarray(jfec.build_mettab(), np.int32)
    for syms, mc in ((clean, 10000), (lanes[0], 50)):
        got = pnative.fano_decode(syms, pfec.METTAB, 60, mc)
        ref = jnative.fano_decode(syms, mettab, 60, mc)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2:] == ref[2:]
    assert pnative.fano_decode(clean, pfec.METTAB, 60, 10000)[0]
    assert 16 in pfec.worker_counts()


def test_profile_stages_counts_match_jax(bench4):
    """torch_profile_stages' search at DB=2 finds as many valid
    candidates and minsync1 passers a window as the JAX tool's vmapped
    ops (power_spectrogram, find_candidates, coarse_search, fine_sync at
    lagstep 8) on the same windows."""
    import jax

    wi, wq = (a[:2] for a in bench4)
    cd, _co, fs = pstages.search(torch.from_numpy(wi), torch.from_numpy(wq),
                                 lambda name, fn: fn())
    got = pstages.counts(cd, fs)
    si, sq = jnp.asarray(wi), jnp.asarray(wq)
    ps = jax.vmap(j_stft)(si, sq)
    jcd = jax.vmap(lambda p: j_cands(p, -110.0, 110.0))(ps)
    co = jax.vmap(j_coarse)(ps, jcd.bin_idx, jnp.full((2,), 4, jnp.int32))
    jfs = jax.vmap(lambda i, q, f, s, d: j_fine_sync(
        i, q, f, s, d, lagstep=8))(si, sq, co.freq, co.shift, co.drift)
    valid = np.asarray(jcd.valid)
    worth = (np.asarray(jfs.sync) > 0.10) & valid
    np.testing.assert_array_equal(got[0], valid.sum(axis=1))
    np.testing.assert_array_equal(got[1], worth.sum(axis=1))
    assert got[0].sum() > 0


def test_host_tools_run_on_the_cpu_when_asked(monkeypatch, capsys):
    """The two host tools run to their end with --device cpu, naming the
    CPU where the card would stand."""
    for mod, argv, want in (
            (pfec, ["torch_fec_scaling.py", "2", "1"], '"sweep_s"'),
            (phost, ["torch_host_frontend_bench.py", "0.05"],
             "channelizer K=4")):
        monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
        mod.main()
        out = capsys.readouterr().out
        assert want in out and "cpu (plain PyTorch versions" in out


def test_tools_run_on_the_card_by_default(monkeypatch):
    """Without --device every new tool names the CUDA card: without one,
    each raises before it measures anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tools run on it")
    for mod in (pe2e, pstaged, pstages, proof, pfec, phost):
        monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pe2e.measure_e2e_device(np.zeros((1, 45000), np.float32),
                                np.zeros((1, 45000), np.float32),
                                DecoderOptions(), DC=1, DWIN=1)

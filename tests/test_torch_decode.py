"""The port's staged decode end to end against the JAX package: host
Fano binding, int8 window transfer, decode_channels over a two-pass
batch with subtraction, the decoder facade, the bucket pipeline, the
device rule and import hygiene."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu import native as jnative
from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu.utils.channel import (
    INTERLEAVE_PERM,
    get_wspr_channel_symbols,
)
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable
from rtlsdr_wsprd_tpu_torch import native as pnative
from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.ops.fano import build_mettab
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc

from torch_parity import CPU, assert_spots_match, windows3
from torch_parity import jax_host_fec  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
QUICK = dict(quickmode=True)
# the port's tools (the decode-quality studies, the measurement tools
# and their shared helpers), beside the JAX package's tools
TOOLS = ("torch_snr_sweep", "torch_sensitivity_matrix", "torch_crowded_band",
         "torch_hash_census", "torch_e2e_sweep", "torch_profile_staged",
         "torch_profile_stages", "torch_roofline", "torch_fec_scaling",
         "torch_host_frontend_bench", "torch_measure", "torch_bench",
         "torch_scaling")


@pytest.fixture(scope="module")
def wins():
    return windows3()


def _hard(message: str) -> np.ndarray:
    chan = get_wspr_channel_symbols(message, WsprHashTable())
    soft = np.where(chan >= 2, 255, 0).astype(np.uint8)
    return soft[np.asarray(INTERLEAVE_PERM)]


def test_host_fano_bit_exact_with_jax_binding():
    """The port's ctypes binding to native/hostdsp.cpp against the JAX
    package's: success, data, cycles, metric and depth identical on a
    clean decode, a noisy decode and a failing search."""
    rng = np.random.default_rng(12)
    mettab = build_mettab()
    good = _hard("K1JT FN20 37")
    noisy = np.clip(good.astype(int) + rng.normal(0, 70, 162), 0,
                    255).astype(np.uint8)
    garbage = rng.integers(100, 156, 162).astype(np.uint8)
    for syms, maxcycles in ((good, 10000), (noisy, 10000), (garbage, 50)):
        got = pnative.fano_decode(syms, mettab, 60, maxcycles)
        ref = jnative.fano_decode(syms, mettab, 60, maxcycles)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2:] == ref[2:]
    assert pnative.fano_decode(good, mettab)[0]
    assert not pnative.fano_decode(garbage, mettab, 60, 50)[0]


@pytest.mark.parametrize("dtype,scale", [(np.int8, 254.0),
                                         (np.int16, 65534.0),
                                         (np.float32, 1.0)])
def test_window_quantization_equals_jax(dtype, scale):
    """float32 -> int8/int16 transfer quantization: NaN -> 0, round to
    nearest even, clamp to the symmetric range; equal to the JAX
    package's native quantizer element for element, at the scale both
    packages give the format. The float32 transfer is exact: the host
    planes cross as they are, NaN and infinities included."""
    rng = np.random.default_rng(13)
    x = rng.normal(0, 0.3, (3, 1000)).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 2.0, -2.0, 0.5 / scale * 3]
    name = np.dtype(dtype).name
    if dtype == np.float32:
        got = pmc._DeviceWindows(x, x, 3, transfer_dtype=name, device=CPU)
        ref = jmc._DeviceWindows(x, x, 3, transfer_dtype=name)
        np.testing.assert_array_equal(got.arrays[0].numpy(),
                                      np.asarray(ref.arrays[0]))
        np.testing.assert_array_equal(got.arrays[0].numpy(), x)
        return
    assert pmc._SCALES[name] == (dtype, scale)
    assert scale == (jmc._I8_SCALE if dtype == np.int8 else jmc._I16_SCALE)
    got = np.zeros(x.shape, dtype)
    ref = np.zeros(x.shape, dtype)
    pnative.quantize_into(x, got, np.float32(scale))
    jnative.quantize_into(x, ref, np.float32(scale))
    np.testing.assert_array_equal(got, ref)


def test_device_windows_dequantize_like_jax(wins):
    """The window upload in each transfer format (int8, the default;
    int16; float32) gives the same float32 samples as the JAX package's
    _DeviceWindows, padding rows included; prepare_windows passes the
    format on, and an unknown one raises."""
    wi, wq = wins
    for tdt in ("int8", "int16", "float32"):
        got = pmc.prepare_windows(wi, wq, 2, transfer_dtype=tdt, device=CPU)
        ref = jmc._DeviceWindows(wi, wq, device_batch=2, transfer_dtype=tdt)
        assert got.n_pad == ref.n_pad == 4
        for g, r in zip(got.arrays, ref.arrays):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    default = pmc._DeviceWindows(wi, wq, device_batch=2, device=CPU)
    int8 = pmc._DeviceWindows(wi, wq, 2, transfer_dtype="int8", device=CPU)
    for d, g in zip(default.arrays, int8.arrays):
        np.testing.assert_array_equal(d.numpy(), g.numpy())
    with pytest.raises(ValueError, match="transfer_dtype"):
        pmc._DeviceWindows(wi, wq, 2, transfer_dtype="bfloat16", device=CPU)


def test_decode_channels_matches_jax(wins, jax_host_fec):
    """decode_channels(fec='host') on three windows (two overlapping
    signals whose weak one decodes only in pass 2 after subtraction, one
    single signal, noise only) gives the JAX package's spot lists:
    equal in call, loc, pwr, message, jitter, cycles and drift, floats
    within the tolerances of torch_parity.assert_spots_match."""
    wi, wq = wins
    got = pmc.decode_channels(wi, wq, DecoderOptions(**QUICK),
                              device_batch=3, device=CPU, fec="host")
    ref = jmc.decode_channels(wi, wq, JOptions(**QUICK), device_batch=3,
                              fec="host")
    assert_spots_match(got, ref)
    assert [sorted(s.call for s in ch) for ch in got] == \
        [["K1JT", "K9AN"], ["G4ABC"], []]
    # the weak signal needs the second pass: one pass misses it
    one = pmc.decode_channels(wi, wq, DecoderOptions(npasses=1, **QUICK),
                              device_batch=3, device=CPU)
    assert [s.call for s in one[0]] == ["K1JT"]


def test_fano_rounds_fed_jax_stage_b_exact(wins):
    """Fed the JAX package's own stage-B outputs (43-jitter schedule),
    the port's host FEC rounds return exactly the JAX rounds' result:
    the same lanes, jitters, bytes and cycle counts. This holds the FEC
    rounds exact apart from the +-1 soft-symbol flips of test_torch_sync."""
    wi, wq = wins
    B = wi.shape[0]
    sA = np.asarray(jmc._stage_a_packed(
        jnp.asarray(wi), jnp.asarray(wq), jnp.full((B,), 4, jnp.int32),
        fmin=-110.0, fmax=110.0))
    wa, cc = np.nonzero(sA[:, 1] != 0)
    n, G = wa.size, 16
    lanes = [np.zeros(G, t) for t in (np.int32, np.float32, np.int32,
                                      np.float32, bool)]
    lanes[0][:n], lanes[1][:n] = wa, sA[wa, 2, cc]
    lanes[2][:n] = sA[wa, 3, cc].astype(np.int32)
    lanes[3][:n], lanes[4][:n] = sA[wa, 4, cc], True
    pk = jmc._stage_b_packed(
        jnp.asarray(wi), jnp.asarray(wq), *(jnp.asarray(a) for a in lanes),
        lagstep=8, iifac=3, quickmode=False, symfac=50, minsync1=0.10,
        minsync2=0.12, minrms=52.0 * 50 / 64)
    _, gate, pre_j, pre_syms, deint = (np.asarray(x) for x in pk)

    def fetch(ls):
        return np.stack([deint[:, g] for g in ls])

    got = pmc._fano_rounds_host_prefetch(gate[:, :n], pre_j[:n],
                                         pre_syms[:n], fetch, 60, 10000)
    ref = jmc._fano_rounds_host_prefetch(gate[:, :n], pre_j[:n],
                                         pre_syms[:n], fetch, 60, 10000)
    assert got == ref and got


def test_fano_rounds_prefetch_defers_past_depth():
    """A lane whose only decodable attempt lies past the prefetch depth
    pulls its full column once, and the result equals the JAX package's
    dense host rounds."""
    J, G = 8, 4
    good = _hard("K1JT FN20 37")
    noise = np.random.default_rng(7).integers(120, 136, 162).astype(np.uint8)
    deint = np.zeros((J, G, 162), np.uint8)
    gate = np.zeros((J, G), bool)
    deint[2, 0] = good
    gate[2, 0] = True
    for j in range(6):
        deint[j, 1] = noise
        gate[j, 1] = True
    deint[5, 1] = good
    deint[[1, 3], 2] = noise
    gate[[1, 3], 2] = True
    M = min(pmc.PREFETCH_ATTEMPTS, J)
    pre_j = np.full((G, M), J, np.int32)
    pre_syms = np.zeros((G, M, 162), np.uint8)
    for g in range(G):
        js = np.nonzero(gate[:, g])[0][:M]
        pre_j[g, :len(js)] = js
        pre_syms[g, :len(js)] = deint[js, g]
    fetched = []

    def fetch(ls):
        fetched.append(list(ls))
        return np.stack([deint[:, g] for g in ls])

    got = pmc._fano_rounds_host_prefetch(gate, pre_j, pre_syms, fetch,
                                         60, 10000)
    assert got == jmc._fano_rounds_host(gate, deint, 60, 10000)
    assert fetched == [[1]] and got[1][0] == 5


def test_wsprdecoder_matches_jax(wins, jax_host_fec):
    """The facade on one window (batch of one) against the JAX package's
    staged WsprDecoder."""
    from rtlsdr_wsprd_tpu.models.decoder import WsprDecoder as JDecoder
    from rtlsdr_wsprd_tpu_torch.models.decoder import WsprDecoder

    wi, wq = wins
    got = WsprDecoder(DecoderOptions(**QUICK), device=CPU).decode(wi[0], wq[0])
    ref = JDecoder(JOptions(**QUICK)).decode(wi[0], wq[0])
    assert_spots_match([got], [ref])
    assert {s.call for s in got} == {"K1JT", "K9AN"}


def test_bucket_pipeline_matches_single_bucket(wins, monkeypatch):
    """Forcing many tiny stage-B buckets (LANE_BUCKETS=(1, 2)), so that
    bucket k+1 is launched before bucket k's host FEC many times over,
    gives the same spots as one bucket: a scheduling change only."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    want = pmc.decode_channels(wi, wq, opts, device_batch=3, device=CPU)
    monkeypatch.setattr(pmc, "LANE_BUCKETS", (1, 2))
    got = pmc.decode_channels(wi, wq, opts, device_batch=3, device=CPU)
    assert [[(s.message, s.freq, s.cycles, s.snr, s.sync) for s in ch]
            for ch in got] == \
        [[(s.message, s.freq, s.cycles, s.snr, s.sync) for s in ch]
         for ch in want]
    assert sum(len(ch) for ch in got) == 3


def test_prepare_windows_device_matches_host_feed(wins):
    """Windows already on the device (the front end's output), padded 3
    -> 4 rows, decode exactly like the int8 host feed of the same
    samples: the device planes are the int8 feed's own dequantized
    rows, so both paths see identical float32 windows."""
    wi, wq = wins
    di, dq = (a[:3].clone() for a in
              pmc.prepare_windows(wi, wq, device_batch=2, device=CPU).arrays)
    h = pmc.prepare_windows_device(di, dq, device_batch=2)
    assert h.n_pad == 4
    got = pmc.decode_channels(None, None, DecoderOptions(**QUICK), windows=h)
    ref = pmc.decode_channels(wi, wq, DecoderOptions(**QUICK),
                              device_batch=2, device=CPU)

    def key(spots):
        return [[(s.message, s.freq, s.dt, s.snr, s.sync, s.cycles)
                 for s in ch] for ch in spots]

    assert key(got) == key(ref)
    assert sum(len(ch) for ch in got) == 3
    with pytest.raises(ValueError, match="fec="):
        pmc.decode_channels(wi, wq, device=CPU, fec="device")


@pytest.mark.slow
def test_bench_batch_spot_lists_match_jax(jax_host_fec):
    """The first 32 windows of chip_smoke.py's 512-window batch (the
    port's copy of bench.py's make_batch, seed 11) through both
    packages' decode_channels with DecoderOptions() (43-jitter schedule,
    2 passes) and host FEC on the CPU: equal spot lists in message,
    jitter and cycles. Prints both counts (run with -s to see them)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wi, wq, _ = smoke.make_batch(32, seed=11)
    got = pmc.decode_channels(wi, wq, DecoderOptions(), device_batch=8,
                              device=CPU, fec="host")
    ref = jmc.decode_channels(wi, wq, JOptions(), device_batch=8,
                              fec="host")
    print(f"\n32 bench windows: JAX CPU {sum(len(ch) for ch in ref)} "
          f"spots, port CPU {sum(len(ch) for ch in got)} spots")
    assert [[(s.message, s.jitter, s.cycles) for s in ch] for ch in got] == \
        [[(s.message, s.jitter, s.cycles) for s in ch] for ch in ref]
    assert sum(len(ch) for ch in got) > 32


def test_resolve_type3_spots_matches_jax():
    """Re-resolving '<...>' spots rebuilds the same call and message
    (truncations included) as the JAX package, and leaves other spots
    and still-unknown hashes alone."""
    from rtlsdr_wsprd_tpu.models.decoder import Spot as JSpot
    from rtlsdr_wsprd_tpu.utils.nhash import nhash
    from rtlsdr_wsprd_tpu_torch.models.decoder import Spot
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import (
        WsprHashTable as PTable,
    )

    call = "PJ4/K1ABCDE"
    ih = nhash(call)
    base = dict(freq=14.0971, sync=0.5, snr=-10.0, dt=0.1, drift=0.0,
                jitter=0, message="<...> FK52UD 37", call="<...>",
                loc="FK52UD", pwr="37", cycles=10)
    rows = [dict(ihash=ih), dict(call="K1JT", message="K1JT FN20 37",
                                 loc="FN20", ihash=-1),
            dict(ihash=(ih + 1) % 32768)]
    jt, pt = WsprHashTable(), PTable()
    jt.put(ih, call)
    pt.put(ih, call)
    ref = jmc.resolve_type3_spots([[JSpot(**{**base, **r}) for r in rows]],
                                  jt)[0]
    mine = [Spot(**{**base, **r}) for r in rows]
    got = pmc.resolve_type3_spots([mine], pt)[0]
    assert [(s.call, s.message) for s in got] == \
        [(s.call, s.message) for s in ref]
    assert got[0].call == f"<{call}>"[:12]
    assert got[1] is mine[1] and got[2] is mine[2]


def test_entry_points_default_to_cuda():
    """device=None means the CUDA card: without one, every entry point
    raises instead of running on the CPU."""
    from rtlsdr_wsprd_tpu_torch.device import resolve_device
    from rtlsdr_wsprd_tpu_torch.frontend import decimate as pdec
    from rtlsdr_wsprd_tpu_torch.models.decoder import (
        WsprDecoder,
        decode_window,
    )
    from rtlsdr_wsprd_tpu_torch.parallel import mesh as pmesh
    from rtlsdr_wsprd_tpu_torch.runtime import multidaemon as pmd
    from rtlsdr_wsprd_tpu_torch.runtime import scheduler as psched
    from rtlsdr_wsprd_tpu_torch.runtime import sources as psrc

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    w = np.zeros((1, 45000), np.float32)
    raw = np.zeros(6400 * 10, np.uint8)
    calls = [
        lambda: resolve_device(None),
        lambda: pmc.decode_channels(w, w),
        lambda: pmc.prepare_windows(w, w),
        lambda: WsprDecoder(),
        lambda: WsprDecoder(staged=False),
        lambda: decode_window(w[0], w[0]),
        lambda: pmc.multichannel_decode_device(w, w, np.zeros(1, np.int32)),
        lambda: pmesh.local_mesh(),
        lambda: pmesh.make_mesh(),
        lambda: pmc.decode_channels(
            w, w, sharding=pmesh.channel_sharding(pmesh.local_mesh(1))),
        lambda: pdec.decimate_stage1(raw, raw, 5),
        lambda: pdec.decimate_stage2(w[0], w[0], 5),
        lambda: pdec.decimate_window(raw, raw),
        lambda: pdec.StreamingDecimator(),
        lambda: pdec.BatchedStreamingDecimator(2),
        lambda: psched.WsprDaemon(psrc.SyntheticBasebandSource(),
                                  DecoderOptions()),
        lambda: psrc.SyntheticRawSource(),
        lambda: pmd.MultiChannelDaemon(
            type("Bank", (), {"n_channels": 1})(), DecoderOptions()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_leaves_jax_out():
    """In a fresh interpreter, importing every module of the port (and
    chip_smoke.py and the port's tools/torch_*.py) loads neither
    jax nor the JAX package; the walk
    reaches the FEC modules (ops.fano, ops.fano_hybrid, ops.calibrate),
    the runtime layer, both CLIs, the channelizer, the multi-host
    runtime (parallel.distributed, parallel.streaming, parallel.dryrun)
    and the dense path (parallel.mesh, models.decoder's decode_window)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rtlsdr_wsprd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        f"for t in {TOOLS!r}:\n"
        "    importlib.import_module(t)\n"
        "new = ('ops.fano', 'ops.fano_hybrid', 'ops.calibrate', 'cli',\n"
        "       'multicli', 'frontend.host_decimate', 'runtime.reporting',\n"
        "       'runtime.sources', 'runtime.banks', 'runtime.scheduler',\n"
        "       'runtime.multidaemon', 'frontend.channelize',\n"
        "       'parallel.distributed', 'parallel.streaming',\n"
        "       'parallel.dryrun', 'parallel.mesh', 'models.decoder')\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in new)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rtlsdr_wsprd_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax():
    """No import statement of the port, of chip_smoke.py or of the
    port's tools/torch_*.py names jax or the JAX package (an AST
    scan, so lazy imports count too)."""
    files = sorted((REPO / "rtlsdr_wsprd_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += [REPO / "tools" / f"{t}.py" for t in TOOLS]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "rtlsdr_wsprd_tpu"), f"{f}: {n}"


def _spot_fields(spots):
    return [[(s.message, s.jitter, s.cycles, s.freq, s.snr, s.dt, s.sync)
             for s in ch] for ch in spots]


def test_hybrid_decode_matches_host_and_jax(wins, jax_host_fec,
                                            monkeypatch):
    """With RTLSDR_WSPRD_TPU_FEC=hybrid and RTLSDR_WSPRD_TPU_FEC_BUDGET=16,
    fec='auto' resolves to the hybrid FEC: every attempt goes through
    the device Fano at budget 16 (the plain version on the CPU), the
    stragglers through the native decoder. The spots equal the port's
    host FEC in every field and the JAX package's host FEC within
    torch_parity's tolerances."""
    from rtlsdr_wsprd_tpu_torch.ops import calibrate

    wi, wq = wins
    host = pmc.decode_channels(wi, wq, DecoderOptions(**QUICK),
                               device_batch=3, device=CPU, fec="host")
    calls = []
    real = pmc._fano_rounds

    def spy(gate, deint, delta, dev_maxcycles, full_maxcycles, device):
        calls.append((int(gate.sum()), dev_maxcycles, full_maxcycles))
        return real(gate, deint, delta, dev_maxcycles, full_maxcycles,
                    device)

    monkeypatch.setattr(pmc, "_fano_rounds", spy)
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "16")
    calibrate._CACHE.clear()
    try:
        hyb = pmc.decode_channels(wi, wq, DecoderOptions(**QUICK),
                                  device_batch=3, device=CPU)
    finally:
        calibrate._CACHE.clear()
    assert calls and all(c[1:] == (16, 10000) for c in calls)
    assert sum(c[0] for c in calls) >= 3  # every decode went through it
    assert _spot_fields(hyb) == _spot_fields(host)
    ref = jmc.decode_channels(wi, wq, JOptions(**QUICK), device_batch=3,
                              fec="host")
    assert_spots_match(hyb, ref)
    assert sum(len(ch) for ch in hyb) == 3


def test_fano_rounds_hybrid_matches_host_rounds():
    """The hybrid rounds on dense attempts (device budget 4, so most
    attempts become stragglers; first-success skipping across one call)
    return exactly the JAX package's host rounds: the same lanes,
    jitters, bytes and cycles."""
    J, G = 6, 5
    rng = np.random.default_rng(31)
    good = _hard("K1JT FN20 37")
    noisy = np.clip(good.astype(int) + rng.normal(0, 60, 162), 0,
                    255).astype(np.uint8)
    deint = rng.integers(0, 256, (J, G, 162)).astype(np.uint8)
    gate = rng.random((J, G)) < 0.6
    deint[1, 0], gate[1, 0] = good, True
    deint[4, 0], gate[4, 0] = noisy, True
    deint[3, 2], gate[3, 2] = noisy, True
    deint[:, 3], gate[:, 3] = good, True   # every jitter decodes
    gate[:, 4] = False                     # a lane with no attempt
    got = pmc._fano_rounds(gate, deint, 60, 4, 10000, torch.device(CPU))
    ref = jmc._fano_rounds_host(gate, deint, 60, 10000)
    assert got == ref
    assert got[0][0] == 1 and got[3][0] == int(np.nonzero(gate[:, 3])[0][0])


@pytest.mark.parametrize("transfer_dtype", pmc.TRANSFER_DTYPES)
def test_pipelined_matches_sequential(wins, jax_host_fec, transfer_dtype):
    """The 2-deep pipelined stream at each transfer format yields each
    batch's spots equal to decode_channels at that format on that batch,
    in order, and the JAX package's pipelined stream at the same format
    (torch_parity.assert_spots_match's tolerances)."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    want = _spot_fields(pmc.decode_channels(
        wi, wq, opts, device_batch=3, transfer_dtype=transfer_dtype,
        device=CPU))
    batches = [(wi, wq), (wi[:2], wq[:2]), (wi, wq)]
    out = list(pmc.decode_channels_pipelined(
        batches, opts, device_batch=3, transfer_dtype=transfer_dtype,
        device=CPU))
    assert [_spot_fields(o) for o in out] == [want, want[:2], want]
    ref = list(jmc.decode_channels_pipelined(
        batches, JOptions(**QUICK), device_batch=3,
        transfer_dtype=transfer_dtype, fec="host"))
    assert len(ref) == len(out)
    for got, r in zip(out, ref):
        assert_spots_match(got, r)
    assert sum(len(ch) for ch in out[0]) == 3


def test_decoders_reject_unknown_transfer_dtype(wins):
    """An unknown transfer format raises ValueError in every stream and
    multi-device decode before a batch is read or a window uploaded (the
    pipelined ones when their first batch is asked for)."""
    wi, wq = wins
    read = []

    def batches():
        read.append(1)
        yield wi, wq

    for decode, kw in ((pmc.decode_channels_pipelined, dict(device=CPU)),
                       (pmc.decode_channels_pipelined_multidevice,
                        dict(devices=["cpu", "cpu"]))):
        with pytest.raises(ValueError, match="transfer_dtype"):
            next(decode(batches(), transfer_dtype="bfloat16", **kw))
    assert read == []
    with pytest.raises(ValueError, match="transfer_dtype"):
        pmc.decode_channels_multidevice(wi, wq, devices=["cpu"],
                                        transfer_dtype="uint8")


def test_prepare_windows_device_device_arg(wins):
    """prepare_windows_device(device=...): None and the planes' own
    device wrap them where they lie (the handle's device is theirs, the
    planes are not copied); any other device raises and nothing is moved
    or falls back."""
    wi, wq = wins
    di, dq = (a[:3].clone() for a in
              pmc.prepare_windows(wi, wq, device_batch=3, device=CPU).arrays)
    for device in (None, "cpu", torch.device("cpu")):
        h = pmc.prepare_windows_device(di, dq, device_batch=3, device=device)
        assert h.device == torch.device("cpu")
        assert h.arrays[0].data_ptr() == di.data_ptr()
    h2 = pmc._DeviceWindows.from_device(di, dq, 2, device="cpu")
    assert h2.n_pad == 4 and h2.device == torch.device("cpu")
    with pytest.raises((ValueError, RuntimeError)):
        pmc.prepare_windows_device(di, dq, device="cuda:0")
    with pytest.raises(ValueError, match="device"):
        pmc.prepare_windows_device(di, dq, device="meta")
    with pytest.raises(ValueError, match="lie on"):
        pmc._DeviceWindows.from_device(di.to("meta"), dq.to("meta"), 3,
                                       device="cpu")
    with pytest.raises(ValueError, match="Q on"):
        pmc._DeviceWindows.from_device(di, dq.to("meta"), 3)


def test_native_nhash_matches_jax_and_python():
    """native.nhash (wspr_nhash of native/hostdsp.cpp) equals the port's
    Python hash and, where the JAX package's binding is built, the JAX
    binding: random keys of 1-29 bytes (the 12-byte block boundary twice)
    and callsigns as str and bytes."""
    from rtlsdr_wsprd_tpu_torch.utils.nhash import nhash as py_nhash

    rng = np.random.default_rng(1)
    keys = [bytes(rng.integers(1, 255, n, dtype=np.uint8))
            for n in range(1, 30) for _ in range(20)]
    keys += [b"K1JT", b"G4ABC", b"PJ4/K1ABC"]
    for key in keys:
        got = pnative.nhash(key)
        assert got == py_nhash(key) and 0 <= got < 32768
        if jnative.AVAILABLE:
            assert got == jnative.nhash(key)
    assert pnative.nhash("K1JT") == pnative.nhash(b"K1JT")


def test_pipelined_accepts_prepared_handles(wins):
    """prepare_windows() and prepare_windows_device() handles decode in
    the stream exactly as the host-array feed does."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    want = _spot_fields(pmc.decode_channels(wi, wq, opts, device_batch=3,
                                            device=CPU))
    h = pmc.prepare_windows(wi, wq, device_batch=3, device=CPU)
    d = pmc.prepare_windows_device(*(a[:3].clone() for a in h.arrays),
                                   device_batch=3)
    out = list(pmc.decode_channels_pipelined(iter([h, d]), opts))
    assert [_spot_fields(o) for o in out] == [want, want]
    assert sum(len(ch) for ch in out[0]) == 3


def test_strict_hash_order_serializes_batches(monkeypatch):
    """strict_hash_order with usehashtable serializes the batches: batch
    k+1's decode starts only after batch k's ended."""
    import time

    timeline = []

    def fake_decode(i, q, options, ht, windows=None, fec="auto", **kw):
        k = sum(1 for ev, _ in timeline if ev == "start")
        timeline.append(("start", time.perf_counter()))
        if k == 0:
            time.sleep(0.25)  # make any overlap visible
        timeline.append(("end", time.perf_counter()))
        return [[] for _ in range(windows.B)]

    monkeypatch.setattr(pmc, "decode_channels", fake_decode)
    z = np.zeros((1, 45000), np.float32)
    opts = DecoderOptions(quickmode=True, usehashtable=True)
    out = list(pmc.decode_channels_pipelined(
        iter([(z, z), (z, z)]), opts, pmc.WsprHashTable(), depth=2,
        device_batch=1, device=CPU, strict_hash_order=True))
    assert out == [[[]], [[]]]
    starts = [t for ev, t in timeline if ev == "start"]
    ends = [t for ev, t in timeline if ev == "end"]
    assert len(starts) == 2 and starts[1] >= ends[0]


def test_pipelined_on_error_isolates_poisoned_batch(monkeypatch):
    """A batch whose decode raises is reported to on_error and yields
    empty spot lists, and the stream goes on; without on_error the
    exception propagates."""
    real = pmc.decode_channels
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("poisoned batch")
        return real(*args, **kwargs)

    rng = np.random.default_rng(5)
    batch = (rng.normal(0, 0.1, (2, 45000)).astype(np.float32),
             rng.normal(0, 0.1, (2, 45000)).astype(np.float32))
    monkeypatch.setattr(pmc, "decode_channels", flaky)
    errors = []
    out = list(pmc.decode_channels_pipelined(
        [batch, batch], DecoderOptions(**QUICK), device_batch=2,
        device=CPU, on_error=errors.append))
    assert len(out) == 2
    assert out[0] == [[], []]
    assert isinstance(out[1], list) and len(out[1]) == 2
    assert len(errors) == 1 and "poisoned" in str(errors[0])
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="poisoned"):
        list(pmc.decode_channels_pipelined(
            [batch], DecoderOptions(**QUICK), device_batch=2, device=CPU))


@pytest.mark.slow
def test_pipelined_type3_resolves_under_forced_race(monkeypatch):
    """The hash-teaching guarantee holds by construction: the teacher
    batch's decode is held until the type-3 batch has decoded (so its
    spot assembles as '<...>'), with the full 2-deep overlap; yield-time
    resolution still delivers '<PJ4/K1ABC>' with the reference's
    fields."""
    import threading

    from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr
    from rtlsdr_wsprd_tpu_torch.utils.hashtable import (
        WsprHashTable as PTable,
    )

    def win(msg, seed):
        i, q = synth_window_at_snr(msg, snr_db=8.0, f0=20.0, seed=seed)
        i, q = normalize_minus3db(i, q)
        return i[None], q[None]

    batches = [win("PJ4/K1ABC 37", 41), win("<PJ4/K1ABC> FK52UD 37", 42)]
    user_done = threading.Event()
    lock = threading.Lock()
    state = {"calls": 0, "raw_user_calls": None}
    real = pmc.decode_channels

    def racing(i, q, options, ht, **kw):
        with lock:
            k = state["calls"]
            state["calls"] += 1
        if k == 0:
            # the teacher decodes (and teaches) only after the type-3
            # batch finished decoding: the worst-case race
            assert user_done.wait(timeout=600.0), "user batch stalled"
            return real(i, q, options, ht, **kw)
        res = real(i, q, options, ht, **kw)
        state["raw_user_calls"] = {s.call for ch in res for s in ch}
        user_done.set()
        return res

    monkeypatch.setattr(pmc, "decode_channels", racing)
    opts = DecoderOptions(quickmode=True, usehashtable=True)
    out = list(pmc.decode_channels_pipelined(
        iter(batches), opts, PTable(), depth=2, device_batch=1,
        device=CPU, strict_hash_order=False))
    assert len(out) == 2
    assert "<...>" in state["raw_user_calls"]
    assert any(s.message == "PJ4/K1ABC 37" for s in out[0][0])
    spot = next(s for s in out[1][0] if s.ihash >= 0)
    assert spot.call == "<PJ4/K1ABC>"
    assert spot.message == "<PJ4/K1ABC> FK52UD 37"
    assert (spot.loc, spot.pwr) == ("FK52UD", "37")

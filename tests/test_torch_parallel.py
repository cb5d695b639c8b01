"""The port's multi-device decode and multi-host runtime against the JAX
package's, on the CPU: decode_channels_multidevice and its pipelined
form over a list of CPU devices, the device rule, rank slices, the
time-sharded decimations in a 2-process gloo job against the JAX
package's shard_map on a 2-device CPU mesh, the meshes, and the dry run
of N ranks."""

import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import Mesh

from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.parallel import distributed as jdist
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc
from rtlsdr_wsprd_tpu.parallel import streaming as jstream
from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
from rtlsdr_wsprd_tpu_torch.device import resolve_devices
from rtlsdr_wsprd_tpu_torch.frontend.filters import R1, R2
from rtlsdr_wsprd_tpu_torch.parallel import distributed as pdist
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as pmc
from rtlsdr_wsprd_tpu_torch.parallel import streaming as pstream

from torch_parity import CPU, assert_spots_match, windows3
from torch_parity import jax_host_fec  # noqa: F401  (fixture)
from torch_parity import port_calibration  # noqa: F401  (fixture)

QUICK = dict(quickmode=True)
TWO_CPUS = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def wins():
    return windows3()


def _fields(per_channel):
    return [[(s.message, s.jitter, s.cycles, s.freq, s.snr, s.dt, s.sync)
             for s in ch] for ch in per_channel]


def _per_shard(wi, wq, opts, bounds=(0, 1, 3), transfer_dtype="int8"):
    """decode_channels on each shard of the windows in turn: what a
    multi-device decode over those shards computes, field for field (a
    shard's lane buckets and subtraction lanes hold its own windows
    only, so its floats may round otherwise than the whole batch's)."""
    return [ch for s0, s1 in zip(bounds, bounds[1:])
            for ch in pmc.decode_channels(wi[s0:s1], wq[s0:s1], opts,
                                          device_batch=3,
                                          transfer_dtype=transfer_dtype,
                                          device=CPU)]


@pytest.mark.parametrize("transfer_dtype", pmc.TRANSFER_DTYPES)
def test_multidevice_matches_jax(wins, jax_host_fec, transfer_dtype):
    """decode_channels_multidevice over two CPU devices (shards of 1 and
    2 windows) at each transfer format gives the JAX package's
    decode_channels_multidevice spot lists on two of its CPU devices at
    that format and the port's one-device decode of the whole batch at
    that format (torch_parity.assert_spots_match's tolerances), and
    decode_channels on each shard at that format exactly."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    got = pmc.decode_channels_multidevice(wi, wq, opts, devices=TWO_CPUS,
                                          device_batch=3,
                                          transfer_dtype=transfer_dtype)
    ref = jmc.decode_channels_multidevice(wi, wq, JOptions(**QUICK),
                                          devices=jax.devices()[:2],
                                          device_batch=3,
                                          transfer_dtype=transfer_dtype,
                                          fec="host")
    assert_spots_match(got, ref)
    assert_spots_match(got, pmc.decode_channels(
        wi, wq, opts, device_batch=3, transfer_dtype=transfer_dtype,
        device=CPU))
    assert _fields(got) == _fields(_per_shard(
        wi, wq, opts, transfer_dtype=transfer_dtype))
    assert sum(len(ch) for ch in got) == 3


def test_pipelined_multidevice_matches_sequential(wins):
    """Three batches through the pipelined multi-device decode (2 CPU
    devices, depth 2), fed as window pairs and as per-shard handles
    (and one whole-batch handle), equal decode_channels on each shard
    of each batch in every spot field, in batch order."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    want = _per_shard(wi, wq, opts)
    rev = _per_shard(wi[::-1].copy(), wq[::-1].copy(), opts)
    batches = [(wi, wq), (wi[::-1].copy(), wq[::-1].copy()), (wi, wq)]
    out = list(pmc.decode_channels_pipelined_multidevice(
        batches, opts, devices=TWO_CPUS, device_batch=3))
    assert [_fields(o) for o in out] == [_fields(r)
                                         for r in (want, rev, want)]
    # a handle's windows are decoded (and subtracted from) in place:
    # every batch gets handles of its own
    handles = [[pmc.prepare_windows(wi[:1], wq[:1], 1, device=CPU),
                pmc.prepare_windows(wi[1:], wq[1:], 2, device=CPU)]
               for _ in range(2)]
    handles.append(pmc.prepare_windows(wi, wq, 3, device=CPU))
    out = list(pmc.decode_channels_pipelined_multidevice(
        handles, opts, devices=TWO_CPUS))
    whole = _per_shard(wi, wq, opts, bounds=(0, 3))
    assert [_fields(o) for o in out] == [_fields(r)
                                         for r in (want, want, whole)]


def test_pipelined_multidevice_isolates_a_failed_shard(wins, monkeypatch):
    """With on_error, a shard whose decode raises yields empty lists for
    its own channels only; the other shard of the same batch and the
    other batches keep their spots, and the error is reported once.
    Without on_error the exception propagates."""
    wi, wq = wins
    opts = DecoderOptions(**QUICK)
    want = _per_shard(wi, wq, opts)
    real = pmc.decode_channels
    seen = {"n": 0}

    def flaky(*a, windows=None, **kw):
        # a batch's first shard holds 1 window, its second 2; at depth 1
        # the batches decode one after another
        if windows.B == 1:
            seen["n"] += 1
            if seen["n"] == 2:  # batch 1's first shard
                raise RuntimeError("poisoned shard")
        return real(*a, windows=windows, **kw)

    monkeypatch.setattr(pmc, "decode_channels", flaky)
    errors = []
    out = list(pmc.decode_channels_pipelined_multidevice(
        [(wi, wq)] * 3, opts, devices=TWO_CPUS, device_batch=3, depth=1,
        on_error=errors.append))
    assert [str(e) for e in errors] == ["poisoned shard"]
    assert [_fields(o) for o in out] == [
        _fields(r) for r in (want, [[]] + want[1:], want)]
    seen["n"] = 0
    with pytest.raises(RuntimeError, match="poisoned shard"):
        list(pmc.decode_channels_pipelined_multidevice(
            [(wi, wq)] * 3, opts, devices=TWO_CPUS, device_batch=3,
            depth=1))


FOUR_CPUS = ["cpu"] * 4


def _wsprbench():
    """The benchmark's generator, reference and comparison (the repo's
    ``wsprbench/``, which imports nothing of the JAX package)."""
    import sys
    from torch_parity import REPO
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from wsprbench import compare, gen
    from wsprbench.reference import constants, decode
    return compare, gen, constants, decode


@pytest.fixture(scope="module")
def four_cards():
    """The four-card farm's content at a small size: 16 windows of the
    ``mixed_x4`` mix (the ``mixed`` content) in 2 pulls of 8, each pull
    4 shards of 2 windows; the pulls, decode_channels on each shard of
    each pull, and the mix."""
    _, gen, _, _ = _wsprbench()
    mix = gen.load_mix(_wsprbench_file("traffic/mixed_x4.json"))
    mix = dict(mix, windows=16, batch=8, check_windows=4)
    pool = gen.baseband(mix, 2**31 + 23, device="cpu")
    pulls = [(pool.wi[a:a + 8], pool.wq[a:a + 8]) for a in (0, 8)]
    opts = DecoderOptions()
    want = [[ch for s0 in range(0, 8, 2)
             for ch in pmc.decode_channels(wi[s0:s0 + 2], wq[s0:s0 + 2],
                                           opts, device_batch=2, device=CPU,
                                           fec="auto")]
            for wi, wq in pulls]
    return pool, pulls, want, opts


def _wsprbench_file(rel):
    from torch_parity import REPO
    return REPO / "wsprbench" / rel


def test_pipelined_multidevice_four_shards_match_each_shard_and_reference(
        four_cards):
    """decode_channels_pipelined_multidevice over four CPU shards (the
    four-card farm's shape: int8 link, depth 2, fec auto) gives, for
    each of 2 pulls of 8 windows, decode_channels on each 2-window shard
    in every spot field; and on a signal window of each half of a pull
    (cards 0-1 and 2-3) the spots equal the plain reference's decode of
    the int8 link samples under the four-card cell's limits."""
    import json
    from concurrent.futures import ThreadPoolExecutor
    compare, _, constants, decode = _wsprbench()
    pool, pulls, want, opts = four_cards
    out = list(pmc.decode_channels_pipelined_multidevice(
        pulls, opts, depth=2, device_batch=2, transfer_dtype="int8",
        fec="auto", devices=FOUR_CPUS))
    assert [_fields(o) for o in out] == [_fields(w) for w in want]
    assert sum(len(ch) for o in out for ch in o) >= 8
    judged = [next(w for w in range(a, a + 4) if pool.truth[w])
              for a in (8, 12)]
    with ThreadPoolExecutor(len(judged)) as ex:
        ref = dict(zip(judged, ex.map(
            lambda w: decode.decode_window(decode.quantize(pool.wi[w]),
                                           decode.quantize(pool.wq[w]),
                                           constants.Options()),
            judged)))
    numbers = compare.spot_numbers(
        [(w, out[w // 8][w % 8]) for w in judged], ref)
    limits = json.loads(_wsprbench_file(
        "limits/farm.mixed.x4.json").read_text())
    ok, checks = compare.judge(numbers, limits)
    assert ok, checks
    assert numbers["spots_judged"] >= 2
    for w in judged:
        assert {s.message for s in out[w // 8][w % 8]} == \
            {s["message"] for s in ref[w]}


def test_pipelined_multidevice_four_shards_isolate_a_failed_quarter(
        four_cards, monkeypatch):
    """With on_error, the shard of card 2 of the second pull raising
    empties that pull's third quarter only: every other shard of both
    pulls keeps decode_channels' spots, and the error is reported once."""
    pool, pulls, want, opts = four_cards
    real = pmc.decode_channels
    poisoned = pmc.prepare_windows(pool.wi[12:14], pool.wq[12:14], 2,
                                   device=CPU).arrays[0]

    def flaky(*a, windows=None, **kw):
        if torch.equal(windows.arrays[0], poisoned):
            raise RuntimeError("poisoned shard")
        return real(*a, windows=windows, **kw)

    monkeypatch.setattr(pmc, "decode_channels", flaky)
    errors = []
    out = list(pmc.decode_channels_pipelined_multidevice(
        pulls, opts, depth=2, device_batch=2, fec="auto", devices=FOUR_CPUS,
        on_error=errors.append))
    assert [str(e) for e in errors] == ["poisoned shard"]
    emptied = want[1][:4] + [[], []] + want[1][6:]
    assert [_fields(o) for o in out] == [_fields(want[0]), _fields(emptied)]


def test_unindexed_cuda_names_the_current_card(monkeypatch):
    """None and a bare ``cuda`` name the calling thread's current card by
    its index (here card 1 of 2), so a handle, mesh or daemon made on it
    stays on it when worker threads, whose current card is 0, decode."""
    from rtlsdr_wsprd_tpu_torch.device import resolve_device
    from rtlsdr_wsprd_tpu_torch.parallel.mesh import make_mesh
    from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card1 = torch.device("cuda", 1)
    assert resolve_device(None) == resolve_device("cuda") == card1
    assert str(resolve_device(None)) == "cuda:1"
    assert resolve_devices(["cuda"]) == [card1]
    assert make_mesh(["cuda"]).devices == (card1,)
    daemon = MultiChannelDaemon(type("Bank", (), {"n_channels": 1})(),
                                DecoderOptions(), frontend="host",
                                device=None)
    assert daemon.device == card1 and daemon.devices == [card1]


def test_device_lists_never_fall_back():
    """devices=None means every visible CUDA card and raises without one;
    a card that is not there raises; CPU entries resolve."""
    assert resolve_devices(TWO_CPUS) == [torch.device("cpu")] * 2
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None names it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_devices(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_devices(["cpu", "cuda:1"])
    with pytest.raises(ValueError, match="no devices"):
        resolve_devices([])
    w = np.zeros((1, 45000), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmc.decode_channels_multidevice(w, w)


@pytest.mark.parametrize("nprocs", [1, 2, 3, 4, 5, 8])
def test_rank_slices_match_jax(nprocs, monkeypatch):
    """rank_slice (explicit and read from the job) and local_batch_slice
    equal the JAX package's over n_items 0..17 for every rank."""
    for rank in range(nprocs):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda n=nprocs: n)
        monkeypatch.setattr(tdist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(tdist, "get_world_size", lambda n=nprocs: n)
        for n_items in range(18):
            want = jdist.rank_slice(n_items, rank, nprocs)
            assert pdist.rank_slice(n_items, rank, nprocs) == want
            assert pdist.rank_slice(n_items) == want
            assert pdist.local_batch_slice(n_items) == \
                jdist.local_batch_slice(n_items)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _streams(seed: int = 12):
    """A raw stream of 2 x 128 stage-1 frames and a mid-rate stream of
    2 x 64 stage-2 frames, float32 planes (2, L)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 30, (2, 2 * 128 * R1)).astype(np.float32),
            rng.normal(0, 1, (2, 2 * 64 * R2)).astype(np.float32))


def _sharded_rank(rank: int, n: int, port: int, out_dir: str) -> None:
    """One rank of the 2-process job: its shards of both streams through
    the sharded decimations, the meshes' shapes; saved for the test."""
    pdist.initialize(f"127.0.0.1:{port}", n, rank)
    try:
        res = {}
        for name, x, fn in (("s1", _streams()[0],
                             pstream.decimate_stage1_sharded),
                            ("s2", _streams()[1],
                             pstream.decimate_stage2_sharded)):
            L = x.shape[1] // n
            part = torch.from_numpy(x[:, rank * L:(rank + 1) * L].copy())
            yI, yQ = fn(part[0], part[1])
            res[name] = np.stack([yI.numpy(), yQ.numpy()])
        mesh = pdist.global_channel_mesh()
        hc = pdist.host_chip_mesh()
        res["mesh"] = np.array([*mesh.shape, *hc.shape])
        res["names"] = np.array([*mesh.mesh_dim_names,
                                 *hc.mesh_dim_names])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        pdist.shutdown()


def _jax_sharded(x, n: int, stage: int):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    fn = (jstream.decimate_stage1_sharded if stage == 1
          else jstream.decimate_stage2_sharded)
    yI, yQ = fn(x[0], x[1], mesh)
    return np.stack([np.asarray(yI), np.asarray(yQ)])


def test_time_sharded_decimation_two_ranks_matches_jax(tmp_path):
    """Two gloo processes, each holding half of a raw stream and half of
    a mid-rate stream, trade halos and decimate their halves (the plain
    versions on the CPU): every frame, the wrapped ones included, equals
    the JAX package's decimate_stage{1,2}_sharded on a 2-device CPU mesh
    within 1e-4 of the output scale (float32 sums in another order).
    The 1-D mesh has 2 ranks over "ch", the 2-D one 1 host x 2 ranks."""
    torch.multiprocessing.spawn(_sharded_rank,
                                args=(2, _free_port(), str(tmp_path)),
                                nprocs=2, join=True)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    x1, x2 = _streams()
    for name, x, stage in (("s1", x1, 1), ("s2", x2, 2)):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        want = _jax_sharded(x, 2, stage)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    for r in ranks:
        assert list(r["mesh"]) == [2, 1, 2]
        assert list(r["names"]) == ["ch", "host", "ch"]


def test_time_sharded_decimation_one_rank_matches_jax():
    """A job of one rank: the halo is the shard's own head (the ring of
    one), as on a 1-device JAX mesh; and the shard-length checks."""
    pdist.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        x1, x2 = _streams(7)
        for x, fn, stage in ((x1, pstream.decimate_stage1_sharded, 1),
                             (x2, pstream.decimate_stage2_sharded, 2)):
            yI, yQ = fn(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
            want = _jax_sharded(x, 1, stage)
            np.testing.assert_allclose(np.stack([yI.numpy(), yQ.numpy()]),
                                       want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
        short = torch.zeros(R2 * 20)
        with pytest.raises(ValueError, match="shard too short"):
            pstream.decimate_stage2_sharded(short, short)
        with pytest.raises(ValueError, match="multiple of 80"):
            pstream.decimate_stage1_sharded(short[:-1], short[:-1])
    finally:
        pdist.shutdown()
    assert pstream.valid_frames(123_456) == jstream.valid_frames(123_456)
    assert pstream.valid_frames_stage2(98_765) == \
        jstream.valid_frames_stage2(98_765)


def test_dryrun_multichip_two_cpu_ranks():
    """dryrun_multichip(2, "cpu"): two gloo ranks each decode their slice
    of a 4-window batch (the staged decode, and the dense step in quick
    mode and on the full schedule) and run both sharded decimations;
    rank 0's checks against the unsharded decode, the unsharded dense
    steps (every ChannelDecode field) and decimations pass. On the CPU
    no rank launches a kernel (the plain versions run); each rank's
    sharded decimations make one polyphase call a stage, at its shard
    plus the halo; both dense runs decode both of a rank's windows."""
    from rtlsdr_wsprd_tpu_torch.parallel.dryrun import (
        FRAMES1,
        FRAMES2,
        dryrun_multichip,
    )

    assert dryrun_multichip(2, "cpu") == [{
        "launches": {"tc": 0, "direct": 0, "fano": 0, "stft": 0,
                     "coarse": 0, "correlator": 0},
        "calls": {("stage1", "float32", 1, FRAMES1 * 80 + 560, FRAMES1): 1,
                  ("stage2", "float32", 1, FRAMES2 * 80 + 2320, FRAMES2): 1},
        "dense_windows_decoded": [2, 2],
    }] * 2

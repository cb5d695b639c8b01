"""Scaling overheads of the PyTorch/CUDA port: shards and ranks on one
card.

The counterpart of tools/scaling.py, in its three modes, with its
constants, windows, JSON keys and staggered file handshake. Every shard
and every rank here shares one card, as the JAX tool's virtual devices
share one core, so wall time cannot fall with their number. What these
runs measure is the overhead that the partitioning, the gloo runtime
and the multi-rank daemon machinery add to perfectly divided work; on
several cards each shard or rank would have a card of its own.

* ``mesh``: the dense decode step ``multichannel_decode_device`` on
  B_GLOBAL windows, unsharded on the device, against the same step over
  ``channel_sharding(make_mesh([device] * 8))`` (parallel/mesh.py: one
  row shard a mesh device, each decoded from its own host thread). The
  outputs must be equal in every ``ChannelDecode`` field.
* ``dist``: two gloo ranks (``parallel/distributed.py`` ``initialize``,
  ``decode_local_shard``), each decoding half of B_GLOBAL windows, against
  one process decoding all of them and one decoding half. Each rank's
  timed phase waits for the rank before it to finish its own (a flag
  file), so every measured decode runs alone on the card; per-process
  CPU seconds a window, and wall seconds.
* ``daemon``: two ranks of the many-dongle daemon
  (``MultiChannelDaemon``, quick mode) over a pre-rendered
  ``SyntheticRawBank`` replay of their half of C_GLOBAL channels,
  against one process on all of them and one on half; CPU seconds a
  channel-window, and the ingest seconds apart.

A timed sample runs the decode (or the daemon) back to back until it
has lasted MIN_SAMPLE_S, and its wall and CPU seconds are divided by
the runs: on the card one run of the dist mode takes ~20 ms, and a
host's process CPU clock may advance in 10 ms ticks. Each process also
prints its kernel launches and the runs a sample, on a line of their
own before its JSON row.

Usage: python tools/torch_scaling.py mesh|dist|daemon [--device DEV]
``--device`` defaults to the CUDA card (raises without one); ``cpu``
runs the plain PyTorch versions. Prints the card's name and power limit
on a line, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.device import resolve_device  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel import (  # noqa: E402
    distributed as dist,
)
from rtlsdr_wsprd_tpu_torch.parallel.dryrun import (  # noqa: E402
    launch_counts,
)
from rtlsdr_wsprd_tpu_torch.parallel.mesh import (  # noqa: E402
    channel_sharding,
    make_mesh,
)
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    ChannelDecode,
    _mesh_step,
    multichannel_decode_device,
    shard_windows,
)
from torch_measure import device_banner  # noqa: E402

B_GLOBAL = 8
DEVICE_BATCH = 2
DECODE_KW = dict(quickmode=True, lagstep=16, max_attempts=16,
                 maxcycles=64)  # the dry run's quick dense step
MESH_SHARDS = 8
C_GLOBAL = 4  # daemon mode: global synthetic channel count
RANK_TIMEOUT_S = 3600
MIN_SAMPLE_S = 1.0  # least wall seconds of a timed sample


def _windows(n: int):
    """n windows, window k one ``K1JT FN20 37`` at 0 dB and f0 = -90 +
    23 k Hz (seed 50 + k), normalized: the JAX tool's bit for bit."""
    from rtlsdr_wsprd_tpu_torch.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu_torch.runtime.synth import synth_window_at_snr

    wi = np.zeros((n, 45000), np.float32)
    wq = np.zeros((n, 45000), np.float32)
    for k in range(n):
        i, q = synth_window_at_snr(
            "K1JT FN20 37", snr_db=0.0, f0=-90.0 + 23.0 * k, seed=50 + k)
        wi[k], wq[k] = normalize_minus3db(i, q)
    return wi, wq


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_mode(device=None, B: int = B_GLOBAL, devices=None,
              reps: int = 3) -> dict:
    """The dense step unsharded on ``device`` (None: the CUDA card)
    against the same step over a mesh of ``devices`` (default
    MESH_SHARDS copies of ``device``), each timed as the mean of
    ``reps`` calls after one warm call. Raises unless the sharded output
    equals the unsharded one in every ChannelDecode field."""
    dev = resolve_device(device)
    mesh = make_mesh(devices if devices is not None
                     else [dev] * MESH_SHARDS)
    sharding = channel_sharding(mesh)
    wi, wq = _windows(B)
    md = torch.full((B,), 4, dtype=torch.int32, device=dev)
    plain_args = (torch.from_numpy(wi).to(dev), torch.from_numpy(wq).to(dev))

    def unsharded():
        out = multichannel_decode_device(*plain_args, md, **DECODE_KW)
        return ChannelDecode(*(x.cpu().numpy() for x in out))

    shards = shard_windows(wi, wq, mesh)

    def sharded():
        return _mesh_step(*shards, sharding, 4, DECODE_KW)

    def timed(fn):
        out = fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
            _sync(dev)
        return (time.perf_counter() - t0) / reps, out

    t_plain, want = timed(unsharded)
    t_shard, got = timed(sharded)
    for name, g, w in zip(ChannelDecode._fields, got, want):
        if not np.array_equal(np.asarray(g).astype(w.dtype), w):
            raise RuntimeError(f"sharded dense step: field {name} differs "
                               "from the unsharded step")
    if not want.success.any(axis=1).all():
        raise RuntimeError("a window of the mesh mode decoded nothing")
    return {
        "mode": "mesh", "B": B, "devices": len(mesh.devices),
        "t_unsharded_s": round(t_plain, 4),
        "t_sharded_8dev_s": round(t_shard, 4),
        "spmd_overhead": round(t_shard / t_plain - 1.0, 4),
    }


def _wait_for(path: str, timeout_s: float = 3000.0) -> None:
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        time.sleep(0.1)
        if time.time() > deadline:
            raise TimeoutError(f"stagger flag never appeared: {path}")


def _timed(run, samples: int):
    """(wall s, CPU s, extra, runs a sample): the least over ``samples``
    timed samples of a run's seconds on the wall clock and on this
    process's CPU clock (every thread), and of the mean of what the runs
    returned (``extra``); a sample is as many back-to-back runs as make
    MIN_SAMPLE_S by one untimed run's wall time."""
    t0 = time.perf_counter()
    run()
    reps = max(1, math.ceil(MIN_SAMPLE_S / (time.perf_counter() - t0)))
    wall = cpu = extra = float("inf")
    for _ in range(samples):
        w0, c0 = time.perf_counter(), time.process_time()
        got = sum(run() for _ in range(reps))
        wall = min(wall, (time.perf_counter() - w0) / reps)
        cpu = min(cpu, (time.process_time() - c0) / reps)
        extra = min(extra, got / reps)
    return wall, cpu, extra, reps


def _report(row: dict, reps: int) -> None:
    """A rank's kernel launches and runs a sample, then its JSON row
    (the last line)."""
    print("process " + json.dumps({"launches": launch_counts(),
                                   "runs_a_sample": reps}), flush=True)
    print(json.dumps(row), flush=True)


def dist_worker(rank: int, nprocs: int, port: int, stagger: str = "",
                b_override: int = 0, device=None) -> None:
    dev = resolve_device(device)
    if nprocs > 1:
        dist.initialize(f"127.0.0.1:{port}", nprocs, rank)
    try:
        # staggered measurement: rank r idles (sleep-polling) until rank
        # r-1 finished its whole synth+warm+timed phase, so the measured
        # decode runs alone on the card; only the other rank's gloo
        # threads stay live, which is the overhead being measured
        if stagger and rank > 0:
            _wait_for(f"{stagger}.{rank - 1}")
        b_local = b_override or B_GLOBAL // nprocs
        wi, wq = _windows(B_GLOBAL)
        sl = (dist.local_batch_slice(B_GLOBAL) if nprocs > 1
              else slice(0, b_local))
        opts = DecoderOptions(quickmode=True)

        def run():
            spots = dist.decode_local_shard(wi[sl], wq[sl], opts,
                                            device_batch=DEVICE_BATCH,
                                            device=dev)
            _sync(dev)
            n_spots = sum(len(ch) for ch in spots)
            if n_spots < b_local:  # every window carries a 0 dB signal
                raise SystemExit(f"rank {rank}: {n_spots} spots on "
                                 f"{b_local} windows")
            return 0.0

        run()  # warm: builds, calibration, caches
        # best-of-3: least scheduler contamination
        wall, cpu, _, reps = _timed(run, 3)
        _report({
            "rank": rank, "nprocs": nprocs, "windows": b_local,
            "wall_s": round(wall, 3), "cpu_s": round(cpu, 3),
            "cpu_s_per_window": round(cpu / b_local, 4),
        }, reps)
        if stagger:
            open(f"{stagger}.{rank}", "w").close()
            # rank 0 holds the rendezvous: it outlives every rank
            _wait_for(f"{stagger}.{nprocs - 1}")
    finally:
        dist.shutdown()


def daemon_worker(rank: int, nprocs: int, port: int, stagger: str = "",
                  c_override: int = 0, device=None) -> None:
    """One rank of the many-dongle daemon chain (multicli --nprocs
    without its argv): raw uint8 -> decimate -> window -> staged decode
    -> spots on this rank's channel slice."""
    from rtlsdr_wsprd_tpu_torch.runtime.banks import SyntheticRawBank
    from rtlsdr_wsprd_tpu_torch.runtime.multidaemon import MultiChannelDaemon

    dev = resolve_device(device)
    if nprocs > 1:
        dist.initialize(f"127.0.0.1:{port}", nprocs, rank)
        sl = dist.rank_slice(C_GLOBAL, rank, nprocs)
    else:
        sl = slice(0, c_override or C_GLOBAL)
    try:
        # multicli's synthetic channel set, rank-sliced
        f0s = [(37 * k) % 180 - 90.0 for k in range(C_GLOBAL)][sl]
        seeds = list(range(1000, 1000 + C_GLOBAL))[sl]
        c_local = len(f0s)
        opts = DecoderOptions(quickmode=True)
        # pre-render the raw streams once, outside every timer: synthesis
        # costs ~50 CPU-s a channel-window, far above the chain under test
        src = SyntheticRawBank(c_local, f0s=f0s, seeds=seeds)
        raw_i, raw_q = src.read(2_400_000 * 123)

        class _Replay:
            n_channels = c_local

            def __init__(self):
                self._pos = 0

            def read(self, n):
                lo = self._pos
                self._pos = min(lo + n, raw_i.shape[1])
                return raw_i[:, lo:self._pos], raw_q[:, lo:self._pos]

            def close(self):
                pass

        def run():
            d = MultiChannelDaemon(_Replay(), opts, quiet=True,
                                   device_batch=2, device=dev)
            out = d.run(max_windows=1)
            _sync(dev)
            n_spots = sum(len(ch) for ch in out[0])
            if n_spots != c_local:
                raise SystemExit(f"rank {rank}: {n_spots} spots on "
                                 f"{c_local} channels")
            return d.stats.ingest_seconds

        run()  # warm (concurrent across ranks; only the timed part waits)
        if stagger and rank > 0:
            _wait_for(f"{stagger}.{rank - 1}")
        wall, cpu, ingest, reps = _timed(run, 2)  # best-of-2
        _report({
            "rank": rank, "nprocs": nprocs, "channels": c_local,
            "wall_s": round(wall, 3), "cpu_s": round(cpu, 3),
            "ingest_s": round(ingest, 3),
            "cpu_s_per_channel_window": round(cpu / c_local, 4),
            "decode_cpu_s_per_channel_window":
                round((cpu - ingest) / c_local, 4),
        }, reps)
        if stagger:
            open(f"{stagger}.{rank}", "w").close()
            _wait_for(f"{stagger}.{nprocs - 1}")
    finally:
        dist.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _processes(worker: str, device, timeout_s: float = RANK_TIMEOUT_S):
    """(solo on the full set, solo on half, both ranks of a 2-rank job)
    of ``worker`` (``_worker`` or ``_daemon_worker``), run in that order
    from the repo root: a list of (JSON row, {"launches": its kernel
    launches, "runs_a_sample": n}) per process.
    Every process of a step is collected before any failure is raised,
    so a dead rank's log is shown beside its peer's."""
    half = (B_GLOBAL if worker == "_worker" else C_GLOBAL) // 2
    tail = [] if device is None else ["--device", str(device)]
    with tempfile.TemporaryDirectory(prefix="wspr_scaling_") as tmp:
        stagger = os.path.join(tmp, "rank_done")
        port = _free_port()
        rows = []
        # (rank, nprocs, override) of each process, one step a list
        for step in ([(0, 1, 0)], [(0, 1, half)], [(0, 2, 0), (1, 2, 0)]):
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), worker,
                 str(rank), str(n), str(port), stagger if n > 1 else "",
                 str(override), *tail],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=REPO) for rank, n, override in step]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=timeout_s)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for k, (p, out) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    peers = "".join(f"\n---- process {j}:\n{o[-2000:]}"
                                    for j, o in enumerate(outs) if j != k)
                    raise RuntimeError(f"{worker} process {k} of {step} "
                                       f"failed:\n{out[-3000:]}{peers}")
            for out in outs:
                lines = out.strip().splitlines()
                info = [x for x in lines if x.startswith("process ")]
                rows.append((json.loads(lines[-1]),
                             json.loads(info[-1].split(" ", 1)[1])))
    return rows


def dist_mode(device=None, timeout_s: float = RANK_TIMEOUT_S):
    """(the dist mode's JSON dict, each process's launches and runs a
    sample)."""
    procs = _processes("_worker", device, timeout_s)
    base, base_half, *rows = [r for r, _ in procs]
    per_win_1 = base["cpu_s_per_window"]
    per_win_h = base_half["cpu_s_per_window"]
    per_win_2 = max(r["cpu_s_per_window"] for r in rows)
    return {
        "mode": "dist", "B_global": B_GLOBAL,
        "one_proc_cpu_s_per_window": per_win_1,
        "one_proc_halfbatch_cpu_s_per_window": per_win_h,
        "two_proc_cpu_s_per_window": per_win_2,
        # the gloo runtime's cost at an identical work shape
        "dist_runtime_overhead": round(per_win_2 / per_win_h - 1.0, 4),
        # per-window cost growth against the full solo batch (includes
        # the smaller per-call batch's amortization loss)
        "dist_overhead_vs_full_batch":
            round(per_win_2 / per_win_1 - 1.0, 4),
        "ranks": rows,
    }, [info for _, info in procs]


def daemon_mode(device=None, timeout_s: float = RANK_TIMEOUT_S):
    """(the daemon mode's JSON dict, each process's launches and runs
    a sample)."""
    procs = _processes("_daemon_worker", device, timeout_s)
    base, base_half, *rows = [r for r, _ in procs]
    per_1 = base["cpu_s_per_channel_window"]
    per_h = base_half["cpu_s_per_channel_window"]
    per_2 = max(r["cpu_s_per_channel_window"] for r in rows)
    dec_h = base_half["decode_cpu_s_per_channel_window"]
    dec_2 = max(r["decode_cpu_s_per_channel_window"] for r in rows)
    return {
        "mode": "daemon", "C_global": C_GLOBAL,
        "one_proc_cpu_s_per_channel_window": per_1,
        "one_proc_halfset_cpu_s_per_channel_window": per_h,
        "two_proc_cpu_s_per_channel_window": per_2,
        # the integrated chain's gloo runtime cost at identical work shape
        "daemon_dist_runtime_overhead": round(per_2 / per_h - 1.0, 4),
        "daemon_dist_overhead_vs_full_set": round(per_2 / per_1 - 1.0, 4),
        # decode side only (ingest = the front end, raw replay) removed
        "decode_only_dist_runtime_overhead":
            round(dec_2 / dec_h - 1.0, 4),
        "ranks": rows,
    }, [info for _, info in procs]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="mesh",
                    choices=("mesh", "dist", "daemon", "_worker",
                             "_daemon_worker"))
    ap.add_argument("worker_args", nargs="*",
                    help="rank, nprocs, port, stagger, override (workers)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.mode in ("_worker", "_daemon_worker"):
        rank, nprocs, port = (int(x) for x in args.worker_args[:3])
        stagger = args.worker_args[3] if len(args.worker_args) > 3 else ""
        override = (int(args.worker_args[4]) if len(args.worker_args) > 4
                    else 0)
        worker = dist_worker if args.mode == "_worker" else daemon_worker
        worker(rank, nprocs, port, stagger, override, args.device)
        return
    print(f"card {device_banner(args.device)}", flush=True)
    if args.mode == "mesh":
        out = mesh_mode(args.device)
    else:
        mode = dist_mode if args.mode == "dist" else daemon_mode
        out, procs = mode(args.device)
        print(f"kernel launches and runs a timed sample by process (solo, "
              f"solo half, rank 0, rank 1): {procs}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

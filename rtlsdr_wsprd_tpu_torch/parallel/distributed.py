"""Multi-host initialization, rank slices and meshes on torch.distributed.

The port's counterpart of ``rtlsdr_wsprd_tpu/parallel/distributed.py``.
The reference has no distributed story (one process, one dongle). Here
every host runs the same program: ``initialize`` wires the processes
into one ``torch.distributed`` job, each rank ingests and decodes its
own contiguous slice of the channels (``rank_slice``) on its local
devices, and only spot lists leave a host: the decode exchanges no
sample data. The backend is gloo: the only traffic is a few small host
tensors (the device count for the banner, the front end's halo in
``streaming.py``), and NCCL refuses two ranks on one card, the layout a
one-card host runs.

Usage on each host of an N-host job:

    from rtlsdr_wsprd_tpu_torch.parallel import distributed as dist
    dist.initialize(coordinator="host0:1234", num_processes=N,
                    process_id=rank)
    sl = dist.rank_slice(n_channels)   # this rank's channels
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as tdist


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """Join this process, rank ``process_id`` of ``num_processes``, to
    the job whose rank 0 listens at ``coordinator`` (HOST:PORT)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} outside 0..{num_processes - 1}")
    tdist.init_process_group(backend=backend,
                             init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the job (no-op when this process never joined one)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _rank_world(rank: int | None, nprocs: int | None) -> tuple[int, int]:
    r = tdist.get_rank() if rank is None else rank
    n = tdist.get_world_size() if nprocs is None else nprocs
    return r, n


def rank_slice(n_items: int, rank: int | None = None,
               nprocs: int | None = None) -> slice:
    """Partition ``n_items`` channels across ranks, remainder spread
    over the first ranks (rank k of N owns a contiguous run of
    ``n_items // N`` or ``n_items // N + 1`` items; every item is owned
    by exactly one rank). ``rank``/``nprocs`` of None read the job's
    rank and world size. Unlike local_batch_slice this does not require
    divisibility: it drives the multi-host daemon's channel assignment
    (multicli --nprocs/--rank), where the channel count is whatever the
    operator's dongle fleet provides."""
    r, n = _rank_world(rank, nprocs)
    base, extra = divmod(n_items, n)
    start = r * base + min(r, extra)
    return slice(start, start + base + (1 if r < extra else 0))


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) channel range this rank should ingest when a
    (global_batch, ...) batch is split evenly over the job's ranks."""
    r, n = _rank_world(None, None)
    per = global_batch // n
    return slice(r * per, (r + 1) * per)


def global_device_count(local_count: int) -> int:
    """The sum of every rank's local device count (one collective)."""
    t = torch.tensor([local_count], dtype=torch.int64)
    tdist.all_reduce(t)
    return int(t.item())


def decode_local_shard(i_windows, q_windows, options=None, hashtable=None,
                       device_batch: int = 64, device=None):
    """Multi-host decode: THIS rank's channels through the staged
    single-device path (parallel.multichannel decode_channels) on
    ``device`` (None: the CUDA card). WSPR decode is embarrassingly
    parallel per window, so no collective is needed: each host decodes
    its own channels and only the spot lists leave it."""
    from ..config import DecoderOptions
    from .multichannel import decode_channels

    if options is None:
        options = DecoderOptions()
    return decode_channels(i_windows, q_windows, options, hashtable,
                           device_batch=device_batch, device=device)


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def global_channel_mesh(axis_name: str = "ch"):
    """1-D device mesh over every rank of the job."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (tdist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def host_chip_mesh(ch_axis: str = "ch", host_axis: str = "host"):
    """2-D (hosts x ranks of a host) device mesh: channels shard over
    hosts and over the ranks within a host independently. A host is a
    hostname; the ranks of each host must be contiguous and as many on
    every host."""
    from torch.distributed.device_mesh import init_device_mesh

    names: list = [None] * tdist.get_world_size()
    tdist.all_gather_object(names, socket.gethostname())
    hosts = list(dict.fromkeys(names))
    per_host = len(names) // len(hosts)
    if names != [h for h in hosts for _ in range(per_host)]:
        raise RuntimeError(f"ranks are not laid out host by host: {names}")
    return init_device_mesh(_device_type(), (len(hosts), per_host),
                            mesh_dim_names=(host_axis, ch_axis))


__all__ = ["initialize", "shutdown", "rank_slice", "local_batch_slice",
           "global_device_count", "decode_local_shard",
           "global_channel_mesh", "host_chip_mesh"]

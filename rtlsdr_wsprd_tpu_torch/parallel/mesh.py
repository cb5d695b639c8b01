"""Device meshes and channel shardings for the dense decode.

The port's counterpart of ``rtlsdr_wsprd_tpu/parallel/mesh.py``. PyTorch
has no single-process ``NamedSharding``, so a mesh here is the ordered
device list plus its axis name, and a sharding is a rule that places a
batch on it:

* ``channel_sharding(mesh, axis_name)``: contiguous row shards along
  axis 0, one a device (``_shard_bounds``: the bounds the multi-device
  decode uses; fewer shards than devices when the batch is smaller);
* ``replicated(mesh)``: the whole batch on every device.

The decode of one window stays on one device (pure data parallelism);
``decode_channels(sharding=...)`` runs each shard's dense step on its
device from its own host thread.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_devices


class Mesh(NamedTuple):
    """A 1-D mesh: resolved devices in axis order, and the axis name."""

    devices: tuple[torch.device, ...]
    axis_name: str = "ch"


def _shard_bounds(B: int, n_devices: int) -> list[tuple[int, int]]:
    """B channel rows in one contiguous ``[s0, s1)`` shard per device
    (fewer shards than devices when B is smaller)."""
    d = min(n_devices, B)
    return [(B * k // d, B * (k + 1) // d) for k in range(d)]


def _put(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


class ChannelSharding(NamedTuple):
    """Contiguous row shards of a batch's leading (channel) axis over
    ``mesh``."""

    mesh: Mesh

    def bounds(self, B: int) -> list[tuple[int, int]]:
        return _shard_bounds(B, len(self.mesh.devices))

    def place(self, x) -> list[torch.Tensor]:
        """A (B, ...) batch (numpy or tensor) -> its row shards as
        float32 tensors, shard k on device k."""
        return [_put(x[s0:s1], self.mesh.devices[k])
                for k, (s0, s1) in enumerate(self.bounds(len(x)))]


class Replicated(NamedTuple):
    """The whole batch on every device of ``mesh``."""

    mesh: Mesh

    def place(self, x) -> list[torch.Tensor]:
        return [_put(x, d) for d in self.mesh.devices]


def make_mesh(devices=None, axis_name: str = "ch") -> Mesh:
    """1-D mesh over ``devices`` (None: every visible CUDA card; raises
    without one, never the CPU). A list may name any devices, the same
    one more than once (``["cpu", "cpu"]`` in the tests)."""
    return Mesh(tuple(resolve_devices(devices)), axis_name)


def local_mesh(n: int | None = None, axis_name: str = "ch") -> Mesh:
    """Mesh over the first ``n`` CUDA cards (None: all of them). Raises
    when there are fewer; never falls back to the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("CUDA is not available; pass make_mesh(['cpu', "
                           "...]) to run the plain PyTorch versions on the "
                           "CPU")
    if n is None:
        n = have
    if not 1 <= n <= have:
        raise RuntimeError(f"requested {n} CUDA card(s), {have} available")
    return make_mesh([f"cuda:{k}" for k in range(n)], axis_name)


def channel_sharding(mesh: Mesh, axis_name: str = "ch") -> ChannelSharding:
    """Shard the leading (channel/window) axis over the mesh's axis
    ``axis_name``; a name the mesh does not have raises ``ValueError``."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis_name={axis_name!r}: the mesh's axis is "
                         f"{mesh.axis_name!r}")
    return ChannelSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


__all__ = ["Mesh", "ChannelSharding", "Replicated", "make_mesh",
           "local_mesh", "channel_sharding", "replicated"]

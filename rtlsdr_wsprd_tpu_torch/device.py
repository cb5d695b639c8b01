"""Device resolution and constant tables for every entry point of the port.

Entry points take ``device=None``, which means the calling thread's
current CUDA card, named by its index (``cuda:k``): a handle, mesh or
daemon made on card k stays on card k when worker threads, whose current
card is 0, decode it. On a host without CUDA such a call raises: the
port never falls back to the CPU on its own. Callers that want the CPU
(the tests) pass ``device="cpu"`` and then run every kernel's plain
PyTorch version.

Matrix products stay in full float32: the JAX package computes its
correlators in float32 off the TPU, and this port keeps TF32 off until
a decode-count comparison on the card says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``cuda`` -> ``cuda:<current card>``; raises if CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(devices=None) -> list[torch.device]:
    """A device list for the multi-device decode. ``None`` -> every
    visible CUDA card, ``cuda:0 .. n-1`` (raises without one: never the
    CPU); a list -> each entry resolved, and a card that is not there
    raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu', ...] to run "
                "the plain PyTorch versions on the CPU")
        devices = [f"cuda:{k}" for k in range(n)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices given")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"{d}: this host has "
                             f"{torch.cuda.device_count()} CUDA card(s)")
    return devs


_CONSTS: dict[tuple, tuple[tuple, torch.Tensor]] = {}


def const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy table as a tensor on ``device``, uploaded
    once (a host->device copy per call would stall the launch queue).
    ``convert.load_state_dict`` rewrites tables in place and then calls
    ``clear_consts``."""
    return derived_const(np.asarray, (a,), device)


def derived_const(fn, srcs: tuple[np.ndarray, ...],
                  device: torch.device) -> torch.Tensor:
    """``fn(*srcs)`` (a numpy table) as a tensor on ``device``, computed
    and uploaded once until ``clear_consts``: a table derived from live
    tables follows them when ``convert.load_state_dict`` rewrites them."""
    key = (fn, *map(id, srcs), device)
    hit = _CONSTS.get(key)
    if hit is None:
        t = torch.from_numpy(np.ascontiguousarray(fn(*srcs))).to(device)
        hit = (srcs, t)   # srcs kept alive so their ids stay theirs
        _CONSTS[key] = hit
    return hit[1]


def clear_consts() -> None:
    _CONSTS.clear()

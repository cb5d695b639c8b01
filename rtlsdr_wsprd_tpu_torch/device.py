"""Device resolution and constant tables for every entry point of the port.

Entry points take ``device=None``, which means the CUDA card. On a host
without CUDA such a call raises: the port never falls back to the CPU
on its own. Callers that want the CPU (the tests) pass ``device="cpu"``
and then run every kernel's plain PyTorch version.

Matrix products stay in full float32: the JAX package computes its
correlators in float32 off the TPU, and this port keeps TF32 off until
a decode-count comparison on the card says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_CONSTS: dict[tuple[int, torch.device], tuple[np.ndarray, torch.Tensor]] = {}


def const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy table as a tensor on ``device``, uploaded
    once (a host->device copy per call would stall the launch queue).
    ``convert.load_state_dict`` rewrites tables in place and then calls
    ``clear_consts``."""
    key = (id(a), device)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = (a, torch.from_numpy(np.ascontiguousarray(a)).to(device))
        _CONSTS[key] = hit
    return hit[1]


def clear_consts() -> None:
    _CONSTS.clear()

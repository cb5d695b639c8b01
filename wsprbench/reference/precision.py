"""The reference's matrix products, at float32 or at TF32.

The control computes the reference one precision below what the
deployments state: float32 products with TF32 in place of float32
(inputs rounded to TF32's 10-bit mantissa, round to nearest even, the
sums kept in float32, as the tensor cores do). The rounding is done
here, before each product, so the control is the same on any device
and whichever kernel the library picks for a product's shape.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (a 10-bit mantissa)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & -0x2000
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if getattr(_state, "tf32", False) and a.dtype == torch.float32:
        return tf32_round(a) @ tf32_round(b)
    return a @ b


@contextlib.contextmanager
def tf32():
    """Products inside the block take TF32 inputs."""
    prev = getattr(_state, "tf32", False)
    _state.tf32 = True
    try:
        yield
    finally:
        _state.tf32 = prev

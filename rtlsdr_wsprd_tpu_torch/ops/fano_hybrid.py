"""Hybrid device/host Fano decoding.

The device Fano (ops/fano.py ``batched_fano``) runs every attempt of a
call at once, so a call lasts as long as its slowest lane, and a lane
that exhausts the reference's full budget (10000 cycles a bit = 810k
cycles, wsprd/wsprd.c:430) is the slowest there is. The hybrid split
runs the device search with a small budget (the calibrated one, see
ops/calibrate.py) and re-runs only the lanes still searching at its end
on the native sequential decoder (native.py), from scratch with the full
budget. Fano is deterministic: a lane re-run with a larger budget passes
through the same states, so the merged results equal a full-budget run
bit for bit.

Copied from ``rtlsdr_wsprd_tpu/ops/fano_hybrid.py`` with two
differences:

- ``host_finish`` has only the native branch. The port has no
  pure-Python FEC (native.py raises without ``g++``), so the JAX
  package's fallback (the device search at the full budget) is not
  carried over: a host without the native decoder cannot run the port's
  decode at all.
- ``pending_mask`` also takes a lane that reached the last node at
  exactly the budget's last cycle. The C (and both device versions)
  reports such a lane as failed with cycles = budget*81 + 1, one short
  of the timeout marker, although the full budget would let it
  succeed; the JAX package's mask misses it and loses that decode.
"""

from __future__ import annotations

import numpy as np

from .. import native, tracing
from ..config import NBITS
from .fano import METTAB

# default device-side budget (cycles a bit, like the C's maxcycles);
# production paths use the calibrated value (ops/calibrate.py
# device_fano_budget); this constant is its fallback and the value the
# env override's absence leaves
DEVICE_MAXCYCLES = 16


def pending_mask(success: np.ndarray, cycles: np.ndarray,
                 device_maxcycles: int, full_maxcycles: int) -> np.ndarray:
    """Lanes that ran out of the device budget without succeeding (their
    cycles carry the timeout marker budget*81 + 2, or budget*81 + 1 for
    a lane that finished on the budget's last cycle) and that the full
    budget would let go on."""
    if device_maxcycles >= full_maxcycles:
        return np.zeros_like(success, dtype=bool)
    last = device_maxcycles * NBITS
    return (~success) & (cycles > last)


def host_finish(deint_symbols: np.ndarray, success: np.ndarray,
                data: np.ndarray, cycles: np.ndarray,
                pending: np.ndarray, delta: int, maxcycles: int):
    """Re-run the ``pending`` lanes on the native host decoder at the
    full budget ``maxcycles``; returns updated (success, data, cycles)
    arrays (copies where modified). Recorded as a ``host_finish`` span
    (tracing.py): ``stragglers`` lanes re-run, ``decoded`` of them
    successes, ``cycles`` the searches' cycles in all."""
    idx = np.nonzero(pending)[0]
    if idx.size == 0:
        return success, data, cycles
    with tracing.span("host_finish", stragglers=int(idx.size)) as sp:
        ok, d, c, _m, _np = native.fano_decode_many(
            deint_symbols[idx], METTAB, delta=delta, maxcycles=maxcycles)
        sp.add(decoded=np.count_nonzero(ok),
               cycles=np.asarray(c, np.int64).sum())
    success = success.copy()
    data = data.copy()
    cycles = cycles.copy()
    success[idx] = ok
    data[idx] = d
    cycles[idx] = c
    return success, data, cycles

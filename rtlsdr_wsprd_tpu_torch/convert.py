"""The JAX package's state, carried into the port.

The system has no weights: its state is its constant tables (filter
taps and partial-product matrices, the DFT matrices, the coarse-search
weights, the offset tone matrices, the Fano metric table) and the
callsign hashtable. ``state_dict`` names the port's own tables as numpy
arrays, under the JAX package's names; ``load_state_dict`` writes a
dictionary of such arrays (for instance the JAX package's, read out by
the caller) into the port in place, so both packages run from the
same tables. ``hashtable_state`` / ``hashtable_from_state`` move a
hashtable's contents across as arrays.

Nothing here imports the JAX package: the caller reads its tables and
hands them over as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .device import clear_consts
from .frontend import decimate as _decimate
from .ops import coarse as _coarse
from .ops import fano as _fano
from .ops import stft as _stft
from .ops import sync as _sync
from .utils.hashtable import WsprHashTable


def tone_offsets() -> dict[str, tuple[int, ...]]:
    """The absolute correlator offsets the decode uses, by name: the
    fine-sync lag grids (lagstep 8 and 16) and the jitter schedules
    (full and quickmode, iifac=3)."""
    lags = {f"lags{s}": tuple(int(r) + _sync.HALF_SPAN
                              for r in _sync._rel_lags(s)) for s in (8, 16)}
    jit = {f"jitter_{m}": tuple(
        int(o) + _sync.HALF_SPAN
        for o in _sync.jitter_offsets(3, quickmode=(m == "quick")))
        for m in ("full", "quick")}
    return {**lags, **jit}


def _live_tables() -> dict[str, np.ndarray]:
    """Name -> the port's live numpy table (written in place on load)."""
    s1, s2 = _decimate.STAGE1, _decimate.STAGE2
    out = {
        # frontend/decimate.py _pp_mats() and the conv-ordered taps
        "frontend.stage1.htop": s1.htop, "frontend.stage1.hbot": s1.hbot,
        "frontend.stage2.htop": s2.htop, "frontend.stage2.hbot": s2.hbot,
        "frontend.stage1.taps_re": s1.gr, "frontend.stage1.taps_im": s1.gi,
        "frontend.stage2.taps_re": s2.gr, "frontend.stage2.taps_im": s2.gi,
        # ops/stft.py
        "ops.stft.hann": _stft.HANN,
        "ops.stft.dft_cos": _stft.DFT_COS, "ops.stft.dft_sin": _stft.DFT_SIN,
        # ops/coarse.py _weights()
        "ops.coarse.weights": _coarse.W,
        # ops/fano.py build_mettab()
        "ops.fano.mettab": _fano.METTAB,
    }
    # ops/sync.py _offset_tone_matrix(offsets), one pair per offset set
    for name, offs in tone_offsets().items():
        tr, ti = _sync._offset_tone_matrix(offs)
        out[f"ops.sync.tone_re.{name}"] = tr
        out[f"ops.sync.tone_im.{name}"] = ti
    return out


def state_dict() -> dict[str, np.ndarray]:
    """Copies of the port's constant tables, by name."""
    return {k: v.copy() for k, v in _live_tables().items()}


def load_state_dict(state: dict[str, np.ndarray]) -> None:
    """Write ``state`` (name -> numpy array) into the port's tables in
    place. Every name must be one of ``state_dict``'s, with the same
    shape and dtype; tables not named keep their values. Tensors already
    on a device are dropped and re-uploaded at next use."""
    live = _live_tables()
    for name, arr in state.items():
        if name not in live:
            raise KeyError(f"unknown table {name!r}")
        dst = live[name]
        arr = np.asarray(arr)
        if arr.shape != dst.shape or arr.dtype != dst.dtype:
            raise ValueError(f"{name}: {arr.dtype}{arr.shape} does not fit "
                             f"{dst.dtype}{dst.shape}")
    for name, arr in state.items():
        np.copyto(live[name], np.asarray(arr))
    clear_consts()


def hashtable_state(ht) -> dict[str, np.ndarray]:
    """A hashtable's contents as arrays: ``ihash`` int32[n] (sorted),
    ``call`` str[n] and ``grid`` str[n] ('' where none). Takes either
    package's WsprHashTable (both keep ``_calls`` and ``_grids``)."""
    keys = sorted(ht._calls)
    return {
        "ihash": np.asarray(keys, np.int32),
        "call": np.asarray([ht._calls[k] for k in keys], dtype=str),
        "grid": np.asarray([ht._grids.get(k, "") for k in keys], dtype=str),
    }


def hashtable_from_state(state: dict[str, np.ndarray]) -> WsprHashTable:
    """The port's WsprHashTable holding ``state``'s entries."""
    ht = WsprHashTable()
    for ihash, call, grid in zip(state["ihash"], state["call"],
                                 state["grid"]):
        ht.put(int(ihash), str(call), str(grid) or None)
    return ht

"""The decoded-spot record and the stateful decoder facade.

``Spot`` is the reference's struct decoder_results (wsprd/wsprd.h:62-74).
``WsprDecoder`` owns the options and the persistent callsign hashtable
and decodes one window through the staged multi-channel path
(parallel/multichannel.py) with a batch of one; the single-channel
daemon (runtime/scheduler.py) and the CLI's ``-t``/``-r`` decode
through it. The JAX package's dense
per-window ``decode_window`` is its own parity anchor and is not ported:
the JAX package anchors the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import DecoderOptions
from ..device import resolve_device
from ..utils.hashtable import WsprHashTable


@dataclass
class Spot:
    """One decoded transmission (wsprd/wsprd.h:62-74)."""

    freq: float      # printed frequency, MHz (dial + (1500+f)/1e6)
    sync: float
    snr: float       # dB
    dt: float        # s (shift*DT - 2.0)
    drift: float
    jitter: int
    message: str
    call: str
    loc: str
    pwr: str
    cycles: int
    noprint: bool = False
    ihash: int = -1  # type-3 spots: the 15-bit hash behind ``call``


class WsprDecoder:
    """Options + the persistent hashtable; ``decode`` runs one window
    through the staged path on ``device`` (None = the CUDA card)."""

    def __init__(self, options: DecoderOptions = DecoderOptions(),
                 hashtable_path: str = "hashtable.txt", device=None):
        self.options = options
        self.hashtable_path = hashtable_path
        self.device = resolve_device(device)
        if options.usehashtable:
            self.hashtable = WsprHashTable.load(hashtable_path)
        else:
            self.hashtable = WsprHashTable()

    def decode(self, i_samples: np.ndarray,
               q_samples: np.ndarray) -> list[Spot]:
        from ..parallel.multichannel import decode_channels

        spots = decode_channels(
            i_samples[None, :], q_samples[None, :], self.options,
            self.hashtable, device_batch=1, device=self.device)[0]
        if self.options.usehashtable:
            self.hashtable.save(self.hashtable_path)
        return spots

"""The decode chain's tensor ops (PyTorch)."""

from .candidates import find_candidates  # noqa: F401
from .coarse import coarse_search  # noqa: F401
from .fano import batched_fano, build_mettab  # noqa: F401
from .stft import BLOCKS, power_spectrogram  # noqa: F401
from .subtract import (  # noqa: F401
    subtract_rows,
    subtract_signal,
    subtract_signal2,
    subtract_signal2_many,
)
from .sync import (  # noqa: F401
    fine_sync,
    fine_sync_lanes,
    soft_symbols_jittered,
    soft_symbols_lanes,
)

"""The decode chain's tensor ops (PyTorch)."""

from .candidates import find_candidates  # noqa: F401
from .coarse import coarse_search  # noqa: F401
from .fano import build_mettab  # noqa: F401
from .stft import BLOCKS, power_spectrogram  # noqa: F401
from .subtract import subtract_rows, subtract_signal2  # noqa: F401
from .sync import fine_sync_lanes, soft_symbols_lanes  # noqa: F401

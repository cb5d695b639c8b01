"""Multi-channel decode: the staged single-device path."""

from .multichannel import (  # noqa: F401
    decode_channels,
    prepare_windows,
    prepare_windows_device,
    resolve_type3_spots,
)

"""Multi-channel decode: the staged single-device path and its
pipelined stream decode."""

from .multichannel import (  # noqa: F401
    decode_channels,
    decode_channels_pipelined,
    prepare_windows,
    prepare_windows_device,
    resolve_type3_spots,
)

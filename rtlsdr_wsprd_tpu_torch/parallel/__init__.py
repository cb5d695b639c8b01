"""Multi-channel decode: the staged single-device path, its pipelined
stream decode, their multi-device forms, and the multi-host runtime
(``distributed``, ``streaming``)."""

from .multichannel import (  # noqa: F401
    decode_channels,
    decode_channels_multidevice,
    decode_channels_pipelined,
    decode_channels_pipelined_multidevice,
    prepare_windows,
    prepare_windows_device,
    resolve_type3_spots,
)

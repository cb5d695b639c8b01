"""Multi-channel decode: the staged single-device path, its pipelined
stream decode and their multi-device forms; the dense device step and
its mesh path (``decode_channels(sharding=channel_sharding(mesh))``);
and the multi-host runtime (``distributed``, ``streaming``)."""

from . import distributed  # noqa: F401
from .mesh import (  # noqa: F401
    channel_sharding,
    local_mesh,
    make_mesh,
    replicated,
)
from .multichannel import (  # noqa: F401
    DEFAULT_MAX_ATTEMPTS,
    ChannelDecode,
    decode_channels,
    decode_channels_multidevice,
    decode_channels_pipelined,
    decode_channels_pipelined_multidevice,
    multichannel_decode_device,
    prepare_windows,
    prepare_windows_device,
    resolve_type3_spots,
    shard_windows,
)
from .streaming import decimate_stage1_sharded  # noqa: F401

"""Streaming front end: 2.4 Msps raw IQ -> 375 sps baseband.

Two polyphase FIR stages (R=80 each) through two hand-written CUDA
kernels, chosen per call by ``polyphase.py``: ``csrc/polyphase_tc.cu``
(uint8 stage 1, on the tensor cores) and ``csrc/polyphase.cu`` (float32
stage 1 and stage 2); the fs/4 downmix is folded into the stage-1 taps
(``filters.py``).
"""

from .channelize import ChannelizingStreamingDecimator  # noqa: F401
from .decimate import (  # noqa: F401
    BatchedStreamingDecimator,
    StreamingDecimator,
    decimate_stage1,
    decimate_stage2,
    decimate_window,
)
from .filters import (  # noqa: F401
    GROUP_DELAY_375,
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
    stage1_coeffs,
    stage2_coeffs,
)
from .host_decimate import (  # noqa: F401
    HostBatchedStreamingDecimator,
    HostStreamingDecimator,
    resolve_placement,
)
from .polyphase import PolyphaseFilter, polyphase_decimate  # noqa: F401

"""Host-side protocol utilities (bit-parity with the reference)."""

from .nhash import nhash  # noqa: F401
from .codec import (  # noqa: F401
    UnpackedMessage,
    unpack50,
    unpackcall,
    unpackgrid,
    unpackpfx,
    unpack_message,
)
from .channel import (  # noqa: F401
    INTERLEAVE_PERM,
    NBITS,
    NSYM,
    POLY1,
    POLY2,
    PR3_VECTOR,
    conv_encode,
    deinterleave,
    get_callsign_character_code,
    get_locator_character_code,
    get_wspr_channel_symbols,
    interleave,
    pack_call,
    pack_grid4_power,
    pack_payload,
    pack_prefix,
)
from .hashtable import WsprHashTable  # noqa: F401
from .metric_tables import METRIC_TABLES  # noqa: F401

"""The decoder facade and the dense per-window decoder."""

from .decoder import Spot, WsprDecoder, decode_window  # noqa: F401

"""The decoder facade."""

from .decoder import Spot, WsprDecoder  # noqa: F401

"""Bit-exact WSPR callsign hash (Bob Jenkins lookup3 ``hashlittle``).

Re-implementation of the reference's ``nhash`` (wsprd/nhash.c:205-451):
lookup3 with the WSPR-specific convention initval=146 and a final 15-bit
mask (``c &= 32767``, wsprd/nhash.c:448) so hashes index a 32768-entry
callsign table. Hash values are protocol-visible (they travel inside
type-2/3 WSPR messages), so this must match the C bit-for-bit.

The C code has three alignment-dependent read paths (32-bit, 16-bit,
byte-wise) that all compute the same function; we implement the
byte-wise formulation, which is alignment-independent.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    x &= _M32
    return ((x << k) | (x >> (32 - k))) & _M32


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    # lookup3 mix() (wsprd/nhash.c:132-140)
    a = (a - c) & _M32; a ^= _rot(c, 4);  c = (c + b) & _M32
    b = (b - a) & _M32; b ^= _rot(a, 6);  a = (a + c) & _M32
    c = (c - b) & _M32; c ^= _rot(b, 8);  b = (b + a) & _M32
    a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
    b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
    c = (c - b) & _M32; c ^= _rot(b, 4);  b = (b + a) & _M32
    return a, b, c


def _final(a: int, b: int, c: int) -> int:
    # lookup3 final() (wsprd/nhash.c:167-176)
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def hashlittle(key: bytes, initval: int = 0) -> int:
    """Full 32-bit lookup3 hashlittle over ``key``."""
    length = len(key)
    a = b = c = (0xDEADBEEF + length + initval) & _M32

    k = 0
    while length > 12:
        a = (a + key[k] + (key[k + 1] << 8) + (key[k + 2] << 16) + (key[k + 3] << 24)) & _M32
        b = (b + key[k + 4] + (key[k + 5] << 8) + (key[k + 6] << 16) + (key[k + 7] << 24)) & _M32
        c = (c + key[k + 8] + (key[k + 9] << 8) + (key[k + 10] << 16) + (key[k + 11] << 24)) & _M32
        a, b, c = _mix(a, b, c)
        length -= 12
        k += 12

    if length == 0:
        return c
    tail = key[k : k + length]
    words = [0, 0, 0]
    for i, byte in enumerate(tail):
        words[i // 4] |= byte << (8 * (i % 4))
    a = (a + words[0]) & _M32
    b = (b + words[1]) & _M32
    c = (c + words[2]) & _M32
    return _final(a, b, c)


def nhash(callsign: str | bytes, initval: int = 146) -> int:
    """WSPR 15-bit callsign hash (wsprd/nhash.c:205-451, mask at :448).

    The reference always calls this with initval=146 and
    length=strlen(callsign).
    """
    if isinstance(callsign, str):
        callsign = callsign.encode("ascii")
    return hashlittle(callsign, initval) & 32767

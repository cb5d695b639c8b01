"""WSPR channel coding: pack, convolutional encode, interleave (host side).

Re-implements the reference encode path (wsprd/wsprsim_utils.c +
wsprd/fano.c:63-82): message string -> 50-bit payload -> K=32 r=1/2
convolutional code (Layland-Lushbaugh polynomials) -> bit-reversal
interleave -> 4-FSK channel symbols with the 162-bit pseudo-random sync
vector. Feeds the self-test generator, signal subtraction, and synthetic
data generation. All protocol constants are bit-parity with the C.
"""

from __future__ import annotations

import numpy as np

from .codec import unpack_message
from .nhash import nhash

NSYM = 162   # channel symbols per transmission (wsprd/wsprd.c:63)
NBITS = 81   # payload+tail bits through the FEC (wsprd/wsprd.c:62)

# Layland-Lushbaugh rate-1/2 K=32 polynomials (wsprd/fano.c:51-53)
POLY1 = 0xF2D05351
POLY2 = 0xE4613C47

# 162-bit pseudo-random sync vector (wsprd/wsprd.c:84-93)
PR3_VECTOR = np.array([
    1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0,
    0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1,
    0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1,
    1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1,
    0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1,
    0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 1,
    0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0,
    0, 0], dtype=np.uint8)


def _bitrev8(i: int) -> int:
    """8-bit reversal; the C uses the multiply-mask trick
    (wsprd/wsprd_utils.c:203)."""
    return int(f"{i:08b}"[::-1], 2)


def _make_interleave_perm() -> np.ndarray:
    """perm[p] = bit-reversed index for sequence position p, i.e. the p-th
    value of bitrev8(i) (i=0,1,2,...) that lands inside [0, 162)."""
    perm = [j for i in range(256) if (j := _bitrev8(i)) < NSYM]
    assert len(perm) == NSYM
    return np.asarray(perm, dtype=np.int32)


# interleaved[INTERLEAVE_PERM[p]] = raw[p]  (wsprd/wsprsim_utils.c:144-161)
# deinterleaved[p] = interleaved[INTERLEAVE_PERM[p]]  (wsprd/wsprd_utils.c:196-213)
INTERLEAVE_PERM = _make_interleave_perm()


def interleave(sym: np.ndarray) -> np.ndarray:
    out = np.empty_like(sym)
    out[INTERLEAVE_PERM] = sym
    return out


def deinterleave(sym: np.ndarray) -> np.ndarray:
    return np.asarray(sym)[..., INTERLEAVE_PERM]


def _parity32(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def encode_symbol_pair(encstate: int) -> int:
    """The ENCODE macro (wsprd/fano.h:35-44): POLY1 parity in the 2-bit,
    POLY2 parity in the 1-bit."""
    return (_parity32(encstate & POLY1) << 1) | _parity32(encstate & POLY2)


def conv_encode(data: bytes | np.ndarray, nbytes: int | None = None) -> np.ndarray:
    """Convolutionally encode ``data`` MSB-first, one symbol per output
    byte (wsprd/fano.c:63-82). Returns 16*nbytes symbols (0/1)."""
    data = bytes(data)
    if nbytes is None:
        nbytes = len(data)
    out = np.zeros(nbytes * 16, dtype=np.uint8)
    encstate = 0
    k = 0
    for byte in data[:nbytes]:
        for i in range(7, -1, -1):
            encstate = ((encstate << 1) | ((byte >> i) & 1)) & 0xFFFFFFFF
            sym = encode_symbol_pair(encstate)
            out[k] = sym >> 1
            out[k + 1] = sym & 1
            k += 2
    return out


# ---------------------------------------------------------------------------
# Message string -> packed payload (wsprd/wsprsim_utils.c)
# ---------------------------------------------------------------------------

def get_locator_character_code(ch: str) -> int:
    """wsprd/wsprsim_utils.c:15-26."""
    o = ord(ch)
    if 48 <= o <= 57:
        return o - 48
    if o == 32:
        return 36
    if 65 <= o <= 82:
        return o - 65
    return -1


def get_callsign_character_code(ch: str) -> int:
    """wsprd/wsprsim_utils.c:28-39."""
    o = ord(ch)
    if 48 <= o <= 57:
        return o - 48
    if o == 32:
        return 36
    if 65 <= o <= 90:
        return o - 55
    return -1


def pack_grid4_power(grid4_codes, power: int) -> int:
    """wsprd/wsprsim_utils.c:41-47 (takes locator character codes)."""
    g = grid4_codes
    m = (179 - 10 * g[0] - g[2]) * 180 + 10 * g[1] + g[3]
    return m * 128 + power + 64


def pack_call(callsign: str) -> int:
    """Pack a callsign into 28 bits (wsprd/wsprsim_utils.c:49-78).

    Returns 0 for callsigns longer than 6 chars, like the C. The third
    character must be the digit; a callsign with its digit in position 2
    is right-shifted by one (leading space).
    """
    if len(callsign) > 6:
        return 0
    call6 = [" "] * 6
    if len(callsign) > 2 and callsign[2].isdigit():
        for i, ch in enumerate(callsign):
            call6[i] = ch
    elif len(callsign) > 1 and callsign[1].isdigit():
        for i, ch in enumerate(callsign):
            call6[i + 1] = ch
    codes = [get_callsign_character_code(c) for c in call6]
    n = codes[0]
    n = n * 36 + codes[1]
    n = n * 10 + codes[2]
    n = n * 27 + codes[3] - 10
    n = n * 27 + codes[4] - 10
    n = n * 27 + codes[5] - 10
    return n


def pack_prefix(callsign: str) -> tuple[int, int, int]:
    """Pack a prefixed/suffixed callsign -> (n, m, nadd)
    (wsprd/wsprsim_utils.c:80-142)."""
    i1 = callsign.find("/")
    if i1 < 0:
        i1 = len(callsign)
    after = callsign[i1 + 1 :]
    if len(after) == 1:
        # single character suffix
        n = pack_call(callsign[:i1])
        nadd = 1
        o = ord(after[0])
        if 48 <= o <= 57:
            m = o - 48
        elif 65 <= o <= 90:
            m = o - 65 + 10
        else:
            m = 38
        m = 60000 - 32768 + m
        return n, m, nadd
    if len(after) == 2:
        # two character suffix
        n = pack_call(callsign[:i1])
        nadd = 1
        m = 10 * (ord(after[0]) - 48) + (ord(after[1]) - 48)
        m = 60000 + 26 + m
        return n, m, nadd
    # 1-3 character prefix before the slash
    pfx = callsign[:i1]
    call = after
    n = pack_call(call)
    plen = len(pfx)
    if plen == 1:
        m = 36 * 37 + 36
    elif plen == 2:
        m = 36
    else:
        m = 0
    for ch in pfx:
        o = ord(ch)
        if 48 <= o <= 57:
            nc = o - 48
        elif 65 <= o <= 90:
            nc = o - 65 + 10
        else:
            nc = 36
        m = 37 * m + nc
    nadd = 0
    if m > 32768:
        m -= 32768
        nadd = 1
    return n, m, nadd


def pack_payload(n: int, m: int) -> bytes:
    """Pack the 28-bit callsign field and 22-bit grid/power field plus the
    31-bit zero tail into 11 bytes (wsprd/wsprsim_utils.c:254-274)."""
    data = bytearray(11)
    data[0] = 0xFF & (n >> 20)
    data[1] = 0xFF & (n >> 12)
    data[2] = 0xFF & (n >> 4)
    data[3] = ((n & 0x0F) << 4) + ((m >> 18) & 0x0F)
    data[4] = 0xFF & (m >> 10)
    data[5] = 0xFF & (m >> 2)
    data[6] = (m & 0x03) << 6
    return bytes(data)


# power levels snap to the nearest value with nu(power) in {0,3,7}
# (wsprd/wsprsim_utils.c:178)
_NU = [0, -1, 1, 0, -1, 2, 1, 0, -1, 1]


def _snap_power(power: int) -> int:
    power = max(0, min(60, power))
    return power + _NU[power % 10]


def get_wspr_channel_symbols(rawmessage: str, hashtable) -> np.ndarray | None:
    """Parse a message string and produce its 162 4-FSK channel symbols
    (wsprd/wsprsim_utils.c:163-316). Returns None for unparseable input
    (C returns 0).

    Message types (decided by the presence of '<' and '/'):
      * Type 1: "K1JT FN20 33"       call + 4-char grid + power
      * Type 2: "PJ4/K1ABC 37"       prefixed/suffixed call + power
      * Type 3: "<K1ABC> EN50WC 33"  hashed call + 6-char grid + power
    """
    message = rawmessage[:22]
    mlen = len(message)
    i1 = message.find(" ");  i1 = i1 if i1 >= 0 else mlen
    i2 = message.find("/");  i2 = i2 if i2 >= 0 else mlen
    i3 = message.find("<");  i3 = i3 if i3 >= 0 else mlen
    i4 = message.find(">");  i4 = i4 if i4 >= 0 else mlen

    if 3 < i1 < 7 and i2 == mlen and i3 == mlen:
        # Type 1
        parts = message.split()
        if len(parts) < 3:
            return None
        callsign, grid, powstr = parts[0], parts[1], parts[2]
        try:
            power = int(powstr)
        except ValueError:
            power = 0
        n = pack_call(callsign)
        grid4 = [get_locator_character_code(c) for c in grid[:4]]
        m = pack_grid4_power(grid4, power)
    elif i3 == 0 and i4 < mlen:
        # Type 3
        tokens = [t for t in message.replace("<", " ").replace(">", " ").split() if t]
        if len(tokens) < 3:
            return None
        callsign, grid, powstr = tokens[0], tokens[1], tokens[2]
        try:
            power = int(powstr)
        except ValueError:
            power = 0
        power = _snap_power(power)
        ntype = -(power + 1)
        ihash = nhash(callsign)
        m = 128 * ihash + ntype + 64
        # grid chars rotate left by one with the first char moved to
        # position 5; shorter grids truncate at the first implicit NUL
        # (wsprd/wsprsim_utils.c:228-235).
        j = len(grid)
        grid6 = [""] * 6
        for i in range(j - 1):
            grid6[i] = grid[i + 1]
        grid6[5] = grid[0]
        pseudo_call = ""
        for ch in grid6:
            if ch == "":
                break
            pseudo_call += ch
        n = pack_call(pseudo_call)
    elif i2 < mlen:
        # Type 2
        parts = message.split()
        if len(parts) < 2:
            return None
        callsign, powstr = parts[0], parts[1]
        if i2 == 0 or i2 > len(callsign):
            return None
        try:
            power = int(powstr)
        except ValueError:
            power = 0
        power = _snap_power(power)
        n, ng, nadd = pack_prefix(callsign)
        ntype = power + 1 + nadd
        m = 128 * ng + ntype + 64
    else:
        return None

    data = pack_payload(n, m)
    # The reference round-trips through the decoder's unpacker so the
    # operator can eyeball consistency; it also inserts type-1 calls into
    # the hashtable (wsprd/wsprsim_utils.c:276-297). We keep the
    # hashtable side effect.
    unpack_message([b if b < 128 else b - 256 for b in data], hashtable)

    channelbits = conv_encode(data, 11)
    interleaved = interleave(channelbits[:NSYM])
    return (2 * interleaved + PR3_VECTOR).astype(np.uint8)

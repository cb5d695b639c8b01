"""Persistent WSPR callsign hash table.

The reference keeps two in-memory char tables of 32768 entries (callsign
+ grid) and persists them to ``hashtable.txt`` as "index call grid" lines
(load: wsprd/wsprd.c:476-494, store: :842-852). This is the only durable
state in the application. We keep a dict with the same file format so a
hashtable written by the reference loads here and vice versa.
"""

from __future__ import annotations

import os
from pathlib import Path

HASHTAB_SIZE = 32768          # wsprd/wsprd.h:36
HASHTAB_ENTRY_LEN = 13        # wsprd/wsprd.h:37 (12 chars + NUL)
LOCTAB_ENTRY_LEN = 5          # wsprd/wsprd.h:38 (4 chars + NUL)


class WsprHashTable:
    """32768-bucket callsign table keyed by the 15-bit WSPR hash."""

    def __init__(self) -> None:
        self._calls: dict[int, str] = {}
        self._grids: dict[int, str] = {}

    def put(self, ihash: int, call: str, grid: str | None = None) -> None:
        if not (0 <= ihash < HASHTAB_SIZE):
            return
        self._calls[ihash] = call[: HASHTAB_ENTRY_LEN - 1]
        if grid:
            self._grids[ihash] = grid[: LOCTAB_ENTRY_LEN - 1]

    def get_call(self, ihash: int) -> str | None:
        return self._calls.get(ihash)

    def get_grid(self, ihash: int) -> str | None:
        return self._grids.get(ihash)

    def __len__(self) -> int:
        return len(self._calls)

    # -- persistence (format-compatible with the reference) ----------------

    @classmethod
    def load(cls, path: str | os.PathLike = "hashtable.txt") -> "WsprHashTable":
        """Load "index call grid" lines; malformed rows are bounds-checked
        and skipped, mirroring wsprd/wsprd.c:481-494."""
        table = cls()
        p = Path(path)
        if not p.exists():
            return table
        for line in p.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            try:
                nh = int(parts[0])
            except ValueError:
                continue
            call = parts[1] if len(parts) > 1 else ""
            grid = parts[2] if len(parts) > 2 else None
            if call:
                table.put(nh, call, grid)
        return table

    def save(self, path: str | os.PathLike = "hashtable.txt") -> None:
        """Write in the reference's "%5d %s %s\\n" format (wsprd/wsprd.c:847)."""
        lines = []
        for ihash in sorted(self._calls):
            call = self._calls[ihash]
            grid = self._grids.get(ihash, "")
            lines.append(f"{ihash:5d} {call} {grid}\n")
        Path(path).write_text("".join(lines))

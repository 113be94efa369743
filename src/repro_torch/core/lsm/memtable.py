# Copied from src/repro/core/lsm/memtable.py; only the repro. imports are rewritten.
"""Skiplist MemTable storing (key → value, wal_offset).

The WAL offset per entry is the paper's Log-Recycling hook: when the
memtable is flushed, the initiator ships only the *sorted offset array* —
the target rebuilds the sorted run from WAL blocks it can already read.
Traversal of the bottom-level list yields keys in sorted order.
"""
from __future__ import annotations

import random
from typing import Iterator, List, Optional, Tuple

TOMBSTONE = b"\x00__TOMBSTONE__"

_MAX_LEVEL = 12
_P = 0.25


class _Node:
    __slots__ = ("key", "value", "wal_off", "next")

    def __init__(self, key, value, wal_off, level):
        self.key = key
        self.value = value
        self.wal_off = wal_off
        self.next: List[Optional["_Node"]] = [None] * level


class MemTable:
    def __init__(self, seed: int = 0):
        self._head = _Node(None, None, -1, _MAX_LEVEL)
        self._rng = random.Random(seed)
        self._level = 1
        self.n = 0
        self.bytes = 0

    def _random_level(self) -> int:
        lvl = 1
        while lvl < _MAX_LEVEL and self._rng.random() < _P:
            lvl += 1
        return lvl

    def put(self, key: bytes, value: bytes, wal_off: int) -> None:
        update = [self._head] * _MAX_LEVEL
        x = self._head
        for i in range(self._level - 1, -1, -1):
            while x.next[i] is not None and x.next[i].key < key:
                x = x.next[i]
            update[i] = x
        nxt = x.next[0]
        if nxt is not None and nxt.key == key:
            self.bytes += len(value) - len(nxt.value)
            nxt.value = value
            nxt.wal_off = wal_off
            return
        lvl = self._random_level()
        if lvl > self._level:
            self._level = lvl
        node = _Node(key, value, wal_off, lvl)
        for i in range(lvl):
            node.next[i] = update[i].next[i]
            update[i].next[i] = node
        self.n += 1
        self.bytes += len(key) + len(value)

    def delete(self, key: bytes, wal_off: int) -> None:
        self.put(key, TOMBSTONE, wal_off)

    def get(self, key: bytes) -> Optional[bytes]:
        x = self._head
        for i in range(self._level - 1, -1, -1):
            while x.next[i] is not None and x.next[i].key < key:
                x = x.next[i]
        x = x.next[0]
        if x is not None and x.key == key:
            return x.value
        return None

    def items(self) -> Iterator[Tuple[bytes, bytes, int]]:
        """Sorted (key, value, wal_offset) — bottom-level traversal."""
        x = self._head.next[0]
        while x is not None:
            yield x.key, x.value, x.wal_off
            x = x.next[0]

    def sorted_offsets(self) -> List[int]:
        """The Log-Recycling offset array (paper Fig. 6)."""
        return [off for _, _, off in self.items()]

    def key_range(self) -> Tuple[bytes, bytes]:
        it = self._head.next[0]
        if it is None:
            return b"", b""
        first = it.key
        last = first
        x = it
        while x is not None:
            last = x.key
            x = x.next[0]
        return first, last

    def __len__(self):
        return self.n

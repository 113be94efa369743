# Copied from src/repro/core/blockdev.py; only the repro. imports are rewritten.
"""Simulated NVMeoF block device (PoseidonOS logical volume stand-in).

Real bytes move through a sparse block store (dict of block → bytes), so a
"200 GB" volume costs memory only for blocks actually written. Every
operation emits a trace event (node, op, blocks) consumed by the DES
performance layer; the functional layer is deterministic and thread-safe.
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

BLOCK_SIZE = 4096


@dataclass
class TraceEvent:
    node: str
    op: str  # read | write
    block: int
    nblocks: int


class BlockDevice:
    """A logical volume of `num_blocks` blocks of BLOCK_SIZE bytes.

    ``read_latency_s`` models the NVMe-oF fetch round trip: each
    ``read_blocks`` call sleeps that long OUTSIDE the lock (GIL released,
    concurrent readers overlap — exactly the latency an ingestion pipeline
    exists to hide). Default 0.0 keeps the functional layer instantaneous;
    wall-clock benchmarks opt in."""

    def __init__(self, num_blocks: int, name: str = "vol0", *,
                 read_latency_s: float = 0.0):
        self.name = name
        self.num_blocks = num_blocks
        self.read_latency_s = read_latency_s
        self._blocks: Dict[int, bytes] = {}
        self._lock = threading.Lock()
        self.tracer: Optional[Callable[[TraceEvent], None]] = None
        self.reads = 0
        self.writes = 0

    # ------------------------------------------------------------- block IO
    def _check(self, block: int, n: int):
        if block < 0 or block + n > self.num_blocks:
            raise IOError(f"block range [{block}, {block + n}) out of volume bounds")

    def read_blocks(self, block: int, n: int, *, node: str = "?") -> bytes:
        self._check(block, n)
        if self.read_latency_s > 0.0:
            time.sleep(self.read_latency_s)
        with self._lock:
            out = b"".join(
                self._blocks.get(b, b"\x00" * BLOCK_SIZE)
                for b in range(block, block + n)
            )
            self.reads += n
        if self.tracer:
            self.tracer(TraceEvent(node, "read", block, n))
        return out

    def write_blocks(self, block: int, data: bytes, *, node: str = "?") -> None:
        n = (len(data) + BLOCK_SIZE - 1) // BLOCK_SIZE
        self._check(block, n)
        if len(data) % BLOCK_SIZE:
            data = data + b"\x00" * (BLOCK_SIZE - len(data) % BLOCK_SIZE)
        with self._lock:
            for i in range(n):
                self._blocks[block + i] = bytes(
                    data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]
                )
            self.writes += n
        if self.tracer:
            self.tracer(TraceEvent(node, "write", block, n))

    def trim(self, block: int, n: int) -> None:
        self._check(block, n)
        with self._lock:
            for b in range(block, block + n):
                self._blocks.pop(b, None)

    # ------------------------------------------------------- persistence
    # The simulated volume normally lives and dies with the process; the
    # cold-process failover tests need the OPPOSITE — the volume (the
    # "disaggregated" part of the system) must survive an initiator crash
    # so a standby can re-mount it. save/load pickle only the sparse block
    # map, not counters or tracer: a real NVMeoF volume carries data, not
    # the dead initiator's statistics.
    def save(self, path: str) -> None:
        with self._lock:
            snap = dict(self._blocks)
        with open(path, "wb") as f:
            pickle.dump(
                {"name": self.name, "num_blocks": self.num_blocks,
                 "blocks": snap},
                f,
            )

    @classmethod
    def load(cls, path: str, *, read_latency_s: float = 0.0) -> "BlockDevice":
        with open(path, "rb") as f:
            state = pickle.load(f)
        dev = cls(state["num_blocks"], state["name"],
                  read_latency_s=read_latency_s)
        dev._blocks = dict(state["blocks"])
        return dev

    # ------------------------------------------------------------ stats
    @property
    def used_blocks(self) -> int:
        return len(self._blocks)

    def reset_counters(self):
        self.reads = self.writes = 0

# Copied from src/repro/sim/des.py; only the repro. imports are rewritten.
"""Minimal deterministic discrete-event simulator.

Processes are generator coroutines yielding requests:
  ("use", resource, amount)   — queue for FIFO service taking amount/rate s
                                (k-server resources serve k in parallel)
  ("delay", seconds)          — sleep
  ("spawn", generator)        — fork a child process
  ("join", handle)            — wait for a spawned process to finish

Determinism: events at equal times are served in insertion order (stable
sequence numbers); no wall-clock anywhere. This is the performance layer —
the functional layer (repro_torch.core) establishes *correctness*, the DES
reproduces the paper's *timings* from calibrated resource rates.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional

_INF = float("inf")


class Resource:
    """k-server FIFO queue with a scalar service rate (units/second)."""

    def __init__(self, sim: "Sim", name: str, rate: float, servers: int = 1):
        self.sim = sim
        self.name = name
        self.rate = rate
        self.servers = servers
        self._free_at = [0.0] * servers  # next-free time per server
        self.busy_time = 0.0
        self.served = 0
        self.queued_amount = 0.0

    def service_end(self, now: float, amount: float) -> float:
        """Assign to the earliest-free server; return completion time."""
        i = min(range(self.servers), key=lambda j: self._free_at[j])
        start = max(now, self._free_at[i])
        dur = amount / self.rate if self.rate > 0 else 0.0
        end = start + dur
        self._free_at[i] = end
        self.busy_time += dur
        self.served += 1
        self.queued_amount += amount
        return end

    def utilization(self, horizon: float) -> float:
        if horizon <= 0:
            return 0.0
        return min(1.0, self.busy_time / (horizon * self.servers))


@dataclass(order=True)
class _Event:
    t: float
    seq: int
    proc: Any = field(compare=False)
    value: Any = field(compare=False, default=None)


class ProcHandle:
    def __init__(self):
        self.done = False
        self.result = None
        self.end_time = 0.0
        self.waiters: List[Any] = []


class Sim:
    def __init__(self):
        self.now = 0.0
        self._q: List[_Event] = []
        self._seq = itertools.count()
        self.resources: Dict[str, Resource] = {}
        self.events = 0  # events processed (fleet-sweep scale reporting)

    def resource(self, name: str, rate: float, servers: int = 1) -> Resource:
        r = Resource(self, name, rate, servers)
        self.resources[name] = r
        return r

    def spawn(self, gen: Generator, at: Optional[float] = None) -> ProcHandle:
        h = ProcHandle()
        heapq.heappush(
            self._q, _Event(at if at is not None else self.now, next(self._seq), (gen, h))
        )
        return h

    def run(self, until: float = _INF) -> float:
        while self._q:
            ev = heapq.heappop(self._q)
            if ev.t > until:
                self.now = until
                return self.now
            self.now = ev.t
            self.events += 1
            gen, h = ev.proc
            try:
                req = gen.send(ev.value)
            except StopIteration as stop:
                h.done = True
                h.result = getattr(stop, "value", None)
                h.end_time = self.now
                for w in h.waiters:
                    heapq.heappush(
                        self._q, _Event(self.now, next(self._seq), w, h.result)
                    )
                continue
            kind = req[0]
            if kind == "use":
                _, res, amount = req
                end = res.service_end(self.now, amount)
                heapq.heappush(self._q, _Event(end, next(self._seq), (gen, h)))
            elif kind == "delay":
                heapq.heappush(
                    self._q, _Event(self.now + req[1], next(self._seq), (gen, h))
                )
            elif kind == "spawn":
                child = self.spawn(req[1])
                heapq.heappush(
                    self._q, _Event(self.now, next(self._seq), (gen, h), child)
                )
            elif kind == "join":
                target: ProcHandle = req[1]
                if target.done:
                    heapq.heappush(
                        self._q, _Event(self.now, next(self._seq), (gen, h), target.result)
                    )
                else:
                    target.waiters.append((gen, h))
            else:  # pragma: no cover
                raise ValueError(kind)
        return self.now

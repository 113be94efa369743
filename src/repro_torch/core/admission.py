# Copied from src/repro/core/admission.py; only the repro. imports are rewritten.
"""Multi-tenancy admission control for the shared storage node (paper §III-B).

Two production policies plus the AcceptAll/RejectAll endpoints used in the
scalability study (Figs. 8–9):

  * CPUThreshold — reactive: reject offload requests when the storage
    node's CPU utilization exceeds a threshold; rejected tasks run on the
    initiator itself.
  * TokenRing — proactive: a fixed number of tokens circulate among
    registered initiators; a Task Offloader may submit only while holding a
    token. Tokens expire (TTL) and are reclaimed for fairness.

Time is injectable (logical clock) so tests and the DES are deterministic.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional


class EwmaGauge:
    """Exponentially-weighted moving average of a sampled gauge.

    The admission/offload plane samples per-target queue depth at every
    submit begin/end; the EWMA smooths the bursty raw depth into the
    FIFO-pressure telemetry the stripe rebalancer consumes (a single deep
    burst must not trigger a migration storm, but sustained skew must).
    Not thread-safe on its own — callers update under their own lock.

    **Aging** (the ClusterRouter's stale-telemetry defence): ``update``
    optionally stamps the sample time, and ``aged_value`` decays the EWMA
    toward 0 ("unknown") as the gauge goes unreported — a target that
    stops answering health probes must decay out of routing preference,
    never stay frozen at its last (possibly flattering) reading.
    """

    def __init__(self, alpha: float = 0.2, value: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.value = value
        self.samples = 0
        self.updated_at: Optional[float] = None  # last stamped sample time

    def update(self, sample: float, now: Optional[float] = None) -> float:
        self.value += self.alpha * (sample - self.value)
        self.samples += 1
        if now is not None:
            self.updated_at = now
        return self.value

    def age(self, now: float) -> float:
        """Seconds since the last stamped sample (inf if never stamped)."""
        if self.updated_at is None:
            return float("inf")
        return max(0.0, now - self.updated_at)

    def aged_value(self, now: float, half_life: float) -> float:
        """The EWMA decayed by its reporting age: halves every
        ``half_life`` seconds of silence, so a silent target reads as
        "unknown, approaching idle" rather than "exactly as last seen"."""
        a = self.age(now)
        if a == float("inf"):
            return 0.0
        if half_life <= 0.0 or a <= 0.0:
            return self.value
        return self.value * 0.5 ** (a / half_life)


class AdmissionPolicy:
    name = "base"

    def admit(self, initiator: str) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def register(self, initiator: str) -> None:
        pass

    def complete(self, initiator: str) -> None:
        pass


class AcceptAll(AdmissionPolicy):
    name = "accept_all"

    def admit(self, initiator: str) -> bool:
        return True


class RejectAll(AdmissionPolicy):
    name = "reject_all"

    def admit(self, initiator: str) -> bool:
        return False


class CPUThreshold(AdmissionPolicy):
    """Reject when cpu_probe() exceeds `threshold` (paper default 80%)."""

    name = "cpu"

    def __init__(self, cpu_probe: Callable[[], float], threshold: float = 0.8):
        self.cpu_probe = cpu_probe
        self.threshold = threshold
        self.rejections = 0

    def admit(self, initiator: str) -> bool:
        ok = self.cpu_probe() < self.threshold
        if not ok:
            self.rejections += 1
        return ok


class TokenRing(AdmissionPolicy):
    """`n_tokens` circulate among registered initiators; TTL-expired tokens
    are reclaimed and passed on (fairness: round-robin hand-off)."""

    name = "token"

    def __init__(self, n_tokens: int = 4, ttl: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        self.n_tokens = n_tokens
        self.ttl = ttl
        self._clock = clock or self._logical
        self._t = 0.0
        self._lock = threading.Lock()
        self._ring: deque = deque()  # registered initiators, round-robin
        self._holders: Dict[str, float] = {}  # initiator -> expiry time
        self._starved: deque = deque()  # reclaimed-from, for rotation

    def _logical(self) -> float:
        self._t += 0.01
        return self._t

    def register(self, initiator: str) -> None:
        with self._lock:
            if initiator not in self._ring:
                self._ring.append(initiator)

    def _reclaim(self, now: float) -> None:
        expired = [i for i, exp in self._holders.items() if exp <= now]
        for i in expired:
            del self._holders[i]  # token returns to the pool

    def admit(self, initiator: str) -> bool:
        with self._lock:
            if initiator not in self._ring:
                self._ring.append(initiator)
            now = self._clock()
            self._reclaim(now)
            if initiator in self._holders:
                return True
            free = self.n_tokens - len(self._holders)
            if free <= 0:
                if initiator not in self._starved:
                    self._starved.append(initiator)
                return False
            # starvation-queue discipline: a free token goes to the caller
            # only if every node queued AHEAD of it could also be served by
            # the remaining free tokens — guarantees eventual admission
            try:
                idx = list(self._starved).index(initiator)
            except ValueError:
                idx = len(self._starved)
            if idx < free:
                if initiator in self._starved:
                    self._starved.remove(initiator)
                self._holders[initiator] = now + self.ttl
                return True
            if initiator not in self._starved:
                self._starved.append(initiator)
            return False

    def complete(self, initiator: str) -> None:
        """Voluntary early release on task completion."""
        with self._lock:
            self._holders.pop(initiator, None)

    def holders(self):
        with self._lock:
            return dict(self._holders)

# Copied from src/repro/core/router.py; only the repro. imports are rewritten.
"""Cluster front door — dynamic membership, health, priority & failover.

The paper's offload plane (§III) assumes a static, always-healthy target
registry: every ``TaskOffloader`` target is expected to answer forever.
This module is the production hardening layered ON TOP of it — the same
role the router/scheduler tier plays in production inference stacks over
disaggregated storage:

  * **membership** — targets ``join``/``leave``/``drain`` at runtime; the
    underlying ``TaskOffloader`` routing set tracks the live view;
  * **health** — ``probe()`` heartbeats every member (the ``ping``
    endpoint ``serve_engine`` registers) and stamps the offloader's
    queue-depth EWMAs with the probe time. Telemetry AGES: a member that
    stops answering decays toward "unknown" (``EwmaGauge.aged_value``)
    and is quarantined after ``stale_after`` seconds of silence rather
    than staying frozen at its last — possibly flattering — reading;
  * **priority** — three I/O classes: ``background`` work (compaction,
    prep) and ``pushdown`` work (scan operator shares) queue behind
    ``foreground`` work (WAL, flush) once fleet pressure crosses
    ``overload_threshold``, with pushdown draining strictly before
    background; callers can opt into shedding instead;
  * **cancellation** — a queued request dies in the queue; an in-flight
    request has its write lease revoked THROUGH THE JOURNAL immediately,
    so the target's late writes are fenced by ``OffloadFS._live_lease``
    (the lease discipline cuts both ways — that is why no DLM is needed);
  * **failover** — ``standby_takeover`` re-mounts a dead initiator's
    volume on a standby: ``LeaseJournal`` replay surfaces the orphaned
    write leases, ``reclaim_orphans()`` fences them, and the standby owns
    the namespace again with zero data scanning.

Everything is deterministic under an injected clock, and the whole layer
is exercised by ``tests/test_router.py`` through ``FaultyFabric`` — the
fault-injection wrapper that kills, partitions, drops, delays and
duplicates per target under a fixed seed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.admission import EwmaGauge
from repro_torch.core.blockdev import BlockDevice
from repro_torch.core.fs import OffloadFS
from repro_torch.core.offloader import OffloadFuture, TaskOffloader

PRIORITIES = ("foreground", "pushdown", "background")

# membership states
LIVE = "live"
QUARANTINED = "quarantined"
DRAINING = "draining"
LEFT = "left"


class RequestCancelled(Exception):
    """Resolved into a request's future when it is cancelled."""


class OverloadShed(Exception):
    """Resolved into a background request's future when the router sheds
    it instead of queueing (``shed=True`` or the queue is full)."""


@dataclass
class Member:
    name: str
    state: str = LIVE
    joined_at: float = 0.0
    probe_failures: int = 0
    quarantined_at: Optional[float] = None
    last_ping: Optional[dict] = None  # target-side truth, last heartbeat


@dataclass
class RouterStats:
    probes: int = 0
    probe_failures: int = 0
    heartbeats: int = 0  # background probe rounds (start_heartbeat pacer)
    quarantined: int = 0
    rejoined: int = 0
    shed: int = 0
    queued: int = 0
    cancelled_queued: int = 0
    cancelled_inflight: int = 0
    dispatched: Dict[str, int] = field(default_factory=dict)  # by priority


class OffloadRequest:
    """Handle for one routed task: a future plus ``cancel()``.

    The future resolves to ``(result, where_ran)`` like ``submit_async``,
    or raises ``RequestCancelled`` / ``OverloadShed`` / the wire error.
    """

    def __init__(self, router: "ClusterRouter", spec: dict, priority: str):
        self.spec = spec
        self.priority = priority
        self.future: OffloadFuture = OffloadFuture()
        self.cancelled = False
        self._router = router
        self._inner: Optional[OffloadFuture] = None  # set when dispatched

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.future.result(timeout)

    def cancel(self) -> bool:
        return self._router.cancel(self)


class ClusterRouter:
    """The front door over one initiator's ``TaskOffloader``.

    The router NEVER touches blocks itself — it only decides *where* and
    *whether* work runs, and revokes authority (leases) when the answer
    changes. ``clock`` is injectable so tests and the DES drive time.
    """

    def __init__(self, off: TaskOffloader, *,
                 clock: Optional[Callable[[], float]] = None,
                 stale_after: float = 3.0,
                 telemetry_half_life: float = 1.0,
                 max_probe_failures: int = 2,
                 overload_threshold: float = 4.0,
                 max_queued: int = 64,
                 pressure_fn: Optional[Callable[[], float]] = None):
        self.off = off
        self.fs = off.fs
        self.fabric = off.fabric
        self._clock = clock or self._logical_clock
        self._t = 0.0
        self.stale_after = stale_after
        self.telemetry_half_life = telemetry_half_life
        self.max_probe_failures = max_probe_failures
        self.overload_threshold = overload_threshold
        self.max_queued = max_queued
        self._pressure_fn = pressure_fn
        self._lock = threading.RLock()
        self.members: Dict[str, Member] = {}
        self._queue: List[OffloadRequest] = []  # FIFO of held background work
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop: Optional[threading.Event] = None
        self.stats = RouterStats()
        # optional remote-memory tier: its foreground MISS rate is folded
        # into fleet_pressure (attach_memtier), so a cold or churning cache
        # reads as load exactly like deep target queues do
        self.memtier = None
        self.memtier_pressure_weight = 1.0
        now = self._clock()
        for t in list(off.targets):  # adopt the offloader's initial set
            self.members[t] = Member(t, joined_at=now)

    def attach_memtier(self, tier, *, weight: float = 1.0) -> None:
        """Fold a MemTier's foreground miss rate into ``fleet_pressure``:
        every foreground miss is NVMe + fabric work the targets are about
        to absorb, so the router should see it as pressure before the
        queue-depth EWMAs do."""
        with self._lock:
            self.memtier = tier
            self.memtier_pressure_weight = weight

    def _logical_clock(self) -> float:
        self._t += 0.001
        return self._t

    # ---------------------------------------------------------- membership
    def join(self, name: str) -> Member:
        """Add (or re-add) a target to the routing set. A name whose
        engine has not come up yet is admitted but skipped by load
        balancing until its ``submit_task`` endpoint exists."""
        with self._lock:
            m = self.members.get(name)
            now = self._clock()
            if m is None or m.state == LEFT:
                m = Member(name, joined_at=now)
                self.members[name] = m
            else:
                m.state, m.probe_failures, m.quarantined_at = LIVE, 0, None
                m.joined_at = now
            self.off.add_target(name)
            return m

    def leave(self, name: str, *, unregister: bool = False) -> bool:
        """Remove a target for good. ``unregister=True`` also tears down
        its fabric endpoints (the node is gone, not just unrouted)."""
        with self._lock:
            m = self.members.get(name)
            if m is None:
                return False
            m.state = LEFT
            routed = self.off.remove_target(name)
            if unregister:
                self.fabric.unregister(name)
            return routed

    def drain(self, name: str) -> bool:
        """Stop routing NEW work to ``name``; in-flight work finishes.
        ``drained(name)`` reports when the target is quiescent and can be
        taken down without losing anything."""
        with self._lock:
            m = self.members.get(name)
            if m is None or m.state == LEFT:
                return False
            m.state = DRAINING
            self.off.remove_target(name)
            return True

    def drained(self, name: str) -> bool:
        with self._lock:
            m = self.members.get(name)
            if m is None:
                return True
            return m.state in (DRAINING, LEFT) and \
                self.off.outstanding().get(name, 0) == 0

    def live_members(self) -> List[str]:
        with self._lock:
            return [n for n, m in self.members.items() if m.state == LIVE]

    # -------------------------------------------------------------- health
    def _last_seen(self, name: str, m: Member) -> float:
        """When we last heard telemetry from ``name`` — the stamped gauge
        if any probe succeeded, else the join time (a fresh member gets a
        full staleness window before quarantine, not an instant one)."""
        g = self.off._depth_ewma.get(name)
        if g is not None and g.updated_at is not None:
            return max(g.updated_at, m.joined_at)
        return m.joined_at

    def telemetry_age(self, name: str) -> float:
        with self._lock:
            m = self.members.get(name)
            if m is None:
                return float("inf")
            return max(0.0, self._clock() - self._last_seen(name, m))

    def probe(self) -> Dict[str, bool]:
        """One heartbeat round: ping every live/quarantined/draining
        member, stamp the offloader's gauges with target-side truth, and
        apply the quarantine rules:

          * ``max_probe_failures`` consecutive failed pings → quarantine
            (``off.remove_target``: no new work, telemetry kept);
          * a successful ping of a quarantined member → rejoin;
          * a member whose telemetry is older than ``stale_after`` —
            even if we never managed to charge it a failed ping (e.g.
            only its health channel is partitioned) — → quarantine.

        Returns {name: reachable} for this round."""
        out: Dict[str, bool] = {}
        with self._lock:
            targets = [(n, m) for n, m in self.members.items()
                       if m.state in (LIVE, QUARANTINED, DRAINING)]
        for name, m in targets:
            now = self._clock()
            try:
                info = self.fabric.call(self.off.node, name, "ping")
                ok = True
            except Exception:  # noqa: BLE001 - RpcError or injected death
                info, ok = None, False
            out[name] = ok
            with self._lock:
                self.stats.probes += 1
                if ok:
                    m.last_ping = info
                    m.probe_failures = 0
                    # stamp initiator-side gauges with target-side truth
                    with self.off._lock:
                        g = self.off._depth_ewma.setdefault(name, EwmaGauge())
                        g.update(float(info["inflight"]), now)
                    if m.state == QUARANTINED:
                        m.state = LIVE
                        m.quarantined_at = None
                        self.off.add_target(name)
                        self.stats.rejoined += 1
                    continue
                self.stats.probe_failures += 1
                m.probe_failures += 1
                stale = (now - self._last_seen(name, m)) > self.stale_after
                if m.state == LIVE and (
                        m.probe_failures >= self.max_probe_failures or stale):
                    self._quarantine_locked(m, now)
        # a member whose pings "succeed" but whose telemetry channel is
        # dropped can only go stale by age — sweep for it explicitly
        self.sweep_stale()
        self.pump()
        return out

    def start_heartbeat(self, interval: float) -> None:
        """Background probe pacing: run ``probe()`` every ``interval``
        seconds on a daemon thread until ``stop_heartbeat()`` — the router
        drives its own health plane instead of being caller-paced. Pacing
        is wall-clock (``Event.wait``); the injected ``clock`` still stamps
        telemetry ages, so deterministic tests can mix both. A probe round
        that raises is swallowed: the pacer must outlive any single fault
        (that is its whole job)."""
        if interval <= 0:
            raise ValueError("heartbeat interval must be positive")
        with self._lock:
            if self._hb_thread is not None and self._hb_thread.is_alive():
                raise RuntimeError("heartbeat already running")
            stop = threading.Event()
            self._hb_stop = stop

            def _loop():
                while not stop.wait(interval):
                    try:
                        self.probe()
                    except Exception:  # noqa: BLE001 - pacer survives faults
                        pass
                    with self._lock:
                        self.stats.heartbeats += 1

            t = threading.Thread(
                target=_loop, name="router-heartbeat", daemon=True
            )
            self._hb_thread = t
        t.start()

    def stop_heartbeat(self) -> None:
        """Stop the background pacer (idempotent; joins the thread)."""
        with self._lock:
            t, stop = self._hb_thread, self._hb_stop
            self._hb_thread = self._hb_stop = None
        if stop is not None:
            stop.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def sweep_stale(self) -> List[str]:
        """Quarantine every LIVE member whose telemetry age exceeds
        ``stale_after`` (no probe needed — silence IS the signal)."""
        hit = []
        with self._lock:
            now = self._clock()
            for name, m in self.members.items():
                if m.state != LIVE:
                    continue
                if (now - self._last_seen(name, m)) > self.stale_after:
                    self._quarantine_locked(m, now)
                    hit.append(name)
        return hit

    def _quarantine_locked(self, m: Member, now: float) -> None:
        m.state = QUARANTINED
        m.quarantined_at = now
        self.off.remove_target(m.name)
        self.stats.quarantined += 1

    # ------------------------------------------------------------ pressure
    def fleet_pressure(self) -> float:
        """Mean AGED queue-depth EWMA over live members: stale readings
        decay (half-life ``telemetry_half_life``) instead of pinning the
        fleet estimate at the last word of a silent target."""
        if self._pressure_fn is not None:
            return self._pressure_fn()
        with self._lock:
            live = [n for n, m in self.members.items() if m.state == LIVE]
            now = self._clock()
            vals = []
            for n in live:
                g = self.off._depth_ewma.get(n)
                if g is None:
                    continue
                if g.updated_at is None:
                    vals.append(g.value)  # never stamped: initiator-only view
                else:
                    vals.append(g.aged_value(now, self.telemetry_half_life))
            depth = sum(vals) / len(vals) if vals else 0.0
            if self.memtier is not None:
                # a cold/churning tier means the foreground read stream is
                # about to land on NVMe: count the aged miss rate as load
                hr = self.memtier.aged_hit_rate(
                    "foreground", now, self.telemetry_half_life
                )
                depth += self.memtier_pressure_weight * (1.0 - hr)
            return depth

    def overloaded(self) -> bool:
        return self.fleet_pressure() >= self.overload_threshold

    # ---------------------------------------------------------- submission
    def submit(self, task: str, *args,
               read_extents: Sequence = (), write_extents: Sequence = (),
               priority: str = "foreground", shed: bool = False,
               mtime: float = 0.0, bypass_cache: bool = False,
               **kwargs) -> OffloadRequest:
        """Route one task. Foreground dispatches immediately; background
        is held in the router queue while the fleet is overloaded (or
        shed, if the caller prefers failure to waiting). The lease is
        granted at DISPATCH time, not enqueue time — queued work must not
        quiesce blocks it is not yet allowed to touch."""
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        spec = {
            "task": task, "args": args, "kwargs": kwargs,
            "read_extents": read_extents, "write_extents": write_extents,
            "mtime": mtime, "bypass_cache": bypass_cache,
        }
        req = OffloadRequest(self, spec, priority)
        # the I/O-class ladder: foreground always dispatches; pushdown
        # (scan operator shares — latency-tolerant but user-visible) and
        # background (compaction, prep) queue under overload, and pump()
        # drains pushdown strictly before background
        if priority != "foreground" and self.overloaded():
            with self._lock:
                if shed or len(self._queue) >= self.max_queued:
                    self.stats.shed += 1
                    req.future.set_exception(OverloadShed(
                        f"fleet pressure {self.fleet_pressure():.1f} >= "
                        f"{self.overload_threshold} ({priority} shed)"))
                    return req
                self._queue.append(req)
                self.stats.queued += 1
            return req
        self._dispatch(req)
        return req

    def pump(self) -> int:
        """Dispatch queued background work while pressure allows; called
        opportunistically after probes, cancellations and completions.
        Returns how many requests were released."""
        released = 0
        while True:
            with self._lock:
                if not self._queue or self.overloaded():
                    return released
                # highest class first (pushdown before background),
                # FIFO within a class
                i = min(range(len(self._queue)),
                        key=lambda j: (PRIORITIES.index(
                            self._queue[j].priority), j))
                req = self._queue.pop(i)
            if req.cancelled:
                continue
            self._dispatch(req)
            released += 1

    def _dispatch(self, req: OffloadRequest) -> None:
        s = req.spec
        with self._lock:
            self.stats.dispatched[req.priority] = \
                self.stats.dispatched.get(req.priority, 0) + 1
        try:
            inner = self.off.submit({
                "task": s["task"], "args": s["args"],
                "kwargs": s["kwargs"],
                "read_extents": s["read_extents"],
                "write_extents": s["write_extents"],
                "mtime": s["mtime"], "bypass_cache": s["bypass_cache"],
            }, async_=True)
        except LookupError:  # no targets at all: run on the initiator
            try:
                with self.fs.lease_scope(s["read_extents"],
                                         s["write_extents"]) as lease:
                    result = self.off._run_local(
                        s["task"], lease, s["args"], s["kwargs"], s["mtime"])
            except BaseException as g:  # noqa: BLE001
                req.future.set_exception(g)
                return
            with self.off._lock:
                self.off.stats.ran_local += 1
            req.future.set_result((result, self.off.node))
            return
        req._inner = inner

        def _settle(f: OffloadFuture):
            if req.cancelled:
                # the lease was already revoked and the caller already got
                # RequestCancelled; whatever the target did was fenced
                self.pump()
                return
            exc = f.exception()
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(f.result())
            self.pump()

        inner.add_done_callback(_settle)

    # -------------------------------------------------------- cancellation
    def cancel(self, req: OffloadRequest) -> bool:
        """Cancel a request. Queued → it never runs. In-flight → its
        write lease is released NOW (journaled), so the initiator stops
        quiescing and any late write from the target dies on the
        ``_live_lease`` fence. Returns False if already resolved."""
        with self._lock:
            if req.future.done() or req.cancelled:
                return False
            req.cancelled = True
            if req in self._queue:
                self._queue.remove(req)
                self.stats.cancelled_queued += 1
                req.future.set_exception(
                    RequestCancelled("cancelled while queued"))
                return True
            self.stats.cancelled_inflight += 1
        inner = req._inner
        if inner is not None and getattr(inner, "lease", None) is not None:
            # revoke authority mid-flight: journaled release (idempotent —
            # the submit_async completion path may release again, harmless)
            self.fs.release_lease(inner.lease)
        req.future.set_exception(RequestCancelled("cancelled in flight"))
        self.pump()
        return True


# ------------------------------------------------------------------ failover
def standby_takeover(dev: BlockDevice, *, node: str = "standby0",
                     shards: Optional[int] = None, memtier=None
                     ) -> Tuple[OffloadFS, List[int]]:
    """Initiator failover: a standby re-mounts a dead initiator's volume.

    ``OffloadFS.mount`` replays the metadata pickle AND the lease journal
    — every write lease the dead initiator granted but never released
    surfaces as an orphan, its blocks still quiesced (the grantee might
    still be mid-write on the shared device). ``reclaim_orphans()`` then
    fences them: the journal is compacted, the blocks are writable again,
    and any straggler write from the old incarnation's targets dies on
    the ``_live_lease`` fence. Returns ``(fs, fenced_task_ids)``.

    ``memtier`` (optional): the remote cache tier the standby inherits.
    Attaching it WIPES it first (``attach_memtier``'s conservative reset —
    the dead initiator may have owed the pool invalidations it never
    sent), and orphan reclaim then fences the orphans' write sets through
    the fresh tier like any other reclaim: the takeover can only inherit
    a coherent cache.
    """
    kwargs = {} if shards is None else {"shards": shards}
    fs = OffloadFS.mount(dev, node=node, **kwargs)
    if memtier is not None:
        fs.attach_memtier(memtier)  # conservative wipe before first read
    fenced = fs.reclaim_orphans()
    return fs, fenced

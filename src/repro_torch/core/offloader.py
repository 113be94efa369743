# Copied from src/repro/core/offloader.py; only the repro. imports are rewritten.
"""Task Offloader — initiator-side (paper §III), sharded multi-target.

Submits I/O-intensive tasks to storage nodes (near-data processing) and/or
peer initiators with the volume mounted (§III-C), subject to each target's
admission policy. Rejected tasks run immediately on the initiator itself
(the paper's fallback). All remote calls carry only block addresses and
small metadata — never file contents (that's the point).

Beyond the paper's single storage node, the offloader keeps a *target
registry* with pluggable load balancing:

  * ``round_robin``       — rotate through registered targets
  * ``least_outstanding`` — pick the target with the fewest in-flight tasks
  * ``admission_aware``   — like least_outstanding, but targets that
    recently rejected (admission pushback) are deprioritized until a
    submission succeeds there again
  * ``placement_affinity`` — route each task to the target whose shard
    stripe owns the task's extents (striped volumes: shard k of the extent
    allocator maps to ``targets[k % N]``), so compaction reads on
    different shards hit disjoint NVMe FIFOs; tasks without extents fall
    back to least_outstanding

and ONE submission entry point:

  * ``submit(specs, *, stream=False, reroute=False, async_=False)`` —
    specs (one dict or a list) are load-balanced across targets, ONE wire
    message per target (``RpcFabric.call_batch``), and every spec resolves
    to the single result shape ``(result, where_ran)`` through an
    ``OffloadFuture``. Sync by default (wait for all); ``stream=True`` /
    ``async_=True`` return the futures so a consumer (the PrepPipeline
    ingestion plane, the KV-cache fetch path) overlaps per-share
    completions with its own work; ``reroute=True`` retries an
    admission-rejected or wire-failed share once on the least-loaded
    *other* target before the local fallback runs.

Deprecated shims kept for pre-consolidation callers: ``submit_task`` (one
task, one coalesced wire message — ``coalesce=False`` keeps the legacy
3-message handshake for comparison; also reachable as
``submit("task", *args, ...)``), ``submit_async`` (single-task future) and
``submit_many`` (barrier batch: all-or-nothing on wire failure).
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.admission import EwmaGauge
from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.fs import Extent, Lease, OffloadFS
from repro_torch.core.memtier import serve_memtier
from repro_torch.core.rpc import RpcFabric, RpcFuture

LB_POLICIES = ("round_robin", "least_outstanding", "admission_aware",
               "placement_affinity")


@dataclass
class OffloadStats:
    submitted: int = 0
    offloaded: int = 0
    rejected: int = 0
    ran_local: int = 0
    rerouted: int = 0  # admission pushback retried on another target
    batches: int = 0  # submit_many wire batches sent
    affinity_routed: int = 0  # tasks routed to the shard owning their extents
    by_target: Dict[str, int] = field(default_factory=dict)
    rejected_by_target: Dict[str, int] = field(default_factory=dict)


# submit_async resolves to (result, where_ran); same semantics as the
# fabric's future, so reuse it rather than maintaining a twin
OffloadFuture = RpcFuture


class TaskOffloader:
    """One per initiator node. Targets = storage node(s) ∪ peer initiators."""

    def __init__(self, fs: OffloadFS, fabric: RpcFabric, *, node: str,
                 storage_node: str = "storage0",
                 targets: Optional[Sequence[str]] = None,
                 lb_policy: str = "round_robin", coalesce: bool = True):
        self.fs = fs
        self.fabric = fabric
        self.node = node
        self.storage_node = storage_node
        if lb_policy not in LB_POLICIES:
            raise ValueError(f"unknown lb_policy {lb_policy!r}")
        self.lb_policy = lb_policy
        # coalesce=False keeps the legacy 3-message handshake per task and
        # unbatched submit_many — the Fig. 14 baseline
        self.coalesce = coalesce
        self.targets: List[str] = list(targets) if targets else [storage_node]
        self._local_engine = OffloadEngine(fs, node=node, enable_cache=False)
        self.stats = OffloadStats()
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {t: 0 for t in self.targets}
        self._reject_streak: Dict[str, int] = {t: 0 for t in self.targets}
        # per-target queue-depth EWMAs, sampled at every submit begin/end:
        # task depth (how many in flight) and BLOCK depth (how many leased
        # blocks in flight — the bytes actually queued on the target's NVMe
        # FIFO, which is the pressure signal the stripe rebalancer consumes;
        # one huge compaction outweighs many tiny tasks)
        self._depth_ewma: Dict[str, EwmaGauge] = {
            t: EwmaGauge() for t in self.targets
        }
        self._outstanding_blocks: Dict[str, int] = {t: 0 for t in self.targets}
        self._qblocks_ewma: Dict[str, EwmaGauge] = {
            t: EwmaGauge() for t in self.targets
        }
        self._rr = 0

    # ----------------------------------------------------- target registry
    def add_target(self, name: str) -> None:
        with self._lock:
            if name not in self.targets:
                self.targets.append(name)
                self._outstanding[name] = 0
                self._reject_streak[name] = 0
                self._depth_ewma[name] = EwmaGauge()
                self._outstanding_blocks[name] = 0
                self._qblocks_ewma[name] = EwmaGauge()

    def remove_target(self, name: str) -> bool:
        """Drop ``name`` from the routing set (router ``leave``/quarantine).
        In-flight submissions to it settle through their own ``_end`` —
        ``_end``/``_begin`` tolerate unknown names — but no NEW share will
        be routed there. Telemetry gauges are kept (cheap, and a rejoining
        target should not restart from a cold EWMA). Returns whether the
        name was actually routable."""
        with self._lock:
            if name not in self.targets:
                return False
            self.targets.remove(name)
            return True

    def outstanding(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._outstanding)

    # ----------------------------------------------------------- telemetry
    def queue_depth_ewma(self) -> Dict[str, float]:
        """Smoothed in-flight task depth per target."""
        with self._lock:
            return {t: g.value for t, g in self._depth_ewma.items()}

    def queue_blocks_ewma(self) -> Dict[str, float]:
        """Smoothed in-flight LEASED BLOCKS per target — the depth of the
        target's NVMe FIFO in device blocks, the rebalancer's raw signal."""
        with self._lock:
            return {t: g.value for t, g in self._qblocks_ewma.items()}

    def shard_utilization(self) -> Dict[int, float]:
        """Per-stripe FIFO-pressure view of the telemetry: stripe k's
        pressure is its owning target's block-depth EWMA (engines register
        in stripe order, so the mapping is positional — the inverse of
        ``target_for_shard``)."""
        depths = self.queue_blocks_ewma()
        n = len(self.targets)
        if n == 0:
            return {}
        return {
            k: depths.get(self.targets[k % n], 0.0)
            for k in range(max(1, self.fs.shards))
        }

    def pick_target(self) -> str:
        """Load-balanced target choice (never the initiator itself)."""
        with self._lock:
            return self._pick_locked()

    def _eligible_locked(self) -> List[str]:
        """Targets whose engine actually came up (has a ``submit_task``
        endpoint). A name can be registered before its engine is wired —
        routing to it would fail with a spurious ``KeyError``/``RpcError``,
        so load balancing skips it. When NO target has an endpoint the full
        list is returned so the wire error surfaces at call time instead of
        an opaque pick-time failure (the legacy single-target behaviour)."""
        live = [t for t in self.targets if self.fabric.has_endpoint(t)]
        return live or list(self.targets)

    def _pick_locked(self) -> str:
        if not self.targets:
            raise LookupError("no offload targets registered")
        cands = self._eligible_locked()
        n = len(cands)
        if n == 1:
            return cands[0]
        start = self._rr % n
        self._rr += 1
        if self.lb_policy == "round_robin":
            return cands[start]
        rotation = [cands[(start + i) % n] for i in range(n)]
        if self.lb_policy in ("least_outstanding", "placement_affinity"):
            # placement_affinity lands here only for tasks without extents
            return min(rotation, key=lambda t: self._outstanding.get(t, 0))
        # admission_aware: avoid targets pushing back, then least loaded
        return min(rotation,
                   key=lambda t: (self._reject_streak.get(t, 0),
                                  self._outstanding.get(t, 0)))

    def least_loaded_other(self, exclude: str) -> Optional[str]:
        """The least-outstanding target that is NOT ``exclude`` (the
        reroute destination after admission pushback or a wire failure);
        None when there is nowhere else to go. Targets whose engine never
        came up (no ``submit_task`` endpoint) are skipped — rerouting a
        share to a stub-less name would just fail again."""
        with self._lock:
            cands = [t for t in self.targets
                     if t != exclude and self.fabric.has_endpoint(t)]
            if not cands:
                return None
            return min(cands, key=lambda t: (self._outstanding.get(t, 0), t))

    def target_for_shard(self, shard: int) -> str:
        """The target owning extent-allocator stripe ``shard``: engines are
        registered in stripe order, so the mapping is positional."""
        return self.targets[shard % len(self.targets)]

    def _route(self, read_extents: Sequence[Extent],
               write_extents: Sequence[Extent]) -> str:
        """Placement-affinity target choice: the shard owning most of the
        task's blocks (reads weighted with writes — both sides of a
        compaction live on the same stripe under striped placement).
        Extent-less tasks fall back to the load-balanced pick."""
        if self.lb_policy == "placement_affinity":
            shard = self.fs.shard_of_extents(
                list(read_extents) + list(write_extents)
            )
            if shard is not None:
                with self._lock:
                    self.stats.affinity_routed += 1
                return self.target_for_shard(shard)
        return self.pick_target()

    @staticmethod
    def _lease_blocks(lease: Lease) -> int:
        return len(lease.read_blocks | lease.write_blocks)

    def _sample_telemetry_locked(self) -> None:
        """Fold EVERY target's current depth into its gauges (lock held).
        Sampling only the submitting target would freeze an idle target's
        EWMA at its last peak — the rebalancer would then chase a stripe
        that stopped being hot long ago."""
        for t, g in self._depth_ewma.items():
            g.update(self._outstanding.get(t, 0))
        for t, g in self._qblocks_ewma.items():
            g.update(self._outstanding_blocks.get(t, 0))

    def _begin(self, dst: str, blocks: int = 0) -> None:
        with self._lock:
            self.stats.submitted += 1
            self._outstanding[dst] = self._outstanding.get(dst, 0) + 1
            self._outstanding_blocks[dst] = (
                self._outstanding_blocks.get(dst, 0) + blocks
            )
            self._depth_ewma.setdefault(dst, EwmaGauge())
            self._qblocks_ewma.setdefault(dst, EwmaGauge())
            self._sample_telemetry_locked()

    def _end(self, dst: str, outcome: str, blocks: int = 0) -> None:
        """outcome ∈ {offloaded, rejected, rerouted, error}. ``rerouted``
        is admission pushback whose task is being retried on ANOTHER
        target: the pushback is charged to ``dst`` (streak + per-target
        count) but the task is neither rejected-to-local nor offloaded yet
        — the retry's own ``_end`` settles it."""
        with self._lock:
            self._outstanding[dst] = max(0, self._outstanding.get(dst, 1) - 1)
            self._outstanding_blocks[dst] = max(
                0, self._outstanding_blocks.get(dst, blocks) - blocks
            )
            self._depth_ewma.setdefault(dst, EwmaGauge())
            self._qblocks_ewma.setdefault(dst, EwmaGauge())
            self._sample_telemetry_locked()
            if outcome == "offloaded":
                self.stats.offloaded += 1
                self.stats.by_target[dst] = self.stats.by_target.get(dst, 0) + 1
                self._reject_streak[dst] = 0
            elif outcome in ("rejected", "rerouted"):
                if outcome == "rejected":
                    self.stats.rejected += 1
                    self.stats.ran_local += 1
                else:
                    self.stats.rerouted += 1
                self.stats.rejected_by_target[dst] = (
                    self.stats.rejected_by_target.get(dst, 0) + 1
                )
                self._reject_streak[dst] = self._reject_streak.get(dst, 0) + 1

    # -------------------------------------------------------------- stubs
    def register_local_stub(self, name: str, fn: Callable) -> None:
        """Register the task implementation for local (rejected) execution."""
        self._local_engine.register_stub(name, fn)

    # --------------------------------------------------------- submission
    @staticmethod
    def _wire(lease: Lease) -> dict:
        return {
            "task_id": lease.task_id,
            "read_blocks": sorted(lease.read_blocks),
            "write_blocks": sorted(lease.write_blocks),
        }

    def _run_local(self, task: str, lease: Lease, args, kwargs, mtime):
        return self._local_engine.run_task(
            task, lease, *args, mtime=mtime, bypass_cache=True, **kwargs
        )

    def submit(
        self,
        task_or_specs,
        *args,
        stream: bool = False,
        reroute: bool = False,
        async_: bool = False,
        **kwargs,
    ):
        """THE submission entry point. Canonical form: ``submit(specs)``
        where ``specs`` is one spec dict or a sequence of them (keys
        ``task``, ``args``, plus optional ``kwargs``, ``read_extents``,
        ``write_extents``, ``target``, ``mtime``, ``bypass_cache``,
        ``reroute``). Every spec becomes one ``OffloadFuture`` resolving to
        ``(result, where_ran)`` — the single result shape of the plane:

          * default (sync): wait for every future, return the resolved
            ``(result, where)`` list (or the bare tuple for a single dict
            spec); the first failure re-raises after all shares settle so
            no lease outlives the call.
          * ``stream=True`` / ``async_=True``: return the future(s)
            immediately — per-spec completion streaming; each future also
            carries ``.lease``/``.target`` for cancellation.
          * ``reroute=True``: default every spec into the
            pushback/wire-failure reroute path (spec-level value wins).

        Legacy form: ``submit("task", *args, read_extents=..., ...)`` —
        the pre-consolidation single-task signature, kept as a shim and
        routed to :meth:`submit_task`."""
        if isinstance(task_or_specs, str):
            if stream or async_ or reroute:
                raise TypeError(
                    "stream/async_/reroute apply to spec submission; the "
                    "legacy submit(task, *args) form takes none of them"
                )
            return self._submit_task(task_or_specs, *args, **kwargs)
        if args or kwargs:
            raise TypeError("spec submission takes no extra args/kwargs")
        single = isinstance(task_or_specs, dict)
        specs = [task_or_specs] if single else list(task_or_specs)
        if reroute:
            specs = [
                s if "reroute" in s else {**s, "reroute": True} for s in specs
            ]
        futs = self._submit_many_stream(specs)
        if stream or async_:
            return futs[0] if single else futs
        results: List[Any] = []
        first_exc: Optional[BaseException] = None
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                results.append(None)
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return results[0] if single else results

    def submit_task(
        self,
        task: str,
        *args,
        **kwargs,
    ):
        """Deprecated shim (pre-consolidation API, kept so existing callers
        run unchanged — use :meth:`submit`): offload one `task` to `target`
        (default: load-balanced pick) and block. Returns (result,
        where_ran). The initiator quiesces on the leased write set for the
        duration (no DLM — lease discipline instead)."""
        warnings.warn(
            "TaskOffloader.submit_task is deprecated; use "
            "TaskOffloader.submit", DeprecationWarning, stacklevel=2)
        return self._submit_task(task, *args, **kwargs)

    def _submit_task(
        self,
        task: str,
        *args,
        read_extents: Sequence[Extent] = (),
        write_extents: Sequence[Extent] = (),
        target: Optional[str] = None,
        mtime: float = 0.0,
        bypass_cache: bool = False,
        coalesce: Optional[bool] = None,
        **kwargs,
    ):
        coalesce = self.coalesce if coalesce is None else coalesce
        dst = target or self._route(read_extents, write_extents)
        lease = self.fs.grant_lease(read_extents, write_extents)
        nb = self._lease_blocks(lease)
        self._begin(dst, nb)
        ok = False
        try:
            if coalesce:
                status, result = self.fabric.call(
                    self.node, dst, "submit_task", self.node, task,
                    self._wire(lease), args, kwargs, mtime, bypass_cache,
                )
                admitted = status == "ok"
            else:
                # legacy 3-message handshake (admit / run_task / complete)
                admitted = self.fabric.call(self.node, dst, "admit", self.node)
                if admitted:
                    try:
                        result = self.fabric.call(
                            self.node, dst, "run_task", task, self._wire(lease),
                            args, kwargs, mtime, bypass_cache,
                        )
                    finally:
                        # even on a stub error the admission slot goes back
                        self.fabric.call(self.node, dst, "complete", self.node)
            if admitted:
                ok = True
                self._end(dst, "offloaded", nb)
                return result, dst
            # rejected → run locally on the initiator
            ok = True
            self._end(dst, "rejected", nb)
            result = self._run_local(task, lease, args, kwargs, mtime)
            return result, self.node
        finally:
            if not ok:
                self._end(dst, "error", nb)
            self.fs.release_lease(lease)

    def submit_async(
        self,
        task: str,
        *args,
        **kwargs,
    ) -> OffloadFuture:
        """Deprecated shim (use ``submit(spec, async_=True)``): non-blocking
        single-task submit. The lease stays outstanding (the initiator
        keeps quiescing on the write set) until the future resolves; the
        rejected-task fallback runs at resolution. Always a single
        coalesced wire message — async submission has no legacy-handshake
        form, so ``coalesce=False`` offloaders still coalesce here."""
        warnings.warn(
            "TaskOffloader.submit_async is deprecated; use "
            "TaskOffloader.submit(spec, async_=True)",
            DeprecationWarning, stacklevel=2)
        return self._submit_async(task, *args, **kwargs)

    def _submit_async(
        self,
        task: str,
        *args,
        read_extents: Sequence[Extent] = (),
        write_extents: Sequence[Extent] = (),
        target: Optional[str] = None,
        mtime: float = 0.0,
        bypass_cache: bool = False,
        **kwargs,
    ) -> OffloadFuture:
        dst = target or self._route(read_extents, write_extents)
        # reprolint: allow[lease-raw] released in the RPC completion callback, not in this scope
        lease = self.fs.grant_lease(read_extents, write_extents)
        nb = self._lease_blocks(lease)
        self._begin(dst, nb)
        ofut = OffloadFuture()
        # the router's cancellation path needs the in-flight lease (to
        # revoke it through the journal) and the destination (telemetry)
        ofut.lease = lease
        ofut.target = dst
        wire_fut: RpcFuture = self.fabric.call_async(
            self.node, dst, "submit_task", self.node, task,
            self._wire(lease), args, kwargs, mtime, bypass_cache,
        )

        def _done(f: RpcFuture):
            try:
                exc = f.exception()
                if exc is not None:
                    self._end(dst, "error", nb)
                    ofut.set_exception(exc)
                    return
                status, result = f.result()
                if status == "ok":
                    self._end(dst, "offloaded", nb)
                    ofut.set_result((result, dst))
                    return
                self._end(dst, "rejected", nb)
                try:
                    result = self._run_local(task, lease, args, kwargs, mtime)
                except BaseException as e:  # noqa: BLE001
                    ofut.set_exception(e)
                    return
                ofut.set_result((result, self.node))
            finally:
                self.fs.release_lease(lease)

        wire_fut.add_done_callback(_done)
        return ofut

    def submit_many(self, specs: Sequence[dict], *,
                    stream: bool = False) -> List[Any]:
        """Deprecated shim (use ``submit(specs)`` / ``submit(specs,
        stream=True)``). Load-balanced batch submission: each spec is a dict with keys
        ``task``, ``args`` (tuple), plus optional ``kwargs``,
        ``read_extents``, ``write_extents``, ``target``, ``mtime``,
        ``bypass_cache``, ``reroute`` (stream only). One wire message per
        distinct target (``call_batch``), targets served concurrently;
        rejected sub-tasks fall back to local execution. Returns
        [(result, where)] in input order. If any wire batch fails the
        whole call raises after all leases are released — results of
        sub-tasks that did complete are discarded, so callers must treat
        the batch as all-or-nothing.

        ``stream=True`` is the streaming-completion plane: the same
        per-target wire batching, but the call returns immediately with
        one ``OffloadFuture`` per spec (resolving to ``(result, where)``)
        instead of a barrier — shares on a fast target resolve while a
        slow target still computes. Leases are released per share at
        resolution; a wire failure resolves only that target's futures
        (with the exception), not the whole batch. A streamed spec with
        ``reroute=True`` retries admission pushback once on the
        least-loaded other target before falling back local."""
        warnings.warn(
            "TaskOffloader.submit_many is deprecated; use "
            "TaskOffloader.submit(specs)", DeprecationWarning, stacklevel=2)
        if stream:
            return self._submit_many_stream(specs)
        if not specs:
            return []
        if not self.coalesce:  # legacy plane: one handshake per task, serial
            return [
                self.submit(
                    s["task"], *tuple(s.get("args", ())),
                    read_extents=s.get("read_extents", ()),
                    write_extents=s.get("write_extents", ()),
                    target=s.get("target"), mtime=s.get("mtime", 0.0),
                    bypass_cache=s.get("bypass_cache", False),
                    coalesce=False, **dict(s.get("kwargs", {})),
                )
                for s in specs
            ]
        plan = []  # (idx, spec, dst, lease)
        try:
            for idx, s in enumerate(specs):
                dst = s.get("target") or self._route(
                    s.get("read_extents", ()), s.get("write_extents", ())
                )
                lease = self.fs.grant_lease(
                    s.get("read_extents", ()), s.get("write_extents", ())
                )
                self._begin(dst, self._lease_blocks(lease))
                plan.append((idx, s, dst, lease))
        except BaseException:
            # e.g. LeaseViolation mid-batch: unwind what was granted
            for _, _, d, lease in plan:
                self._end(d, "error", self._lease_blocks(lease))
                self.fs.release_lease(lease)
            raise
        groups: Dict[str, List[tuple]] = {}
        for entry in plan:
            groups.setdefault(entry[2], []).append(entry)
        futures = []
        for dst, entries in groups.items():  # insertion order: deterministic
            calls = [
                ("submit_task",
                 (self.node, s["task"], self._wire(lease),
                  tuple(s.get("args", ())), dict(s.get("kwargs", {})),
                  s.get("mtime", 0.0), s.get("bypass_cache", False)),
                 {})
                for (_, s, _, lease) in entries
            ]
            futures.append((dst, entries, self.fabric.call_batch_async(
                self.node, dst, calls)))
            with self._lock:
                self.stats.batches += 1
        out: List[Any] = [None] * len(specs)
        pending_local = []  # rejected: run after all wires resolve
        first_exc: Optional[BaseException] = None
        for dst, entries, fut in futures:
            try:
                results = fut.result()
            except BaseException as e:  # noqa: BLE001
                for (_, _, _, lease) in entries:
                    self._end(dst, "error", self._lease_blocks(lease))
                    self.fs.release_lease(lease)
                if first_exc is None:
                    first_exc = e
                continue
            for (idx, s, _, lease), (status, result) in zip(entries, results):
                if status == "ok":
                    self._end(dst, "offloaded", self._lease_blocks(lease))
                    out[idx] = (result, dst)
                    self.fs.release_lease(lease)
                else:
                    self._end(dst, "rejected", self._lease_blocks(lease))
                    pending_local.append((idx, s, lease))
        if first_exc is not None:
            for (_, _, lease) in pending_local:
                self.fs.release_lease(lease)
            raise first_exc
        for idx, s, lease in sorted(pending_local):
            try:
                result = self._run_local(
                    s["task"], lease, tuple(s.get("args", ())),
                    dict(s.get("kwargs", {})), s.get("mtime", 0.0),
                )
                out[idx] = (result, self.node)
            finally:
                self.fs.release_lease(lease)
        return out

    # ------------------------------------------------- streaming submission
    def _fallback_local(self, spec: dict, lease: Lease,
                        ofut: OffloadFuture) -> None:
        """Run the rejected share on the initiator and resolve its future
        (the lease is released either way)."""
        try:
            result = self._run_local(
                spec["task"], lease, tuple(spec.get("args", ())),
                dict(spec.get("kwargs", {})), spec.get("mtime", 0.0),
            )
        except BaseException as e:  # noqa: BLE001 - propagated via future
            self.fs.release_lease(lease)
            ofut.set_exception(e)
            return
        self.fs.release_lease(lease)
        ofut.set_result((result, self.node))

    def _reroute(self, spec: dict, lease: Lease, nb: int, rejected_by: str,
                 ofut: OffloadFuture) -> None:
        """Admission pushback retry: ONE attempt on the least-loaded other
        target (still under the original lease), then the local fallback."""
        alt = self.least_loaded_other(rejected_by)
        if alt is None:
            self._end(rejected_by, "rejected", nb)
            self._fallback_local(spec, lease, ofut)
            return
        self._end(rejected_by, "rerouted", nb)
        self._begin(alt, nb)
        fut = self.fabric.call_async(
            self.node, alt, "submit_task", self.node, spec["task"],
            self._wire(lease), tuple(spec.get("args", ())),
            dict(spec.get("kwargs", {})), spec.get("mtime", 0.0),
            spec.get("bypass_cache", False),
        )

        def _done(f: RpcFuture):
            exc = f.exception()
            if exc is not None:
                self._end(alt, "error", nb)
                # the share still completes on the initiator; unlike the
                # rejected path, "error" doesn't count ran_local itself
                with self._lock:
                    self.stats.ran_local += 1
                self._fallback_local(spec, lease, ofut)
                return
            status, result = f.result()
            if status == "ok":
                self._end(alt, "offloaded", nb)
                self.fs.release_lease(lease)
                ofut.set_result((result, alt))
                return
            self._end(alt, "rejected", nb)
            self._fallback_local(spec, lease, ofut)

        fut.add_done_callback(_done)

    def _retry_elsewhere(self, spec: dict, lease: Lease, nb: int, failed: str,
                         ofut: OffloadFuture) -> None:
        """Wire-failure recovery for a streamed ``reroute=True`` share: the
        target died (or partitioned) after admission, so retry ONCE on the
        least-loaded other target — still under the ORIGINAL lease, which
        is exactly why no DLM is needed: the write set stayed quiesced on
        the initiator throughout, so re-running elsewhere is idempotent-
        safe. The caller has already settled ``failed``'s accounting with
        ``_end(failed, "error")``; here we only charge the retry leg."""
        alt = self.least_loaded_other(failed)
        if alt is None:
            with self._lock:
                self.stats.ran_local += 1
            self._fallback_local(spec, lease, ofut)
            return
        with self._lock:
            self.stats.rerouted += 1
        self._begin(alt, nb)
        fut = self.fabric.call_async(
            self.node, alt, "submit_task", self.node, spec["task"],
            self._wire(lease), tuple(spec.get("args", ())),
            dict(spec.get("kwargs", {})), spec.get("mtime", 0.0),
            spec.get("bypass_cache", False),
        )

        def _done(f: RpcFuture):
            exc = f.exception()
            if exc is not None:  # second target down too: land it ourselves
                self._end(alt, "error", nb)
                with self._lock:
                    self.stats.ran_local += 1
                self._fallback_local(spec, lease, ofut)
                return
            status, result = f.result()
            if status == "ok":
                self._end(alt, "offloaded", nb)
                self.fs.release_lease(lease)
                ofut.set_result((result, alt))
                return
            self._end(alt, "rejected", nb)
            self._fallback_local(spec, lease, ofut)

        fut.add_done_callback(_done)

    def _submit_many_stream(self, specs: Sequence[dict]) -> List[OffloadFuture]:
        """submit_many's streaming plane — see its docstring. On the
        legacy (``coalesce=False``) plane each spec runs through the
        3-message ``submit`` serially and its future resolves immediately
        (the Fig. 14 baseline has no async form)."""
        futs = [OffloadFuture() for _ in specs]
        if not specs:
            return futs
        if not self.coalesce:
            for s, ofut in zip(specs, futs):
                try:
                    ofut.set_result(self.submit(
                        s["task"], *tuple(s.get("args", ())),
                        read_extents=s.get("read_extents", ()),
                        write_extents=s.get("write_extents", ()),
                        target=s.get("target"), mtime=s.get("mtime", 0.0),
                        bypass_cache=s.get("bypass_cache", False),
                        coalesce=False, **dict(s.get("kwargs", {})),
                    ))
                except BaseException as e:  # noqa: BLE001
                    ofut.set_exception(e)
            return futs
        plan = []  # (idx, spec, dst, lease)
        try:
            for idx, s in enumerate(specs):
                dst = s.get("target") or self._route(
                    s.get("read_extents", ()), s.get("write_extents", ())
                )
                # reprolint: allow[lease-raw] released per-share in _landed/_fallback callbacks
                lease = self.fs.grant_lease(
                    s.get("read_extents", ()), s.get("write_extents", ())
                )
                self._begin(dst, self._lease_blocks(lease))
                # same contract as submit_async: the router's cancellation
                # path revokes the in-flight lease through the journal
                futs[idx].lease = lease
                futs[idx].target = dst
                plan.append((idx, s, dst, lease))
        except BaseException:
            for _, _, d, lease in plan:
                self._end(d, "error", self._lease_blocks(lease))
                self.fs.release_lease(lease)
            raise
        groups: Dict[str, List[tuple]] = {}
        for entry in plan:
            groups.setdefault(entry[2], []).append(entry)
        for dst, entries in groups.items():
            fut = self.fabric.call_batch_async(self.node, dst, [
                ("submit_task",
                 (self.node, s["task"], self._wire(lease),
                  tuple(s.get("args", ())), dict(s.get("kwargs", {})),
                  s.get("mtime", 0.0), s.get("bypass_cache", False)),
                 {})
                for (_, s, _, lease) in entries
            ])
            with self._lock:
                self.stats.batches += 1

            def _landed(f: RpcFuture, dst=dst, entries=entries):
                exc = f.exception()
                if exc is not None:
                    # the target died (or partitioned) mid-batch: shares
                    # that opted in (reroute=True) recover — retried on the
                    # least-loaded other target or landed locally, still
                    # under the original lease; the rest surface the error
                    for (idx, s, _, lease) in entries:
                        nb = self._lease_blocks(lease)
                        self._end(dst, "error", nb)
                        if s.get("reroute"):
                            self._retry_elsewhere(s, lease, nb, dst,
                                                  futs[idx])
                        else:
                            self.fs.release_lease(lease)
                            futs[idx].set_exception(exc)
                    return
                for (idx, s, _, lease), (status, result) in zip(
                        entries, f.result()):
                    nb = self._lease_blocks(lease)
                    if status == "ok":
                        self._end(dst, "offloaded", nb)
                        self.fs.release_lease(lease)
                        futs[idx].set_result((result, dst))
                    elif s.get("reroute"):
                        self._reroute(s, lease, nb, dst, futs[idx])
                    else:
                        self._end(dst, "rejected", nb)
                        self._fallback_local(s, lease, futs[idx])

            fut.add_done_callback(_landed)
        return futs


def serve_engine(engine: OffloadEngine, fabric: RpcFabric, policy,
                 *, node: Optional[str] = None) -> None:
    """Wire an Offload Engine (storage node or peer) into the RPC fabric.

    The lease is reconstructed from the wire payload (block sets), keeping
    the fabric honest: the target never sees initiator object references.
    Registers both the legacy 3-message handshake (admit / run_task /
    complete) and the coalesced single-message ``submit_task``.
    """
    n = node or engine.node

    def admit(initiator: str) -> bool:
        policy.register(initiator)
        return policy.admit(initiator)

    def complete(initiator: str) -> None:
        policy.complete(initiator)

    def _lease(lease_wire) -> Lease:
        return Lease(
            lease_wire["task_id"],
            frozenset(lease_wire["read_blocks"]),
            frozenset(lease_wire["write_blocks"]),
        )

    def run_task(task, lease_wire, args, kwargs, mtime, bypass_cache):
        return engine.run_task(
            task, _lease(lease_wire), *args,
            mtime=mtime, bypass_cache=bypass_cache, **kwargs
        )

    def submit_task(initiator, task, lease_wire, args, kwargs, mtime,
                    bypass_cache):
        """admit + run + complete in ONE round trip."""
        policy.register(initiator)
        if not policy.admit(initiator):
            return ("rejected", None)
        try:
            result = engine.run_task(
                task, _lease(lease_wire), *args,
                mtime=mtime, bypass_cache=bypass_cache, **kwargs
            )
        finally:
            policy.complete(initiator)
        return ("ok", result)

    def wal_append(lease_wire, runs, payload):
        """Near-data durable write of a sealed WAL segment (async WAL
        shipping). Raw block I/O under the segment's write lease — NOT an
        admitted task: durability has no 'run locally instead' fallback, so
        admission never rejects it."""
        lease = _lease(lease_wire)
        pos = 0
        for blk, cnt in runs:
            chunk = payload[pos : pos + cnt * BLOCK_SIZE]
            if not chunk:
                break
            engine.fs.authorized_write(lease, blk, chunk, node=n)
            pos += cnt * BLOCK_SIZE
        engine.wal_segments += 1
        return len(payload)

    def ping() -> dict:
        """Health/telemetry probe (the ClusterRouter's heartbeat): the
        engine's own queue counters, so the router can cross-check its
        initiator-side EWMAs against target-side truth. A dead or
        partitioned target fails the call itself — THAT is the signal."""
        return {
            "node": n,
            "inflight": engine.queue.inflight,
            "inflight_peak": engine.queue.inflight_peak,
            "completed": engine.queue.completed,
            "tasks_run": engine.tasks_run,
            "wal_segments": engine.wal_segments,
            "pushdown_scans": engine.pushdown_scans,
            "pushdown_rows_in": engine.pushdown_rows_in,
            "pushdown_rows_out": engine.pushdown_rows_out,
            "memtier": engine.memtier_node.counters(),
        }

    fabric.register(n, "admit", admit)
    fabric.register(n, "complete", complete)
    fabric.register(n, "run_task", run_task)
    fabric.register(n, "submit_task", submit_task)
    fabric.register(n, "wal_append", wal_append)
    fabric.register(n, "ping", ping)
    # remote-memory block-cache endpoints (repro.core.memtier): the pool
    # shard living in this engine node's DRAM
    serve_memtier(engine.memtier_node, fabric, n)


def serve_engines(engines: Sequence[OffloadEngine], fabric: RpcFabric,
                  policies) -> List[str]:
    """Wire N engines (shards) into the fabric; `policies` is one shared
    policy or a per-engine sequence. Returns the target node names."""
    if not isinstance(policies, (list, tuple)):
        policies = [policies] * len(engines)
    names = []
    for eng, pol in zip(engines, policies):
        serve_engine(eng, fabric, pol)
        names.append(eng.node)
    return names

# Copied from src/repro/core/rpc.py; only the repro. imports are rewritten.
"""In-process RPC plane modeling the paper's gRPC stub/skeleton split.

Messages are really serialized (pickle) so byte counts are honest; every
call is recorded (src, dst, method, req_bytes, resp_bytes, n_calls) — the
DES network model replays these. Handlers are registered per node; a call
is dispatched synchronously (deterministic) or asynchronously through a
small worker pool (``call_async`` → ``RpcFuture``). Batched submission
(``call_batch``) coalesces many small metadata calls into ONE wire message
while accounting bytes exactly as the equivalent individual calls would —
the message-count reduction is the honest saving, not a byte discount.

Determinism: a monotonically increasing sequence number is assigned at
submission time (sync and async alike) and ``records`` is always flushed in
sequence order, so the replay trace is independent of worker-thread
completion interleaving.
"""
from __future__ import annotations

import pickle
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class RpcRecord:
    src: str
    dst: str
    method: str
    req_bytes: int
    resp_bytes: int
    n_calls: int = 1  # sub-calls coalesced into this wire message


class RpcError(Exception):
    pass


class RpcFuture:
    """Resolution handle for an async call; resolves exactly once."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["RpcFuture"], None]] = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: Any) -> None:
        self._result = value
        self._finish()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._finish()

    def _finish(self) -> None:
        self._event.set()
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb: Callable[["RpcFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("rpc future not resolved")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("rpc future not resolved")
        return self._exc


class RpcFabric:
    """Registry of node endpoints + transport with per-message accounting."""

    def __init__(self, *, workers: int = 8):
        self._handlers: Dict[Tuple[str, str], Callable] = {}
        self._lock = threading.Lock()
        self.records: List[RpcRecord] = []
        self.bytes_by_link: Dict[Tuple[str, str], int] = {}
        # deterministic record ordering: seq assigned at submission, records
        # buffered until every earlier seq has landed
        self._seq = 0
        self._next_flush = 0
        self._staged: Dict[int, Optional[RpcRecord]] = {}
        self._flushed = threading.Condition(self._lock)
        # lazy worker pool for call_async
        self._n_workers = workers
        self._workers: List[threading.Thread] = []
        self._jobs: "queue.Queue" = queue.Queue()

    # -------------------------------------------------------- registration
    def register(self, node: str, method: str, fn: Callable) -> None:
        with self._lock:
            self._handlers[(node, method)] = fn

    def unregister(self, node: str) -> int:
        """Tear down every endpoint of ``node`` (a target leaving the
        cluster for good). Returns the number of handlers removed."""
        with self._lock:
            gone = [k for k in self._handlers if k[0] == node]
            for k in gone:
                del self._handlers[k]
            return len(gone)

    def has_endpoint(self, node: str, method: str = "submit_task") -> bool:
        """Whether ``node`` ever registered ``method``. A registered target
        whose engine never came up has NO endpoint and must be skipped by
        load balancing; a *dead* target still has one — death is a wire
        property, discovered (and injected, see ``FaultyFabric``) at call
        time, not a registry property."""
        with self._lock:
            return (node, method) in self._handlers

    def _handler(self, dst: str, method: str) -> Callable:
        with self._lock:
            fn = self._handlers.get((dst, method))
        if fn is None:
            raise RpcError(f"no handler {method!r} on node {dst!r}")
        return fn

    # ---------------------------------------------------------- accounting
    def _alloc_seq(self) -> int:
        with self._lock:
            s = self._seq
            self._seq += 1
            return s

    def _land(self, seq: int, rec: Optional[RpcRecord]) -> None:
        """Stage a finished message; flush the contiguous prefix in order.
        rec=None marks an aborted message (still advances the cursor)."""
        with self._lock:
            self._staged[seq] = rec
            while self._next_flush in self._staged:
                r = self._staged.pop(self._next_flush)
                self._next_flush += 1
                if r is not None:
                    self.records.append(r)
                    key = (r.src, r.dst)
                    self.bytes_by_link[key] = (
                        self.bytes_by_link.get(key, 0) + r.req_bytes + r.resp_bytes
                    )
            self._flushed.notify_all()

    # ----------------------------------------------------------- sync path
    def call(self, src: str, dst: str, method: str, *args, **kwargs) -> Any:
        req = pickle.dumps((args, kwargs))  # may raise — before seq alloc
        seq = self._alloc_seq()
        try:
            fn = self._handler(dst, method)
        except RpcError:
            self._land(seq, None)  # never left the initiator
            raise
        a, kw = pickle.loads(req)  # honest copy across the "wire"
        try:
            result = fn(*a, **kw)
            resp = pickle.dumps(result)
        except Exception as e:
            # an error response crosses the wire too
            err = pickle.dumps(repr(e))
            self._land(seq, RpcRecord(src, dst, method, len(req), len(err)))
            raise
        self._land(seq, RpcRecord(src, dst, method, len(req), len(resp)))
        return pickle.loads(resp)

    # ---------------------------------------------------------- async path
    def _ensure_workers(self) -> None:
        if self._workers:
            return
        with self._lock:
            if self._workers:
                return
            for i in range(self._n_workers):
                t = threading.Thread(
                    target=self._worker_loop, name=f"rpc-worker-{i}", daemon=True
                )
                t.start()
                self._workers.append(t)

    def _worker_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:  # pragma: no cover - shutdown path
                return
            try:
                job()
            except BaseException:  # pragma: no cover - job() resolves its
                pass  # own future; never let a stray error kill the worker

    def call_async(self, src: str, dst: str, method: str, *args, **kwargs
                   ) -> RpcFuture:
        """Submit without blocking; the seq (and hence the replay-record
        position) is fixed NOW, whatever order workers finish in."""
        self._ensure_workers()
        req = pickle.dumps((args, kwargs))  # may raise — before seq alloc
        seq = self._alloc_seq()
        fut = RpcFuture()

        def run():
            try:
                fn = self._handler(dst, method)
            except RpcError as e:
                self._land(seq, None)
                fut.set_exception(e)
                return
            try:
                a, kw = pickle.loads(req)
                result = fn(*a, **kw)
                resp = pickle.dumps(result)
            except BaseException as e:  # noqa: BLE001 - propagated via future
                err = pickle.dumps(repr(e))
                self._land(seq, RpcRecord(src, dst, method, len(req), len(err)))
                fut.set_exception(e)
                return
            self._land(seq, RpcRecord(src, dst, method, len(req), len(resp)))
            fut.set_result(pickle.loads(resp))

        self._jobs.put(run)
        return fut

    # ---------------------------------------------------------- batch path
    def call_batch(self, src: str, dst: str,
                   calls: Sequence[Tuple[str, tuple, dict]]) -> List[Any]:
        """ONE wire message carrying many (method, args, kwargs) sub-calls,
        executed on `dst` in order. Byte accounting equals the sum of the
        equivalent individual calls exactly (same pickles) — batching saves
        messages/round-trips, never bytes. A sub-call exception aborts the
        batch and propagates after the partial response is accounted."""
        if not calls:
            return []
        return self._execute_batch(self._alloc_seq(), src, dst, calls)

    def _execute_batch(self, seq: int, src: str, dst: str,
                       calls: Sequence[Tuple[str, tuple, dict]]) -> List[Any]:
        try:
            reqs = [pickle.dumps((args, kwargs)) for _, args, kwargs in calls]
        except Exception:
            self._land(seq, None)  # unpicklable request: nothing hit the wire
            raise
        req_bytes = sum(len(r) for r in reqs)
        methods = [m for m, _, _ in calls]
        try:
            fns = [self._handler(dst, m) for m in methods]
        except RpcError:
            self._land(seq, None)
            raise
        label = f"batch:{methods[0]}" if len(set(methods)) == 1 else "batch:mixed"
        results: List[Any] = []
        resp_bytes = 0
        try:
            for fn, wire in zip(fns, reqs):
                a, kw = pickle.loads(wire)
                r = fn(*a, **kw)
                blob = pickle.dumps(r)
                resp_bytes += len(blob)
                results.append(pickle.loads(blob))
        except Exception as e:
            resp_bytes += len(pickle.dumps(repr(e)))
            self._land(seq, RpcRecord(src, dst, label, req_bytes, resp_bytes,
                                      n_calls=len(calls)))
            raise
        self._land(seq, RpcRecord(src, dst, label, req_bytes, resp_bytes,
                                  n_calls=len(calls)))
        return results

    def call_batch_async(self, src: str, dst: str,
                         calls: Sequence[Tuple[str, tuple, dict]]) -> RpcFuture:
        """Async variant of call_batch (one wire message, one future). The
        seq is fixed at submission so the replay position is deterministic."""
        self._ensure_workers()
        fut = RpcFuture()
        if not calls:
            fut.set_result([])
            return fut
        seq = self._alloc_seq()

        def run():
            try:
                fut.set_result(self._execute_batch(seq, src, dst, calls))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._jobs.put(run)
        return fut

    # ------------------------------------------------------------- stats
    def drain(self, timeout: float = 30.0) -> None:
        """Block until every submitted message has landed in `records`."""
        with self._lock:
            if not self._flushed.wait_for(
                lambda: self._next_flush >= self._seq, timeout
            ):
                raise TimeoutError("rpc fabric drain timed out")

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self.bytes_by_link.values())

    def total_messages(self) -> int:
        with self._lock:
            return len(self.records)

    def total_subcalls(self) -> int:
        with self._lock:
            return sum(r.n_calls for r in self.records)

    def reset(self):
        self.drain()
        with self._lock:
            self.records.clear()
            self.bytes_by_link.clear()


@dataclass
class FaultRule:
    """Per-target fault probabilities/latency; ``methods=None`` = all."""

    drop: float = 0.0  # P(message raises RpcError instead of delivering)
    delay_s: float = 0.0  # fixed sleep before the handler runs
    duplicate: float = 0.0  # P(at-least-once: the handler runs twice)
    methods: Optional[frozenset] = None

    def applies(self, method: str) -> bool:
        return self.methods is None or method in self.methods


class FaultyFabric(RpcFabric):
    """RpcFabric with deterministic per-target fault injection — the
    ClusterRouter's test plane (and fig19's kill-one-of-N harness).

    Faults are evaluated at *delivery* time (when a worker resolves the
    handler), not submission time, so a message already in flight when its
    target is killed dies on the wire exactly like a real mid-batch crash:

      * ``kill(node)`` / ``revive(node)`` — every delivery raises
        ``RpcError`` (the endpoint stays registered: death is a wire
        property, unlike a target whose engine never came up);
      * ``isolate(node)`` / ``heal(node)`` — network partition; same wire
        behaviour as death, tracked separately so tests can distinguish a
        crashed target from a partitioned-but-healthy one;
      * ``kill_after(node, n)`` — the target executes ``n`` more
        sub-calls, then dies *mid-batch*: later sub-calls of the same wire
        message (and everything after) raise;
      * ``drop(node, p)`` / ``delay(node, s)`` / ``duplicate(node, p)`` —
        per-message loss, added latency, and at-least-once re-delivery,
        optionally scoped to a method set (e.g. drop only ``ping`` to
        simulate a target that serves tasks but stops reporting health).

    The RNG is seeded, so single-threaded fault schedules replay exactly;
    under concurrent workers the *set* of faults is seed-stable but their
    assignment to interleaved messages follows thread scheduling — tests
    that need exactness use probabilities 0/1 or sequenced calls.
    """

    def __init__(self, *, seed: int = 0, workers: int = 8):
        super().__init__(workers=workers)
        self._fault_lock = threading.Lock()
        self._rng = random.Random(seed)
        self._rules: Dict[str, FaultRule] = {}
        self._dead: set = set()
        self._isolated: set = set()
        self._kill_after: Dict[str, int] = {}
        self.injected = {"dead": 0, "partitioned": 0, "dropped": 0,
                         "delayed": 0, "duplicated": 0}

    # ------------------------------------------------------------- control
    def kill(self, node: str) -> None:
        with self._fault_lock:
            self._dead.add(node)
            self._kill_after.pop(node, None)

    def revive(self, node: str) -> None:
        with self._fault_lock:
            self._dead.discard(node)
            self._kill_after.pop(node, None)

    def kill_after(self, node: str, n_calls: int) -> None:
        """Die after executing ``n_calls`` more sub-calls (mid-batch)."""
        with self._fault_lock:
            self._kill_after[node] = n_calls

    def isolate(self, node: str) -> None:
        with self._fault_lock:
            self._isolated.add(node)

    def heal(self, node: str) -> None:
        with self._fault_lock:
            self._isolated.discard(node)

    def drop(self, node: str, p: float = 1.0, methods=None) -> None:
        self._rule(node).drop = p
        self._scope(node, methods)

    def delay(self, node: str, seconds: float, methods=None) -> None:
        self._rule(node).delay_s = seconds
        self._scope(node, methods)

    def duplicate(self, node: str, p: float = 1.0, methods=None) -> None:
        self._rule(node).duplicate = p
        self._scope(node, methods)

    def clear_faults(self, node: Optional[str] = None) -> None:
        with self._fault_lock:
            if node is None:
                self._rules.clear()
                self._dead.clear()
                self._isolated.clear()
                self._kill_after.clear()
            else:
                self._rules.pop(node, None)
                self._dead.discard(node)
                self._isolated.discard(node)
                self._kill_after.pop(node, None)

    def _rule(self, node: str) -> FaultRule:
        with self._fault_lock:
            return self._rules.setdefault(node, FaultRule())

    def _scope(self, node: str, methods) -> None:
        with self._fault_lock:
            self._rules[node].methods = (
                None if methods is None else frozenset(methods)
            )

    # ------------------------------------------------------------ delivery
    def _handler(self, dst: str, method: str) -> Callable:
        fn = super()._handler(dst, method)  # no-endpoint raises first
        with self._fault_lock:
            rule = self._rules.get(dst)
            scoped = rule is not None and rule.applies(method)
            if scoped and rule.drop and self._rng.random() < rule.drop:
                self.injected["dropped"] += 1
                raise RpcError(
                    f"message {method!r} to {dst!r} dropped (injected)")
            delay_s = rule.delay_s if scoped else 0.0
            dup = bool(scoped and rule.duplicate
                       and self._rng.random() < rule.duplicate)

        def wrapped(*args, **kwargs):
            with self._fault_lock:
                if dst in self._dead:
                    self.injected["dead"] += 1
                    raise RpcError(f"node {dst!r} is dead (injected)")
                if dst in self._isolated:
                    self.injected["partitioned"] += 1
                    raise RpcError(f"node {dst!r} unreachable "
                                   "(injected partition)")
                if dst in self._kill_after:
                    self._kill_after[dst] -= 1
                    if self._kill_after[dst] < 0:
                        del self._kill_after[dst]
                        self._dead.add(dst)
                        self.injected["dead"] += 1
                        raise RpcError(
                            f"node {dst!r} died mid-batch (injected)")
            if delay_s > 0.0:
                self.injected["delayed"] += 1
                time.sleep(delay_s)
            result = fn(*args, **kwargs)
            if dup:
                self.injected["duplicated"] += 1
                fn(*args, **kwargs)  # at-least-once: idempotent re-delivery
            return result

        return wrapped

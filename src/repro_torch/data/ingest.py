# Copied from src/repro/data/ingest.py; the repro. imports are rewritten, and
# batches are float64 tensors on the prep's device, complete when delivered.
"""PrepPipeline — the streaming peer prep→train ingestion plane.

OffloadPrep (paper §V) fans a minibatch out to storage/peer targets, but
synchronously: the trainer calls ``preprocess_minibatch`` and waits for the
slowest share before it can touch the batch, and the targets idle while the
trainer consumes it. Operator-pushdown systems (BPF-oF, Farview) get their
win from *pipelining* pushdown results back into the consumer — this module
is that stage for the reproduction:

  * a **producer thread** walks the epoch's deterministic permutation and
    issues each minibatch's remote shares through the offloader's
    streaming plane (``TaskOffloader.submit(specs, stream=True)`` — one wire
    batch per target, one future per share), keeping up to ``window``
    minibatches' shares in flight per target ahead of consumption;
  * the producer computes the **local share** of minibatch *b* while *b*'s
    remote shares (and *b+1..b+window*'s) execute on the targets, then
    assembles the batch and stages it into a **bounded queue**
    (``queue_depth`` slots, default 2 = double-buffered). A full queue
    blocks the producer — backpressure, never drops;
  * admission-rejected shares **re-route** to the least-loaded other
    target before the initiator-local fallback (``spec["reroute"]``);
  * the iterator state — epoch, cursor (batches *delivered*), seed, and
    the in-flight share manifest — checkpoints into **OffloadDB** alongside
    ``PipelineState``, so a crashed or re-scaled trainer resumes at the
    exact next batch, byte-identical to the uninterrupted run.

Determinism: batch *b* of epoch *e* depends only on (seed, e, b) — the
epoch permutation and every per-image augmentation seed derive from them —
never on the target count, window, queue depth, or where a share ran.

Batches are float64 tensors on the ``OffloadPrep``'s device. The producer
thread launches the local share's kernels and records an event after the
batch's last write; the consumer waits on it before it hands the batch
out, so a delivered batch is complete whatever stream reads it.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.offload_prep import OffloadPrep

STATE_KEY = b"ingest/pipeline_state"


@dataclass
class IngestState:
    """Checkpointable iterator state. ``cursor`` counts minibatches
    DELIVERED to the consumer in the current epoch (not issued: in-flight
    work is re-issued on resume). ``inflight`` is the manifest of shares
    issued but not yet delivered at checkpoint time — observability for
    the crash path (what work the dead trainer abandoned), re-issued by
    the resumed producer because cursor never covered it."""

    epoch: int = 0
    cursor: int = 0
    seed: int = 0
    batch: int = 32
    epochs: int = 1
    n_images: int = 0
    shuffle: bool = True  # identity: resume must replay the same order
    inflight: List[dict] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, s: str) -> "IngestState":
        return cls(**json.loads(s))


class _BoundedQueue:
    """Blocking bounded staging queue. ``put`` blocks while full (the
    backpressure contract: the producer stalls, batches are never
    dropped); ``close`` unblocks both sides. ``max_seen`` records the
    high-water mark so tests can assert the bound held."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = capacity
        self.max_seen = 0
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item) -> bool:
        with self._cv:
            while len(self._dq) >= self.capacity and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._dq.append(item)
            self.max_seen = max(self.max_seen, len(self._dq))
            self._cv.notify_all()
            return True

    def get(self):
        """Next item, or None when the queue is closed and drained."""
        with self._cv:
            while not self._dq and not self._closed:
                self._cv.wait()
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)


class PrepPipeline:
    """Streaming prep→train ingestion over a fixed corpus of image paths.

    Iterate to receive ``(N, out, out, 3)`` float64 minibatches (tensors on
    the prep's device) in
    deterministic order; call :meth:`checkpoint` (typically at the
    trainer's checkpoint cadence) to persist the cursor into OffloadDB and
    :meth:`resume` to reconstruct after a crash. ``close()`` stops the
    producer (safe mid-epoch; in-flight futures are drained)."""

    def __init__(self, prep: OffloadPrep, paths: Sequence[str], *,
                 batch: Optional[int] = None, epochs: Optional[int] = None,
                 seed: Optional[int] = None, shuffle: Optional[bool] = None,
                 window: int = 2, queue_depth: int = 2,
                 adaptive_window: bool = False, max_window: int = 8,
                 depth_low: float = 1.0, depth_high: float = 4.0,
                 state: Optional[IngestState] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if max_window < window:
            raise ValueError("max_window must be >= window")
        self.prep = prep
        self.paths = list(paths)
        if state is None:
            self.state = IngestState(
                seed=seed or 0, batch=32 if batch is None else batch,
                epochs=1 if epochs is None else epochs,
                shuffle=True if shuffle is None else shuffle,
                n_images=len(self.paths))
        else:
            # a resumed pipeline's identity comes from the checkpoint: an
            # explicitly passed value that contradicts it would silently
            # deliver batches the caller didn't ask for
            for name, want, have in (("batch", batch, state.batch),
                                     ("epochs", epochs, state.epochs),
                                     ("seed", seed, state.seed),
                                     ("shuffle", shuffle, state.shuffle)):
                if want is not None and want != have:
                    raise ValueError(
                        f"resume {name} mismatch: state has {have}, "
                        f"caller passed {want}")
            if state.n_images != len(self.paths):
                raise ValueError(
                    f"resume corpus mismatch: state has {state.n_images} "
                    f"images, got {len(self.paths)}")
            self.state = state
        # in-flight window: static by default; with ``adaptive_window`` the
        # producer drives it from the offloader's queue-depth EWMAs —
        # additive increase while the targets run shallow (< depth_low
        # smoothed tasks in flight per target), decrease while they run
        # deep (> depth_high), clamped to [1, max_window]. Batch CONTENT
        # never depends on the window (determinism contract above), only
        # how far ahead the producer runs.
        self.window = window
        self.adaptive_window = adaptive_window
        self.max_window = max_window
        self.depth_low = depth_low
        self.depth_high = depth_high
        self.window_min_seen = window
        self.window_max_seen = window
        self._queue = _BoundedQueue(queue_depth)
        self._lock = threading.Lock()  # state + inflight manifest
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.issued = 0  # minibatches whose shares have been issued (tests)

    # ------------------------------------------------------- determinism
    @property
    def batches_per_epoch(self) -> int:
        return len(self.paths) // self.state.batch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.paths))
        if self.state.shuffle:
            rng = np.random.RandomState(
                (self.state.seed * 1_000_003 + epoch * 8191) % (2**31 - 1))
            rng.shuffle(order)
        return order

    def _batch_seed(self, epoch: int, bidx: int) -> int:
        return self.state.seed * 1_000_003 + epoch * 8191 + bidx

    # --------------------------------------------------------- producer
    def _adapt_window(self) -> int:
        """One controller step: nudge ``self.window`` toward the depth
        band and return it. Reads the offloader's smoothed per-target
        in-flight depth — each minibatch puts ~1 share on each target, so
        mean task depth IS the in-flight window the targets actually see."""
        if not self.adaptive_window:
            return self.window
        depths = self.prep.off.queue_depth_ewma()
        mean = sum(depths.values()) / len(depths) if depths else 0.0
        if mean < self.depth_low and self.window < self.max_window:
            self.window += 1  # targets are starving: run further ahead
        elif mean > self.depth_high and self.window > 1:
            self.window -= 1  # queues are deep: stop piling on
        self.window_min_seen = min(self.window_min_seen, self.window)
        self.window_max_seen = max(self.window_max_seen, self.window)
        return self.window

    def _issue(self, epoch: int, bidx: int, order: np.ndarray) -> dict:
        """Issue minibatch ``bidx``'s remote shares through the streaming
        plane; the local share is deferred to assembly (it overlaps with
        the remote execution)."""
        b = self.state.batch
        bpaths = [self.paths[int(i)] for i in order[bidx * b:(bidx + 1) * b]]
        bseed = self._batch_seed(epoch, bidx)
        remote, local_ids = self.prep.plan_shares(len(bpaths))
        specs = [
            self.prep.share_spec(t, ids, bpaths, epoch_seed=bseed,
                                 reroute=True)
            for t, ids in remote
        ]
        futs = self.prep.off.submit(specs, stream=True) if specs else []
        job = {
            "epoch": epoch, "index": bidx, "seed": bseed, "paths": bpaths,
            "local_ids": local_ids,
            "shares": [(t, ids, f) for (t, ids), f in zip(remote, futs)],
        }
        with self._lock:
            self.issued += 1
            self.state.inflight.append({
                "epoch": epoch, "index": bidx,
                "shares": [{"target": t, "images": len(ids)}
                           for t, ids in remote],
            })
        return job

    def _assemble(self, job: dict):
        """Local share first (overlapping the in-flight remote shares),
        then collect each share's future as it resolves. Returns the batch
        and, on a CUDA device, an event recorded after its last write."""
        batch = self.prep.new_batch(len(job["paths"]))
        self.prep.local_images(job["paths"], job["local_ids"], batch,
                               epoch_seed=job["seed"])
        for target, ids, fut in job["shares"]:
            tensors, where = fut.result()
            self.prep.note_remote_outcome(len(ids), target, where)
            self.prep.fill_share(batch, ids, tensors)
        done = None
        if batch.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(batch.device))
        return batch, done

    def _produce(self) -> None:
        try:
            first = True
            for epoch in range(self.state.epoch, self.state.epochs):
                order = self._epoch_order(epoch)
                nb = self.batches_per_epoch
                start = self.state.cursor if first else 0
                first = False
                pending: deque = deque()
                nxt = start
                while nxt < nb or pending:
                    self._adapt_window()
                    while (len(pending) < self.window and nxt < nb
                           and not self._stop.is_set()):
                        pending.append(self._issue(epoch, nxt, order))
                        nxt += 1
                    if not pending:
                        break
                    job = pending.popleft()
                    batch, done = self._assemble(job)
                    if self._stop.is_set():
                        self._drain(pending)
                        return
                    if not self._queue.put((epoch, job["index"], batch, done)):
                        self._drain(pending)
                        return  # consumer closed mid-epoch
        except BaseException as e:  # noqa: BLE001 - surfaced at __next__
            self._error = e
        finally:
            self._queue.close()

    def _drain(self, pending: deque) -> None:
        """Await abandoned in-flight futures so leases are released before
        the producer exits (the volume stays usable after close())."""
        for job in pending:
            for _, _, fut in job["shares"]:
                try:
                    fut.result()
                except BaseException:  # noqa: BLE001 - best-effort drain
                    pass

    # --------------------------------------------------------- consumer
    def start(self) -> "PrepPipeline":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, name="prep-pipeline", daemon=True)
            self._thread.start()
        return self

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        self.start()
        item = self._queue.get()
        if item is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        epoch, bidx, batch, done = item
        if done is not None:
            done.synchronize()  # the producer's kernels have written it all
        with self._lock:
            self.state.inflight = [
                m for m in self.state.inflight
                if not (m["epoch"] == epoch and m["index"] == bidx)
            ]
            self.state.cursor = bidx + 1
            self.state.epoch = epoch
            if self.state.cursor >= self.batches_per_epoch:
                self.state.cursor = 0
                self.state.epoch = epoch + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    # ------------------------------------------------------- checkpoints
    def checkpoint(self, db) -> str:
        """Persist the iterator state into OffloadDB (alongside the
        trainer's ``PipelineState``). Returns the JSON written."""
        with self._lock:
            blob = self.state.to_json()
        db.put(STATE_KEY, blob.encode())
        return blob

    @staticmethod
    def load_state(db) -> Optional[IngestState]:
        blob = db.get(STATE_KEY)
        return IngestState.from_json(blob.decode()) if blob else None

    @classmethod
    def resume(cls, prep: OffloadPrep, paths: Sequence[str], db, *,
               window: int = 2, queue_depth: int = 2,
               adaptive_window: bool = False) -> "PrepPipeline":
        """Reconstruct the pipeline from the OffloadDB checkpoint: the
        next delivered batch is exactly the one the dead trainer would
        have received next. The checkpointed in-flight manifest (shares
        the crash abandoned) is discarded — the cursor never advanced
        past those batches, so the producer re-issues them."""
        state = cls.load_state(db)
        if state is None:
            raise KeyError("no ingest state checkpointed in this DB")
        state.inflight = []  # abandoned by the crash; producer re-issues
        return cls(prep, paths, state=state, window=window,
                   queue_depth=queue_depth, adaptive_window=adaptive_window)


def tokens_from_batch(batch, vocab: int,
                      seq_len: int) -> Dict[str, np.ndarray]:
    """Deterministic patch tokenizer chaining prep output into an LM
    trainer's token plane: each preprocessed image is average-pooled into
    ``seq_len + 1`` patches whose quantized values become token ids (the
    next-token split mirrors ``TokenPipeline``). Pure function of the
    tensor — the prep→train chain stays byte-reproducible. A tensor batch
    is reduced on the host with numpy, in the JAX package's order."""
    if isinstance(batch, torch.Tensor):
        batch = batch.cpu().numpy()
    n = batch.shape[0]
    flat = batch.reshape(n, -1).astype(np.float64)
    if seq_len + 1 > flat.shape[1]:
        # empty split chunks would mean() to NaN → constant garbage tokens
        raise ValueError(
            f"seq_len {seq_len} needs {seq_len + 1} patches but each image "
            f"has only {flat.shape[1]} elements")
    chunks = np.array_split(flat, seq_len + 1, axis=1)
    vals = np.stack([c.mean(axis=1) for c in chunks], axis=1)
    toks = (np.abs(vals * 1e4)).astype(np.int64) % vocab
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

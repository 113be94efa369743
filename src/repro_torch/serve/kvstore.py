"""KvCacheStore — the KV-cache offload serving plane (disaggregated
prefill → decode) over OffloadFS. Port of ``src/repro/serve/kvstore.py``:
cache packing, fetch assembly and ``first_token`` are PyTorch here; the
placement, catalog, leases, eviction and failpoints are a copy.

The paper's lease model applied to inference serving: a **prefill
initiator** packs a request's KV cache into block-aligned chunk extents
and writes them into OffloadFS under a journaled WRITE lease (crash-fenced
like every other lease — a prefill node that dies mid-store leaves an
orphan the next mount fences with ``reclaim_orphans()``); **decode
initiators** attach READ leases and stream the chunks back. No distributed
lock manager anywhere: while the store write is in flight the blocks are
quiesced by the lease, and once released the entry is immutable.

Placement is **prefix-aware**: an entry is keyed by the prompt tokens that
produced its cache, and a new entry lands on the stripe of the longest
already-stored prompt prefix (falling back to a hash of its own tokens).
Requests sharing a prompt prefix therefore dedupe onto the same stripe —
under ``placement_affinity`` routing that is the same *target*, whose
block cache stays hot for the whole prefix family. ``round_robin`` /
``random`` placement are kept as benchmark baselines: they scatter the
family across stripes, so a shared prefix is re-stored (and re-read cold)
almost every time. Dedup is deliberately *stripe-local* — reusing a
replica on a different stripe would split one request's fetch across
targets and defeat the affinity story, exactly like KV-aware routers in
production serving stacks.

Store/fetch traffic routes through ``ClusterRouter`` when one is given
(quarantine, failover and cancellation cover the serving plane for free),
through the ``TaskOffloader`` unified ``submit(specs, stream=True)`` plane
otherwise, and directly against the device (under scoped
``write_lease``/``read_lease`` context managers) when the store is local.

Fetched chunks complete out of order (streamed futures across targets);
the assembly order is recovered by merging the completion log's ascending
chunk-index runs with the port's merge kernel (``kernels.ops.merge_sorted``)
on the store's device.
"""
from __future__ import annotations

import pickle
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.fs import OffloadFS
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


class ServingCrash(BaseException):
    """Raised by a KvCacheStore failpoint to simulate a prefill initiator
    dying mid-store. BaseException (not Exception) on purpose: the scoped
    write lease must NOT be released — the journaled grant stays
    outstanding exactly as a real crash would leave it, and remount replay
    + ``reclaim_orphans()`` fences it."""


# a bfloat16 leaf travels as its uint16 bit pattern under this tag, so the
# blob holds only numpy arrays and builtins (numpy has no bfloat16)
_BF16 = "bfloat16_bits"


def _to_host(x: torch.Tensor):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return {_BF16: x.view(torch.int16).numpy().view(np.uint16)}
    return x.numpy()


def _from_host(x, device):
    if isinstance(x, dict):
        bits = torch.from_numpy(np.ascontiguousarray(x[_BF16]).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _pack_cache(cache) -> bytes:
    """KV-cache tree → bytes, exactly reversible. Leaves are pulled to
    host numpy (bf16 as tagged uint16 bits) and the whole tree is pickled
    — same honesty rule as the RPC fabric (pickle-priced wire)."""
    return pickle.dumps(tree_map(_to_host, cache))


def _unpack_cache(blob: bytes, device="cuda"):
    host = pickle.loads(blob)
    return tree_map(lambda x: _from_host(x, device), host,
                    is_leaf=lambda x: isinstance(x, dict) and _BF16 in x)


def _norm_tokens(tokens) -> Tuple[int, ...]:
    """Prompt identity: any int tensor/array/sequence → flat tuple of ints."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    arr = np.asarray(tokens).reshape(-1)
    return tuple(int(t) for t in arr)


def stub_kv_put(io, runs: Sequence[Tuple[int, int]], payload: bytes) -> int:
    """Near-data chunk write: land ``payload`` on the leased runs (padded
    to whole blocks — the chunk's logical size lives in the inode)."""
    pos = 0
    for blk, n in runs:
        chunk = payload[pos : pos + n * BLOCK_SIZE]
        if not chunk:
            break
        io.offload_write(blk, chunk.ljust(n * BLOCK_SIZE, b"\x00"))
        pos += n * BLOCK_SIZE
    return len(payload)


def stub_kv_get(io, runs: Sequence[Tuple[int, int]], size: int) -> bytes:
    """Near-data chunk read: stream the leased runs back, trimmed to the
    chunk's logical size. Runs through the engine's block cache, so a hot
    prefix family is served from target RAM."""
    out = [io.offload_read(blk, n) for blk, n in runs]
    return b"".join(out)[:size]


def register_kv_stubs(engine) -> None:
    """Register the serving-plane stubs on a target engine."""
    engine.register_stub("kv_put", stub_kv_put)
    engine.register_stub("kv_get", stub_kv_get)


@dataclass
class KvEntry:
    """One stored prefill cache, keyed by the prompt tokens that built it.
    ``replicas`` maps stripe → directory prefix (a family scattered by a
    non-prefix placement policy stores one replica per stripe it hit)."""

    key: str
    tokens: Tuple[int, ...]
    size: int  # packed blob bytes
    nchunks: int
    replicas: Dict[int, str] = field(default_factory=dict)
    # prefill's sampled first token (host array) — lets a warm decode skip
    # the prefill compute entirely, not just the cache build
    first: Optional[Any] = None
    # LRU/TTL clock stamp (store clock, monotonic by default): refreshed on
    # put and fetch, consulted by ``evict()``
    last_used: float = 0.0


@dataclass
class KvStoreStats:
    puts: int = 0
    dedupe_hits: int = 0  # put answered by an existing same-stripe replica
    put_chunks: int = 0
    put_bytes: int = 0
    fetches: int = 0
    fetch_bytes: int = 0
    fetch_chunks: int = 0
    merge_runs: int = 0  # out-of-order completion runs merged per fetch
    evictions: int = 0  # entries removed by the LRU/TTL sweep
    evicted_bytes: int = 0  # replica bytes freed by eviction
    expirations: int = 0  # evictions whose trigger was TTL, not capacity
    evict_skipped_leased: int = 0  # victims skipped because a lease held them


PLACEMENTS = ("prefix", "round_robin", "random")


class KvCacheStore:
    """Per-request KV caches as leased OffloadFS extents (module docstring
    has the full story). ``router``/``off`` select the wire plane; with
    neither, chunk I/O runs on the initiator under scoped CM leases.
    ``device`` is where fetched caches, first tokens and the assembly merge
    live: the card unless the caller passes ``device="cpu"``."""

    CATALOG = "meta"

    def __init__(self, fs: OffloadFS, *, router=None, off=None,
                 root: str = "kv", chunk_blocks: int = 8,
                 placement: str = "prefix", seed: int = 0,
                 capacity_bytes: Optional[int] = None,
                 ttl_s: Optional[float] = None, clock=None,
                 device="cuda"):
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}")
        self.fs = fs
        self.device = torch.device(device)
        # LRU/TTL eviction plane: ``capacity_bytes`` caps the stored blob
        # bytes (least-recently-used replicas go first), ``ttl_s`` expires
        # idle entries outright. Eviction is delete → free → trim through
        # ``fs.delete`` (its lease check is the fence); entries any lease
        # still covers are SKIPPED, not raced. ``clock`` is injectable so
        # tests drive TTL deterministically (defaults to time.monotonic).
        self.capacity_bytes = capacity_bytes
        self.ttl_s = ttl_s
        self._clock = clock if clock is not None else time.monotonic
        self.router = router
        self.off = off if off is not None else (
            router.off if router is not None else None
        )
        self.root = root.rstrip("/")
        self.chunk_bytes = chunk_blocks * BLOCK_SIZE
        self.placement = placement
        self.shards = fs.shards
        self.stats = KvStoreStats()
        self._rr = 0
        self._rng_state = seed or 1  # xorshift — deterministic placement
        self._entries: Dict[str, KvEntry] = {}
        self._lock = threading.RLock()
        self._failpoint: Optional[str] = None
        if self.off is not None:
            self.off.register_local_stub("kv_put", stub_kv_put)
            self.off.register_local_stub("kv_get", stub_kv_get)
        if fs.exists(self._catalog_path()):
            self._load_catalog()

    # ------------------------------------------------------------ catalog
    def _catalog_path(self) -> str:
        return f"{self.root}/{self.CATALOG}"

    def _persist_catalog(self) -> None:
        """Length-prefixed pickle of the entry table — the piece of store
        state a standby needs to decode after taking the volume over.
        Initiator-owned metadata, written through the foreground path."""
        payload = pickle.dumps(sorted(self._entries.values(),
                                      key=lambda e: e.key))
        rec = struct.pack("<I", len(payload)) + payload
        path = self._catalog_path()
        if not self.fs.exists(path):
            self.fs.create(path)
        self.fs.write(path, rec)

    def _load_catalog(self) -> None:
        raw = self.fs.read(self._catalog_path())
        (n,) = struct.unpack("<I", raw[:4])
        for e in pickle.loads(raw[4 : 4 + n]):
            self._entries[e.key] = e

    # ---------------------------------------------------------- placement
    @staticmethod
    def _key(tokens: Tuple[int, ...]) -> str:
        h = zlib.crc32(np.asarray(tokens, np.int64).tobytes())
        return f"{h:08x}{len(tokens):04x}"

    def lookup_longest(self, tokens) -> Tuple[Optional[KvEntry], int]:
        """Longest stored prompt-prefix of ``tokens`` (may be an exact
        match). Returns (entry | None, matched token count)."""
        t = _norm_tokens(tokens)
        best, blen = None, 0
        with self._lock:
            for e in self._entries.values():
                n = len(e.tokens)
                if n > blen and n <= len(t) and t[:n] == e.tokens:
                    best, blen = e, n
        return best, blen

    def _place(self, tokens: Tuple[int, ...]) -> int:
        if self.placement == "round_robin":
            s = self._rr % self.shards
            self._rr += 1
            return s
        if self.placement == "random":
            x = self._rng_state
            x ^= (x << 13) & 0xFFFFFFFF
            x ^= x >> 17
            x ^= (x << 5) & 0xFFFFFFFF
            self._rng_state = x
            return x % self.shards
        # prefix-aware: inherit the stripe of the longest stored prefix
        # (its own placement was the family root's hash), else hash self
        anc, _ = self.lookup_longest(tokens)
        if anc is not None and anc.replicas:
            return min(anc.replicas)
        return zlib.crc32(np.asarray(tokens, np.int64).tobytes()) % self.shards

    # --------------------------------------------------------------- put
    def put(self, tokens, cache, *, first_token=None,
            failpoint: Optional[str] = None) -> dict:
        """Store a prefill cache for ``tokens``. Returns a receipt dict:
        ``{"key", "shard", "deduped", "bytes"}``. A same-stripe replica
        already present answers the put with zero I/O (the dedupe hit the
        placement policy is supposed to manufacture)."""
        t = _norm_tokens(tokens)
        key = self._key(t)
        with self._lock:
            self.stats.puts += 1
            shard = self._place(t)
            entry = self._entries.get(key)
            if entry is not None and shard in entry.replicas:
                entry.last_used = self._clock()  # a dedupe hit is a use
                self.stats.dedupe_hits += 1
                return {"key": key, "shard": shard, "deduped": True,
                        "bytes": 0}
        blob = _pack_cache(cache)
        base = f"{self.root}/{key}/s{shard}"
        chunks = [blob[i : i + self.chunk_bytes]
                  for i in range(0, len(blob), self.chunk_bytes)] or [b""]
        specs = []
        for k, chunk in enumerate(chunks):
            path = f"{base}/c{k}"
            self.fs.create(path, shard=shard)
            self.fs.fallocate(path, len(chunk))
            ino = self.fs.stat(path)
            runs = [(e.block, e.nblocks) for e in ino.extents]
            specs.append({
                "task": "kv_put", "args": (runs, chunk),
                "write_extents": ino.extents,
                "mtime": self.fs.stat(path).mtime,
            })
        self._failpoint = failpoint
        try:
            self._run_specs(specs, write=True)
        finally:
            self._failpoint = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = KvEntry(key, t, len(blob), len(chunks))
                self._entries[key] = entry
            entry.replicas[shard] = base
            entry.last_used = self._clock()
            if first_token is not None:
                entry.first = torch.as_tensor(first_token).cpu().numpy()
            self.stats.put_chunks += len(chunks)
            self.stats.put_bytes += len(blob)
            # capacity back-pressure: evict colder entries before the
            # catalog commit so one persist covers insert + eviction (the
            # fresh entry itself is protected from its own sweep)
            self._evict_locked(protect=key)
            self._persist_catalog()
            # commit point: a standby that takes the volume over must see
            # the chunk inodes + catalog of every completed put
            self.fs.flush_metadata()
        return {"key": key, "shard": shard, "deduped": False,
                "bytes": len(blob)}

    # -------------------------------------------------------------- fetch
    def fetch(self, tokens):
        """Decode-side attach: stream the stored cache for ``tokens`` back
        (exact prompt match) and rebuild the pytree. Returns None when the
        prompt was never stored (the caller recomputes prefill)."""
        t = _norm_tokens(tokens)
        with self._lock:
            entry = self._entries.get(self._key(t))
            if entry is not None:
                entry.last_used = self._clock()  # LRU touch
        if entry is None or entry.tokens != t:
            return None
        shard = min(entry.replicas)
        base = entry.replicas[shard]
        specs = []
        for k in range(entry.nchunks):
            path = f"{base}/c{k}"
            ino = self.fs.stat(path)
            runs = [(e.block, e.nblocks) for e in ino.extents]
            specs.append({
                "task": "kv_get", "args": (runs, ino.size),
                "read_extents": ino.extents, "mtime": ino.mtime,
            })
        arrivals = self._run_specs(specs, write=False)
        blob = self._assemble(arrivals)[: entry.size]
        with self._lock:
            self.stats.fetches += 1
            self.stats.fetch_bytes += len(blob)
            self.stats.fetch_chunks += len(specs)
        return _unpack_cache(blob, self.device)

    # ------------------------------------------------------------- planes
    def _run_specs(self, specs: List[dict], *, write: bool) -> List[tuple]:
        """Run chunk specs through whichever plane this store has. Returns
        the COMPLETION-ordered arrival log [(chunk_idx, payload)] — fetch
        assembly reorders it (``_assemble``)."""
        if self.router is None and self.off is None:
            return self._run_local(specs, write=write)
        arrivals: List[tuple] = []
        alock = threading.Lock()

        def on_done(idx):
            def _cb(f):
                if f.exception() is None:
                    payload = f.result()[0]  # may block: resolve OUTSIDE alock
                    with alock:
                        arrivals.append((idx, payload))
            return _cb

        if self.router is not None:
            futs = []
            for s in specs:
                req = self.router.submit(
                    s["task"], *s["args"],
                    read_extents=s.get("read_extents", ()),
                    write_extents=s.get("write_extents", ()),
                    mtime=s.get("mtime", 0.0), priority="foreground",
                )
                futs.append(req.future)
        else:
            futs = self.off.submit(specs, stream=True)
        for i, f in enumerate(futs):
            f.add_done_callback(on_done(i))
        first_exc = None
        for f in futs:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return arrivals

    def _run_local(self, specs: List[dict], *, write: bool) -> List[tuple]:
        """No plane: the initiator does its own chunk I/O — under the
        scoped lease context managers, so release-on-error (and
        leave-on-crash) is structural rather than hand-rolled."""
        arrivals: List[tuple] = []
        for idx, s in enumerate(specs):
            if write:
                runs, payload = s["args"]
                nbytes = sum(n for _, n in runs) * BLOCK_SIZE
                path = self._path_of_extents(s["write_extents"])
                with self.fs.write_lease(path, length=nbytes) as lease:
                    if self._failpoint == "mid_put" and idx == len(specs) - 1:
                        # simulated prefill-initiator death: the journaled
                        # write lease stays outstanding (BaseException
                        # passes through the CM without release)
                        raise ServingCrash(f"mid_put crash on {path}")
                    pos = 0
                    for blk, n in lease.runs:
                        chunk = payload[pos : pos + n * BLOCK_SIZE]
                        if not chunk:
                            break
                        self.fs.authorized_write(
                            lease, blk, chunk.ljust(n * BLOCK_SIZE, b"\x00"),
                            node=self.fs.node,
                        )
                        pos += n * BLOCK_SIZE
                arrivals.append((idx, len(payload)))
            else:
                runs, size = s["args"]
                path = self._path_of_extents(s["read_extents"])
                with self.fs.read_lease(path) as lease:
                    data = b"".join(
                        self.fs.authorized_read(lease, blk, n,
                                                node=self.fs.node)
                        for blk, n in lease.runs
                    )
                arrivals.append((idx, data[:size]))
        return arrivals

    def _path_of_extents(self, extents) -> str:
        first = extents[0].block
        for path in self.fs.listdir(self.root):
            ino = self.fs.stat(path)
            if any(e.block == first for e in ino.extents):
                return path
        raise FileNotFoundError(f"no kv file owns block {first}")

    # ----------------------------------------------------------- assembly
    def _assemble(self, arrivals: List[tuple]) -> bytes:
        """Reorder the completion log into chunk order. The log is a merge
        of ascending chunk-index runs (each target streams its batch in
        order); split it back into those runs and fold them through the
        merge kernel — keys are chunk indices, payloads are arrival
        slots."""
        if not arrivals:
            return b""
        datas = [d for _, d in arrivals]
        runs: List[List[tuple]] = []
        for slot, (idx, _) in enumerate(arrivals):
            if runs and runs[-1][-1][0] < idx:
                runs[-1].append((idx, slot))
            else:
                runs.append([(idx, slot)])
        with self._lock:
            self.stats.merge_runs += len(runs)
        if len(runs) == 1:
            order = [slot for _, slot in runs[0]]
        else:
            def col(run, i):
                return torch.tensor([p[i] for p in run], dtype=torch.int32,
                                    device=self.device)

            mk, mv = col(runs[0], 0), col(runs[0], 1)
            for run in runs[1:]:
                mk, mv = ops.merge_sorted(mk, mv, col(run, 0), col(run, 1))
            order = mv.tolist()
        return b"".join(datas[slot] for slot in order)

    # ----------------------------------------------------------- eviction
    def _stored_bytes_locked(self) -> int:
        return sum(e.size * len(e.replicas) for e in self._entries.values())

    def stored_bytes(self) -> int:
        """Total replica bytes currently stored (what ``capacity_bytes``
        caps)."""
        with self._lock:
            return self._stored_bytes_locked()

    def _delete_entry_locked(self, entry: KvEntry) -> int:
        """delete → free → trim every chunk file of every replica; the
        blocks return to the allocator and the device TRIMs them (and the
        MemTier, when attached, drops its cached copies on the same path).
        Caller has verified no lease covers the entry."""
        freed = 0
        for _shard, base in sorted(entry.replicas.items()):
            for k in range(entry.nchunks):
                path = f"{base}/c{k}"
                if self.fs.exists(path):
                    self.fs.delete(path)
            freed += entry.size
        del self._entries[entry.key]
        return freed

    def _evict_locked(self, *, now: Optional[float] = None,
                      protect: Optional[str] = None) -> List[str]:
        if self.capacity_bytes is None and self.ttl_s is None:
            return []
        now = self._clock() if now is None else now
        victims: List[str] = []
        # coldest first; once an entry is neither expired nor needed for
        # capacity, no younger entry can be either — stop there
        for e in sorted(self._entries.values(), key=lambda e: e.last_used):
            if e.key == protect:
                continue
            expired = (self.ttl_s is not None
                       and now - e.last_used >= self.ttl_s)
            over = (self.capacity_bytes is not None
                    and self._stored_bytes_locked() > self.capacity_bytes)
            if not (expired or over):
                break
            leased = any(
                self.fs.exists(p) and self.fs.leased(p)
                for _shard, base in e.replicas.items()
                for p in (f"{base}/c{k}" for k in range(e.nchunks))
            )
            if leased:
                # a decode stream (or an in-flight store) still holds the
                # blocks: eviction never races a lease, it skips
                self.stats.evict_skipped_leased += 1
                continue
            freed = self._delete_entry_locked(e)
            self.stats.evictions += 1
            self.stats.evicted_bytes += freed
            if expired:
                self.stats.expirations += 1
            victims.append(e.key)
        return victims

    def evict(self, *, now: Optional[float] = None) -> List[str]:
        """One LRU/TTL sweep; returns the evicted entry keys. An evicted
        prompt simply misses on its next ``fetch`` — the caller recomputes
        prefill and re-stores, byte-identical to the evicted copy."""
        with self._lock:
            victims = self._evict_locked(now=now)
            if victims:
                self._persist_catalog()
                self.fs.flush_metadata()
        return victims

    # ------------------------------------------------------------ queries
    def first_token(self, tokens):
        """Prefill's sampled first token for an exact-match prompt (as a
        tensor on the store's device), or None if the put didn't record
        one."""
        t = _norm_tokens(tokens)
        with self._lock:
            e = self._entries.get(self._key(t))
        if e is None or e.tokens != t or e.first is None:
            return None
        return torch.as_tensor(e.first, device=self.device)

    def contains(self, tokens) -> bool:
        t = _norm_tokens(tokens)
        with self._lock:
            e = self._entries.get(self._key(t))
        return e is not None and e.tokens == t

    def entries(self) -> List[KvEntry]:
        with self._lock:
            return list(self._entries.values())


def attach_store(fs: OffloadFS, **kw) -> KvCacheStore:
    """Standby/decode-side attach after ``mount``/``standby_takeover``:
    rebuild the store view from the on-volume catalog (the constructor
    loads it when present — this alias just names the failover intent)."""
    return KvCacheStore(fs, **kw)

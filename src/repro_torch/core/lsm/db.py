# Copied from src/repro/core/lsm/db.py; the repro. imports are rewritten, and
# OffloadDB takes the torch device that its pushdown scan merges on.
"""OffloadDB — RocksDB-style LSM on OffloadFS with offloaded flush +
compaction (paper §IV).

Key design points reproduced:
  * four I/O kinds: WAL append + MANIFEST update stay on the initiator
    (foreground); MemTable flush + compaction offload to the target.
  * Log Recycling: a flushed MemTable ships only its sorted WAL-offset
    array; the target rebuilds the sorted run from WAL blocks it already
    holds — each KV pair crosses the fabric once.
  * L0 cache: immutable MemTables stay pinned on the initiator until their
    L0→L1 compaction commits; with Log Recycling this defers L0 SSTable
    materialization entirely (L0 lives as WAL + offsets + the in-memory
    table; foreground reads never touch storage for L0).
  * MANIFEST commit is the atomic mark: a crash between output-block
    allocation and commit loses nothing — recovery reclaims orphan blocks.
  * initiator-side table cache (the user-level block cache): compaction on
    the initiator pollutes it (Fig. 12/13); offloaded compaction does not.
  * striped placement (this repo's extension): on a striped OffloadFS
    (``shards=N``), WAL generations rotate across stripes and every
    flush/compaction output is pinned to the job's dominant input stripe —
    combined with the offloader's ``placement_affinity`` policy, each
    job's reads and writes land on the NVMe FIFO of the target that
    executes it (Fig. 16).
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.fs import OffloadFS
from repro_torch.core import pushdown as P
from repro_torch.core.lsm import compaction as C
from repro_torch.core.lsm.manifest import Manifest
from repro_torch.core.lsm.memtable import TOMBSTONE, MemTable
from repro_torch.core.lsm.sstable import SSTableReader, TableMeta, build_bytes
from repro_torch.core.lsm.wal import DEFAULT_SEGMENT_BYTES, WalShipper, WriteAheadLog
from repro_torch.core.offloader import TaskOffloader


@dataclass
class DBConfig:
    memtable_bytes: int = 256 * 1024
    l0_trigger: int = 4  # immutable memtables / L0 tables before L0→L1
    level_ratio: int = 4
    base_level_bytes: int = 2 * 1024 * 1024
    sstable_target_bytes: int = 512 * 1024
    max_level: int = 4
    log_recycling: bool = True
    l0_cache: bool = True
    offload_levels: int = 99  # compactions with source level < this offload
    offload_flush: bool = True
    sync_wal: bool = False
    # async durability plane: seal WAL segments and ship them to shard
    # targets (RpcFabric.call_async); foreground puts only touch the
    # in-memory tail and durability is tracked by wal.durable_lsn
    async_wal: bool = False
    wal_segment_bytes: int = DEFAULT_SEGMENT_BYTES
    wal_max_inflight: int = 8
    table_cache_bytes: int = 8 * 1024 * 1024
    cache_compaction_reads: bool = True  # False = "dio-compaction" (Fig. 12)
    peer_target: Optional[str] = None  # offload to a peer initiator instead
    # multi-tenant striping: `namespace` prefixes every path this instance
    # creates (several OffloadDBs can share one OffloadFS), and
    # `placement_shard` pins ALL of the instance's files to one stripe so
    # its flush/compaction I/O never shares an NVMe FIFO with a co-tenant
    # (None on a striped volume = rotate WAL generations across stripes)
    namespace: str = ""
    placement_shard: Optional[int] = None


class TableCache:
    """Initiator-side user-level block cache (whole-table granularity)."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._lru: "OrderedDict[int, SSTableReader]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, table_id: int) -> Optional[SSTableReader]:
        r = self._lru.get(table_id)
        if r is not None:
            self._lru.move_to_end(table_id)
            self.hits += 1
        else:
            self.misses += 1
        return r

    def put(self, table_id: int, reader: SSTableReader):
        self._lru[table_id] = reader
        self._bytes += len(reader.buf)
        while self._bytes > self.capacity and len(self._lru) > 1:
            _, victim = self._lru.popitem(last=False)
            self._bytes -= len(victim.buf)

    def drop(self, table_id: int):
        r = self._lru.pop(table_id, None)
        if r is not None:
            self._bytes -= len(r.buf)

    @property
    def hit_ratio(self):
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class OffloadDB:
    def __init__(self, fs: OffloadFS, offloader: Optional[TaskOffloader],
                 cfg: Optional[DBConfig] = None, *,
                 register_stubs: bool = True, device="cuda"):
        cfg = cfg if cfg is not None else DBConfig()
        self.fs = fs
        self.off = offloader
        self.cfg = cfg
        self.device = device  # where the pushdown scan merges row streams
        self.manifest = Manifest(fs, cfg.namespace + "/MANIFEST",
                                 shard=cfg.placement_shard)
        self._gen = itertools.count(1)
        self._tid = itertools.count(1)
        self.tables: Dict[int, TableMeta] = {}
        self.levels: Dict[int, List[int]] = {i: [] for i in range(cfg.max_level + 1)}
        self.imm: List[dict] = []  # deferred L0: {gen, mem, wal, entry}
        self.cache = TableCache(cfg.table_cache_bytes)
        self._compact_ptr: Dict[int, int] = {}
        self.stats = {"stall_events": 0, "flushes": 0, "compactions": 0,
                      "wal_bytes": 0, "flush_rpc_payload": 0,
                      "pushdown_scans": 0}
        self.read_stats = {"mem": 0, "imm": 0, "l0": 0, "ln": 0, "absent": 0}
        self.orphans_reclaimed: List[int] = []
        self.rebalancer = None  # attach_rebalancer: drains cold SSTables
        self.wal_shipper = self._make_shipper()
        self._new_wal()
        if register_stubs and offloader is not None:
            offloader.register_local_stub("compact", C.stub_compact)
            offloader.register_local_stub("log_recycle", C.stub_log_recycle)
            offloader.register_local_stub("pushdown_scan",
                                          P.stub_pushdown_scan)

    # ------------------------------------------------------------ WAL mgmt
    def _make_shipper(self) -> Optional[WalShipper]:
        if not self.cfg.async_wal or self.off is None or not self.off.targets:
            return None
        return WalShipper(self.fs, self.off.fabric, self.off.targets,
                          node=self.fs.node)

    def _new_wal(self):
        g = next(self._gen)
        path = f"{self.cfg.namespace}/wal/{g:08d}"
        if self.fs.shards > 1:
            # pinned instance: every WAL on its stripe; otherwise rotate
            # generations so each flush's reads (Log Recycling) stay on one
            # shard while consecutive memtables land on different FIFOs
            shard = self.cfg.placement_shard
            self.fs.create(path, shard=g % self.fs.shards
                           if shard is None else shard)
        self.wal = WriteAheadLog(
            self.fs, path, sync=self.cfg.sync_wal, shipper=self.wal_shipper,
            segment_bytes=self.cfg.wal_segment_bytes,
            max_inflight=self.cfg.wal_max_inflight,
        )
        self.wal_gen = g
        self.mem = MemTable(seed=g)
        self.manifest.append({"kind": "wal", "gen": g, "path": path})
        self.manifest.commit()

    # ------------------------------------------------------------- writes
    def put(self, key: bytes, value: bytes) -> None:
        off = self.wal.append(key, value)
        self.stats["wal_bytes"] += len(key) + len(value) + 10
        self.mem.put(key, value, off)
        if self.mem.bytes >= self.cfg.memtable_bytes:
            self.seal_memtable()

    def delete(self, key: bytes) -> None:
        off = self.wal.append(key, TOMBSTONE)
        self.mem.delete(key, off)
        if self.mem.bytes >= self.cfg.memtable_bytes:
            self.seal_memtable()

    # -------------------------------------------------------------- reads
    def get(self, key: bytes) -> Optional[bytes]:
        src = "absent"
        v = self.mem.get(key)
        if v is not None:
            src = "mem"
        if v is None:
            for entry in reversed(self.imm):  # newest first (L0 cache)
                v = entry["mem"].get(key)
                if v is not None:
                    src = "imm"
                    break
        if v is None:
            for tid in reversed(self.levels[0]):  # newest L0 first
                r = self._reader(tid)
                v = r.get(key)
                if v is not None:
                    src = "l0"
                    break
        if v is None:
            for lvl in range(1, self.cfg.max_level + 1):
                for tid in self.levels[lvl]:
                    m = self.tables[tid]
                    if m.min_key <= key <= m.max_key:
                        v = self._reader(tid).get(key)
                        if v is not None:
                            src = "ln"
                            break
                if v is not None:
                    break
        self.read_stats[src] += 1
        if v is None or v == TOMBSTONE:
            return None
        return v

    def foreground_hit_ratio(self) -> float:
        """Initiator cache-hierarchy hit ratio for reads past the active
        memtable: L0-cache (pinned immutable memtables) hits + table-cache
        hits over all such lookups (the Fig. 12/13 metric)."""
        hits = self.read_stats["imm"] + self.cache.hits
        total = hits + self.cache.misses
        return hits / total if total else 0.0

    def scan(self, lo: bytes = b"", n: Optional[int] = None, *,
             program: Optional[dict] = None, pushdown: bool = False):
        """Range scan.  Legacy form ``scan(lo, n)``: the n smallest
        ``(key, value)`` rows with key ≥ lo, merged across all sources.

        Operator form ``scan(program=prog, pushdown=...)``: ``prog`` is a
        verified pushdown program (:func:`repro.core.pushdown.build_scan`)
        carrying its own ``[lo, hi)`` range plus filter / projection /
        aggregate; ``n`` becomes an optional row limit.  With
        ``pushdown=True`` the scan plans one sub-scan per stripe whose
        SSTables overlap the range, ships the *program* to each target
        through ``TaskOffloader.submit`` (``placement_affinity`` keeps
        each sub-scan on the stripe that owns its extents), and merges the
        per-target row streams on-device via ``ops.merge_runs`` — only
        matching rows (plus key-only suppression markers, see
        ``repro.core.pushdown``) cross the wire.  ``pushdown=False``
        evaluates the same program over initiator block shipping — the
        differential-testing baseline.  Both paths return identical rows
        (or the identical aggregate value)."""
        if program is None:
            if n is None:
                raise TypeError("legacy scan(lo, n) requires a row count")
            sources: List[Iterable[Tuple[bytes, bytes]]] = []
            sources.append(((k, v) for k, v, _ in self.mem.items() if k >= lo))
            for entry in reversed(self.imm):
                sources.append(
                    ((k, v) for k, v, _ in entry["mem"].items() if k >= lo))
            for tid in reversed(self.levels[0]):
                sources.append(self._reader(tid).range_items(lo, None))
            for lvl in range(1, self.cfg.max_level + 1):
                its = [self._reader(t).range_items(lo, None)
                       for t in self.levels[lvl]]
                sources.append(itertools.chain(*its))
            out = []
            for k, v in C._merge(sources, drop_tombstones=True):
                out.append((k, v))
                if len(out) >= n:
                    break
            return out
        prog = P.verify_program(program)  # reject before anything ships
        if pushdown and self.off is not None and self.off.targets:
            return self._scan_pushdown(prog, n)
        return self._scan_program_local(prog, n)

    # ------------------------------------------------ pushdown scan plane
    def _ranked_sources(self, lo: bytes, hi: Optional[bytes]):
        """All row sources overlapping ``[lo, hi)``, each tagged with a
        globally unique precedence rank (lower = newer): memtable, then
        immutable memtables newest→oldest, then L0 tables newest→oldest,
        then L1..Lmax.  Returns (initiator_sources, storage_tables) as
        ``[(rank, iterable)]`` and ``[(rank, table_id)]``."""
        def in_range(k):
            return k >= lo and (hi is None or k < hi)

        rank = itertools.count()
        local = [(next(rank),
                  ((k, v) for k, v, _ in self.mem.items() if in_range(k)))]
        for entry in reversed(self.imm):
            local.append((next(rank), ((k, v) for k, v, _
                                       in entry["mem"].items()
                                       if in_range(k))))
        tables = []
        for tid in reversed(self.levels[0]):
            tables.append((next(rank), tid))
        for lvl in range(1, self.cfg.max_level + 1):
            for tid in self.levels[lvl]:
                tables.append((next(rank), tid))
        pruned = []
        for r, tid in tables:
            m = self.tables[tid]
            if m.max_key < lo or (hi is not None and m.min_key >= hi):
                continue
            pruned.append((r, tid))
        return local, pruned

    def _local_wire_rows(self, prog: dict, local) -> List[tuple]:
        """Initiator-resident rows (mem + imm) in the stub's wire-row
        convention: ``(key, rank, payload)`` with ``None`` for
        tombstone/filtered rows — one deduped key-sorted stream."""
        best: Dict[bytes, Tuple[int, bytes]] = {}
        for rnk, src in local:  # rank order: first sighting wins
            for k, v in src:
                best.setdefault(k, (rnk, v))
        agg = prog.get("aggregate")
        key_only = prog.get("project") == "key"
        out = []
        for k in sorted(best):
            rnk, v = best[k]
            if v == TOMBSTONE or not P.eval_filter(prog, k, v):
                out.append((k, rnk, None))
            elif agg:
                out.append((k, rnk, len(v)))
            else:
                out.append((k, rnk, b"" if key_only else v))
        return out

    def _scan_program_local(self, prog: dict, limit: Optional[int]):
        """Block-shipping baseline: every overlapping SSTable is read to
        the initiator and the program evaluates here."""
        lo, hi = prog["lo"], prog.get("hi")
        local, tables = self._ranked_sources(lo, hi)
        sources = [src for _, src in local]
        sources += [self._reader(t).range_items(lo, hi) for _, t in tables]
        agg = prog.get("aggregate")
        state = P.agg_init(agg) if agg else None
        out: List[tuple] = []
        for k, v in C._merge(sources, drop_tombstones=True):
            if not P.eval_filter(prog, k, v):
                continue
            if agg:
                state = P.agg_add(agg, state, k, len(v))
            else:
                out.append(P.project_row(prog, k, v))
                if limit is not None and len(out) >= limit:
                    break
        return state if agg else out

    def _scan_pushdown(self, prog: dict, limit: Optional[int]):
        """Plan + execute the pushdown scan: one sub-scan per stripe
        owning overlapping SSTables, submitted with ``reroute=True`` so a
        dead target's share retries elsewhere or lands locally under the
        same read lease."""
        import heapq
        lo, hi = prog["lo"], prog.get("hi")
        local, tables = self._ranked_sources(lo, hi)
        lstream = self._local_wire_rows(prog, local)
        groups: Dict[int, dict] = {}
        for rnk, tid in tables:
            m = self.tables[tid]
            ino = self.fs.stat(m.path)
            shard = (self.fs.shard_of_extents(ino.extents)
                     if self.fs.shards > 1 else None)
            g = groups.setdefault(-1 if shard is None else shard,
                                  {"tables": [], "extents": [], "mtime": 0.0})
            g["tables"].append({
                "runs": [(e.block, e.nblocks) for e in ino.extents],
                "size": ino.size, "rank": rnk,
            })
            g["extents"].extend(ino.extents)
            g["mtime"] = max(g["mtime"], ino.mtime)
        agg = prog.get("aggregate")
        # single-stripe aggregate with no initiator-resident rows: the
        # sub-scan provably covers the whole range, so the target can
        # aggregate fully and ship ONLY the aggregate state
        final = bool(agg) and not lstream and len(groups) == 1
        specs = [{
            "task": "pushdown_scan",
            "args": (g["tables"], prog),
            "kwargs": {"final": final},
            "read_extents": g["extents"],
            "mtime": g["mtime"],
            "reroute": True,
        } for _, g in sorted(groups.items())]
        self.stats["pushdown_scans"] += 1
        results = self.off.submit(specs) if specs else []
        streams = [lstream] if lstream else []
        agg_states = []
        for res, _where in results:
            if res[0] == "agg":
                agg_states.append(res[1])
                continue
            _, matched, marker_blob, _scanned = res
            markers = [(k, rnk, None)
                       for k, rnk in P.unpack_markers(marker_blob)]
            streams.append(list(heapq.merge(matched, markers,
                                            key=lambda r: r[0])))
        if final:
            state = P.agg_init(agg)
            for s in agg_states:
                state = P.agg_merge(agg, state, s)
            return state
        winners = P.merge_row_streams(streams, self.device)
        state = P.agg_init(agg) if agg else None
        proj = prog.get("project")
        out: List[tuple] = []
        for k, _rnk, payload in winners:
            if payload is None:  # tombstone or filtered-out winner
                continue
            if agg:
                state = P.agg_add(agg, state, k, payload)
            elif proj == "key":
                out.append(k)
            elif proj == "value":
                out.append(payload)
            else:
                out.append((k, payload))
            if not agg and limit is not None and len(out) >= limit:
                break
        return state if agg else out

    def _reader(self, tid: int, *, for_compaction: bool = False) -> SSTableReader:
        use_cache = self.cfg.cache_compaction_reads or not for_compaction
        r = self.cache.get(tid) if use_cache else None
        if r is None:
            m = self.tables[tid]
            r = SSTableReader(self.fs.read(m.path))
            if use_cache:
                self.cache.put(tid, r)
        return r

    # ------------------------------------------------------------- flush
    def seal_memtable(self) -> None:
        entry = {
            "gen": self.wal_gen,
            "mem": self.mem,
            "wal": self.wal,
            "count": len(self.mem),
        }
        self.wal.flush()
        mn, mx = self.mem.key_range()
        self.manifest.append({
            "kind": "l0log", "gen": entry["gen"], "path": self.wal.path,
            "count": len(self.mem), "min": mn.hex(), "max": mx.hex(),
        })
        self.imm.append(entry)
        self._new_wal()
        self.stats["flushes"] += 1
        if not (self.cfg.log_recycling and self.cfg.l0_cache):
            # pop only once the flush committed (failure keeps it readable)
            self._materialize_l0(self.imm[0])
            self.imm.pop(0)
        self.maybe_compact()

    def _file_runs(self, path: str) -> Tuple[List[Tuple[int, int]], int]:
        ino = self.fs.stat(path)
        return [(e.block, e.nblocks) for e in ino.extents], ino.size

    def _placement_shard(self, read_paths) -> Optional[int]:
        """Striped placement key for a job: the instance's pinned stripe,
        else the stripe owning most of its input blocks (outputs go there
        too, and placement_affinity routing sends the task to the same
        target). None on flat volumes."""
        if self.fs.shards <= 1:
            return None
        if self.cfg.placement_shard is not None:
            return self.cfg.placement_shard
        exts = []
        for p in read_paths:
            exts.extend(self.fs.stat(p).extents)
        shard = self.fs.shard_of_extents(exts)
        if shard is not None and self.rebalancer is not None:
            # placement steering: an unpinned instance would otherwise pile
            # its whole L1 back onto the dominant input stripe every round
            shard = self.rebalancer.steer(shard)
        return shard

    def _alloc_outputs(self, total_bytes: int,
                       shard: Optional[int] = None) -> List[dict]:
        """Preallocate output files sized to the inputs (paper §IV-A),
        pinned to ``shard`` on striped volumes."""
        tgt = self.cfg.sstable_target_bytes
        # headroom: per-record index/footer overhead can exceed the input
        # size estimate for tiny records; unused outputs are reclaimed
        k = max(1, -(-int(total_bytes * 1.5) // tgt)) + 2
        outs = []
        for _ in range(k):
            tid = next(self._tid)
            path = f"{self.cfg.namespace}/sst/tmp-{tid:08d}"
            self.fs.create(path, shard=shard)
            exts = self.fs.fallocate(path, tgt + BLOCK_SIZE)
            outs.append({
                "tid": tid, "path": path,
                "runs": [(e.block, e.nblocks) for e in exts],
                "cap": tgt + BLOCK_SIZE,
                "extents": exts,
            })
        return outs

    def _offload_ok(self, task: str, level: int) -> bool:
        return self.off is not None and (
            (task == "compact" and level < self.cfg.offload_levels)
            or (task == "log_recycle" and self.cfg.offload_flush)
        )

    def _lease_args(self, read_paths, write_outputs):
        read_extents = []
        mtime = 0.0
        for p in read_paths:
            ino = self.fs.stat(p)
            read_extents.extend(ino.extents)
            mtime = max(mtime, ino.mtime)
        write_extents = [e for o in write_outputs for e in o["extents"]]
        return read_extents, write_extents, mtime

    def _submit(self, task: str, *args, read_paths=(), write_outputs=(),
                level: int = 0, **kw):
        """Offload via the Task Offloader (or run locally when disabled)."""
        read_extents, write_extents, mtime = self._lease_args(
            read_paths, write_outputs
        )
        target = self.cfg.peer_target
        if self._offload_ok(task, level):
            result, where = self.off.submit({
                "task": task, "args": args, "kwargs": kw,
                "read_extents": read_extents,
                "write_extents": write_extents,
                "target": target, "mtime": mtime,
                "bypass_cache": False,
            })
            return result, where
        # run on the initiator (Local mode / rejected)
        lease = self.fs.grant_lease(read_extents, write_extents)
        try:
            from repro_torch.core.engine import OffloadEngine

            eng = OffloadEngine(self.fs, node=self.fs.node, enable_cache=False)
            eng.register_stub("compact", C.stub_compact)
            eng.register_stub("log_recycle", C.stub_log_recycle)
            res = eng.run_task(task, lease, *args, mtime=mtime, bypass_cache=True, **kw)
            # initiator-side compaction I/O pollutes the table cache
            if self.cfg.cache_compaction_reads and task == "compact":
                for tid in list(self.cache._lru):
                    self.cache.get(tid)  # touch: models pollution pressure
            return res, self.fs.node
        finally:
            self.fs.release_lease(lease)

    def _commit_outputs(self, outs, results, level_to: int) -> List[int]:
        new_ids = []
        used_idx = {r["idx"] for r in results}
        for r in results:
            o = outs[r["idx"]]
            path = f"{self.cfg.namespace}/sst/{level_to}/{o['tid']:08d}"
            self.fs.rename(o["path"], path)
            self.fs.truncate(path, r["used"])  # reclaim unused tail blocks
            meta = TableMeta(
                o["tid"], path, level_to, r["n"], r["used"],
                bytes(r["min"]), bytes(r["max"]),
            )
            self.tables[o["tid"]] = meta
            new_ids.append(o["tid"])
            self.manifest.append({
                "kind": "add", "level": level_to, "table_id": o["tid"],
                "path": path, "n": r["n"], "size": r["used"],
                "min": meta.min_key.hex(), "max": meta.max_key.hex(),
            })
        for i, o in enumerate(outs):
            if i not in used_idx:
                self.fs.delete(o["path"])  # unused prealloc → back to allocator
        return new_ids

    def _pollute_after_local(self, where: str, new_ids) -> None:
        """Cache pollution (paper §II-E2): compaction executed ON the
        initiator drags its output (and victim) blocks through the
        initiator's cache — exactly what offloading avoids. dio-compaction
        (cache_compaction_reads=False) bypasses."""
        if where == self.fs.node and self.cfg.cache_compaction_reads:
            for t in new_ids:
                self._reader(t)

    def _prep_flush_job(self, entry) -> dict:
        """Build the submission for flushing one immutable memtable."""
        mem: MemTable = entry["mem"]
        total = mem.bytes + 24 * len(mem) + 4096
        outs = self._alloc_outputs(
            total, shard=self._placement_shard([entry["wal"].path])
        )
        runs, size = self._file_runs(entry["wal"].path)
        wal_arg = {"runs": runs, "size": size, "offsets": mem.sorted_offsets()}
        self.stats["flush_rpc_payload"] += 8 * len(mem)  # offsets only
        return {
            "kind": "flush", "task": "log_recycle", "level": 0,
            "args": (wal_arg, [{"runs": o["runs"], "cap": o["cap"]} for o in outs]),
            "read_paths": [entry["wal"].path], "outs": outs, "entry": entry,
        }

    def _commit_flush_job(self, job) -> None:
        entry = job["entry"]
        new_ids = self._commit_outputs(job["outs"], job["results"], 0)
        self.levels[0].extend(new_ids)  # newest last
        self.manifest.append({"kind": "droplog", "gen": entry["gen"]})
        self.manifest.commit()
        self.fs.delete(entry["wal"].path)

    def _materialize_l0(self, entry) -> None:
        """Flush one immutable memtable to a physical L0 SSTable."""
        if self.cfg.log_recycling:
            job = self._prep_flush_job(entry)
            job["results"], _ = self._submit(
                job["task"], *job["args"],
                read_paths=job["read_paths"], write_outputs=job["outs"],
            )
            self._commit_flush_job(job)
            return
        # vanilla path: the initiator serializes and writes the table
        # itself (each KV pair crosses the fabric a second time)
        mem: MemTable = entry["mem"]
        total = mem.bytes + 24 * len(mem) + 4096
        outs = self._alloc_outputs(
            total, shard=self._placement_shard([entry["wal"].path])
        )
        data = build_bytes([(k, v) for k, v, _ in mem.items()])
        self.stats["flush_rpc_payload"] += len(data)
        o = outs[0]
        self.fs.write(o["path"], data, 0)
        results = [{"idx": 0, "used": len(data), "n": len(mem),
                    "min": next(mem.items())[0], "max": mem.key_range()[1]}]
        new_ids = self._commit_outputs(outs, results, 0)
        self.levels[0].extend(new_ids)  # newest last
        self._pollute_after_local(self.fs.node, new_ids)
        self.manifest.append({"kind": "droplog", "gen": entry["gen"]})
        self.manifest.commit()
        self.fs.delete(entry["wal"].path)

    def _materialize_l0_batch(self, entries) -> None:
        """Flush a backlog of immutable memtables in ONE load-balanced round:
        each memtable's log_recycle task goes to a shard picked by the
        offloader (one wire batch per shard, shards served concurrently).
        Entries leave ``self.imm`` only as their commit lands, so a failed
        round leaves the un-flushed tail readable and recoverable."""
        if not self.cfg.log_recycling or not self._offload_ok("log_recycle", 0) \
                or len(entries) < 2:
            for e in entries:
                self._materialize_l0(e)
                if e in self.imm:
                    self.imm.remove(e)
            return
        jobs = [self._prep_flush_job(e) for e in entries]  # oldest first
        try:
            self._run_jobs(jobs)
            for job in jobs:  # commit in age order: L0 stays newest-last
                self._commit_flush_job(job)
                job["done"] = True
                if job["entry"] in self.imm:
                    self.imm.remove(job["entry"])
        except BaseException:
            self._abort_jobs(jobs)
            raise

    def _abort_jobs(self, jobs) -> None:
        """Reclaim the preallocated outputs of uncommitted jobs after a
        failed round. Sources are untouched (victims only drop at commit),
        so state stays consistent; completed remote work is discarded."""
        for j in jobs:
            if j.get("done"):
                continue
            for o in j["outs"]:
                if self.fs.exists(o["path"]):
                    self.fs.delete(o["path"])

    # --------------------------------------------------------- compaction
    def level_bytes(self, lvl: int) -> int:
        return sum(self.tables[t].size for t in self.levels[lvl])

    def _level_limit(self, lvl: int) -> int:
        return self.cfg.base_level_bytes * (self.cfg.level_ratio ** (lvl - 1))

    def _run_jobs(self, jobs) -> None:
        """Execute prepared jobs, filling job["results"]/job["where"].
        When ≥2 jobs are offloadable they go out via submit_many — one wire
        batch per shard, shards served concurrently; otherwise serial."""
        parallel = (self.off is not None and len(jobs) > 1
                    and all(self._offload_ok(j["task"], j["level"]) for j in jobs))
        if parallel:
            specs = []
            for j in jobs:
                re_, we_, mtime = self._lease_args(j["read_paths"], j["outs"])
                specs.append({
                    "task": j["task"], "args": j["args"],
                    "read_extents": re_, "write_extents": we_,
                    "target": self.cfg.peer_target, "mtime": mtime,
                })
            for j, (results, where) in zip(jobs, self.off.submit(specs)):
                j["results"], j["where"] = results, where
            return
        for j in jobs:
            j["results"], j["where"] = self._submit(
                j["task"], *j["args"], read_paths=j["read_paths"],
                write_outputs=j["outs"], level=j["level"],
            )

    def maybe_compact(self) -> None:
        """Each round gathers every compaction whose level pair is disjoint
        from the others' (L0+L1, then deeper levels) and runs the round's
        jobs concurrently across shards; commits apply serially on the
        initiator (single metadata owner)."""
        guard = 0
        while guard < 8:
            guard += 1
            jobs, touched = [], set()
            if len(self.imm) + len(self.levels[0]) >= self.cfg.l0_trigger:
                j = self._prep_l0_job()
                if j is not None:
                    jobs.append(j)
                    touched |= {0, 1}
            for lvl in range(1, self.cfg.max_level):
                if lvl in touched or (lvl + 1) in touched:
                    continue
                if self.levels[lvl] and self.level_bytes(lvl) > self._level_limit(lvl):
                    jobs.append(self._prep_level_job(lvl))
                    touched |= {lvl, lvl + 1}
            if not jobs:
                break
            try:
                self._run_jobs(jobs)
                for job in jobs:
                    if job["kind"] == "l0":
                        self._commit_l0_job(job)
                    else:
                        self._commit_level_job(job)
                    job["done"] = True
            except BaseException:
                self._abort_jobs(jobs)
                raise
            # between compaction rounds: realign placement with load —
            # drain cold SSTables off stripes whose FIFO pressure skews
            if self.rebalancer is not None:
                self.drain_cold_tables()

    # --------------------------------------------------------- rebalancing
    def attach_rebalancer(self, rebalancer) -> None:
        """Wire a ``StripeRebalancer``; ``maybe_compact`` then drains cold
        SSTables off hot stripes between compaction rounds."""
        self.rebalancer = rebalancer

    def drain_cold_tables(self, *, max_tables: int = 2) -> list:
        """Migrate COLD SSTables — levels ≥ 1; L0, the pinned immutable
        memtables and the active WAL are write-hot and stay put — off
        stripes whose pressure exceeds the rebalancer's skew threshold.
        Table ids, the MANIFEST and readers are untouched: migration moves
        blocks, not paths. Returns the migrations performed."""
        if self.rebalancer is None or self.fs.shards <= 1:
            return []
        cold = [
            self.tables[t].path
            for lvl in range(1, self.cfg.max_level + 1)
            for t in self.levels[lvl]
        ]
        if not cold:
            return []
        return self.rebalancer.rebalance(max_files=max_tables, paths=cold)

    # -- L0 (+ deferred WAL runs) + overlapping L1 → new L1 tables
    def _prep_l0_job(self) -> Optional[dict]:
        imm = list(self.imm)  # newest last; send newest first
        l0_ids = list(self.levels[0])
        lo, hi = None, None
        for e in imm:
            mn, mx = e["mem"].key_range()
            lo = mn if lo is None or mn < lo else lo
            hi = mx if hi is None or mx > hi else hi
        for t in l0_ids:
            m = self.tables[t]
            lo = m.min_key if lo is None or m.min_key < lo else lo
            hi = m.max_key if hi is None or m.max_key > hi else hi
        if lo is None:
            return None
        l1_ids = [t for t in self.levels[1]
                  if not (self.tables[t].max_key < lo or self.tables[t].min_key > hi)]
        recycle = []
        read_paths = []
        for e in reversed(imm):  # newest first
            runs, size = self._file_runs(e["wal"].path)
            recycle.append({"runs": runs, "size": size,
                            "offsets": e["mem"].sorted_offsets()})
            read_paths.append(e["wal"].path)
        inputs = []
        for t in reversed(l0_ids):  # newer L0 first
            runs, size = self._file_runs(self.tables[t].path)
            inputs.append({"runs": runs, "size": size})
            read_paths.append(self.tables[t].path)
        for t in l1_ids:  # level-1 oldest
            runs, size = self._file_runs(self.tables[t].path)
            inputs.append({"runs": runs, "size": size})
            read_paths.append(self.tables[t].path)
        total = sum(i["size"] for i in inputs) + sum(r["size"] for r in recycle) + 4096
        outs = self._alloc_outputs(total, shard=self._placement_shard(read_paths))
        drop = (self.cfg.max_level == 1)
        return {
            "kind": "l0", "task": "compact", "level": 0,
            "args": (inputs, recycle,
                     [{"runs": o["runs"], "cap": o["cap"]} for o in outs], drop),
            "read_paths": read_paths, "outs": outs,
            "imm": imm, "l0_ids": l0_ids, "l1_ids": l1_ids,
        }

    def _commit_l0_job(self, job) -> None:
        imm, l0_ids, l1_ids = job["imm"], job["l0_ids"], job["l1_ids"]
        new_ids = self._commit_outputs(job["outs"], job["results"], 1)
        self._pollute_after_local(job["where"], new_ids)
        # drop victims: manifest first (commit mark), then reclaim
        for e in imm:
            self.manifest.append({"kind": "droplog", "gen": e["gen"]})
        for t in l0_ids + l1_ids:
            self.manifest.append({"kind": "drop", "table_id": t})
        self.levels[1] = sorted(
            [t for t in self.levels[1] if t not in l1_ids] + new_ids,
            key=lambda t: self.tables[t].min_key,
        )
        self.levels[0] = []
        self.manifest.commit()
        for e in imm:
            self.fs.delete(e["wal"].path)
        for t in l0_ids + l1_ids:
            self.cache.drop(t)
            self.fs.delete(self.tables.pop(t).path)
        self.imm = []
        self.stats["compactions"] += 1

    def compact_l0(self) -> None:
        """L0 (+ deferred WAL runs) + overlapping L1 → new L1 tables."""
        job = self._prep_l0_job()
        if job is None:
            return
        self._run_jobs([job])
        self._commit_l0_job(job)

    # -- one table from lvl + overlapping lvl+1 → lvl+1
    def _prep_level_job(self, lvl: int) -> dict:
        ids = self.levels[lvl]
        ptr = self._compact_ptr.get(lvl, 0) % len(ids)
        vid = ids[ptr]
        self._compact_ptr[lvl] = ptr + 1
        vm = self.tables[vid]
        nxt = [t for t in self.levels[lvl + 1]
               if not (self.tables[t].max_key < vm.min_key
                       or self.tables[t].min_key > vm.max_key)]
        inputs, read_paths = [], []
        for t in [vid] + nxt:
            runs, size = self._file_runs(self.tables[t].path)
            inputs.append({"runs": runs, "size": size})
            read_paths.append(self.tables[t].path)
        total = sum(i["size"] for i in inputs) + 4096
        outs = self._alloc_outputs(total, shard=self._placement_shard(read_paths))
        drop = lvl + 1 >= self.cfg.max_level
        return {
            "kind": "level", "task": "compact", "level": lvl,
            "args": (inputs, [],
                     [{"runs": o["runs"], "cap": o["cap"]} for o in outs], drop),
            "read_paths": read_paths, "outs": outs, "vid": vid, "nxt": nxt,
        }

    def _commit_level_job(self, job) -> None:
        lvl, vid, nxt = job["level"], job["vid"], job["nxt"]
        new_ids = self._commit_outputs(job["outs"], job["results"], lvl + 1)
        self._pollute_after_local(job["where"], new_ids)
        for t in [vid] + nxt:
            self.manifest.append({"kind": "drop", "table_id": t})
        self.levels[lvl] = [t for t in self.levels[lvl] if t != vid]
        self.levels[lvl + 1] = sorted(
            [t for t in self.levels[lvl + 1] if t not in nxt] + new_ids,
            key=lambda t: self.tables[t].min_key,
        )
        self.manifest.commit()
        for t in [vid] + nxt:
            self.cache.drop(t)
            self.fs.delete(self.tables.pop(t).path)
        self.stats["compactions"] += 1

    def compact_level(self, lvl: int) -> None:
        """One table from lvl + overlapping lvl+1 → lvl+1."""
        if not self.levels[lvl]:
            return
        job = self._prep_level_job(lvl)
        self._run_jobs([job])
        self._commit_level_job(job)

    # ------------------------------------------------------------ recovery
    def flush_all(self) -> None:
        if len(self.mem):
            self.seal_memtable()
        if self.imm:
            self._materialize_l0_batch(list(self.imm))
        self.manifest.commit()

    @classmethod
    def recover(cls, fs: OffloadFS, offloader=None,
                cfg: Optional[DBConfig] = None, device="cuda"):
        """Rebuild from MANIFEST + WAL replay after a crash/restart.

        Recovery consults the lease journal first: write leases orphaned by
        the crash (in-flight WAL segments, submit_many flush/compaction
        grants) are fenced and reclaimed WITHOUT scanning, so the replay
        below can read those blocks. WAL replay then trusts only the intact
        device prefix — with async shipping the durability watermark at
        crash time, not the logical tail."""
        cfg = cfg if cfg is not None else DBConfig()
        db = cls.__new__(cls)
        db.fs = fs
        db.off = offloader
        db.cfg = cfg
        db.device = device
        db.orphans_reclaimed = fs.reclaim_orphans()
        db.manifest = Manifest(fs, cfg.namespace + "/MANIFEST",
                               shard=cfg.placement_shard)
        db.tables = {}
        db.levels = {i: [] for i in range(cfg.max_level + 1)}
        db.imm = []
        db.cache = TableCache(cfg.table_cache_bytes)
        db._compact_ptr = {}
        db.stats = {"stall_events": 0, "flushes": 0, "compactions": 0,
                    "wal_bytes": 0, "flush_rpc_payload": 0,
                    "pushdown_scans": 0}
        db.read_stats = {"mem": 0, "imm": 0, "l0": 0, "ln": 0, "absent": 0}
        db.rebalancer = None
        live_logs: Dict[int, str] = {}
        active_gen, active_path = 0, None
        max_tid = 0
        for rec in db.manifest.replay():
            k = rec["kind"]
            if k == "add":
                m = TableMeta(rec["table_id"], rec["path"], rec["level"],
                              rec["n"], rec["size"],
                              bytes.fromhex(rec["min"]), bytes.fromhex(rec["max"]))
                db.tables[m.table_id] = m
                db.levels[m.level].append(m.table_id)
                max_tid = max(max_tid, m.table_id)
            elif k == "drop":
                t = rec["table_id"]
                if t in db.tables:
                    db.levels[db.tables[t].level].remove(t)
                    del db.tables[t]
            elif k == "l0log":
                live_logs[rec["gen"]] = rec["path"]
            elif k == "droplog":
                live_logs.pop(rec["gen"], None)
            elif k == "wal":
                active_gen, active_path = rec["gen"], rec["path"]
        for lvl in range(1, cfg.max_level + 1):
            db.levels[lvl].sort(key=lambda t: db.tables[t].min_key)
        db._tid = itertools.count(max_tid + 1)
        db._gen = itertools.count(active_gen + 1)
        # orphan reclamation: tmp files never committed (namespace-scoped:
        # co-tenant instances' in-flight outputs are not ours to reclaim)
        for path in fs.listdir(f"{cfg.namespace}/sst/tmp-"):
            fs.delete(path)
        db.wal_shipper = db._make_shipper()
        # rebuild deferred L0s from their WALs (oldest first); reopen()
        # keeps only the intact record prefix (torn tails dropped)
        for gen in sorted(live_logs):
            path = live_logs[gen]
            if not fs.exists(path):
                continue
            wal, records = WriteAheadLog.reopen(fs, path)
            mem = MemTable(seed=gen)
            for key, val, off in records:
                mem.put(key, val, off)
            db.imm.append({"gen": gen, "mem": mem, "wal": wal, "count": len(mem)})
        # active WAL → live memtable: replay stops at the crash-time
        # durability watermark (async shipping allocates blocks ahead of the
        # completed segment prefix; the torn tail past it is dropped)
        if active_path and fs.exists(active_path):
            db.wal, records = WriteAheadLog.reopen(
                fs, active_path, sync=cfg.sync_wal, shipper=db.wal_shipper,
                segment_bytes=cfg.wal_segment_bytes,
                max_inflight=cfg.wal_max_inflight,
            )
            db.wal_gen = active_gen
            db.mem = MemTable(seed=active_gen)
            for key, val, off in records:
                db.mem.put(key, val, off)
        else:
            db._new_wal()
        if db.off is not None:
            db.off.register_local_stub("compact", C.stub_compact)
            db.off.register_local_stub("log_recycle", C.stub_log_recycle)
            db.off.register_local_stub("pushdown_scan", P.stub_pushdown_scan)
        return db

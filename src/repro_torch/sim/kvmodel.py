# Copied from src/repro/sim/kvmodel.py; repro. imports rewritten, changelog notes cut from comments.
"""DES workload model for the OffloadDB experiments (Figs. 7a, 8, 10, 11,
and the Fig. 8 ``n_storage`` shard-count sweeps).

Mechanics (why the paper's effects emerge here):
  * Every client op pays initiator CPU + WAL bytes over the fabric; cluster
    file systems additionally serialize each op through a single-server
    journal/metadata path (the Fig. 2 overhead) — OCFS2 ~6 µs/op,
    GFS2 ~12 µs/op (lower baseline, finer locks).
  * MemTable fills spawn flush jobs; every `l0_trigger` flushes spawn an
    L0→L1 compaction; level-l jobs cascade with 1/`job_ratio` frequency and
    ~2.5× size growth — sustained merge demand ≈ 6× ingest bytes.
  * Local (no offload): merges burn initiator cores AND move 2× job bytes
    over the initiator's fabric link → write stalls once the backlog passes
    `stall_backlog` (RocksDB slowdown/stop).
  * Offload to storage: merges run near-data (no fabric bytes), on slower
    cores, accelerated by the Offload Cache; Log Recycling removes the
    flush's second data crossing (offsets only).
  * Offload to peer: full-speed cores, but job bytes cross two links.
  * OCFS2 with TWO writers (initiator + offload target) serializes every
    job and a share of foreground ops on the directory lock → offloading
    makes it WORSE (the paper's key negative result); GFS2's block-grain
    locks cost messages but parallelize → it scales from a lower base.
  * ``n_storage > 1`` models the striped offload plane: initiator i's WAL,
    flush and compaction I/O lands on storage target ``i % n_storage``
    (placement affinity), each target with its own CPU pool, links and
    NVMe FIFOs — the Fig. 8 shard-count sweep shows the single-target
    saturation knee moving out as targets are added.
  * ``shard_skew`` / ``rebalance_at`` model the dynamic stripe rebalancer:
    zipf-skewed placement concentrates the fleet's I/O on one
    storage target; at the trigger point each mis-placed instance pays
    background migration I/O (``Cluster.rebalance``) and flips to uniform
    placement — Fig. 17 measures the throughput recovery.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.admission import AcceptAll, AdmissionPolicy
from repro_torch.core.memtier import MemTierNode
from repro_torch.sim.cluster import Cluster, TestbedSpec, TESTBED
from repro_torch.sim.des import Sim

MB = 1e6

JOURNAL_PER_OP = {"ext4": 0.0, "offloadfs": 0.0, "ocfs2": 2e-6, "gfs2": 3e-6}
# cluster FSs journal DATA writes too (serialized per node): s per MB written
JOURNAL_PER_MB = {"ext4": 0.0, "offloadfs": 0.0, "ocfs2": 2.2e-3, "gfs2": 3.2e-3}


@dataclass
class KVParams:
    system: str = "offloadfs"  # ext4 | ocfs2 | gfs2 | offloadfs
    n_ops: int = 300_000
    write_ratio: float = 1.0
    value_bytes: int = 1024
    key_bytes: int = 24
    client_threads: int = 32  # modeled as client_procs coarse streams
    client_procs: int = 8
    memtable_bytes: float = 4 * MB
    l0_trigger: int = 4
    levels: int = 4
    job_ratio: int = 4  # level-l jobs per level-(l+1) job
    size_growth: float = 3.0  # job size growth per level
    merge_rate: float = 200e6  # bytes/s/core merge (I/O-inclusive)
    subcompactions: int = 4  # intra-job parallelism (RocksDB subcompactions)
    offload_levels: int = 0  # 0=Local; k → offload jobs with level < k
    offload_flush: bool = False
    log_recycling: bool = False
    offload_cache: bool = False
    l0_cache: bool = False
    sync_wal: bool = False
    # async WAL shipping: foreground puts only touch the in-memory tail;
    # sealed segments ship to the storage node as background processes
    async_wal: bool = False
    wal_segment_bytes: float = 64 * 1024
    peer: bool = False
    read_hit_ratio: float = 0.6
    read_amp: float = 2.0
    stall_backlog: int = 5
    batch: int = 128
    io_bw_fabric: float = 1.2e9  # per-job compaction I/O via PoseidonOS volume
    io_bw_near: float = 6.0e9    # near-data (SPDK direct on the array)
    io_bw_peer: float = 2.0e9    # peer's dedicated link, full duplex
    miss_latency: float = 110e-6  # per point-lookup storage round trip
    # striped offload plane: N storage targets, initiator i's placement-
    # affine I/O lands on target i % n_storage (disjoint FIFOs per shard)
    n_storage: int = 1
    # skewed placement: with shard_skew = s > 0 the initiators'
    # placement targets are assigned by zipf weights (k+1)^-s instead of
    # uniformly — a hot stripe serves most of the fleet's I/O while its
    # neighbours idle (the imbalance the rebalancer exists to fix)
    shard_skew: float = 0.0
    # dynamic rebalancing: after `rebalance_at` fraction of an instance's
    # ops its placement migrates to the uniform target (the rebalancer's
    # copy-swap-free cycle, paying `rebalance_bytes` of background
    # migration I/O via Cluster.rebalance); 0.0 = static placement
    rebalance_at: float = 0.0
    rebalance_bytes: float = 32 * MB
    # migration-rate limiter (bytes/s; None = unthrottled burst): paces the
    # background copy through Cluster.rebalance so it can't starve the
    # foreground FIFOs it shares
    rebalance_rate: Optional[float] = None


@dataclass
class KVResult:
    throughput: float
    latencies: List[float]
    storage_cpu_util: float
    initiator_cpu_util: float
    net_bytes: float
    stall_time: float
    makespan: float

    @property
    def p50(self):
        s = sorted(self.latencies)
        return s[len(s) // 2] if s else 0.0

    @property
    def p99(self):
        s = sorted(self.latencies)
        return s[min(len(s) - 1, int(len(s) * 0.99))] if s else 0.0


def make_policy(spec_str, sim: Sim, cpu_probe) -> AdmissionPolicy:
    from repro_torch.core.admission import CPUThreshold, RejectAll, TokenRing

    if spec_str in (None, "accept"):
        return AcceptAll()
    if spec_str == "reject":
        return RejectAll()
    if spec_str.startswith("cpu:"):
        return CPUThreshold(cpu_probe, float(spec_str.split(":")[1]))
    if spec_str.startswith("token:"):
        _, n, ttl = spec_str.split(":")
        return TokenRing(int(n), float(ttl), clock=lambda: sim.now)
    raise ValueError(spec_str)


def run_kv(params: KVParams, *, instances: int = 1,
           policy: Optional[object] = None,
           spec: TestbedSpec = TESTBED) -> KVResult:
    sim = Sim()
    # one extra node when offloading to a peer
    n_nodes = instances + (1 if params.peer else 0)
    n_storage = max(1, params.n_storage)
    cl = Cluster(sim, spec, n_initiators=n_nodes, n_storage=n_storage)
    peer_id = n_nodes - 1

    def zipf_target(i: int) -> int:
        """Deterministic zipf-weighted placement: instance i lands on the
        shard whose cumulative weight bucket covers its index (heavy
        stripes early — shard 0 takes the biggest share)."""
        w = [(k + 1) ** -params.shard_skew for k in range(n_storage)]
        tot = sum(w)
        x = (i + 0.5) / max(1, instances)
        acc = 0.0
        for k in range(n_storage):
            acc += w[k] / tot
            if x <= acc:
                return k
        return n_storage - 1

    placement = [
        zipf_target(i) if params.shard_skew > 0 else i % n_storage
        for i in range(instances)
    ]

    def tg(i: int) -> int:
        """Placement affinity: initiator i's storage target (shard) —
        dynamic when the rebalancer migrates the instance's files."""
        return placement[i]

    dirlock = sim.resource("dirlock", 1.0 / spec.dlm_rtt)
    journals = [sim.resource(f"journal{i}", 1.0) for i in range(instances)]
    journal_s = sim.resource("journal_storage", 1.0)  # target-node journal
    state = {
        "backlog": [list() for _ in range(instances)],
        "stall": [0.0] * instances,
        "net_bytes": 0.0,
        "inflight_storage_cores": [0] * n_storage,
        "latencies": [],
        "wal_fill": [0.0] * instances,
    }
    # a CPU-threshold policy must see the BUSIEST target: with uneven
    # initiator→shard placement one saturated target would otherwise hide
    # behind the fleet average and never push back
    cpu_probe = lambda: max(state["inflight_storage_cores"]) / spec.storage_cores
    if policy is None or isinstance(policy, str):
        policy = make_policy(policy, sim, cpu_probe)

    sysname = params.system
    j_per_op = JOURNAL_PER_OP[sysname]
    two_writers = params.offload_levels > 0 or params.offload_flush or instances > 1
    rec = params.key_bytes + params.value_bytes

    j_per_mb = JOURNAL_PER_MB[sysname]

    def job_locks(i, nbytes, *, remote: bool, via_peer: bool = False):
        """Cluster-FS cost of a background job's file mutations: directory
        lock (OCFS2: cross-node serialization) / block locks (GFS2) plus
        the writing NODE's data journal. Peer offload drags lock/coherence
        traffic across the (data-congested) fabric → higher DLM latency
        (paper: OCFS2/GFS2 prefer the storage node)."""
        if sysname == "ocfs2":
            if remote and two_writers:
                # a REMOTE writer holds the directory lock for its whole
                # write phase — serializing every other dir mutation (the
                # paper's "directory locks serialize offloaded tasks")
                hold_s = nbytes / (280e6 if via_peer else 500e6)
                yield ("use", dirlock, hold_s / spec.dlm_rtt)
            else:
                yield ("use", dirlock, 6.0 if two_writers else 1.0)
        elif sysname == "gfs2":
            per_mb = 1.3 if via_peer else 0.5
            yield from cl.dlm_msgs(2.0 + nbytes / MB * per_mb)
        if j_per_mb:
            res = journal_s if remote else journals[i]
            yield ("use", res, nbytes / MB * j_per_mb)

    def _one_use(res, secs):
        yield ("use", res, secs)

    def merge_work(res, nbytes, *, cached=False, io_bw=None):
        """Merge on `res`, split over subcompactions (correct TOTAL work,
        1/P latency — RocksDB subcompaction parallelism), plus the job's
        read+write I/O time on its access path (fabric vs near-data)."""
        secs = nbytes / params.merge_rate * (0.75 if cached else 1.0)
        P = max(1, params.subcompactions)
        hs = []
        for _ in range(P):
            h = yield ("spawn", _one_use(res, secs / P))
            hs.append(h)
        for h in hs:
            yield ("join", h)
        if io_bw:
            # read+write I/O, half-overlapped with the merge compute
            yield ("delay", nbytes / io_bw)

    def flush_job(i, after=None):
        if after is not None:
            yield ("join", after)
        mt = params.memtable_bytes
        t = tg(i)
        offloaded = params.offload_flush and sysname != "ext4" \
            and policy.admit(f"init{i}")
        if offloaded:
            yield from cl.rpc(i, 4096, target=t)
            state["inflight_storage_cores"][t] += 2
            if params.log_recycling:
                off_bytes = mt / rec * 8
                yield from cl.net_transfer(i, off_bytes, target=t)  # offsets only
                yield ("use", cl.nvme_r_t[t], mt)  # WAL read, near-data
            else:
                yield from cl.net_transfer(i, mt, target=t)
                state["net_bytes"] += mt
            yield from job_locks(i, mt, remote=True)
            yield from merge_work(cl.cpu_s_t[t], mt, io_bw=params.io_bw_near)
            yield ("use", cl.nvme_w_t[t], mt)
            state["inflight_storage_cores"][t] -= 2
            policy.complete(f"init{i}")
        else:
            yield from merge_work(cl.cpu_i[i], mt, io_bw=params.io_bw_fabric)
            yield from job_locks(i, mt, remote=False)
            yield from cl.storage_write(i, mt, target=t)
            state["net_bytes"] += mt

    def compact_job(i, level, after=None):
        if after is not None:
            yield ("join", after)  # same-level jobs serialize (RocksDB)
        size = params.memtable_bytes * params.l0_trigger * 1.5 \
            * (params.size_growth ** level)
        t = tg(i)
        offloaded = level < params.offload_levels and sysname != "ext4" \
            and policy.admit(f"init{i}")
        if offloaded and not params.peer:
            yield from cl.rpc(i, 4096, target=t)
            state["inflight_storage_cores"][t] += params.subcompactions
            yield ("use", cl.nvme_r_t[t], size)  # near-data
            yield from job_locks(i, size, remote=True)
            yield from merge_work(cl.cpu_s_t[t], size, cached=params.offload_cache, io_bw=params.io_bw_near)
            yield ("use", cl.nvme_w_t[t], size)
            state["inflight_storage_cores"][t] -= params.subcompactions
            policy.complete(f"init{i}")
        elif offloaded and params.peer:
            yield from cl.rpc(i, 4096, target=t)
            yield ("use", cl.nvme_r_t[t], size)
            yield ("use", cl.net_i[peer_id], size)  # storage→peer
            yield from job_locks(i, size, remote=True, via_peer=True)
            yield from merge_work(cl.cpu_i[peer_id], size, cached=params.offload_cache, io_bw=params.io_bw_peer)
            yield ("use", cl.net_i[peer_id], size)  # peer→storage
            yield ("use", cl.nvme_w_t[t], size)
            state["net_bytes"] += 2 * size
            policy.complete(f"init{i}")
        else:
            yield from cl.storage_read(i, size, target=t)
            yield from job_locks(i, size, remote=False)
            yield from merge_work(cl.cpu_i[i], size, io_bw=params.io_bw_fabric)
            yield from cl.storage_write(i, size, target=t)
            state["net_bytes"] += 2 * size

    fill = [0.0] * instances
    ops_done = [0] * instances
    rebalanced = [False] * instances
    flush_count = [0] * instances
    level_counters = [[0] * (params.levels + 1) for _ in range(instances)]
    last_job = [[None] * (params.levels + 1) for _ in range(instances)]

    def client(i, sid, n_ops):
        ops_left = n_ops
        while ops_left > 0:
            n = min(params.batch, ops_left)
            ops_left -= n
            t0 = sim.now
            ops_done[i] += n
            if (params.rebalance_at > 0 and not rebalanced[i]
                    and ops_done[i] >= params.rebalance_at * params.n_ops):
                # the rebalancer migrates this instance's files to the
                # uniform stripe: background copy I/O, then placement flips
                rebalanced[i] = True
                uniform = i % n_storage
                if placement[i] != uniform:
                    sim.spawn(cl.rebalance(i, params.rebalance_bytes,
                                           src=placement[i], dst=uniform,
                                           rate=params.rebalance_rate))
                    state["net_bytes"] += 2 * params.rebalance_bytes
                    placement[i] = uniform
            nw = round(n * params.write_ratio)
            nr = n - nw
            yield from cl.cpu_work(i, n * spec.kv_cpu_per_op)
            if j_per_op:
                yield ("use", journals[i], n * j_per_op)
            if sysname == "ocfs2" and two_writers:
                yield ("use", dirlock, n * 0.01)  # fg share of dir-lock churn
            if nw:
                if j_per_mb:
                    yield ("use", journals[i], nw * rec / MB * j_per_mb)
                if params.async_wal:
                    # appends are memory-only; sealed segments ship in the
                    # background (completion-ordered watermark off the
                    # foreground path)
                    state["wal_fill"][i] += nw * rec
                    while state["wal_fill"][i] >= params.wal_segment_bytes:
                        state["wal_fill"][i] -= params.wal_segment_bytes
                        sim.spawn(cl.wal_ship(i, params.wal_segment_bytes,
                                              target=tg(i)))
                        state["net_bytes"] += params.wal_segment_bytes
                else:
                    if params.sync_wal:
                        yield ("delay", nw * spec.rpc_rtt)
                    yield from cl.storage_write(i, nw * rec, target=tg(i))
                    state["net_bytes"] += nw * rec
                fill[i] += nw * rec * 1.05
            if nr:
                misses = int(nr * (1 - params.read_hit_ratio))
                if misses:
                    rb = misses * params.value_bytes * params.read_amp
                    yield ("delay", misses * params.miss_latency / 8)
                    yield from cl.storage_read(i, rb, target=tg(i))
                    state["net_bytes"] += rb
            # flush / compaction triggers (instance-shared accounting; DES
            # events don't interleave within a step → no races)
            counters = level_counters[i]
            while fill[i] >= params.memtable_bytes:
                fill[i] -= params.memtable_bytes
                hf = sim.spawn(flush_job(i, after=last_job[i][0]))
                last_job[i][0] = hf
                state["backlog"][i].append(hf)
                flush_count[i] += 1
                if flush_count[i] % params.l0_trigger == 0:
                    counters[0] += 1
                    h0 = sim.spawn(compact_job(i, 0, after=last_job[i][0]))
                    last_job[i][0] = h0
                    state["backlog"][i].append(h0)
                    for lvl in range(1, params.levels):
                        if counters[lvl - 1] >= params.job_ratio:
                            counters[lvl - 1] = 0
                            counters[lvl] += 1
                            hl = sim.spawn(
                                compact_job(i, lvl, after=last_job[i][lvl])
                            )
                            last_job[i][lvl] = hl
                            state["backlog"][i].append(hl)
            state["backlog"][i] = [h for h in state["backlog"][i] if not h.done]
            if len(state["backlog"][i]) > params.stall_backlog:
                ts = sim.now
                yield ("join", state["backlog"][i][0])
                state["stall"][i] += sim.now - ts
            state["latencies"].append((sim.now - t0) / n)

    procs = params.client_procs
    for i in range(instances):
        policy.register(f"init{i}")
        per = params.n_ops // procs
        # stream 0 carries the whole write volume for trigger bookkeeping
        for sid in range(procs):
            sim.spawn(client(i, sid, per))
    makespan = sim.run()
    total = params.n_ops // procs * procs * instances
    return KVResult(
        throughput=total / makespan if makespan else 0.0,
        latencies=state["latencies"],
        storage_cpu_util=sum(
            r.utilization(makespan) for r in cl.cpu_s_t
        ) / n_storage,
        initiator_cpu_util=cl.cpu_i[0].utilization(makespan),
        net_bytes=state["net_bytes"],
        stall_time=sum(state["stall"]),
        makespan=makespan,
    )


# ===================================================================
# KV-cache serving model (Fig. 20): disaggregated prefill → decode.
#
# Requests arrive in zipf-popular prompt-prefix families. With the
# offload plane, a request whose family's cache is already stored on
# the stripe its placement policy picks ATTACHES (read lease + stream
# the cache back) instead of recomputing prefill; a miss pays prefill
# on the initiator and stores the cache near-data for the rest of the
# family. TTFT = time to the first decoded token. The recompute
# baseline pays prefill on every request. ``n_storage`` moves the
# fetch-bandwidth knee exactly like the Fig. 8 shard sweep; placement
# controls whether a family ever re-finds its replica.
# ===================================================================


@dataclass
class ServeParams:
    n_requests: int = 400
    n_clients: int = 8  # concurrent decode initiators
    n_families: int = 24  # distinct prompt-prefix families
    zipf_s: float = 1.1  # family popularity skew
    prompt_tokens: int = 1024
    prefill_cpu_per_tok: float = 160e-6  # initiator-seconds per prompt token
    decode_cpu_per_tok: float = 1.2e-6
    kv_bytes: float = 64 * MB  # packed cache per request
    offload: bool = True  # False = recompute baseline
    placement: str = "prefix"  # prefix | round_robin | random
    n_storage: int = 4


@dataclass
class ServeResult:
    ttft: List[float]
    hit_rate: float
    net_bytes: float
    makespan: float

    @property
    def mean_ttft(self):
        return sum(self.ttft) / len(self.ttft) if self.ttft else 0.0

    @property
    def p95_ttft(self):
        s = sorted(self.ttft)
        return s[min(len(s) - 1, int(len(s) * 0.95))] if s else 0.0


def run_serve(params: ServeParams, *, spec: TestbedSpec = TESTBED) -> ServeResult:
    sim = Sim()
    n_storage = max(1, params.n_storage)
    cl = Cluster(sim, spec, n_initiators=params.n_clients,
                 n_storage=n_storage)

    # deterministic zipf family stream (xorshift over the CDF — same
    # sequence for every policy so the comparison is paired)
    w = [(k + 1) ** -params.zipf_s for k in range(params.n_families)]
    tot = sum(w)
    cdf, acc = [], 0.0
    for x in w:
        acc += x / tot
        cdf.append(acc)
    rng = [12345]

    def next_family() -> int:
        x = rng[0]
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        rng[0] = x
        u = x / 0xFFFFFFFF
        for fam, c in enumerate(cdf):
            if u <= c:
                return fam
        return params.n_families - 1

    replicas = [set() for _ in range(params.n_families)]
    counters = {"rr": 0, "rnd": 99991, "hits": 0, "net": 0.0}

    def place(fam: int) -> int:
        if params.placement == "round_robin":
            s = counters["rr"] % n_storage
            counters["rr"] += 1
            return s
        if params.placement == "random":
            x = counters["rnd"]
            x ^= (x << 13) & 0xFFFFFFFF
            x ^= x >> 17
            x ^= (x << 5) & 0xFFFFFFFF
            counters["rnd"] = x
            return x % n_storage
        return fam % n_storage  # prefix-aware: family → stable stripe

    ttft: List[float] = []
    per_client = params.n_requests // params.n_clients

    def client(i: int):
        for _ in range(per_client):
            fam = next_family()
            t0 = sim.now
            if params.offload:
                shard = place(fam)
                if shard in replicas[fam]:
                    # attach: read lease RPC + stream the cache back
                    counters["hits"] += 1
                    yield from cl.rpc(i, 4096, target=shard)
                    yield from cl.storage_read(i, params.kv_bytes,
                                               target=shard)
                    counters["net"] += params.kv_bytes
                else:
                    yield from cl.cpu_work(
                        i, params.prompt_tokens * params.prefill_cpu_per_tok)
                    yield from cl.rpc(i, 4096, target=shard)
                    yield from cl.storage_write(i, params.kv_bytes,
                                                target=shard)
                    counters["net"] += params.kv_bytes
                    replicas[fam].add(shard)
            else:
                yield from cl.cpu_work(
                    i, params.prompt_tokens * params.prefill_cpu_per_tok)
            yield from cl.cpu_work(i, params.decode_cpu_per_tok)
            ttft.append(sim.now - t0)

    for i in range(params.n_clients):
        sim.spawn(client(i))
    makespan = sim.run()
    total = per_client * params.n_clients
    return ServeResult(
        ttft=ttft,
        hit_rate=counters["hits"] / total if total else 0.0,
        net_bytes=counters["net"],
        makespan=makespan,
    )

# ===================================================================
# MemTier fleet sweep (Fig. 22): the remote-memory block-cache tier at
# fleet scale — hundreds of storage nodes, thousands of tenants.
#
# The functional layer (repro_torch.core.memtier.MemTierNode) makes the CACHE
# DECISIONS — per-partition LRU, ghost-list admission, invalidation —
# while the DES charges the TIME: a hit pays one RPC + the home node's
# DRAM FIFO + the wire; a miss pays the full NVMe + PoseidonOS + wire
# path and a fill offer back to the tier; a write fences its run (block
# ids only on the wire) before landing on NVMe. Load is zipf-popular
# per-tenant working sets under diurnal modulation (think time swells
# and shrinks with a deterministic function of SIM time — no wall
# clock), plus a configurable share of one-pass background scanners the
# admission filter must keep out of the foreground partitions.
# ===================================================================


@dataclass
class MemTierParams:
    n_tenants: int = 1000
    n_storage: int = 128
    n_clients: int = 8  # initiator nodes the tenants multiplex onto
    ops_per_tenant: int = 30
    blocks_per_run: int = 32  # 128 KiB reads
    runs_per_tenant: int = 32  # hot working set, in runs
    zipf_s: float = 1.2  # run popularity skew within a tenant's set
    write_ratio: float = 0.1  # writes → fence + NVMe, never the tier
    scan_tenants: float = 0.1  # fraction doing one-pass background scans
    tier: bool = True  # False = NVMe-only baseline
    tier_runs_per_node: int = 1024  # home-node partition capacity (runs)
    think_base: float = 10e-3  # mean tenant think time (s)
    diurnal_amp: float = 0.6  # think-time swing (0 = flat load)
    diurnal_period: float = 4.0  # sim-seconds per synthetic "day"
    # per-op device latency (NOT bandwidth — the FIFOs model that): the
    # DRAM-vs-flash latency gap is the second tier's whole argument
    nvme_latency: float = 90e-6
    dram_latency: float = 2e-6


@dataclass
class MemTierResult:
    hit_rate: float
    scan_hit_rate: float  # background partition (should stay near zero)
    latencies: List[float] = field(default_factory=list)
    makespan: float = 0.0
    events: int = 0  # DES events processed (fleet-scale evidence)
    n_storage: int = 0
    n_tenants: int = 0
    net_bytes: float = 0.0
    invalidations: int = 0

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies) if self.latencies else 0.0

    @property
    def p99_latency(self) -> float:
        s = sorted(self.latencies)
        return s[min(len(s) - 1, int(len(s) * 0.99))] if s else 0.0


def run_memtier(params: MemTierParams, *,
                spec: TestbedSpec = TESTBED) -> MemTierResult:
    sim = Sim()
    n_storage = max(1, params.n_storage)
    cl = Cluster(sim, spec, n_initiators=params.n_clients,
                 n_storage=n_storage)
    run_bytes = params.blocks_per_run * 4096.0
    # one functional cache shard per storage node: real LRU + ghost-list
    # admission + partition isolation, driven block-for-block by the model
    nodes: List[MemTierNode] = [
        MemTierNode(capacity_blocks=params.tier_runs_per_node)
        for _ in range(n_storage)
    ]

    # per-tenant zipf CDF over its working-set runs (shared shape)
    w = [(k + 1) ** -params.zipf_s for k in range(params.runs_per_tenant)]
    tot = sum(w)
    cdf, acc = [], 0.0
    for x in w:
        acc += x / tot
        cdf.append(acc)

    def xorshift(x: int) -> int:
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        return x or 1

    counters: Dict[str, float] = {
        "fg_hits": 0, "fg_gets": 0, "bg_hits": 0, "bg_gets": 0,
        "net": 0.0, "inval": 0,
    }
    latencies: List[float] = []
    n_scan = int(params.n_tenants * params.scan_tenants)

    def _near_data_fill(home: int):
        """Admitted fill: the home node copies the run it just served
        from its own NVMe slice into its DRAM partition — SPDK-direct
        background work, never on the foreground path or the wire."""
        yield ("use", cl.nvme_r_t[home], run_bytes)
        yield ("use", cl.dram_t[home], run_bytes)

    def tenant(t: int):
        rng = xorshift(0x9E3779B9 ^ (t + 1))
        scanner = t < n_scan
        io_class = "background" if scanner else "foreground"
        base = t * params.runs_per_tenant
        for op in range(params.ops_per_tenant):
            # diurnal think time: a deterministic function of SIM time and
            # the tenant's timezone phase — load swells and ebbs fleet-wide
            phase = 2.0 * math.pi * (
                sim.now / params.diurnal_period + t / params.n_tenants
            )
            think = params.think_base * (
                1.0 + params.diurnal_amp * math.cos(phase)
            )
            rng = xorshift(rng)
            yield ("delay", think * (0.5 + rng / 0xFFFFFFFF))
            if scanner:
                run = base + op % params.runs_per_tenant  # one-pass sweep
            else:
                rng = xorshift(rng)
                u = rng / 0xFFFFFFFF
                run = base + next(
                    (k for k, c in enumerate(cdf) if u <= c),
                    params.runs_per_tenant - 1,
                )
            home = run % n_storage
            init = t % params.n_clients
            rng = xorshift(rng)
            write = (rng / 0xFFFFFFFF) < params.write_ratio and not scanner
            t0 = sim.now
            if write:
                # lease fence first (ids only), then the NVMe write
                if params.tier:
                    nodes[home].invalidate([run])
                    counters["inval"] += 1
                    yield from cl.cache_invalidate(
                        init, params.blocks_per_run, target=home)
                yield ("delay", params.nvme_latency)
                yield from cl.storage_write(init, run_bytes, target=home)
                counters["net"] += run_bytes
            else:
                key = "bg" if scanner else "fg"
                counters[key + "_gets"] += 1
                hit = params.tier and \
                    nodes[home].get(io_class, run) is not None
                if hit:
                    counters[key + "_hits"] += 1
                    yield ("delay", params.dram_latency)
                    yield from cl.cache_get(init, run_bytes, target=home)
                else:
                    # the request RPC is paid either way; the miss then
                    # waits out the flash access and drains the full
                    # NVMe + PoseidonOS + wire path
                    yield from cl.rpc(init, 4096, target=home)
                    yield ("delay", params.nvme_latency)
                    yield from cl.storage_read(init, run_bytes, target=home)
                    if params.tier and nodes[home].put(io_class, run,
                                                       b"\x01"):
                        # admitted: the home node captures the run it just
                        # served, near-data in the background (no second
                        # wire crossing, no foreground wait)
                        sim.spawn(_near_data_fill(home))
                counters["net"] += run_bytes
            latencies.append(sim.now - t0)

    for t in range(params.n_tenants):
        sim.spawn(tenant(t))
    makespan = sim.run()
    return MemTierResult(
        hit_rate=(counters["fg_hits"] / counters["fg_gets"]
                  if counters["fg_gets"] else 0.0),
        scan_hit_rate=(counters["bg_hits"] / counters["bg_gets"]
                       if counters["bg_gets"] else 0.0),
        latencies=latencies,
        makespan=makespan,
        events=sim.events,
        n_storage=n_storage,
        n_tenants=params.n_tenants,
        net_bytes=counters["net"],
        invalidations=int(counters["inval"]),
    )

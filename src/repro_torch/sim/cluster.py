# Copied from src/repro/sim/cluster.py; repro. imports rewritten, changelog notes cut from comments.
"""Cluster resource model calibrated to the paper's testbed (§VI-A),
generalized to a *sharded* storage plane.

The paper's testbed is 8 compute nodes (2× Xeon Gold 5115, 20 vCPU, 64 GB,
1× FDR HCA each) against ONE storage node (2× Xeon Silver 4215, 128 GB,
2× FDR HCA, 24× PM9A3 NVMe behind PoseidonOS). ``Cluster(n_storage=N)``
replicates the storage node N times — each target gets its own CPU pool,
HCA links, NVMe read/write FIFOs and PoseidonOS reactor pool — which is
what the striped placement path (Fig. 16) and the Fig. 8/9 shard-count
sweeps model. Every primitive takes ``target=k``; the single-node
attributes (``cpu_s``, ``net_s``, ``nvme_r``, ``nvme_w``, ``posvol``)
remain as **target-0 back-compat aliases** so pre-sharding scenarios run
unchanged.

Beyond the paper, the model carries the repo's extensions: ``rpc_batch``
(coalesced wire messages), ``wal_ship`` (async near-data WAL
segment writes) and ``crash_remount`` (metadata-only lease-journal
replay).

Rates are deliberately coarse (the DES reproduces the paper's *relative*
claims; EXPERIMENTS.md records per-figure deltas):
  FDR IB link          ≈ 5.0 GB/s usable per HCA
  PoseidonOS volume    ≈ 10 GB/s read, 6 GB/s write per initiator volume
  initiator CPU        ≈ merge/sort 150 MB/s·core, preprocess 25 img/s·core
  storage CPU          ≈ 0.7× initiator core speed (Silver vs Gold)
  DLM round-trip       ≈ 200 µs (Lockify-style measurement)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.sim.des import Resource, Sim

GB = 1e9


@dataclass
class TestbedSpec:
    n_compute: int = 8
    compute_cores: int = 20
    storage_cores: int = 16
    storage_core_speed: float = 0.6  # Silver cores + PoseidonOS reactors
    link_bw: float = 4.5 * GB  # per HCA, full duplex modeled as 2 resources
    storage_links: int = 2
    nvme_read_bw: float = 20.0 * GB  # 24x PM9A3 raw array
    nvme_write_bw: float = 12.0 * GB
    posvol_bw: float = 8.0 * GB  # PoseidonOS reactor pool: remote volume I/O
    dlm_rtt: float = 200e-6
    rpc_rtt: float = 60e-6  # gRPC over IB round trip
    rpc_dispatch: float = 2e-6  # per-sub-call unmarshal/dispatch on the target
    merge_rate: float = 150e6  # bytes/s/core merge-sort
    preprocess_rate: float = 25.0  # images/s/core
    kv_cpu_per_op: float = 12e-6  # initiator CPU per KV op (s)
    lease_replay_cpu: float = 2e-6  # per journaled lease record on re-mount
    # remote-memory tier (MemTier): per-target DRAM service bandwidth for
    # cache hits/fills — an order of magnitude over the NVMe read path is
    # what makes the second tier worth the fabric crossing
    dram_bw: float = 40.0 * GB
    # trainer step consumption (accelerator, NOT the preprocessing cores):
    # images/s one initiator's training step sinks — the consumer stage the
    # PrepPipeline overlaps prep/transfer against
    train_rate: float = 120.0


TESTBED = TestbedSpec()


class Cluster:
    """Instantiates DES resources for a scenario.

    ``n_storage`` models a *sharded* offload plane: N storage targets, each
    with its own CPU pool, HCA links, and NVMe array slice. The single-node
    attributes (``cpu_s``, ``net_s``, ``nvme_r``, …) stay as aliases for
    target 0 so single-target scenarios are unchanged; sharded scenarios
    pass ``target=k`` to the primitives."""

    def __init__(self, sim: Sim, spec: TestbedSpec = TESTBED, *,
                 n_initiators: int = 1, n_storage: int = 1):
        self.sim = sim
        self.spec = spec
        self.n_initiators = n_initiators
        self.n_storage = n_storage
        self.cpu_i: List[Resource] = [
            sim.resource(f"cpu_init{i}", 1.0, servers=spec.compute_cores)
            for i in range(n_initiators)
        ]
        self.cpu_s_t: List[Resource] = [
            sim.resource(f"cpu_storage{t}", spec.storage_core_speed,
                         servers=spec.storage_cores)
            for t in range(n_storage)
        ]
        # network: per-initiator link (tx+rx combined FIFO) + storage links
        self.net_i: List[Resource] = [
            sim.resource(f"net_init{i}", spec.link_bw) for i in range(n_initiators)
        ]
        self.net_s_t: List[Resource] = [
            sim.resource(f"net_storage{t}", spec.link_bw,
                         servers=spec.storage_links)
            for t in range(n_storage)
        ]
        self.nvme_r_t: List[Resource] = [
            sim.resource(f"nvme_read{t}", spec.nvme_read_bw)
            for t in range(n_storage)
        ]
        self.nvme_w_t: List[Resource] = [
            sim.resource(f"nvme_write{t}", spec.nvme_write_bw)
            for t in range(n_storage)
        ]
        # remote (initiator-side) volume I/O passes through PoseidonOS
        # reactors — a shared pool the paper identifies as the NoOffload
        # scalability limit; near-data tasks bypass it (SPDK direct)
        self.posvol_t: List[Resource] = [
            sim.resource(f"posvol{t}", spec.posvol_bw) for t in range(n_storage)
        ]
        # per-target DRAM FIFO for the remote-memory cache tier (MemTier):
        # hits and fills serve from here, never touching the NVMe FIFOs
        self.dram_t: List[Resource] = [
            sim.resource(f"dram{t}", spec.dram_bw) for t in range(n_storage)
        ]
        # target-0 aliases (back-compat for single-storage scenarios)
        self.cpu_s = self.cpu_s_t[0]
        self.net_s = self.net_s_t[0]
        self.nvme_r = self.nvme_r_t[0]
        self.nvme_w = self.nvme_w_t[0]
        self.posvol = self.posvol_t[0]
        self.dlm = sim.resource("dlm", 1.0 / spec.dlm_rtt)  # msgs/s
        # per-initiator trainer (accelerator): a 1-server FIFO — batches are
        # consumed strictly in arrival order, one at a time
        self.trainer_i: List[Resource] = [
            sim.resource(f"trainer{i}", spec.train_rate)
            for i in range(n_initiators)
        ]

    # ------------------------------------------------------ primitive ops
    def net_transfer(self, initiator: int, nbytes: float, *, target: int = 0):
        """Initiator↔storage transfer: both link FIFOs serve the bytes."""
        yield ("use", self.net_i[initiator], nbytes)
        yield ("use", self.net_s_t[target], nbytes)

    def storage_read(self, initiator: int, nbytes: float, *,
                     to_initiator=True, target: int = 0):
        yield ("use", self.nvme_r_t[target], nbytes)
        if to_initiator:
            yield ("use", self.posvol_t[target], nbytes)
            yield from self.net_transfer(initiator, nbytes, target=target)

    def storage_write(self, initiator: int, nbytes: float, *,
                      from_initiator=True, target: int = 0):
        if from_initiator:
            yield from self.net_transfer(initiator, nbytes, target=target)
            yield ("use", self.posvol_t[target], nbytes)
        yield ("use", self.nvme_w_t[target], nbytes)

    def cpu_work(self, initiator: Optional[int], seconds: float, *,
                 target: int = 0):
        """seconds = single-core-seconds of work; None → storage node."""
        res = self.cpu_s_t[target] if initiator is None else self.cpu_i[initiator]
        yield ("use", res, seconds)

    def dlm_msgs(self, n: int):
        yield ("use", self.dlm, float(n))

    def rpc(self, initiator: int, nbytes: float = 4096, *, target: int = 0):
        yield ("delay", self.spec.rpc_rtt)
        yield from self.net_transfer(initiator, nbytes, target=target)

    def rpc_batch(self, initiator: int, n_msgs: int, nbytes: float, *,
                  target: int = 0):
        """A coalesced wire message carrying `n_msgs` sub-calls: ONE round
        trip (the saving vs n_msgs × rpc is (n_msgs-1) × rpc_rtt), but every
        sub-call still pays target-side unmarshal/dispatch, and the bytes
        still flow through both link FIFOs."""
        yield ("delay", self.spec.rpc_rtt + max(0, n_msgs - 1) * self.spec.rpc_dispatch)
        yield from self.net_transfer(initiator, nbytes, target=target)

    def wal_ship(self, initiator: int, nbytes: float, *, target: int = 0):
        """Async WAL segment shipping: one RPC carries the sealed segment to
        the target, which lands it near-data (SPDK direct — the write skips
        the PoseidonOS reactor crossing that initiator-volume I/O pays).
        Runs as a background process; foreground puts never wait on it."""
        yield ("delay", self.spec.rpc_rtt)
        yield from self.net_transfer(initiator, nbytes, target=target)
        yield ("use", self.nvme_w_t[target], nbytes)

    def rebalance(self, initiator: int, nbytes: float, *,
                  src: int = 0, dst: int = 0,
                  rate: Optional[float] = None, chunk_bytes: float = 4e6):
        """Online stripe migration (copy → swap → free): the
        initiator drives the copy, so the moved bytes drain the SOURCE
        shard's NVMe read FIFO, cross the initiator's link twice (read
        back + write out) and land on the DESTINATION shard's write FIFO;
        one RPC covers the journaled lease grant + superblock commit.
        Spawned as a background process — foreground ops never join it.

        ``rate`` is the migration-rate limiter (bytes/s average): the copy
        proceeds in ``chunk_bytes`` slices with pacing delays between
        them, so the background traffic trickles through the FIFOs instead
        of monopolizing them — foreground I/O interleaves between chunks
        rather than queueing behind the whole copy. ``rate=None`` keeps
        the unthrottled behavior (one FIFO-saturating burst)."""
        yield from self.rpc(initiator, 4096, target=src)
        remaining = nbytes
        while remaining > 0:
            c = min(chunk_bytes, remaining) if rate else remaining
            yield ("use", self.nvme_r_t[src], c)
            yield from self.net_transfer(initiator, c, target=src)
            yield from self.net_transfer(initiator, c, target=dst)
            yield ("use", self.nvme_w_t[dst], c)
            remaining -= c
            if rate and remaining > 0:
                yield ("delay", c / rate)

    def pushdown_scan(self, initiator: int, table_bytes: float,
                      selectivity: float, *, target: int = 0,
                      row_bytes: float = 256.0, key_bytes: float = 32.0,
                      pushdown: bool = True):
        """One stripe's share of an OffloadDB range scan.

        Block shipping (``pushdown=False``): every SSTable byte crosses
        the PoseidonOS reactors + both link FIFOs and the *initiator*
        cores pay the merge+filter at ``merge_rate``.  Pushdown: the
        storage node reads the same bytes SPDK-direct (no posvol
        crossing, like the other near-data stubs), its own cores run the
        verified operator program, and only matching rows plus key-only
        suppression markers cross the wire — bytes drop by roughly the
        selectivity factor.  One small RPC ships the program + lease."""
        yield from self.rpc(initiator, 2048, target=target)
        if not pushdown:
            yield from self.storage_read(initiator, table_bytes,
                                         target=target)
            yield ("use", self.cpu_i[initiator],
                   table_bytes / self.spec.merge_rate)
            return
        yield ("use", self.nvme_r_t[target], table_bytes)
        yield ("use", self.cpu_s_t[target],
               table_bytes / self.spec.merge_rate)
        n_rows = table_bytes / row_bytes
        wire = selectivity * table_bytes + (1.0 - selectivity) * n_rows * key_bytes
        yield from self.net_transfer(initiator, wire, target=target)
        yield ("use", self.cpu_i[initiator], wire / self.spec.merge_rate)

    def cache_get(self, initiator: int, nbytes: float, *, target: int = 0):
        """Remote-DRAM cache hit (MemTier): one RPC round trip, the home
        node's DRAM FIFO, and the wire back — no NVMe read, no PoseidonOS
        reactor crossing. The latency gap between this and
        ``storage_read`` is the whole second-tier story."""
        yield ("delay", self.spec.rpc_rtt)
        yield ("use", self.dram_t[target], nbytes)
        yield from self.net_transfer(initiator, nbytes, target=target)

    def cache_fill(self, initiator: int, nbytes: float, *, target: int = 0):
        """Miss-path fill: the run just read from NVMe is offered back to
        its home node — one RPC, the bytes over the wire, a DRAM write.
        The admission filter's bookkeeping is free at this grain; a
        rejected offer pays the same wire cost (the bytes travel before
        the ghost list votes)."""
        yield ("delay", self.spec.rpc_rtt)
        yield from self.net_transfer(initiator, nbytes, target=target)
        yield ("use", self.dram_t[target], nbytes)

    def cache_invalidate(self, initiator: int, n_blocks: int, *,
                         target: int = 0):
        """Lease fence / free-path invalidation: one RPC carrying block
        ids only (~64 B each) — coherence traffic never moves data."""
        yield from self.rpc(initiator, 64.0 * max(1, n_blocks),
                            target=target)

    def train_consume(self, initiator: int, n_images: float):
        """The trainer sinks one prepped minibatch (strictly FIFO: the
        1-server trainer resource serializes batches in arrival order)."""
        yield ("use", self.trainer_i[initiator], n_images)

    def probe(self, initiator: int, n_targets: int = 1):
        """One router heartbeat round: a tiny RPC per probed target (the
        ``ping`` endpoint) — pure round trips, no data movement. Modeled
        per-target so a big fleet's health plane has visible cost."""
        for t in range(n_targets):
            yield from self.rpc(initiator, 512, target=t % self.n_storage)

    def takeover(self, initiator: int, *, journal_records: int = 0,
                 meta_bytes: float = 256 * 1024, target: int = 0):
        """Standby failover = crash_remount executed by a DIFFERENT
        initiator (the standby's own link/CPU pay for the replay) plus
        one superblock commit to fence the reclaimed orphans."""
        yield from self.crash_remount(initiator,
                                      journal_records=journal_records,
                                      meta_bytes=meta_bytes, target=target)
        yield from self.storage_write(initiator, 64 * 1024, target=target)

    def crash_remount(self, initiator: int, *, journal_records: int = 0,
                      meta_bytes: float = 256 * 1024, target: int = 0):
        """Initiator crash/re-mount: re-read the superblock area (metadata
        pickle + lease journal) from the volume and replay the journal to
        fence orphaned write leases — metadata-only work, no data scanning,
        which is the whole point of journaling the leases."""
        yield from self.storage_read(initiator, meta_bytes, target=target)
        yield ("use", self.cpu_i[initiator],
               journal_records * self.spec.lease_replay_cpu)

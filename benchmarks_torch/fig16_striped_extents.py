# Copied from benchmarks/fig16_striped_extents.py; the imports are rewritten.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 16 — shard-striped extent placement (this repo's extension).

Two measurements, one functional + one DES:

  A. Placement fidelity (functional): four tenant OffloadDB instances share
     one striped volume (``OffloadFS(shards=4)``), each pinned to a stripe
     (``DBConfig(placement_shard=k)``) with the offloader's
     ``placement_affinity`` policy. The device tracer attributes every
     block touched to the stripe that owns it. Claims: every extent-
     carrying task routed by affinity, ≥95% of each tenant's blocks on its
     own stripe with zero allocator spills, engine task counts balanced,
     and the busiest NVMe FIFO carries well under the flat volume's 100%
     share.

  B. Compaction-round throughput (DES): the SAME workload runs with the
     volume striped 1/2/4/8 ways; the per-stripe byte distribution the
     tracer measured is replayed through per-shard NVMe FIFO resources
     (flat volume = everything through one FIFO, the seed behaviour).
     Claim: ≥1.5× compaction-round throughput at 4 shards vs the flat
     volume (observed ≈4× — the distribution is near-uniform).

Run ``--smoke`` for the CI-sized subset (fewer ops, claims unchanged).
"""
from __future__ import annotations

import random
import sys

from benchmarks_torch.common import check, device, emit
from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.fs import SB_BLOCKS
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim

N_TENANTS = 4
SHARD_SWEEP = [1, 2, 4, 8]


def run_tenants(n_shards: int, *, n_ops_per_tenant: int):
    """Ingest N_TENANTS pinned OffloadDB instances on an n_shards-striped
    volume; returns (per-shard {shard: [read_blocks, write_blocks]},
    compaction rounds, engines, offloader, fs, dbs, models)."""
    dev = BlockDevice(num_blocks=1 << 18)
    fs = OffloadFS(dev, node="init0", shards=n_shards)
    fabric = RpcFabric()
    engines = []
    for t in range(max(n_shards, N_TENANTS)):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(
        fs, fabric, node="init0", targets=[e.node for e in engines],
        lb_policy="placement_affinity" if n_shards > 1 else "least_outstanding",
    )

    traffic = {k: [0, 0] for k in range(n_shards)}

    def tracer(ev):
        if ev.block >= SB_BLOCKS:  # superblock/journal area owns no stripe
            traffic[fs.extmgr.shard_of(ev.block)][0 if ev.op == "read" else 1] \
                += ev.nblocks
    dev.tracer = tracer

    dbs, models = [], []
    for inst in range(N_TENANTS):
        cfg = DBConfig(
            memtable_bytes=8 * 1024, sstable_target_bytes=32 * 1024,
            base_level_bytes=64 * 1024, l0_trigger=6,
            namespace=f"/t{inst}",
            placement_shard=inst % n_shards if n_shards > 1 else None,
        )
        dbs.append(OffloadDB(fs, off, cfg, device=device()))
        models.append({})
    rng = random.Random(16)
    for i in range(n_ops_per_tenant * N_TENANTS):
        inst = i % N_TENANTS
        k = f"key{rng.randrange(500):06d}".encode()
        v = f"val{i:08d}".encode() * 6
        dbs[inst].put(k, v)
        models[inst][k] = v
    for db in dbs:
        db.flush_all()
    fabric.drain()
    rounds = sum(db.stats["compactions"] + db.stats["flushes"] for db in dbs)
    return traffic, rounds, engines, off, fs, dbs, models


def replay_fifos(traffic: dict, n_storage: int) -> float:
    """DES replay of the measured per-stripe I/O: each stripe's bytes drain
    through its own NVMe read/write FIFO pair, stripes concurrent. The flat
    volume (n_storage=1) serializes everything through one pair — exactly
    the cross-shard interference striping removes."""
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_initiators=1, n_storage=n_storage)

    def drain(t, read_blocks, write_blocks):
        yield ("use", cl.nvme_r_t[t], read_blocks * BLOCK_SIZE)
        yield ("use", cl.nvme_w_t[t], write_blocks * BLOCK_SIZE)

    for t, (rb, wb) in traffic.items():
        sim.spawn(drain(t % n_storage, rb, wb))
    return sim.run()


def main():
    smoke = "--smoke" in sys.argv
    n_ops = 600 if smoke else 2000

    # ---------------------------------------------- A: placement fidelity
    traffic4, rounds4, engines, off, fs, dbs, models = run_tenants(
        4, n_ops_per_tenant=n_ops
    )
    bad = sum(1 for m, db in zip(models, dbs)
              for k, v in m.items() if db.get(k) != v)
    check("fig16/correctness", bad == 0, f"{bad} wrong gets")

    runs = {e.node: e.tasks_run for e in engines}
    emit("fig16/by_target",
         ";".join(f"{k}={v}" for k, v in sorted(runs.items())),
         f"affinity_routed={off.stats.affinity_routed}")
    check("fig16/affinity_routes_everything",
          off.stats.affinity_routed == off.stats.submitted
          and off.stats.submitted > 0,
          f"{off.stats.affinity_routed}/{off.stats.submitted} tasks routed "
          "to the stripe owning their extents")
    lo, hi = min(runs.values()), max(runs.values())
    check("fig16/balanced_engines", hi <= 2 * max(1, lo),
          f"min={lo} max={hi} tasks per engine")

    own = tot = 0
    for inst in range(N_TENANTS):
        for p in fs.listdir(f"/t{inst}/"):
            for e in fs.stat(p).extents:
                tot += e.nblocks
                own += e.nblocks if fs.extmgr.shard_of(e.block) == inst else 0
    emit("fig16/own_shard_blocks", f"{own}/{tot}",
         f"spills={fs.extmgr.spills}")
    check("fig16/placement_on_own_shard",
          tot > 0 and own >= 0.95 * tot and fs.extmgr.spills == 0,
          f"{own/max(1,tot)*100:.1f}% of tenant blocks on the pinned stripe")

    blocks = {k: rb + wb for k, (rb, wb) in traffic4.items()}
    total_blocks = sum(blocks.values())
    busiest = max(blocks.values()) / max(1, total_blocks)
    emit("fig16/fifo_share",
         ";".join(f"{k}={v}" for k, v in sorted(blocks.items())),
         f"busiest={busiest:.2f} (flat volume = 1.00)")
    check("fig16/fifo_contention_reduced", busiest <= 0.45,
          f"busiest FIFO carries {busiest*100:.0f}% of device blocks "
          "(25% = perfect 4-way stripe)")

    # ------------------------------------- B: compaction-round throughput
    results = {}
    for n in SHARD_SWEEP:
        if n == 4:
            traffic, rounds = traffic4, rounds4
        else:
            traffic, rounds, *_ = run_tenants(n, n_ops_per_tenant=n_ops)
        t = replay_fifos(traffic, n)
        results[n] = rounds / t if t else 0.0
        emit(f"fig16/round_throughput/{n}", f"{results[n]:.0f}",
             f"rounds={rounds} fifo_time={t*1e3:.2f}ms")
    speedup = results[4] / results[1]
    check("fig16/round_throughput_4shards", speedup >= 1.5,
          f"{speedup:.2f}x compaction-round throughput at 4 shards vs flat")
    check("fig16/round_throughput_monotone",
          results[2] >= results[1] * 0.95
          and results[8] >= results[4] * 0.95,
          "adding stripes never hurts")


if __name__ == "__main__":
    main()

# Copied from benchmarks/fig14_sharded_plane.py; the imports are rewritten.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 14 — sharded multi-target offload plane (this repo's extension).

Two measurements, one functional + one DES:

  A. RPC coalescing/batching (functional, honest pickle bytes): the same
     OffloadDB ingest runs once over the legacy plane (3-message
     admit/run/complete handshake, serial per-task submission) and once
     over the batched plane (single-message submit_task, one wire batch
     per shard for flush/compaction rounds). Claim: ≥2× fewer wire
     messages at equivalent bytes-per-link accounting; the record stream
     replays deterministically through the DES wire model and the batched
     plane's replayed wire time is lower (round trips saved).

  B. Throughput scaling (DES): near-data flush/compaction jobs spread
     across 1/2/4/8 storage targets, each with its own CPU/links/NVMe.
     Claim: makespan scales ≥1.7×/≥3×/≥5× at 2/4/8 targets.

Plus the structural claim for this PR: flush + compaction submitted
concurrently against ≥2 storage engines, zero LeaseViolations, balanced
placement under the least-outstanding policy.
"""
from __future__ import annotations

import random

from benchmarks_torch.common import check, device, emit
from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim

MB = 1e6


# ------------------------------------------------------------ functional
def build_plane(n_targets: int, *, coalesce: bool,
                lb_policy: str = "least_outstanding"):
    dev = BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy=lb_policy, coalesce=coalesce)
    return fs, fabric, engines, off


def db_ingest(fs, off, *, n_ops: int = 6000):
    cfg = DBConfig(memtable_bytes=8 * 1024, sstable_target_bytes=32 * 1024,
                   base_level_bytes=64 * 1024, l0_trigger=6)
    db = OffloadDB(fs, off, cfg, device=device())
    rng = random.Random(14)
    for i in range(n_ops):
        k = f"key{rng.randrange(900):06d}".encode()
        db.put(k, f"val{i:08d}".encode() * 6)
        if i == n_ops // 2:
            db.flush_all()  # mid-stream checkpoint: flushes the imm backlog
    db.flush_all()
    return db


def replay_wire(records, spec=TESTBED) -> float:
    """Deterministic DES replay of the recorded message stream over one
    initiator link: every wire message pays one RPC round trip + its bytes
    through both FIFOs. Fewer messages ⇒ less round-trip tax."""
    sim = Sim()
    cl = Cluster(sim, spec, n_initiators=1, n_storage=1)

    def wire():
        for rec in records:
            yield from cl.rpc_batch(0, rec.n_calls, rec.req_bytes + rec.resp_bytes)

    sim.spawn(wire())
    return sim.run()


def part_a():
    fs_a, fab_a, eng_a, off_a = build_plane(2, coalesce=False)
    db_a = db_ingest(fs_a, off_a)
    fab_a.drain()
    fs_b, fab_b, eng_b, off_b = build_plane(2, coalesce=True)
    db_b = db_ingest(fs_b, off_b)
    fab_b.drain()

    msgs_a, msgs_b = fab_a.total_messages(), fab_b.total_messages()
    bytes_a, bytes_b = fab_a.total_bytes(), fab_b.total_bytes()
    emit("fig14/legacy/messages", msgs_a, f"subcalls={fab_a.total_subcalls()}")
    emit("fig14/batched/messages", msgs_b, f"subcalls={fab_b.total_subcalls()}")
    emit("fig14/legacy/bytes", bytes_a)
    emit("fig14/batched/bytes", bytes_b)
    check("fig14/message_reduction", msgs_a >= 2 * msgs_b,
          f"{msgs_a / max(1, msgs_b):.1f}x fewer wire messages")
    ratio = bytes_b / max(1, bytes_a)
    check("fig14/bytes_fidelity", 0.5 < ratio < 1.5,
          f"batched/legacy byte ratio {ratio:.2f} (payloads unchanged; the "
          "saving is messages, not bytes)")

    t_a, t_b = replay_wire(fab_a.records), replay_wire(fab_b.records)
    emit("fig14/legacy/replay_wire_s", f"{t_a:.4f}")
    emit("fig14/batched/replay_wire_s", f"{t_b:.4f}")
    check("fig14/replay_round_trip_savings", t_b < t_a,
          f"{t_a / max(t_b, 1e-12):.1f}x wire time (DES replay of records)")

    # structural claim: both shards executed flush AND compaction work,
    # concurrently submitted, with zero LeaseViolations (any violation
    # would have raised through the futures) and balanced placement
    runs = {e.node: e.tasks_run for e in eng_b}
    emit("fig14/by_target", ";".join(f"{k}={v}" for k, v in sorted(runs.items())),
         f"lb=least_outstanding batches={off_b.stats.batches}")
    check("fig14/sharded_flush_compaction",
          all(v > 0 for v in runs.values())
          and db_b.stats["flushes"] > 0 and db_b.stats["compactions"] > 0
          and off_b.stats.batches > 0,
          "flush+compaction spread over 2 engines, zero LeaseViolation")
    lo, hi = min(runs.values()), max(runs.values())
    check("fig14/balance", hi <= 2.5 * max(1, lo),
          f"min={lo} max={hi} per-target tasks")
    # spot-check durability of the sharded plane's output
    assert db_b.get(b"key000001") == db_a.get(b"key000001")


# --------------------------------------------------------------- scaling
def scale_makespan(n_targets: int, *, n_jobs: int = 256,
                   job_bytes: float = 24 * MB) -> float:
    """Near-data flush/compaction jobs round-robined over N storage
    targets; each pays one (batched) RPC, reads+merges+writes near-data."""
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_initiators=1, n_storage=n_targets)

    def job(k: int):
        t = k % n_targets
        yield from cl.rpc_batch(0, 1, 4096, target=t)
        yield from cl.storage_read(0, job_bytes, to_initiator=False, target=t)
        yield from cl.cpu_work(None, job_bytes / TESTBED.merge_rate, target=t)
        yield from cl.storage_write(0, job_bytes, from_initiator=False, target=t)

    for k in range(n_jobs):
        sim.spawn(job(k))
    return sim.run()


def part_b():
    base = scale_makespan(1)
    speed = {}
    for n in (1, 2, 4, 8):
        m = scale_makespan(n)
        speed[n] = base / m
        emit(f"fig14/scale/{n}", f"{m:.4f}", f"speedup={speed[n]:.2f}x")
    check("fig14/scales_2", speed[2] >= 1.7, f"{speed[2]:.2f}x @2 targets")
    check("fig14/scales_4", speed[4] >= 3.0, f"{speed[4]:.2f}x @4 targets")
    check("fig14/scales_8", speed[8] >= 5.0, f"{speed[8]:.2f}x @8 targets")


def main():
    part_a()
    part_b()


if __name__ == "__main__":
    main()

# Copied from benchmarks/fig11_latency_throughput.py; only the imports are rewritten.
"""Fig. 11 — latency-throughput curves (YCSB A) for RocksDB / ODB / SpanDB
by sweeping offered load. RocksDB/ODB follow the classic hockey-stick;
ODB's curve sits right+down of RocksDB (higher capacity); SpanDB saturates
earlier on writes (sync WAL + fg threads) — 'abnormal' flat-then-cliff.
"""
from __future__ import annotations

from dataclasses import replace

from benchmarks_torch.common import check, emit
from repro_torch.sim.kvmodel import KVParams, run_kv

BASE = KVParams(system="offloadfs", n_ops=40_000, write_ratio=0.5)

SYSTEMS = {
    "rocksdb": replace(BASE, offload_levels=0, offload_flush=False),
    "odb": replace(BASE, offload_levels=99, offload_flush=True,
                   log_recycling=True, l0_cache=True, offload_cache=True),
    "spandb": replace(BASE, offload_levels=0, offload_flush=False, sync_wal=True),
}


def main():
    curves = {}
    for name, base in SYSTEMS.items():
        pts = []
        for nthreads in [4, 8, 16, 32, 64, 128]:
            p = replace(base, client_threads=nthreads)
            r = run_kv(p, instances=max(1, nthreads // 32))
            pts.append((r.throughput, r.p99))
            emit(f"fig11/{name}/threads{nthreads}",
                 f"{r.throughput:.0f}", f"p99_ms={r.p99*1e3:.3f}")
        curves[name] = pts

    cap = {n: max(t for t, _ in pts) for n, pts in curves.items()}
    check("fig11/odb_capacity_above_rocksdb", cap["odb"] > cap["rocksdb"],
          f"{cap['odb']:.0f} vs {cap['rocksdb']:.0f}")
    check("fig11/spandb_saturates_early", cap["spandb"] < cap["rocksdb"],
          "sync WAL")
    # hockey stick: p99 at capacity >> p99 at low load
    for n in ["rocksdb", "odb"]:
        lo = curves[n][0][1]
        hi = curves[n][-1][1]
        check(f"fig11/{n}_hockey_stick", hi > 1.5 * lo,
              f"{lo*1e3:.2f} -> {hi*1e3:.2f} ms")


if __name__ == "__main__":
    main()

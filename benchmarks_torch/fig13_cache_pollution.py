# Copied from benchmarks/fig13_cache_pollution.py; the imports are rewritten.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 13 — initiator cache hit ratio vs number of offloaded compaction
levels (functional OffloadDB, memory-constrained cache, YCSB A). The more
compaction runs remotely, the less background I/O pollutes the initiator's
cache → foreground hit ratio rises monotonically."""
from __future__ import annotations

import random

from benchmarks_torch.common import check, device, emit
from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine


def run(offload_levels: int, n_ops: int = 9000) -> float:
    dev = BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    engine = OffloadEngine(fs, node="storage0", cache_blocks=2048)
    engine.register_stub("compact", C.stub_compact)
    engine.register_stub("log_recycle", C.stub_log_recycle)
    serve_engine(engine, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0")
    cfg = DBConfig(
        memtable_bytes=48 * 1024, sstable_target_bytes=96 * 1024,
        base_level_bytes=256 * 1024, table_cache_bytes=256 * 1024,  # scarce
        offload_levels=offload_levels, offload_flush=offload_levels > 0,
        log_recycling=offload_levels > 0, l0_cache=offload_levels > 0,
        cache_compaction_reads=(offload_levels == 0),
    )
    db = OffloadDB(fs, off, cfg, device=device())
    rng = random.Random(13)
    val = b"v" * 512
    for _ in range(n_ops):
        k = f"k{int(rng.paretovariate(1.2) * 50) % 8000:08d}".encode()
        if rng.random() < 0.5:
            db.put(k, val)
        else:
            db.get(k)
    return db.foreground_hit_ratio()


def main():
    ratios = {}
    for lv in [0, 1, 2, 3, 4]:
        h = run(lv)
        ratios[lv] = h
        emit(f"fig13/offload_levels_{lv}/hit_ratio", f"{h:.3f}", "")
    check("fig13/hit_ratio_rises_with_offloading",
          ratios[4] > ratios[0],
          f"{ratios[0]:.3f} -> {ratios[4]:.3f}")


if __name__ == "__main__":
    main()

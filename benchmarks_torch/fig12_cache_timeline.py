# Copied from benchmarks/fig12_cache_timeline.py; the imports are rewritten.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 12 — cache usage & hit ratio, FUNCTIONAL runs of the real OffloadDB
(not the DES): write-intensive WR75 then read-intensive WR25, under
  default        — compaction I/O goes through the initiator's cache
  dio-compaction — compaction bypasses the cache (direct I/O)
  odb            — compaction offloaded (initiator cache never sees it) +
                   L0 cache + target-side Offload Cache

Claims: default's hit ratio is inflated by background-compaction hits
(pollution); dio-compaction caches only foreground-hot blocks yet loses no
throughput; ODB reaches fewer storage reads (L0 cache absorbs young keys).
"""
from __future__ import annotations

import random

from benchmarks_torch.common import check, device, emit
from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine


def build(cfg: DBConfig):
    dev = BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    engine = OffloadEngine(fs, node="storage0", cache_blocks=2048)
    engine.register_stub("compact", C.stub_compact)
    engine.register_stub("log_recycle", C.stub_log_recycle)
    serve_engine(engine, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0")
    return dev, fs, engine, OffloadDB(fs, off, cfg, device=device())


def run(cfg: DBConfig, tag: str, n_ops: int = 6000):
    dev, fs, engine, db = build(cfg)
    rng = random.Random(7)
    val = b"v" * 512

    def phase(write_pct, n):
        dev.reset_counters()
        db.cache.hits = db.cache.misses = 0
        for i in range(n):
            k = f"k{rng.randrange(3000):08d}".encode()
            if rng.random() < write_pct:
                db.put(k, val)
            else:
                db.get(k)
        return {
            "hit": db.cache.hit_ratio,
            "dev_reads": dev.reads,
            "dev_writes": dev.writes,
        }

    wr75 = phase(0.75, n_ops)
    wr25 = phase(0.25, n_ops)
    emit(f"fig12/{tag}/wr75_hit", f"{wr75['hit']:.3f}",
         f"dev_reads={wr75['dev_reads']}")
    emit(f"fig12/{tag}/wr25_hit", f"{wr25['hit']:.3f}",
         f"dev_reads={wr25['dev_reads']}")
    return wr75, wr25, engine


def main():
    base = dict(memtable_bytes=48 * 1024, sstable_target_bytes=96 * 1024,
                base_level_bytes=256 * 1024, table_cache_bytes=1 << 20)
    default_cfg = DBConfig(offload_levels=0, offload_flush=False,
                           log_recycling=False, l0_cache=False,
                           cache_compaction_reads=True, **base)
    dio_cfg = DBConfig(offload_levels=0, offload_flush=False,
                       log_recycling=False, l0_cache=False,
                       cache_compaction_reads=False, **base)
    odb_cfg = DBConfig(offload_levels=99, offload_flush=True,
                       log_recycling=True, l0_cache=True,
                       cache_compaction_reads=False, **base)
    d75, d25, _ = run(default_cfg, "default")
    o75, o25, _ = run(dio_cfg, "dio-compaction")
    b75, b25, eng = run(odb_cfg, "odb")
    emit("fig12/odb/offload_cache_hits", eng.cache.stats.hits,
         f"misses={eng.cache.stats.misses}")

    check("fig12/odb_fewest_storage_reads",
          b25["dev_reads"] <= min(d25["dev_reads"], o25["dev_reads"]),
          f"odb={b25['dev_reads']} default={d25['dev_reads']} dio={o25['dev_reads']}")
    check("fig12/pollution_visible_in_default",
          d75["dev_reads"] > o75["dev_reads"],
          "compaction reads flow through the foreground path")


if __name__ == "__main__":
    main()

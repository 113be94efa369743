# Port of examples/quickstart.py on repro_torch; OffloadDB takes --device.
"""Quickstart: OffloadFS + OffloadDB in 60 lines.

Creates a disaggregated volume, mounts OffloadFS on the initiator, wires an
Offload Engine on the storage node through the RPC fabric, and runs a KV
workload whose MemTable flushes (Log Recycling) and compactions execute on
the storage node — while the RPC plane carries only block addresses.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import random
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine


def pick_device(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    dev = ap.parse_args(argv).device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {dev}: no CUDA card here (pass --device cpu)")
    return dev


def main(argv=None):
    torch_dev = pick_device(argv)
    # --- a 1 GiB NVMeoF volume shared by initiator and storage node
    dev = BlockDevice(num_blocks=1 << 18)
    fs = OffloadFS(dev, node="initiator0")

    # --- storage node: Offload Engine + admission policy on the fabric
    fabric = RpcFabric()
    engine = OffloadEngine(fs, node="storage0", cache_blocks=4096)
    engine.register_stub("compact", C.stub_compact)
    engine.register_stub("log_recycle", C.stub_log_recycle)
    serve_engine(engine, fabric, AcceptAll())

    # --- initiator: Task Offloader + OffloadDB
    offloader = TaskOffloader(fs, fabric, node="initiator0")
    db = OffloadDB(fs, offloader, DBConfig(memtable_bytes=64 * 1024), device=torch_dev)

    rng = random.Random(0)
    n = 5000
    data = 0
    for i in range(n):
        k = f"user{rng.randrange(2000):08d}".encode()
        v = f"profile-{i:08d}".encode() * 8
        db.put(k, v)
        data += len(k) + len(v)
    print(f"inserted {n} keys ({data/1e6:.1f} MB)")
    print(f"flushes={db.stats['flushes']} compactions={db.stats['compactions']} "
          f"(all executed on {engine.node})")
    print(f"levels: { {l: len(t) for l, t in db.levels.items()} }")
    print(f"RPC bytes total: {fabric.total_bytes()/1e3:.1f} KB "
          f"(Log Recycling: data never crosses the RPC plane)")
    print(f"offload cache: {engine.cache.stats}")
    got = db.get(f"user{rng.randrange(2000):08d}".encode())
    print(f"point lookup ok: {got is not None}")

    # crash + recover
    db.flush_all()
    fs2 = OffloadFS.mount(dev, node="initiator0")
    db2 = OffloadDB.recover(fs2, None, device=torch_dev)
    print(f"recovered: levels { {l: len(t) for l, t in db2.levels.items()} }")


if __name__ == "__main__":
    main()

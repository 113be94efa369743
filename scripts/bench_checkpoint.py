#!/usr/bin/env python3
"""Checkpoint host time of the trainer at full width, for a few OffloadDB
planes, on one GPU.

    python3 scripts/bench_checkpoint.py [--memtables 8,32,128]

For each memtable size (MiB) it runs ``repro_torch.train.e2e.run`` on
paper-lm-100m at full width with ``chip_smoke.py``'s ``train_e2e`` flow
(12 steps, a checkpoint every 4, a crash after 8, recover, restore,
resume), with token ingest so that no prep producer shares the
interpreter, on the plane ``e2e.checkpoint_plane`` builds from that size.
It prints one JSON line per plane: each save's ms and written/skipped
leaves, the restore ms, the DB's flushes and compactions, the RPC bytes
and the whole run's seconds, then the card's name and power limit. The
planes run in the order given, in one process. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the train_e2e flow's constants; sets up src/)


def main(argv=None) -> int:
    import torch

    from repro_torch.train import e2e

    ap = argparse.ArgumentParser()
    ap.add_argument("--memtables", default="8,32,128",
                    help="comma-separated memtable sizes in MiB")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_checkpoint needs a CUDA device")
    for mib in (int(x) for x in args.memtables.split(",")):
        db_cfg, cache_blocks = e2e.checkpoint_plane(mib)
        t0 = time.perf_counter()
        out = e2e.run(steps=chip_smoke.E2E_STEPS, ckpt_every=chip_smoke.E2E_CKPT_EVERY,
                      kill_at=chip_smoke.E2E_KILL_AT, ingest="tokens", device="cuda",
                      plane=(db_cfg, cache_blocks), log=lambda *_: None)
        run_s = time.perf_counter() - t0
        print(json.dumps({
            "plane": {"memtable_mib": mib, "sstable_target_bytes": db_cfg.sstable_target_bytes,
                      "base_level_bytes": db_cfg.base_level_bytes,
                      "cache_blocks": cache_blocks},
            "checkpoints": out["checkpoints"], "restored_step": out["restored_step"],
            "restore_ms": out["restore_ms"],
            "save_ms_total": sum(c["ms"] for c in out["checkpoints"]),
            "flushes": [s["flushes"] for s in out["db_stats"]],
            "compactions": [s["compactions"] for s in out["db_stats"]],
            "rpc_bytes": out["rpc_bytes"], "run_s": run_s}), flush=True)
        del out
        torch.cuda.empty_cache()
    print(chip_smoke.phase_device()["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

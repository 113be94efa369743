# Copied from benchmarks/fig7a_offload_levels.py; only the imports are rewritten.
"""Fig. 7(a) — OffloadDB write-only throughput (YCSB A @100% write,
single initiator, 16-NVMe volume) vs which compaction levels are offloaded:
Local, L0-L1 … L0-L4, peer.

Paper claims checked:
  * OffloadFS Local ≈ 2.2× OCFS2 Local (pure FS overhead);
  * OffloadFS improves monotonically with more offloaded levels;
  * OCFS2 DEGRADES when offloading (two writers → dir-lock serialization)
    and never beats its own Local;
  * GFS2 improves with offloading but from a much lower baseline;
  * OffloadFS best (all levels or peer) ≈ 3.36× best OCFS2;
  * OffloadFS prefers the (faster-CPU) peer — near-data need reduced;
    OCFS2/GFS2 prefer the storage node (their DLM traffic hates the fabric).
"""
from __future__ import annotations

from benchmarks_torch.common import check, emit
from repro_torch.sim.kvmodel import KVParams, run_kv

LEVELS = [("local", 0), ("L0-L1", 1), ("L0-L2", 2), ("L0-L3", 3), ("L0-L4", 4)]


def series(system: str, *, recycling: bool, ocache: bool):
    out = {}
    for tag, k in LEVELS + [("peer", 4)]:
        p = KVParams(
            system=system,
            n_ops=150_000,
            write_ratio=1.0,
            offload_levels=k,
            offload_flush=k > 0,
            log_recycling=recycling and k > 0,
            offload_cache=ocache and k > 0,
            l0_cache=recycling and k > 0,
            peer=(tag == "peer"),
        )
        r = run_kv(p)
        out[tag] = r.throughput
        emit(f"fig7a/{system}/{tag}", f"{r.throughput:.0f}",
             f"stall_s={r.stall_time:.2f}")
    return out


def main():
    offs = series("offloadfs", recycling=True, ocache=True)
    ocfs = series("ocfs2", recycling=False, ocache=False)
    gfs = series("gfs2", recycling=False, ocache=False)

    check("fig7a/offs_local_2.2x_ocfs2",
          1.6 < offs["local"] / ocfs["local"] < 3.2,
          f"{offs['local']/ocfs['local']:.2f}x (paper 2.2x)")
    mono = all(offs[LEVELS[i + 1][0]] >= offs[LEVELS[i][0]] * 0.98
               for i in range(len(LEVELS) - 1))
    check("fig7a/offs_monotone_up", mono, "")
    check("fig7a/ocfs2_degrades_when_offloading",
          ocfs["L0-L1"] < ocfs["local"], f"{ocfs['L0-L1']:.0f} < {ocfs['local']:.0f}")
    check("fig7a/gfs2_scales_from_low_base",
          gfs["local"] < ocfs["local"] and gfs["L0-L4"] > gfs["local"], "")
    best_off = max(offs.values())
    best_ocfs = max(ocfs.values())
    check("fig7a/offs_best_3.36x_best_ocfs2",
          2.3 < best_off / best_ocfs < 4.5,
          f"{best_off/best_ocfs:.2f}x (paper 3.36x)")
    check("fig7a/offs_peer_best", offs["peer"] >= offs["L0-L4"] * 0.90,
          "peer ≈ storage-all: fast cores vs near-data I/O (see EXPERIMENTS)")
    check("fig7a/ocfs2_prefers_storage_over_peer",
          ocfs["peer"] <= ocfs["L0-L4"], "DLM hates the extra fabric hops")


if __name__ == "__main__":
    main()

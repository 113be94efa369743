# Copied from benchmarks/fig7b_prep_ratio.py; only the imports are rewritten.
"""Fig. 7(b) — OffloadPrep pre-processing time vs offloaded fraction of the
minibatch (storage / peer / both), per file system.

Claims: turnaround improves until ~40–50% offload then is bounded by the
offloadee; peer beats storage for compute-bound preprocessing; both > peer;
OffloadFS ≈ 1.85× OCFS2 when offloading to the storage node; FS deltas are
smaller than in 7(a) (read-only workload → little DLM traffic).
"""
from __future__ import annotations

from benchmarks_torch.common import check, emit
from repro_torch.sim.prepmodel import PrepParams, run_prep

RATIOS = [0.0, 0.2, 0.4, 0.5, 0.6, 0.8, 1.0]


def series(system: str, target: str):
    out = {}
    for r in RATIOS:
        p = PrepParams(system=system, offload_ratio=r, target=target)
        res = run_prep(p)
        out[r] = res.epoch_time
        emit(f"fig7b/{system}/{target}/ratio{int(r*100):03d}",
             f"{res.epoch_time:.2f}", "seconds")
    return out


def main():
    offs_s = series("offloadfs", "storage")
    offs_p = series("offloadfs", "peer")
    offs_b = series("offloadfs", "both")
    ocfs_s = series("ocfs2", "storage")

    knee = min(offs_s, key=lambda r: offs_s[r])
    check("fig7b/knee_40_60pct", 0.3 <= knee <= 0.65, f"knee at {knee:.0%}")
    check("fig7b/peer_beats_storage_for_compute_bound",
          offs_p[0.5] <= offs_s[0.5], "")
    check("fig7b/both_beats_peer_alone",
          min(offs_b.values()) <= min(offs_p.values()) * 1.02,
          "storage cycles are additive capacity")
    ratio = ocfs_s[0.5] / offs_s[0.5]
    check("fig7b/offs_1.85x_ocfs2", 1.2 < ratio < 2.6,
          f"{ratio:.2f}x (paper 1.85x)")
    check("fig7b/fs_deltas_smaller_than_7a", ratio < 2.2,
          "read-only: little DLM traffic")


if __name__ == "__main__":
    main()

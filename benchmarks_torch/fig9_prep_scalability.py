# Copied from benchmarks/fig9_prep_scalability.py; only the imports are rewritten.
"""Fig. 9 — OffloadPrep scalability: 1..8 initiators offload 1/3 of each
minibatch to the shared storage node under admission policies — plus the
striped-plane shard-count sweep (``n_storage`` ∈ {1, 2, 4, 8}).

Claims: NoOffload epoch ≈ flat (18→22 s-class growth from shared volume);
AcceptAll best until ~4 then COLLAPSES at 8 (storage CPU > 80%);
RejectAll ≈ NoOffload + negligible penalty (cheap rejected RPCs);
CPU-threshold avoids the collapse; Token ≈ CPU + ~3% (fewer rejections).
Striped sweep: the AcceptAll collapse at 8 initiators is deferred by
adding storage targets (initiator i's corpus on target i % n_storage).
"""
from __future__ import annotations

from benchmarks_torch.common import check, emit
from repro_torch.sim.prepmodel import PrepParams, run_prep

INSTANCES = [1, 2, 4, 8]
N_STORAGE = [1, 2, 4, 8]


def series(tag, policy, ratio=1 / 3):
    out = {}
    for n in INSTANCES:
        p = PrepParams(system="offloadfs", offload_ratio=ratio, target="storage")
        r = run_prep(p, instances=n, policy=policy)
        out[n] = r.epoch_time
        emit(f"fig9/{tag}/{n}", f"{r.epoch_time:.2f}",
             f"storage_cpu={r.storage_cpu_util:.2f} rej={r.rejected}")
    return out


def main():
    noopt = series("nooffload", "reject", ratio=0.0)
    rej = series("rejectall", "reject")
    acc = series("acceptall", "accept")
    cpu = series("cpu", "cpu:0.8")
    tok = series("token", "token:4:0.25")

    check("fig9/acceptall_faster_at_4", acc[4] < noopt[4], "")
    check("fig9/acceptall_collapses_at_8",
          acc[8] > acc[4] * 1.5, f"{acc[8]:.1f}s vs {acc[4]:.1f}s @4")
    check("fig9/rejectall_penalty_negligible",
          rej[8] < noopt[8] * 1.08, "rejected RPCs are cheap")
    check("fig9/cpu_avoids_collapse", cpu[8] < acc[8], "")
    check("fig9/token_within_3pct_of_cpu",
          tok[8] < cpu[8] * 1.05, f"token {tok[8]:.1f}s vs cpu {cpu[8]:.1f}s")

    striped, sutil = {}, {}
    for ns in N_STORAGE:
        p = PrepParams(system="offloadfs", offload_ratio=1 / 3,
                       target="storage", n_storage=ns)
        r = run_prep(p, instances=8, policy="accept")
        striped[ns], sutil[ns] = r.epoch_time, r.storage_cpu_util
        emit(f"fig9/striped/{ns}", f"{r.epoch_time:.2f}",
             f"storage_cpu={r.storage_cpu_util:.2f} rej={r.rejected}")
    check("fig9/striped_defers_collapse",
          striped[2] < striped[1] * 0.75,
          f"{striped[1]:.1f}s -> {striped[2]:.1f}s with 2 targets")
    check("fig9/striped_desaturates_storage_cpu",
          sutil[4] < 0.6 * sutil[1],
          f"per-target cpu {sutil[1]:.2f} -> {sutil[4]:.2f} at 4 targets")
    check("fig9/striped_monotone", striped[8] <= striped[4] * 1.05,
          "adding targets never hurts")


if __name__ == "__main__":
    main()

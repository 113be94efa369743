# Copied from benchmarks/fig8_db_scalability.py; only the imports are rewritten.
"""Fig. 8 — OffloadDB scalability (YCSB A 50% write) with 1..8 initiators
sharing one storage node, under admission policies — plus the striped-plane
shard-count sweep (``n_storage`` ∈ {1, 2, 4, 8}).

Claims: throughput scales to ~6 instances then the storage node saturates;
AcceptAll ≈ 2× NoOffload; Token/CPU ≈ +10% over AcceptAll at 6 instances;
Token degrades least at 8 (fewer reject round-trips than CPU policy).
Striped sweep: adding storage targets at 8 initiators relieves the
single-target saturation knee (placement affinity maps initiator i to
target i % n_storage).
"""
from __future__ import annotations

from benchmarks_torch.common import check, emit
from repro_torch.sim.kvmodel import KVParams, run_kv

INSTANCES = [1, 2, 4, 6, 8]
N_STORAGE = [1, 2, 4, 8]


def series(policy, *, offload: bool):
    out = {}
    for n in INSTANCES:
        p = KVParams(
            system="offloadfs", n_ops=60_000, write_ratio=0.5,
            offload_levels=1 if offload else 0, offload_flush=offload,
            log_recycling=offload, l0_cache=offload, offload_cache=offload,
        )
        r = run_kv(p, instances=n, policy=policy)
        out[n] = r.throughput
        emit(f"fig8/{policy or 'nooffload' if not offload else policy}/{n}",
             f"{r.throughput:.0f}",
             f"storage_cpu={r.storage_cpu_util:.2f}")
    return out


def storage_sweep():
    """Shard-count sweep at the saturation point (8 initiators)."""
    out, util = {}, {}
    for ns in N_STORAGE:
        p = KVParams(
            system="offloadfs", n_ops=30_000, write_ratio=0.5,
            offload_levels=1, offload_flush=True, log_recycling=True,
            l0_cache=True, offload_cache=True, n_storage=ns,
        )
        r = run_kv(p, instances=8, policy="accept")
        out[ns], util[ns] = r.throughput, r.storage_cpu_util
        emit(f"fig8/striped/{ns}", f"{r.throughput:.0f}",
             f"storage_cpu={r.storage_cpu_util:.2f}")
    return out, util


def main():
    noopt = series("reject", offload=False)
    acc = series("accept", offload=True)
    cpu = series("cpu:0.8", offload=True)
    tok = series("token:6:0.5", offload=True)

    check("fig8/acceptall_beats_nooffload",
          acc[4] > 1.35 * noopt[4],
          f"{acc[4]/noopt[4]:.2f}x @4 (paper ~2x; DES reproduces direction, "
          "magnitude deviation recorded in EXPERIMENTS.md)")
    check("fig8/scales_to_6", acc[6] > acc[4] * 1.05, "")
    check("fig8/knee_at_8",
          acc[8] < acc[6] * 1.15, "storage node saturates")
    gain = max(cpu[6], tok[6]) / acc[6]
    check("fig8/policies_competitive_at_6", gain > 0.90,
          f"{(gain-1)*100:+.1f}% (paper +10%; second-order queueing effect)")
    check("fig8/token_degrades_least_at_8",
          tok[8] >= cpu[8] * 0.95 and tok[8] >= acc[8] * 0.95,
          "fewer reject round trips")

    striped, util = storage_sweep()
    check("fig8/striped_relieves_knee_at_2",
          striped[2] > 1.25 * striped[1],
          f"{striped[2]/striped[1]:.2f}x with 2 targets @8 initiators")
    check("fig8/striped_relieves_knee_at_4",
          striped[4] > 1.40 * striped[1],
          f"{striped[4]/striped[1]:.2f}x with 4 targets @8 initiators")
    check("fig8/striped_desaturates_storage_cpu",
          util[4] < 0.6 * util[1],
          f"per-target cpu {util[1]:.2f} -> {util[4]:.2f} at 4 targets")
    check("fig8/striped_monotone", striped[8] >= striped[4] * 0.95,
          "adding targets never hurts")


if __name__ == "__main__":
    main()

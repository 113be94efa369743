# Copied from benchmarks/fig2_fs_overhead.py; only the imports are rewritten.
"""Fig. 2 — FIO 4 KiB random read/write on a single initiator through
EXT4 / OCFS2 / GFS2 / OffloadFS (DES). Claim: EXT4-class FS beats the
shared-disk file systems even with ONE client (pure DLM/metadata overhead);
OffloadFS ≈ EXT4-class (it is a non-cluster user-level FS)."""
from __future__ import annotations

from benchmarks_torch.common import check, emit
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim

N_OPS = 120_000
THREADS = 32
BS = 4096
# single-client overhead model: locks are CACHED after first acquisition
# (rare revokes → tiny DLM rate), but every op still pays the cluster-FS
# journal/metadata serialization path (single-server) — this is what the
# paper's Fig. 2 measures with one client and no conflicts.
META_CPU_PER_OP = {"ext4": 0.0, "offloadfs": 0.0, "ocfs2": 1.65e-6, "gfs2": 2.4e-6}
DLM_PER_OP = {"ext4": 0.0, "offloadfs": 0.0, "ocfs2": 0.002, "gfs2": 0.004}


def run(system: str, write: bool) -> float:
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_initiators=1)
    journal = sim.resource("journal", 1.0)  # single-server: serializes

    def worker(n):
        for _ in range(n):
            yield ("use", cl.cpu_i[0], 1.5e-6)
            m = META_CPU_PER_OP[system]
            if m:
                yield ("use", journal, m)
            d = DLM_PER_OP[system]
            if d:
                yield from cl.dlm_msgs(d)
            if write:
                yield from cl.storage_write(0, BS)
            else:
                yield from cl.storage_read(0, BS)

    per = N_OPS // THREADS
    for _ in range(THREADS):
        sim.spawn(worker(per))
    t = sim.run()
    return per * THREADS / t


def main():
    res = {}
    for wr, tag in [(False, "randread"), (True, "randwrite")]:
        for s in ["ext4", "ocfs2", "gfs2", "offloadfs"]:
            th = run(s, wr)
            res[(s, tag)] = th
            emit(f"fig2/{tag}/{s}", f"{th:.0f}", "ops_per_s")
    check(
        "fig2/ext4_beats_ocfs2_single_client",
        res[("ext4", "randwrite")] > 1.8 * res[("ocfs2", "randwrite")],
        f"{res[('ext4','randwrite')]/res[('ocfs2','randwrite')]:.2f}x",
    )
    check(
        "fig2/offloadfs_ext4_class",
        res[("offloadfs", "randwrite")] > 0.95 * res[("ext4", "randwrite")],
        "user-level non-cluster FS",
    )
    check(
        "fig2/gfs2_worse_than_ext4",
        res[("gfs2", "randread")] < res[("ext4", "randread")],
        "",
    )


if __name__ == "__main__":
    main()

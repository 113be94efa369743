# Copied from src/repro/sim/prepmodel.py; only the repro. imports are rewritten.
"""DES workload model for OffloadPrep (Figs. 7b, 9, and the Fig. 9
``n_storage`` shard-count sweeps): ML image preprocessing offloaded to the
storage node(s) / a peer initiator / both.

Near-data effect: an image offloaded to the storage node is read from NVMe
*without* crossing the fabric; only the normalized tensor returns. A peer
offload ships the raw image out and the tensor back, but peers have faster
cores and no PoseidonOS housekeeping. The pre-processing turnaround of a
minibatch is max(local share, offloaded shares) — the paper's knee at
~40–50% offload ratio (Fig. 7b).

``n_storage > 1`` models the striped plane: initiator i's corpus lives on
storage target ``i % n_storage`` (placement affinity), so its reads and
offloaded preprocessing use that target's NVMe/CPU/links only — the
AcceptAll collapse at 8 initiators (Fig. 9) is deferred as targets are
added.

``train=True`` adds the consumer: each prepped minibatch is sunk by the
initiator's trainer (``Cluster.train_consume``, a 1-server FIFO).
``pipelined=True`` is the PrepPipeline stage (Fig. 18): instead of
prep → train strictly alternating, up to ``window + queue_depth``
minibatches are in flight — remote shares execute on the targets and the
local share on spare initiator cores *while* the trainer consumes earlier
batches, so the epoch time collapses toward the bottleneck stage instead
of the sum of stages.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.sim.cluster import Cluster, TestbedSpec, TESTBED
from repro_torch.sim.des import Sim
from repro_torch.sim.kvmodel import make_policy


@dataclass
class PrepParams:
    system: str = "offloadfs"  # ext4 | ocfs2 | gfs2 | offloadfs
    n_images: int = 2048  # per instance per epoch (10 GB corpus scaled down)
    minibatch: int = 64
    threads: int = 4  # preprocessing threads per initiator (paper: 4)
    avg_image_bytes: float = 250e3
    out_tensor_bytes: float = 224 * 224 * 3 * 4
    offload_ratio: float = 1 / 3
    target: str = "storage"  # storage | peer | both
    # striped plane: initiator i's corpus + offloads on target i % n_storage
    n_storage: int = 1
    # ingestion plane (Fig. 18): charge the trainer consuming each prepped
    # minibatch; `pipelined` overlaps prep/transfer/train with up to
    # window + queue_depth minibatches in flight (the PrepPipeline stage)
    train: bool = False
    pipelined: bool = False
    window: int = 2
    queue_depth: int = 2


@dataclass
class PrepResult:
    epoch_time: float
    storage_cpu_util: float
    net_bytes: float
    offloaded: int
    rejected: int


def run_prep(params: PrepParams, *, instances: int = 1,
             policy: Optional[object] = None,
             spec: TestbedSpec = TESTBED) -> PrepResult:
    sim = Sim()
    # peers exist when offloading to peers: one extra idle initiator
    n_nodes = instances + (1 if params.target in ("peer", "both") else 0)
    n_storage = max(1, params.n_storage)
    cl = Cluster(sim, spec, n_initiators=n_nodes, n_storage=n_storage)
    peer_id = n_nodes - 1

    def tg(i: int) -> int:
        """Placement affinity: initiator i's storage target (shard)."""
        return i % n_storage

    state = {"net": 0.0, "inflight": [0] * n_storage,
             "offloaded": 0, "rejected": 0}
    # probe the BUSIEST target (see kvmodel): a saturated shard must not
    # hide behind the fleet average
    cpu_probe = lambda: max(state["inflight"]) / spec.storage_cores
    if policy is None or isinstance(policy, str):
        policy = make_policy(policy, sim, cpu_probe)
    sysname = params.system
    dlm_per_open = {"ocfs2": 1.0, "gfs2": 2.0}.get(sysname, 0.0)
    img_cpu = 1.0 / spec.preprocess_rate  # core-seconds per image
    # cluster-FS I/O path tax on the image reader: kernel FS + DLM lock
    # maintenance per file. The OFFLOADEE acquires every lock cold (the
    # initiator wrote the corpus → revoke/downgrade per file); the
    # initiator's own locks are cached. OffloadFS reads via SPDK user-level
    # (no kernel path, no locks) — the paper's 1.85× (15.19 s vs 28.18 s).
    fs_tax_remote = {"ocfs2": 1.85, "gfs2": 1.70}.get(sysname, 1.0)
    fs_tax_local = {"ocfs2": 1.15, "gfs2": 1.12}.get(sysname, 1.0)

    def local_images(i, n):
        nbytes = n * params.avg_image_bytes
        if dlm_per_open:
            yield from cl.dlm_msgs(n * dlm_per_open)
        yield from cl.storage_read(i, nbytes, target=tg(i))
        state["net"] += nbytes
        yield from cl.cpu_work(i, n * img_cpu * fs_tax_local)

    def storage_images(i, n):
        t = tg(i)
        yield from cl.rpc(i, 2048, target=t)
        state["inflight"][t] += n
        if dlm_per_open:
            yield from cl.dlm_msgs(n * dlm_per_open)
        yield ("use", cl.nvme_r_t[t], n * params.avg_image_bytes)  # near-data read
        yield from cl.cpu_work(None, n * img_cpu * fs_tax_remote, target=t)
        ret = n * params.out_tensor_bytes
        yield from cl.net_transfer(i, ret, target=t)
        state["net"] += ret
        state["inflight"][t] -= n

    def peer_images(i, n):
        t = tg(i)
        yield from cl.rpc(i, 2048, target=t)
        if dlm_per_open:
            yield from cl.dlm_msgs(n * dlm_per_open)
        nbytes = n * params.avg_image_bytes
        yield from cl.storage_read(peer_id, nbytes, target=t)  # peer pulls the images
        yield from cl.cpu_work(peer_id, n * img_cpu * fs_tax_remote)
        ret = n * params.out_tensor_bytes
        yield from cl.net_transfer(i, ret, target=t)
        state["net"] += nbytes + ret
        yield from cl.net_transfer(peer_id, 0.0, target=t)

    def prep_minibatch(i, *, train: bool):
        """Prep ONE minibatch: remote shares spawned, the local share on
        the initiator's cores, join, then (optionally) the trainer sinks
        it. One generator so the pipelined mode can run many in flight."""
        mb = params.minibatch
        n_off = int(mb * params.offload_ratio)
        if n_off and params.target != "local" and sysname != "ext4":
            admitted = policy.admit(f"init{i}")
        else:
            admitted = False
        handles = []
        n_local = mb - (n_off if admitted else 0)
        if admitted and n_off:
            state["offloaded"] += n_off
            if params.target == "storage":
                handles.append(("spawn", storage_images(i, n_off)))
            elif params.target == "peer":
                handles.append(("spawn", peer_images(i, n_off)))
            else:  # both: split the offloaded share
                handles.append(("spawn", storage_images(i, n_off // 2)))
                handles.append(("spawn", peer_images(i, n_off - n_off // 2)))
        elif n_off:
            state["rejected"] += n_off
        spawned = []
        for s in handles:
            h = yield s
            spawned.append(h)
        yield from local_images(i, n_local)
        for h in spawned:
            yield ("join", h)
        if admitted:
            policy.complete(f"init{i}")
        if train:
            yield from cl.train_consume(i, mb)

    def worker(i, n_minibatches):
        """Synchronous ingestion: prep, then train, strictly alternating."""
        for _ in range(n_minibatches):
            yield from prep_minibatch(i, train=params.train)

    def pipelined_worker(i, n_minibatches):
        """PrepPipeline ingestion: up to window + queue_depth minibatches
        in flight (issued ahead of consumption); the oldest must clear the
        trainer before the next is issued — the bounded staging queue's
        backpressure."""
        cap = max(1, params.window) + max(1, params.queue_depth)
        inflight = deque()
        for _ in range(n_minibatches):
            if len(inflight) >= cap:
                yield ("join", inflight.popleft())
            h = yield ("spawn", prep_minibatch(i, train=params.train))
            inflight.append(h)
        while inflight:
            yield ("join", inflight.popleft())

    per_thread = params.n_images // params.minibatch // params.threads
    make_worker = pipelined_worker if params.pipelined else worker
    for i in range(instances):
        policy.register(f"init{i}")
        for _ in range(params.threads):
            sim.spawn(make_worker(i, per_thread))
    makespan = sim.run()
    return PrepResult(
        epoch_time=makespan,
        storage_cpu_util=sum(
            r.utilization(makespan) for r in cl.cpu_s_t
        ) / n_storage,
        net_bytes=state["net"],
        offloaded=state["offloaded"],
        rejected=state["rejected"],
    )

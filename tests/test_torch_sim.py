"""The port's calibrated discrete-event simulator (``repro_torch.sim``)
against the JAX package's (``repro.sim``): the same params through both
give results equal field by field (``dataclasses.asdict``), exactly, at
small sizes; the port's runs are deterministic (``tests/test_io_plane.py``'s
case) and its ``Cluster`` primitives replay as ``tests/test_recovery.py``'s
do. The rates are the paper's storage testbed's (``TestbedSpec``), not a
GPU's."""
import dataclasses

import pytest

from repro_torch.sim import TESTBED, Cluster, Sim
from repro_torch.sim.kvmodel import (KVParams, MemTierParams, ServeParams, run_kv,
                                     run_memtier, run_serve)
from repro_torch.sim.prepmodel import PrepParams, run_prep

try:  # the JAX package's simulator (it imports no jax itself)
    import jax  # noqa: F401

    from repro.sim import kvmodel as JK
    from repro.sim import prepmodel as JP
    from repro.sim.cluster import TESTBED as J_TESTBED
    from repro.sim.cluster import Cluster as JCluster
    from repro.sim.des import Sim as JSim
except ImportError:
    JK = None


def _need_jax():
    if JK is None:
        pytest.skip("needs the JAX package as the reference")


KV_CASES = {
    "local": (dict(n_ops=8_000), dict(instances=1)),
    "offload_token": (dict(n_ops=8_000, offload_levels=2, offload_flush=True,
                           log_recycling=True), dict(instances=2, policy="token:2:0.5")),
    "striped_skew_rebalance": (dict(n_ops=6_000, offload_levels=2, n_storage=4,
                                    shard_skew=1.2, rebalance_at=0.5,
                                    rebalance_rate=200e6), dict(instances=4)),
    "peer_async_wal": (dict(n_ops=6_000, offload_levels=1, peer=True, async_wal=True,
                            write_ratio=0.7, l0_cache=True), dict(instances=2)),
    "ocfs2": (dict(system="ocfs2", n_ops=4_000), dict(instances=2, policy="cpu:0.8")),
}

PREP_CASES = {
    "local": (dict(n_images=256, offload_ratio=0.0), dict(instances=1)),
    "storage": (dict(n_images=256), dict(instances=2, policy="token:2:0.5")),
    "peer_pipelined": (dict(n_images=512, target="both", train=True, pipelined=True,
                            n_storage=2), dict(instances=2)),
    "gfs2": (dict(system="gfs2", n_images=256), dict(instances=1)),
}

SERVE_CASES = {
    "prefix": dict(n_requests=60, n_clients=4),
    "round_robin": dict(n_requests=60, n_clients=4, placement="round_robin"),
    "recompute": dict(n_requests=40, n_clients=2, offload=False),
}

MEMTIER_CASES = {
    "tier": dict(n_tenants=24, n_storage=8, n_clients=4, ops_per_tenant=10,
                 runs_per_tenant=8, tier_runs_per_node=32),
    "nvme_only": dict(n_tenants=24, n_storage=8, n_clients=4, ops_per_tenant=10,
                      runs_per_tenant=8, tier=False),
}


def _fields(result):
    return dataclasses.asdict(result)


@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_run_kv_equals_jax(case):
    _need_jax()
    params, kw = KV_CASES[case]
    want = JK.run_kv(JK.KVParams(**params), **kw)
    got = run_kv(KVParams(**params), **kw)
    assert got.throughput > 0 and got.latencies
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_run_prep_equals_jax(case):
    _need_jax()
    params, kw = PREP_CASES[case]
    want = JP.run_prep(JP.PrepParams(**params), **kw)
    got = run_prep(PrepParams(**params), **kw)
    assert got.epoch_time > 0
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_run_serve_equals_jax(case):
    _need_jax()
    want = JK.run_serve(JK.ServeParams(**SERVE_CASES[case]))
    got = run_serve(ServeParams(**SERVE_CASES[case]))
    assert len(got.ttft) == SERVE_CASES[case]["n_requests"]
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("case", sorted(MEMTIER_CASES))
def test_run_memtier_equals_jax(case):
    _need_jax()
    want = JK.run_memtier(JK.MemTierParams(**MEMTIER_CASES[case]))
    got = run_memtier(MemTierParams(**MEMTIER_CASES[case]))
    assert got.events > 0
    assert _fields(got) == _fields(want)


def _cluster_run(sim_cls, cluster_cls, spec):
    """Cluster primitives in one sim: a crash remount, a WAL ship to a
    second target, a striped transfer; the end time and each FIFO's
    served count."""
    sim = sim_cls()
    cl = cluster_cls(sim, spec, n_initiators=2, n_storage=2)
    sim.spawn(cl.crash_remount(0, journal_records=512))
    sim.spawn(cl.wal_ship(1, 64 * 1024, target=1))
    sim.spawn(cl.net_transfer(1, 3 * 1024 * 1024, target=0))
    t = sim.run()
    served = {f"{r}[{k}]": getattr(cl, r)[k].served
              for r in ("net_i", "net_s_t", "nvme_w_t", "posvol_t") for k in range(2)}
    return t, served, dataclasses.asdict(spec)


def test_cluster_equals_jax():
    _need_jax()
    assert _cluster_run(Sim, Cluster, TESTBED) == _cluster_run(JSim, JCluster, J_TESTBED)


def test_des_determinism():
    """Port of tests/test_io_plane.py::test_des_determinism."""
    p = KVParams(n_ops=20_000, offload_levels=2, offload_flush=True, log_recycling=True)
    r1 = run_kv(p, instances=2, policy="token:2:0.5")
    r2 = run_kv(p, instances=2, policy="token:2:0.5")
    assert r1.throughput == r2.throughput
    assert r1.makespan == r2.makespan
    assert r1.net_bytes == r2.net_bytes


def test_des_crash_remount_is_deterministic_and_metadata_only():
    """Port of tests/test_recovery.py's DES case."""
    def run(n_records):
        sim = Sim()
        cl = Cluster(sim, TESTBED)
        sim.spawn(cl.crash_remount(0, journal_records=n_records))
        return sim.run()

    t1, t2 = run(128), run(128)
    assert t1 == t2
    t_big = run(4096)
    assert t1 < t_big < 0.05


def test_des_wal_ship_off_foreground_path():
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_storage=2)
    sim.spawn(cl.wal_ship(0, 64 * 1024, target=1))
    t = sim.run()
    assert 0 < t < 1e-3
    assert cl.posvol_t[1].served == 0
    assert cl.nvme_w_t[1].served == 1

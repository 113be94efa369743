"""The port's serving plane behind its cluster front door
(``KvCacheStore(router=ClusterRouter(...))``) through target and initiator
failures, ports of ``tests/test_kv_serving.py``'s router and cold-process
cases, and the failover sequence that ``chip_smoke.py`` drives on the card
at full width, here at smoke width on bridged JAX weights:

  * router-plane roundtrip, every target killed mid-fetch (the error
    surfaces, nothing leaks), revived;
  * one target killed: quarantined by ``probe()`` within
    ``max_probe_failures`` rounds, then every fetch lands on the survivors,
    bit for bit;
  * the prefill initiator PROCESS killed mid-store (a real subprocess that
    imports only ``repro_torch``): ``standby_takeover`` fences every orphan
    and the decode standby serves the surviving entry;
  * ``generate`` cold through the router, a kill, quarantine, warm over the
    survivors, an orphaned put, takeover and a warm attach from the standby:
    every run's tokens equal the JAX package's.

Run this file directly (``python tests/test_torch_failover.py --child
<dir>``) to execute the cold-process child.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (  # noqa: E402
    AcceptAll,
    BlockDevice,
    ClusterRouter,
    FaultyFabric,
    OffloadEngine,
    OffloadFS,
    TaskOffloader,
    serve_engine,
    standby_takeover,
)
from repro_torch.core.router import LIVE, QUARANTINED  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    KvCacheStore,
    ServingCrash,
    attach_store,
    generate,
    register_kv_stubs,
)
from repro_torch.tree import tree_leaves  # noqa: E402


# ------------------------------------------------------------- harness
def small_cache(n=2048):
    return {"k": torch.arange(n, dtype=torch.float32),
            "v": torch.arange(n, dtype=torch.float32) * 0.5,
            "pos": torch.tensor([7, 9], dtype=torch.int32)}


def caches_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def wait_no_leases(fs, timeout=5.0):
    """A routed task's lease is released right after its future resolves
    (same worker thread): give that release the instant it needs."""
    deadline = time.time() + timeout
    while fs._leases and time.time() < deadline:
        time.sleep(0.002)
    assert not fs._leases


def build_plane(n_targets=3, *, shards=4, seed=0, num_blocks=1 << 16):
    dev = BlockDevice(num_blocks=num_blocks)
    fs = OffloadFS(dev, node="init0", shards=shards)
    fabric = FaultyFabric(seed=seed)
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", enable_cache=False)
        register_kv_stubs(eng)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    return dev, fs, fabric, engines, off


def probe_until_quarantined(router, name, limit):
    """``router.probe()`` rounds until ``name`` is quarantined; the count."""
    rounds = 0
    while router.members[name].state != QUARANTINED and rounds < limit:
        router.probe()
        rounds += 1
    assert router.members[name].state == QUARANTINED
    return rounds


# --------------------------------------------------------- wire planes
def test_router_plane_roundtrip_and_midfetch_kill():
    dev, fs, fabric, engines, off = build_plane()
    router = ClusterRouter(off, max_probe_failures=2)
    store = KvCacheStore(fs, router=router, chunk_blocks=1, device="cpu")
    cache = small_cache()
    store.put([2, 7, 1, 8], cache)
    assert caches_equal(cache, store.fetch([2, 7, 1, 8]))
    wait_no_leases(fs)
    # every target dies mid-fetch: the error surfaces, nothing leaks
    for eng in engines:
        fabric.kill(eng.node)
    with pytest.raises(Exception):
        store.fetch([2, 7, 1, 8])
    wait_no_leases(fs)
    for eng in engines:
        fabric.revive(eng.node)
    assert caches_equal(cache, store.fetch([2, 7, 1, 8]))
    wait_no_leases(fs)


def test_one_target_killed_quarantined_then_fetch_over_survivors_bit_equal():
    dev, fs, fabric, engines, off = build_plane(4, seed=3)
    router = ClusterRouter(off, max_probe_failures=2)
    store = KvCacheStore(fs, router=router, chunk_blocks=1, device="cpu")
    g = torch.Generator("cpu").manual_seed(0)
    cache = {"k": torch.randn((3, 7000), generator=g).to(torch.bfloat16),
             "v": torch.randn((3, 7000), generator=g),
             "pos": torch.tensor([5, 6], dtype=torch.int32)}
    store.put([4, 4, 2], cache)
    assert caches_equal(cache, store.fetch([4, 4, 2]))
    wait_no_leases(fs)
    fabric.kill("storage1")
    # least-outstanding still feeds the dead target until a probe says so
    with pytest.raises(Exception, match="dead"):
        store.fetch([4, 4, 2])
    wait_no_leases(fs)
    assert probe_until_quarantined(router, "storage1", 10) <= router.max_probe_failures
    assert "storage1" not in off.targets
    assert router.live_members() == ["storage0", "storage2", "storage3"]
    served = {e.node: e.tasks_run for e in engines}
    for _ in range(2):
        assert caches_equal(cache, store.fetch([4, 4, 2]))
        wait_no_leases(fs)
    assert engines[1].tasks_run == served["storage1"]  # nothing reached it
    assert sum(e.tasks_run for e in engines) - sum(served.values()) == \
        2 * store.entries()[0].nchunks
    assert all(e.tasks_run > served[e.node] for e in engines if e.node != "storage1")
    assert store.stats.fetches == 3 and router.members["storage0"].state == LIVE


# ------------------------------------------------- cold-process child
def _run_serving_child(tmpdir: str) -> None:
    dev = BlockDevice(num_blocks=1 << 15)
    fs = OffloadFS(dev, node="init0", shards=2)
    store = KvCacheStore(fs, chunk_blocks=2, device="cpu")
    cache = {"k": torch.arange(2048, dtype=torch.float32)}
    good = store.put([1, 2, 3], cache)
    try:
        store.put([5, 5, 5], cache, failpoint="mid_put")
    except ServingCrash:
        pass
    orphans = sorted(ls.task_id for ls in fs._leases.values())
    dev.save(os.path.join(tmpdir, "volume.bin"))
    with open(os.path.join(tmpdir, "expect.json"), "w") as f:
        json.dump({"orphans": orphans, "good_shard": good["shard"],
                   "foreign": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "repro"))}, f)
    os._exit(1)  # die mid-store: no release, no cleanup, no atexit


def test_cold_process_serving_failover(tmp_path):
    """The prefill initiator PROCESS is killed mid-store, a decode standby
    (this process) loads the volume, fences 100% of the orphans, and serves
    the surviving entry."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    with open(tmp_path / "expect.json") as f:
        expect = json.load(f)
    assert expect["foreign"] == []  # the child ran on the port alone
    assert expect["orphans"], "child must die with a lease outstanding"
    dev = BlockDevice.load(str(tmp_path / "volume.bin"))
    fs, fenced = standby_takeover(dev, node="decode0", shards=2)
    assert sorted(fenced) == expect["orphans"]  # 100% orphan fencing
    assert not fs._leases
    store = attach_store(fs, chunk_blocks=2, device="cpu")
    got = store.fetch([1, 2, 3])
    assert got is not None and torch.equal(got["k"], torch.arange(2048, dtype=torch.float32))
    assert not store.contains([5, 5, 5])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _run_serving_child(sys.argv[2])
    else:  # pragma: no cover - convenience direct run
        sys.exit(pytest.main([__file__, "-q"]))


# ------------------------------------------- generate through the failover
def test_generate_through_kill_quarantine_takeover_matches_jax():
    """The failover sequence of ``chip_smoke.py`` at smoke width: cold
    through the router, one engine killed (the warm run meets it and
    raises), quarantine, warm over the 3 survivors, an orphaned put of a
    second prompt's cache, ``standby_takeover`` and a warm attach from the
    standby. Tokens equal the JAX package's at every step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models.config import get_config as jax_config
    from repro.models.model import build_model as jax_model
    from repro.serve import generate as jax_generate
    from repro_torch.models.bridge import from_jax_params
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    jcfg = jax_config("qwen3-1.7b:smoke").with_(compute_dtype=jnp.float32)
    tcfg = get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32)
    jm, tm = jax_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompt, prompt2 = (rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
                       for _ in range(2))
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), steps=6, max_len=48))

    dev, fs, fabric, engines, off = build_plane(4, num_blocks=1 << 15)
    router = ClusterRouter(off, max_probe_failures=2)
    store = KvCacheStore(fs, router=router, chunk_blocks=1, device="cpu")

    def gen(kv_store, p=prompt):
        return generate(tm, tp, torch.from_numpy(p), steps=6, max_len=48,
                        kv_store=kv_store).numpy()

    assert np.array_equal(gen(store), want)  # cold: prefill, put, fetch, decode
    wait_no_leases(fs)
    fabric.kill("storage2")
    with pytest.raises(Exception, match="dead"):
        gen(store)  # warm: the fetch meets the dead target
    wait_no_leases(fs)
    assert probe_until_quarantined(router, "storage2", 10) <= 2
    assert np.array_equal(gen(store), want)  # warm over the 3 survivors
    wait_no_leases(fs)
    assert store.stats.puts == 1 and store.stats.fetches == 2

    # the prefill initiator dies mid-put of a second prompt's cache
    _, cache2, _ = tm.apply(tp, {"tokens": torch.from_numpy(prompt2)}, mode="prefill",
                            max_len=48)
    local = KvCacheStore(fs, chunk_blocks=1, device="cpu")
    with pytest.raises(ServingCrash):
        local.put(prompt2, cache2, failpoint="mid_put")
    orphans = sorted(ls.task_id for ls in fs._leases.values())
    assert len(orphans) == 1
    fs2, fenced = standby_takeover(dev, node="decode0", shards=4)
    assert sorted(fenced) == orphans and not fs2._leases
    store2 = attach_store(fs2, chunk_blocks=1, device="cpu")
    assert store2.contains(prompt) and not store2.contains(prompt2)
    assert np.array_equal(gen(store2), want)  # warm from the standby, no prefill
    assert store2.stats.puts == 0 and store2.stats.fetches == 1

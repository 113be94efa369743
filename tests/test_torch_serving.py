"""The port's serving plane (``repro_torch.serve``) against ``repro.serve``.

  * ``generate`` gives token-for-token the JAX package's output on the same
    bridged weights (f32 compute): in memory, cold and warm through a local
    store, and cold and warm through an ``off=`` plane of 3 storage engines,
    where chunks arrive out of order and the merge path runs;
  * cache packing round-trips every leaf bit for bit (bf16 as uint16 bits)
    and the blob unpickles without torch;
  * the mid-put crash catalog and LRU/TTL eviction, on the port's store.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.serve import generate as jax_generate
from repro_torch.core import (AcceptAll, BlockDevice, FaultyFabric, OffloadEngine,
                              OffloadFS, TaskOffloader, serve_engine)
from repro_torch.kernels import build
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.serve import (KvCacheStore, ServingCrash, attach_store, generate,
                               register_kv_stubs)
from repro_torch.serve.kvstore import _pack_cache, _unpack_cache
from repro_torch.tree import tree_leaves


# ------------------------------------------------------------- harness
def small_cache(n=2048):
    return {"k": torch.arange(n, dtype=torch.float32),
            "v": torch.arange(n, dtype=torch.float32) * 0.5,
            "pos": torch.tensor([7, 9], dtype=torch.int32)}


def caches_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def local_store(**kw):
    dev = BlockDevice(num_blocks=1 << 15)
    fs = OffloadFS(dev, node="init0", shards=2)
    return dev, fs, KvCacheStore(fs, device="cpu", **kw)


def build_plane(n_targets=3, *, shards=4, seed=0):
    dev = BlockDevice(num_blocks=1 << 16)
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
    return dev, fs, off


# ----------------------------------------------------------- generate
@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_config("qwen3-1.7b:smoke").with_(compute_dtype=jnp.float32)
    tcfg = get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32)
    jm = jax_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = build_model(tcfg)
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), steps=6, max_len=24))
    return tm, tp, torch.from_numpy(prompt), want


def _gen(bridged, store=None):
    tm, tp, prompt, _ = bridged
    return generate(tm, tp, prompt, steps=6, max_len=24, kv_store=store).numpy()


def test_generate_in_memory_matches_jax(bridged):
    assert np.array_equal(_gen(bridged), bridged[3])


def test_generate_local_store_cold_warm_match_jax(bridged):
    _, fs, store = local_store()
    cold = _gen(bridged, store)  # prefill → put → fetch → decode
    assert store.stats.puts == 1 and store.stats.fetches == 1
    warm = _gen(bridged, store)  # exact prompt stored: prefill skipped
    assert store.stats.puts == 1 and store.stats.fetches == 2
    assert np.array_equal(cold, bridged[3]) and np.array_equal(warm, bridged[3])
    assert not fs._leases


def test_generate_offload_plane_cold_warm_match_jax(bridged):
    _, fs, off = build_plane(3)
    store = KvCacheStore(fs, off=off, chunk_blocks=1, device="cpu")
    launches = build.LAUNCHES["merge_runs"]
    cold = _gen(bridged, store)
    warm = _gen(bridged, store)
    assert np.array_equal(cold, bridged[3]) and np.array_equal(warm, bridged[3])
    assert store.stats.fetches == 2
    assert store.stats.merge_runs > store.stats.fetches  # out of order: merged
    assert build.LAUNCHES["merge_runs"] == launches  # CPU tensors: the plain merge


def test_assemble_restores_chunk_order():
    _, _, store = local_store()
    arrivals = [(0, b"a"), (2, b"c"), (4, b"e"), (1, b"b"), (3, b"d"), (5, b"f")]
    assert store._assemble(arrivals) == b"abcdef"
    assert store.stats.merge_runs == 2


# ------------------------------------------------------------ packing
def test_pack_unpack_bit_exact_with_bf16(tmp_path):
    g = torch.Generator("cpu").manual_seed(0)
    cache = {"stack": {"scan": ({"kv": {
        "k": torch.randn((2, 3, 5, 2, 4), generator=g).to(torch.bfloat16),
        "v": torch.randn((2, 3, 5, 2, 4), generator=g).to(torch.bfloat16),
        "len": torch.tensor([[3, 3], [3, 3]], dtype=torch.int32)}},)},
        "pos": torch.tensor([3, 3], dtype=torch.int32),
        "f32": torch.tensor([np.nan, -0.0, np.inf], dtype=torch.float32)}
    blob = _pack_cache(cache)
    got = _unpack_cache(blob, "cpu")
    for a, b in zip(tree_leaves(cache), tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))
    # the blob holds numpy arrays and builtins only: no torch to unpickle it
    path = tmp_path / "blob.pkl"
    path.write_bytes(blob)
    code = ("import sys, pickle; sys.modules['torch'] = None; "
            f"t = pickle.loads(open({str(path)!r}, 'rb').read()); "
            "kv = t['stack']['scan'][0]['kv']; "
            "assert kv['k']['bfloat16_bits'].dtype.name == 'uint16'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------ crash fencing
def test_mid_put_crash_then_takeover_fences_and_serves():
    dev, fs, store = local_store(chunk_blocks=2)
    cache = small_cache()
    store.put([1, 2, 3], cache)
    with pytest.raises(ServingCrash):
        store.put([6, 6, 6], cache, failpoint="mid_put")
    assert len(fs._leases) == 1  # the orphan the crash left behind
    # standby takeover: remount + journal replay + orphan fencing
    fs2 = OffloadFS.mount(dev, node="standby0", shards=2)
    fenced = fs2.reclaim_orphans()
    assert len(fenced) == 1 and not fs2._leases
    store2 = attach_store(fs2, chunk_blocks=2, device="cpu")
    assert caches_equal(cache, store2.fetch([1, 2, 3]))
    assert not store2.contains([6, 6, 6])  # half-store never committed


def test_offloader_plane_roundtrip():
    _, fs, off = build_plane()
    store = KvCacheStore(fs, off=off, chunk_blocks=1, device="cpu")
    cache = small_cache()
    store.put([3, 1, 4, 1, 5], cache)
    assert caches_equal(cache, store.fetch([3, 1, 4, 1, 5]))
    assert store.stats.fetch_chunks > 1


def test_fetch_whole_when_callbacks_lag_their_futures(monkeypatch):
    """A future wakes ``result()`` before it runs its done callbacks; a
    fetch that waited on every chunk still gets every chunk's bytes."""
    import time

    from repro_torch.core import rpc

    def lagging_finish(self):
        self._event.set()
        time.sleep(0.01)  # the waiter runs on before the callbacks
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    _, fs, off = build_plane()
    store = KvCacheStore(fs, off=off, chunk_blocks=1, device="cpu")
    cache = small_cache()
    store.put([2, 7, 1, 8], cache)
    monkeypatch.setattr(rpc.RpcFuture, "_finish", lagging_finish)
    assert caches_equal(cache, store.fetch([2, 7, 1, 8]))
    assert store.stats.fetch_bytes == store.stats.put_bytes


def test_fetch_shorter_than_the_put_names_the_shard(monkeypatch):
    _, fs, off = build_plane()
    store = KvCacheStore(fs, off=off, chunk_blocks=1, device="cpu")
    store.put([2, 7, 1, 8], small_cache())
    monkeypatch.setattr(store, "_assemble", lambda arrivals: b"\0" * 100)
    with pytest.raises(IOError, match=r"from shard \d+ .*100 bytes of the \d+ put"):
        store.fetch([2, 7, 1, 8])


# ---------------------------------------------------- LRU/TTL eviction
def test_lru_eviction_caps_bytes_and_recomputes_identical():
    clock = [0.0]
    dev = BlockDevice(num_blocks=1 << 15)
    fs = OffloadFS(dev, node="init0", shards=2)
    cache = small_cache()
    one = KvCacheStore(fs, root="probe", chunk_blocks=2, device="cpu").put(
        [0, 1], cache)["bytes"]
    store = KvCacheStore(fs, root="kv", chunk_blocks=2, device="cpu",
                         capacity_bytes=int(one * 2.5), clock=lambda: clock[0])
    for i in range(4):
        clock[0] = float(i)
        store.put([i, i + 1], cache)
    assert store.stored_bytes() <= int(one * 2.5)
    assert store.stats.evictions >= 1
    assert store.fetch([0, 1]) is None  # LRU victim misses
    assert caches_equal(cache, store.fetch([3, 4]))
    clock[0] = 10.0
    store.put([0, 1], cache)
    assert caches_equal(cache, store.fetch([0, 1]))
    assert not fs._leases


def test_ttl_expiry_and_fetch_refreshes_lru():
    clock = [0.0]
    _, fs, store = local_store(chunk_blocks=2, ttl_s=5.0, clock=lambda: clock[0])
    cache = small_cache()
    store.put([1, 1], cache)
    clock[0] = 4.0
    store.put([2, 2], cache)
    assert caches_equal(cache, store.fetch([1, 1]))  # touch refreshes LRU
    clock[0] = 8.0
    assert store.evict() == []
    clock[0] = 9.5
    victims = store.evict()
    assert len(victims) == 2 and store.stats.expirations == 2
    assert store.fetch([1, 1]) is None and store.fetch([2, 2]) is None
    assert not store.entries() and not fs._leases


def test_eviction_skips_leased_entries():
    clock = [0.0]
    _, fs, store = local_store(chunk_blocks=2, ttl_s=1.0, clock=lambda: clock[0])
    cache = small_cache()
    store.put([5, 5], cache)
    entry = store.entries()[0]
    base = entry.replicas[min(entry.replicas)]
    clock[0] = 100.0
    with fs.read_lease(f"{base}/c0"):
        assert store.evict() == []  # a decode stream still holds it
        assert store.stats.evict_skipped_leased >= 1
        assert caches_equal(cache, store.fetch([5, 5]))
    clock[0] = 200.0
    assert store.evict() == [entry.key]
    assert not fs._leases


def test_first_token_is_a_tensor_on_the_store_device():
    _, _, store = local_store()
    store.put([4, 2], small_cache(16), first_token=torch.tensor([[7], [9]],
                                                                dtype=torch.int32))
    tok = store.first_token(torch.tensor([4, 2]))
    assert isinstance(tok, torch.Tensor) and tok.device.type == "cpu"
    assert tok.tolist() == [[7], [9]]

# Port of benchmarks/fig20_kv_serving.py: the model, prefill and KV store are repro_torch's.
"""Fig. 20 — KV-cache offload serving plane: disaggregated prefill →
decode over OffloadFS (this repo's extension).

The paper offloads *storage-side compute*; this figure turns the same
lease machinery into an inference serving plane. A prefill initiator
stores a request's KV cache into OffloadFS under a journaled write
lease; decode initiators attach read leases and stream it back, so a
prompt shared across sessions is prefilled ONCE per stripe instead of
once per request. Four measurements:

  A. TTFT, offloaded attach vs recompute (functional, wall-clock): a
     real (reduced) model on a 4-target offload plane. Warm path =
     fetch the stored cache + decode one token; recompute path =
     prefill + decode one token. Decoded tokens must be byte-identical
     between the in-memory and offloaded cache paths. Claims:
     **offloaded TTFT ≥ 2× faster than recompute at 4 targets**, tokens
     identical.

  B. Cache-hit rate vs placement policy (functional): zipf-popular
     prompt-prefix families stored through ``prefix`` / ``round_robin``
     / ``random`` placement. Prefix-aware placement hashes a request
     onto the stripe of its longest stored prefix, so a family re-finds
     its replica; round-robin scatters the family and re-stores it
     almost every time. Claims: **prefix-aware dedupe-hit rate ≥ 1.3×
     round-robin**, and prefix-aware moves strictly fewer store bytes.

  C. Crash fencing (functional): a prefill initiator dies mid-store
     (``ServingCrash`` through the scoped ``write_lease`` context
     manager — BaseException, so the lease survives as a journaled
     orphan); separately a target dies mid-fetch on the routed plane.
     Claims: **100% of orphaned leases fenced on takeover, zero leases
     leaked after the mid-fetch kill**, surviving entries decode
     byte-exact on the standby.

  D. Serving economics (DES): the calibrated testbed model sweeps
     ``n_storage`` ∈ {1,2,4,8} and the three placement policies under
     zipf session traffic. Claims: offloaded mean TTFT ≥ 2× faster than
     recompute at 4 targets, prefix-aware hit rate strictly above
     round-robin.

Run ``--smoke`` for the CI-sized subset (smaller model, fewer requests,
claims unchanged). The model, its params, the prompts and every fetched
cache live on the figures' torch device (``--device``, default the card).

``--full-width`` runs Part A alone at qwen3-1.7b's published config (28
layers, d_model 2,048, a vocabulary of 151,936): batch 2, a 4,096-token
prompt (past the flash threshold, so the prefill runs the flash kernel)
and 1 MiB chunks (``chunk_blocks`` 256). fig20's own volume of 2^16
blocks (256 MiB) cannot hold the 943 MB cache, so this mode runs on the
serving main path's volume, 2^19 blocks on 4 stripes behind 4 engines;
its rows say so. The 2× claim is the same.
"""
from __future__ import annotations

import sys
import time

import torch

from benchmarks_torch.common import check, device, emit, sync
from repro_torch.core import (
    BLOCK_SIZE,
    BlockDevice,
    FaultyFabric,
    OffloadFS,
    TaskOffloader,
    standby_takeover,
)
from repro_torch.core.admission import AcceptAll
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.offloader import serve_engine
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.kvstore import KvCacheStore, ServingCrash, attach_store, register_kv_stubs
from repro_torch.serve.step import make_prefill_step
from repro_torch.sim.kvmodel import ServeParams, run_serve
from repro_torch.tree import tree_leaves

N_TARGETS = 4
SEED = 11
# --full-width: qwen3-1.7b's published config at the serving main path's
# shape, on the main path's volume (fig20's 2^16 blocks hold 256 MiB)
FULL_WIDTH = {"arch": "qwen3-1.7b", "batch": 2, "prompt": 4096, "chunk_blocks": 256,
              "num_blocks": 1 << 19}


def build_plane(n_targets: int = N_TARGETS, *, shards: int = N_TARGETS,
                enable_cache: bool = False, num_blocks: int = 1 << 16):
    dev = BlockDevice(num_blocks=num_blocks)
    fs = OffloadFS(dev, node="init0", shards=shards)
    fabric = FaultyFabric(seed=SEED)
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", enable_cache=enable_cache)
        register_kv_stubs(eng)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    return dev, fs, fabric, engines, off


def tiny_model(smoke: bool):
    d = 128 if smoke else 256
    cfg = get_config("qwen3-1.7b:smoke").with_(
        num_layers=4, d_model=d, num_heads=8, num_kv_heads=4,
        d_ff=2 * d, vocab_size=512, head_dim=d // 8)
    return build_model(cfg), cfg


def _host_bits(t: torch.Tensor) -> torch.Tensor:
    """A host copy whose floats are their bit patterns (bf16 as int16), so
    that equality is bit for bit."""
    t = t.detach().cpu()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def same_leaves(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(_host_bits(x), _host_bits(y))
        for x, y in zip(la, lb))


def prefill_first_token(model, params, prompt):
    """One prefill and its greedy first token, ended in a device sync:
    the recompute path. Returns (token (B,), cache)."""
    prefill = make_prefill_step(model, prompt.shape[1] + 16)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    sync(prompt.device)
    return tok, cache


# ------------------------------------------------------------------ A
def attach_vs_recompute(model, params, prompt, store, reps: int) -> dict:
    """Part A's timing. ``store`` already holds ``prompt``'s cache and first
    token; each path runs once to warm, then ``reps`` times timed. Returns
    the mean ms of each path, their ratio, the recomputed first token, and
    the last fetched cache and first token."""
    prefill_first_token(model, params, prompt)
    store.fetch(prompt)
    t0 = time.perf_counter()
    for _ in range(reps):
        tok_ref, _ = prefill_first_token(model, params, prompt)
    t_recompute = (time.perf_counter() - t0) / reps

    t0 = time.perf_counter()
    for _ in range(reps):
        cache_off = store.fetch(prompt)
        tok_off = store.first_token(prompt)
        sync(prompt.device)
    t_attach = (time.perf_counter() - t0) / reps

    return {"recompute_ms": t_recompute * 1e3, "attach_ms": t_attach * 1e3,
            "ratio": t_recompute / t_attach if t_attach else 0.0,
            "token": tok_ref, "fetched": cache_off, "first_token": tok_off}


def identical(put_cache, res: dict) -> bool:
    """The fetched cache equals the one put, and the stored first token the
    recomputed one, bit for bit."""
    same_tok = torch.equal(res["token"].cpu().reshape(-1),
                           res["first_token"].cpu().reshape(-1).to(torch.int32))
    return same_leaves(put_cache, res["fetched"]) and same_tok


def report_part_a(res: dict, prefix: str, where: str, ratio_fmt: str = ".1f") -> None:
    ratio = format(res["ratio"], ratio_fmt)
    emit(f"{prefix}/ttft_ms",
         f"recompute={res['recompute_ms']:.1f};attach={res['attach_ms']:.1f}",
         f"{where}, {ratio}x")
    check(f"{prefix}/attach_beats_recompute_2x", res["ratio"] >= 2.0,
          f"offloaded attach {ratio}x faster than recompute (floor 2x)")
    check(f"{prefix}/offloaded_cache_identical", res["identical"],
          "fetched cache + first token byte-identical to the in-memory path")


def ttft_vs_recompute(smoke: bool) -> None:
    dev = device()
    model, cfg = tiny_model(smoke)
    params = model.init(torch.Generator(dev).manual_seed(0))
    B, S = (2, 128) if smoke else (4, 256)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    _, fs, fabric, engines, off = build_plane()
    store = KvCacheStore(fs, off=off, chunk_blocks=32, device=dev)
    tok, cache = prefill_first_token(model, params, prompt)
    store.put(prompt, cache, first_token=tok)
    res = attach_vs_recompute(model, params, prompt, store, 2 if smoke else 3)
    res["identical"] = identical(cache, res)
    report_part_a(res, "fig20", f"{N_TARGETS}-target plane, B={B} S={S}")


def full_width(arch: str = FULL_WIDTH["arch"], batch: int = FULL_WIDTH["batch"],
               prompt_len: int = FULL_WIDTH["prompt"], reps: int = 3) -> dict:
    """Part A at ``arch``'s own widths and depth (random weights from seed
    0, prompts from seed 1) on the main path's volume; prints its rows and
    returns Part A's result. The tests run it at ``qwen3-1.7b:smoke``."""
    dev = device()
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
                           device=dev, generator=torch.Generator(dev).manual_seed(1))
    _, fs, fabric, engines, off = build_plane(num_blocks=FULL_WIDTH["num_blocks"],
                                              enable_cache=True)
    store = KvCacheStore(fs, off=off, chunk_blocks=FULL_WIDTH["chunk_blocks"], device=dev)
    tok, cache = prefill_first_token(model, params, prompt)
    store.put(prompt, cache, first_token=tok)
    res = attach_vs_recompute(model, params, prompt, store, reps)
    res["identical"] = identical(cache, res)
    emit_full_width(res, arch, cfg, batch, prompt_len, store)
    return res


def emit_full_width(res: dict, arch: str, cfg, batch: int, prompt_len: int, store) -> None:
    """The full-width rows, with the config and the plane they ran on."""
    entry = store.entries()[0]
    emit("fig20/full_width/plane",
         f"blocks={store.fs.dev.num_blocks};stripes={store.shards};"
         f"chunk_blocks={store.chunk_bytes // BLOCK_SIZE}",
         f"the serving main path's volume in place of fig20's 2^16 blocks "
         f"(a {entry.size} B cache in {entry.nchunks} chunks)")
    report_part_a(res, "fig20/full_width",
                  f"{arch} ({cfg.num_layers} layers, d_model {cfg.d_model}), "
                  f"{N_TARGETS}-target plane, B={batch} S={prompt_len}", ratio_fmt=".4f")


# ------------------------------------------------------------------ B
def placement_hit_rates(smoke: bool) -> None:
    n_requests = 40 if smoke else 120
    n_families = 6 if smoke else 24
    dev = device()
    cache = {"kv": torch.arange(4096, dtype=torch.float32, device=dev)}

    zipf_state = [7]  # xorshift PRNG word, advanced per call

    def zipf_family(i: int) -> int:
        state = zipf_state
        x = state[0]
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        state[0] = x
        u = x / 0xFFFFFFFF
        acc, tot = 0.0, sum((k + 1) ** -1.1 for k in range(n_families))
        for fam in range(n_families):
            acc += (fam + 1) ** -1.1 / tot
            if u <= acc:
                return fam
        return n_families - 1

    families = [zipf_family(i) for i in range(n_requests)]
    rates, bytes_stored = {}, {}
    for policy in ("prefix", "round_robin", "random"):
        bdev = BlockDevice(num_blocks=1 << 16)
        fs = OffloadFS(bdev, node="init0", shards=N_TARGETS)
        store = KvCacheStore(fs, placement=policy, chunk_blocks=4, device=dev)
        for fam in families:
            tokens = [fam * 1000 + t for t in range(8)]
            store.put(tokens, cache)
        rates[policy] = store.stats.dedupe_hits / store.stats.puts
        bytes_stored[policy] = store.stats.put_bytes

    emit("fig20/dedupe_hit_rate",
         ";".join(f"{p}={rates[p]:.3f}" for p in rates),
         f"{n_requests} zipf requests over {n_families} prefix families, "
         f"{N_TARGETS} stripes")
    lift = rates["prefix"] / rates["round_robin"] if rates["round_robin"] else float("inf")
    check("fig20/prefix_beats_round_robin",
          rates["prefix"] >= 1.3 * rates["round_robin"],
          f"prefix {rates['prefix']:.3f} vs round_robin "
          f"{rates['round_robin']:.3f} ({lift:.2f}x, floor 1.3x)")
    check("fig20/prefix_moves_fewest_bytes",
          bytes_stored["prefix"] < bytes_stored["round_robin"]
          and bytes_stored["prefix"] < bytes_stored["random"],
          f"store bytes prefix={bytes_stored['prefix']} "
          f"rr={bytes_stored['round_robin']} rnd={bytes_stored['random']}")


# ------------------------------------------------------------------ C
def crash_fencing(smoke: bool) -> None:
    # C1: prefill initiator dies mid-store (local plane, scoped lease)
    tdev = device()
    dev = BlockDevice(num_blocks=1 << 15)
    fs = OffloadFS(dev, node="init0", shards=2)
    store = KvCacheStore(fs, chunk_blocks=2, device=tdev)
    cache = {"kv": torch.arange(2048, dtype=torch.float32, device=tdev)}
    store.put([1, 2, 3], cache)
    try:
        store.put([7, 7, 7], cache, failpoint="mid_put")
        raise AssertionError("failpoint did not fire")
    except ServingCrash:
        pass
    orphans = len(fs._leases)
    fs2, fenced = standby_takeover(dev, shards=2)
    check("fig20/takeover_fences_all_orphans",
          orphans >= 1 and len(fenced) == orphans and not fs2._leases,
          f"{len(fenced)}/{orphans} orphaned write leases fenced")
    store2 = attach_store(fs2, chunk_blocks=2, device=tdev)
    got = store2.fetch([1, 2, 3])
    ok = got is not None and same_leaves(got, cache)
    check("fig20/survivor_decodes_on_standby",
          ok and not store2.contains([7, 7, 7]),
          "completed entry byte-exact on the standby; "
          "half-stored entry absent")

    # C2: a target dies mid-fetch on the routed plane — the wire error
    # surfaces, the lease is released, nothing leaks
    dev, fs, fabric, engines, off = build_plane(2, shards=2)
    store3 = KvCacheStore(fs, off=off, chunk_blocks=2, device=tdev)
    store3.put([9, 9], cache)
    for eng in engines:
        fabric.kill(eng.node)
    errors = 0
    try:
        store3.fetch([9, 9])
    except Exception:  # noqa: BLE001 - injected target death
        errors += 1
    for eng in engines:
        fabric.revive(eng.node)
    deadline = time.time() + 5.0
    while fs._leases and time.time() < deadline:
        time.sleep(0.002)
    check("fig20/midfetch_kill_leaks_nothing",
          errors >= 1 and not fs._leases,
          f"targets killed mid-fetch (errors={errors}): "
          f"{len(fs._leases)} leases outstanding")


# ------------------------------------------------------------------ D
def des_serving_economics(smoke: bool) -> None:
    n_req = 160 if smoke else 400
    ratios = {}
    for ns in (1, 2, 4, 8):
        off = run_serve(ServeParams(n_requests=n_req, n_storage=ns))
        rec = run_serve(ServeParams(n_requests=n_req, n_storage=ns,
                                    offload=False))
        ratios[ns] = rec.mean_ttft / off.mean_ttft if off.mean_ttft else 0.0
    emit("fig20/des/ttft_ratio",
         ";".join(f"n{ns}={r:.2f}" for ns, r in ratios.items()),
         "recompute/offload mean-TTFT ratio vs storage targets")
    check("fig20/des_attach_2x_at_4_targets", ratios[4] >= 2.0,
          f"{ratios[4]:.2f}x at 4 targets (floor 2x)")

    hits = {p: run_serve(ServeParams(n_requests=n_req, placement=p)).hit_rate
            for p in ("prefix", "round_robin", "random")}
    emit("fig20/des/hit_rate",
         ";".join(f"{p}={h:.3f}" for p, h in hits.items()),
         "attach-hit rate by placement policy, 4 stripes")
    check("fig20/des_prefix_beats_round_robin",
          hits["prefix"] > hits["round_robin"],
          f"prefix {hits['prefix']:.3f} vs round_robin "
          f"{hits['round_robin']:.3f}")


def main():
    if "--full-width" in sys.argv:
        full_width()
        return
    smoke = "--smoke" in sys.argv
    ttft_vs_recompute(smoke)
    placement_hit_rates(smoke)
    crash_fencing(smoke)
    des_serving_economics(smoke)


if __name__ == "__main__":
    main()

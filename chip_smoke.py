#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

  1. device  — the card's name and count (no CUDA device: the script fails);
  2. build   — nvcc for every ``src/repro_torch/kernels/csrc/*.cu``, all
               started together, with ptxas registers / shared memory;
  3. kernels — each kernel against its plain PyTorch version on the card,
               with its time, the plain version's and a library yardstick's;
  4. small   — a smoke-width model on the card against the same model on
               the CPU (plain versions) at a prompt that takes the flash path;
  5. main    — qwen3-1.7b at full width (random weights from a seed) through
               ``serve.generate``: cold (prefill, put, fetch, decode) and
               warm (attach, no prefill) through a KV-cache store on an
               OffloadFS volume behind 4 storage engines, and in memory;
               tokens must agree, every fetched cache must equal the
               prefill's bit for bit, and the path must launch both kernels.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
# HBM bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# main-path shape: qwen3-1.7b at full width, two 4,096-token prompts
BATCH, PROMPT, STEPS = 2, 4096, 16
MAX_LEN = PROMPT + STEPS


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` warm calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def merge_library(a_k, a_v, b_k, b_v):
    """The merge's library yardstick (never called by the port): a stable
    sort of the concatenated keys, then a gather of the payloads."""
    import torch

    keys, order = torch.sort(torch.cat([a_k, b_k]), stable=True)
    return keys, torch.cat([a_v, b_v])[order]


def merge_errors(got, want, what: str) -> dict:
    """A merge's (keys, payloads) against the stable plain merge's, which
    it must equal exactly: the largest key difference and the number of
    payloads that differ. Raises unless both are 0."""
    import torch

    (gk, gv), (wk, wv) = got, want
    torch.cuda.synchronize()
    check(gk.shape == wk.shape and gv.shape == wv.shape, f"{what}: lengths differ")
    diff = torch.where(gk == wk, 0.0, (gk.double() - wk.double()).abs())  # inf == inf
    errs = {"max_abs_err": diff.max().item() if diff.numel() else 0.0,
            "payload_mismatches": int((gv != wv).sum().item())}
    check(errs["max_abs_err"] == 0.0 and errs["payload_mismatches"] == 0,
          f"{what}: differs from the stable plain merge: {errs}")
    return errs


def bound(flops: float, nbytes: float, peak_ops: float):
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------ phase 1-2
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["flash_attention", "merge"])
    emit("build", seconds=time.perf_counter() - t0, kernels=build.BUILD_LOG)


# ------------------------------------------------------------ phase 3
def _flash_inputs(B, S, KV, G, D, dtype, seed):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn((B, S, KV, G, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def _flash_work(q, k, causal):
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * KV * G * pairs * D
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())  # q,o + k,v
    return flops, nbytes


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions exact
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    cases = [  # name, B, S, KV, G, D, dtype, causal, softcap
        ("prefill_bf16", BATCH, PROMPT, 8, 2, 128, torch.bfloat16, True, 0.0),
        ("small_f32", 2, 256, 2, 2, 64, torch.float32, True, 0.0),
        ("softcap_f32", 1, 256, 2, 4, 128, torch.float32, True, 30.0),
        ("ragged_bf16", 2, 1000, 2, 4, 64, torch.bfloat16, True, 0.0),
        ("noncausal_f32", 1, 333, 1, 2, 128, torch.float32, False, 0.0),
    ]

    def flash_case(name, B, S, KV, G, D, dt, causal, cap):
        q, k, v = _flash_inputs(B, S, KV, G, D, dt, seed=len(results))
        out = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
        # against the plain version in f32 on the same values
        errs, ok = ref.flash_attention_check(out, q, k, v, causal=causal, softcap=cap)
        tol = ({"atol": ref.FLASH_F32_TOL, "rtol": ref.FLASH_F32_TOL}
               if dt == torch.float32 else
               {"rel": ref.FLASH_BF16_REL_TOL, "row_rel": ref.FLASH_BF16_ROW_REL_TOL})
        rec = {"shape": [B, S, KV, G, D], "dtype": str(dt), "causal": causal,
               "softcap": cap, **errs, "tol": tol}
        emit("flash_check", case=name, **rec)
        check(ok, f"flash {name}: errors {errs} beyond {tol}")
        rec["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                       softcap=cap), 10)
        rec["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, softcap=cap), 3, warmup=1)
        rec["library_ms"] = None  # SDPA has no softcap
        if not cap:
            qt = q.reshape(B, S, KV * G, D).transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            rec["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                       enable_gqa=True), 10)
        flops, nbytes = _flash_work(q, k, causal)
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, peak)
        rec["flops"], rec["bytes"] = flops, nbytes
        results[name] = rec

    for case in cases:
        flash_case(*case)
    emit("kernels_flash", cases=results)
    fa_rec = results["prefill_bf16"]

    merged = {}
    g = torch.Generator("cuda").manual_seed(7)

    def sorted_run(n, dtype, hi):
        x = torch.randint(0, hi, (n,), generator=g, device="cuda")
        return torch.sort(x.to(dtype)).values

    def merge_case(name, ak, bk):
        av = torch.arange(ak.numel(), dtype=torch.int32, device="cuda")
        bv = torch.arange(ak.numel(), ak.numel() + bk.numel(), dtype=torch.int32,
                          device="cuda")
        errs = merge_errors(kvmerge.merge_sorted(ak, av, bk, bv),
                            ref.merge_sorted_ref(ak, av, bk, bv), f"merge {name}")
        n = ak.numel() + bk.numel()
        b_ms, by = bound(n, 16.0 * n, PEAK_F32)
        merged[name] = {
            "n": n, **errs,
            "ms": time_ms(lambda: kvmerge.merge_sorted(ak, av, bk, bv), 20),
            "plain_ms": time_ms(lambda: ref.merge_sorted_ref(ak, av, bk, bv), 20),
            "library_ms": time_ms(lambda: merge_library(ak, av, bk, bv), 20),
            "bound_ms": b_ms, "bound_by": by}

    merge_case("ragged_i32", sorted_run(1003, torch.int32, 500),
               sorted_run(777, torch.int32, 500))
    inf = torch.tensor([math.inf], device="cuda")
    merge_case("float_inf", torch.cat([sorted_run(300, torch.float32, 1000), inf]),
               torch.cat([sorted_run(211, torch.float32, 1000), inf, inf]))
    merge_case("empty_side", sorted_run(0, torch.int32, 9), sorted_run(5, torch.int32, 9))
    big = (1 << 20) + 3
    merge_case("large_i32", sorted_run(big // 2, torch.int32, 1 << 30),
               sorted_run(big - big // 2, torch.int32, 1 << 30))
    emit("kernels_merge", cases=merged)
    return fa_rec


def time_merge_at_path(nchunks: int, nruns: int):
    """Time the merge fold of ``KvCacheStore._assemble`` at the main path's
    shape: ``nchunks`` chunk indices arriving as ``nruns`` ascending runs."""
    import torch

    from repro_torch.kernels import kvmerge, ref

    idx = torch.arange(nchunks, dtype=torch.int32, device="cuda")
    runs = [idx[r::nruns].contiguous() for r in range(nruns)]
    slots = [r.clone() for r in runs]

    def fold(merge):
        mk, mv = runs[0], slots[0]
        for rk, rv in zip(runs[1:], slots[1:]):
            mk, mv = merge(mk, mv, rk, rv)
        return mk, mv

    errs = merge_errors(fold(kvmerge.merge_sorted), fold(ref.merge_sorted_ref),
                        "merge at the path's shape")
    iters = 50
    n_elems = sum(len(runs[0]) + sum(len(r) for r in runs[1:i + 1])
                  for i in range(1, nruns))
    b_ms, by = bound(n_elems, 16.0 * n_elems, PEAK_F32)
    return {**errs,
            "ms": time_ms(lambda: fold(kvmerge.merge_sorted), iters),
            "plain_ms": time_ms(lambda: fold(ref.merge_sorted_ref), iters),
            "library_ms": time_ms(lambda: fold(merge_library), iters),
            "bound_ms": b_ms, "bound_by": by,
            "shape": {"chunks": nchunks, "runs": nruns, "merged_elems": n_elems}}


# ------------------------------------------------------------ phase 4
def phase_small():
    """Smoke width on the card (kernels) against the CPU (plain versions),
    at a prompt past the flash threshold."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import generate
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b:smoke").with_(
        head_dim=64, compute_dtype=torch.float32)  # the kernel takes D in {64, 128}
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 2304), dtype=torch.int32,
                           generator=torch.Generator("cpu").manual_seed(1))
    gpu_params = tree_map(lambda t: t.cuda(), params)
    lg_cpu, _ = model.apply(params, {"tokens": prompt}, mode="prefill", max_len=2310)
    lg_gpu, _ = model.apply(gpu_params, {"tokens": prompt.cuda()}, mode="prefill",
                            max_len=2310)
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    check(torch.allclose(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4),
          f"smoke-width prefill logits differ card vs CPU: {err}")
    t_cpu = generate(model, params, prompt, steps=4, max_len=2310)
    t_gpu = generate(model, gpu_params, prompt.cuda(), steps=4, max_len=2310)
    check(torch.equal(t_cpu, t_gpu.cpu()), "smoke-width tokens differ card vs CPU")
    emit("small", prefill_logits_max_abs_err=err, tokens_equal=True)


class _Timed:
    """Per-phase host times around a callable, each ending in a device
    synchronise."""

    def __init__(self):
        self.log = []

    def wrap(self, label, fn):
        import torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.log.append((label(*a, **kw) if callable(label) else label,
                             (time.perf_counter() - t0) * 1e3))
            return out
        return run

    def take(self):
        out, self.log = self.log, []
        return out


def main_path_model():
    """The main path's model and input on the card: qwen3-1.7b at full
    width with random weights from seed 0, and BATCH prompts of PROMPT
    tokens from seed 1. ``scripts/profile_serving.py`` traces the same."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                           device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    return cfg, model, params, prompt


def _bits(t):
    """A tensor's bit patterns, so that equality is bit for bit (-0.0 is
    not 0.0)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def phase_main():
    import torch

    from repro_torch.core import (AcceptAll, BlockDevice, OffloadEngine,
                                  OffloadFS, RpcFabric, TaskOffloader,
                                  serve_engine)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.serve import KvCacheStore, generate, register_kv_stubs
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg, model, params, prompt = main_path_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    dev = BlockDevice(num_blocks=1 << 19)
    fs = OffloadFS(dev, node="init0", shards=4)
    fabric = RpcFabric()
    engines = []
    for t in range(4):
        eng = OffloadEngine(fs, node=f"storage{t}")
        register_kv_stubs(eng)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0", targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    store = KvCacheStore(fs, off=off, chunk_blocks=256)

    timed = _Timed()
    model.apply = timed.wrap(lambda *a, **kw: kw.get("mode", "train"), model.apply)
    put, fetch = timed.wrap("put", store.put), timed.wrap("fetch", store.fetch)
    # every fetched cache (before decode writes into it) against the cache
    # that the cold prefill put, leaf by leaf and bit for bit
    prefilled, fetched = [], []

    def put_spy(tokens, cache, **kw):
        prefilled.append(cache)
        return put(tokens, cache, **kw)

    def fetch_spy(tokens):
        cache = fetch(tokens)
        same = tree_map(lambda a, b: a.shape == b.shape and a.dtype == b.dtype
                        and torch.equal(_bits(a), _bits(b)), prefilled[0], cache)
        fetched.append({"leaves": len(tree_leaves(same)), "equal": all(tree_leaves(same)),
                        "bytes": sum(t.numel() * t.element_size()
                                     for t in tree_leaves(cache))})
        return cache

    store.put, store.fetch = put_spy, fetch_spy

    def drive(kv_store):
        fa0, mg0, f0 = fa.LAUNCHES, kvmerge.LAUNCHES, store.stats.fetches
        t0 = time.perf_counter()
        toks = generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN,
                        kv_store=kv_store)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        phases = timed.take()
        ms = {k: sum(t for lab, t in phases if lab == k)
              for k in ("prefill", "put", "fetch", "decode")}
        n_dec = sum(1 for lab, _ in phases if lab == "decode")
        run = {"total_ms": total, "phase_ms": ms, "decode_steps": n_dec,
               "decode_tok_per_s": BATCH * n_dec / (ms["decode"] / 1e3) if n_dec else None,
               "flash_launches": fa.LAUNCHES - fa0,
               "merge_launches": kvmerge.LAUNCHES - mg0,
               "fetches": store.stats.fetches - f0}
        # time to first token on the decode side: the cache and the first
        # token are there (cold: prefill + put + fetch; warm: fetch)
        run["ttft_ms"] = ms["prefill"] + ms["put"] + ms["fetch"]
        return toks, run

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    kvmerge.LAUNCHES = 0
    cold, r_cold = drive(store)  # prefill, put, fetch, decode
    warm, r_warm = drive(store)  # attach: fetch, decode
    mem, r_mem = drive(None)  # prefill, decode
    launches = {"flash_attention": fa.LAUNCHES, "merge": kvmerge.LAUNCHES}

    check(cold.shape == (BATCH, STEPS) and bool(((cold >= 0) & (cold < cfg.vocab_size)).all()),
          "tokens out of range")
    check(torch.equal(cold, warm) and torch.equal(cold, mem),
          "cold, warm and in-memory tokens differ")
    check(len(prefilled) == 1 and len(fetched) == 2
          and all(f["equal"] for f in fetched),
          f"a fetched cache differs from the prefill's: {fetched}")
    check(r_cold["flash_launches"] == cfg.num_layers,
          f"cold prefill launched flash {r_cold['flash_launches']} times, "
          f"want {cfg.num_layers}")
    check(r_warm["flash_launches"] == 0, "warm attach ran a prefill")
    check(r_mem["flash_launches"] == cfg.num_layers, "in-memory prefill skipped flash")
    for r in (r_cold, r_warm):
        check(r["merge_launches"] >= r["fetches"] >= 1,
              f"merge launched {r['merge_launches']} times for {r['fetches']} fetches")
    check(launches["flash_attention"] > 0 and launches["merge"] > 0,
          "a kernel of the path was never launched")
    entry = store.entries()[0]
    emit("main", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, n_params=model.n_params(), batch=BATCH,
         prompt=PROMPT, steps=STEPS, init_s=init_s, launches=launches,
         cold=r_cold, warm=r_warm, in_memory=r_mem,
         cache_bytes_put=store.stats.put_bytes, cache_bytes_fetched=store.stats.fetch_bytes,
         chunks=entry.nchunks, merge_runs=store.stats.merge_runs,
         fetched_cache_bit_equal=fetched,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         tokens=cold.tolist())
    runs_per_fetch = max(2, store.stats.merge_runs // max(store.stats.fetches, 1))
    return launches, entry.nchunks, runs_per_fetch


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    import repro_torch.kernels.build  # noqa: F401  (the port must be here)

    info = phase_device()
    phase_build()
    fa_rec = phase_kernels()
    phase_small()
    launches, nchunks, nruns = phase_main()
    mg_rec = time_merge_at_path(nchunks, nruns)
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": launches["flash_attention"], "max_abs_err": fa_rec["max_abs_err"],
         "rel_err": fa_rec["rel_err"], "row_rel_err": fa_rec["row_rel_err"],
         "ms": fa_rec["ms"], "plain_ms": fa_rec["plain_ms"], "bound_ms": fa_rec["bound_ms"],
         "bound_by": fa_rec["bound_by"], "library_ms": fa_rec["library_ms"]},
        {"name": "merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merge.cu",
         "replaces": "src/repro/kernels/kvmerge.py:24",
         "launches": launches["merge"], "max_abs_err": mg_rec["max_abs_err"],
         "payload_mismatches": mg_rec["payload_mismatches"],
         "ms": mg_rec["ms"], "plain_ms": mg_rec["plain_ms"], "bound_ms": mg_rec["bound_ms"],
         "bound_by": mg_rec["bound_by"], "library_ms": mg_rec["library_ms"]},
    ]
    emit("merge_at_path", **mg_rec)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

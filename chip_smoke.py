#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

  1. device  — the card's name and count (no CUDA device: the script fails);
  2. build   — nvcc for every ``src/repro_torch/kernels/csrc/*.cu``, all
               started together, with ptxas registers / shared memory;
  3. kernels — each kernel against its plain PyTorch version on the card,
               with its time, the plain version's and a library yardstick's
               (the preprocess kernels bit for bit); flash at the prefill
               shape, at S = 2,049 (the first length on the flash path) and
               8,192, at the archs path's GQA groups of 16 and 4,
               non-causal, softcapped, ragged and in f32, each with its
               time over SDPA's; the two-run merge at edges and 2^20
               keys; the per-image preprocess at edges, and the batch
               preprocess over one minibatch's local share (171 crops of
               the corpus) beside the per-image loop it replaces;
  4. small   — a smoke-width model on the card against the same model on
               the CPU (plain versions) at a prompt that takes the flash path;
  5. main    — qwen3-1.7b at full width (random weights from a seed) through
               ``serve.generate``: cold (prefill, put, fetch, decode) and
               warm (attach, no prefill) through a KV-cache store on an
               OffloadFS volume behind 4 storage engines, and in memory;
               tokens must agree, every fetched cache must equal the
               prefill's bit for bit, and the path must launch both kernels:
               flash once a layer per prefill, the k-way merge once a fetch
               that arrived in more than one run;
  6. failover — the main path's model, prompts and new tokens on the main
               path's volume shape behind a ``ClusterRouter`` over a
               ``FaultyFabric``: cold; one engine killed, the warm run that
               meets it fails; ``probe()`` quarantines it within
               ``max_probe_failures`` rounds; warm over the 3 survivors, one
               of them slowed, through one merge launch; the initiator dies
               mid-put of a second prompt's cache;
               ``standby_takeover`` fences exactly that orphan and the
               standby serves the first prompt warm. Tokens equal the main
               phase's every time, fetched caches the prefill's bit for bit,
               no lease left;
  7. archs   — glm4-9b, granite-3-8b and mistral-nemo-12b at full width and
               depth (f32 params, bf16 compute, random weights), one after
               the other: in memory, and glm4-9b also cold and warm through
               the main path's store; flash once a layer per prefill (GQA
               groups of 16 and 4), tokens equal across runs, logits finite,
               ``n_params`` the JAX package's;
  8. prep    — OffloadPrep through ``PrepPipeline`` on 1,024 images of the
               synthetic corpus (sides 64-512) on a volume behind one
               storage engine: a third of each 256-image minibatch
               preprocessed by the engine's numpy stub, the rest on the card
               by one batch preprocess launch a minibatch; every batch bit
               for bit equal to a host numpy golden, before and after a
               checkpoint into OffloadDB, a remount and a resume;
  9. pushdown — OffloadDB on a 4-stripe volume behind 4 engines, 200,000
               keys of fig21's shape, a ~10 % filter: the pushdown scan,
               merged on the card by one k-way merge launch, equals the
               local scan, and its merge equals the plain merge bit for
               bit. fig21's keys all tie on their 4-byte prefix, so the
               merge there orders nothing: streams of the scan's lengths
               with distinct prefixes go through ``merge_row_streams`` on
               the card against a plain host merge;
 10. merge_at_path — the k-way merge timed at the path's shapes (a fetch's
               900 chunk indices in its runs and in 900 runs of one, the
               scan's and the distinct-prefix streams) against its plain
               version, one stable sort and, at the fetch, the two-run fold
               it replaces; each bit for bit;
 11. train_small — one AdamW ``make_train_step`` step of qwen3-1.7b:smoke
               (f32) at S = 2,304, past the flash threshold, on the card
               against the same step on the CPU: loss, grad_norm, every
               param and moment; the flash kernel must not launch (the
               train path runs the differentiable chunked twin);
 12. train_e2e — ``repro_torch.train.e2e.run`` on paper-lm-100m at full
               width with prep ingest: 12 steps, a checkpoint into OffloadDB
               every 4, a crash after step 8, recover, restore, resume; the
               resumed losses bit for bit those of an uninterrupted run, the
               restored ingest state the one saved, every minibatch the
               crash run consumed bit for bit the host numpy golden (out
               32), one preprocess launch per minibatch, no merge launch;
 13. train     — qwen3-1.7b at full width (28 layers, bf16 compute over f32
               params, remat) at S 4,096, batch 2: the first three AdamW
               steps of ``for_config``'s schedule on one batch (finite,
               falling loss), then one at microbatches 2.

The train phases run under ``torch.use_deterministic_algorithms(True)``,
with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts.

Then a ``phase_seconds`` line, the ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
# f64 outside them, HBM bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12

# main-path shape: qwen3-1.7b at full width, two 4,096-token prompts
BATCH, PROMPT, STEPS = 2, 4096, 16
MAX_LEN = PROMPT + STEPS

# prep path: OffloadPrep's defaults (out 224, a third offloaded) on the
# corpus's own size distribution, 4 minibatches of 256
PREP_IMAGES, PREP_BATCH, PREP_OUT, PREP_SEED = 1024, 256, 224, 5
# pushdown path: fig21's corpus shape (240-byte values) at 200,000 keys
PUSHDOWN_KEYS = 200_000
# train paths: the chunked twin's first length; train_e2e.py's defaults
# (batch 8, seq 128, prep ingest at out 32) for 12 steps, a checkpoint every
# 4, a crash after 8; qwen3 at the train_4k cell's length, batch 2 (the
# cell's global batch of 256 cut to 2)
TRAIN_SMALL_S = 2304
E2E_STEPS, E2E_CKPT_EVERY, E2E_KILL_AT = 12, 4, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 3
# failover path: the main path's model, prompts and store shape on a
# FaultyFabric from a fixed seed; one of its 4 engines is killed, and one
# survivor straggles (each delivery delayed), so that the fetch over the
# survivors arrives out of order whatever the threads' timing and the
# merge has runs to order
FAILOVER_SEED, FAILOVER_KILL = 16, "storage1"
FAILOVER_STRAGGLER, FAILOVER_DELAY_S = "storage3", 0.002
# archs path: the other dense archs at full width and depth, each with the
# JAX package's n_params() (src/repro/models, computed on the CPU)
ARCHS = {"glm4-9b": 9_399_767_040, "granite-3-8b": 8_372_187_136,
         "mistral-nemo-12b": 12_247_782_400}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` warm calls. A spin
    kernel holds the card while the host enqueues the calls, twice as long
    as one call took end to end times ``iters``, so that the host's own
    time between launches (a Python wrapper's checks, a small kernel's
    launch) is not counted as the card's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(2.0 * iters * (time.perf_counter() - t0), 2.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles, at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn``, a loop of many small launches, in ms:
    captured once into a CUDA graph and timed by ``time_ms`` over replays,
    so that neither the host's Python between launches nor the launch
    queue's depth (about a thousand) is counted as the card's time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, iters)
    del graph
    return ms


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
    build.build(["flash_attention", "merge", "preprocess"])
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
        ("s2049_bf16", BATCH, 2049, 8, 2, 128, torch.bfloat16, True, 0.0),
        ("s8192_bf16", 1, 8192, 8, 2, 128, torch.bfloat16, True, 0.0),
        ("noncausal_bf16", 1, 1500, 8, 2, 128, torch.bfloat16, False, 0.0),
        ("softcap_bf16", 1, 1024, 2, 4, 128, torch.bfloat16, True, 30.0),
        # the archs path's prefill shapes: glm4-9b's 32 heads over 2 KV heads
        # (groups of 16), granite-3-8b's and mistral-nemo-12b's over 8 (of 4)
        ("glm4_g16_bf16", BATCH, PROMPT, 2, 16, 128, torch.bfloat16, True, 0.0),
        ("kv8_g4_bf16", BATCH, PROMPT, 8, 4, 128, torch.bfloat16, True, 0.0),
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
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"] if rec["library_ms"] else None
        flops, nbytes = _flash_work(q, k, causal)
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, peak)
        rec["flops"], rec["bytes"] = flops, nbytes
        results[name] = rec
        del q, k, v, out
        torch.cuda.empty_cache()

    for case in cases:
        flash_case(*case)
    emit("kernels_flash", cases=results)
    fa_rec = dict(results["prefill_bf16"])
    fa_rec["arch_shapes"] = {name: {k: results[name][k] for k in (
        "shape", "max_abs_err", "rel_err", "row_rel_err", "tol", "ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by")} for name in ("glm4_g16_bf16", "kv8_g4_bf16")}

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


def merge_library_runs(keys, vals):
    """The k-way merge's library yardstick (never called by the port): one
    stable sort of the runs' keys laid back to back, then a gather."""
    import torch

    out_k, order = torch.sort(keys, stable=True)
    return out_k, vals[order]


def time_merge_at_path(nchunks: int, nruns: int, scans):
    """Time the k-way merge at the path's shapes: ``KvCacheStore._assemble``'s
    ``nchunks`` chunk indices arriving as ``nruns`` ascending runs, as 72
    (the most runs a cold fetch has been seen to arrive in) and as
    ``nchunks`` runs of one (the most a fetch can have), and each recorded
    input of ``merge_row_streams`` in ``scans`` (name → (keys, vals,
    offsets)). Each is held bit for bit against the plain version; the
    fetch shapes also time the fold of two-run merges that they replaced
    (one launch a run, as a CUDA graph)."""
    import torch

    from repro_torch.kernels import kvmerge, ref

    def fetch_input(runs):
        idx = torch.arange(nchunks, dtype=torch.int32, device="cuda")
        keys = torch.cat([idx[r::runs] for r in range(runs)])
        lengths = [idx[r::runs].numel() for r in range(runs)]
        return keys, torch.arange(nchunks, dtype=torch.int32, device="cuda"), \
            [0, *torch.tensor(lengths).cumsum(0).tolist()]

    cases = {"fetch": fetch_input(nruns), "fetch_72_runs": fetch_input(72),
             "fetch_900_of_one": fetch_input(nchunks), **scans}
    out = {}
    for name, (keys, vals, off) in cases.items():
        off_t = torch.as_tensor(off, dtype=torch.int64)
        errs = merge_errors(kvmerge.merge_runs(keys, vals, off),
                            ref.merge_runs_ref(keys, vals, off_t), f"merge_runs {name}")
        lib = merge_library_runs(keys, vals)
        merge_errors(lib, ref.merge_runs_ref(keys, vals, off_t), f"stable sort {name}")
        n, k = keys.numel(), len(off) - 1
        b_ms, by = bound(n, 16.0 * n, PEAK_F32)
        rec = {"n": n, "runs": k, **errs,
               "ms": time_ms(lambda: kvmerge.merge_runs(keys, vals, off), 50),
               "plain_ms": time_ms(lambda: ref.merge_runs_ref(keys, vals, off_t), 3,
                                   warmup=1),
               "library_ms": time_ms(lambda: merge_library_runs(keys, vals), 50),
               "bound_ms": b_ms, "bound_by": by}
        if name.startswith("fetch"):  # the fold of two-run merges the path ran before
            runs = [(keys[a:b], vals[a:b]) for a, b in zip(off[:-1], off[1:])]

            def fold():
                mk, mv = runs[0]
                for rk, rv in runs[1:]:
                    mk, mv = kvmerge.merge_sorted(mk, mv, rk, rv)
                return mk, mv

            merge_errors(fold(), ref.merge_runs_ref(keys, vals, off_t), "fold")
            rec["fold_ms"] = time_graph_ms(fold, 20)
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
        out[name] = rec
    return out


def prep_library(img_chw, flip, mean, std):
    """The preprocess kernel's library yardstick (never called by the
    port): ``F.interpolate`` bilinear in f64, ``torch.flip``, normalise."""
    import torch
    import torch.nn.functional as F

    x = F.interpolate(img_chw[None].double(), size=(PREP_OUT, PREP_OUT), mode="bilinear",
                      align_corners=False)[0]
    if flip:
        x = torch.flip(x, dims=(-1,))
    return (x - mean[:, None, None]) / std[:, None, None]


def prep_work(img_chw):
    """(FLOP, bytes) of one preprocess call: 13 f64 operations per output
    element (the two-tap blends, their weights' complements, the
    normalisation) plus 5 per output row and column (source coordinates);
    the crop read once, the f64 output written once."""
    C = img_chw.shape[0]
    flops = 13.0 * C * PREP_OUT * PREP_OUT + 5.0 * 2 * PREP_OUT
    nbytes = img_chw.numel() * img_chw.element_size() + C * PREP_OUT * PREP_OUT * 8
    return flops, nbytes


def phase_kernels_preprocess():
    """The preprocess kernel against its plain version on the card, bit for
    bit: a count of differing elements (must be 0) and the max abs error."""
    import torch

    from repro_torch.kernels import preprocess as kpp
    from repro_torch.kernels import ref

    g = torch.Generator("cuda").manual_seed(11)

    def crop(h, w):  # an HWC uint8 crop seen as CHW, as the prep path hands it
        return torch.randint(0, 256, (h, w, 3), generator=g, device="cuda",
                             dtype=torch.uint8).permute(2, 0, 1)

    slots = torch.zeros((2, PREP_OUT, PREP_OUT, 3), dtype=torch.float64, device="cuda")
    cases = [  # name, CHW input, flip, out
        ("crop512_flip", crop(512, 512), True, None),
        ("upscale61x77", crop(61, 77), False, None),
        ("pixel1x1", crop(1, 1), True, None),
        ("f32_chw", torch.rand((3, 300, 417), generator=g, device="cuda") * 255, True, None),
        ("slot_view", crop(200, 300), True, slots[1].permute(2, 0, 1)),
    ]
    mean = ref.PREP_MEAN.to("cuda", torch.float64)
    std = ref.PREP_STD.to("cuda", torch.float64)
    results = {}
    for name, img, flip, out in cases:
        got = kpp.preprocess_image(img, out_size=PREP_OUT, flip=flip, out=out)
        want = ref.preprocess_image_ref(img, out_size=PREP_OUT, flip=flip)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.float64,
              f"preprocess {name}: {tuple(got.shape)} {got.dtype}")
        differing = int((got.view(torch.int64) != want.view(torch.int64)).sum().item())
        err = (got - want).abs().max().item()
        check(differing == 0, f"preprocess {name}: {differing} elements differ from the "
                              f"plain version (max abs error {err})")
        if out is not None:
            check(got.data_ptr() == slots[1].data_ptr() and not slots[0].any().item(),
                  "preprocess slot_view: wrote outside its slot")
        flops, nbytes = prep_work(img)
        b_ms, by = bound(flops, nbytes, PEAK_F64)
        results[name] = {
            "shape": list(img.shape), "dtype": str(img.dtype), "flip": flip,
            "differing_elements": differing, "max_abs_err": err,
            "ms": time_ms(lambda: kpp.preprocess_image(img, out_size=PREP_OUT, flip=flip,
                                                       out=out), 50),
            "plain_ms": time_ms(lambda: ref.preprocess_image_ref(img, out_size=PREP_OUT,
                                                                 flip=flip), 10),
            "library_ms": time_ms(lambda: prep_library(img, flip, mean, std), 50),
            "bound_ms": b_ms, "bound_by": by, "flops": flops, "bytes": nbytes}
    results["batch171"] = _preprocess_batch_case(mean, std)
    emit("kernels_preprocess", cases=results)
    return results["batch171"]


def _preprocess_batch_case(mean, std):
    """One minibatch's local share in one batch launch: 171 crops of the
    corpus (sides 64 to 512), cut and flipped from the seeds as OffloadPrep
    draws them, packed as ``OffloadPrep`` packs them; bit for bit against
    the plain version, timed beside the loop of per-image launches it
    replaces and a loop of ``prep_library`` calls (no one PyTorch call
    resizes a ragged batch); both loops are timed as CUDA graphs."""
    import numpy as np
    import torch

    from repro_torch.data.preprocess import random_crop_params, synthetic_image
    from repro_torch.kernels import preprocess as kpp
    from repro_torch.kernels import ref

    crops, flips = [], []
    for i in range(PREP_BATCH - PREP_BATCH // 3):
        img = synthetic_image(i, max_side=512)
        rng = np.random.RandomState(i)
        y, x, ch, cw = random_crop_params(rng, img.shape[0], img.shape[1])
        crops.append(img[y:y + ch, x:x + cw])
        flips.append(bool(rng.rand() < 0.5))
    n = len(crops)
    packed, desc = kpp.pack_crops(crops, flips, list(range(n)), "cuda")
    out = torch.empty((n, PREP_OUT, PREP_OUT, 3), dtype=torch.float64, device="cuda")
    want = torch.zeros_like(out)
    kpp.preprocess_batch(packed, desc, out)
    ref.preprocess_batch_ref(packed, desc, want)
    torch.cuda.synchronize()
    differing = int((out.view(torch.int64) != want.view(torch.int64)).sum().item())
    err = (out - want).abs().max().item()
    check(differing == 0, f"preprocess batch171: {differing} elements differ from the plain "
                          f"version (max abs error {err})")
    views = [(packed[o:o + h * w * c].view(h, w, c).permute(2, 0, 1), bool(f), s)
             for o, h, w, c, f, s in desc.tolist()]

    def per_image():
        for img, flip, slot in views:
            kpp.preprocess_image(img, out_size=PREP_OUT, flip=flip,
                                 out=out[slot].permute(2, 0, 1))

    def library():
        for img, flip, slot in views:
            out[slot] = prep_library(img, flip, mean, std).permute(1, 2, 0)

    flops = bytes_ = 0.0
    for img, _, _ in views:
        f, b = prep_work(img)
        flops, bytes_ = flops + f, bytes_ + b
    b_ms, by = bound(flops, bytes_, PEAK_F64)
    rec = {"images": n, "crop_bytes": packed.numel(), "differing_elements": differing,
           "max_abs_err": err,
           "ms": time_ms(lambda: kpp.preprocess_batch(packed, desc, out), 20),
           "per_image_loop_ms": time_graph_ms(per_image, 10),
           "plain_ms": time_ms(lambda: ref.preprocess_batch_ref(packed, desc, want), 2,
                               warmup=1),
           "library_ms": time_graph_ms(library, 5),
           "bound_ms": b_ms, "bound_by": by, "flops": flops, "bytes": bytes_}
    rec["ms_over_per_image_loop"] = rec["ms"] / rec["per_image_loop_ms"]
    del out, want
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------ phases 4-5
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


def _kv_plane(fabric):
    """The main path's storage plane on ``fabric``: a volume of 2^19 blocks
    with 4 stripes behind 4 storage engines that serve the KV stubs, and a
    least-outstanding offloader over them. Returns (fs, engines, off)."""
    from repro_torch.core import (AcceptAll, BlockDevice, OffloadEngine, OffloadFS,
                                  TaskOffloader, serve_engine)
    from repro_torch.serve import register_kv_stubs

    fs = OffloadFS(BlockDevice(num_blocks=1 << 19), node="init0", shards=4)
    engines = []
    for t in range(4):
        eng = OffloadEngine(fs, node=f"storage{t}")
        register_kv_stubs(eng)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0", targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    return fs, engines, off


def serving_store():
    """The main path's KV-cache store on the card: 1 MiB chunks on
    ``_kv_plane``. ``scripts/profile_serving.py`` traces a fetch from the
    same."""
    from repro_torch.core import RpcFabric
    from repro_torch.serve import KvCacheStore

    fs, _, off = _kv_plane(RpcFabric())
    return KvCacheStore(fs, off=off, chunk_blocks=256)


def _bits(t):
    """A tensor's bit patterns, so that equality is bit for bit (-0.0 is
    not 0.0)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def phase_main():
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.serve import generate
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg, model, params, prompt = main_path_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    store = serving_store()

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
    runs_per_fetch = []  # the arrival runs of every fetch's assembly
    assemble = store._assemble

    def assemble_spy(arrivals):
        r0 = store.stats.merge_runs
        out = assemble(arrivals)
        runs_per_fetch.append(store.stats.merge_runs - r0)
        return out

    store._assemble = assemble_spy

    def drive(kv_store):
        fa0, mg0, f0 = fa.LAUNCHES, kvmerge.LAUNCHES, store.stats.fetches
        a0 = len(runs_per_fetch)
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
               "fetches": store.stats.fetches - f0,
               "runs_per_fetch": runs_per_fetch[a0:]}
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
    for r in (r_cold, r_warm):  # one k-way launch a fetch that needs a merge
        multi = sum(1 for runs in r["runs_per_fetch"] if runs > 1)
        check(r["fetches"] == len(r["runs_per_fetch"]) >= 1 and r["merge_launches"] == multi,
              f"merge launched {r['merge_launches']} times for {r['fetches']} fetches "
              f"in {r['runs_per_fetch']} runs")
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
    return launches, entry.nchunks, max(2, max(runs_per_fetch)), cold


# ------------------------------------------------------------ phase 6
def failover_plane():
    """The failover path's plane: ``_kv_plane`` on a ``FaultyFabric`` with a
    fixed seed, under ``ClusterRouter(off, max_probe_failures=2)``, and the
    KV-cache store on the router. Returns (fs, fabric, engines, router,
    store)."""
    from repro_torch.core import ClusterRouter, FaultyFabric
    from repro_torch.serve import KvCacheStore

    fabric = FaultyFabric(seed=FAILOVER_SEED)
    fs, engines, off = _kv_plane(fabric)
    router = ClusterRouter(off, max_probe_failures=2)
    return fs, fabric, engines, router, KvCacheStore(fs, router=router, chunk_blocks=256)


def _wait_no_leases(fs, timeout_s: float = 30.0) -> int:
    """A routed chunk's lease is released just after its future resolves,
    on the fabric's worker thread: wait for the last release; the count
    left."""
    deadline = time.perf_counter() + timeout_s
    while fs._leases and time.perf_counter() < deadline:
        time.sleep(0.005)
    return len(fs._leases)


def failover_run(model, params, prompt, prompt2, want, plane):
    """The failover sequence on ``plane`` (``failover_plane()``'s tuple):
    cold through the router; one engine killed and the warm run that meets
    it; ``probe()`` to quarantine; warm over the 3 survivors, one of them
    a straggler; a mid-put
    crash of the initiator on a second prompt's cache, on the
    initiator-local plane where that failpoint lives, leaving its write
    lease orphaned; ``standby_takeover`` and a warm attach from the
    standby. Every run's tokens must equal ``want``, every fetched cache
    the cold prefill's, bit for bit. Returns the record."""
    import torch

    from repro_torch.core import standby_takeover
    from repro_torch.core.router import QUARANTINED
    from repro_torch.core.rpc import RpcError
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.serve import KvCacheStore, ServingCrash, attach_store, generate
    from repro_torch.tree import tree_leaves, tree_map

    fs, fabric, engines, router, store = plane
    timed = _Timed()
    put, fetch = timed.wrap("put", store.put), timed.wrap("fetch", store.fetch)
    prefilled, fetched = [], []

    def put_spy(tokens, cache, **kw):
        prefilled.append(cache)
        return put(tokens, cache, **kw)

    def fetch_spy(tokens):
        cache = fetch(tokens)
        same = tree_map(lambda a, b: a.shape == b.shape and a.dtype == b.dtype
                        and torch.equal(_bits(a), _bits(b)), prefilled[0], cache)
        fetched.append(all(tree_leaves(same)))
        return cache

    store.put, store.fetch = put_spy, fetch_spy
    runs = []
    assemble = store._assemble

    def assemble_spy(arrivals):
        r0 = store.stats.merge_runs
        out = assemble(arrivals)
        runs.append(store.stats.merge_runs - r0)
        return out

    store._assemble = assemble_spy
    by_step, launches = {}, {"flash_attention": 0, "merge": 0}

    def drive(label, kv_store, *, meets_dead=False):
        """One ``generate`` through ``kv_store``; with ``meets_dead`` it must
        fail, and the record keeps what it raised."""
        fa0, mg0, a0 = fa.LAUNCHES, kvmerge.LAUNCHES, len(runs)
        t0 = time.perf_counter()
        rec = {}
        if meets_dead:
            try:
                generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN,
                         kv_store=kv_store)
            except RpcError as e:
                rec["raised"] = f"{type(e).__name__}: {e}"
            check("raised" in rec, f"failover {label}: the run over a dead engine did not fail")
        else:
            toks = generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN,
                            kv_store=kv_store)
        torch.cuda.synchronize()
        phases = timed.take()
        rec.update({
            "total_ms": (time.perf_counter() - t0) * 1e3,
            "phase_ms": {k: [t for lab, t in phases if lab == k] for k in ("put", "fetch")},
            "flash_launches": fa.LAUNCHES - fa0, "merge_launches": kvmerge.LAUNCHES - mg0,
            "runs_per_fetch": runs[a0:], "leases_after": _wait_no_leases(fs)})
        launches["flash_attention"] += rec["flash_launches"]
        launches["merge"] += rec["merge_launches"]
        by_step[label] = rec
        if not meets_dead:
            check(torch.equal(toks.cpu(), want),
                  f"failover {label}: tokens differ from the main phase's")
            check(rec["merge_launches"] == sum(1 for r in rec["runs_per_fetch"] if r > 1),
                  f"failover {label}: {rec['merge_launches']} merge launches for fetches in "
                  f"{rec['runs_per_fetch']} runs")
        return rec

    cfg = model.cfg
    try:
        cold = drive("cold", store)
        check(cold["flash_launches"] == cfg.num_layers, f"cold prefill launched flash "
                                                        f"{cold['flash_launches']} times")
        dead = FAILOVER_KILL
        fabric.kill(dead)
        drive("kill", store, meets_dead=True)
        rounds = 0
        while router.members[dead].state != QUARANTINED and rounds < 10:
            router.probe()
            rounds += 1
        check(router.members[dead].state == QUARANTINED
              and rounds <= router.max_probe_failures,
              f"{dead} not quarantined after {rounds} probe rounds")
        served = {e.node: e.tasks_run for e in engines}
        fabric.delay(FAILOVER_STRAGGLER, FAILOVER_DELAY_S, methods={"submit_task"})
        warm = drive("survivors", store)
        fabric.clear_faults(FAILOVER_STRAGGLER)
        check(warm["flash_launches"] == 0, "the warm run over the survivors ran a prefill")
        check(warm["merge_launches"] == 1, f"the survivors' fetch with a straggler came in "
                                           f"{warm['runs_per_fetch']} runs, no merge")
        by_engine = {e.node: e.tasks_run - served[e.node] for e in engines}
        check(by_engine[dead] == 0 and all(n > 0 for e, n in by_engine.items() if e != dead),
              f"the survivors' fetch landed {by_engine}")
        check(len(prefilled) == 1 and len(fetched) == 2 and all(fetched),
              f"a fetched cache differs from the prefill's: {fetched}")
        del prefilled[:]

        # the prefill initiator dies mid-put of a second prompt's cache
        fa0 = fa.LAUNCHES
        _, cache2 = model.apply(params, {"tokens": prompt2}, mode="prefill", max_len=MAX_LEN)
        orphan_flash = fa.LAUNCHES - fa0
        launches["flash_attention"] += orphan_flash
        check(orphan_flash == cfg.num_layers, f"the second prompt's prefill launched flash "
                                              f"{orphan_flash} times")
        local = KvCacheStore(fs, chunk_blocks=256)
        t0 = time.perf_counter()
        try:
            local.put(prompt2, cache2, failpoint="mid_put")
            check(False, "the mid_put failpoint did not fire")
        except ServingCrash:
            pass
        orphan_ms = (time.perf_counter() - t0) * 1e3
        del cache2
        torch.cuda.empty_cache()
        orphans = sorted(ls.task_id for ls in fs._leases.values())
        check(len(orphans) == 1, f"the crash left {len(orphans)} leases, want 1")

        t0 = time.perf_counter()
        fs2, fenced = standby_takeover(fs.dev, node="decode0", shards=4)
        takeover_ms = (time.perf_counter() - t0) * 1e3
        check(sorted(fenced) == orphans and not fs2._leases,
              f"takeover fenced {fenced}, the orphans were {orphans}")
        store2 = attach_store(fs2, chunk_blocks=256)
        check(store2.contains(prompt) and not store2.contains(prompt2),
              "the standby's catalog is not the committed one")
        store2.fetch = timed.wrap("fetch", store2.fetch)
        fa0, t0 = fa.LAUNCHES, time.perf_counter()
        toks = generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN, kv_store=store2)
        torch.cuda.synchronize()
        standby = {"total_ms": (time.perf_counter() - t0) * 1e3,
                   "phase_ms": {"fetch": [t for _, t in timed.take()]},
                   "flash_launches": fa.LAUNCHES - fa0, "fetches": store2.stats.fetches,
                   "leases_after": len(fs2._leases)}
        launches["flash_attention"] += standby["flash_launches"]
        check(torch.equal(toks.cpu(), want), "the standby's tokens differ from the main phase's")
        check(standby["flash_launches"] == 0 and standby["fetches"] == 1,
              f"the standby ran a prefill or fetched {standby['fetches']} times")
        by_step["standby"] = standby
    finally:
        router.stop_heartbeat()
    leases = {k: r["leases_after"] for k, r in by_step.items()}
    check(all(n == 0 for n in leases.values()), f"leases left outstanding: {leases}")
    return {"killed": dead, "straggler": [FAILOVER_STRAGGLER, FAILOVER_DELAY_S],
            "probe_rounds_to_quarantine": rounds,
            "max_probe_failures": router.max_probe_failures, "router_stats": {
                "probes": router.stats.probes, "probe_failures": router.stats.probe_failures,
                "quarantined": router.stats.quarantined,
                "dispatched": router.stats.dispatched},
            "fabric_injected": dict(fabric.injected), "survivor_tasks": by_engine,
            "orphan_put_ms": orphan_ms, "orphans": orphans, "fenced": sorted(fenced),
            "takeover_ms": takeover_ms, "leases_after": leases, "launches": launches,
            "fetched_cache_bit_equal": True, "tokens_equal_main": True, "by_step": by_step}


def phase_failover(want):
    """The main path's model, prompts and new tokens through the failover
    plane (``failover_run``): the tokens of every run must be the main
    phase's cold tokens ``want``."""
    import torch

    cfg, model, params, prompt = main_path_model()
    prompt2 = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                            device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    rec = failover_run(model, params, prompt, prompt2, torch.as_tensor(want),
                       failover_plane())
    emit("failover", model=cfg.name, batch=BATCH, prompt=PROMPT, steps=STEPS,
         max_memory_allocated=torch.cuda.max_memory_allocated(), **rec)
    return rec["launches"]


# ------------------------------------------------------------ phase 7
def arch_run(cfg, model, params, prompt, store=None):
    """One arch at ``cfg``: in memory, and with ``store`` cold and warm;
    tokens in range and equal across the runs, the prefill's last-position
    and every decode step's logits finite, flash once a layer per prefill,
    the merge once a fetch that arrived in more than one run. Returns the
    record."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.serve import generate

    timed = _Timed()
    apply = timed.wrap(lambda *a, **kw: kw.get("mode", "train"), model.apply)
    finite = []

    def apply_spy(*a, **kw):
        logits, cache = apply(*a, **kw)
        finite.append(bool(torch.isfinite(logits[:, -1].float()).all()))
        return logits, cache

    model.apply = apply_spy
    if store is not None:
        store.put, store.fetch = timed.wrap("put", store.put), timed.wrap("fetch", store.fetch)
    runs, launches = {}, {"flash_attention": 0, "merge": 0}
    labels = ["in_memory"] + (["cold", "warm"] if store is not None else [])
    for label in labels:
        fa0, mg0 = fa.LAUNCHES, kvmerge.LAUNCHES
        r0, f0 = (store.stats.merge_runs, store.stats.fetches) if store else (0, 0)
        t0 = time.perf_counter()
        toks = generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN,
                        kv_store=None if label == "in_memory" else store)
        torch.cuda.synchronize()
        phases = timed.take()
        ms = {k: sum(t for lab, t in phases if lab == k)
              for k in ("prefill", "put", "fetch", "decode")}
        n_dec = sum(1 for lab, _ in phases if lab == "decode")
        rec = {"total_ms": (time.perf_counter() - t0) * 1e3, "prefill_ms": ms["prefill"],
               "put_ms": ms["put"], "fetch_ms": ms["fetch"], "decode_ms": ms["decode"],
               "decode_steps": n_dec,
               "decode_tok_per_s": BATCH * n_dec / (ms["decode"] / 1e3),
               "flash_launches": fa.LAUNCHES - fa0, "merge_launches": kvmerge.LAUNCHES - mg0,
               "tokens": toks.cpu()}
        if store is not None:
            rec["fetches"] = store.stats.fetches - f0
            rec["merge_runs"] = store.stats.merge_runs - r0
        launches["flash_attention"] += rec["flash_launches"]
        launches["merge"] += rec["merge_launches"]
        runs[label] = rec
    del model.apply
    want = runs["in_memory"].pop("tokens")
    check(want.shape == (BATCH, STEPS) and bool(((want >= 0) & (want < cfg.vocab_size)).all()),
          f"{cfg.name}: tokens out of range")
    check(all(finite), f"{cfg.name}: non-finite logits in {finite.count(False)} of "
                       f"{len(finite)} calls")
    for label in labels[1:]:
        check(torch.equal(runs[label].pop("tokens"), want),
              f"{cfg.name}: {label} tokens differ from the in-memory tokens")
    for label in ("in_memory", "cold"):
        if label in runs:
            check(runs[label]["flash_launches"] == cfg.num_layers,
                  f"{cfg.name} {label}: flash launched {runs[label]['flash_launches']} "
                  f"times, want {cfg.num_layers}")
    if store is not None:
        check(runs["warm"]["flash_launches"] == 0, f"{cfg.name}: the warm run ran a prefill")
        for label in ("cold", "warm"):
            r = runs[label]
            check(r["fetches"] == 1 and r["merge_launches"] == int(r["merge_runs"] > 1),
                  f"{cfg.name} {label}: {r['merge_launches']} merge launches for a fetch in "
                  f"{r['merge_runs']} runs")
    return {"runs": runs, "launches": launches, "tokens": want.tolist(),
            "finite_logit_calls": len(finite)}


def phase_archs():
    """glm4-9b, granite-3-8b and mistral-nemo-12b at full width and depth,
    one after the other (each freed before the next): f32 params, bf16
    compute, random weights from seed 0, BATCH prompts of PROMPT tokens
    from seed 1, STEPS new tokens in memory; glm4-9b also cold and warm
    through the main path's store (``serving_store``). ``n_params`` must
    be the JAX package's."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    out, launches = {}, {"flash_attention": 0, "merge": 0}
    for name, n_params in ARCHS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(name)
        model = build_model(cfg)
        check(model.n_params() == n_params,
              f"{name}: n_params {model.n_params()}, the JAX package's {n_params}")
        t0 = time.perf_counter()
        params = model.init(torch.Generator("cuda").manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                               device="cuda", generator=torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        store = serving_store() if name == "glm4-9b" else None
        rec = arch_run(cfg, model, params, prompt, store)
        for k in launches:
            launches[k] += rec["launches"][k]
        out[name] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "rotary_pct": cfg.rotary_pct, "vocab": cfg.vocab_size, "n_params": n_params,
            "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
            "init_s": init_s, "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "cache_bytes": store.stats.put_bytes if store else None, **rec}
        emit("arch", model=name, **out[name])
        del model, params, prompt, store
    gc.collect()
    torch.cuda.empty_cache()
    emit("archs", batch=BATCH, prompt=PROMPT, steps=STEPS, launches=launches,
         n_params={k: v["n_params"] for k, v in out.items()},
         prefill_ms={k: v["runs"]["in_memory"]["prefill_ms"] for k, v in out.items()},
         decode_tok_per_s={k: v["runs"]["in_memory"]["decode_tok_per_s"]
                           for k, v in out.items()},
         max_memory_allocated={k: v["max_memory_allocated"] for k, v in out.items()})
    return launches


# ------------------------------------------------------------ phase 8
def _prep_plane(dev=None):
    """A volume of 2^17 blocks behind one storage engine that serves
    ``stub_preprocess`` (and OffloadDB's stubs); with ``dev`` it remounts
    that device, as a restarted trainer would."""
    from repro_torch.core import (AcceptAll, BlockDevice, OffloadEngine, OffloadFS,
                                  RpcFabric, TaskOffloader, serve_engine)
    from repro_torch.core.lsm import compaction as C
    from repro_torch.data.offload_prep import stub_preprocess

    mount = dev is not None
    dev = dev or BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS.mount(dev, node="init0") if mount else OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    eng = OffloadEngine(fs, node="storage0")
    eng.register_stub("preprocess", stub_preprocess)
    eng.register_stub("compact", C.stub_compact)
    eng.register_stub("log_recycle", C.stub_log_recycle)
    serve_engine(eng, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0", targets=[eng.node])
    return dev, fs, fabric, off


class _PrepTimes:
    """Per-minibatch host times inside the producer thread, with no
    synchronise, through OffloadPrep's public calls: the local share
    (``local_images``: reads, host decode and crop, copies, kernel
    launches; ``scripts/profile_prep.py`` has the device's view), then the
    wait on the remote share up to its copy into the batch
    (``fill_share``)."""

    def __init__(self, prep):
        self.batches = []
        local, fill = prep.local_images, prep.fill_share

        def local_images(*a, **kw):
            t0 = time.perf_counter()
            out = local(*a, **kw)
            self.t_local = time.perf_counter()
            self.batches.append({"local_ms": (self.t_local - t0) * 1e3,
                                 "remote_wait_ms": 0.0})
            return out

        def fill_share(*a, **kw):
            out = fill(*a, **kw)
            self.batches[-1]["remote_wait_ms"] = (time.perf_counter() - self.t_local) * 1e3
            return out

        prep.local_images, prep.fill_share = local_images, fill_share


def phase_prep():
    """OffloadPrep on the training host through ``PrepPipeline``: the local
    two thirds of every minibatch on the card, the rest on the storage
    engine's numpy stub; bit for bit equal to a host numpy golden, before
    and after a checkpoint into OffloadDB, a remount and a resume."""
    import numpy as np
    import torch

    from repro_torch.core.lsm import DBConfig, OffloadDB
    from repro_torch.data import OffloadPrep, PrepPipeline
    from repro_torch.data.preprocess import preprocess_image
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.kernels import preprocess as kpp

    def new_prep(fs, off):
        return OffloadPrep(fs, off, out_size=PREP_OUT, offload_ratio=1 / 3)

    def new_pipe(prep, paths):
        return PrepPipeline(prep, paths, batch=PREP_BATCH, epochs=1, seed=PREP_SEED, window=2,
                            queue_depth=2)

    t0 = time.perf_counter()
    dev, fs, fabric, off = _prep_plane()
    prep = new_prep(fs, off)
    paths = prep.materialize_corpus(PREP_IMAGES, max_side=512)
    corpus_s = time.perf_counter() - t0
    corpus_bytes = sum(fs.stat(p).size for p in paths)

    # the golden: every image through the storage node's numpy path, at the
    # pipeline's per-image seeds; where a share runs must not change a bit
    t0 = time.perf_counter()
    ref_pipe = new_pipe(prep, paths)
    order = ref_pipe._epoch_order(0)
    n_batches = ref_pipe.batches_per_epoch
    golden = []
    for b in range(n_batches):
        bseed = ref_pipe._batch_seed(0, b)
        golden.append(np.stack([
            preprocess_image(fs.read(paths[int(order[b * PREP_BATCH + i])]),
                             prep._image_seed(bseed, i), PREP_OUT)
            for i in range(PREP_BATCH)]))
    golden_s = time.perf_counter() - t0
    remote, local_ids = prep.plan_shares(PREP_BATCH)

    # the path, uninterrupted, with every count at 0 just before it
    pipe = new_pipe(prep, paths)
    times = _PrepTimes(prep)
    fa.LAUNCHES = kvmerge.LAUNCHES = kpp.LAUNCHES = 0
    t0 = time.perf_counter()
    got, arrivals = [], []
    for x in pipe:
        got.append(x)
        arrivals.append((time.perf_counter() - t0) * 1e3)
    wall_s = time.perf_counter() - t0
    launches = {"preprocess": kpp.LAUNCHES, "flash_attention": fa.LAUNCHES,
                "merge": kvmerge.LAUNCHES}
    stats = dict(prep.stats)

    check(len(got) == n_batches, f"the pipeline delivered {len(got)} of {n_batches} batches")
    differing = []
    for x, want in zip(got, golden):
        check(x.is_cuda and x.dtype == torch.float64
              and tuple(x.shape) == want.shape, f"a batch is {x.device} {x.dtype} {x.shape}")
        differing.append(int((x.cpu().numpy().view(np.int64) != want.view(np.int64)).sum()))
    check(all(d == 0 for d in differing),
          f"batches differ from the host numpy golden in {differing} elements")
    n_local = n_batches * len(local_ids)
    check(n_local > 0 and launches["preprocess"] == n_batches,
          f"preprocess launched {launches['preprocess']} times for {n_batches} local shares")
    planned = {"local": n_local, "offloaded": n_batches * sum(len(i) for _, i in remote),
               "rejected": 0, "rerouted": 0}
    check(stats == planned, f"prep.stats {stats}, planned {planned}")

    # checkpoint after two batches into OffloadDB on the same volume, crash,
    # remount, recover, resume: the rest equals the uninterrupted run
    db = OffloadDB(fs, off, DBConfig(memtable_bytes=1 << 16))
    pipe = new_pipe(new_prep(fs, off), paths)
    it = iter(pipe)
    resumed = [next(it) for _ in range(2)]
    blob = pipe.checkpoint(db)
    pipe.close()
    db.flush_all()
    fs.flush_metadata()
    fabric.drain()
    _, fs2, _, off2 = _prep_plane(dev)
    db2 = OffloadDB.recover(fs2, off2)
    pipe2 = PrepPipeline.resume(new_prep(fs2, off2), paths, db2)
    check(pipe2.state.cursor == 2 and pipe2.state.epoch == 0,
          f"resumed at epoch {pipe2.state.epoch} cursor {pipe2.state.cursor}")
    resumed.extend(pipe2)
    check(len(resumed) == n_batches
          and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(resumed, got)),
          "the resumed run differs from the uninterrupted run")

    per_batch = times.batches
    emit("prep", images=PREP_IMAGES, batch=PREP_BATCH, out_size=PREP_OUT, batches=n_batches,
         local_per_batch=len(local_ids), remote_per_batch=[len(i) for _, i in remote],
         corpus_bytes=corpus_bytes, corpus_s=corpus_s, golden_s=golden_s,
         wall_s=wall_s, images_per_s=PREP_IMAGES / wall_s, batch_arrival_ms=arrivals,
         per_batch=per_batch, launches=launches, stats=stats,
         golden_differing_elements=differing, checkpoint=json.loads(blob),
         resumed_bit_equal=True)
    return launches


# ------------------------------------------------------------ phase 9
class _MergeRecord:
    """While in use, records the input and the result of every
    ``ops.merge_runs`` call; the call itself is the path's, so the kernel's
    count is untouched. ``hold`` then compares each result with the plain
    k-way merge of the same runs, bit for bit."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.calls, self._ops, merge = [], ops, ops.merge_runs

        def recorded(keys, vals, offsets):
            out = merge(keys, vals, offsets)
            self.calls.append(((keys, vals, [int(o) for o in offsets]), out))
            return out

        self._merge, ops.merge_runs = merge, recorded
        return self

    def __exit__(self, *exc):
        self._ops.merge_runs = self._merge

    def leaves(self):
        """The lengths of the streams that the merges took."""
        return [b - a for (_, _, off), _ in self.calls for a, b in zip(off[:-1], off[1:])]

    def hold(self, what: str) -> dict:
        import torch

        from repro_torch.kernels import ref

        for n, ((keys, vals, off), out) in enumerate(self.calls):
            merge_errors(out, ref.merge_runs_ref(keys, vals, torch.tensor(off)),
                         f"{what}: merge {n}")
        return {"merges_held": len(self.calls),
                "runs": [[b - a for a, b in zip(off[:-1], off[1:])]
                         for (_, _, off), _ in self.calls],
                "distinct_keys": [int(out[0].unique().numel()) for _, out in self.calls]}


def _distinct_prefix_streams(lengths, seed):
    """Row streams of the given lengths, as the engines return them (sorted,
    unique keys in each, lower rank newer): keys whose first 4 bytes are
    distinct random values, a quarter of them in two streams at different
    ranks, so that the merge of 4-byte prefixes alone decides the order."""
    import random

    rng = random.Random(seed)
    pool = rng.sample(range(0xFFFFFFFE), int(sum(lengths) * 0.8) + 1)
    streams = []
    for s, n in enumerate(lengths):
        ids = sorted(rng.sample(pool, min(n, len(pool))))
        streams.append([(i.to_bytes(4, "big") + b"#row", s, rng.randbytes(8)) for i in ids])
    return streams


def phase_pushdown():
    """OffloadDB's pushdown scan at fig21's corpus shape on a 4-stripe
    volume behind 4 engines (``tests/pushdown_util.py``'s plane): rows
    equal the local scan's, the per-stripe streams merge on the card, and
    each of the scan's merges equals the plain merge bit for bit. fig21's
    keys all share the prefix ``user``, so there the merge orders nothing;
    streams of the same lengths with distinct prefixes then go through
    ``merge_row_streams`` on the card against a plain host merge."""
    import random

    from repro_torch.core import (AcceptAll, BlockDevice, OffloadEngine, OffloadFS,
                                  RpcFabric, TaskOffloader, serve_engine)
    from repro_torch.core import pushdown as P
    from repro_torch.core.lsm import DBConfig, OffloadDB
    from repro_torch.core.lsm import compaction as C
    from repro_torch.kernels import kvmerge

    fs = OffloadFS(BlockDevice(num_blocks=1 << 17), node="init0", shards=4)
    fabric = RpcFabric()
    for t in range(4):
        eng = OffloadEngine(fs, node=f"storage{t}")
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        P.register_pushdown_stub(eng)
        serve_engine(eng, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0", targets=[f"storage{t}" for t in range(4)],
                        lb_policy="placement_affinity")
    db = OffloadDB(fs, off, DBConfig(memtable_bytes=1 << 20, log_recycling=False,
                                     l0_cache=False, l0_trigger=999))

    # benchmarks/fig21_pushdown.py's load_corpus: keys in random order, a
    # one-byte tag (A 1 %, B 9 %, C 30 %, D 60 %) and 240 bytes of value
    t0 = time.perf_counter()
    rng = random.Random(21)
    pad = bytes(240)
    tag_p = ((b"A", 0.01), (b"B", 0.09), (b"C", 0.40), (b"D", 1.00))
    for i in rng.sample(range(PUSHDOWN_KEYS), PUSHDOWN_KEYS):
        r = rng.random()
        db.put(f"user{i:08d}".encode(), next(t for t, p in tag_p if r < p) + pad)
    db.flush_all()
    load_s = time.perf_counter() - t0

    prog = P.build_scan(b"user", b"userz", where=P.or_(P.prefix(P.value(), b"A"),
                                                       P.prefix(P.value(), b"B")))
    t0 = time.perf_counter()
    rows_local = db.scan(program=prog, pushdown=False)
    local_s = time.perf_counter() - t0
    kvmerge.LAUNCHES = 0
    fabric.drain()
    b0 = fabric.total_bytes()
    with _MergeRecord() as scan_merges:
        t0 = time.perf_counter()
        rows_push = db.scan(program=prog, pushdown=True)
        push_s = time.perf_counter() - t0
    launches = kvmerge.LAUNCHES
    fabric.drain()
    wire = fabric.total_bytes() - b0
    check(rows_push == rows_local, f"pushdown rows ({len(rows_push)}) differ from the "
                                   f"local scan's ({len(rows_local)})")
    check(launches == len(scan_merges.calls) == 1,
          f"the pushdown scan launched the merge kernel {launches} times "
          f"({len(scan_merges.calls)} merges recorded), want once")
    held_scan = scan_merges.hold("pushdown scan")
    check(not fs._leases, "the scans leaked a lease")

    # the same fold at the scan's stream lengths, with distinct prefixes
    lengths = scan_merges.leaves()
    streams = _distinct_prefix_streams(lengths, seed=22)
    want = []
    for r in sorted((r for s in streams for r in s), key=lambda r: (r[0], r[1])):
        if not want or want[-1][0] != r[0]:
            want.append(r)
    with _MergeRecord() as distinct_merges:
        got = P.merge_row_streams(streams, "cuda")
    check(got == want, "merge_row_streams on distinct prefixes differs from the plain "
                       "host merge")
    check(len(distinct_merges.calls) == 1, "the distinct-prefix merge took more than one call")
    held_distinct = distinct_merges.hold("distinct prefixes")
    emit("pushdown", keys=PUSHDOWN_KEYS, value_bytes=241, tables=len(db.tables), stripes=4,
         rows=len(rows_push), selectivity=len(rows_push) / PUSHDOWN_KEYS, load_s=load_s,
         local_scan_s=local_s, pushdown_scan_s=push_s, pushdown_wire_bytes=wire,
         merge_launches=launches, rows_equal=True, scan_merges=held_scan,
         distinct_prefix_merge={"stream_lengths": lengths, "rows_out": len(got),
                                "rows_equal": True, **held_distinct})
    return launches, {"scan": scan_merges.calls[0][0],
                      "scan_distinct_prefixes": distinct_merges.calls[0][0]}


# ------------------------------------------------------------ phases 11-13
@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block: an op
    with no deterministic kernel raises, naming itself."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _batch_on(b, device):
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in b.items()}


def _max_err(got, want) -> float:
    return (got.detach().cpu().double() - want.detach().double()).abs().max().item()


def phase_train_small():
    """One AdamW ``make_train_step`` step of qwen3-1.7b:smoke in f32 at S =
    2,304 (the chunked twin's branch) on the card against the same step on
    the CPU from the same params: loss and grad_norm within a relative
    1e-4 (f32 sums in another order), AdamW's m (0.1 × the clipped
    gradient) and v within 1e-4 of each leaf's largest value, every param
    within lr / 10 (a lost gradient moves a param by lr × sign(g) on one
    side only). The flash kernel must not launch: it has no backward."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32)
    model = build_model(cfg)
    lr = 3e-4
    opt = optim.adamw(lr=lr)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    b = TokenPipeline(cfg.vocab_size, 2, TRAIN_SMALL_S).next_batch()
    step = make_train_step(model, opt)
    states, metrics, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        state = init_state(model, opt, params=tree_map(lambda t: t.to(dev, copy=True), params))
        f0 = fa.LAUNCHES
        with deterministic():
            states[dev], m = step(state, _batch_on(b, dev))
        metrics[dev] = {k: float(v) for k, v in m.items()}
        launches[dev] = fa.LAUNCHES - f0
    torch.cuda.synchronize()
    g, c = metrics["cuda"], metrics["cpu"]
    check(launches["cuda"] == 0, f"the train step launched flash {launches['cuda']} times")
    for k in ("loss", "grad_norm", "ce", "zloss"):
        check(math.isfinite(g[k]) and abs(g[k] - c[k]) <= 1e-4 * abs(c[k]),
              f"train_small {k}: card {g[k]} CPU {c[k]}")
    errs = {}
    for (path, a), (_, w) in zip(tree_flatten_with_path(states["cuda"]),
                                 tree_flatten_with_path(states["cpu"])):
        name = "/".join(map(str, path))
        err = _max_err(a, w)
        tol = lr / 10 if path[0] == "params" else 1e-4 * w.abs().max().item()
        check(err <= tol, f"train_small {name}: card and CPU differ by {err} > {tol}")
        errs[name] = err
    worst = {k: max(e for n, e in errs.items() if n.startswith(k))
             for k in ("params", "opt/m", "opt/v")}
    emit("train_small", model=cfg.name, seq=TRAIN_SMALL_S, batch=2, metrics_card=g,
         metrics_cpu=c, leaves=len(errs), max_abs_err=worst,
         flash_launches=launches["cuda"], tol={"loss": "rel 1e-4", "params": lr / 10,
                                               "moments": "1e-4 x leaf max"})
    return launches["cuda"]


class _PrepBatchRecord:
    """While in use, keeps a host copy of every minibatch that a
    ``PrepPipeline`` delivers, with what the host numpy golden of that
    minibatch needs: its images' bytes and per-image seeds and which of its
    images the card preprocessed. The delivery itself is the path's, so the
    kernel's count is untouched. ``hold`` then compares each minibatch with
    the golden, bit for bit."""

    def __enter__(self):
        from repro_torch.data.ingest import PrepPipeline

        self.batches, self._cls, deliver = [], PrepPipeline, PrepPipeline.__next__

        def recorded(pipe):
            x = deliver(pipe)
            st, b = pipe.state, pipe.state.batch
            # the cursor counts the epoch's delivered minibatches, 0 after its last
            epoch, idx = ((st.epoch - 1, pipe.batches_per_epoch - 1) if st.cursor == 0
                          else (st.epoch, st.cursor - 1))
            order, seed = pipe._epoch_order(epoch), pipe._batch_seed(epoch, idx)
            prep = pipe.prep
            self.batches.append({
                "got": x.cpu().numpy(), "is_cuda": x.is_cuda, "out": prep.out_size,
                "local": prep.plan_shares(b)[1],
                "images": [(prep.fs.read(pipe.paths[int(order[idx * b + i])]),
                            prep._image_seed(seed, i)) for i in range(b)]})
            return x

        self._deliver, PrepPipeline.__next__ = deliver, recorded
        return self

    def __exit__(self, *exc):
        self._cls.__next__ = self._deliver

    def hold(self) -> dict:
        import numpy as np

        from repro_torch.data.preprocess import preprocess_image

        differing, local_differing = [], []
        for n, r in enumerate(self.batches):
            want = np.stack([preprocess_image(raw, seed, r["out"]) for raw, seed in r["images"]])
            got = r["got"]
            check(r["is_cuda"] and got.dtype == np.float64 and got.shape == want.shape,
                  f"prep minibatch {n} is {got.dtype} {got.shape} (cuda {r['is_cuda']}), "
                  f"the golden {want.shape}")
            diff = got.view(np.int64) != want.view(np.int64)
            differing.append(int(diff.sum()))
            local_differing.append(int(diff[r["local"]].sum()))
        check(all(d == 0 for d in differing),
              f"prep minibatches differ from the host numpy golden in {differing} elements "
              f"({local_differing} of them in the card's shares)")
        return {"minibatches_held": len(self.batches),
                "shape": list(self.batches[0]["got"].shape),
                "card_images_per_minibatch": len(self.batches[0]["local"]),
                "golden_differing_elements": differing}


def phase_train_e2e():
    """``train.e2e.run`` at paper-lm-100m, full width, prep ingest: the
    crash run (checkpoints every 4 steps, crash after 8, recover, restore,
    resume) with every count at 0 just before it, then an uninterrupted
    run from the same init, both on the card. Every minibatch the crash run
    consumed (out 32, crops of at most 128 px, six of eight images on the
    card) is held against the host numpy golden, bit for bit."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge
    from repro_torch.kernels import preprocess as kpp
    from repro_torch.train import e2e

    def quiet(*_):
        pass

    kw = dict(steps=E2E_STEPS, ingest="prep", device="cuda", log=quiet)
    with deterministic():
        with _PrepBatchRecord() as record:
            fa.LAUNCHES = kvmerge.LAUNCHES = kpp.LAUNCHES = 0
            t0 = time.perf_counter()
            crash = e2e.run(ckpt_every=E2E_CKPT_EVERY, kill_at=E2E_KILL_AT, **kw)
            crash_s = time.perf_counter() - t0
        launches = {"preprocess": kpp.LAUNCHES, "flash_attention": fa.LAUNCHES,
                    "merge": kvmerge.LAUNCHES}
        t0 = time.perf_counter()
        whole = e2e.run(ckpt_every=0, kill_at=E2E_STEPS, **kw)
        whole_s = time.perf_counter() - t0
    del crash["state"], whole["state"]
    torch.cuda.empty_cache()

    want = dict(whole["losses"])
    check(len(want) == E2E_STEPS and all(math.isfinite(x) for x in want.values()),
          f"uninterrupted losses {whole['losses']}")
    rs = crash["restored_step"]
    check(rs is not None and 0 < rs <= E2E_KILL_AT, f"restored at step {rs}")
    resumed = [[s, x] for s, x in crash["losses"][E2E_KILL_AT:]]
    check([s for s, _ in resumed] == list(range(rs + 1, E2E_STEPS + 1)),
          f"resumed steps {[s for s, _ in resumed]}")
    differ = [s for s, x in resumed if x != want[s]]
    check(not differ, f"resumed losses differ from the uninterrupted run's at steps {differ}")
    saved = [j for s, j in crash["saved_pipe"] if s == rs][0]
    check(crash["restored_pipe"] == saved, "the restored ingest state differs from the saved")
    local_per_batch = 8 - int(8 / 3)
    prep = {k: sum(st[k] for st in crash["prep_stats"]) for k in crash["prep_stats"][0]}
    shares = prep["local"] // local_per_batch
    check(prep["rejected"] == prep["rerouted"] == 0 and prep["local"] % local_per_batch == 0
          and launches["preprocess"] == shares >= len(crash["losses"]),
          f"preprocess launched {launches['preprocess']} times for {shares} local shares "
          f"({prep})")
    check(launches["merge"] == 0 and launches["flash_attention"] == 0,
          f"the train path launched {launches}")
    check(len(record.batches) == len(crash["losses"]),
          f"{len(record.batches)} minibatches recorded for {len(crash['losses'])} steps")
    held = record.hold()
    emit("train_e2e", model=crash["arch"], n_params=crash["n_params"], steps=E2E_STEPS,
         ckpt_every=E2E_CKPT_EVERY, kill_at=E2E_KILL_AT, volume_bytes=e2e.VOLUME_BLOCKS * 4096,
         restored_step=rs, losses=crash["losses"], uninterrupted_losses=whole["losses"],
         resumed_bit_equal=True, restored_cursor=json.loads(crash["restored_pipe"])["cursor"],
         restored_epoch=json.loads(crash["restored_pipe"])["epoch"],
         step_ms=crash["step_ms"], uninterrupted_step_ms=whole["step_ms"],
         checkpoints=crash["checkpoints"], restore_ms=crash["restore_ms"],
         memtable_bytes=crash["memtable_bytes"], cache_blocks=crash["cache_blocks"],
         prep_golden=held, db_stats=crash["db_stats"], rpc_bytes=crash["rpc_bytes"],
         prep_stats=prep,
         launches=launches, local_shares=shares, crash_run_s=crash_s,
         uninterrupted_run_s=whole_s)
    return launches


def phase_train():
    """qwen3-1.7b at full width: 28 layers, bf16 compute over f32 params,
    remat per layer, S 4,096, batch 2 (the train_4k cell's global batch of
    256 cut to 2), the first three AdamW steps of ``for_config``'s
    10,000-step schedule on one TokenPipeline batch, the loss after them,
    then one step at microbatches 2."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_eval_step, make_train_step

    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    opt = optim.for_config(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, opt, torch.Generator("cuda").manual_seed(0))
    batch = _batch_on(TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ).next_batch(),
                      "cuda")
    step = make_train_step(model, opt)
    f0 = fa.LAUNCHES
    losses, norms, ms = [], [], []
    with deterministic():
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        after = float(make_eval_step(model)(state["params"], batch)["loss"])
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m2 = make_train_step(model, opt, microbatches=2)(state, batch)
        torch.cuda.synchronize()
        mb2_ms = (time.perf_counter() - t0) * 1e3
    mb2_loss = float(m2["loss"])
    flash = fa.LAUNCHES - f0
    check(all(math.isfinite(x) for x in losses + norms + [after, mb2_loss]),
          f"non-finite loss or grad_norm: {losses} {norms} {after} {mb2_loss}")
    # the schedule's warmup starts at lr 0 (as JAX's): step 1 moves nothing,
    # so step 2 sees the same params and loss; every later update lowers it
    check(losses[1] == losses[0], f"step 1 (lr 0) changed the loss: {losses}")
    falls = losses[1:] + [after]
    check(all(b < a for a, b in zip(falls, falls[1:])), f"the loss did not fall: {losses} "
          f"then {after}")
    check(abs(mb2_loss - after) <= 1e-3, f"microbatches 2 loss {mb2_loss} vs {after}")
    check(flash == 0, f"the train steps launched flash {flash} times")
    steady = sum(ms[1:]) / len(ms[1:])
    emit("train", model=cfg.name, n_params=model.n_params(), layers=cfg.num_layers,
         seq=TRAIN_SEQ, batch=TRAIN_BATCH, remat=cfg.remat, compute_dtype=str(cfg.compute_dtype),
         losses=losses, loss_after=after, grad_norms=norms, step_ms=ms,
         first_step_ms=ms[0], steady_step_ms=steady,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3),
         max_memory_allocated=peak, microbatches2_loss=mb2_loss, microbatches2_ms=mb2_ms,
         max_memory_allocated_with_mb2=torch.cuda.max_memory_allocated(),
         flash_launches=flash, cut="global batch 256 -> 2 sequences")
    del state
    torch.cuda.empty_cache()
    return flash


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    import repro_torch.kernels.build  # noqa: F401  (the port must be here)

    info = phase_device()
    seconds = {}

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    timed_phase("build", phase_build)
    fa_rec = timed_phase("kernels", phase_kernels)
    pp_rec = timed_phase("kernels_preprocess", phase_kernels_preprocess)
    timed_phase("small", phase_small)
    launches, nchunks, nruns, main_tokens = timed_phase("main", phase_main)
    failover_launches = timed_phase("failover", phase_failover, main_tokens.cpu())
    arch_launches = timed_phase("archs", phase_archs)
    prep_launches = timed_phase("prep", phase_prep)
    pushdown_launches, scans = timed_phase("pushdown", phase_pushdown)
    merges = timed_phase("merge_at_path", time_merge_at_path, nchunks, nruns, scans)
    emit("merge_at_path", cases=merges)
    mg_rec = merges["fetch"]
    small_flash = timed_phase("train_small", phase_train_small)
    e2e_launches = timed_phase("train_e2e", phase_train_e2e)
    train_flash = timed_phase("train", phase_train)
    emit("phase_seconds", **seconds)
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": launches["flash_attention"], "max_abs_err": fa_rec["max_abs_err"],
         "launches_by_path": {"serve": launches["flash_attention"],
                              "failover": failover_launches["flash_attention"],
                              "archs": arch_launches["flash_attention"],
                              "train_small": small_flash,
                              "train_e2e": e2e_launches["flash_attention"],
                              "train": train_flash},
         "rel_err": fa_rec["rel_err"], "row_rel_err": fa_rec["row_rel_err"],
         "ms": fa_rec["ms"], "plain_ms": fa_rec["plain_ms"], "bound_ms": fa_rec["bound_ms"],
         "bound_by": fa_rec["bound_by"], "library_ms": fa_rec["library_ms"],
         "ms_over_library": fa_rec["ms_over_library"], "arch_shapes": fa_rec["arch_shapes"]},
        {"name": "merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merge.cu",
         "replaces": "src/repro/kernels/kvmerge.py:24",
         "launches": launches["merge"], "max_abs_err": mg_rec["max_abs_err"],
         "payload_mismatches": mg_rec["payload_mismatches"],
         "launches_by_path": {"serve": launches["merge"],
                              "failover": failover_launches["merge"],
                              "archs": arch_launches["merge"], "pushdown": pushdown_launches,
                              "train_e2e": e2e_launches["merge"]},
         "ms": mg_rec["ms"], "plain_ms": mg_rec["plain_ms"], "bound_ms": mg_rec["bound_ms"],
         "bound_by": mg_rec["bound_by"], "library_ms": mg_rec["library_ms"]},
        {"name": "preprocess", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/preprocess.cu",
         "replaces": "src/repro/kernels/preprocess.py:41",
         "launches": prep_launches["preprocess"], "max_abs_err": pp_rec["max_abs_err"],
         "launches_by_path": {"prep": prep_launches["preprocess"],
                              "train_e2e": e2e_launches["preprocess"]},
         "differing_elements": pp_rec["differing_elements"],
         "ms": pp_rec["ms"], "plain_ms": pp_rec["plain_ms"], "bound_ms": pp_rec["bound_ms"],
         "bound_by": pp_rec["bound_by"], "library_ms": pp_rec["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

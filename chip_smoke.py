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
               8,192, at the archs path's GQA groups of 16 and 4, at the
               families path's shapes (head_dim 96 with group 1 at S 5,120;
               group 3 at 64; group 6 at 128 with softcap 30; head_dim 96
               in f32), at the recurrent_encdec path's (seamless's
               encoder, non-causal over 3,072 frames, and its decoder, both
               16 heads of 64), at granite-4.0-h-small's NoPE layers (G 4,
               D 128, S 2,304 and 7,680, logits times 1/128 in place of
               1/√128), non-causal, softcapped, ragged and in f32 (the
               f32 kernel also at the small phase's shape, at the prefill
               shape, and with softcap and q scaled by 8, checked only; its
               bound counts f32-accurate products at 495 / 3 TFLOP/s), each
               with its time over SDPA's (softcapped: over a compiled
               ``flex_attention`` with a tanh ``score_mod``, held to the
               plain version too); the two-run merge at edges and 2^20
               keys; the per-image preprocess at edges, and the batch
               preprocess over one minibatch's local share (171 crops of
               the corpus) beside the per-image loop it replaces; the SSD
               scan (``kernels_ssd``) at granite-4.0-h-small's and
               jamba-1.5-large's widths, with and without an entering
               state, against ``ssd_chunked`` in f32 plus the D skip, twice
               for the same bits, and at granite's widths at S 2,304 and
               7,680 (one ``ssd_s<S>`` line each) timed beside
               ``ssd_chunked`` and against its bound; the RMSNorm kernel
               (``kernels_rmsnorm``) from the head's one row to a short
               batch's 16,384 at d 4,096 and 5,120 against the plain
               formula (within one bf16 ulp, 99 % bit-equal, the same bits
               twice), one ``rmsnorm_r<rows>_d<d>`` line a shape with its
               time over copies of x past L2, the plain formula's and its
               bound;
  4. small   — a smoke-width model on the card against the same model on
               the CPU (plain versions) at a prompt that takes the flash path,
               in f32: the f32 flash kernel once a layer per prefill;
  5. main    — qwen3-1.7b at full width (random weights from a seed) through
               ``serve.generate``: cold (prefill, put, fetch, decode) and
               warm (attach, no prefill) through a KV-cache store on an
               OffloadFS volume behind 4 storage engines, and in memory;
               tokens must agree, every fetched cache must equal the
               prefill's bit for bit, and the path must launch both kernels:
               flash once a layer per prefill, the k-way merge once a fetch
               that arrived in more than one run;
  6. paper_figures — the paper's evaluation on the port, device the card:
               ``benchmarks_torch``'s fig18 (OffloadPrep through
               ``PrepPipeline``), fig20 (the serving plane) and fig21
               (pushdown) at ``--smoke``, every row and claim printed; fig20's
               Part A at qwen3-1.7b's full width on the ``main`` phase's
               model, params, prompt and stored cache (attach against
               recompute, the fetched cache the one put, bit for bit); and
               ``examples_torch/serving.py``; a crash or a failed claim that
               is not a wall-clock one fails the smoke;
  7. failover — the main path's model, prompts and new tokens on the main
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
  8. archs   — glm4-9b, granite-3-8b and mistral-nemo-12b at full width and
               depth (f32 params, bf16 compute, random weights), one after
               the other: in memory, and glm4-9b also cold and warm through
               the main path's store; flash once a layer per prefill (GQA
               groups of 16 and 4), tokens equal across runs, logits finite,
               ``n_params`` the JAX package's; each arch (here and in
               ``families``) first runs one untimed prefill, so that the
               runs' prefill times are warm;
  9. families — the vision frontend, MoE and Mamba-2 SSD, one arch after
               the other (f32 params, bf16 compute, random weights):
               phi-3-vision-4.2b at full width and depth (a stub frontend
               of 1,024 embeddings before 4,096 text tokens; flash once a
               layer at head_dim 96, group 1) in memory, and at ``:smoke``
               cold and warm through the main path's store with the same
               frontend; granite-moe-3b-a800m at full width and depth in
               memory, cold and warm (flash at group 3; fetched caches the
               prefill's bit for bit); grok-1-314b at full width with its
               depth cut to 4 layers (peak under 70 GB; flash at group 6,
               softcap 30) in memory; jamba-1.5-large-398b at ``:smoke``
               (f32) on the card against the CPU, then cold and warm
               through the store; one Mamba-2 layer at jamba's full widths
               (f32) in prefill and 16 decode steps against the same layer
               over the whole sequence, then in bf16 through the SSD
               kernel, held to the errors of bf16 with the kernel off;
               one AdamW step of granite-moe,
               grok-1 and jamba at ``:smoke`` on the card against the CPU;
 10. recurrent_encdec — xLSTM and the audio encoder–decoder (f32 params,
               bf16 compute, random weights): xlstm-125m at full width and
               depth (mLSTM and sLSTM blocks, no attention) in memory, cold
               and warm through the main path's store, tokens equal, fetched
               caches (tuples of f32 recurrent state) the prefill's bit for
               bit, and the sLSTM layers' share of one more prefill; one
               mLSTM and one sLSTM block at its full widths (f32) in prefill
               and 16 decode steps against the same block in train mode;
               seamless-m4t-large-v2 at full width and depth (24 encoder
               layers over 3,072 stub audio frames, 24 decoder layers with
               cross-attention) in memory, cold and warm, fetched caches
               bit-equal, cross half included, flash once an encoder layer
               (non-causal: the encoder runs in train mode inside the
               prefill) and once a decoder layer (causal) a prefill; one
               AdamW step of both at ``:smoke`` on the card against the CPU;
 11. prep    — OffloadPrep through ``PrepPipeline`` on 1,024 images of the
               synthetic corpus (sides 64-512) on a volume behind one
               storage engine: a third of each 256-image minibatch
               preprocessed by the engine's numpy stub, the rest on the card
               by one batch preprocess launch a minibatch; every batch bit
               for bit equal to a host numpy golden, before and after a
               checkpoint into OffloadDB, a remount and a resume;
 12. pushdown — OffloadDB on a 4-stripe volume behind 4 engines, 200,000
               keys of fig21's shape, a ~10 % filter: the pushdown scan,
               merged on the card by one k-way merge launch, equals the
               local scan, and its merge equals the plain merge bit for
               bit. fig21's keys all tie on their 4-byte prefix, so the
               merge there orders nothing: streams of the scan's lengths
               with distinct prefixes go through ``merge_row_streams`` on
               the card against a plain host merge;
 13. merge_at_path — the k-way merge timed at the path's shapes (a fetch's
               900 chunk indices in its runs and in 900 runs of one, the
               scan's and the distinct-prefix streams) against its plain
               version, one stable sort and, at the fetch, the two-run fold
               it replaces; each bit for bit;
 14. train_small — one AdamW ``make_train_step`` step of qwen3-1.7b:smoke
               (f32) at S = 2,304, past the flash threshold, on the card
               against the same step on the CPU: loss, grad_norm, every
               param and moment; the flash kernel must not launch (the
               train path runs the differentiable chunked twin);
 15. train_e2e — ``repro_torch.train.e2e.run`` on paper-lm-100m at full
               width with prep ingest: 9 steps, a checkpoint into OffloadDB
               every 4, a crash after step 8, recover, restore, resume; the
               resumed losses bit for bit those of an uninterrupted run, the
               restored ingest state the one saved, every minibatch the
               crash run consumed bit for bit the host numpy golden (out
               32), one preprocess launch per minibatch, no merge launch;
 16. train     — qwen3-1.7b at full width (28 layers, bf16 compute over f32
               params, remat) at S 4,096, batch 2: the first three AdamW
               steps of ``for_config``'s schedule on one batch (finite,
               falling loss), then one at microbatches 2.
 17. distribution — qwen3-1.7b at full width, each of its cells planned by
               ``launch.specs.plan_cell`` on a real 1x1 DeviceMesh (NCCL,
               a world of one) and run under the plan's sharding rules
               with its arguments DTensors at the plan's placements,
               against the same call on plain tensors: train_4k (batch
               cut 256 -> 4, 4 microbatches; every param and moment, loss
               and grad_norm bit-equal), prefill_32k (32 -> 2; logits,
               greedy tokens and the 7.5 GB cache bit-equal; flash once a
               layer in each run) and decode_32k (128 -> 8; one step
               against a 30.1 GB cache, tokens, logits and the written
               slots bit-equal); each variant's first call, then the
               median of 3 more and their peak memory (on a 1x1 mesh every
               placement is Replicate: the sharded arithmetic is held
               against the plain path on a 2x2 mesh of CPU processes by
               ``tests/test_torch_launch.py``); then the
               dry run of those cells at full batch on the fake 16x16 and
               2x16x16 meshes in a child process (6 OK, 2 SKIP, every OK
               row with collective bytes, a peak and the three roofline
               terms) and a plan of all 32 cells x 2 meshes. The same for
               xlstm-125m at full width and depth (train_4k 256 -> 2 with
               its sequence cut 4,096 -> 512; prefill_32k 32 -> 1 with
               its sequence cut 32,768 -> 4,096;
               decode_32k 128 -> 8, the whole recurrent state bit-equal),
               the first run of its per-shard loops and of the mLSTM
               gate's sharding strategy on the card, and
               seamless-m4t-large-v2's prefill_32k (32 -> 1; 24 non-causal
               and 24 causal flash launches a call, through the flash op's
               sharding strategy under the rules); its dry run of all 4
               cells x 2 meshes in parallel processes beside the card work
               (8 OK).

The train phases, and distribution's train cell, run under
``torch.use_deterministic_algorithms(True)``,
with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts.

Then a ``phase_seconds`` line, a ``phase_launches`` line (each kernel's
host calls by phase), the ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the softcapped flash cases' library yardstick is compiled by inductor: its
# caches go under the checkout's build/, and it compiles in this process
# (no pool of worker processes left behind)
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
# f32-accurate products on the tensor cores (3xTF32: three TF32 products
# each), f64 outside them, HBM bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F32_3XTF32 = 495e12 / 3
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12

# main-path shape: qwen3-1.7b at full width, two 4,096-token prompts
BATCH, PROMPT, STEPS = 2, 4096, 16
MAX_LEN = PROMPT + STEPS
# the small phase's prompt, past the flash threshold (2,048)
SMALL_S = 2304

# prep path: OffloadPrep's defaults (out 224, a third offloaded) on the
# corpus's own size distribution, 4 minibatches of 256
PREP_IMAGES, PREP_BATCH, PREP_OUT, PREP_SEED = 1024, 256, 224, 5
# pushdown path: fig21's corpus shape (240-byte values) at 200,000 keys
PUSHDOWN_KEYS = 200_000
# train paths: the chunked twin's first length; train_e2e.py's defaults
# (batch 8, seq 128, prep ingest at out 32) for 9 steps, a checkpoint every
# 4, a crash after 8 (the saves at 4 and 8 before it, as the step-8
# generation is not yet durable, and the one at 8 after it: the fewest
# saves this flow can have); qwen3 at the train_4k cell's length, batch 2
# (the cell's global batch of 256 cut to 2)
TRAIN_SMALL_S = 2304
E2E_STEPS, E2E_CKPT_EVERY, E2E_KILL_AT = 9, 4, 8
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
# families path: the JAX package's n_params() at full width; phi-3-vision's
# stub frontend (1,024 patch embeddings, seed 2); grok-1-314b cut to the
# most layers whose peak stays under 70 GB (5 layers' f32 params alone are
# 18.1 B x 4 bytes = 72.4 GB); the :smoke prompts (jamba's a multiple of
# its SSD chunk, both under the flash threshold); one Mamba-2 layer at
# jamba's widths at the main path's shape; the families' train steps at S 256
FAMILIES = {"phi-3-vision-4.2b": 3_821_079_552, "granite-moe-3b-a800m": 3_374_295_552,
            "grok-1-314b": 213_410_125_824, "jamba-1.5-large-398b": 397_644_798_720}
FRONTEND_SEED = 2
GROK_LAYERS, PEAK_LIMIT = 4, 70e9
JAMBA_SMOKE_S, SMOKE_PROMPT = 2048, 256
FAMILY_TRAIN_S = 256
# SSD scan kernel (kernels_ssd): granite-4.0-h-small's widths (H 128, N
# 128) and jamba-1.5-large's (H 256, N 64), P 64, chunks of 256; each case
# its name, widths, batch, S, whether an entering state is given, and
# whether x is a strided view of the conv's output (as the model hands it);
# timed at granite's widths, batch 1, at the lengths in SSD_TIMED
SSD_GRANITE, SSD_JAMBA = {"H": 128, "N": 128}, {"H": 256, "N": 64}
SSD_P, SSD_CHUNK = 64, 256
SSD_CASES = [
    ("granite_s256", SSD_GRANITE, 1, 256, False, True),
    ("granite_s256_h0", SSD_GRANITE, 1, 256, True, True),
    ("granite_s2304", SSD_GRANITE, 1, 2304, False, True),
    ("granite_s2304_h0", SSD_GRANITE, 1, 2304, True, False),
    ("granite_s7680", SSD_GRANITE, 1, 7680, False, True),
    ("granite_s7680_h0", SSD_GRANITE, 1, 7680, True, True),
    ("jamba_s256", SSD_JAMBA, 1, 256, False, True),
    ("jamba_s2304_h0", SSD_JAMBA, 1, 2304, True, True),
    ("jamba_s4096_b2", SSD_JAMBA, 2, 4096, False, True),
    ("granite_s512_b2_h0", SSD_GRANITE, 2, 512, True, False),
]
SSD_TIMED = (2304, 7680)
# RMSNorm kernel (kernels_rmsnorm): (rows, d) of the benchmark's norms, the
# head's one row to a short batch's 16,384 tokens at glm4-9b's and
# mistral-nemo-12b's widths, bf16 x and scale; each timed over enough copies
# of x that one pass over them exceeds the 50 MB L2 (RMS_STREAM_BYTES)
RMS_SHAPES = ((1, 4096), (2304, 4096), (7680, 4096), (16384, 4096), (2304, 5120),
              (7680, 5120), (16384, 5120))
RMS_STREAM_BYTES = 256e6
# the full-width Mamba layer's bf16 errors against f32 through the kernel,
# as a multiple of the same errors with the kernel turned off
MAMBA_BF16_ERR_RATIO = 1.05
# recurrent_encdec path: the JAX package's n_params() at full width;
# seamless's stub audio frontend is its config's frontend_seq frames
RECURRENT_ENCDEC = {"xlstm-125m": 188_954_184, "seamless-m4t-large-v2": 1_632_256_000}
SEAMLESS_FRAMES = 3072


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# each kernel library's C entry points, whose successful calls
# ``build.LAUNCHES`` counts by name; a phase reports their sum
KERNEL_ENTRIES = {"flash_attention": ("fa_forward",), "merge": ("merge_sorted", "merge_runs"),
                  "preprocess": ("preprocess_image", "preprocess_batch"),
                  "ssd": ("ssd_forward",), "rms_norm": ("rms_norm",)}


def launched(kernel: str) -> int:
    """Calls of ``kernel``'s C entries so far in this process (``ssd``:
    host calls of four kernel launches each)."""
    from repro_torch.kernels import build

    return sum(build.LAUNCHES[e] for e in KERNEL_ENTRIES[kernel])


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
    build.build(["flash_attention", "merge", "preprocess", "ssd", "rmsnorm"])
    emit("build", seconds=time.perf_counter() - t0, kernels=build.BUILD_LOG)


# ------------------------------------------------------------ phase 3
def _flash_inputs(B, S, KV, G, D, dtype, seed, qscale=1.0):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    q = (torch.randn((B, S, KV, G, D), generator=g, device="cuda") * qscale).to(dtype)
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


def flex_softcap_library(q, k, v, causal, cap):
    """The softcapped flash cases' library yardstick (never called by the
    port): one ``torch.compile``d ``flex_attention`` call with a tanh
    softcap ``score_mod``, a causal block mask and ``enable_gqa``, which
    computes the same softcapped GQA attention on q, k, v laid out as
    (B, heads, S, D). Returns its ms and its errors against the plain
    version (held to the kernel's tolerance, so that it is the same
    function)."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from repro_torch.kernels import ref

    B, S, KV, G, D = q.shape
    qt = q.reshape(B, S, KV * G, D).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    mask = (create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None,
                              S, S, device=q.device.type) if causal else None)
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        return flex(qt, kt, vt, score_mod=score_mod, block_mask=mask, enable_gqa=True)

    out = call().transpose(1, 2).reshape(B, S, KV, G, D)
    errs, ok = ref.flash_attention_check(out, q, k, v, causal=causal, softcap=cap)
    check(ok, f"flex_attention with softcap {cap} differs from the plain version: {errs}")
    return (time_ms(call, 10) if q.is_cuda else None), errs


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kvmerge, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions exact
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    # the prefills of the benchmark's short-batch cells (bench/traffic/
    # short_batch.json), which ``layers.attention_path`` sends to the kernel: one
    # block of lengths, B = 16,384 // S, causal, D 128, at glm4-9b's KV 2 ×
    # G 16 and mistral-nemo-12b's KV 8 × G 4
    short_batch = [(f"short_s{S}_g{G}_bf16", 16384 // S, S, KV, G, 128, torch.bfloat16,
                    True, 0.0)
                   for KV, G in ((2, 16), (8, 4))
                   for S in (512, 640, 768, 896, 1152, 1280, 1536, 1920)]
    cases = [  # name, B, S, KV, G, D, dtype, causal, softcap[, q scale[, logits scale]]
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
        # the families path's prefill shapes: phi-3-vision's 32 heads at
        # head_dim 96 over the frontend and the text (S 5,120), granite-moe's
        # 24 over 8 KV heads (group 3), grok-1's 48 over 8 (group 6) with its
        # softcap; and head_dim 96 in f32
        ("phi3v_d96_g1_bf16", BATCH, 1024 + PROMPT, 32, 1, 96, torch.bfloat16, True, 0.0),
        ("granite_moe_g3_bf16", BATCH, PROMPT, 8, 3, 64, torch.bfloat16, True, 0.0),
        ("grok_g6_softcap_bf16", BATCH, PROMPT, 8, 6, 128, torch.bfloat16, True, 30.0),
        ("d96_f32", 1, 512, 2, 2, 96, torch.float32, True, 0.0),
        # the recurrent_encdec path's: seamless-m4t-large-v2's encoder (16 heads
        # of 64, non-causal over its 3,072 frames) and its decoder's causal
        # self-attention over the prompt
        ("seamless_enc_noncausal_g1_d64_bf16", BATCH, SEAMLESS_FRAMES, 16, 1, 64,
         torch.bfloat16, False, 0.0),
        ("seamless_dec_g1_d64_bf16", BATCH, PROMPT, 16, 1, 64, torch.bfloat16, True, 0.0),
        # checked, not timed: the edges of the D 96 layout (three 32-column
        # boxes) and of the D 64 one (192-row q tiles)
        ("d96_ragged_noncausal_g2_bf16", BATCH, 1000, 2, 2, 96, torch.bfloat16, False, 0.0),
        ("d96_kv1_g4_bf16", BATCH, 777, 1, 4, 96, torch.bfloat16, True, 0.0),
        ("d64_s193_g3_bf16", BATCH, 193, 8, 3, 64, torch.bfloat16, True, 0.0),
        # grok-1's shape with q scaled by 8, which drives the scores past the
        # softcap (|s| up to about 44): what the cap's tanh is held to
        ("grok_g6_softcap_q8_bf16", BATCH, PROMPT, 8, 6, 128, torch.bfloat16, True, 30.0,
         8.0),
        # f32 at the small phase's shape (qwen3-1.7b:smoke at head_dim 64, S
        # 2,304) and at qwen3-1.7b's prefill shape; grok-1's group 6 with
        # softcap and q scaled by 8, checked only: what 3xTF32's products
        # are held to where the scores pass the cap
        ("small_path_f32", 2, SMALL_S, 2, 2, 64, torch.float32, True, 0.0),
        ("prefill_f32", BATCH, PROMPT, 8, 2, 128, torch.float32, True, 0.0),
        ("softcap_f32_q8", 1, 700, 2, 6, 128, torch.float32, True, 30.0, 8.0),
        # the benchmark's granite-4.0-h-small.long_prompt cell: its 4 NoPE
        # layers' prefill (bench/traffic/long_prompt.json: one prompt of
        # 2,304-7,680 tokens), 32 heads over 8 KV, logits times
        # attention_multiplier 1/128 where the default is 1/sqrt(128)
        ("granite_h_s2304_scale128_bf16", 1, 2304, 8, 4, 128, torch.bfloat16, True, 0.0,
         1.0, 1 / 128),
        ("granite_h_s7680_scale128_bf16", 1, 7680, 8, 4, 128, torch.bfloat16, True, 0.0,
         1.0, 1 / 128),
    ] + short_batch
    check_only = {"d96_ragged_noncausal_g2_bf16", "d96_kv1_g4_bf16", "d64_s193_g3_bf16",
                  "grok_g6_softcap_q8_bf16", "softcap_f32_q8"}

    def flash_case(name, B, S, KV, G, D, dt, causal, cap, qscale=1.0, scale=None):
        q, k, v = _flash_inputs(B, S, KV, G, D, dt, seed=len(results), qscale=qscale)
        out = fa.flash_attention(q, k, v, causal=causal, softcap=cap, scale=scale)
        # against the plain version in f32 on the same values
        errs, ok = ref.flash_attention_check(out, q, k, v, causal=causal, softcap=cap,
                                             scale=scale)
        tol = ({"atol": ref.FLASH_F32_TOL, "rtol": ref.FLASH_F32_TOL}
               if dt == torch.float32 else
               {"rel": ref.FLASH_BF16_REL_TOL, "row_rel": ref.FLASH_BF16_ROW_REL_TOL})
        rec = {"shape": [B, S, KV, G, D], "dtype": str(dt), "causal": causal,
               "softcap": cap, "qscale": qscale, "scale": scale, **errs, "tol": tol}
        emit("flash_check", case=name, **rec)
        check(ok, f"flash {name}: errors {errs} beyond {tol}")
        if name in check_only:
            results[name] = rec
            return
        rec["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                       softcap=cap, scale=scale), 10)
        rec["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, softcap=cap, scale=scale), 3, warmup=1)
        if cap:  # SDPA has no softcap; flex_attention computes the same function
            check(scale is None, f"flash {name}: the softcap yardstick takes 1/sqrt(D)")
            rec["library"] = "flex_attention"
            rec["library_ms"], rec["library_errors"] = flex_softcap_library(
                q, k, v, causal, cap)
        else:
            qt = q.reshape(B, S, KV * G, D).transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            rec["library"] = "scaled_dot_product_attention"
            rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True, scale=scale), 10)
            del qt, kt, vt
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
        flops, nbytes = _flash_work(q, k, causal)
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32_3XTF32
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, peak)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["flops"], rec["bytes"] = flops, nbytes
        results[name] = rec
        del q, k, v, out
        torch.cuda.empty_cache()

    for case in cases:
        flash_case(*case)
    emit("kernels_flash", cases=results)
    fa_rec = dict(results["prefill_bf16"])
    fa_rec["arch_shapes"] = {name: {k: results[name].get(k) for k in (
        "shape", "dtype", "softcap", "max_abs_err", "rel_err", "row_rel_err", "tol", "ms",
        "plain_ms", "library", "library_ms", "ms_over_library", "bound_ms", "bound_by",
        "share_of_bound")}
        for name in ("glm4_g16_bf16", "kv8_g4_bf16", "phi3v_d96_g1_bf16",
                     "granite_moe_g3_bf16", "grok_g6_softcap_bf16", "d96_f32",
                     "seamless_enc_noncausal_g1_d64_bf16", "seamless_dec_g1_d64_bf16")}
    fa_rec["f32_shapes"] = {name: {k: results[name].get(k) for k in (
        "shape", "causal", "softcap", "max_abs_err", "tol", "ms", "plain_ms", "library",
        "library_ms", "ms_over_library", "bound_ms", "bound_by", "share_of_bound")}
        for name in ("small_f32", "softcap_f32", "noncausal_f32", "d96_f32", "small_path_f32",
                     "prefill_f32")}
    fa_rec["short_batch_shapes"] = {name: {k: results[name].get(k) for k in (
        "shape", "rel_err", "row_rel_err", "tol", "ms", "plain_ms", "library_ms",
        "ms_over_library", "bound_ms", "bound_by", "share_of_bound")}
        for name, *_ in short_batch}
    fa_rec["scale_shapes"] = {name: {k: results[name].get(k) for k in (
        "shape", "scale", "rel_err", "row_rel_err", "tol", "ms", "plain_ms", "library_ms",
        "ms_over_library", "bound_ms", "bound_by", "share_of_bound")}
        for name in ("granite_h_s2304_scale128_bf16", "granite_h_s7680_scale128_bf16")}

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


def _ssd_inputs(w, B, S, with_h0, strided, seed):
    """The SSD scan's operands on the card, drawn as the granite cell draws
    them: x, B and C bf16 (with ``strided``, views of one wider row, as the
    conv's output is), dt = softplus(N(0, 2)), A = -exp(N(0, 1)), D N(0, 1),
    and with ``with_h0`` an entering state N(0, 1), all f32."""
    import torch
    import torch.nn.functional as F

    H, N, P = w["H"], w["N"], SSD_P
    g = torch.Generator("cuda").manual_seed(seed)
    if strided:
        xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device="cuda").bfloat16()
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = torch.randn((B, S, H, P), generator=g, device="cuda").bfloat16()
        Bm = torch.randn((B, S, N), generator=g, device="cuda").bfloat16()
        Cm = torch.randn((B, S, N), generator=g, device="cuda").bfloat16()
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda") * math.sqrt(2))
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda"))
    D = torch.randn((H,), generator=g, device="cuda")
    h0 = torch.randn((B, H, N, P), generator=g, device="cuda") if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


def ssd_work(w, B, S):
    """(FLOP, bytes) of one SSD scan call as ``bench/metrics/ssd_roofline.py``
    counts them: (N·L + H·P·L + 4·H·N·P) a token; x and y, B and C in bf16,
    dt and dt·A in f32, and the final state in f32."""
    H, N, P, L = w["H"], w["N"], SSD_P, SSD_CHUNK
    tokens = B * S
    flops = (N * L + H * P * L + 4 * H * N * P) * tokens
    nbytes = tokens * (2 * 2 * H * P + 2 * 2 * N + 2 * 4 * H) + 4 * B * H * N * P
    return flops, nbytes


def phase_kernels_ssd():
    """The SSD scan kernel (``ops.ssd_scan``) against the path it replaces,
    ``ssd_chunked`` in f32 plus the D skip (``ref.ssd_scan_check``: y within
    half a bf16 ulp plus 5e-4 of its rms, the final state to a relative
    1e-5), at each of SSD_CASES, called twice (the same bits both times),
    one kernel call each; the final state's distance from the plain version
    in f64 beside that of ``ssd_chunked`` in f32. Then, at granite's widths
    and each length of SSD_TIMED, its time beside ``ssd_chunked`` + D·x +
    the bf16 cast, its launches' device times from a profiler trace, the
    host's time a call, and its bound (``ssd_work`` at the bf16 peak and
    HBM's bandwidth). One ``kernels_ssd`` line, then one ``ssd_s<S>`` line
    a timed length; returns the kernels line's ``ssd`` record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import ssd_chunked

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain path in f32
    cases, calls = {}, 0
    for i, (name, w, B, S, with_h0, strided) in enumerate(SSD_CASES):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(w, B, S, with_h0, strided, seed=3000 + i)
        before = launched("ssd")
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=SSD_CHUNK, h0=h0)
        y2, h2 = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=SSD_CHUNK, h0=h0)
        torch.cuda.synchronize()
        n = launched("ssd") - before
        calls += n
        errs, ok = ref.ssd_scan_check(y, h, x, dt, A, Bm, Cm, D, chunk=SSD_CHUNK, h0=h0)
        _, h64 = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=SSD_CHUNK, h0=h0,
                                  compute=torch.float64)
        _, hf = ssd_chunked(x.float(), dt, dt * A, Bm.float(), Cm.float(), SSD_CHUNK, h0)
        cases[name] = {
            "B": B, "S": S, **w, "h0": with_h0, "strided": strided, **errs, "ok": ok,
            "deterministic": bool(torch.equal(y, y2) and torch.equal(h, h2)),
            "finite": bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
            "calls": n, "state_rel_err_vs_f64": _rel_err(h, h64),
            "plain_state_rel_err_vs_f64": _rel_err(hf, h64)}
        del x, dt, A, Bm, Cm, D, h0, y, h, y2, h2, h64, hf
        torch.cuda.empty_cache()
    emit("kernels_ssd", cases=cases,
         tol={"y": "half a bf16 ulp + y_rms_slack x rms", "y_rms_slack": ref.SSD_Y_RMS_SLACK,
              "state_rel": ref.SSD_STATE_REL_TOL})
    for name, c in cases.items():
        check(c["ok"] and c["deterministic"] and c["finite"] and c["calls"] == 2,
              f"ssd_scan {name}: against ssd_chunked in f32 + D x: {c}")

    timed = {}
    for S in SSD_TIMED:
        w, B = SSD_GRANITE, 1
        x, dt, A, Bm, Cm, D, _ = _ssd_inputs(w, B, S, False, True, seed=7)

        def kernel():
            return ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=SSD_CHUNK)

        def plain():
            y, h = ssd_chunked(x, dt, dt * A, Bm, Cm, SSD_CHUNK)
            return (y + x.float() * D[None, None, :, None]).to(x.dtype), h

        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 5, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):  # checks, allocations and four launches, unsynchronised
            kernel()
        host_us = (time.perf_counter() - t0) * 1e6 / 50
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        by_kernel = {ev.key[:60]: ev.device_time_total / 5 / 1e3
                     for ev in prof.key_averages() if ev.device_time_total > 0}
        flops, nbytes = ssd_work(w, B, S)
        b_ms, by = bound(flops, nbytes, PEAK_BF16)
        err = cases[f"granite_s{S}"]
        rec = {"B": B, "S": S, **w, "P": SSD_P, "chunk": SSD_CHUNK, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
               "share_of_bound": b_ms / ms, "speedup": plain_ms / ms,
               "host_us_per_call": host_us, "device_ms_by_kernel": by_kernel,
               "flops": flops, "bytes": nbytes,
               **{k: err[k] for k in ("y_ulp_ratio", "y_rel_err", "state_rel_err")}}
        emit(f"ssd_s{S}", **rec)
        timed[f"ssd_s{S}"] = rec
        del x, dt, A, Bm, Cm, D
        torch.cuda.empty_cache()
    last = timed[f"ssd_s{SSD_TIMED[-1]}"]
    return {"calls": calls,
            "y_ulp_ratio": max(c["y_ulp_ratio"] for c in cases.values()),
            "state_rel_err": max(c["state_rel_err"] for c in cases.values()),
            **{k: last[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "share_of_bound")},
            "timed_shapes": timed}


def rms_norm_work(rows: int, d: int, scale_bytes: int = 2):
    """(FLOP, bytes) of one RMSNorm call as ``bench/metrics/rms_norm_roofline.*``
    count them: x read and y written in bf16, the scale read once; four
    operations an element."""
    return 4 * rows * d, rows * d * (2 + 2) + scale_bytes * d


def phase_kernels_rmsnorm():
    """The RMSNorm kernel (``ops.rms_norm``) against the plain formula it
    replaces (``ref.rms_norm_ref``) on the same bf16 input, at each of
    RMS_SHAPES: every output within one bf16 ulp and at least 99 % bit-equal
    (``ref.rms_norm_check``), the same bits on a second call, one launch a
    call; then its device time over copies of x that stream from device
    memory, the plain formula's, the host's time a call, and its bound (bytes
    at HBM's bandwidth). One ``rmsnorm_r<rows>_d<d>`` line a shape, then
    ``kernels_rmsnorm``; returns the latter's record."""
    import torch

    from repro_torch.kernels import ops, ref

    shapes, calls = {}, 0
    for rows, d in RMS_SHAPES:
        g = torch.Generator("cuda").manual_seed(rows + d)
        copies = max(1, min(16, math.ceil(RMS_STREAM_BYTES / (4 * rows * d))))
        xs = [(3 * torch.randn((rows, d), generator=g, device="cuda")).bfloat16()
              for _ in range(copies)]
        scale = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).bfloat16()
        before = launched("rms_norm")
        y, y2 = ops.rms_norm(xs[0], scale), ops.rms_norm(xs[0], scale)
        torch.cuda.synchronize()
        n = launched("rms_norm") - before
        calls += n
        errs, ok = ref.rms_norm_check(y, xs[0], scale)
        same = bool(torch.equal(y, y2))
        check(ok and same and n == 2, f"rms_norm {rows}x{d}: {errs}, deterministic {same}")
        turn = [0]

        def next_x():
            turn[0] = (turn[0] + 1) % copies
            return xs[turn[0]]

        ms = time_ms(lambda: ops.rms_norm(next_x(), scale), 200)
        plain_ms = time_ms(lambda: ref.rms_norm_ref(next_x(), scale), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):  # the rule, the checks, the allocation and the launch
            ops.rms_norm_takes(xs[0], scale)
            ops.rms_norm(xs[0], scale)
        host_us = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
        flops, nbytes = rms_norm_work(rows, d)
        b_ms, by = bound(flops, nbytes, PEAK_BF16)
        rec = {"rows": rows, "d": d, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": by, "share_of_bound": b_ms / ms, "speedup": plain_ms / ms,
               "host_us_per_call": host_us, "copies": copies, "bytes": nbytes, **errs}
        emit(f"rmsnorm_r{rows}_d{d}", **rec)
        shapes[f"r{rows}_d{d}"] = rec
        del xs, y, y2
        torch.cuda.empty_cache()
    rec = {"calls": calls, "max_ulps": max(c["max_ulps"] for c in shapes.values()),
           "min_equal_share": min(c["equal_share"] for c in shapes.values()),
           "tol": {"max_ulps": ref.RMS_NORM_MAX_ULPS, "min_equal": ref.RMS_NORM_MIN_EQUAL},
           "shapes": shapes}
    emit("kernels_rmsnorm", **rec)
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
        head_dim=64, compute_dtype=torch.float32)  # the kernel takes D in {64, 96, 128}
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, SMALL_S), dtype=torch.int32,
                           generator=torch.Generator("cpu").manual_seed(1))
    gpu_params = tree_map(lambda t: t.cuda(), params)
    max_len = SMALL_S + 6
    lg_cpu, _, _ = model.apply(params, {"tokens": prompt}, mode="prefill", max_len=max_len)
    f0 = launched("flash_attention")
    lg_gpu, _, _ = model.apply(gpu_params, {"tokens": prompt.cuda()}, mode="prefill",
                               max_len=max_len)
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    check(torch.allclose(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4),
          f"smoke-width prefill logits differ card vs CPU: {err}")
    t_cpu = generate(model, params, prompt, steps=4, max_len=max_len)
    t_gpu = generate(model, gpu_params, prompt.cuda(), steps=4, max_len=max_len)
    check(torch.equal(t_cpu, t_gpu.cpu()), "smoke-width tokens differ card vs CPU")
    # the f32 flash kernel, once an attention layer per prefill (two prefills)
    want = 2 * sum(prefill_flash_calls(cfg, SMALL_S).values())
    flash = launched("flash_attention") - f0
    check(flash == want, f"small: {flash} f32 flash launches, expected {want}")
    emit("small", prefill_logits_max_abs_err=err, tokens_equal=True, flash_launches=flash)
    return flash


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
        fa0, mg0, f0 = launched("flash_attention"), launched("merge"), store.stats.fetches
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
               "flash_launches": launched("flash_attention") - fa0,
               "merge_launches": launched("merge") - mg0,
               "fetches": store.stats.fetches - f0,
               "runs_per_fetch": runs_per_fetch[a0:]}
        # time to first token on the decode side: the cache and the first
        # token are there (cold: prefill + put + fetch; warm: fetch)
        run["ttft_ms"] = ms["prefill"] + ms["put"] + ms["fetch"]
        return toks, run

    torch.cuda.reset_peak_memory_stats()
    base = {k: launched(k) for k in ("flash_attention", "merge")}
    cold, r_cold = drive(store)  # prefill, put, fetch, decode
    warm, r_warm = drive(store)  # attach: fetch, decode
    mem, r_mem = drive(None)  # prefill, decode
    launches = {k: launched(k) - n for k, n in base.items()}

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
    # paper_figures times fig20's Part A on this model, prompt and stored
    # cache: the timers and spies come off first
    del model.apply, store.put, store.fetch, store._assemble
    served = {"cfg": cfg, "model": model, "params": params, "prompt": prompt, "store": store,
              "put_cache": prefilled[0]}
    return launches, entry.nchunks, max(2, max(runs_per_fetch)), cold, served


# ------------------------------------------------------------ phase 6
# the paper's evaluation on the port: the figures that drive the path's
# kernels, at --smoke, and fig20's Part A at the main path's full width
PAPER_FIGURES = ("fig18_prep_pipeline", "fig20_kv_serving", "fig21_pushdown")
PART_A_REPS = 3


def phase_paper_figures(served: dict):
    """fig20's Part A at qwen3-1.7b's full width on the ``main`` phase's
    model, params, prompt and stored cache (no second init, no second put);
    then ``benchmarks_torch``'s fig18, fig20 and fig21 at ``--smoke`` with
    the device set to the card, and ``examples_torch/serving.py``. Every row
    is printed; a crash, or a failed claim that is not a wall-clock one
    (``common.WALL_CLOCK``), fails the smoke. Empties ``served``. Returns
    the phase's launches of each kernel."""
    import importlib
    import io

    from benchmarks_torch import common
    from benchmarks_torch import fig20_kv_serving as fig20
    from examples_torch import serving as serving_example

    cfg = served["cfg"]
    base = {k: launched(k) for k in ("flash_attention", "merge", "preprocess")}
    rows, argv, seconds = io.StringIO(), sys.argv, {}
    common.DEVICE, common.OUT, common.FAILURES = "cuda", rows, 0
    try:
        t0 = time.perf_counter()
        part_a = fig20.attach_vs_recompute(served["model"], served["params"], served["prompt"],
                                           served["store"], PART_A_REPS)
        part_a["identical"] = fig20.identical(served["put_cache"], part_a)
        fig20.emit_full_width(part_a, cfg.name, cfg, BATCH, PROMPT, served["store"])
        seconds["fig20_full_width"] = time.perf_counter() - t0
        # the main model goes before the figures run: a fabric's worker
        # keeps its last job, whose future holds the error a figure provoked
        # (fig20's mid-fetch kill) and, through its traceback, every frame
        # above it, this phase's and its caller's included
        del part_a["fetched"]
        served.clear()
        for name in PAPER_FIGURES:
            sys.argv = [name, "--smoke", "--device", "cuda"]
            t0 = time.perf_counter()
            importlib.import_module(f"benchmarks_torch.{name}").main()
            seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serving_example.main(["--device", "cuda"])
        seconds["examples_torch/serving.py"] = time.perf_counter() - t0
    finally:
        sys.argv, common.OUT = argv, None
    launches = {k: launched(k) - n for k, n in base.items()}
    claims = [line.split(",", 2) for line in rows.getvalue().splitlines()
              if line.startswith("claim/")]
    failed = [name[len("claim/"):] for name, value, _ in claims if value != "PASS"]
    functional = [c for c in failed if c not in common.WALL_CLOCK]
    emit("paper_figures",
         figures=["fig20_kv_serving full width (the main phase's model, prompt and stored cache)"]
         + [f"benchmarks_torch.{n} --smoke" for n in PAPER_FIGURES] + ["examples_torch/serving.py"],
         part_a_full_width={"model": cfg.name, "batch": BATCH, "prompt": PROMPT,
                            "recompute_ms": part_a["recompute_ms"],
                            "attach_ms": part_a["attach_ms"], "ratio": part_a["ratio"],
                            "timed": f"mean of {PART_A_REPS} after one untimed",
                            "identical": part_a["identical"]},
         claims=len(claims), failed_claims=failed, launches=launches, seconds=seconds)
    check(not functional, f"functional claims failed: {functional}")
    check(launches["flash_attention"] == (PART_A_REPS + 1) * cfg.num_layers,
          f"Part A's {PART_A_REPS + 1} prefills launched flash {launches['flash_attention']} "
          f"times, want {(PART_A_REPS + 1) * cfg.num_layers}")
    check(launches["merge"] > 0, "no fetch or scan of the figures merged on the card")
    return launches


# ------------------------------------------------------------ phase 7
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
        fa0, mg0, a0 = launched("flash_attention"), launched("merge"), len(runs)
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
            "flash_launches": launched("flash_attention") - fa0,
            "merge_launches": launched("merge") - mg0, "runs_per_fetch": runs[a0:],
            "leases_after": _wait_no_leases(fs)})
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
        fa0 = launched("flash_attention")
        _, cache2, _ = model.apply(params, {"tokens": prompt2}, mode="prefill", max_len=MAX_LEN)
        orphan_flash = launched("flash_attention") - fa0
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
        fa0, t0 = launched("flash_attention"), time.perf_counter()
        toks = generate(model, params, prompt, steps=STEPS, max_len=MAX_LEN, kv_store=store2)
        torch.cuda.synchronize()
        standby = {"total_ms": (time.perf_counter() - t0) * 1e3,
                   "phase_ms": {"fetch": [t for _, t in timed.take()]},
                   "flash_launches": launched("flash_attention") - fa0,
                   "fetches": store2.stats.fetches,
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


# ------------------------------------------------------------ phase 8
def _cache_bit_equal(a, b) -> bool:
    import torch

    from repro_torch.tree import tree_leaves, tree_map

    same = tree_map(lambda x, y: x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(_bits(x), _bits(y)), a, b)
    return all(tree_leaves(same))


def prefill_flash_calls(cfg, S: int, batch: int = 1) -> dict:
    """{(q shape, softcap, causal): flash launches} of one forward-only
    prefill of ``batch`` × S tokens: one an attention layer where
    ``layers.attention_path`` answers "kernel", asked for the decoder's
    causal self-attention over S and for an encoder–decoder's encoder, non-
    causal over its frames in train mode (as JAX runs it in a prefill)."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import n_periods, period_layout

    attn = sum(kind == "attn" for kind, _ in period_layout(cfg))
    stacks = [("prefill", True, S, n_periods(cfg))]
    if cfg.encoder_decoder:
        stacks.append(("train", False, cfg.frontend_seq, n_periods(cfg, cfg.num_encoder_layers)))
    calls = {}
    for mode, causal, seq, periods in stacks:
        path = layers.attention_path(mode, causal=causal, cross=False, seq=seq,
                                     head_dim=cfg.head_dim, dtype=cfg.compute_dtype,
                                     records=False)
        if path == "kernel" and periods * attn:
            key = ((batch, seq, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim),
                   cfg.attn_logit_softcap, causal)
            calls[key] = periods * attn
    return calls


def arch_run(cfg, model, params, prompt, store=None, *, extra=None):
    """One arch at ``cfg``: one untimed prefill at the runs' shapes (its
    time is ``first_prefill_ms``, so that the runs' prefill times leave
    the first call's out), then in memory, and with ``store`` cold and
    warm; tokens in range and equal across the runs, the prefill's
    last-position and every decode step's logits finite, flash once per
    attention layer a prefill at the shapes ``prefill_flash_calls`` names
    (the decoder's prompt, a vision model's frontend before it; an
    encoder–decoder's frames);
    every fetched cache the prefill's bit for bit, the merge once a fetch
    that arrived in more than one run. ``extra`` joins the prefill's batch
    (a vision or audio model's frontend). Returns the record."""
    import torch

    from repro_torch.models import layers
    from repro_torch.serve import generate

    S = (cfg.frontend_seq if cfg.frontend == "vision" else 0) + prompt.shape[1]
    max_len = S + STEPS
    want_calls = prefill_flash_calls(cfg, S, BATCH)
    flash_per_prefill = sum(want_calls.values())
    fa0, rn0 = launched("flash_attention"), launched("rms_norm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        model.apply(params, {"tokens": prompt, **(extra or {})}, mode="prefill",
                    max_len=max_len)
        torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    warmup_flash = launched("flash_attention") - fa0
    rms_norm_per_prefill = launched("rms_norm") - rn0
    check(warmup_flash == flash_per_prefill,
          f"{cfg.name} first prefill: flash launched {warmup_flash} times, "
          f"want {flash_per_prefill}")
    timed = _Timed()
    apply = timed.wrap(lambda *a, **kw: kw.get("mode", "train"), model.apply)
    finite, flash_calls = [], {}

    def apply_spy(*a, **kw):
        logits, cache, aux = apply(*a, **kw)
        finite.append(bool(torch.isfinite(logits[:, -1].float()).all()))
        return logits, cache, aux

    def flash_spy(q, k, v, **kw):
        key = (tuple(q.shape), kw.get("softcap", 0.0), kw.get("causal", True))
        flash_calls[key] = flash_calls.get(key, 0) + 1
        return flash_entry(q, k, v, **kw)

    model.apply = apply_spy
    flash_entry, layers.ops.flash_attention = layers.ops.flash_attention, flash_spy
    prefilled, fetched_equal = [], []
    if store is not None:
        put, fetch = timed.wrap("put", store.put), timed.wrap("fetch", store.fetch)

        def put_spy(tokens, cache, **kw):
            prefilled.append(cache)
            return put(tokens, cache, **kw)

        def fetch_spy(tokens):
            cache = fetch(tokens)
            fetched_equal.append(_cache_bit_equal(prefilled[0], cache))
            return cache

        store.put, store.fetch = put_spy, fetch_spy
    runs, launches = {}, {"flash_attention": warmup_flash, "merge": 0}
    labels = ["in_memory"] + (["cold", "warm"] if store is not None else [])
    try:
        for label in labels:
            fa0, mg0 = launched("flash_attention"), launched("merge")
            r0, f0 = (store.stats.merge_runs, store.stats.fetches) if store else (0, 0)
            t0 = time.perf_counter()
            toks = generate(model, params, prompt, steps=STEPS, max_len=max_len,
                            batch_extra=extra,
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
                   "flash_launches": launched("flash_attention") - fa0,
                   "merge_launches": launched("merge") - mg0, "tokens": toks.cpu()}
            if store is not None:
                rec["fetches"] = store.stats.fetches - f0
                rec["merge_runs"] = store.stats.merge_runs - r0
            launches["flash_attention"] += rec["flash_launches"]
            launches["merge"] += rec["merge_launches"]
            runs[label] = rec
    finally:
        del model.apply
        layers.ops.flash_attention = flash_entry
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
            check(runs[label]["flash_launches"] == flash_per_prefill,
                  f"{cfg.name} {label}: flash launched {runs[label]['flash_launches']} "
                  f"times, want {flash_per_prefill}")
    prefills = 2 if store is not None else 1  # in memory, and cold
    want_flash = {key: n * prefills for key, n in want_calls.items()}
    check(flash_calls == want_flash,
          f"{cfg.name}: flash calls {flash_calls}, want {want_flash}")
    if store is not None:
        check(runs["warm"]["flash_launches"] == 0, f"{cfg.name}: the warm run ran a prefill")
        check(len(prefilled) == 1 and fetched_equal == [True, True],
              f"{cfg.name}: a fetched cache differs from the prefill's: {fetched_equal}")
        for label in ("cold", "warm"):
            r = runs[label]
            check(r["fetches"] == 1 and r["merge_launches"] == int(r["merge_runs"] > 1),
                  f"{cfg.name} {label}: {r['merge_launches']} merge launches for a fetch in "
                  f"{r['merge_runs']} runs")
    return {"runs": runs, "launches": launches, "tokens": want.tolist(),
            "first_prefill_ms": first_prefill_ms, "flash_per_prefill": flash_per_prefill,
            "rms_norm_per_prefill": rms_norm_per_prefill,
            "finite_logit_calls": len(finite), "seq": S,
            "flash_calls": sorted([list(sh), cap, causal, n]
                                  for (sh, cap, causal), n in flash_calls.items()),
            "fetched_cache_bit_equal": fetched_equal or None}


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
        # a bf16 prefill runs every RMSNorm in the kernel: ln1 and ln2 of each
        # layer and the head's
        check(rec["rms_norm_per_prefill"] == 2 * cfg.num_layers + 1,
              f"{name}: {rec['rms_norm_per_prefill']} RMSNorm launches a prefill, want "
              f"{2 * cfg.num_layers + 1}")
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
         first_prefill_ms={k: v["first_prefill_ms"] for k, v in out.items()},
         decode_tok_per_s={k: v["runs"]["in_memory"]["decode_tok_per_s"]
                           for k, v in out.items()},
         max_memory_allocated={k: v["max_memory_allocated"] for k, v in out.items()})
    return launches


# ------------------------------------------------------------ phase 9
def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _family_arch(name, cfg, store=None, *, frontend=False, n_params=None, probe=None):
    """``arch_run`` for ``cfg`` on the card: random weights from seed 0,
    BATCH prompts of PROMPT tokens (SMOKE_PROMPT at ``:smoke``) from seed
    1, and with ``frontend`` a stub of frontend_seq embeddings from seed
    FRONTEND_SEED. ``probe(model, params, prompt)``, if given, runs after
    and its dict joins the record. Returns the record, the arch's peak
    memory with it."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    _free()
    model = build_model(cfg)
    if n_params is not None:
        check(model.n_params() == n_params,
              f"{name}: n_params {model.n_params()}, the JAX package's {n_params}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    S = SMOKE_PROMPT if name.endswith(":smoke") else PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, S), dtype=torch.int32, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    extra = None
    if frontend:
        extra = {"frontend": torch.randn(
            (BATCH, cfg.frontend_seq, cfg.d_model), device="cuda",
            generator=torch.Generator("cuda").manual_seed(FRONTEND_SEED))}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = arch_run(cfg, model, params, prompt, store, extra=extra)
    rec.update(layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, vocab=cfg.vocab_size,
               frontend_seq=cfg.frontend_seq if frontend else 0, n_params=model.n_params(),
               param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
               init_s=init_s, max_memory_allocated=torch.cuda.max_memory_allocated(),
               cache_bytes=store.stats.put_bytes if store else None)
    if probe is not None:
        rec.update(probe(model, params, prompt))
    emit("family", model=name, **rec)
    del model, params, prompt, extra
    return rec


def _jamba_smoke_card_vs_cpu():
    """jamba-1.5-large-398b:smoke in f32 (its 7 mamba layers and 1
    attention layer, MoE every other layer): the prefill's logits and MoE
    aux on the card within 1e-4 of the CPU's, and greedy tokens equal;
    then on the card in memory, cold and warm through the main path's
    store (``arch_run``), tokens equal to the CPU's."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import generate
    from repro_torch.tree import tree_map

    _free()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-1.5-large-398b:smoke").with_(compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, JAMBA_SMOKE_S), dtype=torch.int32,
                           generator=torch.Generator("cpu").manual_seed(1))
    gpu_params = tree_map(lambda t: t.cuda(), params)
    max_len = JAMBA_SMOKE_S + STEPS
    lg_cpu, _, aux_cpu = model.apply(params, {"tokens": prompt}, mode="prefill",
                                     max_len=max_len)
    lg_gpu, cache, aux_gpu = model.apply(gpu_params, {"tokens": prompt.cuda()},
                                         mode="prefill", max_len=max_len)
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    check(torch.allclose(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4),
          f"jamba:smoke prefill logits differ card vs CPU: {err}")
    for k in aux_cpu:
        check(abs(float(aux_gpu[k]) - float(aux_cpu[k])) <= 1e-4 * abs(float(aux_cpu[k])),
              f"jamba:smoke {k}: card {float(aux_gpu[k])} CPU {float(aux_cpu[k])}")
    kinds = sorted({k for layer in cache["stack"]["unroll"] for k in layer})
    t_cpu = generate(model, params, prompt, steps=STEPS, max_len=max_len)
    del cache
    rec = arch_run(cfg, model, gpu_params, prompt.cuda(), serving_store())
    check(rec["tokens"] == t_cpu.tolist(), "jamba:smoke tokens differ card vs CPU")
    rec.update(n_params=model.n_params(), prefill_logits_max_abs_err=err,
               tokens_equal_cpu=True, cache_kinds=kinds,
               aux_card={k: float(v) for k, v in aux_gpu.items()},
               aux_cpu={k: float(v) for k, v in aux_cpu.items()},
               compute_dtype="float32", seq=JAMBA_SMOKE_S)
    emit("family", model=cfg.name, **rec)
    return rec


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _mamba_full_width():
    """One Mamba-2 layer at jamba-1.5-large-398b's widths (d_model 8,192,
    d_inner 16,384, 256 heads of 64, d_state 64, chunk 256), random params
    from seed 0, input from seed 3: in f32, a prefill of PROMPT tokens and
    STEPS decode steps from its cache, held at a relative 1e-3 (Frobenius)
    against the same layer in train mode over the whole PROMPT + one chunk
    sequence (the chunked scan over one more chunk, not the recurrence);
    then the same prefill and steps at bf16 compute, timed, with their
    error against f32, through the SSD kernel (``ops.ssd_scan``, one call in
    the prefill) and again with the kernel turned off (``ssd_chunked``, the
    path it replaces): the kernel's errors may exceed the plain path's by
    no more than MAMBA_BF16_ERR_RATIO, so that a wrong y or final state (the
    decode steps start from it) fails. The f32 prefill keeps
    ``ssd_chunked``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models.config import get_config
    from repro_torch.models.schema import init_tree

    _free()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-1.5-large-398b")
    params = init_tree(ssm.mamba_spec(cfg), torch.Generator("cuda").manual_seed(0),
                       torch.float32)
    S_all = PROMPT + cfg.mamba.chunk
    x = torch.randn((BATCH, S_all, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    out, bf16 = {}, {}
    takes = ops.ssd_takes
    with torch.inference_mode():
        want, _ = ssm.apply_mamba(params, cfg.with_(compute_dtype=torch.float32), x,
                                  mode="train")
        for name, dt, kernel in (("float32", torch.float32, True),
                                 ("bfloat16", torch.bfloat16, True),
                                 ("bfloat16_plain", torch.bfloat16, False)):
            c = cfg.with_(compute_dtype=dt)
            torch.cuda.synchronize()
            calls = launched("ssd")
            if not kernel:
                ops.ssd_takes = lambda *a: False
            try:
                t0 = time.perf_counter()
                y_pre, cache = ssm.apply_mamba(params, c, x[:, :PROMPT], mode="prefill")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            finally:
                ops.ssd_takes = takes
            calls = launched("ssd") - calls
            ys = []
            for t in range(PROMPT, PROMPT + STEPS):
                y, cache = ssm.apply_mamba(params, c, x[:, t:t + 1], cache=cache,
                                           mode="decode")
                ys.append(y)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[name] = {"prefill_ms": (t1 - t0) * 1e3, "ssd_kernel_calls": calls,
                         "decode_ms_per_step": (t2 - t1) * 1e3 / STEPS,
                         "prefill_rel_err": _rel_err(y_pre, want[:, :PROMPT]),
                         "decode_rel_err": _rel_err(torch.cat(ys, 1),
                                                    want[:, PROMPT:PROMPT + STEPS]),
                         "finite": bool(torch.isfinite(y_pre).all()
                                        and all(torch.isfinite(y).all() for y in ys))}
            if dt == torch.bfloat16:
                bf16[name] = (y_pre, torch.cat(ys, 1))
            del y_pre, cache, ys
    (kp, kd), (pp, pd) = bf16["bfloat16"], bf16["bfloat16_plain"]
    kernel_vs_plain = {"prefill_rel_err": _rel_err(kp, pp), "decode_rel_err": _rel_err(kd, pd)}
    del bf16, kp, kd, pp, pd
    f32, b16, plain = out["float32"], out["bfloat16"], out["bfloat16_plain"]
    check(f32["prefill_rel_err"] <= 1e-3 and f32["decode_rel_err"] <= 1e-3,
          f"full-width mamba layer: prefill/decode against train mode: {f32}")
    check(b16["finite"] and plain["finite"], "full-width mamba layer: bf16 output not finite")
    check(f32["ssd_kernel_calls"] == 0 and b16["ssd_kernel_calls"] == 1
          and plain["ssd_kernel_calls"] == 0,
          f"full-width mamba layer: SSD kernel calls {out}")
    check(all(b16[k] <= MAMBA_BF16_ERR_RATIO * plain[k]
              for k in ("prefill_rel_err", "decode_rel_err")),
          f"full-width mamba layer: bf16 through the SSD kernel against f32 {b16}, "
          f"the kernel off {plain}")
    rec = {"d_model": cfg.d_model, "d_inner": ssm.mamba_dims(cfg)[0],
           "heads": ssm.mamba_dims(cfg)[1], "d_state": cfg.mamba.d_state,
           "chunk": cfg.mamba.chunk, "batch": BATCH, "prompt": PROMPT, "steps": STEPS,
           "tol": (f"rel 1e-3 (f32) against train mode; bf16 through the kernel within "
                   f"{MAMBA_BF16_ERR_RATIO}x the kernel-off errors"), **out,
           "bfloat16_kernel_vs_plain": kernel_vs_plain,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit("mamba_layer", **rec)
    del params, x, want
    return rec


def phase_families():
    """The vision frontend, MoE and Mamba-2 SSD families on the card, one
    arch after the other (each freed before the next); f32 params, bf16
    compute unless said: phi-3-vision-4.2b and granite-moe-3b-a800m at full
    width and depth, grok-1-314b at full width cut to GROK_LAYERS layers,
    jamba-1.5-large-398b at ``:smoke`` against the CPU, one full-width
    Mamba-2 layer, and one AdamW step of three of them at ``:smoke``
    (``train_card_vs_cpu``; AdamW's eps 1e-6, as
    ``tests/test_torch_families.py`` takes it)."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train import optim

    out = {}
    ssd_calls = launched("ssd")
    phi = get_config("phi-3-vision-4.2b")
    out["phi-3-vision-4.2b"] = _family_arch("phi-3-vision-4.2b", phi, frontend=True,
                                            n_params=FAMILIES["phi-3-vision-4.2b"])
    phi_s = get_config("phi-3-vision-4.2b:smoke")
    out["phi-3-vision-4.2b:smoke"] = _family_arch("phi-3-vision-4.2b:smoke", phi_s,
                                                  serving_store(), frontend=True)
    gm = get_config("granite-moe-3b-a800m")
    out["granite-moe-3b-a800m"] = _family_arch("granite-moe-3b-a800m", gm, serving_store(),
                                               n_params=FAMILIES["granite-moe-3b-a800m"])
    grok_full = get_config("grok-1-314b")
    check(build_model(grok_full).n_params() == FAMILIES["grok-1-314b"],
          "grok-1-314b: full-width n_params differs from the JAX package's")
    grok = grok_full.with_(num_layers=GROK_LAYERS)
    rec = _family_arch("grok-1-314b", grok)
    check(rec["max_memory_allocated"] < PEAK_LIMIT,
          f"grok-1-314b at {GROK_LAYERS} layers peaked at {rec['max_memory_allocated']} B")
    rec["cut"] = (f"num_layers {grok_full.num_layers} -> {GROK_LAYERS}: the most whose peak "
                  f"stays under {PEAK_LIMIT:.0f} B")
    out["grok-1-314b"] = rec
    check(build_model(get_config("jamba-1.5-large-398b")).n_params()
          == FAMILIES["jamba-1.5-large-398b"],
          "jamba-1.5-large-398b: full-width n_params differs from the JAX package's")
    out["jamba-1.5-large-398b:smoke"] = _jamba_smoke_card_vs_cpu()
    mamba = _mamba_full_width()
    _free()
    lr = 3e-4
    trains = {}
    for name in ("granite-moe-3b-a800m", "grok-1-314b", "jamba-1.5-large-398b"):
        cfg = get_config(f"{name}:smoke").with_(compute_dtype=torch.float32)
        trains[name] = train_card_vs_cpu(cfg, FAMILY_TRAIN_S, optim.adamw(lr=lr, eps=1e-6), lr)
        check(trains[name]["metrics_card"]["moe_aux"] > 0, f"{name}: no MoE aux loss")
        emit("family_train", **trains[name])
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in ("flash_attention", "merge")}
    launches["ssd_calls"] = launched("ssd") - ssd_calls
    emit("families", batch=BATCH, prompt=PROMPT, steps=STEPS, launches=launches,
         n_params={k: v["n_params"] for k, v in out.items()},
         prefill_ms={k: v["runs"]["in_memory"]["prefill_ms"] for k, v in out.items()},
         first_prefill_ms={k: v["first_prefill_ms"] for k, v in out.items()},
         decode_tok_per_s={k: v["runs"]["in_memory"]["decode_tok_per_s"]
                           for k, v in out.items()},
         max_memory_allocated={k: v["max_memory_allocated"] for k, v in out.items()
                               if "max_memory_allocated" in v},
         cache_bytes={k: v.get("cache_bytes") for k, v in out.items()},
         put_ms={k: v["runs"]["cold"]["put_ms"] for k, v in out.items() if "cold" in v["runs"]},
         fetch_ms={k: {r: v["runs"][r]["fetch_ms"] for r in ("cold", "warm")}
                   for k, v in out.items() if "cold" in v["runs"]},
         grok_cut=out["grok-1-314b"]["cut"], mamba_layer=mamba,
         train_max_abs_err={k: v["max_abs_err"] for k, v in trains.items()})
    _free()
    return launches

# ------------------------------------------------------------ phase 10
def _slstm_share(model, params, prompt):
    """One more prefill of ``prompt``, each sLSTM layer timed alone (a
    device synchronise before and after): its share of the prefill."""
    import torch

    from repro_torch.models import xlstm

    real, spent = xlstm.apply_slstm, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    xlstm.apply_slstm = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.apply(params, {"tokens": prompt}, mode="prefill",
                        max_len=prompt.shape[1] + STEPS)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        xlstm.apply_slstm = real
    return {"slstm_probe": {"prefill_ms": total * 1e3, "slstm_ms": sum(spent) * 1e3,
                            "slstm_layers": len(spent), "slstm_share": sum(spent) / total}}


def _xlstm_layers_full_width():
    """One mLSTM and one sLSTM block at xlstm-125m's full widths (d_model
    768, 4 heads; mLSTM inner 1,536 in heads of 384, sLSTM heads of 192),
    f32, random params from seed 0, input from seed 3: a prefill of PROMPT
    tokens and STEPS decode steps from its cache, held at a relative 1e-3
    (Frobenius) against the same block in train mode over PROMPT + one
    mLSTM chunk (PROMPT - STEPS is no multiple of the chunk, which the
    chunkwise cell needs): for the mLSTM the chunkwise form against the
    recurrence on the card."""
    import torch

    from repro_torch.models import xlstm
    from repro_torch.models.config import get_config
    from repro_torch.models.schema import init_tree

    _free()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-125m").with_(compute_dtype=torch.float32)
    S_all = PROMPT + xlstm.MLSTM_CHUNK
    x = torch.randn((BATCH, S_all, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    out = {}
    for kind, spec, apply in (("mlstm", xlstm.mlstm_spec, xlstm.apply_mlstm),
                              ("slstm", xlstm.slstm_spec, xlstm.apply_slstm)):
        params = init_tree(spec(cfg), torch.Generator("cuda").manual_seed(0), torch.float32)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, _ = apply(params, cfg, x, mode="train")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y_pre, cache = apply(params, cfg, x[:, :PROMPT], mode="prefill")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ys = []
            for t in range(PROMPT, PROMPT + STEPS):
                y, cache = apply(params, cfg, x[:, t:t + 1], cache=cache, mode="decode")
                ys.append(y)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out[kind] = {"train_ms": (t1 - t0) * 1e3, "train_seq": S_all,
                         "prefill_ms": (t2 - t1) * 1e3,
                         "decode_ms_per_step": (t3 - t2) * 1e3 / STEPS,
                         "prefill_rel_err": _rel_err(y_pre, want[:, :PROMPT]),
                         "decode_rel_err": _rel_err(torch.cat(ys, 1),
                                                    want[:, PROMPT:PROMPT + STEPS])}
        del params, want, y_pre, cache, ys
    for kind, r in out.items():
        check(r["prefill_rel_err"] <= 1e-3 and r["decode_rel_err"] <= 1e-3,
              f"full-width {kind} block: prefill/decode against train mode: {r}")
    rec = {"d_model": cfg.d_model, "heads": cfg.num_heads, "batch": BATCH, "prompt": PROMPT,
           "steps": STEPS, "chunk": xlstm.MLSTM_CHUNK,
           "tol": "rel 1e-3 (f32) against train mode", **out,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit("xlstm_layers", **rec)
    del x
    return rec


def phase_recurrent_encdec():
    """xLSTM and the audio encoder–decoder on the card, one arch after the
    other (each freed before the next); f32 params, bf16 compute unless
    said: xlstm-125m at full width and depth (12 layers in 3 periods of
    mLSTM, mLSTM, mLSTM, sLSTM) in memory, cold and warm through the main
    path's store, with the sLSTM layers' share of a prefill; one mLSTM and
    one sLSTM block at full width in f32 against train mode;
    seamless-m4t-large-v2 at full width and depth (24 encoder layers over
    SEAMLESS_FRAMES stub audio frames from seed FRONTEND_SEED, 24 decoder
    layers with cross-attention) in memory, cold and warm, its cache's
    cross half bit-equal too, flash once an encoder layer (non-causal) and
    once a decoder layer (causal) a prefill; one AdamW step of both at
    ``:smoke`` on the card against the CPU (``train_card_vs_cpu``, AdamW's
    eps 1e-6 as for the families)."""
    import numpy as np
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.train import optim

    out = {}
    xl = get_config("xlstm-125m")
    out["xlstm-125m"] = _family_arch("xlstm-125m", xl, serving_store(),
                                     n_params=RECURRENT_ENCDEC["xlstm-125m"],
                                     probe=_slstm_share)
    layers = _xlstm_layers_full_width()
    sm = get_config("seamless-m4t-large-v2")
    check(sm.frontend_seq == SEAMLESS_FRAMES, f"seamless frontend_seq {sm.frontend_seq}")
    out["seamless-m4t-large-v2"] = _family_arch(
        "seamless-m4t-large-v2", sm, serving_store(), frontend=True,
        n_params=RECURRENT_ENCDEC["seamless-m4t-large-v2"])
    _free()
    lr = 3e-4
    trains = {}
    for name in RECURRENT_ENCDEC:
        cfg = get_config(f"{name}:smoke").with_(compute_dtype=torch.float32)
        extra = None
        if cfg.encoder_decoder:
            extra = {"frontend": np.random.default_rng(FRONTEND_SEED).standard_normal(
                (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)}
        trains[name] = train_card_vs_cpu(cfg, FAMILY_TRAIN_S, optim.adamw(lr=lr, eps=1e-6),
                                         lr, extra)
        emit("family_train", **trains[name])
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in ("flash_attention", "merge")}
    emit("recurrent_encdec", batch=BATCH, prompt=PROMPT, steps=STEPS, launches=launches,
         n_params={k: v["n_params"] for k, v in out.items()},
         prefill_ms={k: v["runs"]["in_memory"]["prefill_ms"] for k, v in out.items()},
         first_prefill_ms={k: v["first_prefill_ms"] for k, v in out.items()},
         decode_tok_per_s={k: {r: v["runs"][r]["decode_tok_per_s"]
                               for r in ("in_memory", "cold", "warm")}
                           for k, v in out.items()},
         max_memory_allocated={k: v["max_memory_allocated"] for k, v in out.items()},
         cache_bytes={k: v["cache_bytes"] for k, v in out.items()},
         put_ms={k: v["runs"]["cold"]["put_ms"] for k, v in out.items()},
         fetch_ms={k: {r: v["runs"][r]["fetch_ms"] for r in ("cold", "warm")}
                   for k, v in out.items()},
         flash_per_prefill={k: v["flash_per_prefill"] for k, v in out.items()},
         slstm_probe=out["xlstm-125m"]["slstm_probe"], xlstm_layers=layers,
         train_max_abs_err={k: v["max_abs_err"] for k, v in trains.items()})
    _free()
    return launches


# ------------------------------------------------------------ phase 11
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
    base = {k: launched(k) for k in ("preprocess", "flash_attention", "merge")}
    t0 = time.perf_counter()
    got, arrivals = [], []
    for x in pipe:
        got.append(x)
        arrivals.append((time.perf_counter() - t0) * 1e3)
    wall_s = time.perf_counter() - t0
    launches = {k: launched(k) - n for k, n in base.items()}
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


# ------------------------------------------------------------ phase 12
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
    m0 = launched("merge")
    fabric.drain()
    b0 = fabric.total_bytes()
    with _MergeRecord() as scan_merges:
        t0 = time.perf_counter()
        rows_push = db.scan(program=prog, pushdown=True)
        push_s = time.perf_counter() - t0
    launches = launched("merge") - m0
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


# ------------------------------------------------------------ phases 14-16
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


def train_card_vs_cpu(cfg, seq: int, opt, lr: float, extra=None) -> dict:
    """One AdamW ``make_train_step`` step of ``cfg`` (f32) at ``seq`` on the
    card against the same step on the CPU from the same params, under
    ``deterministic()``: loss, grad_norm and the other metrics within a
    relative 1e-4 (f32 sums in another order), AdamW's m (0.1 × the
    clipped gradient) and v within 1e-4 of each leaf's largest value, every
    param within lr / 10 (a lost gradient moves a param by lr × sign(g) on
    one side only). ``extra`` (numpy arrays, such as an audio model's
    frontend) joins the batch. Returns the record, with the card's flash
    launches."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    b = dict(TokenPipeline(cfg.vocab_size, 2, seq).next_batch(), **(extra or {}))
    step = make_train_step(model, opt)
    states, metrics, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        state = init_state(model, opt, params=tree_map(lambda t: t.to(dev, copy=True), params))
        f0 = launched("flash_attention")
        with deterministic():
            states[dev], m = step(state, _batch_on(b, dev))
        metrics[dev] = {k: float(v) for k, v in m.items()}
        launches[dev] = launched("flash_attention") - f0
    torch.cuda.synchronize()
    g, c = metrics["cuda"], metrics["cpu"]
    check(set(g) == set(c), f"{cfg.name}: metrics {sorted(g)} vs {sorted(c)}")
    for k in g:
        check(math.isfinite(g[k]) and abs(g[k] - c[k]) <= 1e-4 * abs(c[k]),
              f"{cfg.name} train {k}: card {g[k]} CPU {c[k]}")
    errs = {}
    for (path, a), (_, w) in zip(tree_flatten_with_path(states["cuda"]),
                                 tree_flatten_with_path(states["cpu"])):
        name = "/".join(map(str, path))
        err = _max_err(a, w)
        tol = lr / 10 if path[0] == "params" else 1e-4 * w.abs().max().item()
        check(err <= tol, f"{cfg.name} train {name}: card and CPU differ by {err} > {tol}")
        errs[name] = err
    worst = {k: max(e for n, e in errs.items() if n.startswith(k))
             for k in ("params", "opt/m", "opt/v")}
    return {"model": cfg.name, "seq": seq, "batch": 2, "metrics_card": g,
            "metrics_cpu": c, "leaves": len(errs), "max_abs_err": worst,
            "flash_launches": launches["cuda"],
            "tol": {"metrics": "rel 1e-4", "params": lr / 10, "moments": "1e-4 x leaf max"}}


def phase_train_small():
    """One AdamW step of qwen3-1.7b:smoke in f32 at S = 2,304 (the chunked
    twin's branch) on the card against the CPU (``train_card_vs_cpu``).
    The flash kernel must not launch: it has no backward."""
    import torch

    from repro_torch.models.config import get_config
    from repro_torch.train import optim

    lr = 3e-4
    cfg = get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32)
    rec = train_card_vs_cpu(cfg, TRAIN_SMALL_S, optim.adamw(lr=lr), lr)
    check(rec["flash_launches"] == 0,
          f"the train step launched flash {rec['flash_launches']} times")
    emit("train_small", **rec)
    return rec["flash_launches"]


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

    from repro_torch.train import e2e

    def quiet(*_):
        pass

    kw = dict(steps=E2E_STEPS, ingest="prep", device="cuda", log=quiet)
    with deterministic():
        with _PrepBatchRecord() as record:
            base = {k: launched(k) for k in ("preprocess", "flash_attention", "merge")}
            t0 = time.perf_counter()
            crash = e2e.run(ckpt_every=E2E_CKPT_EVERY, kill_at=E2E_KILL_AT, **kw)
            crash_s = time.perf_counter() - t0
        launches = {k: launched(k) - n for k, n in base.items()}
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
    f0 = launched("flash_attention")
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
    flash = launched("flash_attention") - f0
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


# ------------------------------------------------------------ phase 17
# distribution path: qwen3-1.7b at full width under each cell's sharding
# rules on a real 1x1 mesh, each cell's global batch cut to fit one card
DIST_ARCH = "qwen3-1.7b"
DIST_CUTS = {
    "train_4k": (4, "global batch 256 -> 4 (microbatches 4, TRAIN_MICROBATCHES)"),
    "prefill_32k": (2, "global batch 32 -> 2"),
    "decode_32k": (8, "global batch 128 -> 8"),
}
DIST_SEED = 19
# xlstm-125m at full width and depth; its sequences are cut too: on plain
# tensors the sLSTM loop launches ~20 kernels a step (a prefill of 4,096
# took 3.14 s, 82 % of it that loop), so a prefill of 32,768 would take ~25
# s a call, and a train step at 4,096 took 46.0 s, 8 calls a cell
DIST_XLSTM = "xlstm-125m"
XLSTM_CUTS = {
    "train_4k": (2, "global batch 256 -> 2 (microbatches 1, TRAIN_MICROBATCHES); sequence "
                    "4,096 -> 512 (a step at 4,096 takes 46 s, at 1,024 11 s: the sLSTM "
                    "loop's ~20 launches a step, forward and backward)"),
    "prefill_32k": (1, "global batch 32 -> 1; sequence 32,768 -> 4,096 (the sLSTM loop "
                       "launches ~20 kernels a step)"),
    "decode_32k": (8, "global batch 128 -> 8"),
}
XLSTM_TRAIN_SEQ, XLSTM_PREFILL_SEQ = 512, 4096
DIST_SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_CUTS = {"prefill_32k": (1, "global batch 32 -> 1")}


def _dist_tokens(abstract, vocab, seed):
    """Random tokens for each int32 leaf of ``abstract``, and standard
    normal values for a float one (an audio frontend's frames), from
    ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def make(v):
        if v.dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, vocab, tuple(v.shape)).astype(np.int32))
        return torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)).to(
            v.dtype)

    return {k: make(v).cuda() for k, v in abstract.items()}


def _whole(t):
    """A DTensor on the 1x1 mesh as a plain tensor (its one shard), anything
    else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _timed(fn, *a):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


DIST_REPS = 3  # timed calls of each variant after its first


def _dist_run(plan, args, compare, fn=None, before=None):
    """``fn`` (the plan's step by default) on ``args()`` without rules, then
    on fresh ``args()`` placed at the plan's placements under its rules;
    ``compare(want, got)`` checks these first calls' outputs. Then each
    variant runs ``DIST_REPS`` more times on its own arguments (a train
    step goes on updating them), timed: the record holds each variant's
    first (cold) call and the median of the timed ones, the timed calls'
    peak memory and the first calls' flash launches. ``before(a)``, if
    given, runs untimed before every call on its arguments."""
    import statistics

    from repro_torch.sharding import use_rules

    fn = fn or plan.fn

    def ruled(*a):
        with use_rules(plan.rules):
            out = fn(*a)
            return plan.constrain(out) if fn is plan.fn else out

    def call(f, a):
        if before is not None:
            before(a)
        return _timed(f, *a)

    f0 = launched("flash_attention")
    plain_args = args()
    want, plain_first, _ = call(fn, plain_args)
    f1 = launched("flash_attention")
    placed = plan.place(args())
    got, rules_first, _ = call(ruled, placed)
    rec = {"flash_launches": [f1 - f0, launched("flash_attention") - f1]}
    rec.update(compare(want, got))
    del want, got
    _free()
    for name, f, a, first in (("plain", fn, plain_args, plain_first),
                              ("rules", ruled, placed, rules_first)):
        runs = [call(f, a)[1:] for _ in range(DIST_REPS)]
        rec.update({f"{name}_first_ms": first,
                    f"{name}_ms": statistics.median(ms for ms, _ in runs),
                    f"{name}_ms_runs": [ms for ms, _ in runs],
                    f"{name}_peak_bytes": max(peak for _, peak in runs)})
    return rec


def _bit_equal(want, got, what: str) -> int:
    import torch

    from repro_torch.tree import tree_leaves

    w, g = tree_leaves(want), tree_leaves(got)
    check(len(w) == len(g) > 0, f"distribution {what}: {len(w)} leaves vs {len(g)}")
    differ = [i for i, (a, b) in enumerate(zip(w, g)) if not torch.equal(_whole(b), a)]
    check(not differ, f"distribution {what}: leaves {differ[:8]} differ with rules")
    return len(w)


def _dist_train(mesh, arch=DIST_ARCH, cuts=DIST_CUTS, seq=None):
    """One train step of the cut cell without rules and with them, from the
    same seeded params, under ``deterministic()``: loss, grad_norm, the
    step, every updated param and AdamW moment bit-equal."""
    import torch

    from repro_torch.launch.specs import plan_cell
    from repro_torch.train import optim

    batch_n, cut = cuts["train_4k"]
    plan = plan_cell(arch, "train_4k", mesh, batch=batch_n, seq=seq)
    opt = optim.for_config(plan.cfg)
    batch = _dist_tokens(plan.abstract_args[1], plan.cfg.vocab_size, DIST_SEED)

    def args():
        params = plan.model.init(torch.Generator("cuda").manual_seed(DIST_SEED))
        return ({"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}, batch)

    def compare(want, got):
        (w_state, w_m), (g_state, g_m) = want, got
        return {"leaves_bit_equal": _bit_equal(w_state, g_state, "train state")
                + _bit_equal(w_m, g_m, "train metrics"),
                "loss": float(w_m["loss"]), "grad_norm": float(w_m["grad_norm"]),
                "rules_loss": float(_whole(g_m["loss"])),
                "rules_grad_norm": float(_whole(g_m["grad_norm"]))}

    with deterministic():
        rec = _dist_run(plan, args, compare)
    rec.update(cell="train_4k", cut=cut, batch=batch_n, seq=plan.cell.seq_len,
               microbatches=plan.microbatches)
    check(rec["flash_launches"] == [0, 0], f"the train step launched flash {rec}")
    check(math.isfinite(rec["loss"]), f"non-finite loss {rec['loss']}")
    _free()
    return rec


def _dist_serve(mesh, arch=DIST_ARCH, cuts=DIST_CUTS, prefill_seq=None):
    """The cut prefill cell (flash once an attention layer, in both runs)
    and, where ``cuts`` has it, the cut decode cell (one step against a
    full 32,768-entry cache of random keys and values, every row writing
    its last slot; a recurrent state of random values, restored before
    every call), each without rules and with them: logits, greedy tokens
    and caches bit-equal."""
    import torch

    from repro_torch.launch.specs import plan_cell
    from repro_torch.models.transformer import period_layout
    from repro_torch.serve.step import make_decode_step
    from repro_torch.tree import tree_leaves, tree_map

    recs = []
    pb, pcut = cuts["prefill_32k"]
    plan = plan_cell(arch, "prefill_32k", mesh, batch=pb, seq=prefill_seq)
    params = plan.model.init(torch.Generator("cuda").manual_seed(DIST_SEED))
    batch = _dist_tokens(plan.abstract_args[1], plan.cfg.vocab_size, DIST_SEED + 1)
    def compare_prefill(want, got):
        (w_logits, w_cache), (g_logits, g_cache) = want, got
        leaves = _bit_equal(w_logits, g_logits, "prefill logits") + _bit_equal(
            w_cache, g_cache, "prefill cache")
        w_tok = torch.argmax(w_logits[:, -1], -1)
        check(torch.equal(w_tok, torch.argmax(_whole(g_logits)[:, -1], -1)),
              "distribution prefill: greedy tokens differ with rules")
        return {"leaves_bit_equal": leaves, "tokens": w_tok.tolist(),
                "cache_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(w_cache))}

    with torch.inference_mode():
        rec = _dist_run(plan, lambda: (params, batch), compare_prefill)
    flash = sum(prefill_flash_calls(plan.cfg, plan.cell.seq_len).values())
    check(rec["flash_launches"] == [flash, flash],
          f"prefill flash launches {rec['flash_launches']}, want {flash} in each run")
    rec.update(cell="prefill_32k", cut=pcut, batch=pb, seq=plan.cell.seq_len)
    recs.append(rec)
    _free()
    if "decode_32k" not in cuts:
        del params
        _free()
        return recs

    db, dcut = cuts["decode_32k"]
    plan = plan_cell(arch, "decode_32k", mesh, batch=db)
    L = plan.cell.seq_len
    gen = torch.Generator("cuda").manual_seed(DIST_SEED + 2)

    def fill(t):
        if t.dtype == torch.int32:
            return torch.full(tuple(t.shape), L - 1, dtype=torch.int32, device="cuda")
        return torch.randn(tuple(t.shape), generator=gen, dtype=t.dtype, device="cuda")

    cache = tree_map(fill, plan.abstract_args[1])
    tokens = _dist_tokens({"t": plan.abstract_args[2]}, plan.cfg.vocab_size, DIST_SEED + 3)["t"]
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    step = make_decode_step(plan.model)
    written = []
    # a KV cache: each step writes each row's last slot; a recurrent state
    # (no attention layer): each step rewrites all of it, from a kept copy
    kv = any(kind == "attn" for kind, _ in period_layout(plan.cfg))
    kept = None if kv else [t.clone() for t in tree_leaves(cache)]

    def step_keeping(*a):
        # both runs write the same cache in place (the placed cache shares
        # its storage): what each wrote is kept
        out = step(*a)
        written.append([t[..., L - 1, :, :].clone() for t in tree_leaves(cache) if t.dim() >= 4]
                       if kv else [t.clone() for t in tree_leaves(cache)])
        return out

    def compare_decode(want, got):
        (w_nxt, w_logits, _), (g_nxt, g_logits, _) = want, got
        leaves = _bit_equal([w_nxt, w_logits], [g_nxt, g_logits], "decode tokens and logits")
        leaves += _bit_equal(written[0], written[1], "decode cache writes")
        written.clear()  # the timed calls write the same slots again
        return {"leaves_bit_equal": leaves, "tokens": w_nxt[:, 0].tolist()}

    def rewind(a):
        # a step advances the stacked cache's lengths (or the recurrent
        # state) in place: every call starts from the same cache again
        if kv:
            for t in tree_leaves(a[1]):
                if t.dtype == torch.int32:
                    t.fill_(L - 1)
        else:
            for t, k in zip(tree_leaves(cache), kept):
                t.copy_(k)

    with torch.inference_mode():
        rec = _dist_run(plan, lambda: (params, cache, tokens), compare_decode, fn=step_keeping,
                        before=rewind)
    rec.update(cell="decode_32k", cut=dcut, batch=db, cache_len=L, cache_bytes=cache_bytes)
    check(rec["flash_launches"] == [0, 0], f"decode launched flash {rec['flash_launches']}")
    recs.append(rec)
    del cache, params, written, kept
    _free()
    return recs


def _dryrun(*cmd):
    """``python3 *cmd`` (a dry run) in a child process of its own session
    (its fake process group would be this process's default group; the
    session holds any process it starts), started now."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def _rows(proc, timeout: float, what: str):
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"dry run {what} exited {proc.returncode}: {err[-2000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def phase_distribution():
    """The sharding rules on the card: qwen3-1.7b at full width, then
    xlstm-125m's three cells and seamless's prefill, each cut cell's plan
    run on a real 1x1 DeviceMesh (NCCL, a world of one) with its arguments
    DTensors at the plan's placements, against the same calls on plain
    tensors; then, once those are timed, the dry runs of qwen3-1.7b and
    xlstm-125m at their full batch on the fake 16x16 and 2x16x16 meshes
    and the plan-only pass of every cell (child processes)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dry = dry_x = plan_only = None
    try:
        f0 = launched("flash_attention")
        mesh = make_debug_mesh()
        cells = [_dist_train(mesh)] + _dist_serve(mesh)
        for rec in cells:
            emit("distribution_cell", model=DIST_ARCH, mesh="1x1", **rec)
        more = [(DIST_XLSTM, r) for r in [_dist_train(mesh, DIST_XLSTM, XLSTM_CUTS,
                                                      seq=XLSTM_TRAIN_SEQ)]
                + _dist_serve(mesh, DIST_XLSTM, XLSTM_CUTS, prefill_seq=XLSTM_PREFILL_SEQ)]
        more += [(DIST_SEAMLESS, r) for r in _dist_serve(mesh, DIST_SEAMLESS, SEAMLESS_CUTS)]
        for arch, rec in more:
            emit("distribution_cell", model=arch, mesh="1x1", **rec)
        launches = launched("flash_attention") - f0
        # the dry runs load the host's CPU, which the cells' dispatch under
        # the rules needs: they start once the timed cells are done
        dryrun = ("-m", "repro_torch.launch.dryrun")
        dry = _dryrun(*dryrun, "--arch", DIST_ARCH, "--both")
        dry_x = _dryrun(str(ROOT / "scripts" / "dryrun_parallel.py"), "--arch", DIST_XLSTM,
                        "--jobs", "4")
        plan_only = _dryrun(*dryrun, "--plan-only", "--both")
        traced = _rows(dry, 600, f"--arch {DIST_ARCH} --both")
        traced_x = _rows(dry_x, 900, f"--arch {DIST_XLSTM} --both, in parallel")
        planned = _rows(plan_only, 300, "--plan-only --both")
    finally:
        for proc in (dry, dry_x, plan_only):
            if proc is not None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)  # with any cell it started
                proc.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    status = [(r["cell"], r["mesh"], r["status"]) for r in traced]
    check(sum(s == "OK" for *_, s in status) == 6 and sum(s == "SKIP" for *_, s in status) == 2
          and len(status) == 8, f"dry run of {DIST_ARCH}: {status}")
    status_x = [(r["cell"], r["mesh"], r["status"]) for r in traced_x]
    check(sum(s == "OK" for *_, s in status_x) == 8 and len(status_x) == 8,
          f"dry run of {DIST_XLSTM}: {status_x}")
    for r in traced + traced_x:
        if r["status"] == "OK":
            check(r["coll_bytes_per_dev"] > 0 and r["peak_bytes"] > 0
                  and r["t_compute_ms"] > 0 and r["t_memory_ms"] > 0
                  and r["t_collective_ms"] > 0, f"dry run row {r}")
            emit("distribution_dryrun", **{k: v for k, v in r.items() if k != "coll_counts"})
    ok_plans = [r for r in planned if r["status"] == "OK"]
    check(len(ok_plans) == 64 and len(planned) == 80, f"plan-only pass: {len(ok_plans)} of "
          f"{len(planned)} planned")
    for r in ok_plans:
        emit("distribution_plan", arch=r["arch"], cell=r["cell"], mesh=r["mesh"],
             arg_bytes=r["arg_bytes"], t_compute_ms=r["t_compute_ms"],
             t_memory_ms=r["t_memory_ms"], bottleneck=r["bottleneck"])
    every = [(DIST_ARCH, r) for r in cells] + more
    emit("distribution", model=DIST_ARCH, mesh="1x1 (NCCL, world of one)",
         cuts={c: cut for c, (_, cut) in DIST_CUTS.items()},
         more_cuts={DIST_XLSTM: {c: cut for c, (_, cut) in XLSTM_CUTS.items()},
                    DIST_SEAMLESS: {c: cut for c, (_, cut) in SEAMLESS_CUTS.items()}},
         ms={f"{a}/{r['cell']}": {"plain": r["plain_ms"], "rules": r["rules_ms"],
                                  "plain_first": r["plain_first_ms"],
                                  "rules_first": r["rules_first_ms"]} for a, r in every},
         timed=f"median of {DIST_REPS} calls after the first",
         peak_bytes={f"{a}/{r['cell']}": {"plain": r["plain_peak_bytes"],
                                          "rules": r["rules_peak_bytes"]} for a, r in every},
         flash_launches=launches, dryrun_cells=status, dryrun_cells_xlstm=status_x,
         planned_cells=len(ok_plans))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    import repro_torch.kernels.build  # noqa: F401  (the port must be here)

    info = phase_device()
    seconds, by_phase = {}, {}

    def timed_phase(name, fn, *a):
        t0, n0 = time.perf_counter(), {k: launched(k) for k in KERNEL_ENTRIES}
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        by_phase[name] = {k: launched(k) - n for k, n in n0.items() if launched(k) > n}
        return out

    timed_phase("build", phase_build)
    fa_rec = timed_phase("kernels", phase_kernels)
    pp_rec = timed_phase("kernels_preprocess", phase_kernels_preprocess)
    ssd_rec = timed_phase("kernels_ssd", phase_kernels_ssd)
    rms_rec = timed_phase("kernels_rmsnorm", phase_kernels_rmsnorm)
    small_launches = timed_phase("small", phase_small)
    launches, nchunks, nruns, main_tokens, served = timed_phase("main", phase_main)
    paper_launches = timed_phase("paper_figures", phase_paper_figures, served)
    _free()
    failover_launches = timed_phase("failover", phase_failover, main_tokens.cpu())
    arch_launches = timed_phase("archs", phase_archs)
    family_launches = timed_phase("families", phase_families)
    recurrent_launches = timed_phase("recurrent_encdec", phase_recurrent_encdec)
    prep_launches = timed_phase("prep", phase_prep)
    pushdown_launches, scans = timed_phase("pushdown", phase_pushdown)
    merges = timed_phase("merge_at_path", time_merge_at_path, nchunks, nruns, scans)
    emit("merge_at_path", cases=merges)
    mg_rec = merges["fetch"]
    small_flash = timed_phase("train_small", phase_train_small)
    e2e_launches = timed_phase("train_e2e", phase_train_e2e)
    train_flash = timed_phase("train", phase_train)
    dist_flash = timed_phase("distribution", phase_distribution)
    emit("phase_seconds", **seconds)
    emit("phase_launches", **by_phase)  # host calls of each kernel's entries, by phase
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": launches["flash_attention"], "max_abs_err": fa_rec["max_abs_err"],
         "launches_by_path": {"serve": launches["flash_attention"],
                              "paper_figures": paper_launches["flash_attention"],
                              "failover": failover_launches["flash_attention"],
                              "archs": arch_launches["flash_attention"],
                              "families": family_launches["flash_attention"],
                              "recurrent_encdec": recurrent_launches["flash_attention"],
                              "small_f32": small_launches, "train_small": small_flash,
                              "train_e2e": e2e_launches["flash_attention"],
                              "train": train_flash, "distribution": dist_flash},
         "rel_err": fa_rec["rel_err"], "row_rel_err": fa_rec["row_rel_err"],
         "ms": fa_rec["ms"], "plain_ms": fa_rec["plain_ms"], "bound_ms": fa_rec["bound_ms"],
         "bound_by": fa_rec["bound_by"], "library_ms": fa_rec["library_ms"],
         "ms_over_library": fa_rec["ms_over_library"],
         "share_of_bound": fa_rec["share_of_bound"], "arch_shapes": fa_rec["arch_shapes"],
         "f32_shapes": fa_rec["f32_shapes"], "short_batch_shapes": fa_rec["short_batch_shapes"],
         "scale_shapes": fa_rec["scale_shapes"]},
        {"name": "merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merge.cu",
         "replaces": "src/repro/kernels/kvmerge.py:24",
         "launches": launches["merge"], "max_abs_err": mg_rec["max_abs_err"],
         "payload_mismatches": mg_rec["payload_mismatches"],
         "launches_by_path": {"serve": launches["merge"],
                              "paper_figures": paper_launches["merge"],
                              "failover": failover_launches["merge"],
                              "archs": arch_launches["merge"],
                              "families": family_launches["merge"],
                              "recurrent_encdec": recurrent_launches["merge"],
                              "pushdown": pushdown_launches,
                              "train_e2e": e2e_launches["merge"]},
         "ms": mg_rec["ms"], "plain_ms": mg_rec["plain_ms"], "bound_ms": mg_rec["bound_ms"],
         "bound_by": mg_rec["bound_by"], "library_ms": mg_rec["library_ms"]},
        {"name": "preprocess", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/preprocess.cu",
         "replaces": "src/repro/kernels/preprocess.py:41",
         "launches": prep_launches["preprocess"], "max_abs_err": pp_rec["max_abs_err"],
         "launches_by_path": {"prep": prep_launches["preprocess"],
                              "paper_figures": paper_launches["preprocess"],
                              "train_e2e": e2e_launches["preprocess"]},
         "differing_elements": pp_rec["differing_elements"],
         "ms": pp_rec["ms"], "plain_ms": pp_rec["plain_ms"], "bound_ms": pp_rec["bound_ms"],
         "bound_by": pp_rec["bound_by"], "library_ms": pp_rec["library_ms"]},
        {"name": "ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro_torch/models/ssm.py ssd_chunked + the D skip (no TPU kernel)",
         "launches_per_call": 4,
         "launches": 4 * (ssd_rec["calls"] + family_launches["ssd_calls"]),
         "launches_by_path": {"kernels_ssd": 4 * ssd_rec["calls"],
                              "families": 4 * family_launches["ssd_calls"]},
         "y_ulp_ratio": ssd_rec["y_ulp_ratio"], "state_rel_err": ssd_rec["state_rel_err"],
         "ms": ssd_rec["ms"], "plain_ms": ssd_rec["plain_ms"], "bound_ms": ssd_rec["bound_ms"],
         "bound_by": ssd_rec["bound_by"], "share_of_bound": ssd_rec["share_of_bound"],
         "library_ms": None, "timed_shapes": ssd_rec["timed_shapes"]},
        {"name": "rms_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro_torch/models/layers.py apply_norm's RMSNorm (no TPU kernel)",
         "launches": launched("rms_norm"),
         "launches_by_path": {k: n["rms_norm"] for k, n in by_phase.items() if "rms_norm" in n},
         "max_ulps": rms_rec["max_ulps"], "min_equal_share": rms_rec["min_equal_share"],
         "library_ms": None, "shapes": rms_rec["shapes"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

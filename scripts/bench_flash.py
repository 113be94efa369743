#!/usr/bin/env python3
"""The flash-attention kernel, bf16 and f32, against other builds of it,
built, checked and timed on one GPU.

    python3 scripts/bench_flash.py [--also LABEL=PATH[:FLAGS]] [--iters N]

It compiles ``csrc/flash_attention.cu`` and every ``--also`` source (an
earlier commit's ``flash_attention.cu``, say, with extra ``nvcc`` flags
after a colon, comma-separated) with ``nvcc``, all started together, and
prints what ptxas said (registers, spills, stack frames, warnings). Then,
in one child process per build (so that a hung kernel is killed at a time
limit), it holds each against the plain version on the cases below and at
the timed shapes (``ref.flash_attention_check``), and last times every
build that passed, in turns (A B C C B A), at the shapes of ``TIMED``: the
prefill shape (qwen3-1.7b: B 2, S 4,096, 8 kv heads × 2, D 128, causal),
S 8,192, the archs' G 4 and G 16 (glm4-9b), grok-1's G 6 with softcap 30,
phi-3-vision's D 96 (S 5,120, 32 heads), the D 64 shapes of
seamless-m4t-large-v2's encoder (non-causal, S 3,072) and decoder and of
granite-moe-3b-a800m (G 3), and the ends of the benchmark's short-batch
prefills (S 512 at B 32 and S 1,920 at B 8, G 16 and G 4), and in f32 at
``TIMED_F32`` (``chip_smoke.py``'s f32 cases, their bound at 495 / 3
TFLOP/s: 3xTF32's three products),
beside ``F.scaled_dot_product_attention`` with ``enable_gqa`` (which has no
softcap: the softcapped shapes are timed against the other builds only).
The f32 checks also print ``tol_ratio``, the largest error over the
allclose bound (1 = the tolerance). One JSON line per phase; the card's
name and power limit first.

A build other than the kept one that refuses a case (an earlier design's
limit, such as the old f32 kernel's B * H <= 65,535) is timed all the
same, its refusal printed. Each build runs through the port's own
wrapper, its library put in the place of the kept one
(``build._libs["flash_attention"]``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name, B, Sq, Sk, KV, G, D, causal, softcap[, q scale]
CASES = [
    ("prefill", 2, 4096, 4096, 8, 2, 128, True, 0.0),
    ("s2049", 1, 2049, 2049, 8, 2, 128, True, 0.0),
    ("ragged_d64", 2, 1000, 1000, 2, 4, 64, True, 0.0),
    ("noncausal_d64", 1, 77, 77, 2, 1, 64, False, 0.0),
    ("noncausal_g8", 1, 333, 333, 1, 8, 128, False, 0.0),
    ("softcap", 1, 256, 256, 2, 4, 128, True, 30.0),
    ("sq37_sk150", 2, 37, 150, 2, 2, 64, True, 0.0),
    ("sq150_sk37", 2, 150, 37, 2, 2, 128, True, 0.0),
    ("g1_kv1", 1, 300, 300, 1, 1, 128, True, 0.0),
    # D 96 (three 32-column boxes) and D 64 (192-row q tiles) at their edges
    ("d96_sq77", 2, 77, 77, 2, 1, 96, True, 0.0),
    ("d96_ragged_noncausal_g2", 2, 1000, 1000, 2, 2, 96, False, 0.0),
    ("d96_sq150_sk37", 2, 150, 37, 1, 4, 96, True, 0.0),
    ("d96_sq37_sk150", 2, 37, 150, 2, 2, 96, True, 0.0),
    ("d64_sq193", 2, 193, 193, 2, 2, 64, True, 0.0),
    ("d64_sq385_noncausal", 1, 385, 385, 1, 3, 64, False, 0.0),
    # q scaled by 8 drives the scores past the softcap (|s| up to about 44)
    ("softcap_g6_q8", 1, 700, 700, 2, 6, 128, True, 30.0, 8.0),
    ("grok_g6_softcap_q8", 2, 4096, 4096, 8, 6, 128, True, 30.0, 8.0),
]
# the f32 kernel's edges, as the gpu tests hold them: ragged S, Sq != Sk
# both ways, G 8, D 96 non-causal, softcap with q scaled by 8, the card-
# against-CPU check's shape (qwen3-1.7b:smoke at head_dim 64, S 2,304), and
# B * H = 65,540 (past a grid's y extent)
CASES_F32 = [
    ("f32_ragged_d128", 2, 1000, 1000, 2, 2, 128, True, 0.0),
    ("f32_ragged_d64_noncausal", 2, 1000, 1000, 2, 2, 64, False, 0.0),
    ("f32_sq37_sk150", 2, 37, 150, 2, 2, 64, True, 0.0),
    ("f32_sq150_sk37", 2, 150, 37, 2, 2, 128, True, 0.0),
    ("f32_g8", 2, 300, 300, 1, 8, 64, True, 0.0),
    ("f32_d96_noncausal", 2, 1000, 1000, 2, 2, 96, False, 0.0),
    ("f32_softcap_g6_q8", 1, 700, 700, 2, 6, 128, True, 30.0, 8.0),
    ("f32_small_path", 2, 2304, 2304, 2, 2, 64, True, 0.0),
    ("f32_bh65540", 2, 64, 64, 16385, 2, 64, True, 0.0),
    # long rows: the tensor cores' truncating sums must not build up over S
    ("f32_s16384_noncausal", 1, 16384, 16384, 1, 2, 128, False, 0.0),
    ("f32_s32768_noncausal", 1, 32768, 32768, 1, 1, 64, False, 0.0),
]
CHECK_FAILED = 3  # a check child's exit code: it ran, and a case missed
REFUSED = 4  # ... it ran, and refused a case (cudaErrorInvalidValue), no case missed

# name, B, S, KV, G, D, causal, softcap
TIMED = [("prefill", 2, 4096, 8, 2, 128, True, 0.0), ("s8192", 1, 8192, 8, 2, 128, True, 0.0),
         ("kv8_g4", 2, 4096, 8, 4, 128, True, 0.0),
         ("glm4_g16", 2, 4096, 2, 16, 128, True, 0.0),
         ("grok_g6_softcap", 2, 4096, 8, 6, 128, True, 30.0),
         ("phi3v_d96", 2, 5120, 32, 1, 96, True, 0.0),
         ("seamless_enc_d64", 2, 3072, 16, 1, 64, False, 0.0),
         ("seamless_dec_d64", 2, 4096, 16, 1, 64, True, 0.0),
         ("granite_moe_d64", 2, 4096, 8, 3, 64, True, 0.0),
         ("short_s512_g16", 32, 512, 2, 16, 128, True, 0.0),
         ("short_s1920_g16", 8, 1920, 2, 16, 128, True, 0.0),
         ("short_s512_g4", 32, 512, 8, 4, 128, True, 0.0),
         ("short_s1920_g4", 8, 1920, 8, 4, 128, True, 0.0)]
# chip_smoke.py's f32 cases: its four test shapes, the card-against-CPU
# check's (small_path) and qwen3-1.7b's prefill in f32
TIMED_F32 = [("small_f32", 2, 256, 2, 2, 64, True, 0.0),
             ("softcap_f32", 1, 256, 2, 4, 128, True, 30.0),
             ("noncausal_f32", 1, 333, 1, 2, 128, False, 0.0),
             ("d96_f32", 1, 512, 2, 2, 96, True, 0.0),
             ("small_path_f32", 2, 2304, 2, 2, 64, True, 0.0),
             ("prefill_f32", 2, 4096, 8, 2, 128, True, 0.0)]

def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def build_all(also):
    """Compile the kept source and every ``also`` build at once; returns
    {label: .so} of those that compiled."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "bench_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"kept": (build.CSRC / "flash_attention.cu", [])}
    for spec in also:
        label, _, rest = spec.partition("=")
        path, _, flags = rest.partition(":")
        jobs[label] = (Path(path), [f for f in flags.split(",") if f])
    procs = {}
    for label, (src, extra) in jobs.items():
        lib = out_dir / f"flash_{label}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)]
        procs[label] = (lib, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, t0, proc) in procs.items():
        log, _ = proc.communicate()
        keep = [ln.strip() for ln in log.splitlines()
                if any(w in ln for w in ("registers", "spill", "stack", "warning",
                                         "error", "Compiling entry", "Performance"))]
        emit("build", build=label, rc=proc.returncode,
             seconds=time.perf_counter() - t0, ptxas=keep)
        if proc.returncode == 0:
            libs[label] = str(lib)
    return libs


def _use(lib):
    """The flash wrapper, launching the kernel of the loaded library
    ``lib`` from now on."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    build._libs["flash_attention"] = lib
    return fa


def _inputs(B, Sq, Sk, KV, G, D, seed, qscale=1.0, dtype="bf16"):
    import torch

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator("cuda").manual_seed(seed)
    q = (torch.randn((B, Sq, KV, G, D), generator=g, device="cuda") * qscale).to(dt)
    k = torch.randn((B, Sk, KV, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Sk, KV, D), generator=g, device="cuda").to(dt)
    return q, k, v


def _rows(cases, timed):
    """(dtype, row) of every case and every timed shape, bf16 then f32."""
    out = []
    for dtype, (rows, shapes) in (("bf16", cases), ("f32", timed)):
        out += [(dtype, row) for row in rows]
        out += [(dtype, (name, B, S, S, KV, G, D, causal, cap))
                for name, B, S, KV, G, D, causal, cap in shapes]
    return out


def child_check(label, lib_path):
    import ctypes

    import torch

    from repro_torch.kernels import ref

    fa = _use(ctypes.CDLL(lib_path))
    results, ok_all, refused = {}, True, False
    rows = _rows((CASES, TIMED), (CASES_F32, TIMED_F32))
    for i, (dtype, (name, B, Sq, Sk, KV, G, D, causal, cap, *qscale)) in enumerate(rows):
        q, k, v = _inputs(B, Sq, Sk, KV, G, D, seed=i, qscale=qscale[0] if qscale else 1.0,
                          dtype=dtype)
        try:
            out = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
        except RuntimeError as e:  # an earlier design's refusal (B * H past its grid)
            if not str(e).endswith("cudaError 1"):
                raise
            results[name] = {"ok": False, "refused": str(e)}
            refused = True
            continue
        torch.cuda.synchronize()
        errs, ok = ref.flash_attention_check(out, q, k, v, causal=causal, softcap=cap)
        results[name] = {**errs, "ok": ok}
        ok_all &= ok
        del q, k, v, out
    emit("check", build=label, ok=ok_all and not refused, cases=results)
    return CHECK_FAILED if not ok_all else REFUSED if refused else 0


def child_time(libs, iters):
    import ctypes

    import torch.nn.functional as F

    import chip_smoke

    loaded = {label: ctypes.CDLL(path) for label, path in libs.items()}

    shapes = [("bf16", row) for row in TIMED] + [("f32", row) for row in TIMED_F32]
    for dtype, (name, B, S, KV, G, D, causal, cap) in shapes:
        q, k, v = _inputs(B, S, S, KV, G, D, seed=100, dtype=dtype)
        flops, nbytes = chip_smoke._flash_work(q, k, causal)
        bound_ms, by = chip_smoke.bound(flops, nbytes, chip_smoke.PEAK_BF16 if dtype == "bf16"
                                        else chip_smoke.PEAK_F32_3XTF32)
        order = list(libs) + list(reversed(libs))
        times = {label: [] for label in libs}
        for label in order:
            fa = _use(loaded[label])
            times[label].append(chip_smoke.time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal, softcap=cap), iters))
        lib_ms = None
        if not cap:  # SDPA has no softcap
            qt = q.reshape(B, S, KV * G, D).transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            lib_ms = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
            del qt, kt, vt
        emit("time", shape=name, dtype=dtype, B=B, S=S, KV=KV, G=G, D=D, causal=causal,
             softcap=cap,
             flops=flops, bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
             ms={label: t for label, t in times.items()},
             tflops={label: flops / (min(t) * 1e9) for label, t in times.items()},
             ms_over_library={label: min(t) / lib_ms for label, t in times.items()}
             if lib_ms else None)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--also", action="append", default=[],
                    help="LABEL=PATH[:FLAGS]: another source to build and time beside")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--child", choices=("check", "time"))
    ap.add_argument("--lib", action="append", default=[], help="label=path (child)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash needs a CUDA device; none is available")
    if args.child:
        libs = dict(x.split("=", 1) for x in args.lib)
        if args.child == "check":
            (label, path), = libs.items()
            return child_check(label, path)
        return child_time(libs, args.iters)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    libs = build_all(args.also)
    passed, timed, refused = {}, {}, set()
    me = [sys.executable, str(Path(__file__).resolve())]
    for label, path in libs.items():
        try:
            rc = subprocess.run(me + ["--child", "check", "--lib", f"{label}={path}"],
                                timeout=300).returncode
        except subprocess.TimeoutExpired:
            emit("check", build=label, ok=False, error="timed out: the kernel hung")
            continue
        if rc == 0:
            passed[label] = timed[label] = path
        elif rc == REFUSED and label != "kept":
            timed[label] = path
            refused |= {label} if rc == REFUSED else set()
    if timed:
        try:
            subprocess.run(me + ["--child", "time", "--iters", str(args.iters)]
                           + [f"--lib={label}={path}" for label, path in timed.items()],
                           timeout=900, check=False)
        except subprocess.TimeoutExpired:
            emit("time", error="timed out")
    every = len(libs) == 1 + len(args.also) and set(timed) == set(libs)
    return 0 if every and set(passed) >= set(libs) - refused else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the device time goes in a qwen3-1.7b train step, on one GPU.

    python3 scripts/profile_train.py

Builds ``chip_smoke.py``'s ``train`` phase at full width (28 layers, bf16
compute over f32 params, remat per layer, S 4,096, batch 2, AdamW from
``for_config``) on the card and warms up one step. Then it prints one
JSON line each for:
  * ``step``: one step traced with ``torch.profiler``: host wall ms (ending
    in a device synchronise), device busy ms (kernel self times), the
    device's idle share, launches, and the kernels that took most time;
  * ``attention``: the chunked attention twin alone at one layer's shapes
    (q (2, 4,096, 8, 2, 128), k/v (2, 4,096, 8, 128), bf16), timed with CUDA
    events: a forward, and a forward with its backward (which recomputes
    each KV block); a layer of the step runs its forward three times (the
    step's forward, the period's recompute, the block's recompute) and its
    backward once, so its share of the step is 28 × (fwd + fwd_bwd) over
    the step's device time.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the train phase's shapes; sets up src/ and cuBLAS)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import layers as L
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA device")
    B, S = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    opt = optim.for_config(cfg)
    state = init_state(model, opt, torch.Generator("cuda").manual_seed(0))
    batch = chip_smoke._batch_on(TokenPipeline(cfg.vocab_size, B, S).next_batch(), "cuda")
    step = make_train_step(model, opt)
    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    print(json.dumps({
        "trace": "step", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches": sum(e.count for e in kernels), "loss": float(m["loss"]),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top]}), flush=True)

    # the chunked twin alone at one layer's shapes
    g = torch.Generator("cuda").manual_seed(1)
    KV, G, D = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q = torch.randn((B, S, KV, G, D), generator=g, device="cuda").bfloat16().requires_grad_()
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16().requires_grad_()
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16().requires_grad_()
    dout = torch.randn((B, S, KV, G, D), generator=g, device="cuda").bfloat16()

    def fwd():
        with torch.no_grad():
            L._flash_attention_qchunked(q, k, v, causal=True, softcap=0.0)

    def fwd_bwd():
        out = L._flash_attention_qchunked(q, k, v, causal=True, softcap=0.0)
        torch.autograd.grad(out, (q, k, v), dout)

    att = {"fwd_ms": chip_smoke.time_ms(fwd, 5), "fwd_bwd_ms": chip_smoke.time_ms(fwd_bwd, 5)}
    att["per_layer_in_step_ms"] = att["fwd_ms"] + att["fwd_bwd_ms"]
    att["step_share"] = cfg.num_layers * att["per_layer_in_step_ms"] / busy_ms
    print(json.dumps({"trace": "attention", "shape": [B, S, KV, G, D], **att}), flush=True)
    del q, k, v, dout

    print(chip_smoke.phase_device()["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

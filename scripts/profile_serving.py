#!/usr/bin/env python3
"""Where the device time goes on the port's serving path, on one GPU.

    python3 scripts/profile_serving.py

Builds the main path's model and prompt as ``chip_smoke.py`` does (its
``main_path_model``: qwen3-1.7b at full width, random weights from a seed,
2 prompts of 4,096 tokens) on the card, warms up one in-memory
``generate``, then traces with ``torch.profiler`` one prefill and one
decode step against its cache; then it puts that cache into the main
path's store (``chip_smoke.serving_store``: 900 chunks behind 4 storage
engines) and traces one fetch of it (chunk reads, the merge of the
arrival runs, the unpack onto the card).
For each it prints one JSON line: host wall time (ms, ending in a device
synchronise), device busy time (sum of kernel self times, ms), the
device's idle share, the number of kernel launches, and the kernels that
took the most device time, and the copies between host and device (count
and device ms). The trace itself adds host overhead, so wall
times here run above ``chip_smoke.py``'s. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the main path's shapes, model and prompt)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def trace(label, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    copies = [e for e in kernels if "Memcpy" in e.key]
    print(json.dumps({
        "trace": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches": sum(e.count for e in kernels),
        "copies": {e.key[:40]: {"count": e.count, "device_ms": _device_us(e) / 1e3}
                   for e in copies},
        "top": [{"name": e.key[:80], "count": e.count, "device_ms": _device_us(e) / 1e3}
                for e in top]}), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_serving needs a CUDA device; none is available")
    from repro_torch.serve import generate, make_decode_step, make_prefill_step

    _, model, params, prompt = chip_smoke.main_path_model()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    with torch.inference_mode():
        generate(model, params, prompt, steps=2, max_len=chip_smoke.MAX_LEN)  # warm-up
        prefill = make_prefill_step(model, chip_smoke.MAX_LEN)
        decode = make_decode_step(model)
        logits, cache = trace("prefill", lambda: prefill(params, {"tokens": prompt}))
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        decode(params, cache, tok)  # warm-up step
        trace("decode_step", lambda: decode(params, cache, tok))
    store = chip_smoke.serving_store()
    store.put(prompt, cache)
    del logits, cache
    torch.cuda.empty_cache()
    trace("fetch", lambda: store.fetch(prompt))
    print(json.dumps({"fetch_merge_runs": store.stats.merge_runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

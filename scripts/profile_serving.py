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
synchronise), device busy time (ms, a union of the device operations'
intervals, so kernels that overlap count once), the device's idle share
of the traced call, the number of kernel launches, the kernels that took
the most device time, the copies between host and device (count and
device ms), and, where the program's spans (``repro_torch.spans``) are in
the trace, device ms, launches and idle ms by the innermost span open at
each launch (``bench/spans.py``). The trace itself adds host overhead, so
wall times here run above ``chip_smoke.py``'s. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the main path's shapes, model and prompt)
from bench import spans  # noqa: E402
from bench import trace as trace_mod  # noqa: E402


def trace(label, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("bench.window"):  # the window bench.trace reads
            out = fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = trace_mod.export(prof)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    t = trace_mod.parse(events, n_requests=1)
    busy_ms = t.busy_s() * 1e3
    copies = defaultdict(lambda: {"count": 0, "device_ms": 0.0})
    for o in t.device:
        if o.cat == "gpu_memcpy":
            copies[o.name[:40]]["count"] += 1
            copies[o.name[:40]]["device_ms"] += (o.end - o.start) * 1e3
    by_span = spans.from_events(events)
    print(json.dumps({
        "trace": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - t.busy_s() / t.window_s,
        "launches": len(t.kernels()), "copies": copies,
        "top": [{"name": name[:80], "device_ms": s * 1e3} for name, s in t.top_ops(12)],
        "spans": [{"span": r["span"], "device_ms": r["device_s"] * 1e3,
                   "launches": r["launches"], "idle_ms": r["idle_s"] * 1e3}
                  for r in by_span.table()] if by_span else None}), flush=True)
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

#!/usr/bin/env python3
"""Where the time of a step under the sharding rules goes, on one GPU.

    python3 scripts/profile_distribution.py

Builds ``chip_smoke.py``'s distribution cells (qwen3-1.7b at full width,
random weights from its seed) on a real 1x1 DeviceMesh (NCCL, a world of
one): the decode cell (batch 8, one step against a 32,768-entry cache)
and the prefill cell (batch 2 at S 32,768). For each it runs the step once
without rules and once under the plan's rules on DTensor arguments, as
warm-up, then traces one call of each with ``torch.profiler``. Each trace
prints one JSON line: host wall time (ms, ending in a device synchronise),
device busy time (sum of kernel self times, ms), the device's idle share,
kernel launches, the kernels that took the most device time, the host
operator calls, and the host operators with the most self CPU time (the
dispatch a DTensor adds lands there). The trace adds host overhead of its
own, so wall times run above ``chip_smoke.py``'s. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the distribution cells' cuts, seed and helpers)


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
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    host = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CPU")]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "trace": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "count": e.count, "device_ms": _device_us(e) / 1e3}
                        for e in sorted(kernels, key=_device_us, reverse=True)[:10]],
        "host_op_calls": sum(e.count for e in host),
        "top_host_self": [{"name": e.key[:80], "count": e.count,
                           "self_cpu_ms": e.self_cpu_time_total / 1e3}
                          for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                                          reverse=True)[:12]]}), flush=True)
    return out


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError("profile_distribution needs a CUDA device; none is available")
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import plan_cell
    from repro_torch.serve.step import make_decode_step
    from repro_torch.sharding import use_rules
    from repro_torch.tree import tree_leaves, tree_map

    arch, seed = chip_smoke.DIST_ARCH, chip_smoke.DIST_SEED
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    mesh = make_debug_mesh()
    try:
        with torch.inference_mode():
            db, _ = chip_smoke.DIST_CUTS["decode_32k"]
            plan = plan_cell(arch, "decode_32k", mesh, batch=db)
            params = plan.model.init(torch.Generator("cuda").manual_seed(seed))
            L = plan.cell.seq_len
            gen = torch.Generator("cuda").manual_seed(seed + 2)
            cache = tree_map(lambda t: (
                torch.full(tuple(t.shape), L - 1, dtype=torch.int32, device="cuda")
                if t.dtype == torch.int32 else
                torch.randn(tuple(t.shape), generator=gen, dtype=t.dtype, device="cuda")),
                plan.abstract_args[1])
            tokens = chip_smoke._dist_tokens({"t": plan.abstract_args[2]},
                                             plan.cfg.vocab_size, seed + 3)["t"]
            step = make_decode_step(plan.model)
            placed = plan.place((params, cache, tokens))

            def rewind(c):
                # a step advances the stacked cache's lengths in place:
                # every call starts from the last slot again
                for t in tree_leaves(c):
                    if t.dtype == torch.int32:
                        t.fill_(L - 1)

            def plain_decode():
                return step(params, cache, tokens)

            def ruled_decode():
                with use_rules(plan.rules):
                    return step(*placed)

            for label, f, c in (("decode_plain", plain_decode, cache),
                                ("decode_rules", ruled_decode, placed[1])):
                rewind(c)
                f()  # warm-up
                rewind(c)
                torch.cuda.synchronize()
                trace(label, f)
            del cache, placed
            torch.cuda.empty_cache()

            pb, _ = chip_smoke.DIST_CUTS["prefill_32k"]
            plan = plan_cell(arch, "prefill_32k", mesh, batch=pb)
            batch = chip_smoke._dist_tokens(plan.abstract_args[1], plan.cfg.vocab_size,
                                            seed + 1)
            placed = plan.place((params, batch))

            def ruled_prefill():
                with use_rules(plan.rules):
                    return plan.constrain(plan.fn(*placed))

            for f in (lambda: plan.fn(params, batch), ruled_prefill):
                f()  # warm-up
                torch.cuda.empty_cache()
            trace("prefill_plain", lambda: plan.fn(params, batch))
            torch.cuda.empty_cache()
            trace("prefill_rules", ruled_prefill)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

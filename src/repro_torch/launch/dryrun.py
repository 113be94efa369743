"""Dry run (port of ``src/repro/launch/dryrun.py``): plan every
(architecture × shape cell × mesh) against the production meshes, trace
each plan's step over DTensors on the ``fake`` process-group backend, and
record per-device memory, collective wire bytes and the three-term H100
roofline. Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch qwen3-1.7b]
        [--cell train_4k] [--multi-pod | --single-pod | --both]
        [--out dryrun.jsonl] [--plan-only] [--perf]

One JSON line per cell, ``status`` OK, SKIP or FAIL, with the torch
release that planned it (``torch``); a FAIL names the op that failed.
``--plan-only`` stops after the plan: argument bytes per device and the
analytic roofline terms, no trace. A train cell of several
microbatches is traced over one and scaled (its ``notes`` say so).

The fake process group is set up inside ``main()``, never at import; it
is this process's default group, so a process that runs real collectives
runs this module in a child (``python -m repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def run_cell(arch: str, cell_name: str, multi_pod: bool, perf: bool = False,
             plan_only: bool = False):
    import torch

    from repro_torch import roofline as R
    from repro_torch.launch.mesh import abstract_production_mesh, make_production_mesh
    from repro_torch.launch.specs import CellSkip, plan_cell

    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.perf_counter()
    try:
        mesh = (abstract_production_mesh if plan_only
                else make_production_mesh)(multi_pod=multi_pod)
        plan = plan_cell(arch, cell_name, mesh, perf=perf)
    except CellSkip as e:
        return {"arch": arch, "cell": cell_name, "mesh": mesh_name,
                "status": "SKIP", "reason": str(e), "torch": torch.__version__}
    t_plan = time.perf_counter() - t0
    row = {"arch": arch, "cell": cell_name, "mesh": mesh_name, "status": "OK",
           "torch": torch.__version__, "t_plan_s": round(t_plan, 3),
           "arg_bytes": plan.arg_bytes()}
    trace = None
    if not plan_only:
        trace = plan.trace(one_microbatch=True)
        row.update(t_trace_s=round(trace.seconds, 2), temp_bytes=trace.temp_bytes,
                   out_bytes=trace.out_bytes, peak_bytes=trace.peak_bytes)
    rl = R.analyze(plan, trace, mesh_name)
    notes = rl.notes
    if trace is not None and trace.microbatches_traced < plan.microbatches:
        notes += (f"; traced 1 of {plan.microbatches} microbatches, collectives and "
                  f"flops_traced x{plan.microbatches}")
    row.update({
        "mem_per_dev_GiB": round(rl.memory_per_device / 2**30, 3),
        "flops_analytic": rl.flops,
        "flops_traced": rl.flops_traced if trace is not None else None,
        "bytes_analytic": rl.hbm_bytes,
        "coll_bytes_per_dev": rl.coll_bytes if trace is not None else None,
        "coll_breakdown": rl.coll_breakdown,
        "coll_counts": trace.collective_counts if trace is not None else None,
        "t_compute_ms": rl.t_compute * 1e3,
        "t_memory_ms": rl.t_memory * 1e3,
        "t_collective_ms": rl.t_collective * 1e3 if trace is not None else None,
        "bottleneck": rl.bottleneck,
        "model_flops": rl.model_flops,
        "useful_ratio": rl.useful_ratio,
        "notes": notes,
    })
    return row


def _failing_op(exc: BaseException) -> str:
    """The first line of the error, where DTensor names the op it could
    not propagate."""
    text = f"{type(exc).__name__}: {exc}"
    for line in text.splitlines():
        if "Sharding propagation failed for" in line:
            return line.strip()
    return text.splitlines()[0] if text else type(exc).__name__


def main(argv=None):
    from repro_torch.launch.specs import ALL_ARCHS
    from repro_torch.models.config import SHAPE_CELLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--cell", default=None, help="one cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--plan-only", action="store_true",
                    help="plan and the analytic roofline only, no trace")
    ap.add_argument("--perf", action="store_true",
                    help="apply the reference's hillclimb variants")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ALL_ARCHS
    cells = [args.cell] if args.cell else list(SHAPE_CELLS)
    meshes = [False, True] if (args.both or not (args.multi_pod or args.single_pod)) \
        else ([True] if args.multi_pod else [False])

    out = open(args.out, "a") if args.out else None
    failures = 0
    try:
        for mp in meshes:
            for arch in archs:
                for cell in cells:
                    try:
                        res = run_cell(arch, cell, mp, perf=args.perf,
                                       plan_only=args.plan_only)
                    except Exception as e:  # noqa: BLE001 — a FAIL row, then the next cell
                        res = {"arch": arch, "cell": cell,
                               "mesh": "2x16x16" if mp else "16x16",
                               "status": "FAIL", "error": _failing_op(e),
                               "trace": traceback.format_exc()[-2000:]}
                        failures += 1
                    line = json.dumps(res)
                    print(line if res["status"] == "OK" else json.dumps(
                        {k: v for k, v in res.items() if k != "trace"}), flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

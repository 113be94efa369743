#!/usr/bin/env python3
"""Where the time of one dry-run trace goes, on the CPU.

    PYTHONPATH=src python3 scripts/profile_dryrun.py [--arch glm4-9b]
        [--cell train_4k] [--multi-pod] [--num-layers 2] [--stop-after 300]
        [--top 12] [--no-memo] [--anomaly]

Plans the cell (``launch.specs.plan_cell``, the config's depth cut to
``--num-layers``, 0 for the config's own) on the fake production mesh and
traces it over one microbatch under ``cProfile``, as ``launch.dryrun``
does. Prints one JSON line: torch's version, the mesh, the trace's seconds
(or, if it has not ended after ``--stop-after`` seconds, that it was
stopped then), its collective wire bytes, and the functions with the most
own time and the most cumulative time (file:line, calls, seconds). The
time limit ends the process from a timer thread, so a trace that would
run for hours still reports where its first minutes went.

A trace that fails reports its error and the last ``--top`` local ops it
ran (arguments as shape/stride). ``--no-memo`` runs every op itself
instead of allocating the remembered layout of a pure op on ``meta``
(``roofline.TraceRecorder``); ``--anomaly`` traces under autograd's
anomaly mode, so a failing backward also reports the forward stack that
recorded its node.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import json
import os
import pstats
import sys
import threading
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _top(prof: cProfile.Profile, key: str, n: int):
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2 if key == "tottime" else 3])[:n]
    return [{"fn": f"{Path(f).name}:{line} {name}", "calls": nc, "tottime_s": round(tt, 3),
             "cumtime_s": round(ct, 3)} for (f, line, name), (_, nc, tt, ct, _) in rows]


def _desc(x) -> str:
    import torch

    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)}/{tuple(x.stride())}"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_desc(e) for e in x[:6]) + (", ..." if len(x) > 6 else "") + "]"
    return repr(x)[:40]


def main(argv=None) -> int:
    import torch

    from repro_torch import roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import plan_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--cell", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--stop-after", type=float, default=300.0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--no-memo", action="store_true")
    ap.add_argument("--anomaly", action="store_true")
    a = ap.parse_args(argv)
    mesh_name = "2x16x16" if a.multi_pod else "16x16"
    rec = {"torch": torch.__version__, "arch": a.arch, "cell": a.cell, "mesh": mesh_name,
           "num_layers": a.num_layers, "memo": not a.no_memo, "anomaly": a.anomaly}
    last = collections.deque(maxlen=a.top)
    run = roofline.TraceRecorder._run

    def logged_run(self, func, args, kwargs):
        last.append(f"{func} " + _desc(list(args)))
        return func(*args, **kwargs) if a.no_memo else run(self, func, args, kwargs)

    roofline.TraceRecorder._run = logged_run
    prof = cProfile.Profile()
    t0 = time.perf_counter()

    def report(**kw):
        prof.disable()
        rec.update(kw, top_own=_top(prof, "tottime", a.top),
                   top_cumulative=_top(prof, "cumtime", a.top))
        print(json.dumps(rec), flush=True)

    def stop():
        report(stopped_after_s=round(time.perf_counter() - t0, 1))
        os._exit(0)

    timer = threading.Timer(a.stop_after, stop)
    timer.daemon = True
    timer.start()
    plan = plan_cell(a.arch, a.cell, make_production_mesh(multi_pod=a.multi_pod),
                     **({"num_layers": a.num_layers} if a.num_layers else {}))
    prof.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.autograd.set_detect_anomaly(a.anomaly, check_nan=False)
        try:
            trace = plan.trace(one_microbatch=True)
        except Exception as e:  # noqa: BLE001  (the report is the point)
            timer.cancel()
            forward = [str(w.message) for w in caught if "forward call" in str(w.message)]
            report(failed_after_s=round(time.perf_counter() - t0, 1),
                   error=f"{type(e).__name__}: {e}".splitlines()[0], last_ops=list(last),
                   forward_stack=forward[-1:])
            os._exit(1)
    timer.cancel()
    report(trace_s=round(trace.seconds, 2), collectives=trace.collectives,
           peak_bytes=trace.peak_bytes)
    os._exit(0)  # the fake process group needs no teardown


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics.

The window drives the program's prefill node with one client in a closed
loop: each request runs the prefill that ``repro_torch.serve.generate``
runs (``serve.step.make_prefill_step``), takes the greedy first token from
the last position's logits and brings it to the host, and the next request
is dispatched then; its cache stays on the card until it is dropped
(decode is another node's). A request's time to first token runs from its
dispatch to its token on the host.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bench import trace as trace_mod
from bench import traffic, weights, yardstick

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ------------------------------------------------------------ the files
def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """Everything a run reads about its cell, from the files that the
    names in ``BENCHMARK.json`` lead to."""

    name: str
    workload: dict
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    own: dict  # cells/<workload>.json: the check's limits
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def widths(self) -> dict:
        return self.config["widths"]

    @property
    def reference(self):
        """The plain reference that the configuration names:
        ``bench/reference/<reference>.py``."""
        return importlib.import_module(f"bench.reference.{self.config['reference']}")

    def flops(self, rows: int, seq: int) -> float:
        """The benchmark's count of a prefill's work: the reference's own
        ``prefill_flops`` where it has one, else a dense GQA model's."""
        count = getattr(self.reference, "prefill_flops", yardstick.prefill_flops)
        return count(self.widths, rows, seq)


def _for_cell(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def load_cell(name: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    return Cell(
        name=name, workload=wl,
        config=load_json(ROOT / cfg_entry["file"]),
        mix=load_json(ROOT / "bench" / "traffic" / f"{wl['traffic']}.json"),
        own=load_json(ROOT / "bench" / "cells" / f"{name}.json"),
        end_to_end=_for_cell(spec["end_to_end"], name),
        per_layer=_for_cell(spec["per_layer"], name),
    )


def load_reader(metric: str) -> Callable:
    """``bench/metrics/<metric>.py``'s ``read``."""
    path = ROOT / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the program
def build_program(cell: Cell, device):
    """The program's model for the cell's configuration: the port's arch
    with every width and dtype that the configuration file states."""
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    port = cell.config["port"]
    fields = dict(port.get("fields", {}))
    for k in ("param_dtype", "compute_dtype"):
        if k in fields:
            fields[k] = DTYPES[fields[k]]
    cfg = get_config(port["arch"]).with_(**cell.widths, **fields)
    return build_model(cfg)


def program_step(model, seq: int):
    """The program's prefill of prompts of ``seq`` tokens."""
    from repro_torch.serve.step import make_prefill_step

    return make_prefill_step(model, max_len=seq)


def first_token(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row from the last position's logits."""
    return torch.argmax(logits[:, -1], dim=-1)


def program_kv(cache: dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(k, v)] of each attention layer in order, each (B, L, KV, hd), from
    the program's cache: stacked over periods of one or more layers
    (layer j·p + i is slot i of period j), or one entry a layer."""
    stack = cache["stack"]
    if "scan" in stack:
        period = stack["scan"]
        n = next(lc["kv"]["k"].shape[0] for lc in period if "kv" in lc)
        return [(lc["kv"]["k"][j], lc["kv"]["v"][j])
                for j in range(n) for lc in period if "kv" in lc]
    return [(lc["kv"]["k"], lc["kv"]["v"]) for lc in stack["unroll"] if "kv" in lc]


# ------------------------------------------------------------ the check
@dataclass
class Output:
    """What the timed path produced for a request the check compares."""

    rows: List[int]
    tokens: torch.Tensor  # (R, S) the prompts of those rows
    logits: torch.Tensor  # (B, 1, V) the program's
    token: torch.Tensor  # (B,) on the host
    kv: List[Tuple[torch.Tensor, torch.Tensor]]


def compare(ref_mod, params, widths: dict, outs: List[Output]) -> List[Dict[str, float]]:
    """The numbers compared for each of ``outs`` (candidates for the same
    checked prompts), against one run of the plain f32 reference
    ``ref_mod`` on those prompts and the same weights.

    - ``token_gap``: how far the served token's reference logit lies below
      the reference's best, in standard deviations of the reference's
      logits over the vocabulary; worst row.
    - ``logit_err``: the largest |candidate − reference| over the
      vocabulary, in the same units; worst row.
    - ``kv_err``: ‖candidate − reference‖ / ‖reference‖ of each layer's
      cached k and of its v over the checked rows; worst of all. A cache of
      another length than the prompt, or another number of layers, reads
      infinite.
    """
    tokens = outs[0].tokens
    S = tokens.shape[1]
    kv_err = [0.0] * len(outs)

    def on_kv(i, k, v):
        for j, out in enumerate(outs):
            if i >= len(out.kv):
                kv_err[j] = math.inf
                continue
            rows = torch.tensor(out.rows, device=out.kv[i][0].device)
            for p, r in zip(out.kv[i], (k, v)):
                if p.shape[1] != S:
                    kv_err[j] = math.inf
                    continue
                p = p.index_select(0, rows).to(r.device).float()
                e = ((p - r).norm() / r.norm().clamp_min(1e-30)).item()
                kv_err[j] = max(kv_err[j], e)

    ref = ref_mod.prefill(params, widths, tokens, on_kv=on_kv)
    sd = ref.std(dim=-1)
    best = ref.amax(-1)
    res = []
    for j, out in enumerate(outs):
        if len(out.kv) != ref_mod.num_layers(params):
            kv_err[j] = math.inf
        rows = torch.tensor(out.rows)
        got = out.logits[:, -1].index_select(0, rows.to(out.logits.device)).to(ref.device)
        tok = out.token.index_select(0, rows.to(out.token.device)).to(ref.device).long()
        gap = (best - ref.gather(-1, tok[:, None])[:, 0]) / sd
        err = (got.float() - ref).abs().amax(-1) / sd
        res.append({"token_gap": gap.max().item(), "logit_err": err.max().item(),
                    "kv_err": kv_err[j]})
    return res


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    keys = ("token_gap", "logit_err", "kv_err")
    return {k: max((r[k] for r in readings), default=math.nan) for k in keys}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Each number beside its limit; correct when every one is within."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# ------------------------------------------------------------ the run
@dataclass
class Served:
    index: int
    rows: int
    seq: int
    start: float  # dispatch, seconds after the window opened
    end: float  # first token on the host
    traced: str = ""  # "device" or "host": the stretch that recorded it

    @property
    def tokens(self) -> int:
        return self.rows * self.seq


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    window_end: float  # seconds from the window's opening to the last completion
    served: List[Served]
    trace: Optional[object] = None  # the device-only stretch (``trace.Trace``)
    host_trace: Optional[object] = None  # the stretch with the host's operations

    @property
    def widths(self) -> dict:
        return self.cell.widths

    def flops(self, rows: int, seq: int) -> float:
        return self.cell.flops(rows, seq)


def token_seed(seed: int) -> int:
    return (seed * 0x9E3779B1 + 0x7F4A7C15) % (1 << 63)


def make_inputs(cell: Cell, seed: int, device):
    """The client's requests in order and their prompts: views of one
    draw of token ids on the device."""
    reqs = traffic.sequence(cell.mix, seed)
    total = sum(r.tokens for r in reqs)
    gen = torch.Generator(device=device).manual_seed(token_seed(seed))
    flat = torch.randint(0, cell.widths["vocab_size"], (total,), dtype=torch.int32,
                         device=device, generator=gen)
    prompts, off = [], 0
    for r in reqs:
        prompts.append(flat[off:off + r.tokens].view(r.rows, r.seq))
        off += r.tokens
    return reqs, prompts


def make_params(cell: Cell, model, seed: int, device):
    """The benchmark's weights for ``model``, from the seed."""
    ref = cell.reference
    return weights.make(model.abstract_params(), seed, device,
                        DTYPES[cell.config["port"]["fields"]["param_dtype"]],
                        fan_in=getattr(ref, "fan_in", weights.fan_in))


def check_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark forbids."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Tracer:
    """The traced run's two stretches at the window's start: the first
    ``trace_requests`` requests under a profiler that records device
    activity only (the per-layer metrics read it), then
    ``trace_host_requests`` under one that records the host's operations
    too (only the breakdown of idle gaps reads it)."""

    def __init__(self, mix: dict, device):
        self.device = device
        self.n_dev = int(mix["trace_requests"])
        self.n_host = int(mix.get("trace_host_requests", 0))
        self.acts_dev, self.acts_host = _activities(device)
        for acts in (self.acts_dev, self.acts_host):  # a tracer's first start is slow
            with torch.profiler.profile(activities=acts):
                torch.ones(1, device=device).add_(1)
                _sync(device)
        self.prof = self.span = None
        self.kind = ""  # the open stretch
        self.done: Dict[str, str] = {}  # stretch: its exported trace

    def stretch(self, i: int) -> str:
        """The stretch that records request ``i``, or ""."""
        return "device" if i < self.n_dev else (
            "host" if i < self.n_dev + self.n_host else "")

    def before(self, i: int) -> None:
        if i == 0 and self.n_dev:
            self._start("device", self.acts_dev)
        if i == self.n_dev and self.n_host:
            self._start("host", self.acts_host)

    def after(self, i: int) -> None:
        if i + 1 in (self.n_dev, self.n_dev + self.n_host):
            self.stop()

    def _start(self, kind: str, acts) -> None:
        self.kind = kind
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function("bench.window")
        self.span.__enter__()
        _sync(self.device)  # the window's first marker

    def stop(self) -> None:
        """Ends the open stretch, if any (also when the window closed first)."""
        if self.prof is None:
            return
        _sync(self.device)  # the window's last marker
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done[self.kind] = trace_mod.export(self.prof)
        self.prof = self.span = None

    def read(self, n_served: Dict[str, int]):
        """(device-only trace, trace with the host), each None if not made."""
        out = {kind: trace_mod.load(path, n_served.get(kind, 0))
               for kind, path in self.done.items()}
        self.done.clear()
        return out.get("device"), out.get("host")


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, *, device="cuda",
        t_start: Optional[float] = None) -> dict:
    """One run; returns the result object, ``checks`` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    parts = {"start": time.perf_counter() - t_start}
    model = build_program(cell, device)
    params = make_params(cell, model, seed, device)
    reqs, prompts = make_inputs(cell, seed, device)
    _sync(device)
    parts["weights"] = time.perf_counter() - t_start - parts["start"]
    picked = dict(traffic.sample(cell.mix, reqs, seed))

    with torch.inference_mode():
        for rows, seq in sorted({(r.rows, r.seq) for r in reqs}):  # the shapes sent
            toks = torch.zeros((rows, seq), dtype=torch.int32, device=device)
            logits, _ = program_step(model, seq)(params, {"tokens": toks})
            first_token(logits).cpu()
            del logits, _
        tracer = Tracer(cell.mix, device) if trace_on else None
        _sync(device)
        gc.collect()
        gc.freeze()

        served: List[Served] = []
        kept = []  # what the check compares, as the window produced it
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        parts["warm_up"] = setup_s - parts["weights"] - parts["start"]
        for i, (req, toks) in enumerate(zip(reqs, prompts)):
            if time.perf_counter() - t0 >= seconds:
                break
            stretch = ""
            if tracer is not None:
                tracer.before(i)
                stretch = tracer.stretch(i)
            start = time.perf_counter() - t0
            with _span("bench.request", stretch == "host"):
                logits, cache = program_step(model, req.seq)(params, {"tokens": toks})
                tok = first_token(logits).cpu()
            end = time.perf_counter() - t0
            served.append(Served(req.index, req.rows, req.seq, start, end, stretch))
            if req.index in picked:
                kept.append((req.index, toks, logits, tok, cache))
            del logits, cache
            if tracer is not None:
                tracer.after(i)
        window_end = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
    gc.unfreeze()

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del prompts, reqs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    dev_trace = host_trace = None
    if tracer is not None:
        counts: Dict[str, int] = {}
        for s in served:
            counts[s.traced] = counts.get(s.traced, 0) + 1
        dev_trace, host_trace = tracer.read(counts)
        del tracer

    readings = []
    with torch.inference_mode():
        for index, toks, logits, tok, cache in kept:
            rows = picked[index]
            sel = toks.index_select(0, torch.tensor(rows, device=toks.device))
            out = Output(rows, sel, logits, tok, program_kv(cache))
            readings.extend(compare(cell.reference, params, cell.widths, [out]))
    numbers = worst(readings)
    ok, checks = judge(numbers, cell.own["limits"])
    correct = ok and bool(kept)

    record = Run(cell, setup_s, window_end, served, dev_trace, host_trace)
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(served), "failed": 0,
              "metrics": metrics, "device": dev}
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s()
        dev["window_s"] = dev_trace.window_s
        gaps = (host_trace or dev_trace).idle_gaps()
        result["breakdown"] = {"device_ops": dev_trace.top_ops(), "idle_gaps": gaps}
    result["compared"] = len(readings)
    result["setup_parts_s"] = parts
    result["checks"] = checks
    return result


def _span(name: str, on: bool):
    """A span in the profiler's trace, or nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _activities(device):
    """(device only, with the host's operations). Without a card the
    device-only stretch records the host, the one device there is."""
    from torch.profiler import ProfilerActivity

    if device.type == "cuda":
        return [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU], [ProfilerActivity.CPU]

#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's numbers on many seeds, and the control's.

    python3 bench/control.py --workload glm4-9b.long_prompt --seeds 1,2,3 --control-seeds 1,2,3

For each seed it makes the weights and the client's requests as a run
does, takes the run's sample of requests (drawn from the first block,
which every window serves), and compares against the cell's plain f32
reference:
- ``program``: the program's prefill of each sampled request, at its
  timed size (every row of the batch);
- ``token_altered``: the same with each served token moved to the next
  id, the fault of an answer altered where it is produced;
- ``half_batch``: (batches of more than one row) the rows of the second
  half given the first half's outputs, the fault of half of the batch
  left out;
- ``norm_dropped``: the program's prefill with every norm scale taken as
  1, the fault of a norm whose weight is left out;
- ``control`` (``--control-seeds`` only): the reference itself computed
  in float8 e4m3 (every matmul input, and the cache), put in the
  program's place: the precision below the configuration's bf16; its
  ``token_gap`` is read at every position of the sampled prompts.
Each line of standard output is one JSON reading; the last holds, for
each number, the largest program reading and the smallest of each other
side. A cache left as it was made (zeros) reads ``kv_err`` 1 without a run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(ref, params, widths, tokens, block: int = 1024):
    """The numbers of the float8 reference put in the program's place on
    ``tokens`` (R, S): ``kv_err`` and ``logit_err`` as ``harness.compare``
    reads them, and ``token_gap`` at every position of the prompts: how far
    below the f32 reference's best lies the token that float8 puts first.
    ``ref`` is the cell's reference module."""
    import torch

    kv = []
    h_c = ref.prefill(params, widths, tokens, precision="fp8", all_positions=True,
                            on_kv=lambda i, k, v: kv.append((k, v)))
    kv_err = [0.0]

    def on_kv(i, k, v):
        for c, r in zip(kv[i], (k, v)):
            kv_err[0] = max(kv_err[0], ((c - r).norm() / r.norm()).item())
        kv[i] = None

    h_r = ref.prefill(params, widths, tokens, all_positions=True, on_kv=on_kv)
    gap, err = 0.0, 0.0
    S = tokens.shape[1]
    for s0 in range(0, S, block):
        lr = ref.logits(params, h_r[:, s0:s0 + block])
        lc = ref.logits(params, h_c[:, s0:s0 + block], "fp8")
        sd = lr.std(-1)
        picked = lr.gather(-1, lc.argmax(-1, keepdim=True))[..., 0]
        gap = max(gap, ((lr.amax(-1) - picked) / sd).max().item())
        if s0 + block >= S:
            err = ((lc[:, -1] - lr[:, -1]).abs().amax(-1) / sd[:, -1]).max().item()
        del lr, lc, picked
    del h_c, h_r, kv
    torch.cuda.empty_cache()
    return {"token_gap": gap, "logit_err": err, "kv_err": kv_err[0]}


def half_batch(out):
    """``out`` with the second half of its batch given the first half's
    outputs."""
    import torch

    from bench import harness

    B = out.logits.shape[0]
    src = torch.arange(B) % (B // 2)
    pick = lambda t: t.index_select(0, src.to(t.device))
    return harness.Output(out.rows, out.tokens, pick(out.logits),
                          pick(out.token), [(pick(k), pick(v)) for k, v in out.kv])


def readings(cell, seed, control: bool, device):
    import torch

    from bench import harness, traffic, weights

    model = harness.build_program(cell, device)
    params = harness.make_params(cell, model, seed, device)
    reqs, prompts = harness.make_inputs(cell, seed, device)
    worst = {}
    with torch.inference_mode():
        for idx, rows in traffic.sample(cell.mix, reqs, seed):
            req = reqs[idx]
            logits, cache = harness.program_step(model, req.seq)(params,
                                                                 {"tokens": prompts[idx]})
            tok = harness.first_token(logits).cpu()
            sel = prompts[idx].index_select(0, torch.tensor(rows, device=device))
            out = harness.Output(rows, sel, logits, tok, harness.program_kv(cache))
            sides = {"program": out,
                     "token_altered": harness.Output(rows, sel, logits,
                                                     (tok + 1) % cell.widths["vocab_size"],
                                                     out.kv)}
            if req.rows > 1:
                sides["half_batch"] = half_batch(out)
            n_logits, n_cache = harness.program_step(model, req.seq)(
                weights.with_unit_scales(params), {"tokens": prompts[idx]})
            sides["norm_dropped"] = harness.Output(rows, sel, n_logits,
                                                   harness.first_token(n_logits).cpu(),
                                                   harness.program_kv(n_cache))
            res = dict(zip(sides, harness.compare(cell.reference, params, cell.widths,
                                                  list(sides.values()))))
            if control:
                res["control"] = control_readings(cell.reference, params, cell.widths, sel)
            for side, r in res.items():
                print(json.dumps({"seed": seed, "side": side, "request": idx, "rows": rows,
                                  "seq": req.seq, "batch": req.rows, **r}), flush=True)
                w = worst.setdefault(side, {})
                for k, v in r.items():
                    w[k] = max(w.get(k, 0.0), v)
            del logits, cache, out, sides, n_logits, n_cache
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated program seeds")
    ap.add_argument("--control-seeds", default="", help="seeds that also run the control")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(
        ctrl - {int(s) for s in args.seeds.split(",")})
    per_seed = {}
    for seed in seeds:
        t0 = time.perf_counter()
        per_seed[seed] = readings(cell, seed, seed in ctrl, "cuda")
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          "worst": per_seed[seed]}), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for w in per_seed.values():
        for side, r in w.items():
            agg = summary.setdefault(side, {})
            for k, v in r.items():
                f = max if side == "program" else min
                agg[k] = f(agg[k], v) if k in agg else v
    print(json.dumps({"workload": args.workload, "seeds": len(per_seed),
                      "program_max": summary.get("program"),
                      "others_min": {k: v for k, v in summary.items() if k != "program"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Runs the port's cell plans on a real mesh of CPU processes, for
``tests/test_torch_launch.py``.

Each case is one ``:smoke`` arch's train step, prefill or decode, planned
by ``repro_torch.launch.specs.plan_cell`` on the mesh. Every rank makes the
same arguments from one seed, runs the plan's ``fn`` on them as plain
tensors, then runs it again with every argument cut to its shards at the
plan's placements (``distribute_tensor``) under the plan's rules, gathers
each output and compares. A train step also compares every parameter and
moment it updated in place.

Run as a script it starts a world of ``--world`` gloo processes (2×2 by
default) that meet through a FileStore, and rank 0 writes one JSON object
of results to OUT. A case may change integer fields of the config, the
length and a train step's microbatch count
(``qwen3-1.7b:smoke+num_kv_heads=1+seq=128+microbatches=2/train_4k``), and
``+f64`` runs params and compute in float64 (for a step whose f32 plain run
is itself ill-conditioned: xlstm's train step, whose f32 grad norm differs
from its float64 one by 3.4e-3 of itself, so that no split of its sums
could meet the tolerance in f32)::

    PYTHONPATH=src python tests/torch_mesh_util.py OUT.json \\
        qwen3-1.7b:smoke/train_4k granite-moe-3b-a800m:smoke/decode_32k
"""
import argparse
import copy
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.launch import specs as S
from repro_torch.sharding import use_rules
from repro_torch.train import optim
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

# the prefill past the flash threshold (qwen3: the flash op); train and
# decode shorter
SEQ = {"train_4k": 256, "prefill_32k": 2304, "decode_32k": 256}


def concrete(plan, seed=0):
    """Real CPU arguments of the plan's shapes: params from a seed, the
    rest from numpy; a decode cache whose every row has all but one entry."""
    rng = np.random.default_rng(seed)
    params = plan.model.init(torch.Generator().manual_seed(seed))

    def ints(t, hi):
        return torch.from_numpy(rng.integers(0, hi, tuple(t.shape)).astype(np.int32))

    def batch(abstract):
        return {k: ints(v, plan.cfg.vocab_size) for k, v in abstract.items()}

    if plan.cell.kind == "train":
        opt = optim.for_config(plan.cfg)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        return state, batch(plan.abstract_args[1])
    if plan.cell.kind == "prefill":
        return params, batch(plan.abstract_args[1])

    def fill(t):
        if t.dtype == torch.int32:
            return torch.full(tuple(t.shape), plan.cell.seq_len - 1, dtype=torch.int32)
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(
            t.dtype)

    cache = tree_map(fill, plan.abstract_args[1])
    return params, cache, ints(plan.abstract_args[2], plan.cfg.vocab_size)


def with_microbatches(plan, microbatches):
    """A train plan whose step splits its batch into ``microbatches`` (a
    ``:smoke`` arch has no entry in ``TRAIN_MICROBATCHES``, so one)."""
    if not microbatches:
        return plan
    from repro_torch.train.step import make_train_step

    return dataclasses.replace(plan, microbatches=microbatches, fn=make_train_step(
        plan.model, optim.for_config(plan.cfg), microbatches=microbatches))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _errors(want, got):
    """Path → (max |got − want|, max |want|, exact, float) over the leaves
    of two trees of one structure."""
    out = {}
    w, g = dict(tree_flatten_with_path(want)), dict(tree_flatten_with_path(got))
    assert w.keys() == g.keys(), (sorted(w), sorted(g))
    for k, wt in w.items():
        gt = _full(g[k])
        assert tuple(gt.shape) == tuple(wt.shape) and gt.dtype == wt.dtype, k
        d = (gt.double() - wt.double()).abs()
        out["/".join(map(str, k))] = (float(d.max()) if d.numel() else 0.0,
                                      float(wt.double().abs().max()) if wt.numel() else 0.0,
                                      bool(torch.equal(gt, wt)), wt.is_floating_point())
    return out


def run_case(mesh, arch, cell, seq=None, microbatches=None, f64=False, **overrides):
    """One cell of ``arch`` on ``mesh``, plain and under the plan's rules
    on its placements, in f32 compute (so that a sum split over shards
    differs from the whole one by rounding alone; ``f64``: params and
    compute in float64, where the model keeps its own f32 parts). Returns the output
    leaves' errors (and, for a train step, the updated state's), the count
    of arguments that are split over some mesh axis and the collectives
    the sharded run made."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.perf_counter()
    dtype = {"compute_dtype": torch.float64, "param_dtype": torch.float64} if f64 else {
        "compute_dtype": torch.float32}
    plan = with_microbatches(S.plan_cell(arch, cell, mesh, batch=4, seq=seq or SEQ[cell],
                                         **dtype, **overrides), microbatches)
    args = concrete(plan)
    plain_args = copy.deepcopy(args)
    sharded = sum(tree_leaves(plan.map_args(
        lambda sp, t: int(any(isinstance(p, Shard) for p in plan.rules.placements(sp))))))
    grad = torch.enable_grad() if plan.cell.kind == "train" else torch.no_grad()
    with grad:
        want = plan.fn(*plain_args)
        placed = plan.map_args(lambda sp, t: distribute_tensor(
            t, mesh, plan.rules.placements(sp)), copy.deepcopy(args))
        comm = CommDebugMode()
        with use_rules(plan.rules), comm:
            got = plan.constrain(plan.fn(*placed))
    errs = {"out/" + k: v for k, v in _errors(want, got).items()}
    if plan.cell.kind == "train":  # params and moments updated in place, both runs
        errs.update({"state/" + k: v for k, v in _errors(plain_args[0], placed[0]).items()})
    return {"errors": errs, "sharded_args": int(sharded), "microbatches": plan.microbatches,
            "collectives": int(comm.get_total_counts()),
            "seconds": time.perf_counter() - t0}


def _worker(rank, world, store, cases, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
        results = {}
        for case in cases:
            arch, cell = case.split("/")
            arch, *kv = arch.split("+")
            try:
                results[case] = run_case(mesh, arch, cell, **{
                    k: int(v) if v else True
                    for k, _, v in (o.partition("=") for o in kv)})
            except Exception:  # the same program fails on every rank alike
                results[case] = {"error": traceback.format_exc()}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("cases", nargs="+", help="arch[+field=int...][+f64]/cell")
    ap.add_argument("--world", type=int, default=4)
    a = ap.parse_args(argv)
    store_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "build", "dist")
    os.makedirs(store_dir, exist_ok=True)
    fd, store = tempfile.mkstemp(prefix="store-", dir=store_dir)
    os.close(fd)
    os.unlink(store)
    try:
        torch.multiprocessing.spawn(_worker, args=(a.world, store, a.cases, a.out),
                                    nprocs=a.world)
    finally:
        if os.path.exists(store):
            os.unlink(store)
    return 0


if __name__ == "__main__":
    sys.exit(main())

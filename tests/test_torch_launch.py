"""The port's cell planner, roofline and DTensor runs (``repro_torch.launch``,
``repro_torch.roofline``) against the JAX package's on the CPU:

  * for every (arch, cell) of ``repro.launch.specs`` on both production
    meshes, the same skips, and for the 32 planned cells every argument
    leaf's spec, shape and dtype and its per-device bytes (JAX's
    ``NamedSharding.shard_shape``) equal, as integers;
  * the roofline's analytic FLOPs, parameter counts and HBM bytes equal
    exactly;
  * qwen3-1.7b:smoke's train step (4 microbatches), prefill at S 2,304
    (the flash op, through its DTensor sharding strategy)
    and decode run under each plan's rules on a gloo 1×1 mesh, with their
    arguments DTensors at the plan's placements, bit-equal to the same
    calls on plain tensors; on a fake 2×2 mesh each traces, with
    collectives recorded and a peak of live bytes;
  * the cells of xlstm-125m, seamless-m4t-large-v2 and jamba at ``:smoke``
    traced on the fake 2×2 mesh too, and train steps on a fake 2×2×2 mesh;
  * the same calls, and those of an MoE, a Mamba, an xLSTM and the
    encoder–decoder arch and of a model whose KV heads do not divide the
    model axis, on a real 2×2 mesh of
    four gloo processes (``tests/torch_mesh_util.py``), where the
    arguments are split into shards: every output, updated parameter and
    moment gathered back equals the plain run within 2e-4 of its largest
    magnitude (f32 compute), and every integer output exactly.

A process group is the process's default one, so each mesh lives in a
fixture that tears its group down (xdist runs other files' tests after
these in the same worker). ``repro.launch.dryrun`` is never imported: it
sets the XLA host device count at import.
"""
import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro import roofline as JR
from repro.launch import specs as JS
from repro.models.config import SHAPE_CELLS as JAX_CELLS
from repro_torch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_production_mesh, make_debug_mesh, make_fake_mesh
from repro_torch.models.config import SHAPE_CELLS, get_config
from repro_torch.sharding import is_spec, use_rules
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
from torch_mesh_util import concrete, with_microbatches

CELLS = list(SHAPE_CELLS)


def _jax_mesh(multi_pod):
    if multi_pod:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


def _jax_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in flat}


class _Leaf:
    def __init__(self, v):
        self.v = v


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def test_cell_tables_match_jax():
    assert {k: (c.seq_len, c.global_batch, c.kind) for k, c in SHAPE_CELLS.items()} == {
        k: (c.seq_len, c.global_batch, c.kind) for k, c in JAX_CELLS.items()}
    assert S.ALL_ARCHS == JS.ALL_ARCHS and S.TRAIN_MICROBATCHES == JS.TRAIN_MICROBATCHES
    for name in ("FSDP_ARCHS", "SEQ_SHARD_TRAIN", "NO_SEQ_PREFILL", "PERF_SMALL_TRAIN",
                 "PERF_WEIGHT_STATIONARY_DECODE", "PERF_BF16_TRAIN"):
        assert getattr(S, name) == getattr(JS, name), name


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", S.ALL_ARCHS)
def test_plan_specs_and_arg_bytes_match_jax(arch, cell, multi_pod):
    """Every argument leaf: the same path, shape, dtype and spec, and the
    same per-device bytes; a cell JAX skips, the port skips too."""
    jm, tm = _jax_mesh(multi_pod), abstract_production_mesh(multi_pod=multi_pod)
    try:
        jplan = JS.plan_cell(arch, cell, jm)
    except JS.CellSkip as e:
        with pytest.raises(S.CellSkip, match="full-attention"):
            S.plan_cell(arch, cell, tm)
        assert "full-attention" in str(e)
        return
    tplan = S.plan_cell(arch, cell, tm)
    want_sh = _jax_flat(jplan.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    want_abs = _jax_flat(jplan.abstract_args)
    got_sp = {p: b.v for p, b in tree_flatten_with_path(
        tree_map(_Leaf, tplan.in_specs, is_leaf=is_spec))}
    got_abs = dict(tree_flatten_with_path(tplan.abstract_args))
    assert got_sp.keys() == want_sh.keys() == want_abs.keys() == got_abs.keys()
    total = 0
    for k, ns in want_sh.items():
        a, g = want_abs[k], got_abs[k]
        assert tuple(g.shape) == tuple(a.shape) and _dtype(g.dtype) == _dtype(a.dtype), k
        assert tuple(got_sp[k]) == tuple(ns.spec), k
        local = tplan.rules.local_shape(got_sp[k], g.shape)
        assert local == tuple(ns.shard_shape(a.shape)), k
        total += math.prod(ns.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
    assert tplan.arg_bytes() == total
    assert tplan.microbatches == jplan.microbatches and tplan.notes == jplan.notes


@pytest.mark.parametrize("arch", S.ALL_ARCHS)
def test_roofline_analytic_terms_match_jax(arch):
    jm, tm = _jax_mesh(False), abstract_production_mesh()
    tcfg = get_config(arch)
    jcfg = JS.get_config(arch)
    assert R.count_params(tcfg) == JR.count_params(jcfg)
    for cell in CELLS:
        c = SHAPE_CELLS[cell]
        B, L = c.global_batch, c.seq_len
        assert R.forward_flops(tcfg, B, L) == JR.forward_flops(jcfg, B, L)
        assert R.decode_flops(tcfg, B, L) == JR.decode_flops(jcfg, B, L)
        assert R.prefill_bytes(tcfg, B, L) == JR.prefill_bytes(jcfg, B, L)
        assert R.decode_bytes(tcfg, B, L) == JR.decode_bytes(jcfg, B, L)
        try:
            jplan = JS.plan_cell(arch, cell, jm)
        except JS.CellSkip:
            continue
        tplan = S.plan_cell(arch, cell, tm)
        assert R.train_bytes(tcfg, tplan, B, L) == JR.train_bytes(jcfg, jplan, B, L)
        assert R.analytic(tplan) == (R.analyze(tplan, None, "16x16").flops,
                                     R.analyze(tplan, None, "16x16").hbm_bytes,
                                     R.analyze(tplan, None, "16x16").model_flops)


# ------------------------------------------------------------ DTensor runs
SMOKE = "qwen3-1.7b:smoke"
# the prefill past the flash threshold (the flash op); train and decode
# shorter (the train step's attention is per shard whichever branch runs)
SEQ = {"train_4k": 256, "prefill_32k": 2304, "decode_32k": 256}


@pytest.fixture
def gloo_mesh():
    import torch.distributed as dist

    mesh = make_debug_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _plain(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_smoke_cells_on_a_1x1_mesh_bit_equal_to_plain(gloo_mesh, cell):
    plan = with_microbatches(S.plan_cell(SMOKE, cell, gloo_mesh, batch=4, seq=SEQ[cell]),
                             4 if cell == "train_4k" else None)
    args = concrete(plan)
    plain_args = copy.deepcopy(args)
    with torch.no_grad() if cell != "train_4k" else torch.enable_grad():
        want = plan.fn(*plain_args)
        placed = plan.place(copy.deepcopy(args))
        with use_rules(plan.rules):
            got = plan.constrain(plan.fn(*placed))
    want_l, got_l = tree_leaves(want), tree_leaves(got)
    assert len(want_l) == len(got_l) > 0
    assert any(type(g).__name__ == "DTensor" for g in got_l)
    for w, g in zip(want_l, got_l):
        assert torch.equal(_plain(g), w)
    if cell == "train_4k":  # params and moments updated in place, both runs
        for w, g in zip(tree_leaves(plain_args[0]), tree_leaves(placed[0])):
            assert torch.equal(_plain(g), w)


XLSTM, SEAMLESS = "xlstm-125m:smoke", "seamless-m4t-large-v2:smoke"
MOE, MAMBA = "granite-moe-3b-a800m:smoke", "jamba-1.5-large-398b:smoke"
SERVE_CELLS = ["train_4k", "prefill_32k", "decode_32k"]


def _check_trace(plan, trace, mesh_name, chips):
    assert trace.collectives["total"] > 0 and sum(trace.collective_counts.values()) > 0
    assert trace.peak_bytes >= trace.arg_bytes == plan.arg_bytes() > 0
    assert trace.flops_per_device > 0 and trace.microbatches_traced == plan.microbatches
    rl = R.analyze(plan, trace, mesh_name)
    assert rl.chips == chips and rl.coll_bytes == trace.collectives["total"]
    assert rl.t_collective > 0 and rl.bottleneck in ("compute", "memory", "collective")


@pytest.mark.parametrize("arch,cell", [pytest.param(SMOKE, c, id=c) for c in SERVE_CELLS] + [
    pytest.param(a, c, id=f"{a}-{c}") for a in (XLSTM, SEAMLESS, MAMBA) for c in SERVE_CELLS])
def test_smoke_cells_trace_on_a_fake_2x2_mesh(fake_mesh, arch, cell):
    """Each cell traces over DTensors: xlstm's train step reaches the mLSTM
    gate's ``log_sigmoid`` backward and its loops run per shard; seamless's
    cross-attention and jamba's SSD scan too."""
    plan = S.plan_cell(arch, cell, fake_mesh, batch=4, seq=SEQ[cell])
    _check_trace(plan, plan.trace(), "2x2", 4)


@pytest.fixture
def fake_mesh_3d():
    import torch.distributed as dist

    mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", [SMOKE, "glm4-9b:smoke", MAMBA])
def test_smoke_train_traces_on_a_fake_2x2x2_mesh(fake_mesh_3d, arch):
    """A train step on a mesh of rank 3, the rank of 2x16x16: DTensor's
    redistribution planner searches a state space that grows with the
    mesh's rank, not its widths."""
    plan = S.plan_cell(arch, "train_4k", fake_mesh_3d, batch=8, seq=SEQ["train_4k"])
    _check_trace(plan, plan.trace(), "2x2x2", 8)


# ------------------------------------------------- a real 2×2 mesh of processes
MESH_CASES = [
    f"{SMOKE}+microbatches=2/train_4k", f"{SMOKE}/prefill_32k", f"{SMOKE}/decode_32k",
    # one KV head: attention splits its q groups and replicates K/V
    f"{SMOKE}+num_kv_heads=1/train_4k", f"{SMOKE}+num_kv_heads=1/prefill_32k",
    f"{MOE}/train_4k", f"{MOE}+seq=256/prefill_32k", f"{MOE}/decode_32k",
    f"{MAMBA}+seq=128/train_4k", f"{MAMBA}+seq=256/prefill_32k", f"{MAMBA}/decode_32k",
    # the xLSTM loops per shard (``local_map``): their grads' placements.
    # The train step in float64: in f32 its plain run is itself off its
    # float64 one by 3.4e-3 in grad norm (``torch_mesh_util``)
    f"{XLSTM}+seq=128+f64/train_4k", f"{XLSTM}+seq=128/prefill_32k",
    # cross-attention per shard, the encoder's output gathered along its sequence
    f"{SEAMLESS}+seq=256/prefill_32k",
]
RTOL = 2e-4  # of a leaf's largest magnitude: f32 sums split over shards


@pytest.fixture(scope="module")
def mesh_2x2_results(tmp_path_factory):
    """One child run of every case on four gloo processes."""
    root = Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("mesh") / "results.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                               if p]))
    subprocess.run([sys.executable, str(root / "tests" / "torch_mesh_util.py"), str(out),
                    *MESH_CASES], check=True, env=env, timeout=600,
                   stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", MESH_CASES)
def test_cells_on_a_2x2_mesh_of_processes_match_plain(mesh_2x2_results, case):
    r = mesh_2x2_results[case]
    assert "error" not in r, r.get("error")
    assert r["sharded_args"] > 0 and r["collectives"] > 0
    if "microbatches=2" in case:
        assert r["microbatches"] == 2
    bad = {k: (err, scale) for k, (err, scale, exact, is_float) in r["errors"].items()
           if not (exact or (is_float and err <= RTOL * scale))}
    assert not bad, bad
    assert any(k.startswith("out/0") for k in r["errors"])
    if "train" in case:  # every updated parameter and moment compared
        assert sum(k.startswith("state/params/") for k in r["errors"]) > 10

"""The port's checkpoints (``repro_torch.train.checkpoint``) and its
end-to-end trainer (``repro_torch.train.e2e``) against the JAX package, on
the CPU.

Checkpoints are bit-exact: a round trip returns the saved bits, the delta
counts and the keys left after garbage collection equal the JAX manager's,
the two packages write the same bytes under the same keys, and a
generation written by either restores in the other (the volume's blocks
copied from one package's ``BlockDevice`` into the other's, then
``OffloadDB.recover``). The trainer's crash, recover and resume give
losses bit-equal to an uninterrupted run, and within 1e-4 (f32 on both
sides, summation order only) of the same flow run through the JAX API.
Inputs are made with numpy from a seed.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockDevice as JBlockDevice
from repro.core import OffloadFS as JOffloadFS
from repro.core.lsm import DBConfig as JDBConfig
from repro.core.lsm import OffloadDB as JOffloadDB
from repro.data.pipeline import PipelineState as JPipelineState
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.train import optim as jopt
from repro.train import step as jstep
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.core import BlockDevice, OffloadFS
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.train import e2e
from repro_torch.train.checkpoint import CHUNK, CheckpointManager
from repro_torch.tree import tree_flatten_with_path, tree_map

TOL = 1e-4
BLOCKS = 1 << 15
MEMTABLE = 1 << 16  # small, so that saves flush and compact


def _arrays(seed, bump=0.0):
    """A train-state-shaped tree of numpy arrays; ``big`` spans two CHUNKs."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"embed": f(16, 8), "big": f(300, 200) + np.float32(bump),
              "stack": {"unroll": ({"w": f(8, 8)}, {"w": f(8, 8) + np.float32(bump)})}}
    assert params["big"].nbytes > CHUNK
    m = jax.tree.map(lambda a: a * np.float32(0.1), params)
    return {"params": params, "opt": {"m": m, "v": jax.tree.map(np.square, m)},
            "step": np.asarray(int(bump * 10), np.int32)}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _state(seed, bump, pipe):
    a = _arrays(seed, bump)
    return {"train": _jax_tree(a), "pipe": pipe}, {"train": _port_tree(a), "pipe": pipe}


def _dbs():
    jdev, pdev = JBlockDevice(BLOCKS), BlockDevice(BLOCKS)
    jdb = JOffloadDB(JOffloadFS(jdev), None, JDBConfig(memtable_bytes=MEMTABLE))
    pdb = OffloadDB(OffloadFS(pdev), None, DBConfig(memtable_bytes=MEMTABLE), device="cpu")
    return (jdev, jdb), (pdev, pdb)


def _assert_equal_trees(got, want_numpy):
    g = tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want_numpy)[0]
    assert len(g) == len(w)
    for (path, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_port_round_trip_is_bit_exact_on_likes_dtype():
    _, (_, pdb) = _dbs()
    mgr = CheckpointManager(pdb)
    _, state = _state(0, 0.5, json.dumps({"cursor": 3}))
    assert mgr.save(state, 7) == {"written": 14, "skipped": 0}
    like = tree_map(torch.zeros_like, state["train"])
    got = mgr.restore({"train": like, "pipe": "x"})
    assert got["pipe"] == state["pipe"] and mgr.latest_step() == 7
    for (path, a), (_, b) in zip(tree_flatten_with_path(got["train"]),
                                 tree_flatten_with_path(state["train"])):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    # a like in another dtype gets that dtype
    like64 = tree_map(lambda t: t.double(), like)
    got64 = mgr.restore({"train": like64, "pipe": "x"}, 7)["train"]
    assert got64["params"]["big"].dtype == torch.float64
    assert torch.equal(got64["params"]["big"], state["train"]["params"]["big"].double())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(_dbs()[1][1]).restore({"train": like, "pipe": "x"})


def test_delta_counts_gc_and_bytes_match_jax():
    """Four generations, keep 2: each save's written/skipped counts, then
    every (key, value) row left in the DB, equal the JAX manager's."""
    (_, jdb), (_, pdb) = _dbs()
    jm, pm = JCheckpointManager(jdb, keep=2), CheckpointManager(pdb, keep=2)
    for i, (bump, pipe) in enumerate([(0.0, "a"), (0.0, "a"), (0.25, "b"), (0.5, "b")]):
        js, ps = _state(1, bump, pipe)
        assert pm.save(ps, 4 * (i + 1)) == jm.save(js, 4 * (i + 1))
    rows_j, rows_p = jdb.scan(b"", 1 << 20), pdb.scan(b"", 1 << 20)
    assert [k for k, _ in rows_p] == [k for k, _ in rows_j]
    assert rows_p == rows_j
    gens = sorted({k.split(b"/")[1] for k, _ in rows_p if k.startswith(b"ckptidx/")})
    assert gens == [b"000000000012", b"000000000016"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generation_restores_across_packages(writer):
    """A generation written through one package's OffloadDB restores,
    bit for bit, through the other's after its blocks are copied over and
    the DB is recovered."""
    (jdev, jdb), (pdev, pdb) = _dbs()
    js, ps = _state(2, 0.75, json.dumps({"epoch": 1, "cursor": 5}))
    want = jax.device_get(js["train"])
    if writer == "jax":
        mgr, db, fs_dev, dst = JCheckpointManager(jdb), jdb, jdev, pdev
        mgr.save(js, 3)
    else:
        mgr, db, fs_dev, dst = CheckpointManager(pdb), pdb, pdev, jdev
        mgr.save(ps, 3)
    db.flush_all()
    db.fs.flush_metadata()
    dst._blocks = dict(fs_dev._blocks)
    if writer == "jax":
        db2 = OffloadDB.recover(OffloadFS.mount(dst), None,
                                DBConfig(memtable_bytes=MEMTABLE), device="cpu")
        like = {"train": tree_map(torch.zeros_like, ps["train"]), "pipe": "x"}
        got = CheckpointManager(db2).restore(like)
    else:
        db2 = JOffloadDB.recover(JOffloadFS.mount(dst), None,
                                 JDBConfig(memtable_bytes=MEMTABLE))
        like = {"train": jax.tree.map(jnp.zeros_like, js["train"]), "pipe": "x"}
        got = JCheckpointManager(db2).restore(like)
        got = {"train": jax.device_get(got["train"]), "pipe": got["pipe"]}
    assert got["pipe"] == js["pipe"]
    _assert_equal_trees(got["train"], want)


# ------------------------------------------------------------- the trainer
def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_e2e_example", Path(__file__).resolve().parent.parent / "examples/train_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_flow(jcfg, params, *, steps, ckpt_every, kill_at, batch, seq):
    """``examples/train_e2e.py``'s loop through the JAX API (tokens ingest),
    from ``params``: [step, loss] in the order run, and the restored step."""
    ex = _jax_example()
    model = jax_model(jcfg)
    dev = JBlockDevice(num_blocks=1 << 19)
    fs, _, off, _ = ex.build_io_plane(dev)
    mgr = JCheckpointManager(JOffloadDB(fs, off, JDBConfig(memtable_bytes=1 << 20)), keep=2)
    opt = jopt.adamw(lr=3e-4, schedule=jopt.cosine_schedule(20, steps))
    step_fn = jax.jit(jstep.make_train_step(model, opt))
    losses = []

    def run_until(state, pipe, stop, mgr):
        while int(state["step"]) < stop:
            b = {k: jnp.asarray(v) for k, v in pipe.next_batch().items()}
            state, m = step_fn(state, b)
            s = int(state["step"])
            losses.append([s, float(m["loss"])])
            if s % ckpt_every == 0:
                mgr.save({"train": state, "pipe": pipe.state.to_json()}, s)
        return state

    run_until(jstep.init_state(model, opt, params=params),
              JTokenPipeline(jcfg.vocab_size, batch, seq), kill_at, mgr)
    fs, _, off, _ = ex.build_io_plane(dev)
    mgr = JCheckpointManager(JOffloadDB.recover(fs, off), keep=2)
    like = {"train": jstep.init_state(model, opt, params=params), "pipe": "x" * 64}
    restored = mgr.restore(like, mgr.latest_step())
    pipe = JTokenPipeline(jcfg.vocab_size, batch, seq,
                          state=JPipelineState.from_json(str(restored["pipe"])))
    state = restored["train"]
    rs = int(state["step"])
    run_until(state, pipe, steps, mgr)
    return losses, rs


def test_e2e_crash_resume_is_exact_and_matches_jax():
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
              vocab_size=256)
    jcfg = jax_config("paper-lm-100m").with_(compute_dtype=jnp.float32, **kw)
    tcfg = get_config("paper-lm-100m").with_(compute_dtype=torch.float32, **kw)
    jp = jax.jit(jax_model(jcfg).init)(jax.random.key(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    flow = dict(steps=12, batch=8, seq=64)
    run = dict(device="cpu", cfg=tcfg, params=tp, log=lambda *a: None, **flow)
    crash = e2e.run(ckpt_every=4, kill_at=8, **run)
    whole = e2e.run(ckpt_every=0, kill_at=12, **run)
    assert crash["memtable_bytes"] == 1 << 20  # the JAX example's DB config
    rs = crash["restored_step"]
    # the newest generation's index sits in the WAL's unflushed tail at the
    # crash, so the generation before it comes back, as in the JAX package
    assert rs == 4 and [s for s, _ in crash["losses"]] == list(range(1, 9)) + \
        list(range(5, 13))
    assert dict(crash["losses"]) == dict(whole["losses"])  # bit for bit
    assert crash["restored_pipe"] == dict(crash["saved_pipe"])[rs]
    assert json.loads(crash["restored_pipe"])["step"] == rs
    assert [c["step"] for c in crash["checkpoints"]] == [4, 8, 8, 12]
    want, jrs = _jax_flow(jcfg, jp, ckpt_every=4, kill_at=8, **flow)
    assert jrs == rs and [s for s, _ in want] == [s for s, _ in crash["losses"]]
    np.testing.assert_allclose([x for _, x in crash["losses"]], [x for _, x in want],
                               atol=TOL, rtol=TOL)

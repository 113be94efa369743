"""End-to-end trainer (port of ``examples/train_e2e.py``): trains
``paper-lm-100m`` on the card with the full I/O plane engaged.

  * a deterministic, resumable ``TokenPipeline`` feeds the batches, or,
    with ``--ingest prep``, the streaming ``PrepPipeline``: each
    minibatch's preprocessing fans out to the storage engine through the
    offload plane (the local share runs on the card in one
    ``preprocess_batch`` launch), and a deterministic patch tokenizer
    chains the prep output into the LM's token plane;
  * every ``--ckpt-every`` steps the train state checkpoints into OffloadDB
    on a disaggregated volume (delta checkpoints; flush and compaction run
    on the storage engine), with the ingestion state in the same
    generation;
  * at ``--kill-at`` the run simulates a crash (drops all host state),
    remounts the volume, recovers the DB, restores the latest generation
    and finishes, resuming the ingestion at the saved cursor.

    python -m repro_torch.train.e2e --steps 200
    python -m repro_torch.train.e2e --steps 60 --small --ingest prep --device cpu

``run`` is the same flow as a function: it returns the per-step losses,
the restored step and the ingestion state saved and restored, with the
step, checkpoint and restore times.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.data.ingest import IngestState, PrepPipeline, tokens_from_batch
from repro_torch.data.offload_prep import OffloadPrep, stub_preprocess
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.train import optim
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

# 8 GiB of 4 KiB blocks: paper-lm-100m's checkpoint generation (params, m
# and v in f32) is 1.007 GB, and two live generations, the one being
# written and the LSM's WAL and compaction outputs must fit; the JAX
# example's 2 GiB holds its --small model's only.
VOLUME_BLOCKS = 1 << 21


def checkpoint_plane(memtable_mib: int):
    """(OffloadDB config, engine cache blocks) for large checkpoint
    generations, from one memtable size: tables of half a memtable, a base
    level of four, and 8,192 cache blocks per MiB of memtable, four times
    the blocks an L0→L1 compaction pins (four L0 tables and a full L1), so
    that the cache's LRU scan never goes quadratic (ROADMAP Queue 3)."""
    mem = memtable_mib << 20
    return (DBConfig(memtable_bytes=mem, sstable_target_bytes=mem // 2,
                     base_level_bytes=4 * mem), 8192 * memtable_mib)


# The JAX example's plane (1 MiB memtables, an 8,192-block cache), for
# generations up to LARGE_GENERATION_BYTES: --small's and the tests'.
EXAMPLE_PLANE = (DBConfig(memtable_bytes=1 << 20), 8192)
LARGE_GENERATION_BYTES = 1 << 28
# Larger generations (paper-lm-100m at full width: 1,007 MB): the fastest
# of 8, 32 and 128 MiB memtables by `scripts/bench_checkpoint.py` on an
# H100 host (PERF.md, PR 15).
FULL_WIDTH_MEMTABLE_MIB = 32
FULL_WIDTH_PLANE = checkpoint_plane(FULL_WIDTH_MEMTABLE_MIB)


def build_io_plane(dev, cache_blocks: int = 8192):
    fs = OffloadFS(dev, node="trainer0") if dev.used_blocks == 0 \
        else OffloadFS.mount(dev, node="trainer0")
    fabric = RpcFabric()
    engine = OffloadEngine(fs, node="storage0", cache_blocks=cache_blocks)
    engine.register_stub("compact", C.stub_compact)
    engine.register_stub("log_recycle", C.stub_log_recycle)
    engine.register_stub("preprocess", stub_preprocess)
    serve_engine(engine, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="trainer0")
    return fs, engine, off, fabric


class PrepIngest:
    """The prep→train chain: PrepPipeline minibatches → patch tokens.
    Mirrors TokenPipeline's interface (next_batch / state) so the trainer
    loop is ingestion-agnostic."""

    N_IMAGES = 96
    OUT_SIZE = 32

    def __init__(self, fs, off, cfg, batch, seq, steps, *,
                 state: IngestState = None, device="cuda"):
        if batch > self.N_IMAGES:
            raise ValueError(
                f"--batch {batch} exceeds the ingest corpus "
                f"({self.N_IMAGES} images)")
        self.vocab, self.seq = cfg.vocab_size, seq
        self.prep = OffloadPrep(fs, off, out_size=self.OUT_SIZE,
                                offload_ratio=1 / 3, device=device)
        prefix = "/ingest_corpus"
        if fs.exists(f"{prefix}/{0:08d}.raw"):  # re-mounted volume
            self.paths = [p for p in fs.listdir(prefix + "/")]
        else:
            self.paths = self.prep.materialize_corpus(
                self.N_IMAGES, prefix=prefix, max_side=128)
        # enough WHOLE batches for every step: the pipeline drops the
        # ragged tail, so epochs derive from floor(images/batch), not the
        # image count
        batches_per_epoch = self.N_IMAGES // batch
        epochs = -(-steps // batches_per_epoch) + 1
        if state is not None:
            # the resumed run may need MORE epochs than the checkpoint
            # recorded (e.g. --steps grew); batch must match the
            # checkpoint and is validated by the pipeline
            state.epochs = max(state.epochs, epochs)
            self.pipe = PrepPipeline(self.prep, sorted(self.paths),
                                     batch=batch, state=state)
        else:
            self.pipe = PrepPipeline(self.prep, sorted(self.paths),
                                     batch=batch, epochs=epochs, seed=17)
        self._it = iter(self.pipe)

    @property
    def state(self):
        return self.pipe.state

    def next_batch(self):
        return tokens_from_batch(next(self._it), self.vocab, self.seq)

    def close(self):
        self.pipe.close()


def small_config(cfg):
    """``--small``: the 4-layer, d_model 256 shrink for fast demo runs."""
    return cfg.with_(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
                     d_ff=1024, vocab_size=8192)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(*, steps=200, batch=8, seq=128, ckpt_every=25, kill_at=60,
        arch="paper-lm-100m", small=False, ingest="tokens", device="cuda",
        cfg=None, params=None, plane=None, log=print) -> dict:
    """Train ``steps`` steps, checkpointing every ``ckpt_every`` (0: never)
    and crashing after step ``kill_at`` when it is below ``steps``.

    ``cfg`` overrides ``arch`` (and ``small``); ``params`` (copied, never
    written) replaces the seed-0 init; ``plane`` (a DB config and cache
    blocks) replaces the one picked by the generation's size. Returns a dict: ``losses`` as
    [step, loss] in the order run, ``step_ms``, ``checkpoints`` (step,
    written, skipped, ms), ``restored_step``, ``restore_ms``,
    ``saved_pipe`` ([step, the ingestion state's JSON saved with it]),
    ``restored_pipe``, each DB incarnation's stats, the RPC bytes, the
    prep statistics and the final ``state``."""
    if cfg is None:
        cfg = get_config(arch)
        if small:
            cfg = small_config(cfg)
    model = build_model(cfg)
    log(f"arch={cfg.name} params={model.n_params()/1e6:.1f}M device={device}")

    opt = optim.adamw(lr=3e-4, schedule=optim.cosine_schedule(20, steps))

    def seeded():
        return torch.Generator(device).manual_seed(0)

    state = init_state(model, opt, seeded() if params is None else None,
                       None if params is None else tree_map(torch.clone, params))
    if plane is None:
        gen_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
        plane = FULL_WIDTH_PLANE if gen_bytes > LARGE_GENERATION_BYTES else EXAMPLE_PLANE
    db_cfg, cache_blocks = plane
    dev = BlockDevice(num_blocks=VOLUME_BLOCKS)
    fs, engine, off, fabric = build_io_plane(dev, cache_blocks)
    db = OffloadDB(fs, off, db_cfg, device=device)
    mgr = CheckpointManager(db, keep=2)

    def new_pipe(saved=None):
        if ingest == "prep":
            return PrepIngest(fs, off, cfg, batch, seq, steps, device=device,
                              state=None if saved is None else IngestState.from_json(saved))
        return TokenPipeline(cfg.vocab_size, batch, seq,
                             state=None if saved is None else PipelineState.from_json(saved))

    pipe = new_pipe()
    step_fn = make_train_step(model, opt)
    out = {"arch": cfg.name, "n_params": model.n_params(), "losses": [], "step_ms": [],
           "memtable_bytes": db_cfg.memtable_bytes, "cache_blocks": cache_blocks,
           "checkpoints": [], "saved_pipe": [], "restored_step": None,
           "restored_pipe": None, "restore_ms": None, "db_stats": [], "rpc_bytes": 0,
           "prep_stats": []}

    def run_until(state, stop):
        t_run = time.perf_counter()
        while int(state["step"]) < stop:
            batch_ = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in pipe.next_batch().items()}
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_)
            loss = float(metrics["loss"])
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            s = int(state["step"])
            out["losses"].append([s, loss])
            if s % 10 == 0 or s == stop:
                log(f"step {s:4d} loss {loss:.4f} ({time.perf_counter() - t_run:.1f}s)")
            if ckpt_every and s % ckpt_every == 0:
                saved = pipe.state.to_json()
                t0 = time.perf_counter()
                r = mgr.save({"train": state, "pipe": saved}, s)
                out["checkpoints"].append({"step": s, **r,
                                           "ms": (time.perf_counter() - t0) * 1e3})
                out["saved_pipe"].append([s, saved])
                log(f"  ckpt@{s}: wrote {r['written']} leaves, "
                    f"skipped {r['skipped']} (delta)")
        return state

    def retire():
        """Fold the dying incarnation's counters into ``out``."""
        out["db_stats"].append(dict(db.stats))
        out["rpc_bytes"] += fabric.total_bytes()
        if ingest == "prep":
            out["prep_stats"].append(dict(pipe.prep.stats))
            pipe.close()  # the dead trainer's producer thread dies with it

    state = run_until(state, min(kill_at, steps))

    if kill_at < steps:
        log(f"\n*** simulated crash at step {kill_at}: dropping all host state; "
            "re-mounting the volume ***\n")
        retire()
        del state
        fs, engine, off, fabric = build_io_plane(dev, cache_blocks)
        _sync(device)
        t0 = time.perf_counter()
        db = OffloadDB.recover(fs, off, cfg=db_cfg, device=device)
        mgr = CheckpointManager(db, keep=2)
        like = {"train": init_state(model, opt, seeded()), "pipe": "x" * 64}
        latest = mgr.latest_step()
        if latest is None:
            raise FileNotFoundError("the crash left no checkpoint to restore")
        restored = mgr.restore(like, latest)
        _sync(device)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        state = restored["train"]
        out["restored_step"] = int(state["step"])
        out["restored_pipe"] = str(restored["pipe"])
        ing = json.loads(out["restored_pipe"])
        if ingest == "prep":
            ing["inflight"] = []  # abandoned by the crash; re-issued from cursor
            log(f"ingest resumed at epoch {ing['epoch']} cursor {ing['cursor']}")
        pipe = new_pipe(json.dumps(ing))
        log(f"restored at step {out['restored_step']}; resuming")
        state = run_until(state, steps)

    retire()
    out["state"] = state
    log(f"\ndone at step {int(state['step'])}; I/O plane: "
        f"flushes={sum(s['flushes'] for s in out['db_stats'])} "
        f"compactions={sum(s['compactions'] for s in out['db_stats'])} "
        f"offloaded_to={engine.node} rpc={out['rpc_bytes'] / 1e6:.2f}MB")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--kill-at", type=int, default=60)
    ap.add_argument("--arch", default="paper-lm-100m")
    ap.add_argument("--small", action="store_true",
                    help="shrink the model for very fast demo runs")
    ap.add_argument("--ingest", choices=("tokens", "prep"), default="tokens",
                    help="tokens: synthetic TokenPipeline; prep: streaming "
                         "PrepPipeline (offloaded preprocessing chained "
                         "into the token plane)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_every=args.ckpt_every,
        kill_at=args.kill_at, arch=args.arch, small=args.small, ingest=args.ingest,
        device=args.device)


if __name__ == "__main__":
    main()

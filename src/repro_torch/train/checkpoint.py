"""Checkpointing through OffloadDB (port of ``src/repro/train/checkpoint.py``):
the trainer's fault tolerance rests on the paper's technique.

Model, optimizer and data-iterator state are written as KV pairs into an
LSM on the disaggregated volume; flush and compaction of checkpoint
generations run on the storage node through OffloadFS. Leaves whose bytes
are unchanged since the previous generation are not rewritten (delta
checkpointing); generations beyond ``keep`` are deleted and compaction
reclaims them.

The format on the volume is the JAX package's, byte for byte: keys
``ckpt/{step:012d}/{path}/{chunk:05d}`` holding ``np.save`` blobs cut into
``CHUNK``-byte values, one JSON index ``ckptidx/{step:012d}`` per
generation, and ``ckpt_latest``. Paths join dict keys and sequence
indices with "/", and leaves go in ``jax.tree_util``'s order (sorted dict
keys), so a checkpoint written by either package restores in the other.
A tensor leaf makes one device-to-host copy on save and one
host-to-device copy on restore.
"""
from __future__ import annotations

import hashlib
import io as _io
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lsm.db import OffloadDB
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

CHUNK = 200_000  # bytes per KV value: large leaves split across records
# (must stay below DBConfig.sstable_target_bytes so tables can always split)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype to save as")
        x = x.detach().cpu().numpy()
    buf = _io.BytesIO()
    np.save(buf, np.asarray(x), allow_pickle=False)
    return buf.getvalue()


class CheckpointManager:
    def __init__(self, db: OffloadDB, *, keep: int = 2):
        self.db = db
        self.keep = keep
        self._hashes: Dict[str, Tuple[list, str]] = {}  # leaf -> ([gen, n], sha)

    def _put_blob(self, name: str, blob: bytes) -> int:
        n = max(1, -(-len(blob) // CHUNK))
        for ci in range(n):
            self.db.put(f"{name}/{ci:05d}".encode(), blob[ci * CHUNK:(ci + 1) * CHUNK])
        return n

    def _get_blob(self, name: str, n_chunks: int) -> bytes:
        return b"".join(self.db.get(f"{name}/{ci:05d}".encode()) for ci in range(n_chunks))

    def save(self, state: Any, step: int) -> Dict[str, int]:
        """Write a checkpoint generation; returns {written, skipped}."""
        written = skipped = 0
        index = {}
        for path, leaf in tree_flatten_with_path(state):
            key = _path_str(path)
            blob = _leaf_bytes(leaf)
            sha = hashlib.sha1(blob).hexdigest()
            prev = self._hashes.get(key)
            if prev is not None and prev[1] == sha:
                index[key] = prev[0]  # unchanged: [old gen, n_chunks]
                skipped += 1
                continue
            n = self._put_blob(f"ckpt/{step:012d}/{key}", blob)
            self._hashes[key] = ([step, n], sha)
            index[key] = [step, n]
            written += 1
        self.db.put(f"ckptidx/{step:012d}".encode(), json.dumps(index).encode())
        self.db.put(b"ckpt_latest", str(step).encode())
        self._gc(step)
        return {"written": written, "skipped": skipped}

    def _gc(self, current: int) -> None:
        steps = sorted(
            int(k.decode().split("/")[1])
            for k, _ in self.db.scan(b"ckptidx/", 1 << 20)
            if k.startswith(b"ckptidx/")
        )
        live = set(steps[-self.keep:]) | {current}
        referenced = set()  # leaves referenced by live indexes survive
        for s in live:
            raw = self.db.get(f"ckptidx/{s:012d}".encode())
            if raw:
                for key, (gen, n) in json.loads(raw.decode()).items():
                    referenced.add(f"ckpt/{gen:012d}/{key}")
        for s in steps:
            if s in live:
                continue
            raw = self.db.get(f"ckptidx/{s:012d}".encode())
            if not raw:
                continue
            for key, (gen, n) in json.loads(raw.decode()).items():
                name = f"ckpt/{gen:012d}/{key}"
                if name not in referenced:
                    for ci in range(n):
                        self.db.delete(f"{name}/{ci:05d}".encode())
            self.db.delete(f"ckptidx/{s:012d}".encode())

    def latest_step(self) -> Optional[int]:
        raw = self.db.get(b"ckpt_latest")
        return int(raw.decode()) if raw else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """The generation ``step`` (the latest when None) in ``like``'s
        structure: a tensor leaf comes back on ``like``'s device, in its
        dtype and shape; any other leaf (a JSON string of iterator state)
        as the Python value saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint")
        index = json.loads(self.db.get(f"ckptidx/{step:012d}".encode()).decode())

        def leaf(path, like_leaf):
            key = _path_str(path)
            gen, n = index[key]
            arr = np.load(_io.BytesIO(self._get_blob(f"ckpt/{gen:012d}/{key}", n)),
                          allow_pickle=False)
            if isinstance(like_leaf, torch.Tensor):
                return torch.from_numpy(arr).reshape(like_leaf.shape).to(
                    device=like_leaf.device, dtype=like_leaf.dtype)
            return arr.item() if arr.shape == () else arr

        return tree_map_with_path(leaf, like)

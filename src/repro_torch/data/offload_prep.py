# Copied from src/repro/data/offload_prep.py; the repro. imports are rewritten,
# and the initiator's share runs on a torch device through the port's kernel.
"""OffloadPrep (paper §V): offload minibatch image preprocessing to the
storage node and/or peer initiators through OffloadFS — no scheduler, just
the FS's admission control. The dataset lives as image files on the
disaggregated volume; the initiator partitions each minibatch into a local
share and offloaded shares; the offloaded stub reads image blocks on the
target (near-data), preprocesses there, and returns only the (small)
normalized tensors.

In the port the storage node's stub stays numpy (storage nodes have no
GPU), and the initiator's share — its local images and any share that a
target pushes back — runs on ``device``: the host decodes and crops, the
unflipped uint8 crops of the whole share go to the device in one copy
(``preprocess.pack_crops``), and one ``ops.preprocess_batch`` launch
resizes, flips and normalises each into its slot of the batch. Both give
the same float64 bits, so a batch does not depend on where a share ran.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fs import OffloadFS
from repro_torch.core.offloader import TaskOffloader
from repro_torch.data.preprocess import (decode_image, encode_image, preprocess_image,
                                         random_crop_params, synthetic_image)
from repro_torch.kernels import ops
from repro_torch.kernels.preprocess import pack_crops


def stub_preprocess(io, images: List[dict], out_size: int) -> List[np.ndarray]:
    """Target-side stub: images = [{"runs", "size", "seed"}]."""
    out = []
    for im in images:
        buf = b"".join(io.offload_read(b, n) for b, n in im["runs"])[: im["size"]]
        out.append(preprocess_image(buf, im["seed"], out_size))
    return out


class OffloadPrep:
    def __init__(self, fs: OffloadFS, offloader: Optional[TaskOffloader],
                 *, out_size: int = 224, offload_ratio: float = 1 / 3,
                 targets: Optional[Sequence[str]] = None, device="cuda"):
        self.fs = fs
        self.off = offloader
        self.out_size = out_size
        self.offload_ratio = offload_ratio
        self.device = torch.device(device)
        # None → follow the offloader's LIVE target registry (shards/peers
        # added later via add_target get prep shares too)
        self._targets = list(targets) if targets is not None else None
        if offloader is not None:
            # a share pushed back to the initiator runs on the device too
            offloader.register_local_stub("preprocess", self._stub_on_device)
        # DISJOINT outcome counters — every image lands in exactly one, so
        # sum(stats.values()) == images processed:
        #   local     — planned for the initiator (never submitted)
        #   offloaded — ran on its planned remote target
        #   rerouted  — pushed back by the planned target, ran on another
        #   rejected  — pushed back and fell back to the initiator
        self.stats = {"local": 0, "offloaded": 0, "rejected": 0, "rerouted": 0}

    @property
    def targets(self) -> List[str]:
        if self._targets is not None:
            return self._targets
        return list(self.off.targets) if self.off else ["storage0"]

    # ------------------------------------------------------------ dataset
    def materialize_corpus(self, n_images: int, prefix: str = "/img",
                           seed: int = 0, max_side: int = 512) -> List[str]:
        paths = []
        for i in range(n_images):
            img = synthetic_image(seed * 100003 + i, max_side=max_side)
            p = f"{prefix}/{i:08d}.raw"
            self.fs.create(p)
            self.fs.write(p, encode_image(img), 0)
            paths.append(p)
        return paths

    # ---------------------------------------------------------- minibatch
    @staticmethod
    def _image_seed(epoch_seed: int, i: int) -> int:
        """Per-image augmentation seed, folded into RandomState's 32-bit
        domain (large epoch seeds — e.g. the PrepPipeline's per-batch
        seeds — must not overflow it). Values small callers pass are
        unchanged by the mod."""
        return (epoch_seed * 1000003 + i) % (2**31 - 1)

    def _image_arg(self, path: str, seed: int) -> Tuple[dict, list]:
        ino = self.fs.stat(path)
        return (
            {
                "runs": [(e.block, e.nblocks) for e in ino.extents],
                "size": ino.size,
                "seed": seed,
            },
            ino.extents,
        )

    def plan_shares(self, n: int) -> Tuple[List[Tuple[str, List[int]]],
                                           List[int]]:
        """Partition minibatch indices [0, n): ``offload_ratio × n`` images
        per remote target, the rest local. Returns (remote_shares,
        local_ids) where remote_shares is [(target, ids)]."""
        per_target = int(n * self.offload_ratio)
        remote: List[Tuple[str, List[int]]] = []
        idx = 0
        if self.off is not None and per_target > 0:
            for t in self.targets:
                ids = list(range(idx, min(idx + per_target, n)))
                if ids:
                    remote.append((t, ids))
                idx += per_target
        return remote, list(range(idx, n))

    def share_spec(self, target: str, ids: Sequence[int],
                   paths: Sequence[str], *, epoch_seed: int = 0,
                   reroute: bool = False) -> dict:
        """A ``TaskOffloader.submit_many`` spec for one remote share."""
        args, extents = [], []
        for i in ids:
            a, e = self._image_arg(paths[i], self._image_seed(epoch_seed, i))
            args.append(a)
            extents.extend(e)
        return {
            "task": "preprocess", "args": (args, self.out_size),
            "read_extents": extents, "write_extents": [],
            "target": target, "reroute": reroute,
            "mtime": max(self.fs.stat(paths[i]).mtime for i in ids),
        }

    def new_batch(self, n: int) -> torch.Tensor:
        """An uninitialised (n, out, out, 3) float64 batch on the device."""
        return torch.empty((n, self.out_size, self.out_size, 3), dtype=torch.float64,
                           device=self.device)

    def _preprocess_into(self, images, batch: torch.Tensor) -> None:
        """Preprocess ``images``, (encoded image, seed, slot) triples, into
        their slots of ``batch`` (n, out, out, C). For each, decode on the
        host and draw the crop and the flip from ``RandomState(seed)`` in
        ``preprocess_image``'s order; then send the unflipped uint8 crops
        to the device in one copy and launch once."""
        crops, flips, slots = [], [], []
        for buf, seed, slot in images:
            img = decode_image(buf)
            rng = np.random.RandomState(seed)
            y, x, ch, cw = random_crop_params(rng, img.shape[0], img.shape[1])
            flips.append(bool(rng.rand() < 0.5))
            crops.append(img[y : y + ch, x : x + cw])
            slots.append(slot)
        if crops:
            packed, desc = pack_crops(crops, flips, slots, self.device)
            ops.preprocess_batch(packed, desc, batch)

    def _stub_on_device(self, io, images: List[dict], out_size: int) -> torch.Tensor:
        """``stub_preprocess`` for a share that ran on the initiator: the
        same blocks, preprocessed on the device."""
        out = self.new_batch(len(images))
        self._preprocess_into(
            [(b"".join(io.offload_read(b, n) for b, n in im["runs"])[: im["size"]],
              im["seed"], slot) for slot, im in enumerate(images)], out)
        return out

    def local_images(self, paths: Sequence[str], ids: Sequence[int],
                     batch: torch.Tensor, *, epoch_seed: int = 0) -> None:
        """Preprocess the local share on the device into ``batch[i]`` for
        each i in ``ids`` (counted ``local``)."""
        self._preprocess_into([(self.fs.read(paths[i]), self._image_seed(epoch_seed, i), i)
                               for i in ids], batch)
        self.stats["local"] += len(ids)

    def fill_share(self, batch: torch.Tensor, ids: Sequence[int], tensors) -> None:
        """Copy a remote share's images (numpy from a storage node, or
        device tensors from the initiator's fallback) into their slots; a
        storage node's images go to a CUDA device in one asynchronous copy
        from pinned memory (see ``preprocess.pack_crops``)."""
        if isinstance(tensors, torch.Tensor):
            batch[ids] = tensors
            return
        host = torch.empty((len(tensors), *tensors[0].shape), dtype=torch.float64,
                           pin_memory=batch.is_cuda)
        np.stack(tensors, out=host.numpy())
        batch[ids] = host.to(batch.device, non_blocking=True)

    def note_remote_outcome(self, n: int, planned: str, ran: str) -> None:
        """Fold a remote share's resolution into the disjoint counters."""
        if self.off is not None and ran == self.off.node:
            self.stats["rejected"] += n
        elif ran != planned:
            self.stats["rerouted"] += n
        else:
            self.stats["offloaded"] += n

    def preprocess_minibatch(self, paths: Sequence[str], *, epoch_seed: int = 0
                             ) -> torch.Tensor:
        """Split the minibatch: offload_ratio × len(paths) images per remote
        target, the rest locally. Returns (N, out, out, 3) float64 on the
        device."""
        n = len(paths)
        remote, local_ids = self.plan_shares(n)
        batch = self.new_batch(n)
        # remote shares: one submit round — one wire batch per target,
        # targets served concurrently (instead of serial per-target calls)
        specs = [self.share_spec(t, ids, paths, epoch_seed=epoch_seed)
                 for t, ids in remote]
        if specs:
            for (target, ids), (tensors, where) in zip(
                    remote, self.off.submit(specs)):
                self.note_remote_outcome(len(ids), target, where)
                self.fill_share(batch, ids, tensors)
        self.local_images(paths, local_ids, batch, epoch_seed=epoch_seed)
        return batch

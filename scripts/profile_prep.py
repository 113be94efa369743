#!/usr/bin/env python3
"""Where the device time goes on the port's prep path, on one GPU.

    python3 scripts/profile_prep.py

Builds the prep path as ``chip_smoke.py``'s ``prep`` phase does (its
``_prep_plane``: a volume behind one storage engine serving the numpy
stub; 256 images of the synthetic corpus, sides 64 to 512; ``OffloadPrep``
with out 224 and a third offloaded) on the card, warms up one minibatch,
then traces with ``torch.profiler`` one synchronous
``preprocess_minibatch`` of 256 images: 85 on the engine, 171 on the card.
It prints one JSON line as ``scripts/profile_serving.py`` does: host wall
time, device busy time, the device's idle share, the kernel launches, and
the kernels and copies that took the most device time. The trace adds host
overhead. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the prep path's plane and shapes)
from scripts.profile_serving import trace  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_prep needs a CUDA device; none is available")
    from repro_torch.data import OffloadPrep

    _, fs, _, off = chip_smoke._prep_plane()
    prep = OffloadPrep(fs, off, out_size=chip_smoke.PREP_OUT, offload_ratio=1 / 3)
    paths = prep.materialize_corpus(chip_smoke.PREP_BATCH, max_side=512)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    prep.preprocess_minibatch(paths, epoch_seed=1)  # warm-up
    trace("prep_minibatch", lambda: prep.preprocess_minibatch(paths, epoch_seed=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

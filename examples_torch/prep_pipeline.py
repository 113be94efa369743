# Port of examples/prep_pipeline.py on repro_torch; OffloadPrep takes --device.
"""OffloadPrep demo: image preprocessing split between the training host,
the storage node and a peer node, governed by admission control.

    PYTHONPATH=src python examples_torch/prep_pipeline.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.core import BlockDevice, OffloadFS, RpcFabric, TokenRing
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.data.offload_prep import OffloadPrep, stub_preprocess


def pick_device(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    dev = ap.parse_args(argv).device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {dev}: no CUDA card here (pass --device cpu)")
    return dev


def main(argv=None):
    torch_dev = pick_device(argv)
    dev = BlockDevice(num_blocks=1 << 18)
    fs = OffloadFS(dev, node="trainer0")
    fabric = RpcFabric()

    storage = OffloadEngine(fs, node="storage0", cache_blocks=4096)
    storage.register_stub("preprocess", stub_preprocess)
    peer = OffloadEngine(fs, node="peer1", cache_blocks=1024)
    peer.register_stub("preprocess", stub_preprocess)
    # the storage node protects itself with a token ring; the peer accepts all
    serve_engine(storage, fabric, TokenRing(n_tokens=2, ttl=1.0))
    from repro_torch.core.admission import AcceptAll

    serve_engine(peer, fabric, AcceptAll())

    off = TaskOffloader(fs, fabric, node="trainer0")
    prep = OffloadPrep(fs, off, out_size=64, offload_ratio=1 / 3,
                       targets=("storage0", "peer1"), device=torch_dev)
    paths = prep.materialize_corpus(64, max_side=192)
    print(f"corpus: {len(paths)} images on the disaggregated volume")

    t0 = time.time()
    for epoch in range(2):
        for mb in range(0, len(paths), 16):
            batch = prep.preprocess_minibatch(paths[mb : mb + 16], epoch_seed=epoch)
        print(f"epoch {epoch}: minibatches ok, last batch {tuple(batch.shape)} "
              f"{batch.dtype} on {batch.device}")
    print(f"stats: {prep.stats} ({time.time()-t0:.1f}s)")
    print(f"storage ran {storage.tasks_run} tasks, peer ran {peer.tasks_run}")
    print(f"rpc bytes {fabric.total_bytes()/1e6:.2f} MB "
          "(tensors return over the fabric; images stay near-data)")


if __name__ == "__main__":
    main()

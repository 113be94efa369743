# Port of examples/serving.py on repro_torch: the model, params and prompts live on --device.
"""Batched serving demo: prefill + greedy decode on a reduced config, using
the same serve steps the decode shape-cells trace for the dry run.

    PYTHONPATH=src python examples_torch/serving.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.step import generate


def pick_device(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    dev = ap.parse_args(argv).device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {dev}: no CUDA card here (pass --device cpu)")
    return dev


def main(argv=None):
    dev = pick_device(argv)
    cfg = get_config("qwen3-1.7b:smoke").with_(
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=4, d_ff=256,
        vocab_size=512, head_dim=16,
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    print(f"serving {cfg.name}-reduced: {model.n_params()/1e6:.2f}M params")

    B, S, steps = 4, 48, 16
    prompts = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    where = torch.cuda.get_device_name(dev) if torch.device(dev).type == "cuda" else "the CPU"
    t0 = time.time()
    out = generate(model, params, prompts, steps=steps, max_len=S + steps)
    out = out.cpu()  # waits for the device
    dt = time.time() - t0
    print(f"generated {B}x{steps} tokens in {dt:.2f}s "
          f"({B*steps/dt:.1f} tok/s on {where}, first call included)")
    print("sample:", out[0].tolist())
    # decode is deterministic: same prompt → same continuation
    out2 = generate(model, params, prompts, steps=steps, max_len=S + steps)
    assert torch.equal(out, out2.cpu())
    print("deterministic decode: OK")
    return out


if __name__ == "__main__":
    main()

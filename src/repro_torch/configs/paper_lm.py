"""paper-lm-100m — the framework's own end-to-end training model (83.9 M
params): 12 layers, d_model 512, 8 heads, swiglu. ``repro_torch.train.e2e``
trains it with the full OffloadFS I/O plane (OffloadPrep input pipeline,
OffloadDB checkpoints)."""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="paper-lm-100m",
        family="dense",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=32768,
        mlp_kind="swiglu",
        scan_layers=False,
        remat="none",
    )


register("paper-lm-100m", make)

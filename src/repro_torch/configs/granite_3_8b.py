"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base family]"""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, scan_layers=False, remat="none",
    )


register("granite-3-8b", make)
register("granite-3-8b:smoke", make_smoke)

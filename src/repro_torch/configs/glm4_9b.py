"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE (partial rotary 0.5), GQA. [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        rotary_pct=0.5,
        rope_theta=1e4,
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, scan_layers=False, remat="none",
    )


register("glm4-9b", make)
register("glm4-9b:smoke", make_smoke)

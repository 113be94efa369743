"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936. qk_norm, GQA. [hf:Qwen/Qwen3 family]"""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        head_dim=128,  # qwen3 uses head_dim 128 (16H × 128 = 2048)
        qk_norm=True,
        rope_theta=1e6,
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, scan_layers=False, remat="none",
    )


register("qwen3-1.7b", make)
register("qwen3-1.7b:smoke", make_smoke)

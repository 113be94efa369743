"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 on every layer (as the JAX package's config:
the structured assignment field, where a free-text note says "32 experts
top-8"). [hf:ibm-granite family]"""
from repro_torch.models.config import ModelConfig, MoEConfig, register


def make():
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, experts_per_token=8, expert_d_ff=512),
        moe_every=1,
        moe_offset=0,
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=64,
        vocab_size=256,
        moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=64),
        scan_layers=False, remat="none",
    )


register("granite-moe-3b-a800m", make)
register("granite-moe-3b-a800m:smoke", make_smoke)

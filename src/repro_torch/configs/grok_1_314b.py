"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 on every layer. Attention logit softcap 30
(grok-style tanh cap). [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig, MoEConfig, register


def make():
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=32768),
        moe_every=1,
        moe_offset=0,
        attn_logit_softcap=30.0,
        mlp_kind="gelu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, expert_d_ff=128),
        scan_layers=False, remat="none",
    )


register("grok-1-314b", make)
register("grok-1-314b:smoke", make_smoke)

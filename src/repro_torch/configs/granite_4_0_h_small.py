"""granite-4.0-h-small [hybrid] — 40L d_model=4096, Mamba-2 in 36 layers and
GQA attention (32 heads over 8 KV, head_dim 128, no position embedding) in
4 (layers 5, 15, 25, 35), an MoE sublayer after every mixer: 72 experts
top-10 of width 768 plus a shared SwiGLU expert of width 1,536; vocab
100,352, tied embeddings; the muP scalars of ``granitemoehybrid``.
[hf:ibm-granite/granite-4.0-h-small]

Mamba-2: 128 heads of 64 (d_inner 8,192), d_state 128, one group, a
depthwise conv of 4 with a bias, chunks of 256. The published model is
dropless; so is the port's dispatch here (``MoEConfig.dropless``).
"""
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig, register

_PATTERN = ("mamba",) * 5 + ("attn",) + ("mamba",) * 4


def make():
    return ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=100352,
        block_pattern=_PATTERN,
        moe=MoEConfig(num_experts=72, experts_per_token=10, expert_d_ff=768,
                      dropless=True, shared_d_ff=1536),
        moe_every=1,
        moe_offset=0,
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256,
                          conv_bias=True),
        rotary_pct=0.0,
        tie_embeddings=True,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=1.0 / 128,
        logits_scaling=16.0,
        sub_quadratic=True,
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256,
        moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=32,
                      dropless=True, shared_d_ff=48),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=256,
                          conv_bias=True),
        num_layers=10, scan_layers=False, remat="none",
    )


register("granite-4.0-h-small", make)
register("granite-4.0-h-small:smoke", make_smoke)

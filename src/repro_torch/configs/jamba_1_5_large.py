"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2. Mamba+attn 1:7 interleave (one attn
per 8-layer period), MoE every other layer. [arXiv:2403.19887]

Mamba blocks run the chunked SSD (Mamba-2) matmul formulation, as in the
JAX package — d_state=64, head_dim=64 — instead of the selective scan;
hybrid attention layers use the standard GQA path and are the only
KV-cache consumers.
"""
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig, register

_PATTERN = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")


def make():
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, experts_per_token=2, expert_d_ff=24576),
        moe_every=2,
        moe_offset=1,
        mamba=MambaConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        sub_quadratic=True,
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256,
        moe=MoEConfig(num_experts=4, experts_per_token=2, expert_d_ff=128),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        scan_layers=False, remat="none",
    )


register("jamba-1.5-large-398b", make)
register("jamba-1.5-large-398b:smoke", make_smoke)

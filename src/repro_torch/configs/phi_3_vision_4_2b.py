"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064. phi3-mini backbone + CLIP frontend.
[hf:microsoft/Phi-3-vision-128k-instruct]

Frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 1024, d_model) prepended to the token
sequence; shape cells budget seq_len = patches + text tokens."""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision",
        frontend_seq=1024,  # stub CLIP patch embeddings
        rope_theta=1e6,  # 128k-ctx longrope base (adapted)
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, frontend_seq=8, scan_layers=False, remat="none",
    )


register("phi-3-vision-4.2b", make)
register("phi-3-vision-4.2b:smoke", make_smoke)

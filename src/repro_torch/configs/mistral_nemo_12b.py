"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.config import ModelConfig, register


def make():
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,  # nemo: head_dim 128 (not d_model/heads = 160)
        rope_theta=1e6,  # long-context rope base for 128k ctx
        max_seq_len=131072,
        mlp_kind="swiglu",
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, scan_layers=False, remat="none",
    )


register("mistral-nemo-12b", make)
register("mistral-nemo-12b:smoke", make_smoke)

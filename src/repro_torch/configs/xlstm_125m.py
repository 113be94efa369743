# Copied from src/repro/configs/xlstm_125m.py; only the repro. imports are rewritten.
"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks (arXiv:2405.04517), 1 sLSTM per 4 blocks at 125M scale.
d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM pf=2,
sLSTM post-MLP pf=4/3)."""
from repro_torch.models.config import ModelConfig, XLSTMConfig, register


def make():
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        xlstm=XLSTMConfig(),
        rotary_pct=0.0,  # recurrent blocks: no RoPE
        sub_quadratic=True,
        scan_layers=True,
    )


def make_smoke():
    return make().with_(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=256, scan_layers=False, remat="none",
    )


register("xlstm-125m", make)
register("xlstm-125m:smoke", make_smoke)

"""Architecture registry: importing this package registers the ported
architectures (``qwen3-1.7b``, ``glm4-9b``, ``granite-3-8b``,
``mistral-nemo-12b``, ``phi-3-vision-4.2b``, ``granite-moe-3b-a800m``,
``grok-1-314b``, ``jamba-1.5-large-398b``, ``xlstm-125m`` and
``seamless-m4t-large-v2``, each with its ``:smoke`` variant, and
``paper-lm-100m``): all ten archs of the JAX package and its paper LM;
and the port's own ``granite-4.0-h-small`` (and ``:smoke``), which the
JAX package does not have."""
from repro_torch.configs import (  # noqa: F401
    glm4_9b,
    granite_3_8b,
    granite_4_0_h_small,
    granite_moe_3b_a800m,
    grok_1_314b,
    jamba_1_5_large,
    mistral_nemo_12b,
    paper_lm,
    phi_3_vision_4_2b,
    qwen3_1_7b,
    seamless_m4t_large_v2,
    xlstm_125m,
)

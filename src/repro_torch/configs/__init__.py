"""Architecture registry: importing this package registers the ported
architectures (``qwen3-1.7b``, ``glm4-9b``, ``granite-3-8b`` and
``mistral-nemo-12b``, each with its ``:smoke`` variant, and
``paper-lm-100m``)."""
from repro_torch.configs import (  # noqa: F401
    glm4_9b,
    granite_3_8b,
    mistral_nemo_12b,
    paper_lm,
    qwen3_1_7b,
)

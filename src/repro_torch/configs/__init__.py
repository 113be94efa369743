"""Architecture registry: importing this package registers the ported
architectures (``qwen3-1.7b`` and its ``:smoke`` variant, ``paper-lm-100m``)."""
from repro_torch.configs import paper_lm, qwen3_1_7b  # noqa: F401

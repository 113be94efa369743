"""Architecture registry: importing this package registers the ported
architectures (``qwen3-1.7b`` and its ``:smoke`` variant)."""
from repro_torch.configs import qwen3_1_7b  # noqa: F401

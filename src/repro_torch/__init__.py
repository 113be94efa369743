"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It keeps ``repro``'s layout (``core``, ``kernels``, ``models``, ``configs``,
``serve``) so each module's JAX counterpart sits at the same relative path.
It imports ``torch``, numpy and the standard library only: never ``jax``
and nothing of ``repro``. The storage modules under ``core`` are copies of
their ``repro.core`` counterparts. Entry points run on ``"cuda"`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

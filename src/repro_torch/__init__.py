"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It keeps ``repro``'s layout (``core``, ``data``, ``kernels``, ``models``,
``configs``, ``serve``, ``train``, ``sim``) so each module's JAX
counterpart sits at the same relative path. It imports ``torch``, numpy
and the standard library only: never ``jax`` and nothing of ``repro``.
The storage modules under ``core``, the data modules under ``data`` and
the calibrated discrete-event simulator under ``sim`` (which replays the
traced operation streams at the paper's testbed rates for the benchmark
figures) are copies of their ``repro`` counterparts. Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

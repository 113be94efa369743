"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
wrappers, and their plain PyTorch versions (``ref.py``)."""

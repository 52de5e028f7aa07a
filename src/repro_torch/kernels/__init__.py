"""Hand-written CUDA kernels (``csrc/``), their ctypes build and wrappers
(``ops``), and their plain PyTorch versions (``ref``)."""

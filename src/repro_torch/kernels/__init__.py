"""Hand-written Hopper kernels of the port (``csrc/``), their ctypes
wrappers and plain PyTorch versions, and the padding/routing layer."""

"""Hand-written CUDA kernels for Hopper, their wrappers and their plain
PyTorch versions (see ``ops`` for the dispatch)."""

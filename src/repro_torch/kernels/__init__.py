"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``ops`` for the entry points and ``ref`` for the oracles)."""

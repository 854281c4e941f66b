"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``build`` compiles ``csrc/*.cu`` at first use."""

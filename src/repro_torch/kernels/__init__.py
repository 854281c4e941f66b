"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``build`` compiles ``csrc/*.cu`` at first use."""

from __future__ import annotations


def check_args(anchor: str, want: dict) -> None:
    """Raise ``ValueError`` unless every tensor of ``want`` (name ->
    (tensor, dtype, shape)) lies on the device of ``want[anchor]``, has its
    dtype and shape, and is contiguous: what a kernel's wrapper checks
    before it hands raw pointers to the kernel."""
    dev = want[anchor][0].device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {anchor} on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

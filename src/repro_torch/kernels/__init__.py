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


def launch_counts(reset: bool = False) -> dict:
    """Each kernel wrapper's launch count (the plain integer on the
    wrapper), by kernel name; every count set to 0 first when ``reset``."""
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops as sweep_ops
    from repro_torch.kernels.power_sweep import packed
    from repro_torch.kernels.segment_sum import ops as seg_ops

    wrappers = (bp_ops.bp_update, sweep_ops.power_sweep_carry,
                sweep_ops.power_sweep_carry_train, packed.power_sweep_tokens,
                pack_ops.pack_rows, pack_ops.scatter_add_rows,
                seg_ops.word_rows_sum, seg_ops.topic_sum)
    if reset:
        for fn in wrappers:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in wrappers}

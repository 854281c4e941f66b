"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``build`` compiles ``csrc/*.cu`` at first use."""

from __future__ import annotations

import threading

import torch

_COUNT_LOCK = threading.Lock()
# (device index, stream) -> counters that every kernel taking them leaves 0
_counters: dict = {}


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


def zeroed_counters(device: torch.device, stream: int, n: int
                    ) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device`` for a kernel's launch on
    ``stream``, all zero: a kernel that counts its CTAs or warps in them
    sets each back to 0 before it ends (``topic_sum``'s groups, the carry
    fold's rows).  One tensor a stream, shared by those kernels: launches
    on one stream run one after another."""
    key = (device.index, stream)
    got = _counters.get(key)
    if got is None or got.numel() < n:
        got = _counters[key] = torch.zeros(max(n, 1), dtype=torch.int32,
                                           device=device)
    return got


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: the shards of a
    lockstep run launch from threads of their own."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def launch_counts(reset: bool = False) -> dict:
    """Each kernel wrapper's launch count (the plain integer on the
    wrapper), by kernel name; every count set to 0 first when ``reset``."""
    from repro_torch.kernels.bp_update import ops as bp_ops
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.kernels.power_sweep import ops as sweep_ops
    from repro_torch.kernels.power_sweep import packed
    from repro_torch.kernels.power_topics import ops as topics_ops
    from repro_torch.kernels.segment_sum import ops as seg_ops

    wrappers = (bp_ops.bp_update, sweep_ops.power_sweep_carry,
                sweep_ops.power_sweep_carry_train, packed.power_sweep_tokens,
                pack_ops.pack_rows, pack_ops.scatter_add_rows,
                seg_ops.word_rows_sum, seg_ops.topic_sum, gibbs_ops.gibbs_sweep,
                gibbs_ops.gibbs_noise, topics_ops.power_topics)
    if reset:
        for fn in wrappers:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in wrappers}

"""Carry a trained phi statistic, a training state, or an LM's params from
the JAX package into the port."""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import LDATrainState


def phi_from_reference(phi_acc: Union[np.ndarray, torch.Tensor], *,
                       live_words: Optional[int] = None,
                       device="cuda") -> torch.Tensor:
    """The reference's ``phi_acc`` [W, K] (numpy, as ``np.asarray`` of the
    JAX array gives it, or a tensor) as a float32 tensor on ``device``.

    float32 and bfloat16 statistics are accepted (a bfloat16 array from
    ``ml_dtypes`` is decoded from its raw bytes; it is up-cast to float32,
    the serving precision).  Raises ``ValueError`` on any other dtype, on a
    shape that is not 2-D, and on ``live_words`` outside ``[1, W]``.
    """
    dev = resolve_device(device)
    if isinstance(phi_acc, np.ndarray):
        phi_acc = _float_tensor(phi_acc, "phi_acc")
    if phi_acc.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"phi_acc must be float32 or bfloat16, got "
                         f"{phi_acc.dtype}")
    if phi_acc.dim() != 2 or 0 in phi_acc.shape:
        raise ValueError(f"phi_acc must be a non-empty [W, K] matrix, got "
                         f"shape {tuple(phi_acc.shape)}")
    W = phi_acc.shape[0]
    if live_words is not None and not 0 < int(live_words) <= W:
        raise ValueError(f"live_words={live_words} outside phi's {W} rows")
    return phi_acc.to(device=dev, dtype=torch.float32).contiguous()


def _float_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """A float32 or bfloat16 numpy array as a CPU tensor of its dtype.  A
    bfloat16 array (``ml_dtypes``' type, as ``np.asarray`` of a JAX array
    gives it) is decoded from its raw bytes through its dtype's name."""
    if not a.flags.writeable:      # e.g. np.asarray of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.uint16)).view(torch.bfloat16)
    if a.dtype == np.float32:
        return torch.from_numpy(a)
    raise ValueError(f"{name} must be float32 or bfloat16, got {a.dtype}")


def lm_params_from_reference(tree: Any, cfg, *, device="cuda") -> Any:
    """The reference's LM params for ``cfg`` (its ``init`` tree with numpy
    leaves, as ``np.asarray`` of each JAX array gives them) as the port's
    tree on ``device``.  float32 and bfloat16 leaves keep their dtype.
    Raises ``ValueError`` where a key, a list length or a shape differs
    from ``registry.build(cfg).init``'s tree."""
    from repro_torch.models import registry

    dev = resolve_device(device)
    want = registry.build(cfg).init(cfg, device="meta")

    def carry(got, ref, path):
        where = "/".join(map(str, path)) or "<root>"
        if isinstance(ref, dict):
            if not isinstance(got, dict) or set(got) != set(ref):
                raise ValueError(
                    f"params at {where}: keys "
                    f"{sorted(got) if isinstance(got, dict) else type(got)} "
                    f"!= {sorted(ref)}")
            return {k: carry(got[k], ref[k], path + (k,)) for k in ref}
        if isinstance(ref, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(ref):
                raise ValueError(f"params at {where}: expected a list of "
                                 f"{len(ref)}")
            return [carry(g, r, path + (i,))
                    for i, (g, r) in enumerate(zip(got, ref))]
        t = _float_tensor(np.asarray(got), f"params at {where}")
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"params at {where}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        return t.to(dev)

    return carry(tree, want, ())


def train_state_from_reference(phi_acc: np.ndarray, m: int, *, seed: int,
                               device="cuda") -> LDATrainState:
    """The reference's ``LDATrainState`` (``phi_acc`` [W, K] as numpy, the
    mini-batch cursor ``m``) as the port's, to continue training there.

    phi_acc passes through `phi_from_reference` (float32 or bfloat16 in,
    float32 out).  The reference's PRNG key cannot be carried into torch:
    the new state's generator is seeded with ``seed`` on ``device``.
    """
    phi = phi_from_reference(phi_acc, device=device)
    return LDATrainState(
        phi_acc=phi, m=int(m),
        generator=torch.Generator(device=phi.device).manual_seed(int(seed)))

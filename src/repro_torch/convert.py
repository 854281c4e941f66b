"""Carry a trained phi statistic, or a training state, from the JAX package
into the port."""

from __future__ import annotations

from typing import Optional, Union

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
        if not phi_acc.flags.writeable:      # e.g. np.asarray of a jax array
            phi_acc = phi_acc.copy()
        if phi_acc.dtype.name == "bfloat16":
            phi_acc = torch.from_numpy(np.ascontiguousarray(phi_acc).view(
                np.uint16)).view(torch.bfloat16)
        elif phi_acc.dtype == np.float32:
            phi_acc = torch.from_numpy(phi_acc)
        else:
            raise ValueError(f"phi_acc must be float32 or bfloat16, got "
                             f"{phi_acc.dtype}")
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

"""Compressed phi accumulators: the counterpart of ``repro.core.quantize``.

``LDAConfig.phi_acc_dtype = 'bfloat16'`` stores the streaming Eq. 11
statistic at half width: phi_acc's memory halves, the phi and residual
statistic syncs ship at bf16, and checkpoints keep the narrow dtype.  The
accumulate itself runs in float32 (``phi_eff = phi_acc + delta``
promotes), and only the fold back into the carry narrows, by stochastic
rounding: a round-to-nearest fold would drop every per-batch delta under
half a bf16 ULP of the running statistic, batch after batch.

The reference draws its dither from a JAX key; the port draws it from a
``torch.Generator``, so the two give different bits from one seed.  Given
one dither, `round_with_dither` gives the reference's formula's bits.
"""

from __future__ import annotations

import torch

_PHI_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def phi_acc_dtype(cfg) -> torch.dtype:
    """Resolve ``cfg.phi_acc_dtype`` to the torch storage dtype."""
    name = getattr(cfg, "phi_acc_dtype", "float32")
    if name not in _PHI_ACC_DTYPES:
        raise ValueError(f"unknown phi_acc_dtype: {name!r} "
                         f"(expected one of {tuple(_PHI_ACC_DTYPES)})")
    return _PHI_ACC_DTYPES[name]


# elements a rounding pass takes at once: the int32 working copies stay at
# 64 MB each however large phi_acc is, and the bf16 result is the one
# full-size allocation
_CHUNK = 1 << 24


def round_with_dither(x: torch.Tensor, dither: torch.Tensor) -> torch.Tensor:
    """The reference's stochastic-rounding formula with a given dither:
    ``bf16(bitcast_f32((bits(x) + dither) & 0xFFFF0000))``, ``dither`` an
    integer tensor of x's shape in [0, 2**16).  The sum is formed in int32,
    whose wrapping add gives uint32's bits; an arithmetic shift by 16 then
    leaves the top 16 bits sign-extended, which int16 holds as they are
    (the cast of a value whose low 16 bits are 0 is exact), a NaN made the
    quiet NaN 0x7FC0 with its sign, as the reference's cast makes it.
    Works on one int32 copy of the dither; neither input is changed."""
    r = dither.to(torch.int32, copy=True)
    r.add_(x.to(torch.float32).contiguous().view(torch.int32))
    r.bitwise_right_shift_(16)
    nan = (r & 0x7F80) == 0x7F80
    nan &= (r & 0x7F) != 0
    r = torch.where(nan, (r & -0x8000) | 0x7FC0, r)
    return r.to(torch.int16).view(torch.bfloat16)


def stochastic_round(x: torch.Tensor, dtype: torch.dtype,
                     generator: torch.Generator) -> torch.Tensor:
    """Cast float32 ``x`` to ``dtype`` with stochastic rounding.

    bf16 is float32's top 16 bits, so adding a uniform 16-bit dither to the
    bits that truncation drops, then truncating, rounds x up with
    probability equal to the dropped fraction: unbiased.  The dither is
    drawn from ``generator`` on x's device, in passes of `_CHUNK`
    elements, so the temporaries stay small beside the result.  float32
    passes through; any other dtype raises ``ValueError``.
    """
    if dtype == torch.float32:
        return x.to(torch.float32)
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic_round supports float32/bfloat16, "
                         f"got {dtype}")
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.bfloat16, device=x.device)
    for lo in range(0, flat.numel(), _CHUNK):
        part = flat[lo:lo + _CHUNK]
        dither = torch.randint(0, 1 << 16, tuple(part.shape),
                               generator=generator, dtype=torch.int32,
                               device=x.device)
        out[lo:lo + _CHUNK] = round_with_dither(part, dither)
    return out.reshape(x.shape)

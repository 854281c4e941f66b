"""Selective-sweep policy resolution: the counterpart of
``repro.core.sweep_dispatch`` for the port's kernels.

``LDAConfig.sweep_policy`` names the formulation of the t >= 2 selective
sweep.  The port's kernels are the counterparts of the reference's Pallas
kernels, so the name resolves as the reference's ``impl="pallas"`` branch
resolves it:

  - ``auto``, ``dense_layout`` and ``kblocked`` run the carry-resident
    sweep (``kernels/power_sweep/ops.py::power_sweep_carry_train``).  On
    Hopper it reads phi by index from HBM, so the reference's full-K and
    K-blocked variants are one kernel, and both resolve to
    ``dense_layout``, the name of the formulation that kernel computes;
  - ``packed`` runs the packed-stream sweep: the phi pack
    (``kernels/power_pack``) and ``kernels/power_sweep/packed.py``.

``auto`` never resolves to ``packed``, as the reference's Pallas branch
never does.  The reference's jnp branch prices two jnp formulations with
a cost model measured on the host CPU (``measure_coeffs``,
``packed_cost``, ``dense_layout_cost``); the port has neither formulation,
so that model is not carried over.
"""

from __future__ import annotations

POLICIES = ("auto", "packed", "dense_layout", "kblocked")


def resolve_sweep_policy(cfg) -> str:
    """``cfg.sweep_policy`` resolved to the formulation the port runs:
    ``"packed"`` or ``"dense_layout"`` (the carry kernel).  Raises
    ``ValueError`` for a name outside ``POLICIES``, in the reference's
    words."""
    policy = cfg.sweep_policy
    if policy not in POLICIES:
        raise ValueError(f"unknown sweep_policy: {policy!r} (expected "
                         f"auto | packed | dense_layout | kblocked)")
    return "packed" if policy == "packed" else "dense_layout"

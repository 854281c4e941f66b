"""The port's LM lab (``repro_torch.models``) against the JAX package's
``repro.models`` in bfloat16 (the reference's param and cache dtypes), for
all ten architectures at ``reduced()``: ``forward`` logits and
``decode_step`` logits teacher-forced step by step, on the reference's own
params (``torch_lm_pairs.run_pair``).

Held to the reference's own bf16 decode tolerance (``tests/test_archs.py``:
rtol 0.1, atol 0.15, top-1 agreement >= 0.5): torch and XLA round bf16
products and sums at different points.  MoE routing is discrete: where the
rounding moves a gate across a near-tie the two packages route a token to
other experts, and that row's logits differ by more than any rounding.
"""

import numpy as np
import pytest

from repro.configs import ARCH_IDS

from torch_lm_pairs import (held, one_torch_thread,
                            run_pair, true_vocab)

BF16_TOL = dict(rtol=0.1, atol=0.15)
# a routing decision the two packages take differently must be a near-tie:
# the port's top-k gate margin (k-th largest gate less the next) there is
# below this; the first flips seen had margins of 2.3e-4 and 2.8e-4
ROUTER_TIE = 1e-2


@pytest.fixture(scope="module")
def runs():
    """run_pair(arch, "bf16"), once per architecture."""
    cache = {}

    def get(arch):
        if arch not in cache:
            with one_torch_thread():
                cache[arch] = run_pair(arch, "bf16")
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_decode_bf16_match_reference(runs, arch):
    """Every row of the forward and of each decode step within the bf16
    tolerance, but a row in which the packages routed a token to other
    experts: that must have been a near-tie (ROUTER_TIE), and the row is
    held to top-1 agreement with the rest."""
    r = runs(arch)
    cfg = r["cfg"]
    pairs = [r["fwd"]] + r["dec"]
    for i, ((want, got), (flipped, worst)) in enumerate(zip(pairs,
                                                            r["flips"])):
        what = f"{arch} {'forward' if i == 0 else f'decode step {i - 1}'}"
        assert worst < ROUTER_TIE, what
        w, g = true_vocab(want, cfg), true_vocab(got, cfg)
        for b in np.flatnonzero(~flipped):
            held(g[b], w[b], BF16_TOL, f"{what} row {b}")
        assert np.mean(g.argmax(-1) == w.argmax(-1)) >= 0.5, what

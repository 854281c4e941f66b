"""The port's LM lab (``repro_torch.models``) against the JAX package's
``repro.models`` in float32, for all ten architectures at ``reduced()``:
``forward`` (prefill) logits and caches, ``decode_step`` logits and caches
teacher-forced step by step, and the MoE routing, on the reference's own
params (``torch_lm_pairs.run_pair``).

Every param is cast to float32 on both sides and the caches are float32:
the two packages then differ only in the order of float32 sums, and are
held to rtol 1e-4 (atol 1e-4, against logits of scale ~1).
"""

import numpy as np
import pytest

from repro.configs import ARCH_IDS
from repro_torch.models.common import tree_leaves

from torch_lm_pairs import (B, P, held, one_torch_thread,
                            run_pair, true_vocab)

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def runs():
    """run_pair(arch, "f32"), once per architecture."""
    cache = {}

    def get(arch):
        if arch not in cache:
            with one_torch_thread():
                cache[arch] = run_pair(arch, "f32")
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_f32_matches_reference(runs, arch):
    r = runs(arch)
    want, got = r["fwd"]
    assert got.shape == want.shape == (B, P, r["cfg"].padded_vocab)
    # the padded vocabulary rows are masked to -1e30 in both
    np.testing.assert_array_equal(got[..., r["cfg"].vocab_size:],
                                  want[..., r["cfg"].vocab_size:])
    held(true_vocab(got, r["cfg"]), true_vocab(want, r["cfg"]), F32_TOL,
         arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_caches_f32_match_reference(runs, arch):
    r = runs(arch)
    want, got = r["caches"]
    wl, gl = list(tree_leaves(want)), list(tree_leaves(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, w), (_, g) in zip(wl, gl):
        assert g.shape == w.shape, path
        held(g, w, F32_TOL, f"{arch} {path}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_f32_matches_reference_step_by_step(runs, arch):
    r = runs(arch)
    for i, (want, got) in enumerate(r["dec"]):
        assert got.shape == want.shape == (B, 1, r["cfg"].padded_vocab)
        held(true_vocab(got, r["cfg"]), true_vocab(want, r["cfg"]), F32_TOL,
             f"{arch} decode step {i}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_caches_f32_match_reference(runs, arch):
    """The caches each decode step leaves (its KV or state write)."""
    r = runs(arch)
    for i, (want, got) in enumerate(r["dec_caches"]):
        for (path, w), (_, g) in zip(tree_leaves(want), tree_leaves(got)):
            held(g, w, F32_TOL, f"{arch} decode step {i} {path}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_decode_f32_route_alike(runs, arch):
    """In float32 both packages route every token to the same experts."""
    for flipped, _ in runs(arch)["flips"]:
        assert not flipped.any()

"""The port's carry sweep (``repro_torch.kernels.power_sweep.ops``), both
modes, held against the JAX package's oracle ``power_sweep_carry_ref``.

On the CPU the wrapper runs the plain version.  The CUDA kernel itself is
held against the plain version on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerance: rtol 1e-5, atol 1e-6 — the two sum the renormalization and the
per-document reductions in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.power_sweep.ref import power_sweep_carry_ref
from repro_torch.kernels.power_sweep import ops

RTOL, ATOL = 1e-5, 1e-6
ALPHA = 0.1


def _case(seed, *, D, L, K, W, frozen=0.3, frozen_doc=None):
    """Doc-contiguous tokens with ragged lengths (padding carries c = 0),
    a share of frozen tokens on the guard id W, and optionally one doc
    frozen whole."""
    rng = np.random.default_rng(seed)
    T = D * L
    p_tok = rng.integers(0, W, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    lens = rng.integers(1, L + 1, D)
    c = rng.integers(1, 4, T).astype(np.float32)
    c[np.tile(np.arange(L), D) >= np.repeat(lens, L)] = 0.0
    froz = rng.random(T) < frozen
    if frozen_doc is not None:
        froz |= doc_ids == frozen_doc
    p_tok[froz] = W
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    counts = c.reshape(T, 1)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = rng.random((W, K)).astype(np.float32)
    phi /= phi.sum(0, keepdims=True)
    return p_tok, doc_ids, counts, mu, theta, phi


def _ref_serving(p_tok, doc_ids, counts, mu, theta, phi):
    """The oracle with the reference's layout: guard row appended."""
    W, K = phi.shape
    phi_rows = np.concatenate([phi, np.zeros((1, K), np.float32)])
    return [np.asarray(x) for x in power_sweep_carry_ref(
        jnp.asarray(p_tok), jnp.asarray(doc_ids), jnp.asarray(counts),
        jnp.asarray(mu), jnp.asarray(theta), jnp.zeros((K,), jnp.float32),
        jnp.asarray(phi_rows), jnp.zeros((1, K), jnp.float32),
        alpha=ALPHA, beta=0.0, wbeta=1.0, update_phi=False)]


def _port_serving(p_tok, doc_ids, counts, mu, theta, phi):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = ops.power_sweep_carry(
        t(p_tok), t(doc_ids), t(counts), t(mu), t(theta),
        torch.zeros(phi.shape[1]), t(phi), alpha=ALPHA, beta=0.0, wbeta=1.0,
        n_guard=phi.shape[0])
    return [x.numpy() for x in out]


@pytest.mark.parametrize("D,L,K,W,frozen_doc", [
    (8, 12, 16, 150, None),      # the test_serve.py width
    (6, 10, 100, 40, 2),         # K not a multiple of 128, one doc frozen
    (5, 9, 130, 70, 0),          # K just past a lane tile, first doc frozen
    (3, 4, 10000, 20, 1),        # K = 10,000: past the register path
])
def test_serving_sweep_matches_reference_oracle(D, L, K, W, frozen_doc):
    case = _case(D * 1000 + K, D=D, L=L, K=K, W=W, frozen_doc=frozen_doc)
    mu_new, th_delta, rdoc = _port_serving(*case)
    ref_mu, ref_th, _, _, ref_rdoc = _ref_serving(*case)
    np.testing.assert_allclose(mu_new, ref_mu, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th_delta, ref_th, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rdoc, ref_rdoc, rtol=RTOL, atol=ATOL)
    assert th_delta.shape == (D, K) and rdoc.shape == (D,)
    p_tok, doc_ids, counts, mu, _, _ = case
    frozen = p_tok == W
    # frozen and guard tokens leave mu untouched, bit for bit
    np.testing.assert_array_equal(mu_new[frozen], mu[frozen])
    if frozen_doc is not None:
        assert rdoc[frozen_doc] == 0.0
        assert not th_delta[frozen_doc].any()
    # padding tokens (c = 0) of an active doc move mu but add nothing
    assert (counts[~frozen, 0] == 0).any()


@pytest.mark.parametrize("K,path", [
    (1, "registers"), (37, "registers"), (2000, "registers"),
    (2048, "registers"), (2049, "kblocked"), (4096, "kblocked"),
    (8192, "kblocked"), (8193, "kblocked"), (10000, "kblocked"),
    (50000, "kblocked")])
def test_serve_launch_plan_covers_every_k(K, path):
    """Every K has a serving path: the register path (its threads'
    float4s cover K) up to the K = 2000 cell, the K-blocked two passes,
    which take any K, past it; nothing raises."""
    plan = ops.serve_launch_plan(K)
    assert plan.path == path and plan.threads == 256
    if path == "registers":
        assert plan.V in (1, 2) and 4 * plan.V * plan.threads >= K
        assert K <= ops.SERVE_REGISTER_MAX_K
    else:
        assert plan == ops.ServePlan("kblocked", 0, 256)


def test_serving_sweep_updates_mu_in_place():
    p_tok, doc_ids, counts, mu, theta, phi = _case(3, D=4, L=6, K=16, W=30)
    mu_t = torch.from_numpy(mu.copy())
    out = ops.power_sweep_carry(
        torch.from_numpy(p_tok), torch.from_numpy(doc_ids),
        torch.from_numpy(counts), mu_t, torch.from_numpy(theta),
        torch.zeros(16), torch.from_numpy(phi), alpha=ALPHA, beta=0.0,
        wbeta=1.0, n_guard=30)
    assert out[0] is mu_t
    assert not np.array_equal(mu_t.numpy(), mu)


def _train_case(seed, *, D, L, K, W, P, Pk, guard=0.4, empty_doc=False):
    """Training-mode inputs: tokens on power rows [0, P) or (a ``guard``
    share) the guard id P; P distinct power words of a [W, K] phi, Pk
    distinct topics each; with ``empty_doc`` document 1 has no tokens."""
    rng = np.random.default_rng(seed)
    T = D * L
    p_tok = rng.integers(0, P, T).astype(np.int32)
    p_tok[rng.random(T) < guard] = P
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    if empty_doc:
        doc_ids[doc_ids == 1] = 0                # doc 1 owns no slot
    counts = rng.integers(0, 4, (T, 1)).astype(np.float32)
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = (rng.random((W, K)) * 5).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    phi_tot = (phi[sel_w].sum(0) + 3.0).astype(np.float32)
    return p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k


def reference_tables(phi, sel_w, sel_k):
    """The reference's [P+1, K] phi and mask row tables (guard row last) of
    a selection, as its ``_selective_sweep_carry_pallas`` builds them."""
    P, K = sel_k.shape[0], phi.shape[1]
    phi_rows = np.zeros((P + 1, K), np.float32)
    phi_rows[:P] = phi[sel_w]
    mask_rows = np.zeros((P + 1, K), np.float32)
    np.put_along_axis(mask_rows[:P], sel_k, 1.0, axis=1)
    return phi_rows, mask_rows


@pytest.mark.parametrize("D,L,K,P,Pk,guard,empty_doc", [
    (6, 8, 20, 9, 8, 0.4, False),
    (5, 6, 20, 7, 1, 0.4, False),                # Pk = 1
    (4, 6, 16, 5, 16, 0.4, False),               # Pk = K
    (4, 6, 20, 5, 6, 1.0, False),                # every token a guard token
    (5, 7, 24, 6, 5, 0.3, True),                 # an empty document
])
def test_training_mode_plain_matches_reference_oracle(D, L, K, P, Pk, guard,
                                                      empty_doc):
    """power_sweep_carry_train (plain on the CPU) against the reference's
    oracle over the [P+1, K] tables of the same selection, its [P, K]
    delta/residual rows read back at sel_k; mu outside each power token's
    selected topics, and every guard token's mu, left bit for bit."""
    case = _train_case(D * 100 + K + Pk, D=D, L=L, K=K, W=3 * P, P=P, Pk=Pk,
                       guard=guard, empty_doc=empty_doc)
    p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k = case
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=P * 0.01)
    phi_rows, mask_rows = reference_tables(phi, sel_w, sel_k)
    ref = [np.asarray(x) for x in power_sweep_carry_ref(
        *[jnp.asarray(x) for x in (p_tok, doc_ids, counts, mu, theta,
                                   phi_tot, phi_rows, mask_rows)],
        update_phi=True, **kw)]
    ref[2] = np.take_along_axis(ref[2], sel_k, axis=1)
    ref[3] = np.take_along_axis(ref[3], sel_k, axis=1)
    t = torch.from_numpy
    mu_t = t(mu.copy())
    got = ops.power_sweep_carry_train(
        t(p_tok), t(doc_ids), t(counts), mu_t, t(theta), t(phi_tot), t(phi),
        t(sel_w), t(sel_k), **kw)
    assert got[0] is mu_t and len(got) == 4
    for name, g, r in zip(("mu", "theta_delta", "d_pack", "r_pack"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    off = mask_rows[p_tok] == 0                 # unselected, guard rows too
    np.testing.assert_array_equal(mu_t.numpy()[off], mu[off])
    if guard == 1.0:
        np.testing.assert_array_equal(mu_t.numpy(), mu)
        assert not any(x.numpy().any() for x in got[1:])
    if empty_doc:
        assert not got[1].numpy()[1].any()

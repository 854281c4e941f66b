"""The plain versions of the training slice's three kernels held against the
JAX package: ``bp_update`` (TPU kernel ``bp_update_tokens``), the training
mode of the carry sweep, ``power_sweep_carry_train``
(``power_sweep_carry_tokens`` and its K-blocked twin) and
``scatter_add_rows`` (``scatter_add_rows_pallas``).

On the CPU each wrapper runs its plain version; the CUDA kernels are held
against the plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.  The Pallas ``bp_update`` and ``power_pack`` kernels
trace in interpret mode here, so the port is held against them as well as
against the oracles.

Tolerances: rtol 1e-5, atol 1e-6 where the two sides sum in different
orders (the renormalization over K, the row sums); the scatter is exact
(float adds of unique coordinates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bp_update.kernel import bp_update_tokens
from repro.kernels.bp_update.ref import bp_update_tokens_ref
from repro.kernels.power_pack import ops as jpack
from repro.kernels.power_pack.ref import scatter_add_rows_ref
from repro.kernels.power_sweep.ref import power_sweep_carry_kblocked_ref
from repro.core import power as jpw
from repro_torch.kernels.bp_update import ops as bp_ops
from repro_torch.kernels.power_pack import ops as pack_ops
from repro_torch.kernels.power_sweep import ops as sweep_ops

RTOL, ATOL = 1e-5, 1e-6
ALPHA, BETA = 0.1, 0.01


def _bp_case(seed, *, D, L, K, W):
    """Token-major dense-sweep inputs: ragged docs (c = 0 padding on word
    0), theta and phi consistent with mu as the sweep's caller builds them."""
    rng = np.random.default_rng(seed)
    T = D * L
    word_ids = rng.integers(0, W, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    c = rng.integers(1, 4, T).astype(np.float32)
    pad = np.tile(np.arange(L), D) >= np.repeat(rng.integers(1, L + 1, D), L)
    c[pad] = 0.0
    word_ids[pad] = 0
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    counts = c.reshape(T, 1)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = (rng.random((W, K)) * 3).astype(np.float32)
    np.add.at(phi, word_ids, counts * mu)
    phi_tot = phi.sum(0).astype(np.float32)
    return word_ids, doc_ids, counts, mu, theta, phi, phi_tot


def _port_bp(case, wbeta):
    t = torch.from_numpy
    word_ids, doc_ids, counts, mu, theta, phi, phi_tot = case
    before = bp_ops.bp_update.launches
    out = bp_ops.bp_update(t(word_ids), t(doc_ids), t(counts), t(mu.copy()),
                           t(theta), t(phi), t(phi_tot), alpha=ALPHA,
                           beta=BETA, wbeta=wbeta)
    assert bp_ops.bp_update.launches == before      # CPU: plain, no launch
    return [x.numpy() for x in out]


@pytest.mark.parametrize("D,L,K,W", [(4, 8, 128, 60),    # lane-aligned K
                                     (3, 7, 100, 40),    # K not a multiple of 32
                                     (5, 9, 130, 90)])   # K just past a tile
def test_bp_update_plain_matches_oracle_and_pallas_kernel(D, L, K, W):
    case = _bp_case(D * 100 + K, D=D, L=L, K=K, W=W)
    word_ids, doc_ids, counts, mu, theta, phi, phi_tot = case
    wbeta = W * BETA
    got_mu, got_r = _port_bp(case, wbeta)
    theta_t, phi_t = theta[doc_ids], phi[word_ids]
    ref_mu, ref_r = bp_update_tokens_ref(
        jnp.asarray(counts), jnp.asarray(mu), jnp.asarray(theta_t),
        jnp.asarray(phi_t), jnp.asarray(phi_tot[None, :]), alpha=ALPHA,
        beta=BETA, wbeta=wbeta)
    np.testing.assert_allclose(got_mu, np.asarray(ref_mu), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_r, np.asarray(ref_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_mu.sum(1), 1.0, rtol=1e-5)
    # the Pallas kernel, in interpret mode, on its own padded layout
    T = D * L
    Tp, Kp = -(-T // 8) * 8, -(-K // 128) * 128

    def pad(x, fill=0.0):
        out = np.full((Tp, Kp), fill, np.float32)
        out[:T, :K] = x
        return jnp.asarray(out)

    pt = np.ones((1, Kp), np.float32)
    pt[0, :K] = phi_tot
    cnt = np.zeros((Tp, 1), np.float32)
    cnt[:T] = counts
    pal_mu, pal_r = bp_update_tokens(
        jnp.asarray(cnt), pad(mu), pad(theta_t, -ALPHA), pad(phi_t, -BETA),
        jnp.asarray(pt), alpha=ALPHA, beta=BETA, wbeta=wbeta)
    np.testing.assert_allclose(got_mu, np.asarray(pal_mu)[:T, :K], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_r, np.asarray(pal_r)[:T, :K], rtol=RTOL,
                               atol=ATOL)


def test_bp_update_leaves_its_inputs_and_rejects_other_devices():
    case = _bp_case(1, D=2, L=4, K=16, W=10)
    t = torch.from_numpy
    args = [t(x.copy()) for x in case]
    before = [a.clone() for a in args]
    bp_ops.bp_update(*args, alpha=ALPHA, beta=BETA, wbeta=0.1)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bp_ops.bp_update(*meta, alpha=ALPHA, beta=BETA, wbeta=0.1)


def _pack_case(seed, *, W, K, P, Pk, dup_zero_rows=0):
    """A [W, K] matrix and a top-k-like selection: distinct rows, distinct
    topics per row; optionally the last ``dup_zero_rows`` slots all point
    at one row that no other slot names, with zero values, as the dead
    slots of a live-vocabulary run point at its first guard row."""
    rng = np.random.default_rng(seed)
    mat = (rng.random((W, K)) * 4).astype(np.float32)
    sel_w = rng.choice(W, P + 1, replace=False).astype(np.int32)
    sel_w, guard = sel_w[:P], sel_w[P]
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    vals = rng.standard_normal((P, Pk)).astype(np.float32)
    if dup_zero_rows:
        sel_w[-dup_zero_rows:] = guard
        vals[-dup_zero_rows:] = 0.0
    return mat, sel_w, sel_k, vals


@pytest.mark.parametrize("W,K,P,Pk,dup", [(50, 16, 8, 4, 0),
                                          (40, 100, 12, 50, 3),
                                          (300, 130, 30, 8, 5)])
def test_scatter_add_rows_matches_pallas_kernel_and_reference(W, K, P, Pk,
                                                              dup):
    mat, sel_w, sel_k, vals = _pack_case(W + K, W=W, K=K, P=P, Pk=Pk,
                                         dup_zero_rows=dup)
    t = torch.from_numpy
    m = t(mat.copy())
    before = pack_ops.scatter_add_rows.launches
    out = pack_ops.scatter_add_rows(m, t(sel_w), t(sel_k), t(vals))
    assert out is m and pack_ops.scatter_add_rows.launches == before
    args = [jnp.asarray(x) for x in (mat, sel_w, sel_k, vals)]
    for want in (jpack.scatter_add_rows(*args),        # Pallas, interpret
                 jpw.scatter_add_rows(*args), scatter_add_rows_ref(*args)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(want))


def test_scatter_add_rows_sums_repeated_rows_with_values():
    """Repeated rows that carry values all add (the kernel's atomics), as
    the jnp reference's scatter does.  The Pallas kernel is left out: its
    grid steps each read the row from its aliased input, so in interpret
    mode only the last repeat's write survives."""
    mat, sel_w, sel_k, vals = _pack_case(9, W=30, K=12, P=6, Pk=4)
    sel_w[3:] = sel_w[2]
    got = pack_ops.scatter_add_rows(*[torch.from_numpy(x.copy()) for x in
                                      (mat, sel_w, sel_k, vals)])
    want = jpw.scatter_add_rows(*[jnp.asarray(x) for x in
                                  (mat, sel_w, sel_k, vals)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_scatter_add_rows_drops_pairs_outside_the_matrix():
    mat, sel_w, sel_k, vals = _pack_case(2, W=20, K=8, P=4, Pk=3)
    sel_w[1] = 20                       # row past W
    sel_k[2, 0] = -1                    # column before 0
    want = mat.copy()
    for p in range(4):
        for j in range(3):
            if sel_w[p] < 20 and sel_k[p, j] >= 0:
                want[sel_w[p], sel_k[p, j]] += vals[p, j]
    got = pack_ops.scatter_add_rows(*[torch.from_numpy(x.copy()) for x in
                                      (mat, sel_w, sel_k, vals)])
    np.testing.assert_array_equal(got.numpy(), want)


def _train_case(seed, *, D, L, K, P, Pk, guard=0.5, empty_doc=False):
    """Training-mode carry inputs: power tokens on rows [0, P), the rest
    (a ``guard`` share) on the guard id P; a ragged last document (with
    ``empty_doc``, document 0 has no tokens at all); P distinct power words
    of a [W, K] phi with Pk distinct topics each."""
    rng = np.random.default_rng(seed)
    T = D * L
    W = 4 * P
    p_tok = rng.integers(0, P, T).astype(np.int32)
    p_tok[rng.random(T) < guard] = P
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    if empty_doc:
        doc_ids[doc_ids == 0] = 1
    counts = rng.integers(1, 4, (T, 1)).astype(np.float32)
    counts[(doc_ids == D - 1) & (np.tile(np.arange(L), D) >= L // 2)] = 0.0
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = (rng.random((W, K)) * 5).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    phi_tot = (phi[sel_w].sum(0) + 30.0).astype(np.float32)
    return p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k


@pytest.mark.parametrize("D,L,K,P,Pk,guard,empty_doc", [
    (6, 8, 20, 9, 5, 0.5, False),
    (4, 12, 100, 7, 50, 0.5, False),
    (3, 16, 130, 11, 8, 0.5, False),
    (4, 9, 40, 6, 1, 0.5, False),               # Pk = 1
    (3, 10, 40, 5, 40, 0.5, False),             # Pk = K
    (3, 8, 30, 4, 6, 1.0, False),               # all guard tokens
    (4, 8, 36, 6, 7, 0.3, True),                # an empty document
])
def test_carry_training_plain_matches_kblocked_oracle(D, L, K, P, Pk, guard,
                                                      empty_doc):
    """power_sweep_carry_train (plain on the CPU) against the reference's
    K-blocked oracle over the [P+1, K] phi and mask tables of the same
    selection, its [P, K] delta/residual rows read back at sel_k."""
    case = _train_case(D + K + Pk, D=D, L=L, K=K, P=P, Pk=Pk, guard=guard,
                       empty_doc=empty_doc)
    p_tok, doc_ids, counts, mu0, theta, phi_tot, phi, sel_w, sel_k = case
    kw = dict(alpha=ALPHA, beta=BETA, wbeta=0.3)
    phi_rows = np.zeros((P + 1, K), np.float32)
    phi_rows[:P] = phi[sel_w]
    mask = np.zeros((P + 1, K), np.float32)
    np.put_along_axis(mask[:P], sel_k, 1.0, axis=1)
    ref = power_sweep_carry_kblocked_ref(
        *[jnp.asarray(x) for x in (p_tok, doc_ids, counts, mu0, theta,
                                   phi_tot, phi_rows, mask)],
        update_phi=True, kb=32, **kw)
    want = [np.asarray(ref[0]), np.asarray(ref[1])] + [
        np.take_along_axis(np.asarray(r), sel_k, axis=1) for r in ref[2:4]]
    t = torch.from_numpy
    mu_t = t(mu0.copy())
    before = sweep_ops.power_sweep_carry_train.launches
    got = sweep_ops.power_sweep_carry_train(
        t(p_tok), t(doc_ids), t(counts), mu_t, *[t(x) for x in case[4:]],
        **kw)
    assert sweep_ops.power_sweep_carry_train.launches == before
    assert got[0] is mu_t                                   # in place
    for name, g, r in zip(("mu", "theta_delta", "d_pack", "r_pack"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    guard_tok = p_tok == P
    np.testing.assert_array_equal(mu_t.numpy()[guard_tok], mu0[guard_tok])
    off = mask[p_tok] == 0                     # unselected coordinates
    np.testing.assert_array_equal(mu_t.numpy()[off], mu0[off])
    # mass-conserving renorm: each token's mu still sums to 1
    np.testing.assert_allclose(mu_t.numpy().sum(1), 1.0, rtol=1e-5)
    if empty_doc:
        assert not got[1].numpy()[0].any()

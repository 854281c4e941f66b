"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the wrappers' checks, the serving engines on the card
against the same engines on the CPU, and the training step (carry and
packed sweep policies) on the card against the same step on the CPU.

Every test here carries the ``cuda`` marker and skips without a card.
The file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pobp
from repro_torch.core.types import LDAConfig
from repro_torch.data.batching import docs_to_padded
from repro_torch.data.synthetic import lda_corpus
from repro_torch.kernels.bp_update import ops as bp_ops
from repro_torch.kernels.power_pack import ops as pack_ops
from repro_torch.kernels.power_sweep import ops, packed
from repro_torch.serve import FoldInEngine, SlabEngine

pytestmark = pytest.mark.cuda
ALPHA = 0.1


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (on the card: pytest -m cuda)")


def _sweep_args(seed, *, D, L, K, W, device):
    """Serving-sweep inputs: ragged docs (c = 0 padding), 30% frozen
    tokens, doc 1 frozen whole, doc 2 (when D > 3) owning no slot, one
    out-of-range id (treated as frozen)."""
    rng = np.random.default_rng(seed)
    T = D * L
    p_tok = rng.integers(0, W, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    if D > 3:
        doc_ids[doc_ids == 2] = 1
    c = rng.integers(1, 4, T).astype(np.float32)
    c[np.tile(np.arange(L), D) >= np.repeat(rng.integers(1, L + 1, D), L)] = 0
    p_tok[(rng.random(T) < 0.3) | (doc_ids == 1)] = W
    p_tok[-1] = W + 5
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, c[:, None] * mu)
    phi = rng.random((W, K)).astype(np.float32)
    phi /= phi.sum(0, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [t(p_tok), t(doc_ids), t(c.reshape(T, 1)), t(mu), t(theta),
            torch.zeros(K, device=device), t(phi)]


@pytest.mark.parametrize("D,L,K,W", [
    (8, 12, 16, 150), (3, 7, 100, 50), (16, 64, 2000, 3000),
    (5, 1, 1, 20),            # one token a document, K = 1
    (5, 3, 37, 40),           # fewer tokens than the cluster's 4 CTAs
    (5, 4, 100, 40),          # as many
    (5, 5, 2000, 300),        # one more
    (4, 200, 100, 500),       # long documents
    (4, 16, 2048, 100),       # K at the register path's limit
    (4, 16, 2049, 100),       # one past it: the K-blocked path
    (4, 16, 8192, 100),
    (4, 16, 8193, 100),
    (4, 16, 10000, 100),      # the reference's second paper-scale K
    (3, 8, 20001, 30)])       # odd K far past the register path
def test_kernel_matches_plain_version_on_card(card, D, L, K, W):
    _check_serving_on_card(D, L, K, W)


@pytest.mark.parametrize("D,L,K,W", [
    (5, 1, 1, 20), (5, 3, 37, 40), (3, 7, 100, 50), (16, 64, 2000, 3000),
    (4, 16, 2048, 100)])
def test_kblocked_serving_path_matches_plain_version_on_card(
        card, monkeypatch, D, L, K, W):
    """The K-blocked serving path forced where the register path would
    run (the scalar path at K = 1 and 37, the 16-byte path elsewhere)."""
    monkeypatch.setattr(ops, "serve_launch_plan",
                        lambda K: ops.ServePlan("kblocked", 0, 256))
    _check_serving_on_card(D, L, K, W)


def _check_serving_on_card(D, L, K, W):
    kw = dict(alpha=ALPHA, beta=0.0, wbeta=1.0, n_guard=W)
    args = _sweep_args(D + K + L, D=D, L=L, K=K, W=W, device="cuda")
    mu0 = args[3].clone()
    plain_args = list(args)
    plain_args[3] = mu0.clone()
    before = ops.power_sweep_carry.launches
    got = ops.power_sweep_carry(*args, **kw)
    assert ops.power_sweep_carry.launches == before + 1
    want = ops.power_sweep_carry_plain(*plain_args, **kw)
    assert ops.power_sweep_carry.launches == before + 1
    torch.cuda.synchronize()
    assert got[0].data_ptr() == args[3].data_ptr()        # mu in place
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert float(got[2][1]) == 0.0 and not got[1][1].any()   # frozen doc
    if D > 3:
        assert float(got[2][2]) == 0.0 and not got[1][2].any()   # no slot
    frozen = args[0] >= W
    assert torch.equal(got[0][frozen], mu0[frozen])
    # deterministic: a second launch on the same inputs repeats bit for bit
    again = list(args)
    again[3] = mu0.clone()
    rerun = ops.power_sweep_carry(*again, **kw)
    for g, r in zip(got, rerun):
        assert torch.equal(g, r)


def test_kernel_limits_on_card(card):
    """Serving has no K limit: one past the register path serves through
    the K-blocked path and agrees with its plain version.  Training at its
    stated largest K runs and agrees; one past it raises ValueError before
    any launch."""
    K = ops.SERVE_REGISTER_MAX_K + 1
    assert ops.serve_launch_plan(K).path == "kblocked"
    _check_serving_on_card(2, 4, K, 20)
    for Pk in (1, 3):
        K = ops.power_sweep_carry_train_max_k(Pk)
        args = [x.to("cuda") for x in _train_args(K, D=2, L=4, K=K, P=3,
                                                   Pk=Pk)]
        kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
        plain = list(args)
        plain[3] = args[3].clone()
        got = ops.power_sweep_carry_train(*args, **kw,
                                          runs=_word_runs(args, 7))
        want = ops.power_sweep_carry_train_plain(*plain, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
        args = [x.to("cuda") for x in _train_args(K, D=2, L=4, K=K + 1, P=3,
                                                   Pk=Pk)]
        before = ops.power_sweep_carry_train.launches
        with pytest.raises(ValueError, match="training kernel takes"):
            ops.power_sweep_carry_train(*args, **kw,
                                        runs=_word_runs(args, 7))
        assert ops.power_sweep_carry_train.launches == before


def test_wrapper_checks_on_card(card):
    args = _sweep_args(0, D=2, L=4, K=8, W=10, device="cuda")
    kw = dict(alpha=ALPHA, beta=0.0, wbeta=1.0, n_guard=10)
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(ValueError, match="p_tok must be torch.int32"):
        ops.power_sweep_carry(*bad, **kw)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="phi_rows is on cpu"):
        ops.power_sweep_carry(*bad, **kw)
    targs = [x.to("cuda") for x in _train_args(0, D=2, L=4, K=8, P=3, Pk=2)]
    tkw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3,
               runs=_word_runs(targs, 7))
    bad = list(targs)
    bad[7] = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="sel_w must have shape"):
        ops.power_sweep_carry_train(*bad, **tkw)
    bad = list(targs)
    bad[8] = targs[8].long()
    with pytest.raises(ValueError, match="sel_k must be torch.int32"):
        ops.power_sweep_carry_train(*bad, **tkw)
    with pytest.raises(ValueError, match="runs by word on CUDA"):
        ops.power_sweep_carry_train(*targs, **dict(tkw, runs=None))
    bp = [x.to("cuda") for x in _bp_args(0, D=2, L=4, K=8, W=10)]
    bad = list(bp)
    bad[3] = bp[3].t().contiguous().t()
    with pytest.raises(ValueError, match="mu_t must be contiguous"):
        bp_ops.bp_update(*bad, alpha=ALPHA, beta=0.01, wbeta=0.1)
    mat, sel_w, sel_k, vals = [x.to("cuda") for x in _pack_args(0, W=10, K=8,
                                                                 P=3, Pk=2)]
    with pytest.raises(ValueError, match="sel_k must be torch.int32"):
        pack_ops.scatter_add_rows(mat, sel_w, sel_k.long(), vals)


def _bp_args(seed, *, D, L, K, W, junk_pad_mu=False):
    """Dense-sweep inputs: ragged docs (c = 0 padding on word 0); with
    ``junk_pad_mu`` the padding slots' mu is not a distribution (finite,
    some of it negative), which the sweep must ignore."""
    rng = np.random.default_rng(seed)
    T = D * L
    word_ids = rng.integers(0, W, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    c = rng.integers(1, 4, T).astype(np.float32)
    pad = np.tile(np.arange(L), D) >= np.repeat(rng.integers(1, L + 1, D), L)
    c[pad], word_ids[pad] = 0.0, 0
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    if junk_pad_mu:
        mu[pad] = (rng.random((int(pad.sum()), K)) * 7 - 2).astype(np.float32)
    counts = c.reshape(T, 1)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = (rng.random((W, K)) * 3).astype(np.float32)
    np.add.at(phi, word_ids, counts * mu)
    return [torch.from_numpy(x) for x in
            (word_ids, doc_ids, counts, mu, theta, phi, phi.sum(0))]


@pytest.mark.parametrize("D,L,K,W", [
    (4, 8, 128, 60), (3, 7, 100, 40), (64, 128, 2000, 20000),
    (5, 3, 1, 20),            # K = 1: one thread's scalar loads
    (3, 7, 513, 40),          # 5 warps, the last one mostly idle
    (3, 7, 1999, 50),         # K not a multiple of 4: scalar loads
    (4, 16, 2048, 100),       # the register path's limit
    (4, 16, 2049, 100),       # one past it: the two-pass path
    (4, 16, 10000, 100)])     # the reference's second paper-scale K
def test_bp_update_kernel_matches_plain_version_on_card(card, D, L, K, W):
    _check_bp_update_on_card(D, L, K, W)


@pytest.mark.parametrize("D,L,K,W", [
    (5, 3, 1, 20), (3, 7, 100, 40), (3, 7, 1999, 50), (64, 128, 2000, 20000)])
def test_bp_update_twopass_path_matches_plain_version_on_card(
        card, monkeypatch, D, L, K, W):
    """The two-pass path forced where the register path would run."""
    monkeypatch.setattr(bp_ops, "bp_launch_plan",
                        lambda K: bp_ops.BpPlan("twopass", 256))
    _check_bp_update_on_card(D, L, K, W)


def _check_bp_update_on_card(D, L, K, W):
    """The kernel against its plain version, with count-0 slots whose mu is
    not a distribution; a second launch repeats mu' and r bit for bit."""
    args = [x.to("cuda") for x in _bp_args(D + K, D=D, L=L, K=K, W=W,
                                           junk_pad_mu=True)]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=W * 0.01)
    before = bp_ops.bp_update.launches
    got = bp_ops.bp_update(*args, **kw)
    assert bp_ops.bp_update.launches == before + 1
    want = bp_ops.bp_update_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    rerun = bp_ops.bp_update(*args, **kw)
    for g, r in zip(got, rerun):
        assert torch.equal(g, r)


def _word_runs(args, W):
    """The tokens' runs by word, as the step makes them: a power token's
    word is its row's sel_w, a guard token's a word outside the selection."""
    from repro_torch.core.types import token_runs

    p_tok, counts, sel_w = args[0], args[2], args[7]
    P = sel_w.shape[0]
    other = int(np.setdiff1d(np.arange(W), sel_w.cpu().numpy())[0])
    words = torch.where(p_tok < P, sel_w[p_tok.clamp(max=P - 1).long()],
                        other)
    return token_runs(words, counts, W)


def _train_args(seed, *, D, L, K, P, Pk, guard=0.5, empty_doc=False):
    """Training-mode carry inputs: tokens on power rows [0, P) or (a
    ``guard`` share) the guard id P, a ragged last document (with
    ``empty_doc``, document 1 owns no slot), P distinct power words of a
    [W, K] phi with Pk distinct topics each."""
    rng = np.random.default_rng(seed)
    T = D * L
    W = 2 * P + 1
    p_tok = rng.integers(0, P, T).astype(np.int32)
    p_tok[rng.random(T) < guard] = P
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    if empty_doc:
        doc_ids[doc_ids == 1] = 0
    counts = rng.integers(1, 4, (T, 1)).astype(np.float32)
    counts[(doc_ids == D - 1) & (np.tile(np.arange(L), D) >= L // 2)] = 0.0
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi = (rng.random((W, K)) * 5).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.argsort(rng.random((P, K)), axis=1)[:, :Pk].astype(np.int32)
    phi_tot = (phi[sel_w].sum(0) + 30.0).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (p_tok, doc_ids, counts, mu, theta, phi_tot, phi, sel_w, sel_k)]


@pytest.mark.parametrize("D,L,K,P,Pk,guard,empty_doc", [
    (6, 8, 20, 9, 5, 0.5, False), (4, 12, 100, 7, 50, 0.5, False),
    (64, 128, 2000, 1400, 50, 0.3, False),
    (4, 6, 1, 5, 1, 0.5, False),                # K = 1
    (5, 7, 37, 6, 37, 0.5, False),              # Pk = K = 37
    (4, 16, 8192, 50, 50, 0.5, False),          # K = 8192
    (6, 1, 100, 9, 5, 0.5, False),              # one token a document
    (3, 200, 100, 20, 10, 0.3, True),           # long documents, one empty
    (3, 8, 40, 4, 6, 1.0, False)])              # all guard tokens
def test_carry_training_kernel_matches_plain_version_on_card(
        card, D, L, K, P, Pk, guard, empty_doc):
    args = [x.to("cuda") for x in _train_args(D + K + Pk, D=D, L=L, K=K,
                                              P=P, Pk=Pk, guard=guard,
                                              empty_doc=empty_doc)]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    mu0 = args[3].clone()
    plain = list(args)
    plain[3] = mu0.clone()
    kw["runs"] = _word_runs(args, 2 * P + 1)
    before = ops.power_sweep_carry_train.launches
    got = ops.power_sweep_carry_train(*args, **kw)
    assert ops.power_sweep_carry_train.launches == before + 1
    want = ops.power_sweep_carry_train_plain(*plain, **kw)
    assert ops.power_sweep_carry_train.launches == before + 1
    torch.cuda.synchronize()
    assert got[0].data_ptr() == args[3].data_ptr()        # mu in place
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    # theta_delta and the packs, summed in another order: rel 1e-4 of
    # their scale
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(
            g, w, rtol=1e-4, atol=1e-4 * max(float(w.abs().max()), 1e-30))
    # untouched coordinates (guard tokens, unselected topics), bit for bit
    p_tok, sel_k = args[0].long(), args[8].long()
    selected = torch.zeros_like(mu0, dtype=torch.bool)
    rows = (p_tok < P).nonzero().squeeze(1)
    selected[rows[:, None], sel_k[p_tok[rows]]] = True
    assert torch.equal(got[0][~selected], mu0[~selected])
    if empty_doc:
        assert not got[1][1].any()
    # all four outputs repeat bit for bit from launch to launch
    again = list(args)
    again[3] = mu0.clone()
    rerun = ops.power_sweep_carry_train(*again, **kw)
    assert all(torch.equal(r, g) for r, g in zip(rerun, got))


def _pack_args(seed, *, W, K, P, Pk):
    rng = np.random.default_rng(seed)
    mat = (rng.random((W, K)) * 4).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.argsort(rng.random((P, K)), axis=1)[:, :Pk].astype(np.int32)
    vals = rng.standard_normal((P, Pk)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (mat, sel_w, sel_k, vals)]


@pytest.mark.parametrize("W,K,P,Pk", [(50, 16, 8, 4), (40, 100, 12, 50),
                                      (20000, 2000, 2000, 50)])
def test_scatter_add_rows_kernel_matches_plain_version_on_card(card, W, K,
                                                               P, Pk):
    mat, sel_w, sel_k, vals = [x.to("cuda") for x in
                               _pack_args(W + K, W=W, K=K, P=P, Pk=Pk)]
    want = pack_ops.scatter_add_rows_plain(mat.clone(), sel_w, sel_k, vals)
    before = pack_ops.scatter_add_rows.launches
    got = pack_ops.scatter_add_rows(mat, sel_w, sel_k, vals)
    assert got is mat and pack_ops.scatter_add_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)              # unique pairs: exact
    # repeated rows with values all add
    sel_w[1:] = sel_w[0]
    want = pack_ops.scatter_add_rows_plain(mat.clone(), sel_w, sel_k, vals)
    got = pack_ops.scatter_add_rows(mat, sel_w, sel_k, vals)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _packed_args(seed, *, D, L, K, P, Pk, guard, long_row=False):
    """Packed-sweep inputs: tokens on power rows [0, P) or (a ``guard``
    share, and the whole document 0) the guard id P, a ragged last
    document, Pk distinct topics per power row, phi_pack above each
    token's own count.  With ``long_row`` every document's second half is
    padding on row 0 (count 0) and a third of the counted tokens is on
    row 0 too: one run of counted tokens spanning many chunks of 32, and
    count-0 power tokens that the sweep updates but that add nothing."""
    rng = np.random.default_rng(seed)
    T = D * L
    p_tok = rng.integers(0, P, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    counts = rng.integers(1, 4, (T, 1)).astype(np.float32)
    if long_row:
        pad = np.tile(np.arange(L), D) >= L // 2
        p_tok[(rng.random(T) < 0.3) | pad] = 0
        counts[pad] = 0.0
    p_tok[(rng.random(T) < guard) | (doc_ids == 0)] = P
    counts[(doc_ids == D - 1) & (np.tile(np.arange(L), D) >= L // 2)] = 0.0
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi_tot = (rng.random(K) * 50 + 30).astype(np.float32)
    phi_pack = (rng.random((P, Pk)) * 5 + 3).astype(np.float32)
    sel_k = np.argsort(rng.random((P, K)), axis=1)[:, :Pk].astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k)]


@pytest.mark.parametrize("D,L,K,P,Pk,guard,long_row", [
    (6, 8, 20, 9, 5, 0.3, False), (4, 12, 100, 7, 100, 0.3, False),  # Pk = K
    (3, 16, 64, 5, 37, 1.0, False),                       # all guard
    (64, 128, 2000, 1400, 50, 0.3, False),
    (8, 16, 40, 6, 1, 0.3, False),                        # Pk = 1
    (16, 24, 100, 30, 37, 0.3, True),                     # Pk = 37, long row
    (128, 128, 2000, 1400, 50, 0.3, True),                # slice's Pk, long row
    (48, 32, 300, 20, 300, 0.2, True)])                   # Pk = K > 128
def test_power_sweep_tokens_kernel_matches_plain_version_on_card(
        card, D, L, K, P, Pk, guard, long_row):
    args = [x.to("cuda") for x in _packed_args(D + K + Pk, D=D, L=L, K=K, P=P,
                                               Pk=Pk, guard=guard,
                                               long_row=long_row)]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    mu0 = args[3].clone()
    theta0 = args[4].clone()
    plain = list(args)
    plain[3] = mu0.clone()
    before = packed.power_sweep_tokens.launches
    got = packed.power_sweep_tokens(*args, **kw)
    assert packed.power_sweep_tokens.launches == before + 1
    want = packed.power_sweep_tokens_plain(*plain, **kw)
    assert packed.power_sweep_tokens.launches == before + 1
    torch.cuda.synchronize()
    assert got[0].data_ptr() == args[3].data_ptr()          # mu in place
    assert torch.equal(args[4], theta0)                     # theta read only
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    # theta_delta and the atomically summed packed rows: rel 1e-5 of scale
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-5 * max(float(w.abs().max()), 1e-30))
    # untouched coordinates, bit for bit
    p_tok, sel_k = args[0].long(), args[7].long()
    selected = torch.zeros_like(mu0, dtype=torch.bool)
    rows = (p_tok < P).nonzero().squeeze(1)
    selected[rows[:, None], sel_k[p_tok[rows]]] = True
    assert torch.equal(got[0][~selected], mu0[~selected])
    if guard == 1.0:
        assert torch.equal(got[0], mu0) and not got[1].any()
        assert not got[2].any() and not got[3].any()
    # no atomics: all four outputs repeat bit for bit from launch to launch
    again = list(args)
    again[3] = mu0.clone()
    rerun = packed.power_sweep_tokens(*again, **kw)
    for g, r in zip(got, rerun):
        assert torch.equal(g, r)


@pytest.mark.parametrize("W,K,P,Pk", [(50, 16, 8, 4), (40, 100, 12, 100),
                                      (20000, 2000, 1400, 50),
                                      (30, 70, 11, 1), (500, 300, 97, 37)])
def test_pack_rows_kernel_matches_plain_version_on_card(card, W, K, P, Pk):
    mat, sel_w, sel_k, _ = [x.to("cuda") for x in
                            _pack_args(W + K, W=W, K=K, P=P, Pk=Pk)]
    if P > 4:
        sel_k[3, 0] = K                     # a column outside mat packs to 0
        sel_k[2, -1] = -1                   # so does one before column 0
        sel_w[4] = W                        # and every pair of a row past W
    before = pack_ops.pack_rows.launches
    got = pack_ops.pack_rows(mat, sel_w, sel_k)
    assert pack_ops.pack_rows.launches == before + 1
    want = pack_ops.pack_rows_plain(mat, sel_w, sel_k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)                          # exact
    if P > 4:
        assert float(got[3, 0]) == 0.0 and float(got[2, -1]) == 0.0
        assert not got[4].any()


def test_packed_wrapper_checks_on_card(card):
    args = [x.to("cuda") for x in _packed_args(0, D=2, L=4, K=8, P=3, Pk=2,
                                                guard=0.3)]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    bad = list(args)
    bad[7] = args[7].long()
    with pytest.raises(ValueError, match="sel_k must be torch.int32"):
        packed.power_sweep_tokens(*bad, **kw)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="phi_pack is on cpu"):
        packed.power_sweep_tokens(*bad, **kw)
    bad = list(args)
    bad[6] = torch.ones((4, 2), device="cuda")
    with pytest.raises(ValueError, match="phi_pack must have shape"):
        packed.power_sweep_tokens(*bad, **kw)
    mat, sel_w, sel_k, _ = [x.to("cuda") for x in _pack_args(0, W=10, K=8,
                                                              P=3, Pk=2)]
    with pytest.raises(ValueError, match="sel_w must be torch.int32"):
        pack_ops.pack_rows(mat, sel_w.long(), sel_k)
    with pytest.raises(ValueError, match="sel_k must be contiguous"):
        pack_ops.pack_rows(mat, sel_w, sel_k.t().contiguous().t())


def _numpy_batches(W, K):
    rng = np.random.default_rng(0)
    batches = []
    for m in range(3):
        docs, _, _ = lda_corpus(10 + m, 32, W, K, doc_len_mean=40)
        mb = docs_to_padded(docs, max_len=32)
        batches.append((mb, rng.uniform(0.01, 1.0, (32, 32, K)
                                        ).astype(np.float32)))
    return batches


def test_packed_train_step_on_card_matches_cpu_step(card):
    """Three POBP steps with ``sweep_policy="packed"`` on the card (the
    dense sweep, the phi pack, the packed sweep and the scatter kernels)
    and on the CPU (the plain versions) from the same numpy-drawn inits:
    iterations equal, rel 1e-3."""
    W, K = 500, 64
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=8,
                    inner_iters=8, residual_tol=0.05, sweep_policy="packed")
    counters = ((bp_ops.bp_update, "launches"),
                (pack_ops.pack_rows, "launches"),
                (packed.power_sweep_tokens, "launches"),
                (pack_ops.scatter_add_rows, "launches"),
                (ops.power_sweep_carry_train, "launches"))
    res = {}
    for device in ("cpu", "cuda"):
        step, _ = pobp.make_train_step(cfg, device=device)
        state = pobp.init_train_state(cfg, device=device)
        before = [getattr(f, a) for f, a in counters]
        trace = []
        for mb, u0 in _numpy_batches(W, K):
            state, diag = step(state, mb.word_ids, mb.counts,
                               u0=torch.from_numpy(u0))
            trace.append((diag["iters"], float(diag["mean_r"])))
        res[device] = (state.phi_acc.cpu(), trace,
                       [getattr(f, a) - b
                        for (f, a), b in zip(counters, before)])
    sweeps = sum(it - 1 for it, _ in res["cuda"][1])
    assert res["cpu"][2] == [0, 0, 0, 0, 0]
    assert res["cuda"][2] == [3, sweeps, sweeps, sweeps, 0] and sweeps > 0
    for (it_c, r_c), (it_g, r_g) in zip(res["cpu"][1], res["cuda"][1]):
        assert it_c == it_g
        assert r_g == pytest.approx(r_c, rel=1e-3)
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-3,
                               atol=1e-3)


def test_train_step_on_card_matches_cpu_step(card):
    """Three POBP steps on the card (the three kernels) and on the CPU
    (the plain versions) from the same numpy-drawn inits."""
    W, K = 500, 64
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=8,
                    inner_iters=8, residual_tol=0.05)
    _, _, true_phi = lda_corpus(4, 1, W, K)
    rng = np.random.default_rng(0)
    batches = []
    for m in range(3):
        docs, _, _ = lda_corpus(10 + m, 32, W, K, doc_len_mean=40)
        mb = docs_to_padded(docs, max_len=32)
        batches.append((mb, rng.uniform(0.01, 1.0, (32, 32, K)
                                        ).astype(np.float32)))
    res = {}
    for device in ("cpu", "cuda"):
        step, _ = pobp.make_train_step(cfg, device=device)
        state = pobp.init_train_state(cfg, device=device)
        before = (bp_ops.bp_update.launches,
                  ops.power_sweep_carry_train.launches,
                  pack_ops.scatter_add_rows.launches)
        trace = []
        for mb, u0 in batches:
            state, diag = step(state, mb.word_ids, mb.counts,
                               u0=torch.from_numpy(u0))
            trace.append((diag["iters"], float(diag["mean_r"])))
        after = (bp_ops.bp_update.launches,
                 ops.power_sweep_carry_train.launches,
                 pack_ops.scatter_add_rows.launches)
        res[device] = (state.phi_acc.cpu(), trace,
                       [a - b for a, b in zip(after, before)])
    sweeps = sum(it - 1 for it, _ in res["cuda"][1])
    assert res["cpu"][2] == [0, 0, 0]
    assert res["cuda"][2] == [3, sweeps, sweeps] and sweeps > 0
    for (it_c, r_c), (it_g, r_g) in zip(res["cpu"][1], res["cuda"][1]):
        assert it_c == it_g
        assert r_g == pytest.approx(r_c, rel=1e-3)
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-3,
                               atol=1e-3)


def _replay_numpy_init(eng, seed):
    """Feed an engine's slab step the same numpy-drawn inits on every
    device, so a CPU engine and a card engine start from one init."""
    rng = np.random.default_rng(seed)
    step = eng._step
    shape = (eng._refill_cap, eng.slot_len, eng._K)

    def replayed(*args, **kw):
        u = rng.uniform(0.01, 1.0, shape).astype(np.float32)
        kw["init_u"] = torch.from_numpy(u).to(eng.device)
        return step(*args, **kw)

    eng._step = replayed


def test_slab_engine_on_card_matches_cpu_engine(card):
    W, K = 400, 64
    docs, _, true_phi = lda_corpus(1, 40, W, K, doc_len_mean=30)
    phi_acc = (true_phi.T * 200.0).astype(np.float32)
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    kw = dict(slots=8, slot_len=64, sweeps_per_step=2, fold_iters=30,
              residual_tol=1e-2, pipeline=0)
    res = {}
    for device in ("cpu", "cuda"):
        eng = SlabEngine(phi_acc, cfg, device=device, **kw)
        _replay_numpy_init(eng, 3)
        for d in docs:
            eng.submit(d)
        res[device] = {r.req_id: r for r in eng.drain()}
    assert sorted(res["cuda"]) == sorted(res["cpu"]) == list(range(40))
    for rid, want in res["cpu"].items():
        got = res["cuda"][rid]
        assert got.iters == want.iters, rid
        np.testing.assert_allclose(got.theta, want.theta, rtol=1e-4,
                                   atol=1e-6)


def test_engines_serve_on_card_with_pipelined_harvest(card):
    W, K = 300, 32
    docs, _, true_phi = lda_corpus(2, 48, W, K, doc_len_mean=25)
    phi_acc = (true_phi.T * 200.0).astype(np.float32)
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    before = ops.power_sweep_carry.launches
    slab = SlabEngine(phi_acc, cfg, slots=8, slot_len=64, pipeline=4,
                      device="cuda")
    bucket = FoldInEngine(phi_acc, cfg, len_buckets=(32, 64), batch_docs=8,
                          device="cuda")
    for eng in (slab, bucket):
        ids = [eng.submit(d) for d in docs]
        res = eng.drain()
        assert sorted(r.req_id for r in res) == sorted(ids)
        th = np.stack([r.theta for r in res])
        assert np.isfinite(th).all()
        np.testing.assert_allclose(th.sum(axis=1), 1.0, atol=1e-5)
    assert ops.power_sweep_carry.launches > before


# ------------------------------------------------ the training step repeats

@pytest.mark.parametrize("D,L,K,P,Pk", [
    (512, 128, 2000, 14104, 50),                # the training slice's shapes
    (5, 7, 37, 6, 37), (4, 16, 8192, 50, 50), (3, 8, 1, 4, 1),
    (6, 9, 999, 13, 33)])                       # odd K and Pk
def test_carry_training_dr_repeat_bit_for_bit_on_card(card, D, L, K, P, Pk):
    """The carry training sweep's d/r sums run in a fixed order: three
    launches with the step's runs by word give the same four outputs bit
    for bit."""
    args = [x.to("cuda") for x in _train_args(D + P, D=D, L=L, K=K, P=P,
                                              Pk=Pk, guard=0.3)]
    runs = _word_runs(args, 2 * P + 1)
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    outs = []
    for r in (runs, runs, runs):
        a = list(args)
        a[3] = args[3].clone()
        outs.append(ops.power_sweep_carry_train(*a, **kw, runs=r))
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.parametrize("T,K,W", [(65536, 2000, 141043), (21, 37, 5),
                                   (256, 10000, 50)])
def test_word_rows_sum_matches_cpu_bit_for_bit_on_card(card, T, K, W):
    from repro_torch.core.types import token_runs
    from repro_torch.kernels.segment_sum import ops as seg

    rng = np.random.default_rng(T + K)
    words = (rng.random(T) ** 4 * W).astype(np.int32)
    counts = rng.integers(0, 3, (T, 1)).astype(np.float32)
    words[counts[:, 0] == 0] = 0
    values = counts * rng.random((T, K)).astype(np.float32)
    runs = token_runs(torch.from_numpy(words), torch.from_numpy(counts), W)
    want = seg.word_rows_sum_plain(*runs, torch.from_numpy(values), W)
    before = seg.word_rows_sum.launches
    got = seg.word_rows_sum(*[r.cuda() for r in runs],
                            torch.from_numpy(values).cuda(), W)
    again = seg.word_rows_sum(*[r.cuda() for r in runs],
                              torch.from_numpy(values).cuda(), W)
    assert seg.word_rows_sum.launches == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


@pytest.mark.parametrize("P,Pk,K", [(14104, 50, 2000), (9, 1, 100),
                                    (9, 37, 37), (300, 50, 10000)])
def test_topic_sum_matches_plain_version_on_card(card, P, Pk, K):
    from repro_torch.kernels.segment_sum import ops as seg

    rng = np.random.default_rng(P + K)
    sel_k = torch.from_numpy(np.argsort(rng.random((P, K)), axis=1)[
        :, :Pk].astype(np.int32).copy())
    vals = torch.from_numpy(rng.standard_normal((P, Pk)).astype(np.float32))
    base = torch.from_numpy((rng.random(K) * 100).astype(np.float32))
    want = seg.topic_sum_plain(sel_k, vals, base)
    got = seg.topic_sum(sel_k.cuda(), vals.cuda(), base.cuda())
    again = seg.topic_sum(sel_k.cuda(), vals.cuda(), base.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


def test_restored_cuda_generator_draws_the_same_init(card):
    """get_state/set_state on a CUDA generator restore its seed and offset:
    the restored generator draws what the uninterrupted one draws, and its
    initial_seed (the stochastic rounding's seed) survives."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    torch.rand((7, 33), generator=g, device="cuda")
    saved = g.get_state()
    want = torch.rand((16, 32, 64), generator=g, device="cuda")
    h = torch.Generator(device="cuda").manual_seed(99)
    h.set_state(saved)
    assert h.initial_seed() == 1234
    assert torch.equal(torch.rand((16, 32, 64), generator=h, device="cuda"),
                       want)


@pytest.mark.parametrize("policy,dtype", [("auto", "float32"),
                                          ("packed", "float32"),
                                          ("auto", "bfloat16")])
def test_train_step_repeats_bit_for_bit_on_card(card, policy, dtype):
    """One mini-batch run twice from one state, the generator's state put
    back in between: phi_acc, theta, mean_r and iterations equal bit for
    bit on both policies (every sum in a fixed order) and with a bf16
    phi_acc (the rounding's dither from a generator of its own)."""
    W, K = 3000, 128
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=16,
                    inner_iters=30, residual_tol=0.02, sweep_policy=policy,
                    phi_acc_dtype=dtype)
    step, _ = pobp.make_train_step(cfg, device="cuda")
    state = pobp.init_train_state(cfg, 3, device="cuda")
    docs, _, _ = lda_corpus(5, 64, W, K, doc_len_mean=60)
    mb = docs_to_padded(docs, max_len=64)
    state, _ = step(state, mb.word_ids, mb.counts)
    saved = state.generator.get_state()
    runs = []
    for _ in range(2):
        state.generator.set_state(saved)
        new, diag = step(state, mb.word_ids, mb.counts)
        runs.append((new.phi_acc, diag["theta"], float(diag["mean_r"]),
                     diag["iters"]))
    (pa, ta, ra, ia), (pb, tb, rb, ib) = runs
    assert ia == ib and ia > 2 and ra == rb
    assert torch.equal(pa, pb) and torch.equal(ta, tb)
    assert pa.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)


def test_crash_resume_through_the_driver_on_card(card, tmp_path):
    """``--crash-at`` then the same command again on the card: the resumed
    run ends where the uninterrupted one ends, bit for bit."""
    from repro_torch.launch import lda_train

    def args(ck, *extra):
        return lda_train.build_parser().parse_args([
            "--minibatches", "5", "--docs-per-batch", "32", "--vocab", "600",
            "--topics", "32", "--lambda-k", "8", "--inner-iters", "20",
            "--tol", "0.02", "--log-every", "0", "--ckpt-every", "2",
            "--ckpt-dir", str(ck), "--device", "cuda", *extra])

    full = lda_train.train_loop(args(tmp_path / "a"))
    with pytest.raises(SystemExit):
        lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    resumed = lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    assert resumed["first_m"] == 2
    assert resumed["mean_r"] == full["mean_r"][2:]
    assert resumed["iters"] == full["iters"][2:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])

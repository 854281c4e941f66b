"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the wrappers' checks, the serving engines on the card
against the same engines on the CPU (and placed on a 1 x 1 NCCL mesh
against the unplaced engine), and the training step (carry and
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
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.data.batching import docs_to_padded
from repro_torch.data.synthetic import lda_corpus
from repro_torch.kernels import launch_counts
from repro_torch.kernels.bp_update import ops as bp_ops
from repro_torch.kernels.power_pack import ops as pack_ops
from repro_torch.kernels.power_sweep import ops, packed
from repro_torch.kernels.power_topics import ops as topics_ops
from repro_torch.kernels.token_order import FOLD_CHUNK
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
    before = launch_counts()["power_sweep_carry"]
    got = ops.power_sweep_carry(*args, **kw)
    assert launch_counts()["power_sweep_carry"] == before + 1
    want = ops.power_sweep_carry_plain(*plain_args, **kw)
    assert launch_counts()["power_sweep_carry"] == before + 1
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
                                          **_word_runs(args, 7))
        want = ops.power_sweep_carry_train_plain(*plain, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
        args = [x.to("cuda") for x in _train_args(K, D=2, L=4, K=K + 1, P=3,
                                                   Pk=Pk)]
        before = launch_counts()["power_sweep_carry_train"]
        with pytest.raises(ValueError, match="training kernel takes"):
            ops.power_sweep_carry_train(*args, **kw,
                                        **_word_runs(args, 7))
        assert launch_counts()["power_sweep_carry_train"] == before


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
    tkw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3, **_word_runs(targs, 7))
    bad = list(targs)
    bad[7] = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="sel_w must have shape"):
        ops.power_sweep_carry_train(*bad, **tkw)
    bad = list(targs)
    bad[8] = targs[8].long()
    with pytest.raises(ValueError, match="sel_k must be torch.int32"):
        ops.power_sweep_carry_train(*bad, **tkw)
    with pytest.raises(ValueError, match="runs by word and their chunks"):
        ops.power_sweep_carry_train(*targs, **dict(tkw, runs=None))
    with pytest.raises(ValueError, match="runs by word and their chunks"):
        ops.power_sweep_carry_train(*targs, **dict(tkw, chunks=None))
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
    before = launch_counts()["bp_update"]
    got = bp_ops.bp_update(*args, **kw)
    assert launch_counts()["bp_update"] == before + 1
    want = bp_ops.bp_update_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    rerun = bp_ops.bp_update(*args, **kw)
    for g, r in zip(got, rerun):
        assert torch.equal(g, r)


def _word_runs(args, W):
    """The tokens' runs by word and their chunks, as the step makes them
    (keywords of ``power_sweep_carry_train``): a power token's word is its
    row's sel_w, a guard token's a word outside the selection."""
    from repro_torch.kernels.token_order import token_chunks, token_runs

    p_tok, counts, sel_w = args[0], args[2], args[7]
    P = sel_w.shape[0]
    other = int(np.setdiff1d(np.arange(W), sel_w.cpu().numpy())[0])
    words = torch.where(p_tok < P, sel_w[p_tok.clamp(max=P - 1).long()],
                        other)
    runs = token_runs(words, counts, W)
    return dict(runs=runs, chunks=token_chunks(runs[1]))


def _train_args(seed, *, D, L, K, P, Pk, guard=0.5, empty_doc=False,
                skew=False, padded=False):
    """Training-mode carry inputs: tokens on power rows [0, P) or (a
    ``guard`` share) the guard id P, a ragged last document (with
    ``empty_doc``, document 1 owns no slot), P distinct power words of a
    [W, K] phi with Pk distinct topics each.  With ``skew`` (P >= 6), the
    runs of the d/r fold's edges: row 0 has the first slot of every
    document (a run of D counted tokens), rows 1, 2 and 3 runs of exactly
    C = FOLD_CHUNK, C + 1 and 1 counted tokens, row 4 none.  With
    ``padded``, every document is ragged as the training cells' batches
    are: the slots past its length carry count 0 on power row 0, the head
    word's."""
    rng = np.random.default_rng(seed)
    T = D * L
    W = 2 * P + 1
    p_tok = rng.integers(5 if skew else 0, P, T).astype(np.int32)
    p_tok[rng.random(T) < guard] = P
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    if empty_doc:
        doc_ids[doc_ids == 1] = 0
    counts = rng.integers(1, 4, (T, 1)).astype(np.float32)
    counts[(doc_ids == D - 1) & (np.tile(np.arange(L), D) >= L // 2)] = 0.0
    if padded:
        pad = np.tile(np.arange(L), D) >= np.repeat(rng.integers(1, L + 1, D),
                                                    L)
        counts[pad] = 0.0
        p_tok[pad] = 0
    if skew:
        C = FOLD_CHUNK
        head = np.tile(np.arange(L), D) == 0
        p_tok[head] = 0
        pick = rng.choice(np.flatnonzero(~head & (counts[:, 0] > 0)),
                          2 * C + 2, replace=False)
        p_tok[pick[:C]] = 1
        p_tok[pick[C:2 * C + 1]] = 2
        p_tok[pick[2 * C + 1]] = 3
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


@pytest.mark.parametrize("D,L,K,P,Pk,guard,empty_doc,skew", [
    (6, 8, 20, 9, 5, 0.5, False, False),
    (4, 12, 100, 7, 50, 0.5, False, False),
    (64, 128, 2000, 1400, 50, 0.3, False, False),
    (4, 6, 1, 5, 1, 0.5, False, False),         # K = 1
    (5, 7, 37, 6, 37, 0.5, False, False),       # Pk = K = 37
    (4, 16, 8192, 50, 50, 0.5, False, False),   # K = 8192
    (6, 1, 100, 9, 5, 0.5, False, False),       # one token a document
    (3, 200, 100, 20, 10, 0.3, True, False),    # long documents, one empty
    (3, 8, 40, 4, 6, 1.0, False, False),        # all guard tokens
    # a word in every document, runs of C, C + 1, 1 and no token
    (4096, 8, 50, 64, 50, 0.3, False, True),
    (600, 4, 200, 9, 100, 0.3, False, True),    # Pk past one pass of 64
    (100, 4, 20, 9, 5, 0.5, True, True)])       # the head run cut once
def test_carry_training_kernel_matches_plain_version_on_card(
        card, D, L, K, P, Pk, guard, empty_doc, skew):
    _check_carry_training_on_card(
        _train_args(D + K + Pk, D=D, L=L, K=K, P=P, Pk=Pk, guard=guard,
                    empty_doc=empty_doc, skew=skew), empty_doc=empty_doc,
        skew=skew)


@pytest.mark.parametrize("Pk", [1, 31, 32, 33, 50, 64, 65, 128, 129])
def test_carry_training_kernel_each_topic_path_on_card(card, Pk):
    """Each count of topics a lane holds (J = 1 to 4: Pk up to 32, 64, 96,
    128) at its edges, and the strided loop past 128, on ragged documents
    whose padding sits on a power row."""
    _check_carry_training_on_card(
        _train_args(Pk, D=24, L=32, K=300, P=40, Pk=Pk, guard=0.3,
                    padded=True))


@pytest.mark.parametrize("D,L,K,P,Pk", [
    (64, 128, 2000, 1400, 50),      # the k2000 cell's widths
    (16, 128, 10000, 700, 50),      # the k10000 cell's widths
    (64, 128, 2000, 1400, 129)])    # the loop path
def test_carry_training_kernel_on_padding_of_a_power_row_on_card(
        card, D, L, K, P, Pk):
    """The cells' batches: every document ragged, its padding slots (count
    0) on power row 0, so they are updated as power tokens and add exact
    zeros to theta_delta."""
    _check_carry_training_on_card(
        _train_args(D + K, D=D, L=L, K=K, P=P, Pk=Pk, guard=0.2,
                    padded=True))


@pytest.mark.parametrize("Pk", [1, 50, 129])
def test_carry_training_kernel_at_its_largest_k_on_card(card, Pk):
    """K at ``power_sweep_carry_train_max_k(Pk)``: the document's theta
    row fills the shared memory a CTA may take."""
    K = ops.power_sweep_carry_train_max_k(Pk)
    _check_carry_training_on_card(
        _train_args(K + Pk, D=3, L=6, K=K, P=4, Pk=Pk, guard=0.2))


def _check_carry_training_on_card(host_args, *, empty_doc=False, skew=False):
    """The training sweep on the card against its plain version: mu' within
    1e-5, theta_delta and the packs within rel 1e-4 of their scale, mu
    in place and bit for bit as it was outside the power tokens' topics, a
    second launch repeating all four outputs bit for bit."""
    args = [x.to("cuda") for x in host_args]
    P = args[7].shape[0]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    mu0 = args[3].clone()
    plain = list(args)
    plain[3] = mu0.clone()
    kw.update(_word_runs(args, 2 * P + 1))
    before = launch_counts()["power_sweep_carry_train"]
    got = ops.power_sweep_carry_train(*args, **kw)
    assert launch_counts()["power_sweep_carry_train"] == before + 1
    want = ops.power_sweep_carry_train_plain(*plain, **kw)
    assert launch_counts()["power_sweep_carry_train"] == before + 1
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
    if skew:                                    # row 4's run has no token
        assert not got[2][4].any() and not got[3][4].any()
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
    before = launch_counts()["scatter_add_rows"]
    got = pack_ops.scatter_add_rows(mat, sel_w, sel_k, vals)
    assert got is mat and launch_counts()["scatter_add_rows"] == before + 1
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
    before = launch_counts()["power_sweep_tokens"]
    got = packed.power_sweep_tokens(*args, **kw)
    assert launch_counts()["power_sweep_tokens"] == before + 1
    want = packed.power_sweep_tokens_plain(*plain, **kw)
    assert launch_counts()["power_sweep_tokens"] == before + 1
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
    before = launch_counts()["pack_rows"]
    got = pack_ops.pack_rows(mat, sel_w, sel_k)
    assert launch_counts()["pack_rows"] == before + 1
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
    counters = ("bp_update", "pack_rows", "power_sweep_tokens",
                "scatter_add_rows", "power_sweep_carry_train", "power_topics")
    res = {}
    for device in ("cpu", "cuda"):
        step, _ = pobp.make_train_step(cfg, device=device)
        state = pobp.init_train_state(cfg, device=device)
        before = launch_counts()
        trace = []
        for mb, u0 in _numpy_batches(W, K):
            state, diag = step(state, mb.word_ids, mb.counts,
                               u0=torch.from_numpy(u0))
            trace.append((diag["iters"], float(diag["mean_r"])))
        after = launch_counts()
        res[device] = (state.phi_acc.cpu(), trace,
                       [after[k] - before[k] for k in counters])
    sweeps = sum(it - 1 for it, _ in res["cuda"][1])
    assert res["cpu"][2] == [0, 0, 0, 0, 0, 0]
    assert res["cuda"][2] == [3, sweeps, sweeps, sweeps, 0, sweeps]
    assert sweeps > 0
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
        before = launch_counts()
        trace = []
        for mb, u0 in batches:
            state, diag = step(state, mb.word_ids, mb.counts,
                               u0=torch.from_numpy(u0))
            trace.append((diag["iters"], float(diag["mean_r"])))
        after = launch_counts()
        res[device] = (state.phi_acc.cpu(), trace,
                       [after[k] - before[k] for k in (
                           "bp_update", "power_sweep_carry_train",
                           "scatter_add_rows", "power_topics")])
    sweeps = sum(it - 1 for it, _ in res["cuda"][1])
    assert res["cpu"][2] == [0, 0, 0, 0]
    assert res["cuda"][2] == [3, sweeps, sweeps, sweeps] and sweeps > 0
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
    before = launch_counts()["power_sweep_carry"]
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
    assert launch_counts()["power_sweep_carry"] > before


# ------------------------------------------------ the training step repeats

@pytest.mark.parametrize("D,L,K,P,Pk,skew", [
    (512, 128, 2000, 14104, 50, False),         # the training slice's shapes
    (5, 7, 37, 6, 37, False), (4, 16, 8192, 50, 50, False),
    (3, 8, 1, 4, 1, False),
    (6, 9, 999, 13, 33, False),                 # odd K and Pk
    # a word in every document, runs of C, C + 1, 1 and no token
    (4096, 8, 50, 64, 50, True), (600, 4, 200, 9, 100, True)])
def test_carry_training_dr_repeat_bit_for_bit_on_card(card, D, L, K, P, Pk,
                                                      skew):
    """The carry training sweep's d/r sums run in a fixed order: three
    launches with the step's runs by word give the same four outputs bit
    for bit, a run longer than FOLD_CHUNK summed in chunks."""
    args = [x.to("cuda") for x in _train_args(D + P, D=D, L=L, K=K, P=P,
                                              Pk=Pk, guard=0.3, skew=skew)]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3,
              **_word_runs(args, 2 * P + 1))
    outs = []
    for _ in range(3):
        a = list(args)
        a[3] = args[3].clone()
        outs.append(ops.power_sweep_carry_train(*a, **kw))
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.parametrize("T,K,W", [(65536, 2000, 141043), (21, 37, 5),
                                   (256, 10000, 50)])
def test_word_rows_sum_matches_cpu_bit_for_bit_on_card(card, T, K, W):
    from repro_torch.kernels.token_order import token_runs
    from repro_torch.kernels.segment_sum import ops as seg

    rng = np.random.default_rng(T + K)
    words = (rng.random(T) ** 4 * W).astype(np.int32)
    counts = rng.integers(0, 3, (T, 1)).astype(np.float32)
    words[counts[:, 0] == 0] = 0
    values = counts * rng.random((T, K)).astype(np.float32)
    runs = token_runs(torch.from_numpy(words), torch.from_numpy(counts), W)
    want = seg.word_rows_sum_plain(*runs, torch.from_numpy(values), W)
    before = launch_counts()["word_rows_sum"]
    got = seg.word_rows_sum(*[r.cuda() for r in runs],
                            torch.from_numpy(values).cuda(), W)
    again = seg.word_rows_sum(*[r.cuda() for r in runs],
                              torch.from_numpy(values).cuda(), W)
    assert launch_counts()["word_rows_sum"] == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


@pytest.mark.parametrize("P,Pk,K", [(14104, 50, 2000), (9, 1, 100),
                                    (9, 37, 37), (300, 50, 10000),
                                    (1, 50, 2000),       # one row
                                    (1001, 7, 300),      # rows not even
                                    (14104, 1, 2000),    # one pair a row
                                    (50, 2000, 2000),    # rows past 64
                                    (3, 50, 58000)])     # no room to stage
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
    before = launch_counts()["topic_sum"]
    seg.topic_sum(sel_k.cuda(), vals.cuda(), base.cuda())
    assert launch_counts()["topic_sum"] == before + 1


def test_topic_sum_repeats_on_another_stream_and_refuses_a_k_past_its_memory(
        card):
    """Two streams keep counters of their own: a launch on a side stream
    equals one on the default stream bit for bit; a K whose [K] row does
    not fit a block's shared memory raises."""
    from repro_torch.kernels.segment_sum import ops as seg

    rng = np.random.default_rng(3)
    sel_k = torch.from_numpy(np.argsort(rng.random((700, 500)), axis=1)[
        :, :40].astype(np.int32).copy()).cuda()
    vals = torch.from_numpy(rng.standard_normal((700, 40)).astype(
        np.float32)).cuda()
    base = torch.zeros(500, device="cuda")
    first = seg.topic_sum(sel_k, vals, base)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = seg.topic_sum(sel_k, vals, base)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(first, again)
    K = 60000
    with pytest.raises(ValueError, match="topic_sum takes K"):
        seg.topic_sum(torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                      torch.zeros((1, 1), device="cuda"),
                      torch.zeros(K, device="cuda"))


# ------------------------------------------------ power-topic selection

def _cell_residual_rows(P, K, seed):
    """[P + 3, K] residual rows drawn on the card like the cells': a word's
    token count times |mu' - mu| of two Dirichlet(0.1) draws (spread over
    many orders of magnitude, distinct values), then rows whose top Pk is
    decided by ties: quantized to four values, zeros in 60% of the topics
    with -0.0 among them, and three all-zero guard rows at the end."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    conc = torch.full((P + 3, K), 0.1, device="cuda")
    a, b = (torch._standard_gamma(conc, generator=g) for _ in range(2))
    counts = torch.randint(1, 400, (P + 3, 1), generator=g, device="cuda")
    r = counts * (a / a.sum(1, keepdim=True) - b / b.sum(1, keepdim=True)
                  ).abs()
    n = P // 20
    r[:n] = (r[:n] / r[:n].amax(1, keepdim=True) * 4).floor() / 4
    u = torch.rand((n, K), generator=g, device="cuda")
    r[n:2 * n] = torch.where(u < 0.6, torch.where(u < 0.3, -0.0, 0.0),
                             r[n:2 * n])
    r[P:] = 0.0
    return r.contiguous(), g


@pytest.mark.parametrize("K", [2000, 10000])
def test_power_topics_kernel_matches_plain_version_at_cell_shapes_on_card(
        card, K):
    """P = 14,104 power words, Pk = 50, from rows drawn like the cells'
    residuals, tie rows and zero rows: the kernel gives the plain
    version's ids id for id (lax.top_k's order), and a second launch the
    same bits."""
    P, Pk = 14104, 50
    r, g = _cell_residual_rows(P, K, seed=K)
    W = r.shape[0]
    sel_w = torch.randperm(W, generator=g, device="cuda")[:P].to(torch.int32)
    sel_w[-7:] = W - 1                   # dead slots on one guard row
    before = launch_counts()["power_topics"]
    got = topics_ops.power_topics(r, sel_w, Pk)
    again = topics_ops.power_topics(r, sel_w, Pk)
    assert launch_counts()["power_topics"] == before + 2
    want = topics_ops.power_topics_plain(r, sel_w, Pk)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (P, Pk)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    zero = torch.arange(Pk, dtype=torch.int32, device="cuda")
    assert torch.equal(got[-7:], zero.expand(7, Pk))


@pytest.mark.parametrize("K,Pk", [(1, 1), (3, 3), (8, 1), (8, 8), (10, 10),
                                  (37, 5), (2000, 1), (2000, 2000),
                                  (2001, 50), (4099, 50), (10000, 10000),
                                  (20001, 50), (20001, 20001)])
def test_power_topics_kernel_matches_plain_version_on_card(card, K, Pk):
    """Every plan the row width picks, Pk from 1 to K, rows of odd width
    (4-byte loads), on the cells' row kinds."""
    P = 60
    r, g = _cell_residual_rows(P, K, seed=K + Pk)
    r[5:9] = torch.randn((4, K), generator=g, device="cuda")   # negatives
    sel_w = torch.cat([torch.randperm(P + 3, generator=g, device="cuda"),
                       torch.tensor([P + 1, 2], device="cuda")]).to(
                           torch.int32)
    got = topics_ops.power_topics(r, sel_w, Pk)
    want = topics_ops.power_topics_plain(r.cpu(), sel_w.cpu(), Pk)
    assert torch.equal(got.cpu(), want)


def test_power_topics_kernel_on_unaligned_rows_and_its_checks_on_card(card):
    """Rows of a multiple of 4 floats that start off a 16-byte boundary
    take the 4-byte loads and give the same ids; the wrapper refuses a
    wrong dtype, a strided matrix and a K past its shared memory."""
    P, K, Pk = 300, 2000, 50
    r, g = _cell_residual_rows(P, K, seed=7)
    flat = torch.empty(r.numel() + 1, device="cuda")
    flat[1:] = r.reshape(-1)
    shifted = flat[1:].view(r.shape)
    assert shifted.data_ptr() % 16 != 0
    sel_w = torch.randperm(P + 3, generator=g, device="cuda").to(torch.int32)
    assert torch.equal(topics_ops.power_topics(shifted, sel_w, Pk),
                       topics_ops.power_topics(r, sel_w, Pk))
    with pytest.raises(ValueError, match="sel_w must be torch.int32"):
        topics_ops.power_topics(r, sel_w.long(), Pk)
    with pytest.raises(ValueError, match="r_wk must be contiguous"):
        topics_ops.power_topics(r.t().contiguous().t(), sel_w, Pk)
    with pytest.raises(ValueError, match="shared memory"):
        topics_ops.power_topics(torch.zeros((2, 60000), device="cuda"),
                                sel_w[:2] % 2, 50)


def test_power_topics_launches_once_a_selective_iteration_on_card(card):
    """One POBP step on the card: the selection kernel launches exactly
    once in each selective iteration, and no topk copy of the rows."""
    W, K = 3000, 128
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=16,
                    inner_iters=30, residual_tol=0.02)
    step, _ = pobp.make_train_step(cfg, device="cuda")
    state = pobp.init_train_state(cfg, 3, device="cuda")
    docs, _, _ = lda_corpus(5, 64, W, K, doc_len_mean=60)
    mb = docs_to_padded(docs, max_len=64)
    before = launch_counts()["power_topics"]
    _, diag = step(state, mb.word_ids, mb.counts)
    assert diag["iters"] > 2
    assert launch_counts()["power_topics"] - before == diag["iters"] - 1


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
            "--shards", "1", "--ckpt-dir", str(ck), "--device", "cuda",
            *extra])

    full = lda_train.train_loop(args(tmp_path / "a"))
    with pytest.raises(SystemExit):
        lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    resumed = lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    assert resumed["first_m"] == 2
    assert resumed["mean_r"] == full["mean_r"][2:]
    assert resumed["iters"] == full["iters"][2:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])


# ---------------------------------------------------- multi-shard sync

def _shard_batches(W, K, shards, steps=2, docs=32, L=32):
    rng = np.random.default_rng(5)
    out = []
    for m in range(steps):
        d, _, _ = lda_corpus(30 + m, docs, W, K, doc_len_mean=40)
        mb = docs_to_padded(d, max_len=L)
        out.append((mb.word_ids.reshape(shards, -1, L),
                    mb.counts.reshape(shards, -1, L),
                    rng.uniform(0.01, 1.0, (shards, docs // shards, L, K)
                                ).astype(np.float32)))
    return out


def test_lockstep_shards_on_card_match_cpu_and_repeat(card):
    """Four data shards in lockstep on the card (a thread a shard, one
    stream) against the same four on the CPU from one numpy-drawn init:
    the same iterations, phi_acc within rtol 1e-3; each kernel launched
    four times its single-shard count; a second run on the card equal bit
    for bit; the meter the same on both devices."""
    from repro_torch.kernels import launch_counts

    W, K, N = 500, 64, 4
    cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=8,
                    inner_iters=8, residual_tol=0.05)
    batches = _shard_batches(W, K, N)
    res = {}
    for device in ("cpu", "cuda", "cuda"):
        step, meter = pobp.make_train_step(cfg, N, device=device)
        state = pobp.init_train_state(cfg, device=device)
        launch_counts(reset=True)
        trace = []
        for wid, cnt, u0 in batches:
            state, diag = step(state, wid, cnt, u0=torch.from_numpy(u0))
            trace.append(diag["iters"])
        res.setdefault(device, []).append(
            (state.phi_acc.cpu(), trace, launch_counts(),
             meter.bytes_by_phase))
    (cpu_phi, cpu_it, cpu_n, cpu_by), = res["cpu"]
    (a_phi, a_it, a_n, a_by), (b_phi, b_it, _, _) = res["cuda"]
    sweeps = sum(it - 1 for it in a_it)
    assert a_it == b_it == cpu_it and sweeps > 0
    assert set(cpu_n.values()) == {0}
    assert a_n["bp_update"] == N * len(batches)
    assert a_n["power_sweep_carry_train"] == a_n["topic_sum"] == N * sweeps
    assert a_n["power_topics"] == N * sweeps
    assert torch.equal(a_phi, b_phi)
    torch.testing.assert_close(a_phi, cpu_phi, rtol=1e-3, atol=1e-3)
    assert a_by == cpu_by and a_by["dense"] == 2 * W * K * 4


def test_topic_sharded_slab_on_card_matches_unsharded(card):
    """``SlabEngine(topic_shards=4)`` on the card (torch code over the
    stacked shards) serves the unsharded card engine's theta within
    1e-5 and bills every retired document."""
    W, K = 400, 64
    docs, _, true_phi = lda_corpus(2, 24, W, K, doc_len_mean=30)
    phi_acc = (true_phi.T * 200.0).astype(np.float32)
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    kw = dict(slots=8, slot_len=64, sweeps_per_step=2, fold_iters=30,
              residual_tol=1e-2, pipeline=0, device="cuda")
    res = {}
    for shards in (1, 4):
        eng = SlabEngine(phi_acc, cfg, topic_shards=shards, **kw)
        _replay_numpy_init(eng, 4)
        for d in docs:
            eng.submit(d)
        res[shards] = {r.req_id: r for r in eng.drain()}
    for rid, want in res[1].items():
        got = res[4][rid]
        assert got.iters == want.iters and got.comm_bytes > 0
        np.testing.assert_allclose(got.theta, want.theta, atol=1e-5)


def test_slab_placed_on_a_one_by_one_nccl_mesh_serves_as_unplaced(
        card, tmp_path):
    """``SlabEngine.from_checkpoint(sharding=(mesh, phi_serving_spec))`` on
    a 1 x 1 NCCL mesh serves as the unplaced engine (one seed,
    ``pipeline=0``): every theta and iteration equal bit for bit, the
    serving kernel launched steps x sweeps times."""
    import torch.distributed as dist

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist.sharding import phi_serving_spec
    from repro_torch.launch.mesh import make_mesh

    W, K = 400, 64
    docs, _, true_phi = lda_corpus(3, 40, W, K, doc_len_mean=30)
    phi_acc = torch.from_numpy((true_phi.T * 200.0).astype(np.float32))
    ckpt.save(str(tmp_path / "ck"), 1, {"state": {"phi_acc": phi_acc}},
              extra={"run": {"vocab": W, "topics": K}})
    kw = dict(slots=8, slot_len=64, sweeps_per_step=2, seed=3, pipeline=0,
              device="cuda")

    def serve(eng):
        for d in docs:
            eng.submit(d)
        return {r.req_id: r for r in eng.drain()}

    want = serve(SlabEngine.from_checkpoint(str(tmp_path / "ck"), **kw))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        eng = SlabEngine.from_checkpoint(
            str(tmp_path / "ck"),
            sharding=(mesh, phi_serving_spec(mesh, phi_acc)), **kw)
        before = launch_counts()["power_sweep_carry"]
        got = serve(eng)
        launched = launch_counts()["power_sweep_carry"] - before
    finally:
        dist.destroy_process_group()
    assert eng._place.group is None and tuple(eng._phi.shape) == (W + 1, K)
    assert launched == eng.stats()["steps"] * 2 > 0
    assert sorted(got) == sorted(want) == list(range(40))
    for rid, w in want.items():
        assert got[rid].iters == w.iters, rid
        assert np.array_equal(got[rid].theta, w.theta), rid


# ------------------------------------------- dynamic vocabulary (live W)

def _dead_slots(sel_w, sel_k, dead, guard_row):
    """A live-W selection's tail: the last ``dead`` slots all on one guard
    row, all with the same topics (a tie over a zero row)."""
    sel_w[-dead:] = guard_row
    sel_k[-dead:] = sel_k[-dead - 1]


@pytest.mark.parametrize("D,L,K,P,Pk,dead", [(6, 8, 20, 9, 5, 4),
                                             (64, 128, 2000, 1400, 50, 300)])
def test_carry_training_kernel_dead_slots_on_card(card, D, L, K, P, Pk, dead):
    """The training sweep with dead slots repeating one all-zero guard row
    that no token has: against its plain version, d/r exactly 0 there, all
    four outputs repeating bit for bit."""
    args = _train_args(D + K + Pk + 1, D=D, L=L, K=K, P=P, Pk=Pk, guard=0.3)
    p_tok, phi, sel_w, sel_k = args[0], args[6], args[7], args[8]
    guard_row = int(np.setdiff1d(np.arange(phi.shape[0]), sel_w.numpy())[0])
    _dead_slots(sel_w, sel_k, dead, guard_row)
    p_tok[p_tok >= P - dead] = P
    phi[guard_row] = 0.0
    args = [x.to("cuda") for x in args]
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3,
              **_word_runs(args, phi.shape[0]))
    mu0 = args[3].clone()
    got = ops.power_sweep_carry_train(*args, **kw)
    plain = list(args)
    plain[3] = mu0.clone()
    want = ops.power_sweep_carry_train_plain(*plain, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(
            g, w, rtol=1e-4, atol=1e-4 * max(float(w.abs().max()), 1e-30))
    assert not got[2][-dead:].any() and not got[3][-dead:].any()
    again = list(args)
    again[3] = mu0.clone()
    rerun = ops.power_sweep_carry_train(*again, **kw)
    assert all(torch.equal(r, g) for r, g in zip(rerun, got))


@pytest.mark.parametrize("D,L,K,P,Pk,dead", [(6, 8, 20, 9, 5, 4),
                                             (64, 128, 2000, 1400, 50, 300)])
def test_packed_sweep_and_pack_dead_slots_on_card(card, D, L, K, P, Pk, dead):
    """The packed path with dead slots: ``pack_rows`` packs the repeated
    zero guard row as zeros (exactly its plain version), the packed sweep
    gives those slots zero d/r against its plain version and repeats bit
    for bit, and the scatter adds their zeros exactly."""
    W = 2 * P + 1
    mat, sel_w, sel_k, vals = _pack_args(W + K, W=W, K=K, P=P, Pk=Pk)
    guard_row = int(np.setdiff1d(np.arange(W), sel_w.numpy())[0])
    mat[guard_row] = 0.0
    _dead_slots(sel_w, sel_k, dead, guard_row)
    vals[-dead:] = 0.0
    mat, sel_w, sel_k, vals = (x.to("cuda") for x in (mat, sel_w, sel_k,
                                                      vals))
    phi_pack = pack_ops.pack_rows(mat, sel_w, sel_k)
    assert torch.equal(phi_pack, pack_ops.pack_rows_plain(mat, sel_w, sel_k))
    assert not phi_pack[-dead:].any()
    want = pack_ops.scatter_add_rows_plain(mat.clone(), sel_w, sel_k, vals)
    assert torch.equal(pack_ops.scatter_add_rows(mat.clone(), sel_w, sel_k,
                                                 vals), want)
    args = _packed_args(D + K + Pk + 2, D=D, L=L, K=K, P=P, Pk=Pk, guard=0.3)
    args[0][args[0] >= P - dead] = P
    args = [x.to("cuda") for x in args]
    args[6] = phi_pack + torch.where(phi_pack > 0, 3.0, 0.0)
    args[7] = sel_k
    kw = dict(alpha=ALPHA, beta=0.01, wbeta=0.3)
    mu0 = args[3].clone()
    got = packed.power_sweep_tokens(*args, **kw)
    plain = list(args)
    plain[3] = mu0.clone()
    want = packed.power_sweep_tokens_plain(*plain, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-5 * max(float(w.abs().max()), 1e-30))
    assert not got[2][-dead:].any() and not got[3][-dead:].any()
    again = list(args)
    again[3] = mu0.clone()
    rerun = packed.power_sweep_tokens(*again, **kw)
    assert all(torch.equal(r, g) for r, g in zip(rerun, got))


@pytest.mark.parametrize("policy", ["auto", "packed"])
def test_live_w_train_step_on_card_repeats_and_matches_cpu(card, policy):
    """A live-W step (W_cap 4096 above a 3000-word vocabulary) on the card:
    run twice from one state, equal bit for bit; against the CPU step from
    the same init, iterations equal, rel 1e-3; guard rows exactly 0."""
    W, W_cap, K = 3000, 4096, 64
    cfg = LDAConfig(vocab_size=W_cap, num_topics=K, lambda_k_abs=8,
                    inner_iters=20, residual_tol=0.02, sweep_policy=policy)
    docs, _, _ = lda_corpus(7, 64, W, K, doc_len_mean=60)
    mb = docs_to_padded(docs, max_len=64)
    u0 = torch.from_numpy(np.random.default_rng(1).uniform(
        0.01, 1.0, (64, 64, K)).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        step, _ = pobp.make_train_step(cfg, device=device)
        state = pobp.init_train_state(cfg, 3, device=device)
        state, _ = step(state, mb.word_ids, mb.counts, W, u0=u0)
        runs = [step(state, mb.word_ids, mb.counts, W, u0=u0)
                for _ in range(2)]
        (a, da), (b, db) = runs
        assert da["iters"] == db["iters"] > 2
        assert torch.equal(a.phi_acc, b.phi_acc)
        assert float(da["mean_r"]) == float(db["mean_r"])
        assert not a.phi_acc[W:].any()
        out[device] = (a.phi_acc.cpu(), da["iters"], float(da["mean_r"]))
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-3)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3,
                               atol=1e-3)


def test_lifecycle_driver_crash_resume_on_card(card, tmp_path):
    """The sliding stream with decay and fences on the card: a crash after
    batch 7, then the same command, replays through the fence at 8 and ends
    equal to the uninterrupted run bit for bit; a fence that drops a rung
    frees the old rung's bytes."""
    from repro_torch.launch import lda_train

    def args(ck, *extra):
        return lda_train.build_parser().parse_args([
            "--minibatches", "8", "--docs-per-batch", "32", "--vocab", "96",
            "--topics", "16", "--lambda-k", "8", "--shards", "1",
            "--dynamic-vocab", "--drift-mode", "slide",
            "--vocab-growth-per-batch", "6", "--decay", "1,0.3",
            "--compact-every", "4", "--compact-min-idle", "2",
            "--compact-mass-tol", "60", "--tol", "1e-9", "--log-every", "0",
            "--ckpt-every", "3", "--ckpt-dir", str(ck), "--device", "cuda",
            *extra])

    full = lda_train.train_loop(args(tmp_path / "a"))
    assert [e["m"] for e in full["compaction_events"]] == [4, 8]
    with pytest.raises(SystemExit):
        lda_train.train_loop(args(tmp_path / "b", "--crash-at", "7"))
    resumed = lda_train.train_loop(args(tmp_path / "b", "--crash-at", "7"))
    assert resumed["first_m"] == 6
    assert resumed["mean_r"] == full["mean_r"][6:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])
    assert resumed["vocab_keys"] == full["vocab_keys"]
    assert not full["phi_acc"][full["live_w"]:].any()
    assert [f["m"] for f in full["fence_bytes"]] == [4, 8]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topic_recycling_through_a_fence_on_card(card, tmp_path, dtype):
    """A fence that recycles topics moves phi_acc to the host and back in
    its storage dtype: on the card, with ``--recycle-tol 1`` (every topic
    at or under the mean mass), each fence recycles; a crash after batch 3,
    then the same command, resumes from the fence at 2 and ends equal to
    the uninterrupted run bit for bit, recycling the same topics."""
    from repro_torch.launch import lda_train

    def args(ck, *extra):
        return lda_train.build_parser().parse_args([
            "--minibatches", "6", "--docs-per-batch", "32", "--vocab", "96",
            "--topics", "16", "--lambda-k", "8", "--shards", "1",
            "--dynamic-vocab", "--drift-mode", "slide",
            "--vocab-growth-per-batch", "6", "--decay", "1,0.3",
            "--compact-every", "2", "--compact-min-idle", "2",
            "--compact-mass-tol", "60", "--recycle-tol", "1.0",
            "--tol", "1e-9", "--log-every", "0", "--ckpt-every", "2",
            "--phi-acc-dtype", dtype, "--ckpt-dir", str(ck),
            "--device", "cuda", *extra])

    full = lda_train.train_loop(args(tmp_path / "a"))
    assert [e["m"] for e in full["compaction_events"]] == [2, 4, 6]
    assert all(e["recycled"] for e in full["compaction_events"])
    assert full["phi_acc"].dtype == getattr(torch, dtype)
    with pytest.raises(SystemExit):
        lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    resumed = lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    assert resumed["first_m"] == 2
    assert resumed["mean_r"] == full["mean_r"][2:]
    assert resumed["iters"] == full["iters"][2:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])
    assert resumed["compaction_events"] == full["compaction_events"][1:]


# ------------------------------------------------- the comparators (Gibbs, VB)

def _gibbs_case(seed, *, T, D, K, W, kind="docs"):
    """Tokens on the card, a random z and its counts, and Gumbel noise.
    ``kind``: "docs", tokens in document order (the last document holds
    one token, word W - 1 appears once); "shuffled", the same in a random
    order; "repeats", words in runs of 3 consecutive tokens, runs crossing
    document boundaries; "singletons", one token a document (D = T);
    "ties", every token on one document and one word, z = [0, 0, 1, 1,
    ...] and noise 0: every draw is a tie that the lowest topic wins."""
    from repro_torch.core import gibbs

    rng = np.random.default_rng(seed)
    if kind == "ties":
        doc = np.zeros(T, np.int32)
        word = np.zeros(T, np.int32)
        z = (np.arange(T) // 2 % K).astype(np.int32)
        noise = np.zeros((T, K), np.float32)
    else:
        if kind == "singletons":
            D = T
            doc = np.arange(T, dtype=np.int32)
        else:
            doc = np.sort(rng.integers(0, D - 1, T)).astype(np.int32)
            doc[-1] = D - 1
        word = rng.integers(0, W - 1, T).astype(np.int32)
        word[rng.integers(T)] = W - 1
        if kind == "repeats":
            word = np.repeat(word[::3], 3)[:T]
        if kind == "shuffled":
            perm = rng.permutation(T)
            doc, word = doc[perm], word[perm]
        z = rng.integers(0, K, T).astype(np.int32)
        noise = rng.gumbel(size=(T, K)).astype(np.float32)
    cfg = LDAConfig(vocab_size=W, num_topics=K, alpha=ALPHA)
    d, w = torch.from_numpy(doc).cuda(), torch.from_numpy(word).cuda()
    state = gibbs.gibbs_init(None, d, w, D, cfg,
                             z=torch.from_numpy(z).cuda())
    return cfg, d, w, state, torch.from_numpy(noise).cuda()


def _check_counts(z, n_dk, n_wk, n_k, T):
    assert torch.equal(n_k, n_wk.sum(0))
    for c in (n_dk, n_wk, n_k):
        assert bool((c >= 0).all()) and torch.equal(c, c.round())
    assert float(n_wk.sum()) == float(n_dk.sum()) == T
    assert int(z.min()) >= 0 and int(z.max()) < n_k.shape[0]


def _past_cache():
    """A K past the chain's shared-memory caches (the device-memory path),
    a multiple of 4 (its 16-byte loads)."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    return gops.cached_topic_limit("cuda") // 4 * 4 + 4


@pytest.mark.parametrize("T,D,K,W,kind", [
    (4096, 64, 2000, 20000, "docs"),   # the comparators slice's shape
    (300, 10, 1, 50, "docs"),          # one topic
    (300, 10, 33, 50, "docs"),         # a warp and one topic
    (200, 6, 2049, 100, "docs"),       # past 2048: 4-byte copies
    (128, 4, 10000, 100, "docs"),      # the reference's second K
    (64, 3, "past", 40, "docs"),       # past the shared-memory caches
    (64, 3, "past+1", 40, "docs"),     # ... and its 4-byte loads
    (64, 1, 37, 1, "ties"),            # every draw a tie
    (64, 1, 2000, 1, "ties"),          # ties on the 16-byte path
    (800, 12, 500, 300, "shuffled"),   # any token order
    (900, 12, 2000, 60, "repeats"),    # a word's repeated tokens, across docs
    (400, 0, 64, 500, "singletons")])  # one-token documents
def test_gibbs_sweep_kernel_matches_plain_version_on_card(card, T, D, K, W,
                                                          kind):
    """Injected noise and the kernel's own Philox noise: z and all three
    counts equal to the plain version's exactly, the counts consistent; a
    sweep is one chain launch (and, with a seed, one pre-pass launch)."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    if isinstance(K, str):
        K = _past_cache() + (1 if K.endswith("+1") else 0)
    cfg, d, w, state, noise = _gibbs_case(T + K, T=T, D=D, K=K, W=W,
                                          kind=kind)
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=W)
    for draw, sweep in ((noise, 0), (987654321987654321, 3)):
        got = [x.clone() for x in state]
        want = [x.clone() for x in state]
        before = launch_counts()
        gops.gibbs_sweep(*got, d, w, draw, **kw, sweep=sweep)
        gops.gibbs_sweep_plain(*want, d, w, draw, **kw, sweep=sweep)
        torch.cuda.synchronize()
        after = launch_counts()
        assert (after["gibbs_sweep"], after["gibbs_noise"]) == \
            (before["gibbs_sweep"] + 1,
             before["gibbs_noise"] + (draw is not noise))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        _check_counts(*got, T)
        if kind == "ties" and draw is noise:
            # token 0 leaves topic 0 one count short of topics 1..31: the
            # tie among them goes to the lowest
            assert int(got[0][0]) == 1


def test_gibbs_sweep_with_noise_off_16_byte_boundaries_on_card(card):
    """Injected noise that starts 4 bytes into its allocation takes the
    chain's 4-byte path and still equals the plain version exactly."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    cfg, d, w, state, noise = _gibbs_case(4, T=600, D=8, K=2000, W=5000)
    view = torch.empty(600 * 2000 + 1, device="cuda")[1:].view(600, 2000)
    view.copy_(noise)
    got = [x.clone() for x in state]
    want = [x.clone() for x in state]
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=5000)
    gops.gibbs_sweep(*got, d, w, view, **kw)
    gops.gibbs_sweep_plain(*want, d, w, noise, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("threads", [32, 256, 512, 1024])
def test_gibbs_sweep_block_sizes_agree_on_card(card, monkeypatch, threads):
    """Every block size chooses the plain version's topics (many chunks a
    thread, two, one, and threads with none)."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    monkeypatch.setattr(gops, "block_threads", lambda K: threads)
    cfg, d, w, state, noise = _gibbs_case(9, T=500, D=10, K=2000, W=700)
    got = [x.clone() for x in state]
    want = [x.clone() for x in state]
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=700)
    gops.gibbs_sweep(*got, d, w, noise, **kw)
    gops.gibbs_sweep_plain(*want, d, w, noise, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gibbs_noise_pre_pass_equals_philox_gumbel_on_card(card):
    """The pre-pass draws philox_gumbel's numbers exactly, at any token
    offset; a sweep past NOISE_CHUNK_BYTES runs one pre-pass and one chain
    launch a chunk and still equals the plain version."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    for T, K, t0 in ((300, 2000, 0), (17, 33, 5), (5, 10000, 100)):
        before = launch_counts()["gibbs_noise"]
        got = gops.gibbs_noise(1234567890123, 3, T, K, "cuda", t0=t0)
        assert launch_counts()["gibbs_noise"] == before + 1
        assert torch.equal(got, gops.philox_gumbel(1234567890123, 3, T, K,
                                                   "cuda", t0=t0))
    cfg, d, w, state, _ = _gibbs_case(2, T=300, D=6, K=64, W=90)
    got = [x.clone() for x in state]
    want = [x.clone() for x in state]
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=90)
    chunk = gops.NOISE_CHUNK_BYTES
    gops.NOISE_CHUNK_BYTES = 64 * 4 * 100              # 100 tokens a chunk
    try:
        before = launch_counts()
        gops.gibbs_sweep(*got, d, w, 77, **kw, sweep=2)
        after = launch_counts()
        assert (after["gibbs_sweep"], after["gibbs_noise"]) == \
            (before["gibbs_sweep"] + 3, before["gibbs_noise"] + 3)
    finally:
        gops.NOISE_CHUNK_BYTES = chunk
    gops.gibbs_sweep_plain(*want, d, w, 77, **kw, sweep=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gibbs_sweep_refuses_an_over_range_k_on_card(card):
    from repro_torch.kernels.gibbs_sweep import ops as gops

    K = 65537
    z = torch.zeros(1, dtype=torch.int32, device="cuda")
    ids = torch.zeros(1, dtype=torch.int32, device="cuda")
    n_dk = torch.zeros((1, K), device="cuda")
    n_k = torch.zeros(K, device="cuda")
    with pytest.raises(ValueError, match="K <= 65536"):
        gops.gibbs_sweep(z, n_dk, n_dk.clone(), n_k, ids, ids, 5,
                         alpha=0.1, beta=0.01, W=1)


def test_gibbs_philox_draws_repeat_on_card(card):
    """One state, one seed, one sweep index: two launches equal bit for
    bit; another sweep index or seed draws other topics."""
    from repro_torch.kernels.gibbs_sweep import ops as gops

    cfg, d, w, state, _ = _gibbs_case(5, T=2000, D=20, K=500, W=3000)
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, W=3000)
    runs = []
    for seed, sweep in ((11, 0), (11, 0), (11, 1), (12, 0)):
        s = [x.clone() for x in state]
        gops.gibbs_sweep(*s, d, w, seed, **kw, sweep=sweep)
        runs.append(s)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[2][0])
    assert not torch.equal(runs[0][0], runs[3][0])


def test_run_gibbs_on_card_repeats_and_launches_once_a_sweep(card):
    from repro_torch.core import gibbs

    docs, _, _ = lda_corpus(3, 64, 500, 20, doc_len_mean=60)
    mb = docs_to_padded(docs)
    cfg = LDAConfig(vocab_size=500, num_topics=20)
    runs, seen = [], []
    for _ in range(2):
        before = launch_counts()["gibbs_sweep"]
        runs.append(gibbs.run_gibbs(
            torch.Generator(device="cuda").manual_seed(7), mb, cfg, 3,
            callback=lambda s, *st: seen.append(
                bool(torch.equal(st[3], st[2].sum(0))))))
        assert launch_counts()["gibbs_sweep"] == before + 3
    assert all(seen) and len(seen) == 6
    # the Philox noise: one pre-pass launch a sweep
    before = launch_counts()["gibbs_noise"]
    gibbs.run_gibbs(torch.Generator(device="cuda").manual_seed(7), mb, cfg, 2)
    assert launch_counts()["gibbs_noise"] == before + 2
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    T = float(mb.counts.sum())
    assert float(runs[0][0].sum()) == float(runs[0][1].sum()) == T
    phi, nbytes = gibbs.run_parallel_gibbs(
        torch.Generator(device="cuda").manual_seed(8),
        [docs_to_padded(docs[:32]), docs_to_padded(docs[32:])], cfg, 2)
    assert nbytes == 500 * 20 * 4 * 2 * 2 and float(phi.sum()) == T


def test_vb_on_card_repeats_bit_for_bit_and_tracks_cpu(card):
    """run_vb from one injected lambda twice on the card: equal bit for bit
    (the statistic through the fixed-order word_rows_sum kernel).  One
    sweep on the card within rtol 1e-5 of the same sweep on the CPU
    (digamma and the sums over K and L in other orders; a floor of 1e-6 of
    the largest entry): over several iterations VB's fixed point amplifies
    those ulps (4 iterations at these shapes part by up to 1.2e-3 at small
    entries), so the run is held to itself, not to the CPU."""
    from repro_torch.core import vb

    docs, _, _ = lda_corpus(4, 48, 800, 16, doc_len_mean=50)
    mb = docs_to_padded(docs)
    cfg = LDAConfig(vocab_size=800, num_topics=16)
    lam0 = 0.01 + 0.5 + torch.rand((800, 16),
                                   generator=torch.Generator().manual_seed(0))
    before = launch_counts()["word_rows_sum"]
    a = vb.run_vb(None, mb, cfg, 4, lam0=lam0)
    b = vb.run_vb(None, mb, cfg, 4, lam0=lam0)
    assert launch_counts()["word_rows_sum"] == before + 8
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(torch.isfinite(a[1]).all())
    card_mb = MiniBatch(mb.word_ids.cuda(), mb.counts.cuda())
    for got, want in zip(vb.vb_sweep(card_mb, lam0.cuda(), cfg),
                         vb.vb_sweep(mb, lam0, cfg)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("arch,dtype", [
    ("smollm-360m", torch.bfloat16), ("zamba2-2.7b", torch.bfloat16),
    ("llama-3.2-vision-11b", torch.bfloat16),
    ("deepseek-v2-lite-16b", torch.float32)])
def test_lm_decode_on_card_matches_cpu_and_repeats(card, arch, dtype):
    """A reduced model's prefill of 8 tokens and 6 decode steps on the card
    (teacher-forced with the CPU run's greedy tokens): every step's logits
    against the same steps on the CPU from the same params, and a second
    run on the card equal bit for bit.  bf16 is held to the reference's own
    decode tolerance (rtol 0.1, atol 0.15); the MoE model runs in float32
    (params and caches), where the two devices' sums agree to ~1e-6 and
    route every token alike (a bf16 near-tie may route it elsewhere), and
    is held to rtol 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map

    cfg = get_config(arch).reduced()
    mod = registry.build(cfg)
    params = mod.init(cfg, seed=3, device="cpu")
    if dtype == torch.float32:
        params = tree_map(lambda t: t.float(), params)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    image = torch.randn((2, cfg.frontend_tokens, cfg.d_model), generator=gen)

    def grown(c, t):
        out = t.to(c.dtype if dtype == torch.float32 else t.dtype).clone()
        out[tuple(slice(0, n) for n in c.shape)] = c
        return out

    def run(device, feed=None):
        p = tree_map(lambda t: t.to(device), params)
        logits, caches, _ = mod.forward(
            p, prompt.to(device), cfg, mode="prefill",
            image_embeds=image.to(device) if cfg.family == "vlm" else None)
        caches = tree_map(grown, caches,
                          registry.cache_zeros(cfg, 2, 14, device=device))
        outs, toks = [logits.float().cpu()], []
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(6):
            if feed is not None:
                tok = feed[i].to(device)
            toks.append(tok.cpu())
            lg, caches = mod.decode_step(p, tok, caches, 8 + i, cfg)
            outs.append(lg.float().cpu())
            tok = lg[:, -1].argmax(-1)[:, None]
        return outs, toks

    cpu, toks = run("cpu")
    a, _ = run("cuda", feed=toks)
    b, _ = run("cuda", feed=toks)
    tol = (dict(rtol=0.1, atol=0.15) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    for i, (x, y, want) in enumerate(zip(a, b, cpu)):
        assert torch.equal(x, y), i
        torch.testing.assert_close(x[..., :cfg.vocab_size],
                                   want[..., :cfg.vocab_size], **tol)


# ------------------------------------------------------------- LM training

def _lm_step_args(*extra, device="cuda"):
    from repro_torch.launch import train

    return train.build_parser().parse_args([
        "--arch", "smollm-360m", "--reduced", "--steps", "6", "--batch", "4",
        "--seq", "16", "--shards", "2", "--sync", "power", "--log-every",
        "100", "--ckpt-every", "2", "--device", device, *extra])


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "zamba2-2.7b"])
def test_lm_train_step_on_card_matches_cpu_and_repeats(card, arch):
    """One trainer step (2 lockstep shards, PowerSync through the
    power-pack kernels, AdamW) on the card against the CPU from the same
    params and batch in float32: the loss within rtol 1e-4, the synced
    grads that the step hands to AdamW within a relative L2 error of 1e-3
    per leaf; the step run twice on the card equal bit for bit."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import batch_at
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.powersync import PowerSyncConfig, residual_init

    cfg = get_config(arch).reduced()
    train_update = train.adamw_update

    def one_step(device):
        step, meter, mod = train.build_trainer(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=20), PowerSyncConfig(), 2,
            "power", device)
        params = tree_map(lambda t: t.float().to(device),
                          mod.init(cfg, seed=1, device="cpu"))
        residual = tree_map(lambda r: r.new_zeros((2, *r.shape)),
                            residual_init(params))
        batch = batch_at(0, 0, 4, 16, cfg.vocab_size, shards=2,
                         device=device)
        synced = []

        def update(grads, opt, acfg):
            synced.append(grads)
            return train_update(grads, opt, acfg)

        with mock.patch.object(train, "adamw_update", update):
            loss, _, opt, residual = step(params, adamw_init(params),
                                          residual, batch)
        return loss.cpu(), synced[0], opt, residual

    n0 = launch_counts()["pack_rows"]
    cpu_loss, cpu_grads, _, _ = one_step("cpu")
    a_loss, a_grads, a_opt, a_res = one_step("cuda")
    assert launch_counts()["pack_rows"] > n0
    b_loss, b_grads, b_opt, b_res = one_step("cuda")
    torch.testing.assert_close(a_loss, cpu_loss, rtol=1e-4, atol=0)
    for (path, x), (_, y), (_, want) in zip(tree_leaves(a_grads),
                                            tree_leaves(b_grads),
                                            tree_leaves(cpu_grads)):
        assert torch.equal(x, y), path
        err = float((x.cpu() - want).norm())
        assert err <= 1e-3 * float(want.norm()), (path, err)
    assert torch.equal(a_loss, b_loss)
    for (path, x), (_, y) in zip(tree_leaves(a_opt.master),
                                 tree_leaves(b_opt.master)):
        assert torch.equal(x, y), path
    for (path, x), (_, y) in zip(tree_leaves(a_res), tree_leaves(b_res)):
        assert torch.equal(x, y), path


def test_powersync_kernels_match_plain_versions_on_card(card):
    """PowerSync over 2 lockstep shards on the card through the power-pack
    kernels and through their plain versions: synced equal, the residual
    equal bit for bit (each pair is selected once, so the scatter's
    atomics land in a fixed result)."""
    from unittest import mock

    from repro_torch.core.sync import SimReducer, lockstep
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.powersync import PowerSyncConfig, powersync_tree

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    emb = rnd(2, 600, 48)
    emb[:, ::4] = 0.0
    grads = {"embed": emb, "stack": {"w": rnd(2, 3, 40, 64),
                                     "wb": rnd(2, 70, 90).bfloat16()},
             "norm": rnd(2, 48), "head_blocks": [{"w": rnd(2, 50, 90)}]}
    res = tree_map(lambda g: 0.1 * rnd(*g.shape), grads)

    def run():
        red = SimReducer(2)
        return lockstep(lambda s: powersync_tree(
            tree_map(lambda a: a[s], grads), tree_map(lambda a: a[s], res),
            red, PowerSyncConfig(lambda_rows=0.3, lambda_cols=0.4), 2), 2,
            [red], device="cuda")

    n0 = launch_counts()
    got = run()
    n = launch_counts()
    # 4 leaves past min_dense_size, a pack and two scatters each, a shard
    assert (n["pack_rows"] - n0["pack_rows"],
            n["scatter_add_rows"] - n0["scatter_add_rows"]) == (8, 16)
    with mock.patch.object(pack_ops, "pack_rows", pack_ops.pack_rows_plain), \
            mock.patch.object(pack_ops, "scatter_add_rows",
                              pack_ops.scatter_add_rows_plain):
        want = run()
    for s in range(2):
        for i in range(2):
            for (path, x), (_, y) in zip(tree_leaves(got[s][i]),
                                         tree_leaves(want[s][i])):
                assert x.dtype == y.dtype and torch.equal(x, y), (s, i, path)


def test_lm_crash_resume_on_card(card, tmp_path):
    """``--crash-at 5`` (a checkpoint every 2 steps) then the same command
    again on the card: the resumed losses equal the uninterrupted run's
    bit for bit."""
    from repro_torch.launch import train

    full, _ = train.train_loop(_lm_step_args("--ckpt-dir",
                                             str(tmp_path / "a")))
    with pytest.raises(SystemExit):
        train.train_loop(_lm_step_args("--ckpt-dir", str(tmp_path / "b"),
                                       "--crash-at", "5"))
    resumed, _ = train.train_loop(_lm_step_args("--ckpt-dir",
                                                str(tmp_path / "b")))
    assert len(resumed) == 2
    assert resumed == full[4:]


def test_powersync_syncs_a_leaf_of_two_to_the_31_elements_on_card(card):
    """An olmoe-1b-7b expert leaf, [16, 64, 2048, 1024] = 2^31 float32
    elements ([2^21, 1024] in 2-D), synced through the power-pack kernels
    and through their plain versions on the card: a pack and two scatters
    launched, the synced leaf and the residual equal at every pair, and
    P x Pc pairs sent (a pair whose accumulated value is exactly 0 sends
    a 0, so up to that many of them may read as not sent)."""
    from unittest import mock

    from repro_torch.core.sync import LocalReducer
    from repro_torch.optim.powersync import PowerSyncConfig, powersync_tree

    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn((16, 64, 2048, 1024), generator=gen, device="cuda")
    r = 0.1 * torch.randn(g.shape, generator=gen, device="cuda")

    def run():
        s, res = powersync_tree({"w": g}, {"w": r}, LocalReducer(),
                                PowerSyncConfig(), 1)
        return s["w"].reshape(-1, 1024), res["w"].reshape(-1, 1024)

    n0 = launch_counts()
    got = run()
    n = launch_counts()
    assert (n["pack_rows"] - n0["pack_rows"],
            n["scatter_add_rows"] - n0["scatter_add_rows"]) == (1, 2)
    with mock.patch.object(pack_ops, "pack_rows", pack_ops.pack_rows_plain), \
            mock.patch.object(pack_ops, "scatter_add_rows",
                              pack_ops.scatter_add_rows_plain):
        want = run()
    sent, zeros = 0, 0
    g2, r2 = g.reshape(-1, 1024), r.reshape(-1, 1024)
    for lo in range(0, 2 ** 21, 2 ** 18):       # row blocks of 1 GiB
        rows = slice(lo, lo + 2 ** 18)
        for x, y in zip(got, want):
            assert torch.equal(x[rows], y[rows]), lo
        sent += int(torch.count_nonzero(want[0][rows]))
        zeros += int(((g2[rows] + r2[rows]) == 0).sum())
    P, Pc = round(0.2 * 2 ** 21), 512
    assert P * Pc - zeros <= sent <= P * Pc, (sent, P * Pc, zeros)

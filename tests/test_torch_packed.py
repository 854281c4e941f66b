"""The port's packed selective-sweep policy held against the JAX package:
the phi pack (``pack_rows``, TPU kernel ``pack_rows_pallas``), the packed
sweep (``power_sweep_tokens``, TPU kernel ``power_sweep_tokens`` with the
gathers and fold-back of its caller), ``_selective_sweep_packed``, the
streaming step with ``sweep_policy="packed"``, the policy resolution and
the driver's flags.

On the CPU each wrapper runs its plain version; the CUDA kernels are held
against the plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.  The Pallas ``power_pack`` kernel traces in interpret
mode here; the Pallas ``power_sweep`` kernel does not trace on the
installed jax, so the packed sweep is held against its jnp oracle
(``power_sweep/ref.py``) composed with the reference's gathers and
fold-back, and against the reference's jnp ``_selective_sweep_packed``.

Tolerances: rtol 1e-5, atol 1e-6 where the two sides sum in different
orders (the renormalization over Pk, the per-document and per-row sums);
a mini-batch or a step, over several iterations, rtol 1e-4 with
``iters`` equal.  Exact: the pack, and every coordinate the sweep must
leave untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pobp as jp
from repro.core.sweep_dispatch import resolve_sweep_policy as j_resolve
from repro.core.types import LDAConfig as JConfig
from repro.core.types import TokenLayout as JLayout
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro.kernels.power_pack import ops as jpack
from repro.kernels.power_pack.ref import pack_rows_ref
from repro.kernels.power_sweep.ref import power_sweep_tokens_ref
from repro.launch import lda_train as jcli
from repro_torch.core import pobp, power
from repro_torch.core.sweep_dispatch import POLICIES, resolve_sweep_policy
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.kernels.power_pack import ops as pack_ops
from repro_torch.kernels.power_sweep import packed
from repro_torch.launch import lda_train as cli

RTOL, ATOL = 1e-5, 1e-6
ALPHA, BETA = 0.1, 0.01
W, K, D, L = 300, 16, 32, 32


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


# --------------------------------------------------------------- the pack

def _pack_case(seed, *, W, K, P, Pk):
    """A [W, K] matrix and a top-k-like selection: distinct rows, distinct
    topics per row."""
    rng = np.random.default_rng(seed)
    mat = (rng.standard_normal((W, K)) * 4).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.argsort(rng.random((P, K)), axis=1)[:, :Pk].astype(np.int32)
    return mat, sel_w, np.ascontiguousarray(sel_k)


@pytest.mark.parametrize("W_,K_,P,Pk", [(50, 16, 8, 4), (40, 100, 12, 37),
                                        (30, 130, 6, 130)])
def test_pack_rows_plain_matches_oracle_and_pallas_kernel(W_, K_, P, Pk):
    mat, sel_w, sel_k = _pack_case(W_ + K_, W=W_, K=K_, P=P, Pk=Pk)
    before = pack_ops.pack_rows.launches
    got = pack_ops.pack_rows(t(mat), t(sel_w), t(sel_k))
    assert pack_ops.pack_rows.launches == before       # CPU: plain, no launch
    assert got.shape == (P, Pk) and got.dtype == torch.float32
    args = [jnp.asarray(x) for x in (mat, sel_w, sel_k)]
    for want in (pack_rows_ref(*args), jpack.pack_rows(*args)):   # Pallas
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # core.power routes the phi pack through the same wrapper
    np.testing.assert_array_equal(
        power.pack_rows(t(mat), t(sel_w), t(sel_k)).numpy(), got.numpy())


def test_pack_rows_packs_pairs_outside_the_matrix_to_zero():
    """Columns outside [0, K) pack to 0, as the Pallas kernel's one-hot
    does; rows outside [0, W) pack to 0 as well."""
    mat, sel_w, sel_k = _pack_case(3, W=20, K=8, P=4, Pk=3)
    sel_k[1, 2] = 8                          # column past K
    np.testing.assert_array_equal(
        pack_ops.pack_rows_plain(t(mat), t(sel_w), t(sel_k)).numpy(),
        np.asarray(jpack.pack_rows(*[jnp.asarray(x)
                                     for x in (mat, sel_w, sel_k)])))
    sel_w[2] = 20                            # row past W
    sel_k[3, 0] = -1                         # column before 0
    want = np.zeros((4, 3), np.float32)
    for p in range(4):
        for j in range(3):
            if sel_w[p] < 20 and 0 <= sel_k[p, j] < 8:
                want[p, j] = mat[sel_w[p], sel_k[p, j]]
    got = pack_ops.pack_rows(t(mat), t(sel_w), t(sel_k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[2] == 0).all() and got.numpy()[1, 2] == 0


# --------------------------------------------------------------- the sweep

def _sweep_case(seed, *, D, L, K, P, Pk, guard=0.3, empty_doc=None):
    """Packed-sweep inputs: doc-contiguous tokens, a ragged last document
    (c = 0 after its first half), a ``guard`` share of tokens on the guard
    id P, optionally one document ``empty_doc`` with no tokens at all (all
    guard, c = 0); theta consistent with mu; phi_pack above each token's
    own c*mu, as a statistic that holds the batch is, except one entry a
    few ulp below 0 whose tokens carry almost no mass there (what the
    incremental row scatters leave; the packed formulation does not clamp
    it)."""
    rng = np.random.default_rng(seed)
    T = D * L
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    counts = rng.integers(1, 4, (T, 1)).astype(np.float32)
    counts[(doc_ids == D - 1) & (np.tile(np.arange(L), D) >= L // 2)] = 0.0
    p_tok = rng.integers(0, P, T).astype(np.int32)
    p_tok[rng.random(T) < guard] = P
    if empty_doc is not None:
        p_tok[doc_ids == empty_doc] = P
        counts[doc_ids == empty_doc] = 0.0
    sel_k = np.ascontiguousarray(
        np.argsort(rng.random((P, K)), axis=1)[:, :Pk].astype(np.int32))
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu[p_tok == 0, sel_k[0, 0]] = 1e-9
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, counts * mu)
    phi_pack = (rng.random((P, Pk)) * 5 + 3).astype(np.float32)
    phi_pack[0, 0] = -1e-7
    phi_tot = (rng.random(K) * 50 + 30).astype(np.float32)
    return p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k


def _reference_composition(case, wbeta):
    """The reference's packed path around its kernel: ``_gather_selection``,
    the kernel's jnp oracle (phi_pack padded with the guard row the
    reference's wrapper adds) and ``_apply_token_update``."""
    p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k = \
        [jnp.asarray(x) for x in case]
    P, Pk = sel_k.shape
    Dn = theta.shape[0]
    layout = JLayout(word_ids=jnp.zeros_like(p_tok), counts=counts,
                     doc_ids=doc_ids, num_docs=Dn,
                     max_len=p_tok.shape[0] // Dn)
    k_tok, mu_sel, theta_sel, pt_sel = jp._gather_selection(
        layout, mu, theta, phi_tot, sel_k, p_tok, P)
    phi1 = jnp.concatenate([phi_pack, jnp.zeros((1, Pk))], axis=0)
    mu_new_sel, d_pack, r_pack = power_sweep_tokens_ref(
        p_tok, counts, mu_sel, theta_sel, pt_sel, phi1, alpha=ALPHA,
        beta=BETA, wbeta=wbeta, n_pow=P)
    mu_new, theta_new, _ = jp._apply_token_update(layout, mu, theta, k_tok,
                                                  mu_sel, mu_new_sel)
    return mu_new, theta_new, d_pack[:P], r_pack[:P]


@pytest.mark.parametrize("D_,L_,K_,P,Pk,guard,empty", [
    (6, 8, 20, 9, 5, 0.3, None),          # generic, ragged last document
    (4, 12, 100, 7, 37, 0.3, 1),          # odd Pk, an empty document
    (3, 16, 30, 5, 30, 0.2, None),        # Pk = K
    (5, 8, 16, 4, 1, 0.3, 2),             # Pk = 1
    (4, 8, 24, 6, 8, 1.0, None)])         # an all-guard batch
@pytest.mark.parametrize("onehot", [False, True])
def test_power_sweep_tokens_plain_matches_reference_composition(
        D_, L_, K_, P, Pk, guard, empty, onehot):
    case = _sweep_case(D_ * 100 + K_ + Pk, D=D_, L=L_, K=K_, P=P, Pk=Pk,
                       guard=guard, empty_doc=empty)
    p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k = case
    wbeta = 0.3
    want = _reference_composition(case, wbeta)
    mu_t, theta_t = t(mu), t(theta)
    before = packed.power_sweep_tokens.launches
    got = packed.power_sweep_tokens(
        t(p_tok), t(doc_ids), t(counts), mu_t, theta_t, t(phi_tot),
        t(phi_pack), t(sel_k), alpha=ALPHA, beta=BETA, wbeta=wbeta,
        onehot=onehot)
    assert packed.power_sweep_tokens.launches == before
    assert got[0] is mu_t                                  # in place
    np.testing.assert_array_equal(theta_t.numpy(), theta)  # theta read only
    _close(got[0], want[0], RTOL, ATOL, "mu")
    _close(theta + got[1].numpy(), want[1], RTOL, ATOL, "theta")
    _close(got[2], want[2], RTOL, ATOL, "d_pack")
    _close(got[3], want[3], RTOL, ATOL, "r_pack")
    # untouched coordinates, bit for bit: every element of a guard token,
    # and every topic outside a power token's selection
    selected = np.zeros(mu.shape, bool)
    power_tok = p_tok < P
    rows = np.nonzero(power_tok)[0]
    selected[rows[:, None], sel_k[p_tok[rows]]] = True
    np.testing.assert_array_equal(mu_t.numpy()[~selected], mu[~selected])
    assert not got[1].numpy()[~np.isin(np.arange(D_), doc_ids[power_tok])
                              ].any()
    # the renormalization conserves each token's mass
    np.testing.assert_allclose(mu_t.numpy().sum(1), mu.sum(1), rtol=1e-5)
    if guard == 1.0:
        np.testing.assert_array_equal(mu_t.numpy(), mu)
        assert not got[1].any() and not got[2].any() and not got[3].any()


def test_power_sweep_tokens_reads_the_incoming_theta():
    """A Jacobi sweep: two tokens of one document, one topic each, see the
    theta of the start of the sweep.  An update that wrote theta as it
    went would give the second token another result."""
    case = list(_sweep_case(5, D=1, L=4, K=6, P=2, Pk=3, guard=0.0))
    p_tok = case[0]
    p_tok[:] = [0, 1, 0, 1]
    case[7] = np.array([[0, 1, 2], [0, 1, 3]], np.int32)  # shared topics
    want = _reference_composition(case, 0.3)
    alone = []
    for tok in range(4):                       # each token by itself
        one = [x.copy() for x in case]
        one[0][:] = 2
        one[0][tok] = p_tok[tok]
        mu_t = t(one[3])
        packed.power_sweep_tokens_plain(
            *[t(x) for x in one[:3]], mu_t, *[t(x) for x in one[4:]],
            alpha=ALPHA, beta=BETA, wbeta=0.3)
        alone.append(mu_t.numpy()[tok])
    mu_t = t(case[3])
    packed.power_sweep_tokens(*[t(x) for x in case[:3]], mu_t,
                              *[t(x) for x in case[4:]], alpha=ALPHA,
                              beta=BETA, wbeta=0.3)
    _close(mu_t, want[0], RTOL, ATOL, "mu")
    _close(mu_t, np.stack(alone), RTOL, ATOL, "mu, token by token")


def test_power_sweep_tokens_rejects_other_devices():
    case = _sweep_case(1, D=2, L=4, K=8, P=3, Pk=2)
    meta = [t(x).to("meta") for x in case]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        packed.power_sweep_tokens(*meta, alpha=ALPHA, beta=BETA, wbeta=0.3)
    mat, sel_w, sel_k = _pack_case(1, W=10, K=8, P=3, Pk=2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pack_ops.pack_rows(t(mat).to("meta"), t(sel_w), t(sel_k))


# --------------------------------------------------------------- the sweep order

def _word_case(seed, *, word0_power):
    """A CLI-like batch (padding slots on word 0 with count 0), its token
    layout, and a power selection with or without word 0 in it."""
    jb, tb, _ = _batch(seed, mean=20)
    layout = tb.token_layout()
    words = np.unique(np.asarray(jb.word_ids))
    P = LDAConfig(vocab_size=W, num_topics=K).num_power_words
    rng = np.random.default_rng(seed)
    sel_w = rng.choice(words[words != 0], P, replace=False).astype(np.int32)
    if word0_power:
        sel_w[P // 2] = 0
    p_tok = power.token_power_rows(layout.word_ids, t(sel_w), W)
    return layout, sel_w, p_tok


def _runs(order, p_tok, counts, P, chunk=32):
    """The kernel's d/r partition in plain numpy: the runs of counted power
    tokens along the order, each cut at the boundaries of the chunks of
    ``chunk`` positions that the sweep warps take.  Returns [(row, [[token,
    ...] per chunk the run covers])]: the kernel sums each part in token
    order, then adds the parts in chunk order."""
    order = np.asarray(order)
    p = np.asarray(p_tok)[order]
    c = np.asarray(counts).reshape(-1)[order]
    key = np.where((p >= 0) & (p < P) & (c != 0), p, -1)
    runs = []
    for i in range(len(order)):
        if key[i] < 0 or (i > 0 and key[i - 1] == key[i]):
            continue
        end = i
        while end < len(order) and key[end] == key[i]:
            end += 1
        parts = [order[a:min(end, (a // chunk + 1) * chunk)].tolist()
                 for a in [i] + list(range((i // chunk + 1) * chunk, end,
                                           chunk))]
        runs.append((int(key[i]), parts))
    return runs


@pytest.mark.parametrize("seed,word0_power", [(1, False), (2, True),
                                              (3, True)])
def test_sweep_order_matches_numpy_and_keeps_rows_contiguous(seed,
                                                             word0_power):
    """The layout's sweep order is numpy's stable argsort by (count == 0,
    word); each power row's counted tokens form one run of it (word 0's
    too, when it is a power word: its padding slots gather after every
    counted token), and every counted power token lies in exactly one run
    of the fold kernel's partition."""
    layout, sel_w, p_tok = _word_case(seed, word0_power=word0_power)
    words = layout.word_ids.numpy().astype(np.int64)
    counts = layout.counts.numpy().reshape(-1)
    order = layout.sweep_order
    assert order.dtype == torch.int32 and layout.sweep_order is order
    want = np.argsort(words + (counts == 0).astype(np.int64) * 2 ** 32,
                      kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    n_zero = int((counts == 0).sum())
    assert n_zero > 0 and (counts[want[len(want) - n_zero:]] == 0).all()
    P = len(sel_w)
    runs = _runs(order, p_tok, layout.counts, P)
    rows = [r for r, _ in runs]
    assert len(rows) == len(set(rows))                 # one run a row
    seen = np.concatenate([tk for _, parts in runs for tk in parts])
    pt = p_tok.numpy()
    counted = np.nonzero((pt < P) & (counts != 0))[0]
    np.testing.assert_array_equal(np.sort(seen), counted)  # each once
    np.testing.assert_array_equal(
        np.bincount(pt[counted], minlength=P),
        np.bincount(rows, weights=[sum(map(len, x)) for _, x in runs],
                    minlength=P).astype(np.int64))
    if word0_power:
        row0 = int(np.nonzero(sel_w == 0)[0][0])
        assert (pt[words == 0] == row0).all()
        assert (row0 in rows) == bool(((words == 0) & (counts != 0)).any())


@pytest.mark.parametrize("D_,L_,K_,P,Pk,guard,empty", [
    (6, 8, 20, 9, 5, 0.3, None),
    (4, 12, 100, 7, 37, 0.3, 1),
    (3, 16, 30, 5, 30, 0.2, None),
    (5, 8, 16, 4, 1, 0.3, 2),
    (12, 40, 24, 3, 8, 0.1, None),            # runs spanning many chunks
    (40, 20, 12, 2, 4, 0.0, 3)])             # runs of hundreds of tokens
def test_kernel_fold_of_the_cd_stream_matches_reference_composition(
        D_, L_, K_, P, Pk, guard, empty):
    """The kernel's order of sums, in numpy: the [T, Pk] cd stream of the
    plain sweep folded into theta_delta per document in token order, and
    into d/r per run of the wrapper's default sweep order, agrees with the
    reference's composition at rel 1e-5."""
    case = _sweep_case(D_ * 100 + K_ + Pk + 1, D=D_, L=L_, K=K_, P=P, Pk=Pk,
                       guard=guard, empty_doc=empty)
    p_tok, doc_ids, counts, mu, theta, phi_tot, phi_pack, sel_k = case
    want = _reference_composition(case, 0.3)
    mu_t = t(mu)
    packed.power_sweep_tokens_plain(
        t(p_tok), t(doc_ids), t(counts), mu_t, t(theta), t(phi_tot),
        t(phi_pack), t(sel_k), alpha=ALPHA, beta=BETA, wbeta=0.3)
    power_tok = p_tok < P
    rows = np.where(power_tok, p_tok, 0)
    k_tok = sel_k[rows]
    tok = np.arange(len(p_tok))[:, None]
    cd = counts * (mu_t.numpy()[tok, k_tok] - mu[tok, k_tok])   # [T, Pk]
    theta_delta = np.zeros_like(theta)
    for tt in range(len(p_tok)):                 # token order, per document
        if power_tok[tt] and counts[tt, 0] != 0:
            theta_delta[doc_ids[tt], k_tok[tt]] += cd[tt]
    keys = torch.where(t(p_tok) < P, t(p_tok), P)
    order = packed.sweep_order(keys, t(counts))
    d_pack = np.zeros((P, Pk), np.float32)
    r_pack = np.zeros((P, Pk), np.float32)
    for row, parts in _runs(order, p_tok, counts, P):
        for part in parts:                       # chunk order
            dp = np.zeros(Pk, np.float32)
            rp = np.zeros(Pk, np.float32)
            for tt in part:                      # token order in a chunk
                dp += cd[tt]
                rp += np.abs(cd[tt])
            d_pack[row] += dp
            r_pack[row] += rp
    _close(theta + theta_delta, want[1], RTOL, ATOL, "theta")
    _close(d_pack, want[2], RTOL, ATOL, "d_pack")
    _close(r_pack, want[3], RTOL, ATOL, "r_pack")


# --------------------------------------------------------------- the formulation

def _cfgs(**kw):
    base = dict(vocab_size=W, num_topics=K, lambda_k_abs=8,
                sweep_policy="packed")
    base.update(kw)
    return JConfig(**base), LDAConfig(**base)


def _batch(seed, *, mean=40):
    docs, _, true_phi = j_lda_corpus(seed, D, W, K, doc_len_mean=mean)
    jb = j_docs_to_padded(docs, max_len=L)
    return jb, MiniBatch(t(jb.word_ids), t(jb.counts)), true_phi


def _selective_inputs(seed, Pk=5):
    jb, tb, true_phi = _batch(seed)
    rng = np.random.default_rng(seed)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (D, L, K),
                                      minval=0.01, maxval=1.0))
    mu = (u / u.sum(-1, keepdims=True)).astype(np.float32)
    phi_eff = (true_phi.T * 50 * rng.random(true_phi.T.shape)).astype(
        np.float32)
    np.add.at(phi_eff, np.asarray(jb.word_ids),
              np.asarray(jb.counts)[..., None] * mu)
    theta = np.einsum("dl,dlk->dk", np.asarray(jb.counts), mu)
    P = LDAConfig(vocab_size=W, num_topics=K).num_power_words
    sel_w = rng.choice(np.unique(np.asarray(jb.word_ids)), P,
                       replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    arrays = (mu.reshape(D * L, K), theta, phi_eff, phi_eff.sum(0), sel_w,
              sel_k)
    return jb, tb, arrays


@pytest.mark.parametrize("crossover", [0, 10 ** 12],
                         ids=["row_scatter", "onehot"])
def test_selective_sweep_packed_matches_reference(crossover):
    """The port's packed formulation against the reference's jnp
    ``_selective_sweep_packed`` on both sides of ``onehot_crossover``."""
    jcfg, cfg = _cfgs(onehot_crossover=crossover)
    jb, tb, arrays = _selective_inputs(7)
    want = jp._selective_sweep_packed(jb.token_layout(),
                                      *[jnp.asarray(a) for a in arrays], jcfg)
    before = (pack_ops.pack_rows.launches,
              packed.power_sweep_tokens.launches)
    got = pobp._selective_sweep_packed(tb.token_layout(),
                                       *[t(a) for a in arrays], cfg)
    assert (pack_ops.pack_rows.launches,
            packed.power_sweep_tokens.launches) == before
    for name, g, w in zip(("mu", "theta", "d_pack", "r_pack"), got, want):
        _close(g, w, RTOL, 1e-5, name)
    # the policy dispatch reaches the same formulation
    again = pobp.selective_sweep_tokens(tb.token_layout(),
                                        *[t(a) for a in arrays], cfg)
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
    power_tok = np.isin(np.asarray(jb.word_ids).reshape(-1), arrays[4])
    np.testing.assert_array_equal(got[0].numpy()[~power_tok],
                                  arrays[0][~power_tok])


def _cli_args(**kw):
    flags = dict(minibatches=3, docs_per_batch=24, vocab=W, topics=K,
                 lambda_k=8, inner_iters=8, tol=0.05, seed=4,
                 sweep_policy="packed")
    flags.update(kw)
    argv = []
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return cli.build_parser().parse_args(argv + ["--device", "cpu"]), flags


def test_make_train_step_packed_matches_reference_over_the_cli_stream():
    """Three mini-batches of the CLI's stream through the port's packed
    step and the reference's (its jnp packed formulation), the reference's
    per-step draws injected: iterations equal, phi_acc at rtol 1e-4.  The
    tolerance 0.3 stops two of the three on it (8, 7 and 5 iterations)."""
    args, flags = _cli_args(tol=0.3)
    jargs = jcli.default_args(**flags, shards=1)
    cfg, buckets = cli._build_cfg(args)
    jcfg = jcli._build_cfg(jargs)[0]
    assert cfg.sweep_policy == jcfg.sweep_policy == "packed"
    assert jcfg.impl == "jnp" and j_resolve(jcfg, 1, K, 8, 30) == "packed"
    jstep, _ = jp.make_train_step(jcfg, 1)
    jstate = jp.init_train_state(jcfg, args.seed)
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state = pobp.init_train_state(cfg, args.seed, device="cpu")
    key = jstate.rng
    stops = []
    for mb, _ in cli.synthetic_stream(args, buckets)():
        key, sub = jax.random.split(key)
        Dm, Lm = mb.word_ids.shape
        u0 = jax.random.uniform(sub, (Dm, max(cfg.init_pad_len, Lm), K),
                                minval=0.01, maxval=1.0)
        jstate, jdiag = jstep(jstate, jnp.asarray(mb.word_ids.numpy()),
                              jnp.asarray(mb.counts.numpy()))
        state, diag = step(state, mb.word_ids, mb.counts, u0=t(u0))
        assert diag["iters"] == int(jdiag["iters"])
        stops.append(diag["iters"])
        _close(diag["mean_r"], jdiag["mean_r"], 1e-4, 0, "mean_r")
        _close(diag["theta"], jdiag["theta"], 1e-4, 1e-4, "theta")
        _close(state.phi_acc, jstate.phi_acc, 1e-4, 1e-4, "phi_acc")
    assert stops[0] == 8 and 1 < stops[2] < 8            # tolerance stops


def test_packed_and_carry_policies_agree_on_a_step():
    """The same sweep in two formulations: one step from one init, with
    residual_tol 0 and a fixed iteration count so that both run alike."""
    _, tb, _ = _batch(11)
    u0 = torch.from_numpy(np.random.default_rng(0).uniform(
        0.01, 1.0, (D, L, K)).astype(np.float32))
    out = {}
    for policy in ("packed", "auto"):
        cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=8,
                        inner_iters=8, residual_tol=0.0, sweep_policy=policy)
        step, _ = pobp.make_train_step(cfg, device="cpu")
        state, diag = step(pobp.init_train_state(cfg, device="cpu"),
                           tb.word_ids, tb.counts, u0=u0)
        assert diag["iters"] == 8
        out[policy] = (state.phi_acc, diag["theta"])
    for a, b in zip(out["packed"], out["auto"]):
        gap = float((a - b).abs().sum() / b.abs().sum())
        assert gap <= 1e-5, gap


# --------------------------------------------------------------- policy, driver

def test_resolve_sweep_policy_follows_the_reference_pallas_branch():
    for name in POLICIES:
        cfg = LDAConfig(vocab_size=W, num_topics=K, sweep_policy=name)
        want = j_resolve(JConfig(vocab_size=W, num_topics=K,
                                 sweep_policy=name, impl="pallas"),
                         D * L, K, 8, 30, n_docs=D)
        got = resolve_sweep_policy(cfg)
        assert got == ("packed" if name == "packed" else "dense_layout")
        assert (got == "packed") == (want == "packed")
    bogus = LDAConfig(vocab_size=W, num_topics=K, sweep_policy="bogus")
    with pytest.raises(ValueError) as mine:
        resolve_sweep_policy(bogus)
    with pytest.raises(ValueError) as theirs:
        j_resolve(JConfig(vocab_size=W, num_topics=K, sweep_policy="bogus"),
                  D * L, K, 8, 30)
    assert str(mine.value) == str(theirs.value)
    for build in (lambda: pobp.make_train_step(bogus, device="cpu"),
                  lambda: pobp.init_train_state(bogus, device="cpu")):
        with pytest.raises(ValueError, match="unknown sweep_policy: 'bogus'"):
            build()


def test_cli_parser_takes_every_flag_of_the_reference_driver():
    """The docstring's promise: each flag of the reference's parser exists
    in the port's, with the reference's default; ``--impl``'s default
    follows ``--device`` (None), which resolves to the reference's "jnp" on
    the CPU."""
    args = cli.build_parser().parse_args([])
    mine = vars(args)
    theirs = vars(jcli.build_parser().parse_args([]))
    assert set(theirs) <= set(mine)
    skip = ("shards", "impl")
    assert {k: mine[k] for k in theirs if k not in skip} == \
        {k: v for k, v in theirs.items() if k not in skip}
    assert mine["impl"] is None
    args.device = "cpu"
    assert cli.resolve_impl(args) == theirs["impl"] == "jnp"


@pytest.mark.parametrize("flag,item", [
    (["--ps-servers", "2"], "item 7"),
    (["--mesh", "multi"], "item 5"),
    (["--vocab-growth-per-batch", "3"], "item 6")])
def test_cli_rejects_the_newly_listed_flags_naming_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {item}"):
        cli.main(["--minibatches", "1", "--device", "cpu"] + flag)


def test_cli_trains_the_packed_policy_with_prefetch(capsys):
    res = cli.main(["--minibatches", "3", "--docs-per-batch", "16",
                    "--vocab", "200", "--topics", "8", "--lambda-k", "4",
                    "--sweep-policy", "packed", "--prefetch", "3",
                    "--onehot-crossover", "0", "--inner-iters", "6",
                    "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[done] 3 minibatches" in out and len(res["iters"]) == 3
    assert all(1 < i <= 6 for i in res["iters"])
    assert float(res["phi_acc"].sum()) == pytest.approx(res["tokens"],
                                                        rel=1e-5)
    args, _ = _cli_args(onehot_crossover=0, prefetch=0)
    cfg, _ = cli._build_cfg(args)
    assert cfg.onehot_crossover == 0 and cfg.sweep_policy == "packed"
    assert dataclasses.replace(cfg, onehot_crossover=8_000_000) == \
        cli._build_cfg(_cli_args()[0])[0]

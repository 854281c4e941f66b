"""The port's single-device POBP training slice held against the JAX
package: residual helpers, power selection, the dense and selective
sweeps, one mini-batch (``pobp_minibatch``) in both sync modes, the
streaming step over the CLI's stream, evaluation, the seed oracle, the
batching streams, and the CLI's checkpoints.

JAX's random draws cannot be reproduced in torch, so each test injects
the reference's draw: ``u0``, the ``jax.random.uniform`` field of the
step's key, for ``pobp_minibatch`` and the step; ``mu0`` for fold-in.
The reference runs its jnp path (``sweep_policy='dense_layout'``), never
the Pallas carry kernel, which does not trace on the installed jax.

Tolerances: the port sums in other orders than XLA (the renormalization
over K, ``index_add_`` against XLA's scatter, einsum against dot), so a
mini-batch is held to rtol 1e-4 over up to 30 iterations; single sweeps
to rtol 1e-5.  ``iters`` must match exactly.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perplexity as jperp
from repro.core import pobp as jp
from repro.core import power as jpw
from repro.core import ref as jref
from repro.core import residuals as jres
from repro.core.sync import LocalReducer as JLocalReducer
from repro.core.types import LDAConfig as JConfig
from repro.core import infer as jinfer
from repro.data import batching as jbatching
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro.dist import checkpoint as jckpt
from repro.kernels.bp_update.ops import dense_sweep_pallas
from repro.launch import lda_train as jcli
from repro_torch import convert
from repro_torch.core import perplexity, pobp, power, ref, residuals
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.data import batching
from repro_torch.launch import lda_train as cli

W, K, D, L = 300, 16, 32, 32


def t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, *, D=D, L=L, W=W, K=K, mean=40):
    docs, _, true_phi = j_lda_corpus(seed, D, W, K, doc_len_mean=mean)
    jb = j_docs_to_padded(docs, max_len=L)
    return jb, MiniBatch(t(jb.word_ids), t(jb.counts)), true_phi


def _phi_acc(true_phi, seed=0):
    rng = np.random.default_rng(seed)
    return (true_phi.T * 50 * rng.random(true_phi.T.shape)).astype(np.float32)


def _cfgs(**kw):
    base = dict(vocab_size=W, num_topics=K, lambda_k_abs=8)
    base.update(kw)
    return JConfig(**base, sweep_policy="dense_layout"), LDAConfig(**base)


def _close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


# --------------------------------------------------------------- helpers

def test_residual_helpers_match_reference():
    rng = np.random.default_rng(0)
    jb, tb, _ = _batch(1)
    vals = rng.random((D, L, K)).astype(np.float32)
    _close(residuals.token_scatter_wk(tb.word_ids, t(vals), W),
           jres.token_scatter_wk(jb.word_ids, jnp.asarray(vals), W),
           1e-6, 1e-6)
    doc_ids = np.repeat(np.arange(4), 5).astype(np.int32)
    k_tok = rng.integers(0, K, (20, 3)).astype(np.int32)
    v = rng.random((20, 3)).astype(np.float32)
    _close(residuals.token_topic_segment_sum(t(doc_ids), t(k_tok), t(v), 4, K),
           jres.token_topic_segment_sum(jnp.asarray(doc_ids),
                                        jnp.asarray(k_tok), jnp.asarray(v),
                                        4, K), 1e-6, 1e-6)
    r_w = rng.random(W).astype(np.float32)
    _close(residuals.mean_residual(t(r_w), 123.0),
           jres.mean_residual(jnp.asarray(r_w), jnp.float32(123.0)),
           1e-6, 0)
    assert float(residuals.mean_residual(t(r_w), 0.0)) == \
        pytest.approx(float(r_w.sum()), rel=1e-6)       # tokens clamp at 1
    r_glob = rng.random((W, K)).astype(np.float32)
    sel_w = rng.choice(W, 30, replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, 5, replace=False)
                      for _ in range(30)]).astype(np.int32)
    r_pack = rng.random((30, 5)).astype(np.float32)
    _close(residuals.packed_rw_delta(t(r_glob), t(sel_w), t(sel_k),
                                     t(r_pack)),
           jres.packed_rw_delta(*[jnp.asarray(x) for x in
                                  (r_glob, sel_w, sel_k, r_pack)]),
           1e-6, 1e-6)


def test_select_power_words_and_topics_match_top_k_with_zero_ties():
    """Untouched words (and topics) tie at zero residual; torch.topk may
    break those ties differently from lax.top_k, so the test pins the set
    of selected words with a non-zero residual, and the order of the rest
    where no ties exist."""
    rng = np.random.default_rng(3)
    r_w = np.zeros(W, np.float32)
    live = rng.choice(W, 20, replace=False)
    r_w[live] = rng.random(20).astype(np.float32) + 0.1
    P = 30                                        # more than the 20 non-zero
    got = power.select_power_words(t(r_w), P).numpy()
    want = np.asarray(jpw.select_power_words(jnp.asarray(r_w), P))
    assert got.dtype == np.int32 and len(set(got)) == P
    nz = lambda sel: set(int(w) for w in sel if r_w[w] > 0)  # noqa: E731
    assert nz(got) == nz(want) == set(int(w) for w in live)
    np.testing.assert_array_equal(got[:20], want[:20])   # distinct values
    r_wk = np.zeros((W, K), np.float32)
    r_wk[live, :10] = rng.random((20, 10)).astype(np.float32) + 0.1
    sel_w = want[:25]                              # 5 all-zero rows
    got_k = power.select_power_topics(t(r_wk), t(sel_w), 12).numpy()
    want_k = np.asarray(jpw.select_power_topics(jnp.asarray(r_wk),
                                                jnp.asarray(sel_w), 12))
    np.testing.assert_array_equal(got_k[:20, :10], want_k[:20, :10])
    for g, w_ in zip(got_k, want_k):             # tied tails and rows
        assert len(set(g)) == len(set(w_)) == 12


def test_row_maps_and_packed_scatters_match_reference():
    rng = np.random.default_rng(4)
    jb, tb, _ = _batch(2)
    sel_w = rng.choice(W, 30, replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, 6, replace=False)
                      for _ in range(30)]).astype(np.int32)
    vals = rng.standard_normal((30, 6)).astype(np.float32)
    mat = rng.random((W, K)).astype(np.float32)
    np.testing.assert_array_equal(
        power.word_to_row(t(sel_w), W).numpy(),
        np.asarray(jpw.word_to_row(jnp.asarray(sel_w), W)))
    np.testing.assert_array_equal(
        power.token_power_rows(tb.word_ids.reshape(-1), t(sel_w), W).numpy(),
        np.asarray(jpw.token_power_rows(jb.word_ids.reshape(-1),
                                        jnp.asarray(sel_w), W)))
    args = [jnp.asarray(x) for x in (mat, sel_w, sel_k)]
    np.testing.assert_array_equal(power.pack_rows(t(mat), t(sel_w),
                                                  t(sel_k)).numpy(),
                                  np.asarray(jpw.pack_rows(*args)))
    for mine, theirs in ((power.scatter_add_rows, jpw.scatter_add_rows),
                         (power.scatter_set_rows, jpw.scatter_set_rows)):
        m = t(mat)
        assert mine(m, t(sel_w), t(sel_k), t(vals)) is m       # in place
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(theirs(*args, jnp.asarray(vals))))


# --------------------------------------------------------------- sweeps

def _mu0(seed, shape):
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                      minval=0.01, maxval=1.0))
    return u / u.sum(-1, keepdims=True)


@pytest.mark.parametrize("Kx,Lx", [(16, 32), (100, 24), (130, 16)])
def test_dense_sweep_matches_jnp_and_pallas_interpret(Kx, Lx):
    jcfg, cfg = _cfgs(num_topics=Kx)
    jb, tb, true_phi = _batch(5, K=Kx, L=Lx)
    mu = _mu0(0, (D, Lx, Kx)).astype(np.float32)
    phi_eff = _phi_acc(true_phi) + np.asarray(jres.token_scatter_wk(
        jb.word_ids, jb.counts[..., None] * mu, W))
    phi_tot = phi_eff.sum(0)
    got_mu, got_r = pobp.dense_sweep(tb, t(mu), t(phi_eff), t(phi_tot), cfg)
    for want_mu, want_r in (
            jp.dense_sweep(jb, jnp.asarray(mu), jnp.asarray(phi_eff),
                           jnp.asarray(phi_tot), jcfg, JLocalReducer()),
            dense_sweep_pallas(jb, jnp.asarray(mu), jnp.asarray(phi_eff),
                               jnp.asarray(phi_tot), jcfg)):
        _close(got_mu, want_mu, 1e-5, 1e-6, "mu")
        _close(got_r, want_r, 1e-5, 1e-5, "r_wk")


def _selective_inputs(seed, Pk=5):
    jcfg, cfg = _cfgs()
    jb, tb, true_phi = _batch(seed)
    rng = np.random.default_rng(seed)
    mu = _mu0(seed, (D, L, K)).astype(np.float32)
    phi_eff = _phi_acc(true_phi, seed) + np.asarray(jres.token_scatter_wk(
        jb.word_ids, jb.counts[..., None] * mu, W))
    phi_tot = phi_eff.sum(0)
    theta = np.einsum("dl,dlk->dk", np.asarray(jb.counts), mu)
    P = cfg.num_power_words
    sel_w = rng.choice(np.unique(np.asarray(jb.word_ids)), P,
                       replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    arrays = (mu.reshape(D * L, K), theta, phi_eff, phi_tot, sel_w, sel_k)
    return jcfg, cfg, jb, tb, arrays


def _carry_ref_sweep(layout, *arrays_and_cfg):
    """The reference's carry formulation (its [P+1, K] table build) with
    its Pallas kernel replaced by the kernel's jnp oracle, which traces
    here where the kernel does not."""
    from repro.kernels.power_sweep import ops as jops
    from repro.kernels.power_sweep.ref import power_sweep_carry_ref

    def oracle(*args, kblocked=False, vmem_budget_bytes=None, **kw):
        return power_sweep_carry_ref(*args, **kw)

    *arrays, jcfg = arrays_and_cfg
    with mock.patch.object(jops, "power_sweep_carry", oracle):
        return jp._selective_sweep_carry_pallas(
            layout, *[jnp.asarray(a) for a in arrays], jcfg)


@pytest.mark.parametrize("formulation", ["dense_layout", "packed",
                                         "carry_ref"])
def test_selective_sweep_matches_reference_formulations(formulation):
    """The port's sweep (the carry formulation: on the CPU the plain
    version of ``power_sweep_carry_train``, which reads sel_w and sel_k
    directly) against the reference's two jnp formulations and its carry
    kernel's jnp oracle over the [P+1, K] row tables it builds: the same
    math."""
    jcfg, cfg, jb, tb, arrays = _selective_inputs(7)
    jl = jb.token_layout()
    if formulation == "carry_ref":
        want = _carry_ref_sweep(jl, *arrays, jcfg)
    else:
        want = {"dense_layout": jp._selective_sweep_dense_layout,
                "packed": jp._selective_sweep_packed}[formulation](
            jl, *[jnp.asarray(a) for a in arrays], jcfg)
    got = pobp.selective_sweep_tokens(tb.token_layout(),
                                      *[t(a) for a in arrays], cfg)
    for name, g, w in zip(("mu", "theta", "d_pack", "r_pack"), got, want):
        _close(g, w, 1e-5, 1e-5, name)
    mu0 = arrays[0]
    power_tok = np.isin(np.asarray(jb.word_ids).reshape(-1), arrays[4])
    np.testing.assert_array_equal(got[0].numpy()[~power_tok],
                                  mu0[~power_tok])


# --------------------------------------------------------------- mini-batch

def _run_pair(sync, tol, iters, *, seed=5, **cfg_kw):
    jcfg, cfg = _cfgs(inner_iters=iters, residual_tol=tol, **cfg_kw)
    jb, tb, true_phi = _batch(seed)
    phi_acc = _phi_acc(true_phi)
    key = jax.random.PRNGKey(seed + 1)
    total = jnp.sum(jb.counts)
    weight = float(jp._delta_weight(jcfg, jnp.int32(3)))
    jdecay = jp._decay_factor(jcfg, jnp.int32(3))
    want = jp.pobp_minibatch(jb, jnp.asarray(phi_acc), key, total,
                             jnp.float32(weight), jcfg, JLocalReducer(),
                             sync_mode=sync, decay=jdecay)
    Lpad = L if cfg.init_pad_len is None else max(cfg.init_pad_len, L)
    u0 = np.asarray(jax.random.uniform(key, (D, Lpad, K), minval=0.01,
                                       maxval=1.0))
    acc = t(phi_acc)
    got = pobp.pobp_minibatch(tb, acc, float(total), pobp._delta_weight(cfg, 3),
                              cfg, sync_mode=sync,
                              decay=pobp._decay_factor(cfg, 3), u0=t(u0))
    np.testing.assert_array_equal(acc.numpy(), phi_acc)  # input untouched
    return want, got


@pytest.mark.parametrize("sync,tol,iters", [("power", 0.0, 6),
                                            ("power", 0.3, 30),
                                            ("dense", 0.0, 6),
                                            ("dense", 0.05, 30)])
def test_pobp_minibatch_matches_reference(sync, tol, iters):
    want, got = _run_pair(sync, tol, iters)
    assert got.iters == int(want.iters)
    if tol == 0.0:
        assert got.iters == iters
    else:
        assert 1 < got.iters < iters                   # stopped on tolerance
    _close(got.mean_r, want.mean_r, 1e-4, 0, "mean_r")
    _close(got.phi_acc_new, want.phi_acc_new, 1e-4, 1e-4, "phi_acc_new")
    _close(got.theta, want.theta, 1e-4, 1e-4, "theta")
    _close(got.mu, want.mu, 1e-4, 1e-5, "mu")


def test_pobp_minibatch_decay_power_schedule_and_init_pad_len():
    """The Robbins-Monro decay, the 'power' Eq. 11 schedule and a padded
    init field (init_pad_len > L) all follow the reference."""
    want, got = _run_pair("power", 0.0, 4, lr_schedule="power",
                          decay_kappa=0.5, decay_tau0=2.0, init_pad_len=48)
    assert got.iters == int(want.iters) == 4
    _close(got.phi_acc_new, want.phi_acc_new, 1e-4, 1e-4, "phi_acc_new")
    _close(got.theta, want.theta, 1e-4, 1e-4, "theta")


def test_pobp_minibatch_conserves_mass_and_rejects_unported_modes():
    _, cfg = _cfgs(inner_iters=5, residual_tol=0.0)
    _, tb, _ = _batch(8)
    zero = torch.zeros((W, K))
    g = torch.Generator().manual_seed(0)
    res = pobp.pobp_minibatch(tb, zero, float(tb.counts.sum()), 1.0, cfg,
                              generator=g)
    assert float(res.phi_acc_new.sum()) == pytest.approx(
        float(tb.counts.sum()), rel=1e-5)
    np.testing.assert_allclose(res.mu.sum(-1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 6"):
        pobp.pobp_minibatch(tb, zero, 1.0, 1.0, cfg, live_w=100)
    # a bfloat16 statistic (ported since item 2c) accumulates in float32:
    # from zeros, the same init gives the float32 run's result bit for bit
    res16 = pobp.pobp_minibatch(tb, zero.bfloat16(), float(tb.counts.sum()),
                                1.0, cfg,
                                generator=torch.Generator().manual_seed(0))
    assert res16.phi_acc_new.dtype == torch.float32
    assert torch.equal(res16.phi_acc_new, res.phi_acc_new)
    with pytest.raises(ValueError, match="u0 must have shape"):
        pobp.pobp_minibatch(tb, zero, 1.0, 1.0, cfg, u0=torch.ones(2, 2, 2))
    with pytest.raises(NotImplementedError, match="item 5"):
        pobp.make_train_step(cfg, num_shards=2, device="cpu")
    assert pobp.init_train_state(dataclasses.replace(
        cfg, phi_acc_dtype="bfloat16"), device="cpu").phi_acc.dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="unknown phi_acc_dtype"):
        pobp.init_train_state(dataclasses.replace(
            cfg, phi_acc_dtype="float16"), device="cpu")


def test_sweep_policy_resolves_to_the_carry_kernel():
    """Every policy but ``packed`` runs the one carry formulation, bit for
    bit alike; ``packed`` runs the packed kernels' formulation, the same
    sweep within float associativity (``tests/test_torch_packed.py`` holds
    it against the reference)."""
    _, tb, _ = _batch(8)
    zero = torch.zeros((W, K))
    runs = []
    for policy in ("auto", "dense_layout", "kblocked", "packed"):
        cfg = LDAConfig(vocab_size=W, num_topics=K, lambda_k_abs=8,
                        inner_iters=3, residual_tol=0.0, sweep_policy=policy)
        runs.append(pobp.pobp_minibatch(
            tb, zero, float(tb.counts.sum()), 1.0, cfg,
            generator=torch.Generator().manual_seed(0)).phi_acc_new)
    for other in runs[1:3]:
        np.testing.assert_array_equal(other.numpy(), runs[0].numpy())
    _close(runs[3], runs[0], 1e-5, 1e-5, "packed against carry")
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state, diag = step(pobp.init_train_state(cfg, device="cpu"),
                       tb.word_ids, tb.counts)
    assert diag["iters"] == 3 and state.m == 1


# --------------------------------------------------------------- the step

def _cli_args(**kw):
    flags = dict(minibatches=3, docs_per_batch=24, vocab=W, topics=K,
                 lambda_k=8, inner_iters=8, tol=0.05, seed=4)
    flags.update(kw)
    argv = []
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return cli.build_parser().parse_args(argv + ["--device", "cpu"]), flags


def test_cli_stream_and_eval_split_match_reference():
    args, flags = _cli_args()
    jargs = jcli.default_args(**flags, shards=1)
    cfg, buckets = cli._build_cfg(args)
    jcfg, jbuckets = jcli._build_cfg(jargs)
    assert buckets == jbuckets and cfg.init_pad_len == jcfg.init_pad_len
    mine = list(cli.synthetic_stream(args, buckets)())
    theirs = list(jcli.synthetic_stream(jargs, jbuckets, 0, False)())
    assert len(mine) == len(theirs) == 3
    for (mb, n), (jmb, jn) in zip(mine, theirs):
        assert n == jn
        np.testing.assert_array_equal(mb.word_ids.numpy(), jmb.word_ids)
        np.testing.assert_array_equal(mb.counts.numpy(), jmb.counts)
    for a, b in zip(cli._eval_split(args), jcli._eval_split(jargs)):
        np.testing.assert_array_equal(a.word_ids.numpy(), b.word_ids)
        np.testing.assert_array_equal(a.counts.numpy(), b.counts)


def test_make_train_step_matches_reference_over_the_cli_stream():
    """Three mini-batches of the CLI's stream through both steps, the
    reference's per-step draws (split of the state key) injected."""
    args, flags = _cli_args()
    jargs = jcli.default_args(**flags, shards=1)
    cfg, buckets = cli._build_cfg(args)
    jcfg = dataclasses.replace(jcli._build_cfg(jargs)[0],
                               sweep_policy="dense_layout")
    jstep, _ = jp.make_train_step(jcfg, 1)
    jstate = jp.init_train_state(jcfg, args.seed)
    step, meter = pobp.make_train_step(cfg, device="cpu")
    state = pobp.init_train_state(cfg, args.seed, device="cpu")
    key = jstate.rng
    total = 0.0
    for mb, ntok in cli.synthetic_stream(args, buckets)():
        key, sub = jax.random.split(key)
        Dm, Lm = mb.word_ids.shape
        u0 = jax.random.uniform(sub, (Dm, max(cfg.init_pad_len, Lm), K),
                                minval=0.01, maxval=1.0)
        jstate, jdiag = jstep(jstate, jnp.asarray(mb.word_ids.numpy()),
                              jnp.asarray(mb.counts.numpy()))
        state, diag = step(state, mb.word_ids, mb.counts, u0=t(u0))
        total += ntok
        assert diag["iters"] == int(jdiag["iters"])
        _close(diag["mean_r"], jdiag["mean_r"], 1e-4, 0, "mean_r")
        _close(diag["theta"], jdiag["theta"], 1e-4, 1e-4, "theta")
        _close(state.phi_acc, jstate.phi_acc, 1e-4, 1e-4, "phi_acc")
    assert state.m == int(jstate.m) == 3
    assert float(state.phi_acc.sum()) == pytest.approx(total, rel=1e-5)
    assert meter.total_bytes == 0                 # one shard: nothing crosses


def test_run_stream_numbers_batches_and_continues_a_state():
    _, cfg = _cfgs(inner_iters=4, residual_tol=0.0)
    docs, _, _ = j_lda_corpus(9, 48, W, K, doc_len_mean=20)
    phi, hist, _ = pobp.run_stream(batching.minibatch_stream(docs, 16), cfg,
                                   seed=1, device="cpu")
    assert [h["m"] for h in hist] == [1, 2, 3]
    assert all(h["iters"] == 4 for h in hist)
    tokens = sum(float(c.sum()) for _, c in docs)
    assert float(phi.sum()) == pytest.approx(tokens, rel=1e-5)
    seen = []
    state = pobp.init_train_state(cfg, 1, device="cpu")
    state.m = 3
    _, hist2, _ = pobp.run_stream(
        batching.minibatch_stream(docs[:16], 16), cfg, state=state,
        device="cpu", callback=lambda m, p, rec, th: seen.append(rec["m"]))
    assert [h["m"] for h in hist2] == seen == [4]


def test_evaluate_matches_reference_from_the_same_init():
    jcfg, cfg = _cfgs()
    docs, _, true_phi = j_lda_corpus(11, 24, W, K, doc_len_mean=40)
    tr, te = jbatching.train_test_split_counts(docs, 3)
    jtr, jte = j_docs_to_padded(tr), j_docs_to_padded(te)
    phi_acc = _phi_acc(true_phi)
    key = jax.random.PRNGKey(2)
    want = jperp.evaluate(key, jnp.asarray(phi_acc), jtr, jte, jcfg)
    mu0 = jinfer._init_messages(key, jtr, jcfg, K, JLocalReducer())
    got = perplexity.evaluate(
        t(phi_acc), MiniBatch(t(jtr.word_ids), t(jtr.counts)),
        MiniBatch(t(jte.word_ids), t(jte.counts)), cfg, mu0=t(mu0),
        device="cpu")
    assert got == pytest.approx(want, rel=1e-4)
    phi_norm = perplexity.normalize_phi(t(phi_acc), cfg.beta)
    theta = perplexity.fold_in_theta(
        MiniBatch(t(jtr.word_ids), t(jtr.counts)), phi_norm, cfg,
        mu0=t(mu0), device="cpu")
    _close(theta, jperp.fold_in_theta(key, jtr, jnp.asarray(phi_norm.numpy()),
                                      jcfg), 1e-4, 1e-6)


def test_ref_oracle_matches_reference():
    jcfg, cfg = _cfgs()
    jb, tb, true_phi = _batch(12, D=8, L=16)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (8, 16, K), minval=0.01,
                                      maxval=1.0))
    mu0 = ref.init_messages(tb, K, u=t(u))
    _close(mu0, jref.init_messages(key, jb, K), 1e-6, 1e-7)
    prior = _phi_acc(true_phi).T.copy()                    # [K, W]
    want = jref.batch_bp(key, jb, jcfg, 5, jnp.asarray(prior))
    got = ref.batch_bp(tb, cfg, 5, t(prior), u=t(u))
    for name, g, w in zip(("mu", "phi", "theta", "trace"), got, want):
        _close(g, w, 1e-4, 1e-5, name)
    _close(ref.log_likelihood(tb, got[2], got[1], cfg),
           jref.log_likelihood(jb, want[2], want[1], jcfg), 1e-5, 0)
    sweep = ref.bp_sweep(tb, mu0, t(prior), cfg)
    for name, g, w in zip(("mu", "r_wk", "theta"), sweep,
                          jref.bp_sweep(jb, jnp.asarray(mu0.numpy()),
                                        jnp.asarray(prior), jcfg)):
        _close(g, w, 1e-5, 1e-5, name)


def test_batching_streams_match_reference():
    docs, _, _ = j_lda_corpus(13, 37, W, K, doc_len_mean=30)
    pairs = [(batching.minibatch_stream(docs, 16, max_len=40),
              jbatching.minibatch_stream(docs, 16, max_len=40)),
             (batching.minibatch_stream(docs, 16, prefetch=0),
              jbatching.minibatch_stream(docs, 16, prefetch=0)),
             (batching.bucketed_minibatch_stream(docs, 16,
                                                 len_buckets=(16, 32, 64)),
              jbatching.bucketed_minibatch_stream(docs, 16,
                                                  len_buckets=(16, 32, 64)))]
    for mine, theirs in pairs:
        a, b = list(mine), list(theirs)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.word_ids.numpy(), y.word_ids)
            np.testing.assert_array_equal(x.counts.numpy(), y.counts)
    for x, y in zip(batching.train_test_split_counts(docs, 7),
                    jbatching.train_test_split_counts(docs, 7)):
        for (i1, c1), (i2, c2) in zip(x, y):
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(c1, c2)
    with pytest.raises(NotImplementedError, match="item 5"):
        list(batching.bucketed_minibatch_stream(docs, 16, num_shards=2))
    with pytest.raises(ValueError, match="multiples of 8"):
        list(batching.bucketed_minibatch_stream(docs, 16, len_buckets=(12,)))


def test_prefetched_stream_raises_the_workers_error():
    def gen():
        yield 1
        raise KeyError("boom")

    it = batching.prefetched(gen, 2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_train_state_from_reference_continues_training():
    jcfg, cfg = _cfgs(inner_iters=3)
    jstate = jp.init_train_state(jcfg, 0)
    jb, tb, _ = _batch(14)
    jstep, _ = jp.make_train_step(jcfg, 1)
    jstate, _ = jstep(jstate, jb.word_ids, jb.counts)
    state = convert.train_state_from_reference(np.asarray(jstate.phi_acc),
                                               int(jstate.m), seed=1,
                                               device="cpu")
    np.testing.assert_array_equal(state.phi_acc.numpy(),
                                  np.asarray(jstate.phi_acc))
    assert state.m == 1 and state.generator.device.type == "cpu"
    step, _ = pobp.make_train_step(cfg, device="cpu")
    state, diag = step(state, tb.word_ids, tb.counts)
    assert state.m == 2 and diag["iters"] == 3
    assert float(state.phi_acc.sum()) == pytest.approx(
        2 * float(tb.counts.sum()), rel=1e-5)


# --------------------------------------------------------------- the CLI

def test_cli_checkpoint_restores_in_reference_and_serves_in_port(tmp_path):
    from repro_torch.serve import SlabEngine

    ck = tmp_path / "ck"
    args, _ = _cli_args(minibatches=4, eval_every=2, ckpt_dir=ck,
                        ckpt_every=2, log_every=2)
    res = cli.train_loop(args)
    assert res["iters"] and len(res["mean_r"]) == 4
    assert [s for s, _ in res["ppl_trace"]] == [2, 4]
    assert np.isfinite(res["ppl"]) and res["ppl"] == res["ppl_trace"][-1][1]
    phi, extra, step = jckpt.restore_phi(str(ck))
    assert step == 4 and extra["next_m"] == 4
    assert extra["run"]["vocab"] == W and extra["run"]["topics"] == K
    np.testing.assert_array_equal(np.asarray(phi), res["phi_acc"])
    assert float(np.asarray(phi).sum()) == pytest.approx(res["tokens"],
                                                         rel=1e-5)
    eng = SlabEngine.from_checkpoint(str(ck), slots=4, slot_len=32,
                                     device="cpu")
    docs, _, _ = j_lda_corpus(15, 6, W, K, doc_len_mean=20)
    for d in docs:
        eng.submit(d)
    th = np.stack([r.theta for r in eng.drain()])
    assert th.shape == (6, K) and np.isfinite(th).all()
    np.testing.assert_allclose(th.sum(1), 1.0, atol=1e-5)
    # the same command again resumes (ported since item 4): the checkpoint
    # already covers every mini-batch, so nothing more is trained
    again = cli.train_loop(args)
    assert again["first_m"] == 4 and again["mean_r"] == []
    assert torch.equal(again["phi_acc"], res["phi_acc"])


@pytest.mark.parametrize("flag", [
    ["--shards", "2"], ["--backend", "ps"], ["--dynamic-vocab"],
    ["--staleness", "1"], ["--compact-every", "2"],
    ["--chaos-drop", "0.1"], ["--elastic-events", "join:w1@2"],
    ["--w-growth", "3.0"]])
def test_cli_rejects_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        cli.main(["--minibatches", "1", "--device", "cpu"] + flag)


def test_cli_runs_dense_sync_with_decay(capsys):
    res = cli.main(["--minibatches", "2", "--docs-per-batch", "16",
                    "--vocab", "200", "--topics", "8", "--sync", "dense",
                    "--decay", "1,0.5", "--inner-iters", "4", "--log-every",
                    "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "minibatch     2" in out and "[done] 2 minibatches" in out
    assert res["iters"] == [4, 4] or all(1 < i <= 4 for i in res["iters"])


@pytest.mark.parametrize("sync", ["power", "dense"])
def test_decay_is_billed_as_the_reference_bills_it(sync):
    """With decay_kappa > 0 a single-shard step bills the Robbins-Monro
    decay once per mini-batch (W * K * 4 bytes, phase ``decay``), as the
    reference's ``Reducer.bill`` does: ``bytes_by_phase`` and
    ``per_minibatch_bytes`` equal the reference's, the reference's draws
    injected, over the CLI's stream."""
    args, flags = _cli_args(decay="1,0.5", inner_iters=4)
    jargs = jcli.default_args(**flags, shards=1)
    cfg, buckets = cli._build_cfg(args)
    jcfg = dataclasses.replace(jcli._build_cfg(jargs)[0],
                               sweep_policy="dense_layout")
    assert cfg.decay_kappa == jcfg.decay_kappa == 0.5
    jstep, jmeter = jp.make_train_step(jcfg, 1, sync_mode=sync)
    jstate = jp.init_train_state(jcfg, args.seed)
    step, meter = pobp.make_train_step(cfg, sync_mode=sync, device="cpu")
    state = pobp.init_train_state(cfg, args.seed, device="cpu")
    key = jstate.rng
    for mb, _ in cli.synthetic_stream(args, buckets)():
        key, sub = jax.random.split(key)
        Dm, Lm = mb.word_ids.shape
        u0 = jax.random.uniform(sub, (Dm, max(cfg.init_pad_len, Lm), K),
                                minval=0.01, maxval=1.0)
        jstate, jdiag = jstep(jstate, jnp.asarray(mb.word_ids.numpy()),
                              jnp.asarray(mb.counts.numpy()))
        state, diag = step(state, mb.word_ids, mb.counts, u0=t(u0))
        assert diag["iters"] == int(jdiag["iters"])
    assert meter.bytes_by_phase == jmeter.bytes_by_phase == {"decay": W * K * 4}
    for iters in (1, 4, 30):
        assert meter.per_minibatch_bytes(iters) == \
            jmeter.per_minibatch_bytes(iters) == W * K * 4
    _close(state.phi_acc, jstate.phi_acc, 1e-4, 1e-4, "phi_acc")


def test_cli_with_decay_prints_the_reference_comm_line(capsys):
    """The two drivers, one shard, ``--decay 1,0.5``: the same ``[comm]``
    line (the decay pass billed, nothing else crossing)."""
    argv = ["--minibatches", "2", "--docs-per-batch", "16", "--vocab", "200",
            "--topics", "8", "--decay", "1,0.5", "--inner-iters", "4"]
    cli.main(argv + ["--device", "cpu"])
    mine = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[comm]")]
    jcli.main(argv + ["--shards", "1"])
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[comm]")]
    assert mine == theirs == [
        "[comm] per-minibatch bytes=6,400 (phases: {'decay': 6400})"]

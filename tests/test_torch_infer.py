"""The port's fold-in body (``repro_torch.core.infer``) held against the JAX
package's jnp path (``repro.core.infer``) on the same inputs.

JAX's random draws cannot be reproduced in torch, so the reference's
draws are injected: ``mu0`` from ``repro.core.infer._init_messages`` for
``fold_in_tokens``, and for the slab step the same ``jax.random.uniform``
draw the reference makes in-step (``init_u``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import infer as jinfer
from repro.core import perplexity as jperp
from repro.core.sync import LocalReducer as JLocalReducer
from repro.core.types import LDAConfig as JConfig
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro_torch.core import infer, perplexity
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.data.batching import docs_to_padded, slab_refill
from repro_torch.data.synthetic import lda_corpus

W, K = 150, 16
JCFG = JConfig(vocab_size=W, num_topics=K)
CFG = LDAConfig(vocab_size=W, num_topics=K)


@pytest.fixture(scope="module")
def phi():
    """A normalized phi with one guard row (the serving layout), as numpy."""
    _, _, true_phi = lda_corpus(0, 4, W, K, doc_len_mean=20)
    acc = np.concatenate([true_phi.T * 200.0, np.zeros((1, K), np.float32)])
    return np.array(jperp.normalize_phi(jnp.asarray(acc), JCFG.beta,
                                        live_w=W))


def test_copied_generators_and_batching_match_reference():
    docs, stats, true_phi = lda_corpus(3, 10, W, K, doc_len_mean=25)
    jdocs, jstats, jphi = j_lda_corpus(3, 10, W, K, doc_len_mean=25)
    np.testing.assert_array_equal(true_phi, jphi)
    assert str(stats) == str(jstats)
    for (a, b), (c, d) in zip(docs, jdocs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    mb, jmb = docs_to_padded(docs, max_len=20), j_docs_to_padded(jdocs, 20)
    np.testing.assert_array_equal(mb.word_ids.numpy(), jmb.word_ids)
    np.testing.assert_array_equal(mb.counts.numpy(), jmb.counts)


def test_normalize_phi_matches_reference():
    rng = np.random.default_rng(1)
    acc = (rng.random((40, 8)) * 10).astype(np.float32)
    for live in (None, 31):
        got = perplexity.normalize_phi(torch.from_numpy(acc), 0.01,
                                       live_w=live)
        want = jperp.normalize_phi(jnp.asarray(acc), 0.01, live_w=live)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-8)


def _batch_pair(seed, n=12):
    docs, _, _ = lda_corpus(seed, n, W, K, doc_len_mean=20)
    jb = j_docs_to_padded(docs)
    tb = MiniBatch(torch.from_numpy(np.array(jb.word_ids)),
                   torch.from_numpy(np.array(jb.counts)))
    return jb, tb


@pytest.mark.parametrize("tol,iters", [(0.0, 12), (1e-2, 30)])
def test_fold_in_tokens_matches_jax_jnp(phi, tol, iters):
    """Same injected init, same fixed phi: same sweep count, same theta
    (the tolerance of test_serve.py's dense-oracle test)."""
    for seed in (1, 2):
        jb, tb = _batch_pair(seed)
        key = jax.random.PRNGKey(seed)
        mu0 = jinfer._init_messages(key, jb, JCFG, K, JLocalReducer())
        want = jinfer.fold_in_tokens(key, jb, jnp.asarray(phi), JCFG,
                                     iters=iters, residual_tol=tol,
                                     impl="jnp")
        got = infer.fold_in_tokens(tb, torch.from_numpy(phi), CFG,
                                   iters=iters, residual_tol=tol,
                                   mu0=torch.from_numpy(np.array(mu0)),
                                   device="cpu")
        assert got.iters == int(want.iters)
        if tol == 0.0:
            np.testing.assert_allclose(got.theta.numpy(),
                                       np.asarray(want.theta),
                                       rtol=1e-4, atol=1e-5)
        else:
            assert got.iters < iters
            np.testing.assert_allclose(got.theta.numpy(),
                                       np.asarray(want.theta), atol=1e-4)
        np.testing.assert_allclose(float(got.mean_r), float(want.mean_r),
                                   rtol=1e-3, atol=1e-6)


def test_fold_in_matches_dense_reference_oracle(phi):
    """The port's own dense [D, L, K] oracle agrees with the token-major
    body, and with the JAX oracle, on one injected init."""
    jb, tb = _batch_pair(5)
    key = jax.random.PRNGKey(5)
    mu0 = torch.from_numpy(np.array(
        jinfer._init_messages(key, jb, JCFG, K, JLocalReducer())))
    dense = infer.fold_in_dense_reference(tb, torch.from_numpy(phi), CFG,
                                          iters=10, mu0=mu0, device="cpu")
    tok = infer.fold_in_tokens(tb, torch.from_numpy(phi), CFG, iters=10,
                               mu0=mu0, device="cpu")
    jdense = jinfer.fold_in_dense_reference(key, jb, jnp.asarray(phi),
                                            JCFG, iters=10)
    np.testing.assert_allclose(dense.numpy(), tok.theta.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense),
                               rtol=1e-4, atol=1e-5)


def _slab_three_steps(phi, topic_shards):
    """Three slab steps with refills, a warm start and retirements through
    the port's and the reference's jnp slab step (the reference's draws
    injected); returns both meters."""
    B, L, R = 6, 24, 4
    kw = dict(slots=B, slot_len=L, refill_cap=R, sweeps_per_step=2,
              fold_iters=4, residual_tol=1e-2, topic_shards=topic_shards)
    j_init, j_step, jmeter = jinfer.make_slab_step(JCFG, impl="jnp",
                                                   donate=False, **kw)
    t_init, t_step, tmeter = infer.make_slab_step(CFG, device="cpu", **kw)
    jstate, tstate = j_init(), t_init()
    docs, _, _ = lda_corpus(11, 8, W, K, doc_len_mean=18)
    warm_theta = np.full((R, K), 1.0 / K, np.float32)
    warm_theta[0] = np.linspace(1, 2, K) / np.linspace(1, 2, K).sum()
    plan = [  # (docs, slots, warm mask)
        (docs[0:3], [0, 1, 2], [False] * R),
        (docs[3:5], [3, 4], [True, False, False, False]),
        (docs[5:8], [0, 1, 5], [False] * R),
    ]
    key = jax.random.PRNGKey(0)
    jphi = jinfer.split_topic_shards(jnp.asarray(phi), topic_shards)
    tphi = infer.split_topic_shards(torch.from_numpy(phi), topic_shards)
    for n, (ds, slots, wmask) in enumerate(plan):
        wid, cnt, slot, _ = slab_refill(ds, slots, capacity=R, slot_len=L,
                                        pad_slot=B)
        wmask = np.asarray(wmask)
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (R, L, K), minval=0.01, maxval=1.0)
        jstate, jret, jth, jit, jr = j_step(
            jphi, jstate, jnp.asarray(wid), jnp.asarray(cnt),
            jnp.asarray(slot), jnp.asarray(warm_theta), jnp.asarray(wmask),
            sub)
        tstate, tret, tth, tit, tr = t_step(
            tphi, tstate, wid, cnt, slot, warm_theta, wmask,
            init_u=torch.from_numpy(np.array(u)))
        msg = f"step {n}"
        np.testing.assert_array_equal(tret.numpy(), np.asarray(jret), msg)
        np.testing.assert_array_equal(tit.numpy(), np.asarray(jit), msg)
        for name in ("word_rows", "counts", "live", "it"):
            np.testing.assert_array_equal(
                getattr(tstate, name).numpy(),
                np.asarray(getattr(jstate, name)), f"{msg} {name}")
        for name in ("mu", "theta", "r_doc", "r_prev"):
            np.testing.assert_allclose(
                getattr(tstate, name).numpy(),
                np.asarray(getattr(jstate, name)), rtol=1e-5, atol=1e-6,
                err_msg=f"{msg} {name}")
        np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
    assert np.asarray(jret).any(), "the plan should retire some slots"
    return tmeter, jmeter


def test_slab_step_matches_jax_jnp_over_three_steps(phi):
    """Three slab steps with refills, a warm start and retirements: equal
    masks and int32 state, mu/theta/theta_out/r_doc within rtol 1e-5 (atol
    1e-6: theta sums c * delta-mu over a document's tokens in another
    order)."""
    tmeter, _ = _slab_three_steps(phi, 1)
    assert tmeter.total_bytes == 0               # one shard sends nothing


def test_topic_sharded_slab_step_matches_reference_jnp(phi):
    """The same three steps over 4 topic shards ([N, W, K/N] phi, mu and
    theta carrying the shard axis) against the reference's topic-sharded
    jnp slab step, with the same tolerances; the meter bills what the
    reference's bills: the refill's init normalizer over all R lanes, two
    sweeps' normalizer and residual psums, theta's normalizer."""
    tmeter, jmeter = _slab_three_steps(phi, 4)
    by = tmeter.bytes_by_phase
    assert by == jmeter.bytes_by_phase
    assert by["slab_init_norm"] == 4 * 24 * 4
    assert by["slab_norm_loop"] == 2 * 6 * 24 * 4
    assert by["slab_rw_loop"] == 2 * 6 * 4
    assert by["slab_theta_norm"] == 6 * 4


def test_topic_sharded_fold_in_matches_unsharded_and_reference(phi):
    """The reference's ``test_topic_sharded_fold_in_matches_unsharded``, on
    the port: the model-axis fold-in (psum'd renormalization, the init
    drawn at the global K and split) gives the unsharded port's theta and
    the reference's sharded theta within atol 1e-5; the meter bills the
    per-iteration psums as the reference's does."""
    jb, tb = _batch_pair(6, n=16)
    key = jax.random.PRNGKey(6)
    D, L = jb.word_ids.shape
    u = np.array(jax.random.uniform(key, (D, L, K), minval=0.01, maxval=1.0))
    base = infer.fold_in_tokens(tb, torch.from_numpy(phi), CFG, iters=10,
                                mu0=torch.from_numpy(u / u.sum(-1, keepdims=
                                                               True)),
                                device="cpu")
    step, meter = infer.make_fold_in_step(CFG, fold_iters=10, topic_shards=4,
                                          device="cpu")
    theta, iters, mean_r = step(
        infer.split_topic_shards(torch.from_numpy(phi), 4), tb.word_ids,
        tb.counts, mu0=torch.from_numpy(u))
    jstep, jmeter = jinfer.make_fold_in_step(JCFG, fold_iters=10,
                                             topic_shards=4, donate=False,
                                             impl="jnp")
    jtheta, jiters, jmean = jstep(
        jinfer.split_topic_shards(jnp.asarray(phi), 4), key, jb.word_ids,
        jb.counts)
    assert theta.shape == (D, K) and iters == int(jiters) == base.iters
    np.testing.assert_allclose(theta.numpy(), base.theta.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(mean_r), float(jmean), rtol=1e-4)
    by = meter.bytes_by_phase
    assert by == jmeter.bytes_by_phase
    assert by["model_norm_loop"] == D * L * 4 and by["model_rw_loop"] == D * 4
    assert meter.per_minibatch_bytes(iters) == (
        sum(v for p, v in by.items() if not p.endswith("_loop"))
        + (iters - 1) * (D * L * 4 + D * 4))


def test_topic_sharding_is_refused_with_roadmap_item(phi):
    """Topic sharding is ported (ROADMAP Queue 1, item 5): what is still
    refused is a shard count that does not divide K; `split_topic_shards`
    lays phi out as the reference's does."""
    with pytest.raises(ValueError, match="does not divide over 3"):
        infer.make_slab_step(CFG, slots=2, slot_len=8, topic_shards=3,
                             device="cpu")
    with pytest.raises(ValueError, match="does not divide over 5"):
        infer.split_topic_shards(torch.from_numpy(phi), 5)
    with pytest.raises(ValueError, match="does not divide over 6"):
        infer.make_fold_in_step(CFG, topic_shards=6, device="cpu")
    assert infer.split_topic_shards(torch.from_numpy(phi), 1).shape == \
        phi.shape
    np.testing.assert_array_equal(
        infer.split_topic_shards(torch.from_numpy(phi), 4).numpy(),
        np.asarray(jinfer.split_topic_shards(jnp.asarray(phi), 4)))


def test_predictive_perplexity_matches_reference(phi):
    jb, tb = _batch_pair(9, n=8)
    rng = np.random.default_rng(9)
    theta = rng.dirichlet(np.ones(K), size=jb.word_ids.shape[0]
                          ).astype(np.float32)
    got = perplexity.predictive_perplexity(torch.from_numpy(theta),
                                           torch.from_numpy(phi), tb)
    want = jperp.predictive_perplexity(jnp.asarray(theta), jnp.asarray(phi),
                                       jb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_local_reducer_applies_sync_dtype_cast_like_reference():
    from repro_torch.core.sync import CommMeter, LocalReducer

    x = np.linspace(0.1, 3.3, 17).astype(np.float32)
    for name, jdt in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        meter = CommMeter()
        red = LocalReducer(meter=meter, sync_dtype=name)
        assert red.meter is meter
        got = red.psum(torch.from_numpy(x), "phase")
        want = JLocalReducer(sync_dtype=jdt).psum(jnp.asarray(x), "phase")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert meter.total_bytes == 0              # N = 1 sends nothing
        raw = red.psum(torch.from_numpy(x), "phase", compress=False)
        np.testing.assert_array_equal(raw.numpy(), x)


def test_comm_meter_counts_each_payload_once_per_program():
    """An eager program records its payloads every run; the runs of one
    program section (a `CommMeter.section`) log alike and count once, as
    a traced program's would; records outside any section accumulate per
    call, as the reference's eager records do."""
    from repro_torch.core.sync import CommMeter

    meter = CommMeter()
    for _ in range(3):                           # three runs of one program
        with meter.section():
            meter.record("dense", torch.zeros(10, 4))
        with meter.section():
            meter.record("model_rw_loop", torch.zeros(8))
    assert meter.bytes_by_phase == {"dense": 160, "model_rw_loop": 32}
    assert meter.total_bytes == 192
    assert meter.per_minibatch_bytes(5) == 160 + 4 * 32
    meter.record("decay", torch.zeros(2))
    meter.record("decay", torch.zeros(2))
    assert meter.phase_bytes("decay") == 16
    meter.reset()
    assert meter.total_bytes == 0


def test_serving_batching_and_vocab_copies_match_reference():
    from repro.data import batching as jbatch
    from repro.data import vocab as jvocab
    from repro.data import synthetic as jsyn
    from repro_torch.data import batching, synthetic
    from repro_torch.data.vocab import VocabMap

    docs, _, true_phi = lda_corpus(4, 6, W, K, doc_len_mean=30)
    got = batching.slab_refill(docs, [3, 0, 5], capacity=4, slot_len=16,
                               pad_slot=6)
    want = jbatch.slab_refill(docs, [3, 0, 5], capacity=4, slot_len=16,
                              pad_slot=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for args in ((100,), (64, 8, 1.5), (7, 16)):
        assert batching.make_len_buckets(*args) == \
            jbatch.make_len_buckets(*args)
    for n in (1, 9, 64, 500):
        assert batching.bucket_len(n, (16, 32, 64)) == \
            jbatch.bucket_len(n, (16, 32, 64))
    a, _ = synthetic.lda_corpus_from_phi(2, 5, true_phi, doc_len_mean=20)
    b, _ = jsyn.lda_corpus_from_phi(2, 5, true_phi, doc_len_mean=20)
    for (x, y), (u, v) in zip(a, b):
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)
    keys = ["k7", "k2", "k9"]
    tv, jv = VocabMap(keys), jvocab.VocabMap(keys)
    probe = ["k2", "zz", "k9", "k7"]
    np.testing.assert_array_equal(tv.rows(probe, admit=False, oov_row=3),
                                  jv.rows(probe, admit=False, oov_row=3))
    assert tv.to_state() == jv.to_state() and tv.live == jv.live == 3
    assert tv.lookup("k9") == jv.lookup("k9") == 2

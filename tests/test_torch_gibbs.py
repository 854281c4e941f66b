"""The port's collapsed Gibbs sampler (``repro_torch.core.gibbs`` and the
plain version of ``kernels/gibbs_sweep``) held against the JAX package's
``repro.core.gibbs``.

JAX's random draws cannot be reproduced in torch, so each test injects the
reference's draws: the initial topics (``jax.random.randint`` of the
reference's key) and each sweep's noise.  ``jax.random.categorical`` is
Gumbel-max (``argmax(gumbel(key, (K,)) + logits)``), so a sweep's noise is
``jax.random.gumbel`` of each token's key from ``jax.random.split(key, T)``.

Tolerance: none.  The counts are float32 integers (±1 is exact) and each
topic is an argmax, so with the same noise the port must choose the same
topics: z and every count equal exactly, and so does ``comm_bytes``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import gibbs as jg
from repro.core.types import LDAConfig as JConfig
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro_torch.core import gibbs
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.gibbs_sweep import ops

W, K = 60, 8


def t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, *, D=12, W=W, K=K, mean=30):
    docs, _, _ = j_lda_corpus(seed, D, W, K, doc_len_mean=mean)
    jb = j_docs_to_padded(docs)
    return jb, MiniBatch(t(jb.word_ids), t(jb.counts))


def _cfgs(W=W, K=K, **kw):
    return JConfig(vocab_size=W, num_topics=K, **kw), \
        LDAConfig(vocab_size=W, num_topics=K, **kw)


def _noise(key, T, K=K):
    """The reference's sweep noise: categorical's Gumbel draw a token."""
    return t(jax.vmap(lambda k: jax.random.gumbel(k, (K,), jnp.float32))(
        jax.random.split(key, T)))


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("seed,mean", [(0, 30), (1, 5), (2, 80)])
def test_tokens_from_batch_matches_reference(seed, mean):
    jb, mb = _batch(seed, mean=mean)
    d_ref, w_ref = jg.tokens_from_batch(jb)
    d, w = gibbs.tokens_from_batch(mb)
    assert d.dtype == w.dtype == torch.int32
    _equal(d_ref, d)
    _equal(w_ref, w)
    assert d.shape[0] == int(mb.counts.sum())


def test_gibbs_init_with_injected_z_matches_reference():
    jb, mb = _batch(3)
    jcfg, cfg = _cfgs()
    d_ref, w_ref = jg.tokens_from_batch(jb)
    z_ref, *counts_ref = jg.gibbs_init(jax.random.PRNGKey(4),
                                       jnp.asarray(d_ref), jnp.asarray(w_ref),
                                       jb.num_docs, jcfg)
    z, *counts = gibbs.gibbs_init(None, t(d_ref), t(w_ref), jb.num_docs, cfg,
                                  z=t(z_ref))
    _equal(z_ref, z)
    for a, b in zip(counts_ref, counts):
        _equal(a, b)


@pytest.mark.parametrize("seed,K_", [(5, K), (6, 1), (7, 33)])
def test_gibbs_sweep_with_reference_noise_matches_exactly(seed, K_):
    jb, mb = _batch(seed, K=max(K_, 2))
    jcfg, cfg = _cfgs(K=K_)
    d_ref, w_ref = (jnp.asarray(a) for a in jg.tokens_from_batch(jb))
    state_ref = jg.gibbs_init(jax.random.PRNGKey(seed), d_ref, w_ref,
                              jb.num_docs, jcfg)
    key = jax.random.PRNGKey(seed + 100)
    out_ref = jg.gibbs_sweep(key, *state_ref, d_ref, w_ref, jcfg)
    state = [t(a) for a in state_ref]
    before = [x.clone() for x in state]
    out = gibbs.gibbs_sweep(_noise(key, d_ref.shape[0], K_), *state,
                            t(d_ref), t(w_ref), cfg)
    for a, b in zip(out_ref, out):
        _equal(a, b)
    # functional, as the reference: the inputs are untouched
    for a, b in zip(before, state):
        assert torch.equal(a, b)
    # inplace=True sweeps the given tensors to the same result
    gibbs.gibbs_sweep(_noise(key, d_ref.shape[0], K_), *state, t(d_ref),
                      t(w_ref), cfg, inplace=True)
    for a, b in zip(out_ref, state):
        _equal(a, b)


def test_run_gibbs_with_injected_draws_matches_reference():
    jb, mb = _batch(8, D=16)
    jcfg, cfg = _cfgs()
    T = int(mb.counts.sum())
    sweeps = 4
    key = jax.random.PRNGKey(9)
    phi_ref, theta_ref = jg.run_gibbs(key, jb, jcfg, sweeps)
    # the reference's draws, split as run_gibbs splits them
    key, sub = jax.random.split(key)
    z0 = t(jax.random.randint(sub, (T,), 0, K))
    noise = []
    for _ in range(sweeps):
        key, sub = jax.random.split(key)
        noise.append(_noise(sub, T))
    seen = []
    phi, theta = gibbs.run_gibbs(
        None, mb, cfg, sweeps, z0=z0, noise=noise, device="cpu",
        callback=lambda s, z, n_dk, n_wk, n_k: seen.append(
            (s, bool(torch.equal(n_k, n_wk.sum(0))))))
    _equal(phi_ref, phi)
    _equal(theta_ref, theta)
    assert seen == [(s, True) for s in range(sweeps)]


def test_run_parallel_gibbs_with_injected_draws_matches_reference():
    jcfg, cfg = _cfgs()
    N, sweeps = 3, 2
    pairs = [_batch(20 + i, D=6) for i in range(N)]
    jbs, mbs = [p[0] for p in pairs], [p[1] for p in pairs]
    Ts = [int(mb.counts.sum()) for mb in mbs]
    key = jax.random.PRNGKey(11)
    phi_ref, bytes_ref = jg.run_parallel_gibbs(key, jbs, jcfg, sweeps)
    key, *subs = jax.random.split(key, N + 1)
    z0 = [t(jax.random.randint(sk, (T,), 0, K)) for sk, T in zip(subs, Ts)]
    noise = []
    for _ in range(sweeps):
        per = []
        for T in Ts:
            key, sub = jax.random.split(key)
            per.append(_noise(sub, T))
        noise.append(per)
    phi, nbytes = gibbs.run_parallel_gibbs(None, mbs, cfg, sweeps, z0=z0,
                                           noise=noise, device="cpu")
    _equal(phi_ref, phi)
    assert nbytes == bytes_ref == W * K * 4 * N * sweeps
    assert float(phi.sum()) == sum(Ts)


def test_seeded_runs_repeat_and_hold_their_tokens():
    """Without injected draws: the generator's z and the Philox noise,
    the same seed twice equal, another seed different."""
    _, mb = _batch(12)
    _, cfg = _cfgs()
    runs = [gibbs.run_gibbs(torch.Generator().manual_seed(s), mb, cfg, 3,
                            device="cpu") for s in (1, 1, 2)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[2][0])
    T = float(mb.counts.sum())
    for phi, theta in runs:
        assert float(phi.sum()) == float(theta.sum()) == T
    phi, nbytes = gibbs.run_parallel_gibbs(
        torch.Generator().manual_seed(3), [mb, _batch(13)[1]], cfg, 2,
        device="cpu")
    assert nbytes == W * K * 4 * 2 * 2 and bool((phi >= 0).all())


def test_philox_noise_known_answers_and_draws():
    """Philox4x32-10 against the published known-answer vectors (Random123),
    and the noise's mapping: a pure function of (seed, sweep, t, k),
    finite, different across sweeps."""
    z = lambda *v: [torch.tensor([x], dtype=torch.int64) for x in v]  # noqa
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        assert tuple(int(o) for o in ops.philox4x32(*z(*ctr), *key)) == want
    seed = (0xa4093822 << 32) | 0x299f31d0
    g = ops.philox_gumbel(seed, 7, 50, 40, "cpu")
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert torch.equal(g, ops.philox_gumbel(seed, 7, 50, 40, "cpu"))
    assert torch.equal(g[:20, :10], ops.philox_gumbel(seed, 7, 20, 10, "cpu"))
    assert not torch.equal(g, ops.philox_gumbel(seed, 8, 50, 40, "cpu"))
    # element (t, k) is the first word of Philox at counter (k, t, sweep, 0)
    x = int(ops.philox4x32(*z(3, 11, 7, 0), seed & 0xffffffff,
                           seed >> 32)[0])
    u = np.float32((np.float32(x >> 9) + np.float32(0.5))
                   * np.float32(2.0 ** -23))
    assert 0.0 < u < 1.0
    np.testing.assert_allclose(float(g[11, 3]), -np.log(-np.log(float(u))),
                               rtol=1e-6)
    # a Gumbel's mean is the Euler-Mascheroni constant
    big = ops.philox_gumbel(1, 0, 400, 250, "cpu")
    assert abs(float(big.mean()) - 0.5772) < 0.01


@pytest.mark.parametrize("t0,T", [(0, 1), (5, 30), (49, 1)])
def test_noise_pre_pass_at_a_token_offset_is_the_sweeps_rows(t0, T):
    """The pre-pass's noise of tokens t0 .. t0 + T - 1 (its plain version
    on the CPU) is rows t0 .. of the sweep's [T, K] noise: a sweep drawn a
    chunk of tokens at a time sees the same numbers."""
    seed = 987654321987654321
    whole = ops.philox_gumbel(seed, 4, 50, 33, "cpu")
    before = launch_counts()["gibbs_noise"]
    got = ops.gibbs_noise(seed, 4, T, 33, "cpu", t0=t0)
    assert torch.equal(got, whole[t0:t0 + T])
    assert launch_counts()["gibbs_noise"] == before    # no kernel on the CPU
    out = torch.empty((T, 33))
    assert ops.gibbs_noise(seed, 4, T, 33, "cpu", t0=t0, out=out) is out
    assert torch.equal(out, whole[t0:t0 + T])
    with pytest.raises(ValueError, match="seed"):
        ops.gibbs_noise(-1, 0, 1, 1, "cpu")


@pytest.mark.parametrize("K,threads", [(1, 32), (33, 32), (256, 32),
                                       (257, 64), (2000, 256), (2049, 512),
                                       (4096, 512), (10000, 512)])
def test_chain_block_size_is_a_power_of_two_near_eight_topics_a_thread(
        K, threads):
    """About 8 topics a thread: up to K = 4096 the chain's threads own one
    or two chunks of 4 topics (its loop-free forms)."""
    got = ops.block_threads(K)
    assert got == threads and got & (got - 1) == 0
    assert got == 512 or got == 32 or -(-K // 8) <= got < -(-K // 8) * 2
    assert K > 4096 or -(-K // (4 * got)) <= 2


def test_sweep_plain_version_takes_a_seed_as_its_philox_noise():
    _, mb = _batch(14)
    _, cfg = _cfgs()
    d, w = gibbs.tokens_from_batch(mb)
    state = gibbs.gibbs_init(torch.Generator().manual_seed(0), d, w,
                             mb.num_docs, cfg)
    by_seed = gibbs.gibbs_sweep(1234, *state, d, w, cfg, sweep=5)
    by_noise = gibbs.gibbs_sweep(
        ops.philox_gumbel(1234, 5, d.shape[0], K, "cpu"), *state, d, w, cfg)
    for a, b in zip(by_seed, by_noise):
        assert torch.equal(a, b)


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_on_the_default_device_without_a_card(no_card):
    _, mb = _batch(15)
    _, cfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    for call in (lambda: gibbs.run_gibbs(g, mb, cfg, 1),
                 lambda: gibbs.run_parallel_gibbs(g, [mb], cfg, 1),
                 lambda: gibbs.run_gibbs(g, mb, cfg, 1, device="cuda")):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    # no draw is taken from the global generator: an un-injected draw
    # needs a generator
    with pytest.raises(ValueError, match="Generator"):
        gibbs.run_gibbs(None, mb, cfg, 1, device="cpu")


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 31), D=st.integers(1, 6),
       Wn=st.integers(1, 30), Kn=st.integers(1, 12),
       sweep=st.integers(0, 3))
def test_counts_stay_consistent_after_any_sweep(seed, D, Wn, Kn, sweep):
    """After any sweep n_k equals n_wk's column sums exactly, every count
    is a non-negative integer, the counts hold every token, and they are
    the counts of the new z."""
    rng = np.random.default_rng(seed)
    L = 4
    mb = MiniBatch(t(rng.integers(0, Wn, (D, L)).astype(np.int32)),
                   t(rng.integers(0, 4, (D, L)).astype(np.float32)))
    cfg = LDAConfig(vocab_size=Wn, num_topics=Kn)
    d, w = gibbs.tokens_from_batch(mb)
    state = gibbs.gibbs_init(torch.Generator().manual_seed(seed), d, w, D,
                             cfg)
    z, n_dk, n_wk, n_k = gibbs.gibbs_sweep(seed, *state, d, w, cfg,
                                           sweep=sweep)
    T = d.shape[0]
    assert torch.equal(n_k, n_wk.sum(0))
    for c in (n_dk, n_wk, n_k):
        assert bool((c >= 0).all()) and torch.equal(c, c.round())
    assert float(n_wk.sum()) == float(n_dk.sum()) == T
    _, want_dk, want_wk, _ = gibbs.gibbs_init(None, d, w, D, cfg, z=z)
    assert torch.equal(n_dk, want_dk) and torch.equal(n_wk, want_wk)

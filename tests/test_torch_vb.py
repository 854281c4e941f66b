"""The port's variational Bayes (``repro_torch.core.vb``) held against the
JAX package's ``repro.core.vb``.

The reference draws the initial lambda from its key
(``beta + jax.random.uniform(key, (W, K), 0.5, 1.5)``); the tests make that
draw with JAX and inject it as ``lam0``.

Tolerances: ``torch.digamma`` and ``jax.scipy.special.digamma`` are two
float32 implementations a few ulps apart, and the sums over K (the
normalizer, logsumexp) and the counts contraction run in other orders than
XLA's; so one sweep's gamma and statistic are held to rtol 1e-5 and a run
of 3 iterations to rtol 1e-4, each with an absolute floor of 1e-6 times
the tensor's largest entry (statistic entries near 0 have no relative
scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vb as jvb
from repro.core.types import LDAConfig as JConfig
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro_torch.core import vb
from repro_torch.core.types import LDAConfig, MiniBatch

W, K = 80, 8


def t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, *, D=16, mean=40):
    docs, _, _ = j_lda_corpus(seed, D, W, K, doc_len_mean=mean)
    jb = j_docs_to_padded(docs)
    return jb, MiniBatch(t(jb.word_ids), t(jb.counts))


def _cfgs():
    return JConfig(vocab_size=W, num_topics=K), LDAConfig(vocab_size=W,
                                                           num_topics=K)


def _lam0(key):
    """The reference's initial lambda, drawn as run_vb draws it."""
    return 0.01 + jax.random.uniform(key, (W, K), minval=0.5, maxval=1.5)


def _close(ref, got, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("seed,mean", [(0, 40), (1, 8)])
def test_vb_sweep_matches_reference(seed, mean):
    jb, mb = _batch(seed, mean=mean)
    jcfg, cfg = _cfgs()
    lam = _lam0(jax.random.PRNGKey(seed))
    gamma_ref, stat_ref = jvb.vb_sweep(jb, lam, jcfg)
    gamma, stat = vb.vb_sweep(mb, t(lam), cfg)
    _close(gamma_ref, gamma, 1e-5)
    _close(stat_ref, stat, 1e-5)
    # the statistic holds every token
    np.testing.assert_allclose(float(stat.sum()), float(mb.counts.sum()),
                               rtol=1e-5)


def test_run_vb_with_injected_lambda_matches_reference():
    jb, mb = _batch(2)
    jcfg, cfg = _cfgs()
    key = jax.random.PRNGKey(3)
    phi_ref, gamma_ref = jvb.run_vb(key, jb, jcfg, 3)
    phi, gamma = vb.run_vb(None, mb, cfg, 3, lam0=t(_lam0(key)),
                           device="cpu")
    _close(phi_ref, phi, 1e-4)
    _close(gamma_ref, gamma, 1e-4)


def test_run_parallel_vb_matches_reference_and_counts_its_bytes():
    """phi_hat within rtol 1e-4 of the reference's; comm_bytes is the
    reference's count (``comm_bytes += lam.size * 4 * N`` each iteration),
    which the reference computes and then drops (it returns None)."""
    jcfg, cfg = _cfgs()
    pairs = [_batch(10 + i, D=6) for i in range(3)]
    key = jax.random.PRNGKey(4)
    iters = 2
    phi_ref, none = jvb.run_parallel_vb(key, [p[0] for p in pairs], jcfg,
                                        iters)
    assert none is None
    phi, nbytes = vb.run_parallel_vb(None, [p[1] for p in pairs], cfg, iters,
                                     lam0=t(_lam0(key)), device="cpu")
    _close(phi_ref, phi, 1e-4)
    assert nbytes == W * K * 4 * len(pairs) * iters


def test_seeded_run_repeats_and_default_device_needs_a_card(monkeypatch):
    _, mb = _batch(5)
    _, cfg = _cfgs()
    a = vb.run_vb(torch.Generator().manual_seed(1), mb, cfg, 2, device="cpu")
    b = vb.run_vb(torch.Generator().manual_seed(1), mb, cfg, 2, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(torch.isfinite(a[1]).all())
    with pytest.raises(ValueError, match="Generator"):
        vb.run_vb(None, mb, cfg, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: vb.run_vb(torch.Generator(), mb, cfg, 1),
                 lambda: vb.run_parallel_vb(torch.Generator(), [mb], cfg,
                                            1)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()

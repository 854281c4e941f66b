"""Two reference names the port keeps beside its main path, held against
the JAX package: ``data/synthetic.py::zipf_corpus`` (numpy on a seeded
``default_rng``: the same documents bit for bit) and the seed-layout
oracle ``core/pobp.py::selective_sweep`` on [D, L, K] batch-major messages
(within rtol 1e-5 of the reference's on the same numpy-seeded inputs, and
of the port's token-major ``selective_sweep_tokens`` under both sweep
policies: the same sweep in other summation orders, so 1e-5 with an
absolute floor of 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pobp as jp
from repro.core.types import LDAConfig as JConfig
from repro.core.types import MiniBatch as JMiniBatch
from repro.data.synthetic import zipf_corpus as j_zipf_corpus
from repro_torch.core import pobp
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.data.synthetic import zipf_corpus


@pytest.mark.parametrize("seed,docs,W,mean,s", [(0, 40, 2000, 160, 1.07),
                                                (3, 25, 50, 7, 1.5),
                                                (7, 10, 1, 20, 1.07)])
def test_zipf_corpus_bit_for_bit(seed, docs, W, mean, s):
    ref_docs, ref_stats = j_zipf_corpus(seed, docs, W, doc_len_mean=mean,
                                        zipf_s=s)
    got_docs, got_stats = zipf_corpus(seed, docs, W, doc_len_mean=mean,
                                      zipf_s=s)
    assert len(got_docs) == len(ref_docs) == docs
    for (ri, rc), (gi, gc) in zip(ref_docs, got_docs):
        assert ri.dtype == gi.dtype and rc.dtype == gc.dtype
        np.testing.assert_array_equal(ri, gi)
        np.testing.assert_array_equal(rc, gc)
    assert (got_stats.num_docs, got_stats.vocab_size, got_stats.num_tokens,
            got_stats.nnz) == (ref_stats.num_docs, ref_stats.vocab_size,
                               ref_stats.num_tokens, ref_stats.nnz)


def _sweep_inputs(seed, *, W, K, D, L, P, Pk):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 3, (D, L)).astype(np.float32)
    logits = rng.normal(size=(D, L, K))
    mu = np.exp(logits - logits.max(-1, keepdims=True))
    mu = (mu / mu.sum(-1, keepdims=True)).astype(np.float32)
    theta = np.einsum("dl,dlk->dk", cnt, mu).astype(np.float32)
    phi = (rng.random((W, K)) * 5).astype(np.float32)
    sel_w = rng.choice(W, P, replace=False).astype(np.int32)
    sel_k = np.stack([rng.choice(K, Pk, replace=False)
                      for _ in range(P)]).astype(np.int32)
    return dict(wid=wid, cnt=cnt, mu=mu, theta=theta, phi=phi,
                phi_tot=phi.sum(0), sel_w=sel_w, sel_k=sel_k)


def _close(want, got):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("seed,W,K,D,L,P,Pk", [(0, 40, 10, 8, 14, 8, 3),
                                               (1, 120, 16, 6, 20, 30, 16),
                                               (2, 30, 5, 3, 9, 1, 1)])
def test_selective_sweep_matches_reference_and_token_major_sweep(
        seed, W, K, D, L, P, Pk):
    x = _sweep_inputs(seed, W=W, K=K, D=D, L=L, P=P, Pk=Pk)
    jcfg = JConfig(vocab_size=W, num_topics=K)
    ref = jp.selective_sweep(
        JMiniBatch(jnp.asarray(x["wid"]), jnp.asarray(x["cnt"])),
        *(jnp.asarray(x[k]) for k in ("mu", "theta", "phi", "phi_tot",
                                      "sel_w", "sel_k")), jcfg)
    tt = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    mb = MiniBatch(tt["wid"], tt["cnt"])
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    got = pobp.selective_sweep(mb, tt["mu"], tt["theta"], tt["phi"],
                               tt["phi_tot"], tt["sel_w"], tt["sel_k"], cfg)
    for a, b in zip(ref, got):
        _close(a, b)
    # a functional oracle: its inputs are untouched
    assert torch.equal(tt["mu"], torch.from_numpy(x["mu"]))
    assert torch.equal(tt["theta"], torch.from_numpy(x["theta"]))
    lay = mb.token_layout()
    for policy in ("dense_layout", "packed"):
        mu_t = tt["mu"].reshape(-1, K).clone()
        m2, t2, d2, r2 = pobp.selective_sweep_tokens(
            lay, mu_t, tt["theta"], tt["phi"], tt["phi_tot"], tt["sel_w"],
            tt["sel_k"], cfg, policy=policy)
        for a, b in zip(got, (lay.to_batch_major(m2), t2, d2, r2)):
            _close(a.numpy(), b)

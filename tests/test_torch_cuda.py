"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the wrapper's checks, and the serving engines on the card
against the same engines on the CPU.

Every test here carries the ``cuda`` marker and skips without a card.
The file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.types import LDAConfig
from repro_torch.data.synthetic import lda_corpus
from repro_torch.kernels.power_sweep import ops
from repro_torch.serve import FoldInEngine, SlabEngine

pytestmark = pytest.mark.cuda
ALPHA = 0.1


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (on the card: pytest -m cuda)")


def _sweep_args(seed, *, D, L, K, W, device):
    """Serving-sweep inputs: ragged docs (c = 0 padding), 30% frozen
    tokens, doc 1 frozen whole, one out-of-range id (treated as frozen)."""
    rng = np.random.default_rng(seed)
    T = D * L
    p_tok = rng.integers(0, W, T).astype(np.int32)
    doc_ids = np.repeat(np.arange(D), L).astype(np.int32)
    c = rng.integers(1, 4, T).astype(np.float32)
    c[np.tile(np.arange(L), D) >= np.repeat(rng.integers(1, L + 1, D), L)] = 0
    p_tok[(rng.random(T) < 0.3) | (doc_ids == 1)] = W
    p_tok[0] = W + 5
    mu = rng.random((T, K)).astype(np.float32) + 0.01
    mu /= mu.sum(1, keepdims=True)
    theta = np.zeros((D, K), np.float32)
    np.add.at(theta, doc_ids, c[:, None] * mu)
    phi = rng.random((W, K)).astype(np.float32)
    phi /= phi.sum(0, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [t(p_tok), t(doc_ids), t(c.reshape(T, 1)), t(mu), t(theta),
            torch.zeros(K, device=device), t(phi), None]


@pytest.mark.parametrize("D,L,K,W", [(8, 12, 16, 150), (3, 7, 100, 50),
                                     (16, 64, 2000, 3000)])
def test_kernel_matches_plain_version_on_card(card, D, L, K, W):
    kw = dict(alpha=ALPHA, beta=0.0, wbeta=1.0, update_phi=False, n_guard=W)
    args = _sweep_args(D + K, D=D, L=L, K=K, W=W, device="cuda")
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
    assert float(got[4][1]) == 0.0                         # frozen doc
    # deterministic: a second launch on the same inputs repeats bit for bit
    again = list(args)
    again[3] = mu0.clone()
    rerun = ops.power_sweep_carry(*again, **kw)
    for g, r in zip(got, rerun):
        assert torch.equal(g, r)


def test_wrapper_checks_and_training_mode_raise_on_card(card):
    args = _sweep_args(0, D=2, L=4, K=8, W=10, device="cuda")
    kw = dict(alpha=ALPHA, beta=0.0, wbeta=1.0, n_guard=10)
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.power_sweep_carry(*args, update_phi=True, **kw)
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(ValueError, match="p_tok must be torch.int32"):
        ops.power_sweep_carry(*bad, update_phi=False, **kw)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="phi_rows is on cpu"):
        ops.power_sweep_carry(*bad, update_phi=False, **kw)


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

"""The port's serving engines (``repro_torch.serve``) and CLI, held against
the JAX package's engines on a JAX-written checkpoint.

The slab comparison replays the JAX engine's per-step key splits and feeds
the same ``jax.random.uniform`` draws into the port's step (``init_u``), so
both engines start every document from the same messages; both run with
``pipeline=0`` so retirement and refill happen on the same steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro.serve import FoldInEngine as JFoldInEngine
from repro.serve import SlabEngine as JSlabEngine
from repro_torch.configs import ARCH_IDS
from repro_torch.data.synthetic import lda_corpus
from repro_torch.launch import serve as serve_mod

from torch_lm_pairs import one_torch_thread
from repro_torch.serve import (FoldInEngine, OOVTrigger, Shed, SlabEngine,
                               ThetaCache)

W, K = 150, 16


@pytest.fixture(scope="module")
def trained():
    docs, _, true_phi = lda_corpus(0, 48, W, K, doc_len_mean=30)
    return docs, (true_phi.T * 200.0).astype(np.float32)


@pytest.fixture()
def ckpt_dir(tmp_path, trained):
    _, phi_acc = trained
    jckpt.save(str(tmp_path), 3,
               {"state": {"phi_acc": jnp.asarray(phi_acc),
                          "m": jnp.asarray(3, jnp.int32),
                          "rng": jax.random.PRNGKey(0)}},
               extra={"next_m": 3, "run": {"vocab": W, "topics": K}})
    return str(tmp_path)


def _check_served(res, ids):
    assert sorted(r.req_id for r in res) == sorted(ids)
    th = np.stack([r.theta for r in res])
    assert np.isfinite(th).all()
    np.testing.assert_allclose(th.sum(axis=1), 1.0, atol=1e-5)


def test_engines_from_jax_checkpoint_serve_every_request(ckpt_dir, trained):
    docs, _ = trained
    slab = SlabEngine.from_checkpoint(ckpt_dir, slots=8, slot_len=64,
                                      device="cpu")
    bucket = FoldInEngine.from_checkpoint(ckpt_dir, len_buckets=(32, 64),
                                          batch_docs=8, device="cpu")
    assert slab.cfg.vocab_size == W and slab.cfg.num_topics == K
    for eng in (slab, bucket):
        ids = [eng.submit(d) for d in docs[:20]]
        _check_served(eng.drain(), ids)
    # the scorecards carry the reference engines' keys
    jslab = JSlabEngine.from_checkpoint(ckpt_dir, slots=8, slot_len=64,
                                        warmup=False)
    jbucket = JFoldInEngine.from_checkpoint(ckpt_dir, len_buckets=(32, 64),
                                            batch_docs=8, warmup=False)
    assert set(slab.stats()) == set(jslab.stats())
    assert set(bucket.stats()) == set(jbucket.stats())
    assert slab.stats()["served"] == bucket.stats()["served"] == 20


def _replay_jax_init(eng, seed):
    """Feed the port engine the init draws the JAX engine makes: one key
    split per step() (engine.py:879), uniform [R, L, K] in [0.01, 1)."""
    key = jax.random.PRNGKey(seed)
    step = eng._step
    shape = (eng._refill_cap, eng.slot_len, eng._K)

    def replayed(*args, **kw):
        nonlocal key
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, shape, minval=0.01, maxval=1.0)
        kw["init_u"] = torch.from_numpy(np.array(u))
        return step(*args, **kw)

    eng._step = replayed


def test_slab_engine_matches_jax_engine_with_replayed_inits(trained):
    docs, phi_acc = trained
    from repro.core.types import LDAConfig as JConfig
    from repro_torch.core.types import LDAConfig

    kw = dict(slots=6, slot_len=48, sweeps_per_step=2, fold_iters=30,
              residual_tol=1e-2, seed=7, pipeline=0)
    jeng = JSlabEngine(jnp.asarray(phi_acc),
                       JConfig(vocab_size=W, num_topics=K), **kw)
    teng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                      device="cpu", **kw)
    _replay_jax_init(teng, 7)
    batch = docs[:14]
    for d in batch:
        jeng.submit(d)
        teng.submit(d)
    want = {r.req_id: r for r in jeng.drain()}
    got = {r.req_id: r for r in teng.drain()}
    assert sorted(got) == sorted(want) == list(range(len(batch)))
    for rid in want:
        assert got[rid].iters == want[rid].iters, rid
        assert got[rid].bucket == want[rid].bucket, rid
        np.testing.assert_allclose(got[rid].theta, want[rid].theta,
                                   rtol=1e-4, atol=1e-6, err_msg=str(rid))
    assert teng.stats()["steps"] == jeng.stats()["steps"]


def _submit_all(engine, docs):
    for d in docs:
        engine.submit(d)
    return {r.req_id: r for r in engine.drain()}


def test_engine_sharded_phi_bytes_accounted(trained):
    """The reference's ``test_engine_sharded_phi_bytes_accounted`` and its
    meter lifecycle test, on the port's bucket engine: a topic-sharded phi
    meters the per-iteration model psums (the reference's bytes, integer
    for integer), bills per request, keeps its bill across dispatches of
    one shape and clears it on ``reset``; its theta is the unsharded
    engine's within atol 1e-5 (same requests, same seed)."""
    docs, phi_acc = trained
    from repro.core.types import LDAConfig as JConfig
    from repro_torch.core.types import LDAConfig

    kw = dict(len_buckets=(32,), batch_docs=8, fold_iters=8,
              residual_tol=0.0)
    solo = FoldInEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                        device="cpu", **kw)
    eng = FoldInEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                       topic_shards=4, device="cpu", **kw)
    jeng = JFoldInEngine(jnp.asarray(phi_acc),
                         JConfig(vocab_size=W, num_topics=K),
                         topic_shards=4, warmup=False, **kw)
    a, b = _submit_all(solo, docs[:8]), _submit_all(eng, docs[:8])
    _submit_all(jeng, docs[:8])
    for rid in a:
        np.testing.assert_allclose(b[rid].theta, a[rid].theta, atol=1e-5)
    first = eng.stats()
    assert first["bytes_by_phase"].get("model_norm_loop", 0) == 8 * 32 * 4
    assert first["bytes_by_phase"] == jeng.stats()["bytes_by_phase"]
    assert first["per_request_bytes"] == pytest.approx(
        jeng.stats()["per_request_bytes"]) and first["per_request_bytes"] > 0
    assert solo.stats()["per_request_bytes"] == 0
    for _ in range(3):
        _submit_all(eng, docs[:8])
    many = eng.stats()
    assert many["served"] == 32
    assert many["bytes_by_phase"] == first["bytes_by_phase"]
    eng.meter.reset()
    assert eng.stats()["bytes_by_phase"] == {}


def test_slab_sharded_billing_per_retired_document(trained):
    """The reference's ``test_slab_sharded_billing_per_retired_document``,
    on the port: requests share a slab step, so sync bytes are billed per
    retired document (its own iteration count); the sharded slab serves the
    unsharded slab's theta within atol 1e-5; against the reference's
    sharded slab with its draws replayed, every document's bill and the
    meter are the reference's."""
    from repro.core.types import LDAConfig as JConfig
    from repro_torch.core.types import LDAConfig

    _, phi_acc = trained
    docs, _, _ = lda_corpus(9, 6, W, K, doc_len_mean=25)
    kw = dict(slots=8, slot_len=48, fold_iters=60, residual_tol=1e-2,
              seed=3)
    cfg = LDAConfig(vocab_size=W, num_topics=K)
    solo = SlabEngine(phi_acc, cfg, device="cpu", **kw)
    shard = SlabEngine(phi_acc, cfg, topic_shards=4, device="cpu", **kw)
    rs, rh = _submit_all(solo, docs), _submit_all(shard, docs)
    for rid in rs:
        np.testing.assert_allclose(rs[rid].theta, rh[rid].theta, atol=1e-5)
        assert rs[rid].comm_bytes == 0.0          # local reducer: no wire
        assert rh[rid].comm_bytes > 0.0
    by_iters = sorted((r.iters, r.comm_bytes) for r in rh.values())
    for (i1, b1), (i2, b2) in zip(by_iters, by_iters[1:]):
        if i2 > i1:
            assert b2 > b1
    s = shard.stats()
    total = sum(r.comm_bytes for r in rh.values())
    assert s["per_request_bytes"] == pytest.approx(total / len(rh))

    kw.update(pipeline=0)
    jeng = JSlabEngine(jnp.asarray(phi_acc),
                       JConfig(vocab_size=W, num_topics=K), topic_shards=4,
                       **kw)
    teng = SlabEngine(phi_acc, cfg, topic_shards=4, device="cpu", **kw)
    _replay_jax_init(teng, kw["seed"])
    want, got = _submit_all(jeng, docs), _submit_all(teng, docs)
    assert teng.meter.bytes_by_phase == jeng.meter.bytes_by_phase
    for rid in want:
        assert got[rid].iters == want[rid].iters
        assert got[rid].comm_bytes == pytest.approx(want[rid].comm_bytes)
        np.testing.assert_allclose(got[rid].theta, want[rid].theta,
                                   atol=1e-5)


def test_slab_swap_under_queued_load_stamps_versions(trained):
    docs, phi_acc = trained
    from repro_torch.core.types import LDAConfig

    eng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                     slots=4, slot_len=64, seed=2, device="cpu")
    pre = [eng.submit(d) for d in docs[:12]]
    eng.step()
    eng.step()
    assert eng.in_flight() > 0
    eng.swap_phi(phi_acc * 0.5 + 1.0)
    assert eng.in_flight() == 0            # pumped dry before install
    post = [eng.submit(d) for d in docs[12:18]]
    res = {r.req_id: r for r in eng.drain() + eng.poll()}
    assert sorted(res) == sorted(pre + post)
    assert all(res[i].phi_version == 0 for i in pre)
    assert all(res[i].phi_version == 1 for i in post)


def test_slab_theta_cache_hit_and_version_invalidation(trained):
    docs, phi_acc = trained
    from repro_torch.core.types import LDAConfig

    eng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                     slots=4, slot_len=64, seed=4, theta_cache=8,
                     device="cpu")
    doc = docs[5]
    eng.submit(doc, tenant="a")
    (cold,) = eng.drain()
    assert not cold.cached
    eng.submit(doc, tenant="a")
    (hit,) = eng.drain()
    assert hit.cached and hit.iters == 0
    np.testing.assert_array_equal(hit.theta, cold.theta)
    eng.submit(doc, tenant="b")
    (other,) = eng.drain()
    assert not other.cached
    eng.swap_phi(phi_acc[:, ::-1].copy())
    eng.submit(doc, tenant="a")
    (after,) = eng.drain()
    assert not after.cached and after.phi_version == 1
    assert float(np.abs(after.theta - cold.theta).sum()) > 1e-3
    assert eng.cache.stats()["stale_evictions"] >= 1


def test_slab_warm_cache_mode_takes_fewer_sweeps(trained):
    docs, phi_acc = trained
    from repro_torch.core.types import LDAConfig

    tol = 1e-2
    eng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                     slots=4, slot_len=64, seed=6, residual_tol=tol,
                     fold_iters=100, theta_cache=ThetaCache(16),
                     cache_mode="warm", device="cpu")
    for d in docs[:4]:
        eng.submit(d)
    cold = sorted(eng.drain(), key=lambda r: r.req_id)
    for d in docs[:4]:
        eng.submit(d)
    warm = sorted(eng.drain(), key=lambda r: r.req_id)
    assert all(not r.cached for r in warm)
    for c, w in zip(cold, warm):
        assert w.iters <= c.iters
        assert float(np.abs(w.theta - c.theta).sum()) <= 2 * tol
    s = eng.stats()
    assert s["warm_starts"] == 4
    assert s["warm_fold_iters"] < s["cold_fold_iters"]


def test_slab_sheds_over_slo_and_quarantines_nonfinite(trained):
    docs, phi_acc = trained
    from repro_torch.core.types import LDAConfig

    eng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                     slots=2, slot_len=64, seed=3, admission_slo_s=1e-9,
                     device="cpu")
    first = eng.submit(docs[0])            # cold engine always admits
    assert not isinstance(first, Shed)
    eng.step()
    shed = eng.submit(docs[1])
    assert isinstance(shed, Shed) and shed.slo_s == 1e-9
    bad = (np.array([1, 2, 3], np.int32),
           np.array([1.0, np.nan, 2.0], np.float32))
    rid = eng.submit(bad)
    res = {r.req_id: r for r in eng.drain()}
    assert res[rid].error == "nonfinite_input"
    np.testing.assert_allclose(res[rid].theta, 1.0 / K)
    s = eng.stats()
    assert s["shed"] == 1 and s["quarantined"] == 1 and s["served"] == 2


def test_slab_oov_admission_feeds_retrain_batches(trained):
    _, phi_acc = trained
    from repro_torch.core.types import LDAConfig

    eng = SlabEngine(phi_acc, LDAConfig(vocab_size=W, num_topics=K),
                     slots=4, slot_len=32, seed=8, device="cpu",
                     oov_trigger=OOVTrigger(rate_threshold=0.05, min_docs=2,
                                            batch_keys=4))
    hot = np.array([W + 7, W + 9], np.int32)
    for _ in range(4):
        eng.submit((np.concatenate([hot, np.arange(5, dtype=np.int32)]),
                    np.ones(7, np.float32)))
    res = eng.drain()
    assert all(r.oov_tokens == 2.0 for r in res)
    assert all(np.isfinite(r.theta).all() for r in res)
    assert eng.stats()["oov_rate"] == pytest.approx(2 / 7)
    keys, _ = eng.take_retrain_batches()[0][0]
    assert set(keys.tolist()) == {W + 7, W + 9}


@pytest.mark.parametrize("admission", ["slab", "bucket"])
def test_serve_cli_on_cpu_reports_latency(ckpt_dir, capsys, admission):
    serve_mod.main(["--mode", "lda", "--ckpt-dir", ckpt_dir,
                    "--device", "cpu", "--admission", admission,
                    "--requests", "24", "--slots", "8", "--batch", "8",
                    "--len-buckets", "16,32"])
    out = capsys.readouterr().out
    assert "docs/s" in out and "p99=" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_lm_mode_runs_on_cpu(capsys, arch):
    """``--mode lm --reduced --device cpu`` serves every architecture: the
    reference's ``[serve-lm]`` line, greedy tokens inside the vocabulary,
    finite logits; for a dense and an MoE id, the same tokens again from
    the same seed."""
    argv = ["--mode", "lm", "--arch", arch, "--reduced", "--device", "cpu",
            "--batch", "3", "--prompt-len", "5", "--gen", "4", "--seed", "2"]
    with one_torch_thread():
        res = serve_mod.main(argv)
    out = capsys.readouterr().out
    assert "[serve-lm] 3 streams x 4 new tokens in" in out
    assert "tok/s); sample: [" in out
    assert res["tokens"].shape == (3, 4) and res["finite"]
    assert 0 <= int(res["tokens"].min()) <= int(res["tokens"].max()) \
        < res["vocab_size"]
    assert len(res["step_s"]) == 5 + 4 - 1
    if arch in ("smollm-360m", "olmoe-1b-7b"):
        with one_torch_thread():
            assert torch.equal(serve_mod.main(argv)["tokens"], res["tokens"])


def test_serve_cli_lm_mode_defaults(monkeypatch):
    """Without ``--batch`` the LM mode decodes 8 streams (the bucket
    engine's 32 documents a batch stay LDA's default)."""
    seen = {}
    monkeypatch.setattr(serve_mod, "serve_lm",
                        lambda args: seen.setdefault("lm", args))
    monkeypatch.setattr(serve_mod, "serve_lda",
                        lambda args: seen.setdefault("lda", args))
    serve_mod.main(["--mode", "lm"])
    serve_mod.main(["--mode", "lda", "--ckpt-dir", "x"])
    lm, lda = seen["lm"], seen["lda"]
    assert (lm.batch, lm.prompt_len, lm.gen, lm.arch, lm.device) == \
        (8, 8, 8, "smollm-360m", "cuda")
    assert lda.batch == 32


def test_serve_cli_lm_mode_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.main(["--mode", "lm", "--arch", "olmoe-1b-7b",
                        "--reduced"])

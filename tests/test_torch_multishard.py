"""The port's multi-shard POBP (N data shards in lockstep on one device, and
a data x model grid of them) held against the JAX package's vmap
simulation on the same inputs.

JAX's draws cannot be reproduced in torch, so each test injects the
reference's: ``jax.random.split(key, N)`` and one ``uniform`` draw a
shard, as ``make_sim_minibatch_fn`` and ``make_train_step(cfg, N)`` make
them; under the mesh the reference draws one replicated key, so every
shard gets the same field.  The reference runs its jnp path
(``sweep_policy='dense_layout'``).

Tolerances: float32 runs are held to rtol 1e-4 (atol 1e-4 on statistics
of tens of tokens) over at most 8 iterations, ``iters`` exact, the byte
meter exact.  bf16 sync rounds every payload in bf16 and the two packages
sum in float32 in other orders before each rounding, so an entry whose
rounding flips moves a whole bf16 step; a bf16 run's relative L1 gap to
the reference's bf16 run is budgeted at three times the reference's own
bf16-vs-float32 gap on the same inputs (the budget of
``tests/test_torch_quantize.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pobp as jp
from repro.core.sync import dense_sync_bytes as j_dense_sync_bytes
from repro.core.sync import power_sync_bytes as j_power_sync_bytes
from repro.core.types import LDAConfig as JConfig
from repro.data import bucketed_minibatch_stream as j_bucketed
from repro.data import lda_corpus
from repro.data import sharded_minibatch_stream as j_sharded
from repro_torch.core import pobp
from repro_torch.core.sync import (CommMeter, SimReducer, dense_sync_bytes,
                                   lockstep, power_sync_bytes)
from repro_torch.core.types import LDAConfig

W, K = 120, 8
BASE = dict(vocab_size=W, num_topics=K, lambda_w=0.3, lambda_k_abs=4,
            inner_iters=8, residual_tol=1e-6)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def docs():
    return lda_corpus(0, 64, W, K, doc_len_mean=50)[0]


def _cfgs(**kw):
    base = dict(BASE, **kw)
    return JConfig(**base, sweep_policy="dense_layout"), LDAConfig(**base)


def t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def _shard_draws(key, n, shape):
    """The reference's per-shard inits: one uniform draw a split key."""
    return np.stack([np.asarray(jax.random.uniform(k, shape, minval=0.01,
                                                   maxval=1.0))
                     for k in jax.random.split(key, n)])


def _sim_pair(batch, sync, sync_dtype, key, cfg_kw=None):
    jcfg, cfg = _cfgs(**(cfg_kw or {}))
    N, Dl, L = batch.word_ids.shape
    jfn, jmeter = jp.make_sim_minibatch_fn(jcfg, N, sync,
                                           sync_dtype=JDT[sync_dtype])
    want = jfn(batch.word_ids, batch.counts, jnp.zeros((W, K)), key,
               jnp.float32(1.0))
    fn, meter = pobp.make_sim_minibatch_fn(cfg, N, sync, sync_dtype,
                                           device="cpu")
    got = fn(t(batch.word_ids), t(batch.counts), torch.zeros((W, K)), 1.0,
             u0=t(_shard_draws(key, N, (Dl, L, K))))
    return want, jmeter, got, meter


@pytest.mark.parametrize("sync", ["power", "dense"])
@pytest.mark.parametrize("sync_dtype", ["float32", "bfloat16"])
def test_sim_minibatch_matches_reference(docs, sync, sync_dtype):
    """N = 4 through the port's lockstep simulation against the
    reference's ``make_sim_minibatch_fn(cfg, 4)``: phi_acc, theta,
    iterations and mean_r; the port's shards end bit-identical; the meter
    bills what the reference's bills, integer for integer."""
    b = next(iter(j_sharded(docs, 32, num_shards=4)))
    key = jax.random.PRNGKey(0)
    want, jmeter, got, meter = _sim_pair(b, sync, sync_dtype, key)
    phi, iters, mean_r, mu, theta = got
    assert phi.shape == (4, W, K) and theta.shape == (4, 8, K)
    for n in range(1, 4):
        assert torch.equal(phi[n], phi[0])
        assert float(mean_r[n]) == float(mean_r[0])
    assert iters.tolist() == np.asarray(want[1]).tolist()
    assert meter.bytes_by_phase == jmeter.bytes_by_phase
    if sync_dtype == "float32":
        np.testing.assert_allclose(phi[0].numpy(), np.asarray(want[0][0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(theta.numpy(), np.asarray(want[4]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mean_r.numpy(), np.asarray(want[2]),
                                   rtol=1e-4)
    else:
        f32, _, _, _ = _sim_pair(b, sync, "float32", key)
        for i in (0, 4):          # phi_acc, theta
            budget = 3 * _rel(want[i], f32[i])
            assert _rel(got[i], want[i]) <= budget, (i, budget)


def test_model_rw_goes_through_the_model_reducer(docs):
    """Two data shards: the packed r_w refresh is already synchronized by
    the data psum of r_pack, so it goes through the model reducer (one
    topic shard: nothing), as the reference's does; through the data
    reducer it would be counted twice and mean_r and the iterations would
    leave the reference's."""
    b = next(iter(j_sharded(docs, 32, num_shards=2)))
    kw = dict(inner_iters=30, residual_tol=0.15)
    want, jmeter, got, meter = _sim_pair(b, "power", "float32",
                                         jax.random.PRNGKey(3), kw)
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert 2 < int(got[1][0]) < 30
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    assert "model_rw_loop" not in meter.bytes_by_phase


def test_shards_agree_on_global_state(docs):
    """The reference's ``test_pobp_shards_agree_on_global_state``, on the
    port: every data shard ends the mini-batch with phi_acc identical, here
    bit for bit (the psums sum in shard order and hand every shard the
    same bits)."""
    b = next(iter(j_sharded(docs, 32, num_shards=4)))
    _, cfg = _cfgs()
    fn, _ = pobp.make_sim_minibatch_fn(cfg, 4, "power", device="cpu")
    phi, iters, *_ = fn(t(b.word_ids), t(b.counts), torch.zeros((W, K)),
                        1.0, generator=torch.Generator().manual_seed(0))
    assert phi.shape[0] == 4 and len(set(iters.tolist())) == 1
    for n in range(1, 4):
        assert torch.equal(phi[0], phi[n])


def test_comm_bytes_follow_eq5_and_eq6(docs):
    """The reference's ``test_comm_bytes_follow_eq5_and_eq6``, on the
    port's meter."""
    _, cfg = _cfgs(lambda_w=0.25, inner_iters=6, residual_tol=1e-9)
    b = next(iter(j_sharded(docs, 32, 4)))
    fn, meter = pobp.make_sim_minibatch_fn(cfg, 4, "power", device="cpu")
    _, iters, *_ = fn(t(b.word_ids), t(b.counts), torch.zeros((W, K)), 1.0,
                      generator=torch.Generator().manual_seed(0))
    P, Pk = cfg.num_power_words, cfg.num_power_topics
    assert meter.phase_bytes("power") == 2 * P * Pk * 4
    assert meter.phase_bytes("dense") == 2 * W * K * 4
    assert meter.per_minibatch_bytes(int(iters[0])) == \
        4 + 2 * W * K * 4 + (int(iters[0]) - 1) * 2 * P * Pk * 4
    assert power_sync_bytes(P, Pk, W) < dense_sync_bytes(W, K)
    assert power_sync_bytes(P, Pk, W) == j_power_sync_bytes(P, Pk, W)
    assert dense_sync_bytes(W, K) == j_dense_sync_bytes(W, K)


def test_bf16_sync_halves_bytes(docs):
    """The reference's ``test_bf16_sync_halves_bytes``, on the port."""
    _, cfg = _cfgs()
    b = next(iter(j_sharded(docs, 32, 4)))
    fn, meter = pobp.make_sim_minibatch_fn(cfg, 4, "power",
                                           sync_dtype=torch.bfloat16,
                                           device="cpu")
    fn(t(b.word_ids), t(b.counts), torch.zeros((W, K)), 1.0,
       generator=torch.Generator().manual_seed(0))
    P, Pk = cfg.num_power_words, cfg.num_power_topics
    assert meter.phase_bytes("power") == 2 * P * Pk * 2


@pytest.mark.parametrize("sync", ["power", "dense"])
def test_train_step_matches_reference_over_two_buckets(docs, sync):
    """``make_train_step(cfg, 4)`` over a stream of two length buckets with
    the Robbins-Monro decay on, against the reference's: per batch the
    iterations, mean_r and phi_acc; theta comes back [N, Dl, K]; at the
    end the meter's ``bytes_by_phase``, ``bytes_by_phase_at(live_w)`` and
    ``per_minibatch_bytes(iters)`` equal the reference's integer for
    integer."""
    kw = dict(decay_kappa=0.5, decay_tau0=2.0, init_pad_len=64,
              lr_schedule="power")
    jcfg, cfg = _cfgs(**kw)
    stream = list(j_bucketed(docs[:48], 16, num_shards=4,
                             len_buckets=(32, 64), prefetch=0))
    assert len({b.word_ids.shape[-1] for b in stream}) == 2
    jstep, jmeter = jp.make_train_step(jcfg, 4, sync)
    jstate = jp.init_train_state(jcfg, 5)
    step, meter = pobp.make_train_step(cfg, 4, sync, device="cpu")
    state = pobp.init_train_state(cfg, 5, device="cpu")
    key = jstate.rng
    iters = []
    for b in stream:
        key, sub = jax.random.split(key)
        N, Dl, L = b.word_ids.shape
        u0 = _shard_draws(sub, N, (Dl, 64, K))
        jstate, jdiag = jstep(jstate, b.word_ids, b.counts)
        state, diag = step(state, t(b.word_ids), t(b.counts), u0=t(u0))
        assert diag["iters"] == int(jdiag["iters"])
        assert diag["theta"].shape == (4, Dl, K)
        iters.append(diag["iters"])
        np.testing.assert_allclose(float(diag["mean_r"]),
                                   float(jdiag["mean_r"]), rtol=1e-4)
        np.testing.assert_allclose(state.phi_acc.numpy(),
                                   np.asarray(jstate.phi_acc), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(diag["theta"].numpy(),
                                   np.asarray(jdiag["theta"]), rtol=1e-4,
                                   atol=1e-4)
    assert meter.bytes_by_phase == jmeter.bytes_by_phase
    assert "decay" in meter.bytes_by_phase
    assert meter.bytes_by_phase_at(W // 3) == jmeter.bytes_by_phase_at(W // 3)
    for it in iters + [1, 30]:
        for live in (None, W // 3):
            assert meter.per_minibatch_bytes(it, live_w=live) == \
                jmeter.per_minibatch_bytes(it, live_w=live)


# ------------------------------------------- a data x model grid, in threads

def _grid_reducers(meter, sync_dtype):
    """2 data x 2 topic shards, shard s = 2 d + m: the data psums meet the
    shards of one topic shard, the model psums those of one data shard."""
    data = SimReducer(4, meter=meter, sync_dtype=sync_dtype,
                      groups=[[0, 2], [1, 3]])
    model = SimReducer(4, meter=meter, sync_dtype=sync_dtype,
                       groups=[[0, 1], [2, 3]])
    return data, model


def _reference_grid(jcfg, sync, sync_dtype):
    """The reference's mesh body under two nested vmaps named ``data`` and
    ``model``: the same psums as shard_map binds, on one CPU device."""
    local, jmeter = jp.make_mesh_shard_fn(jcfg, ("data", "model"), sync,
                                          JDT[sync_dtype])

    def per_data(wid, cnt, phi_shards, key, w):
        return jax.vmap(local, in_axes=(None, None, 0, None, None),
                        axis_name="model")(wid, cnt, phi_shards, key, w)

    return jax.jit(jax.vmap(per_data, in_axes=(0, 0, None, None, None),
                            axis_name="data")), jmeter


@pytest.mark.parametrize("sync", ["power", "dense"])
@pytest.mark.parametrize("sync_dtype", ["float32", "bfloat16"])
def test_topic_sharded_grid_matches_reference_nested_vmap(docs, sync,
                                                          sync_dtype):
    """2 data x 2 topic shards in lockstep (`pobp_shard_body` with a data
    and a model `SimReducer`) against the reference's mesh body under
    nested vmaps, over two length buckets: with the topics sharded the
    dense sweep's normalizer and r_w go through the model psums
    (``model_norm``, ``model_rw``, ``model_rw_loop``, and in dense sync
    ``model_norm_loop``).  Every shard ends with the same iterations and
    the data shards with identical statistics; the meter equals the
    reference's integer for integer, the L-dependent ``model_norm`` billed
    at the larger bucket (the per-phase max over shape variants)."""
    jcfg, cfg = _cfgs(lambda_k_abs=3)
    ref, jmeter = _reference_grid(jcfg, sync, sync_dtype)
    ref32, _ = _reference_grid(jcfg, sync, "float32")
    stream = list(j_bucketed(docs[:48], 16, num_shards=2,
                             len_buckets=(32, 64), prefetch=0))
    assert len({b.word_ids.shape[-1] for b in stream}) == 2
    meter_ = CommMeter()
    data, model = _grid_reducers(meter_, sync_dtype)
    phi = np.zeros((W, K), np.float32)
    jphi = phi
    for i, b in enumerate(stream):
        key = jax.random.PRNGKey(10 + i)
        _, Dl, L = b.word_ids.shape
        u0 = t(jax.random.uniform(key, (Dl, L, K // 2), minval=0.01,
                                  maxval=1.0))
        jshards = jnp.transpose(jnp.asarray(jphi).reshape(W, 2, K // 2),
                                (1, 0, 2))
        jnew, jiters, jmean = ref(b.word_ids, b.counts, jshards, key,
                                  jnp.float32(1.0))
        wid, cnt = t(b.word_ids), t(b.counts)
        shards = t(phi).reshape(W, 2, K // 2).permute(1, 0, 2).contiguous()
        outs = lockstep(
            lambda s: pobp.pobp_shard_body(
                wid[s // 2], cnt[s // 2], shards[s % 2], 1.0, cfg, data,
                model, sync_mode=sync, u0=u0),
            4, [data, model], "cpu")
        assert len({o[1] for o in outs}) == 1
        assert outs[0][1] == int(np.asarray(jiters)[0, 0])
        for m in range(2):
            assert torch.equal(outs[m][0], outs[2 + m][0])
        phi = torch.cat([outs[0][0], outs[1][0]], dim=1).numpy()
        jphi = np.concatenate([np.asarray(jnew)[0, 0], np.asarray(jnew)[0, 1]],
                              axis=1)
        if sync_dtype == "float32":
            np.testing.assert_allclose(phi, jphi, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(float(outs[0][2]),
                                       float(np.asarray(jmean)[0, 0]),
                                       rtol=1e-4)
        else:
            j32 = np.asarray(ref32(b.word_ids, b.counts, jshards, key,
                                   jnp.float32(1.0))[0])
            assert _rel(phi, jphi) <= 3 * _rel(
                jphi, np.concatenate([j32[0, 0], j32[0, 1]], axis=1))
        jphi = phi                 # both continue from the port's state
    by = meter_.bytes_by_phase
    assert by == jmeter.bytes_by_phase
    for phase in ("model_norm", "model_rw", "dense", "tokens"):
        assert by[phase] > 0
    assert ("model_rw_loop" if sync == "power" else "model_norm_loop") in by
    Lmax = max(b.word_ids.shape[-1] for b in stream)
    # the init's and the t = 1 sweep's normalizers, [Dl, Lmax, 1] f32 each
    assert by["model_norm"] == 2 * 8 * Lmax * 4
    assert meter_.bytes_by_phase_at(50) == jmeter.bytes_by_phase_at(50)
    for it in (1, 5, 8):
        assert meter_.per_minibatch_bytes(it) == \
            jmeter.per_minibatch_bytes(it)


def test_make_train_step_refuses_a_malformed_shard_batch():
    _, cfg = _cfgs()
    step, _ = pobp.make_train_step(cfg, 4, device="cpu")
    state = pobp.init_train_state(cfg, device="cpu")
    ids = torch.zeros((4, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="u0 must have shape"):
        step(state, ids, torch.ones((4, 2, 8)), u0=torch.ones((4, 2, 8, 3)))
    with pytest.raises(ValueError, match=r"\[N=4, Dl, L\]"):
        step(state, ids[:3], torch.ones((3, 2, 8)))
    out, _ = step(state, ids, torch.ones((4, 2, 8)))
    assert out.m == 1 and float(out.phi_acc.sum()) == pytest.approx(64.0)


def test_run_stream_takes_a_sharded_stream(docs):
    """``run_stream(num_shards=4)`` over ``sharded_minibatch_stream``
    (the reference's N-shard loop): every token lands in phi_acc."""
    from repro_torch.data.batching import sharded_minibatch_stream

    _, cfg = _cfgs(inner_iters=4)
    phi, hist, meter = pobp.run_stream(
        sharded_minibatch_stream(docs[:40], 20, 4), cfg, num_shards=4,
        seed=2, device="cpu")
    tokens = sum(float(c.sum()) for _, c in docs[:40])
    assert [h["m"] for h in hist] == [1, 2]
    assert float(phi.sum()) == pytest.approx(tokens, rel=1e-5)
    assert meter.phase_bytes("dense") == 2 * W * K * 4
    cfg16 = dataclasses.replace(cfg, phi_acc_dtype="bfloat16")
    phi16, _, _ = pobp.run_stream(
        sharded_minibatch_stream(docs[:40], 20, 4), cfg16, num_shards=4,
        seed=2, sync_dtype="bfloat16", device="cpu")
    assert phi16.dtype == torch.bfloat16

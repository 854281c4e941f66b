"""Topic-sharded serving over the ranks of a ``DeviceMesh`` (the engines'
``from_checkpoint(sharding=)``), held against the JAX package's
``topic_shards`` engines and the port's one-process ones.

Each mesh shape is one spawn of gloo processes on the CPU (rank bodies in
``tests/torch_serve_ranks.py``, torch only); every rank serves the same
requests in the same order.  On a 1 x 2 mesh each rank holds its [W', K/2]
topic block: the slab with the reference's init draws replayed matches
the reference's ``SlabEngine(topic_shards=2)`` within rtol 1e-4, atol
1e-6, with the same ids, iterations, slots and steps and the bytes by
phase integer for integer; the bucket engine matches the reference's
``FoldInEngine(topic_shards=2)`` (draws replayed) and the port's
one-process engine (the same seed) within atol 1e-5, the gate of the
one-process sharded engines.  The two ranks return the same bits.  1 x 1
and 2 x 1 meshes serve as the unplaced engine, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from repro.dist import checkpoint as jckpt
from repro.serve import FoldInEngine as JFoldInEngine
from repro.serve import SlabEngine as JSlabEngine
from repro_torch.core.types import LDAConfig
from repro_torch.data.synthetic import lda_corpus
from repro_torch.dist import checkpoint as ckpt
from repro_torch.serve import FoldInEngine, SlabEngine

import torch_serve_ranks

W, K = 150, 16
LIVE = 140                  # live rows of the dynamic and normalized cases
SLAB = dict(slots=6, slot_len=48, sweeps_per_step=2, fold_iters=30,
            residual_tol=1e-2, seed=7, pipeline=0)
BUCKET = dict(len_buckets=(32, 64), batch_docs=8, fold_iters=30,
              residual_tol=1e-2, seed=5)
N_DOCS = 18


def _dyn_doc(doc):
    """A document in the dynamic checkpoint's external keys; words past
    the live rows become an unseen key."""
    ids, cnt = doc
    keys = np.where(ids < LIVE, 1000 + 3 * ids, 7).astype(np.int64)
    return keys, cnt


def _inputs(work):
    docs, _, true_phi = lda_corpus(0, 48, W, K, doc_len_mean=30)
    phi = (true_phi.T * 200.0).astype(np.float32)
    docs = docs[:N_DOCS]
    jckpt.save(f"{work}/ck", 3,
               {"state": {"phi_acc": jnp.asarray(phi),
                          "m": jnp.asarray(3, jnp.int32),
                          "rng": jax.random.PRNGKey(0)}},
               extra={"next_m": 3, "run": {"vocab": W, "topics": K}})
    ckpt.save(f"{work}/ck2", 1, {"state": {"phi_acc": torch.from_numpy(
        phi * 0.5 + 1.0)}})
    dyn = np.zeros((W + 10, K), np.float32)
    dyn[:LIVE] = phi[:LIVE]
    jckpt.save(f"{work}/dyn", 4, {"state": {"phi_acc": jnp.asarray(dyn)}},
               extra={"run": {"vocab": W + 10, "topics": K},
                      "dyn": {"w_cap": W + 10, "live_w": LIVE,
                              "vocab_version": 2,
                              "vocab_keys": [1000 + 3 * i
                                             for i in range(LIVE)]}})
    norm = phi + 0.01
    norm /= norm[:LIVE].sum(axis=0, keepdims=True)
    ckpt.save(f"{work}/norm", 1, {"state": {"phi_acc": torch.from_numpy(
        norm)}})
    key, slab_draws = jax.random.PRNGKey(SLAB["seed"]), []
    for _ in range(200):    # one split a slab step, as the reference's
        key, sub = jax.random.split(key)
        slab_draws.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, (1, SLAB["slot_len"], K), minval=0.01, maxval=1.0))))
    key, bucket_draws = jax.random.PRNGKey(BUCKET["seed"]), []
    for _ in range(20):     # one split a dispatch, at the largest bucket
        key, sub = jax.random.split(key)
        bucket_draws.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, (BUCKET["batch_docs"], max(BUCKET["len_buckets"]), K),
            minval=0.01, maxval=1.0))))
    return {"docs": docs, "dyn_docs": [_dyn_doc(d) for d in docs],
            "phi_acc": torch.from_numpy(phi), "phi3": phi[:, ::-1].copy(),
            "shape": (W, K), "cfg": LDAConfig(vocab_size=W, num_topics=K),
            "ckpt": f"{work}/ck", "ckpt2": f"{work}/ck2",
            "dyn_ckpt": f"{work}/dyn", "norm_ckpt": f"{work}/norm",
            "norm_live": LIVE, "slab_kw": SLAB, "bucket_kw": BUCKET,
            "slab_draws": slab_draws, "bucket_draws": bucket_draws}


def _spawn(work, shape):
    inp = _inputs(work)
    torch.save(inp, os.path.join(work, "inputs.pt"))
    world = shape[0] * shape[1]
    tmp_mp.start_processes(torch_serve_ranks.serve_rank,
                           args=(world, work, shape), nprocs=world,
                           join=True, start_method="spawn")
    return inp, [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("serve12")), (1, 2))


@pytest.fixture(scope="module", params=[(1, 1), (2, 1)],
            ids=["1x1", "2x1"])
def no_model_split(request, tmp_path_factory):
    return request.param, _spawn(str(tmp_path_factory.mktemp("serve_m1")),
                                 request.param)


def _serve(engine, docs):
    for d in docs:
        engine.submit(d)
    return {r.req_id: r for r in engine.drain()}


def _close(got, want, **tol):
    """Served dicts (rank tuples or `ServeResult`s) with the same ids and
    iterations, thetas within ``tol``."""
    assert sorted(got) == sorted(want)
    for rid in want:
        w = want[rid]
        w_theta, w_iters = ((w.theta, w.iters) if hasattr(w, "theta")
                            else w[:2])
        assert got[rid][1] == w_iters, rid
        np.testing.assert_allclose(got[rid][0], w_theta, err_msg=str(rid),
                                   **tol)


def _same_bits(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert np.array_equal(a[rid][0], b[rid][0]), rid
        assert a[rid][1:] == b[rid][1:], rid


def _port(inp, cls, ckpt_dir=None, **kw):
    base = SLAB if cls is SlabEngine else BUCKET
    return cls.from_checkpoint(ckpt_dir or inp["ckpt"], device="cpu",
                               **{**base, **kw})


# --------------------------------------------------------------- 1 x 2


def test_placed_slab_matches_the_reference_two_shard_slab(one_by_two):
    inp, ranks = one_by_two
    jeng = JSlabEngine.from_checkpoint(inp["ckpt"], topic_shards=2, **SLAB)
    want = _serve(jeng, inp["docs"])
    got, stats = ranks[0]["slab_ref"]
    _close(got, want, rtol=1e-4, atol=1e-6)
    for rid in want:
        assert got[rid][2] == want[rid].bucket, rid
    assert stats["steps"] == jeng.stats()["steps"]
    assert set(stats) == set(jeng.stats())


def test_placed_slab_bills_the_reference_bytes(one_by_two):
    inp, ranks = one_by_two
    jeng = JSlabEngine.from_checkpoint(inp["ckpt"], topic_shards=2, **SLAB)
    _serve(jeng, inp["docs"])
    one = _port(inp, SlabEngine, topic_shards=2)
    _serve(one, inp["docs"])
    for r in ranks:
        by = r["slab_ref"][1]["bytes_by_phase"]
        assert by == jeng.meter.bytes_by_phase == one.meter.bytes_by_phase
        assert by.get("slab_norm_loop", 0) > 0


def test_placed_ranks_return_the_same_bits(one_by_two):
    _, (a, b) = one_by_two
    assert (a["coord"], b["coord"]) == ((0, 0), (0, 1))
    for case in ("slab_ref", "bucket_ref", "bucket_seeded", "shards4",
                 "dyn", "normalized", "slo"):
        _same_bits(a[case][0], b[case][0])
    for x, y in zip(a["swap"][0], b["swap"][0]):
        _same_bits(x, y)
    _same_bits(a["bucket_swap"], b["bucket_swap"])


def test_placed_bucket_matches_the_reference_and_one_process(one_by_two):
    inp, ranks = one_by_two
    jeng = JFoldInEngine.from_checkpoint(inp["ckpt"], topic_shards=2,
                                         warmup=False, **BUCKET)
    got, stats = ranks[0]["bucket_ref"]
    _close(got, _serve(jeng, inp["docs"]), atol=1e-5)
    assert stats["bytes_by_phase"] == jeng.stats()["bytes_by_phase"]
    assert set(stats) == set(jeng.stats())
    one = _port(inp, FoldInEngine, topic_shards=2)
    seeded, sstats, gathered = ranks[0]["bucket_seeded"]
    _close(seeded, _serve(one, inp["docs"]), atol=1e-5)
    assert sstats["bytes_by_phase"] == one.stats()["bytes_by_phase"]
    # theta's [D, K/2] block a dispatch and a warm-up bucket, gathered
    # outside the meter
    runs = sstats["dispatches"] + len(BUCKET["len_buckets"])
    assert gathered == runs * BUCKET["batch_docs"] * K // 2 * 4


def test_flush_stale_dispatches_the_same_batches_on_every_rank(one_by_two):
    _, (a, b) = one_by_two
    assert a["flush_stale"][0] == b["flush_stale"][0] > 0
    _same_bits(a["flush_stale"][1], b["flush_stale"][1])


def test_four_shards_on_two_ranks_match_the_one_process_engine(one_by_two):
    inp, ranks = one_by_two
    one = _port(inp, SlabEngine, topic_shards=4)
    want = _serve(one, inp["docs"])
    got, by, shape = ranks[0]["shards4"]
    assert shape == (2, W + 1, K // 4)
    _close(got, want, atol=1e-5)
    assert by == one.stats()["bytes_by_phase"]


def test_shards_that_do_not_split_over_the_ranks_raise(one_by_two):
    _, ranks = one_by_two
    for r in ranks:
        msg = r["shards3"]
        assert msg.startswith("ValueError") and "topic_shards=3" in msg \
            and "2 ranks" in msg


def test_dynamic_vocabulary_checkpoint_serves_placed_as_unplaced(
        one_by_two):
    inp, ranks = one_by_two
    one = _port(inp, SlabEngine, inp["dyn_ckpt"], topic_shards=2)
    want = _serve(one, inp["dyn_docs"])
    got, stats = ranks[0]["dyn"]
    _close(got, want, atol=1e-6)
    assert any(g[5] > 0 for g in got.values())          # OOV mass served
    for rid in want:
        assert got[rid][5] == want[rid].oov_tokens
        assert got[rid][6] == want[rid].phi_version == 2
    for key in ("live_words", "w_cap", "oov_rate", "bytes_by_phase"):
        assert stats[key] == one.stats()[key], key
    assert (stats["live_words"], stats["w_cap"]) == (LIVE, W + 10)


def test_normalized_phi_serves_placed_as_unplaced(one_by_two):
    inp, ranks = one_by_two
    norm, _, _ = ckpt.restore_phi(inp["norm_ckpt"])
    one = SlabEngine(norm, LDAConfig(vocab_size=W, num_topics=K),
                     normalized=True, live_words=LIVE, topic_shards=2,
                     device="cpu", **SLAB)
    got, guard = ranks[0]["normalized"]
    _close(got, _serve(one, inp["docs"]), atol=1e-6)
    # the guard rows carry 1/K of the global K, not of the rank's K/2
    assert torch.equal(guard, torch.full((1, K // 2), 1.0 / K))


def test_swap_phi_serves_placed_as_unplaced(one_by_two):
    inp, ranks = one_by_two
    one = _port(inp, SlabEngine, topic_shards=2)
    docs = inp["docs"]
    want = [_serve(one, docs[:6])]
    one.swap_phi(torch.from_numpy(inp["phi_acc"].numpy() * 0.5 + 1.0))
    want.append(_serve(one, docs[6:12]))
    one.swap_phi(inp["phi3"])
    want.append(_serve(one, docs[12:18]))
    swapped, shape = ranks[0]["swap"]
    assert shape == (1, W + 1, K // 2)
    for version, (g, w) in enumerate(zip(swapped, want)):
        _close(g, w, atol=1e-6)
        assert {x[6] for x in g.values()} == {version}
    bone = _port(inp, FoldInEngine, topic_shards=2)
    bone.swap_phi(inp["phi3"])
    _close(ranks[0]["bucket_swap"], _serve(bone, docs[:8]), atol=1e-5)
    msg = ranks[0]["swap_other_placement"]
    assert msg.startswith("ValueError") and "swap_phi" in msg


def test_no_rank_holds_more_than_its_topic_block(one_by_two):
    _, ranks = one_by_two
    for r in ranks:
        for case in ("resident_slab", "resident_bucket"):
            shape, phi_like = r[case]
            assert shape == (1, W + 1, K // 2)
            # the only tensor with phi's rows is phi's block itself
            assert phi_like == [shape], (case, phi_like)


def test_placements_that_would_gather_phi_raise(one_by_two):
    _, ranks = one_by_two
    for r in ranks:
        assert r["rows_placed"].startswith("ValueError") and \
            "gather phi whole" in r["rows_placed"]
        assert r["is_dtensor"]
        assert r["no_model_axis"].startswith("ValueError") and \
            "'model'" in r["no_model_axis"]


def test_a_failed_collective_raises(one_by_two):
    _, ranks = one_by_two
    for r in ranks:
        assert r["broken_collective"] == "RuntimeError: all_reduce refused"


def test_shedding_reads_a_step_time_every_rank_shares(one_by_two):
    inp, (a, b) = one_by_two
    assert a["slo"][1] == b["slo"][1] > 0
    one = _port(inp, SlabEngine, topic_shards=2)
    _close(a["slo"][0], _serve(one, inp["docs"]), atol=1e-6)


def test_placed_restore_cuts_each_block_on_the_host(one_by_two):
    """``_placed`` cuts the blocks ``distribute_tensor`` cuts, each rank's
    local tensor holding only its block."""
    _, ranks = one_by_two
    for r in ranks:
        assert r["spec"] == [None, "model"]
        for spec, (equal, own, shape, _) in r["placed"].items():
            assert equal and own and shape == (W, K), spec
        assert r["placed"]["P(None, 'model')"][3] == ["R", "S(1)"]


# --------------------------------------------------------------- M = 1


def test_meshes_without_a_topic_split_serve_bit_for_bit(no_model_split):
    shape, (_, ranks) = no_model_split
    for r in ranks:
        for engine in ("slab", "bucket"):
            placed, plain, local, pshape, ushape, by = r[engine]
            assert local and pshape == ushape == (W + 1, K)
            assert by == {}
            _same_bits(placed, plain)
            assert len(placed) == N_DOCS
        for spec, (equal, own, gshape, _) in r["placed"].items():
            assert equal and own and gshape == (W, K), spec
    if len(ranks) == 2:
        for engine in ("slab", "bucket"):
            _same_bits(ranks[0][engine][0], ranks[1][engine][0])

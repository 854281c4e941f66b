"""The port's stream-lifecycle transitions (``core/lifecycle.py``) held
against the JAX package's: the capacity resize (grow, the fenced shrink and
its refusals, a shrink that frees the old rung), the compaction remap on
the device, the dead-row and dead-topic tests, topic recycling, and the
checkpoint's row-remap restore commuting with compaction.

Tolerances: none.  Resizes and remaps move values without arithmetic, and
the host-side tests run the reference's numpy code, so every result must
equal the reference's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lifecycle as jlife
from repro.core.types import LDATrainState as JState
from repro.data.vocab import VocabMap as JVocab
from repro_torch.core import lifecycle
from repro_torch.core.types import LDATrainState
from repro_torch.data.vocab import VocabMap
from repro_torch.dist import checkpoint as ckpt

K = 8


def _state(phi, m=3):
    return LDATrainState(phi_acc=torch.as_tensor(phi), m=m,
                         generator=torch.Generator().manual_seed(5))


def _jstate(phi, m=3):
    return JState(phi_acc=jnp.asarray(phi), m=jnp.asarray(m, jnp.int32),
                  rng=jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_state_grows_guard_rows_and_shrinks_under_a_fence(dtype):
    rng = np.random.default_rng(0)
    phi = rng.gamma(1.0, size=(64, K)).astype(np.float32)
    s = LDATrainState(phi_acc=torch.as_tensor(phi).to(dtype), m=4,
                      generator=torch.Generator().manual_seed(1))
    g = lifecycle.resize_state(s, 128)
    want = jlife.resize_state(_jstate(s.phi_acc.float().numpy()), 128)
    assert g.phi_acc.shape == (128, K) and g.phi_acc.dtype == dtype
    np.testing.assert_array_equal(g.phi_acc.float().numpy(),
                                  np.asarray(want.phi_acc))
    assert torch.equal(g.phi_acc[:64], s.phi_acc)
    assert not g.phi_acc[64:].any()                       # guard rows 0
    assert g.m == 4 and g.generator is s.generator
    assert lifecycle.resize_state(g, 128) is g             # same rung
    back = lifecycle.resize_state(g, 72, live_w=60)
    assert back.phi_acc.shape == (72, K) and back.phi_acc.dtype == dtype
    assert torch.equal(back.phi_acc, g.phi_acc[:72])
    assert back.m == 4 and back.generator is s.generator


def test_resize_state_refusals_match_the_reference():
    g = _state(np.zeros((128, K), np.float32))
    jg = _jstate(np.zeros((128, K), np.float32))
    for kw, match in (({}, "without a fence"),
                      ({"live_w": 64}, "strictly above")):
        with pytest.raises(ValueError, match=match) as mine:
            lifecycle.resize_state(g, 64, **kw)
        with pytest.raises(ValueError) as theirs:
            jlife.resize_state(jg, 64, **kw)
        assert str(mine.value) == str(theirs.value)


def test_a_shrink_owns_its_storage_so_the_old_rung_can_be_freed():
    """A shrink copies the kept rows: the new phi_acc shares no storage
    with the old one, and holds only the new rung's bytes; the old
    tensor, once its state goes, is freed."""
    import gc
    import weakref

    phi = torch.rand((256, K))
    s = _state(phi)
    old_storage = s.phi_acc.untyped_storage()
    small = lifecycle.resize_state(s, 96, live_w=80)
    new_storage = small.phi_acc.untyped_storage()
    assert new_storage.data_ptr() != old_storage.data_ptr()
    assert new_storage.nbytes() == 96 * K * 4
    assert small.phi_acc.is_contiguous()
    ref = weakref.ref(s.phi_acc)
    del s, phi, old_storage
    gc.collect()
    assert ref() is None                      # nothing pins the old rung


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_row_remap_matches_the_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    W = 40
    phi = rng.gamma(1.0, size=(W, K)).astype(np.float32)
    n = int(rng.integers(10, 32))
    remap = JVocab(list(range(n))).compact(rng.random(n) > 0.4)
    got = lifecycle.apply_row_remap(
        LDATrainState(phi_acc=torch.as_tensor(phi).to(dtype), m=2,
                      generator=torch.Generator()), remap)
    want = np.asarray(jlife.apply_row_remap(
        _jstate(torch.as_tensor(phi).to(dtype).float().numpy()),
        remap).phi_acc)
    assert got.phi_acc.dtype == dtype and got.m == 2
    np.testing.assert_array_equal(got.phi_acc.float().numpy(), want)
    assert not got.phi_acc[int((remap >= 0).sum()):].any()
    with pytest.raises(ValueError, match="remap covers"):
        lifecycle.apply_row_remap(got, np.zeros(W + 1, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dead_rows_and_dead_topics_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    mass = rng.gamma(0.5, 4.0, size=60)
    touched = rng.integers(-1, 12, size=60)
    for step, idle, floor in ((11, 3, 1.0), (11, 0, 0.5), (20, 5, 100.0)):
        np.testing.assert_array_equal(
            lifecycle.dead_rows(mass, touched, step, idle, floor),
            jlife.dead_rows(mass, touched, step, idle, floor))
    phi = rng.gamma(1.0, size=(50, K)).astype(np.float32)
    phi[:40, seed % K] *= 1e-4
    for tol in (0.01, 0.5, 2.0):
        np.testing.assert_array_equal(lifecycle.dead_topics(phi, 40, tol),
                                      jlife.dead_topics(phi, 40, tol))


@pytest.mark.parametrize("seed", [0, 1])
def test_recycle_topics_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    W, live = 64, 50
    phi = rng.gamma(1.0, size=(W, K)).astype(np.float32) + 0.5
    phi[:live, [2, 5]] = 1e-9
    got, rec = lifecycle.recycle_topics(phi, live, tol=0.01)
    want, jrec = jlife.recycle_topics(phi, live, tol=0.01)
    assert rec == jrec == [2, 5]
    np.testing.assert_array_equal(got, want)
    same, none = lifecycle.recycle_topics(got, live, tol=1e-9)
    assert none == [] and same is got


def test_compact_then_restore_equals_restore_then_compact(tmp_path):
    """The port's checkpoint: restoring a pre-compaction phi through the
    manifest's row remap lands on the state the fenced compaction made on
    the device, at the same rung and one rung down; without the remap a
    shrinking restore is refused."""
    rng = np.random.default_rng(1)
    phi = rng.gamma(1.0, size=(64, K)).astype(np.float32)
    s = _state(phi, m=4)
    v = VocabMap(list(range(40)))
    remap = v.compact(rng.random(40) > 0.3)
    compacted = lifecycle.apply_row_remap(s, remap)
    d1, d2 = str(tmp_path / "post"), str(tmp_path / "pre")
    ckpt.save(d1, 4, {"state": {"phi_acc": compacted.phi_acc}})
    tmpl = {"state": {"phi_acc": torch.zeros((64, K))}}
    post, _, _ = ckpt.restore_latest(d1, tmpl)
    ckpt.save(d2, 4, {"state": {"phi_acc": s.phi_acc}},
              extra={"dyn": {"row_remap": [int(r) for r in remap]}})
    extra, _ = ckpt.peek_extra(d2)
    row_remap = extra["dyn"]["row_remap"]
    pre, _, _ = ckpt.restore_latest(d2, tmpl,
                                    row_remaps={"phi_acc": row_remap})
    assert torch.equal(post["state"]["phi_acc"], pre["state"]["phi_acc"])
    assert torch.equal(pre["state"]["phi_acc"], compacted.phi_acc)
    small = {"state": {"phi_acc": torch.zeros((48, K))}}
    shrunk, _, _ = ckpt.restore_latest(d2, small,
                                       row_remaps={"phi_acc": row_remap})
    assert torch.equal(shrunk["state"]["phi_acc"], compacted.phi_acc[:48])
    assert torch.equal(
        shrunk["state"]["phi_acc"],
        lifecycle.resize_state(compacted, 48, live_w=v.live).phi_acc)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_latest(d2, small, grow_rows=("phi_acc",))
    arr, _, _ = ckpt.restore_phi(d2, w_cap=48, row_remap=row_remap)
    assert torch.equal(arr, compacted.phi_acc[:48])
    with pytest.raises(ValueError, match="shrink"):
        ckpt.restore_phi(d2, w_cap=48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recycling_fence_resumes_bit_for_bit(tmp_path, dtype):
    """The driver's fence with topic recycling (``--recycle-tol 1``: every
    topic at or under the mean mass) in both storage dtypes: each fence
    recycles, the host round trip keeps the dtype, and a crash after batch
    3 resumes from the post-recycling checkpoint at 2 and ends equal to the
    uninterrupted run bit for bit (``tests/test_torch_cuda.py`` runs the
    same case on the card)."""
    from repro_torch.launch import lda_train

    def args(ck, *extra):
        return lda_train.build_parser().parse_args([
            "--minibatches", "6", "--docs-per-batch", "32", "--vocab", "96",
            "--topics", "16", "--lambda-k", "8", "--shards", "1",
            "--dynamic-vocab", "--drift-mode", "slide",
            "--vocab-growth-per-batch", "6", "--decay", "1,0.3",
            "--compact-every", "2", "--compact-min-idle", "2",
            "--compact-mass-tol", "60", "--recycle-tol", "1.0",
            "--tol", "1e-9", "--log-every", "0", "--ckpt-every", "2",
            "--phi-acc-dtype", dtype, "--ckpt-dir", str(ck),
            "--device", "cpu", *extra])

    full = lda_train.train_loop(args(tmp_path / "a"))
    assert [e["m"] for e in full["compaction_events"]] == [2, 4, 6]
    assert all(e["recycled"] for e in full["compaction_events"])
    assert full["phi_acc"].dtype == getattr(torch, dtype)
    with pytest.raises(SystemExit):
        lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    resumed = lda_train.train_loop(args(tmp_path / "b", "--crash-at", "3"))
    assert resumed["first_m"] == 2
    assert resumed["mean_r"] == full["mean_r"][2:]
    assert resumed["iters"] == full["iters"][2:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])
    assert resumed["compaction_events"] == full["compaction_events"][1:]

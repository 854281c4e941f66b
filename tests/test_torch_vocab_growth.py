"""The port's live-W training (the dynamic vocabulary on the capacity
ladder) and its driver's lifecycle, held against the JAX package.

  - ``select_power_words_live`` against the reference's: the live count,
    the live slots where the residual is non-zero, dead slots on the first
    guard row.
  - one live-W mini-batch (W_cap > live_w) against the reference's, the
    reference's init injected, in ``power`` and ``dense`` sync and as two
    data shards in lockstep; the same at live_w == W against the port's
    fixed-W step; the meter's live-W bytes.
  - the driver on the CPU: a grown run against a fresh run at the final
    rung, crash-resume across a growth event and across a compaction fence,
    a bf16 phi_acc; the port's driver against the reference's on the same
    grow and slide flags (growth events, keys, touch stamps, rungs, and with
    a mass floor above every idle row the fences' remaps); a checkpoint the
    reference's driver wrote after a fence, read by the port and continued
    by both packages.

Tolerances: a mini-batch or step is held to rtol 1e-4 (the port sums in
other orders than XLA; iterations exact), grown against fresh to rtol 1e-6
(the reference's own bound for that property), guard rows exactly 0; the
port's crash-resume on the CPU is exact; the stream-derived quantities
(keys, stamps, rungs, growth events, remaps) are exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pobp as jp
from repro.core import power as jpw
from repro.core.sync import LocalReducer as JLocalReducer
from repro.core.types import LDAConfig as JConfig
from repro.core.types import LDATrainState as JState
from repro.data import docs_to_padded as j_docs_to_padded
from repro.data import lda_corpus as j_lda_corpus
from repro.data.vocab import VocabMap as JVocab
from repro.dist import checkpoint as jckpt
from repro.launch import lda_train as jcli
from repro_torch.core import pobp, power
from repro_torch.core.types import LDAConfig, MiniBatch
from repro_torch.data.vocab import VocabMap, next_capacity
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch import lda_train as cli

W, K, D, L = 200, 16, 32, 32
W_CAP = 256


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def _cfgs(vocab_size=W_CAP, **kw):
    base = dict(vocab_size=vocab_size, num_topics=K, lambda_k_abs=8)
    base.update(kw)
    return JConfig(**base, sweep_policy="dense_layout"), LDAConfig(**base)


@pytest.fixture(scope="module")
def batch():
    docs, _, true_phi = j_lda_corpus(5, D, W, K, doc_len_mean=40)
    jb = j_docs_to_padded(docs, max_len=L)
    rng = np.random.default_rng(0)
    acc = np.zeros((W_CAP, K), np.float32)
    acc[:W] = true_phi.T * 50 * rng.random(true_phi.T.shape)
    return jb, MiniBatch(t(jb.word_ids), t(jb.counts)), acc


# ------------------------------------------------------ live selection

@pytest.mark.parametrize("live,lam", [(200, 0.1), (37, 0.1), (130, 0.25),
                                      (255, 0.1), (7, 0.3)])
def test_select_power_words_live_matches_the_reference(live, lam):
    """Same live count, the same words on the live slots where the residual
    is non-zero (zero-residual ties may break otherwise), guard rows never
    selected, every dead slot on row live_w."""
    rng = np.random.default_rng(live)
    r_w = np.zeros(W_CAP, np.float32)
    touched = rng.choice(live, max(1, live // 2), replace=False)
    r_w[touched] = rng.random(touched.size).astype(np.float32) + 0.1
    r_w[live:] = 5.0                         # guard rows must lose anyway
    P = max(1, int(round(lam * W_CAP)))
    got = power.select_power_words_live(t(r_w), P, live, lam).numpy()
    want = np.asarray(jpw.select_power_words_live(
        jnp.asarray(r_w), P, jnp.int32(live), lam))
    p_live = power.num_live_power_words(live, lam)
    assert int(np.sum(want != live)) == p_live
    assert got.dtype == np.int32 and got.shape == (P,)
    np.testing.assert_array_equal(got[p_live:], live)
    np.testing.assert_array_equal(want[p_live:], live)
    assert (got[:p_live] < live).all() and len(set(got[:p_live])) == p_live
    nz = lambda sel: {int(w) for w in sel if r_w[w] > 0}    # noqa: E731
    assert nz(got[:p_live]) == nz(want[:p_live])
    n_nz = min(p_live, int((r_w[:live] > 0).sum()))
    np.testing.assert_array_equal(got[:n_nz], want[:n_nz])


def test_live_power_count_is_a_float32_floor():
    """P_live = floor(float32(lambda_w) * float32(live_w)): near an integer
    the float32 product can floor to another count than the double one."""
    hits = [(lam, live) for lam in (0.1, 0.7, 0.35) for live in range(1, 400)
            if int(np.floor(lam * live)) != int(np.floor(
                np.float32(lam) * np.float32(live)))]
    assert (0.7, 90) in hits                    # 0.7 * 90 = 63.00000000000001
    for lam, live in hits[:20] + [(0.1, 141_043), (0.1, 52_000)]:
        assert power.num_live_power_words(live, lam) == max(
            1, int(jnp.floor(lam * jnp.asarray(live, jnp.int32).astype(
                jnp.float32))))
    with pytest.raises(ValueError, match="guard row"):
        power.select_power_words_live(torch.zeros(8), 1, 8, 0.1)


# ------------------------------------------------------ one mini-batch

@pytest.mark.parametrize("sync,tol,iters", [("power", 0.0, 6),
                                            ("power", 0.3, 30),
                                            ("dense", 0.0, 6),
                                            ("dense", 0.3, 30)])
def test_live_w_minibatch_matches_the_reference(batch, sync, tol, iters):
    jb, tb, acc = batch
    jcfg, cfg = _cfgs(inner_iters=iters, residual_tol=tol)
    key = jax.random.PRNGKey(7)
    total = jnp.sum(jb.counts)
    want = jp.pobp_minibatch(jb, jnp.asarray(acc), key, total,
                             jnp.float32(1.0), jcfg, JLocalReducer(),
                             sync_mode=sync, live_w=jnp.int32(W))
    u0 = np.asarray(jax.random.uniform(key, (D, L, K), minval=0.01,
                                       maxval=1.0))
    got = pobp.pobp_minibatch(tb, t(acc), float(total), 1.0, cfg,
                              sync_mode=sync, live_w=W, u0=t(u0))
    assert got.iters == int(want.iters)
    if tol:
        assert 1 < got.iters < iters
    _close(got.mean_r, want.mean_r, 1e-4, 0, "mean_r")
    _close(got.phi_acc_new[:W], np.asarray(want.phi_acc_new)[:W], 1e-4,
           1e-4, "phi_acc[:live]")
    _close(got.theta, want.theta, 1e-4, 1e-4, "theta")
    assert not got.phi_acc_new[W:].any()                   # guard rows 0
    assert not np.asarray(want.phi_acc_new)[W:].any()


@pytest.mark.parametrize("sync", ["power", "dense"])
def test_live_w_step_on_two_lockstep_shards_matches_the_reference(batch,
                                                                  sync):
    """``make_train_step(cfg, 2)`` with a trailing live_w over two batches
    against the reference's vmap step, each shard's init injected; the
    step refuses a word id at or past live_w."""
    jb, _, _ = batch
    jcfg, cfg = _cfgs(inner_iters=8, residual_tol=1e-6, decay_kappa=0.5)
    jstep, jmeter = jp.make_train_step(jcfg, 2, sync, donate=False)
    step, meter = pobp.make_train_step(cfg, 2, sync, device="cpu")
    jstate = jp.init_train_state(jcfg, 3)
    state = pobp.init_train_state(cfg, 3, device="cpu")
    wid = np.asarray(jb.word_ids).reshape(2, D // 2, L)
    cnt = np.asarray(jb.counts).reshape(2, D // 2, L)
    key = jstate.rng
    for _ in range(2):
        key, sub = jax.random.split(key)
        u0 = np.stack([np.asarray(jax.random.uniform(
            k, (D // 2, L, K), minval=0.01, maxval=1.0))
            for k in jax.random.split(sub, 2)])
        jstate, jdiag = jstep(jstate, wid, cnt, jnp.int32(W))
        state, diag = step(state, t(wid), t(cnt), W, u0=t(u0))
        assert diag["iters"] == int(jdiag["iters"])
        _close(diag["mean_r"], jdiag["mean_r"], 1e-4, 0, "mean_r")
        _close(state.phi_acc[:W], np.asarray(jstate.phi_acc)[:W], 1e-4,
               1e-4, "phi_acc[:live]")
        assert not state.phi_acc[W:].any()
    assert meter.bytes_by_phase_at(W) == jmeter.bytes_by_phase_at(W)
    bad = wid.copy()
    bad[0, 0, 0] = W
    with pytest.raises(ValueError, match="live_w"):
        step(state, t(bad), t(cnt), W)
    with pytest.raises(ValueError, match="guard row"):
        step(state, t(wid), t(cnt), W_CAP)


@pytest.mark.parametrize("sync", ["power", "dense"])
def test_live_w_step_at_the_full_vocabulary_matches_the_fixed_w_step(
        batch, sync):
    """A rung above the vocabulary with live_w == W computes what the
    fixed-W step at W computes (lambda_w chosen so round() and the live
    floor() give one power-word count), the guard rows exactly 0, from one
    generator seed."""
    _, tb, _ = batch
    kw = dict(num_topics=K, lambda_w=0.25, lambda_k_abs=4, inner_iters=6,
              residual_tol=1e-9)
    cfg_fix = LDAConfig(vocab_size=W, **kw)
    cfg_dyn = LDAConfig(vocab_size=next_capacity(W), **kw)
    step_f, _ = pobp.make_train_step(cfg_fix, 1, sync, device="cpu")
    step_d, _ = pobp.make_train_step(cfg_dyn, 1, sync, device="cpu")
    s_f, d_f = step_f(pobp.init_train_state(cfg_fix, 0, device="cpu"),
                      tb.word_ids, tb.counts)
    s_d, d_d = step_d(pobp.init_train_state(cfg_dyn, 0, device="cpu"),
                      tb.word_ids, tb.counts, W)
    assert d_f["iters"] == d_d["iters"]
    _close(d_d["mean_r"], d_f["mean_r"], 1e-5, 0, "mean_r")
    _close(s_d.phi_acc[:W], s_f.phi_acc, 1e-5, 1e-6, "phi_acc")
    assert not s_d.phi_acc[W:].any()


def test_comm_meter_bills_live_w(batch):
    """The reference's ``test_comm_meter_bills_live_w`` on the port: the
    W-proportional payloads scale to the live rows, the token count does
    not, integer for integer with the reference's meter."""
    jb, _, _ = batch
    cap = 512
    kw = dict(vocab_size=cap, num_topics=K, lambda_w=0.25, lambda_k_abs=4,
              inner_iters=6, residual_tol=1e-9)
    jcfg, cfg = JConfig(**kw, sweep_policy="dense_layout"), LDAConfig(**kw)
    wid = np.asarray(jb.word_ids).reshape(2, D // 2, L)
    cnt = np.asarray(jb.counts).reshape(2, D // 2, L)
    step, meter = pobp.make_train_step(cfg, 2, device="cpu")
    _, diag = step(pobp.init_train_state(cfg, 0, device="cpu"), t(wid),
                   t(cnt), W)
    jstep, jmeter = jp.make_train_step(jcfg, 2, donate=False)
    jstep(jp.init_train_state(jcfg, 0), wid, cnt, jnp.int32(W))
    by_cap, by_live = meter.bytes_by_phase, meter.bytes_by_phase_at(W)
    assert by_cap == jmeter.bytes_by_phase
    assert by_live == jmeter.bytes_by_phase_at(W)
    assert by_live["dense"] == by_cap["dense"] * W // cap
    assert by_live["power"] == by_cap["power"] * W // cap
    assert by_live["tokens"] == by_cap["tokens"]
    iters = diag["iters"]
    assert meter.per_minibatch_bytes(iters, live_w=W) == \
        jmeter.per_minibatch_bytes(iters, live_w=W) < \
        meter.per_minibatch_bytes(iters)


# ------------------------------------------------------ the driver, CPU

GROW = dict(dynamic_vocab=True, minibatches=6, docs_per_batch=16, shards=2,
            vocab=48, vocab_growth_per_batch=24, w_cap_min=64, w_growth=2.0,
            topics=8, lambda_k=4, inner_iters=4, tol=1e-9, log_every=0,
            eval_every=0, len_buckets="16,32", doc_len_means="10,20,30",
            seed=3)
SLIDE = dict(dynamic_vocab=True, drift_mode="slide", minibatches=8,
             docs_per_batch=32, shards=2, vocab=96,
             vocab_growth_per_batch=6, topics=16, lambda_k=8, tol=1e-9,
             decay="1,0.3", compact_every=4, compact_min_idle=2,
             compact_mass_tol=60.0, log_every=0, eval_every=0, seed=0)


def _args(flags, **over):
    merged = dict(flags, **over)
    argv = []
    for k, v in merged.items():
        flag = f"--{k.replace('_', '-')}"
        if v is True:
            argv.append(flag)
        elif v is False:
            argv.append(f"--no-{k.replace('_', '-')}")
        elif v is not None:
            argv += [flag, str(v)]
    return cli.build_parser().parse_args(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def grown():
    return cli.train_loop(_args(GROW))


def test_grown_run_equals_a_fresh_run_at_the_final_rung(grown):
    assert len(grown["growth_events"]) >= 2
    assert [e["w_cap"] for e in grown["growth_events"]] == [128, 256]
    fresh = cli.train_loop(_args(GROW, w_cap_min=grown["w_cap"]))
    assert fresh["growth_events"] == []
    assert fresh["w_cap"] == grown["w_cap"]
    assert fresh["live_w"] == grown["live_w"]
    assert fresh["vocab_keys"] == grown["vocab_keys"]
    assert fresh["iters"] == grown["iters"]
    _close(fresh["mean_r"], grown["mean_r"], 1e-6, 1e-9, "mean_r")
    lw = grown["live_w"]
    _close(fresh["phi_acc"][:lw], grown["phi_acc"][:lw], 1e-6, 1e-7,
           "phi_acc[:live_w]")
    assert not grown["phi_acc"][lw:].any() and not fresh["phi_acc"][lw:].any()
    assert len(grown["vocab_keys"]) == lw
    assert grown["per_minibatch_bytes_live"] < grown["per_minibatch_bytes"]


def test_crash_resume_across_a_growth_event_is_exact(tmp_path, grown):
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit):
        cli.train_loop(_args(GROW, ckpt_dir=d, ckpt_every=2, crash_at=6))
    resumed = cli.train_loop(_args(GROW, ckpt_dir=d, ckpt_every=2,
                                   crash_at=6))
    # resumed from the second growth event's checkpoint (m = 4, saved on
    # the new rung): the crash fired before step 6 was saved
    assert resumed["first_m"] == 4 and resumed["growth_events"] == []
    assert resumed["mean_r"] == grown["mean_r"][resumed["first_m"]:]
    assert torch.equal(resumed["phi_acc"], grown["phi_acc"])
    assert resumed["w_cap"] == grown["w_cap"]
    assert resumed["vocab_keys"] == grown["vocab_keys"]


def test_crash_resume_replays_through_a_compaction_fence(tmp_path):
    full = cli.train_loop(_args(SLIDE))
    assert [e["m"] for e in full["compaction_events"]] == [4, 8]
    d = str(tmp_path / "ck")
    kw = dict(ckpt_dir=d, ckpt_every=3, crash_at=7)
    with pytest.raises(SystemExit):
        cli.train_loop(_args(SLIDE, **kw))
    resumed = cli.train_loop(_args(SLIDE, **kw))
    assert resumed["first_m"] == 6                    # then the fence at 8
    assert resumed["mean_r"] == full["mean_r"][6:]
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])
    for key in ("live_w", "w_cap", "vocab_keys", "vocab_version"):
        assert resumed[key] == full[key], key
    extra, step = ckpt.peek_extra(d)
    assert step == 8 and extra["dyn"]["vocab_version"] == 2
    assert extra["dyn"]["row_remap"] is not None


def test_bf16_phi_acc_keeps_its_guard_rows_at_zero():
    res = cli.train_loop(_args(SLIDE, phi_acc_dtype="bfloat16"))
    phi = res["phi_acc"]
    assert phi.dtype == torch.bfloat16
    assert torch.isfinite(phi.float()).all()
    assert not phi[res["live_w"]:].any()
    assert len(res["compaction_events"]) == 2


def test_driver_refuses_lifecycle_flags_as_the_reference_does():
    for extra in (dict(compact_every=2),
                  dict(dynamic_vocab=True, backend="shard_map")):
        with pytest.raises(ValueError) as mine:
            cli.train_loop(_args(dict(minibatches=1), **extra))
        with pytest.raises(ValueError) as theirs:
            jcli.train_loop(jcli.default_args(minibatches=1, **extra))
        assert str(mine.value) == str(theirs.value)
    # every lifecycle flag is the port's own, with the reference's default
    mine = vars(cli.build_parser().parse_args([]))
    theirs = vars(jcli.build_parser().parse_args([]))
    for k in ("dynamic_vocab", "vocab_growth_per_batch", "drift_mode",
              "w_cap_min", "w_growth", "compact_every", "compact_min_idle",
              "compact_mass_tol", "recycle_tol"):
        assert mine[k] == theirs[k], k


# ------------------------------------------------ against the reference

# a mass floor above every idle row: each fence's dead set is a function of
# the touch stamps alone, so the remaps must agree across the packages
CROSS_SLIDE = dict(SLIDE, shards=1, compact_mass_tol=1e9, ckpt_every=2,
                   warmup_buckets=False)
CROSS_GROW = dict(GROW, shards=1, ckpt_every=2, warmup_buckets=False)


def _jargs(flags, **over):
    return jcli.default_args(**dict(flags, **over))


@pytest.fixture(scope="module")
def reference_slide(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref_slide"))
    return jcli.train_loop(_jargs(CROSS_SLIDE, ckpt_dir=d)), d


@pytest.mark.parametrize("mode", ["grow", "slide"])
def test_driver_matches_the_reference_driver_on_the_stream(tmp_path, mode,
                                                           reference_slide):
    if mode == "slide":
        flags = CROSS_SLIDE
        want, jd = reference_slide
    else:
        flags = CROSS_GROW
        jd = str(tmp_path / "ref")
        want = jcli.train_loop(_jargs(flags, ckpt_dir=jd))
    d = str(tmp_path / "port")
    got = cli.train_loop(_args(flags, ckpt_dir=d))
    for key in ("growth_events", "vocab_keys", "w_cap", "live_w",
                "compaction_events", "vocab_version", "occupancy_trace"):
        assert got[key] == want[key], key
    assert got["iters"] == want["iters"]
    mine, step = ckpt.peek_extra(d)
    theirs, jstep = jckpt.peek_extra(jd)
    assert step == jstep
    for key in ("w_cap", "live_w", "vocab_keys", "touched", "vocab_version",
                "row_remap"):
        assert mine["dyn"][key] == theirs["dyn"][key], key
    if mode == "slide":
        assert len(got["compaction_events"]) == 2
        assert mine["dyn"]["row_remap"] is not None
    else:
        assert len(got["growth_events"]) == 2


def test_a_reference_checkpoint_after_a_fence_continues_in_the_port(
        reference_slide):
    """The reference's driver saved a post-fence state (the ``dyn`` extra
    with a remap) at step 8: the port's ``peek_extra`` and ``restore`` read
    it bit for bit, ``VocabMap.from_state`` rebuilds the table, the port's
    driver still refuses its JAX rng, and both packages continue the
    drifting stream two mini-batches, the reference's draws injected:
    iterations equal, mean_r and phi_acc to rel 1e-4, guard rows 0."""
    _, d = reference_slide
    extra, step = ckpt.peek_extra(d)
    jextra, _ = jckpt.peek_extra(d)
    assert step == 8 and extra == jextra
    dyn = extra["dyn"]
    assert dyn["row_remap"] is not None and dyn["vocab_version"] == 2
    w_cap, live = int(dyn["w_cap"]), int(dyn["live_w"])
    tpl = {"state": {"phi_acc": torch.zeros((w_cap, 16)), "m": np.int32(0),
                     "rng": torch.zeros(2, dtype=torch.uint32)}}
    got, _, _ = ckpt.restore(d, 8, tpl)
    jtpl = {"state": {"phi_acc": jnp.zeros((w_cap, 16)), "m": jnp.int32(0),
                      "rng": jax.random.PRNGKey(0)}}
    jtree, _, _ = jckpt.restore(d, 8, jtpl)
    np.testing.assert_array_equal(
        got["state"]["phi_acc"].numpy().view(np.int32),
        np.asarray(jtree["state"]["phi_acc"]).view(np.int32))
    assert not got["state"]["phi_acc"][live:].any()
    vocab = VocabMap.from_state(dyn["vocab_keys"], touched=dyn["touched"])
    jvocab = JVocab.from_state(jextra["dyn"]["vocab_keys"],
                               touched=jextra["dyn"]["touched"])
    assert vocab.to_state() == jvocab.to_state()
    assert vocab.touched_upto(live) == jvocab.touched_upto(live)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        cli.train_loop(_args(CROSS_SLIDE, ckpt_dir=d, minibatches=10))

    flags = dict(CROSS_SLIDE, minibatches=10)
    args, jargs = _args(flags), _jargs(flags)
    cfg, buckets = cli._build_cfg(args, vocab_size=w_cap)
    jcfg = dataclasses.replace(jcli._build_cfg(jargs, vocab_size=w_cap)[0],
                               sweep_policy="dense_layout")
    step_fn, _ = pobp.make_train_step(cfg, device="cpu")
    jstep, _ = jp.make_train_step(jcfg, 1, donate=False)
    from repro_torch import convert
    state = convert.train_state_from_reference(
        got["state"]["phi_acc"].numpy(), int(got["state"]["m"]), seed=0,
        device="cpu")
    jstate = JState(**jtree["state"])
    theirs = list(jcli.drifting_stream(jargs, buckets, 8, stacked=False,
                                       vocab=jvocab)())
    mine = list(cli.drifting_stream(args, buckets, 8, vocab)())
    assert len(mine) == len(theirs) == 2
    for (mb, ntok, lb), (jmb, jn, jlb) in zip(mine, theirs):
        assert lb == jlb < w_cap and ntok == jn
        np.testing.assert_array_equal(mb.word_ids.numpy(), jmb.word_ids)
        _, sub = jax.random.split(jstate.rng)
        Dm, Lm = mb.word_ids.shape
        u0 = jax.random.uniform(sub, (Dm, max(cfg.init_pad_len, Lm), 16),
                                minval=0.01, maxval=1.0)
        jstate, jdiag = jstep(jstate, jmb.word_ids, jmb.counts,
                              jnp.int32(jlb))
        state, diag = step_fn(state, mb.word_ids, mb.counts, lb, u0=t(u0))
        assert diag["iters"] == int(jdiag["iters"])
        assert float(diag["mean_r"]) == pytest.approx(
            float(jdiag["mean_r"]), rel=1e-4)
        live = lb
    assert state.m == int(jstate.m) == 10
    _close(state.phi_acc[:live], np.asarray(jstate.phi_acc)[:live], 1e-4,
           1e-4, "phi_acc[:live]")
    assert not state.phi_acc[live:].any()

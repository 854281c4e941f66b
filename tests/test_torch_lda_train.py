"""The port's training driver (``repro_torch.launch.lda_train``) against the
reference's: crash-resume reproduces the uninterrupted run bit for bit
(the counterpart of ``tests/test_stream_driver.py``'s crash-resume test),
mismatched flags and JAX-written checkpoints are refused, the warm-up
leaves the result as it was, and ``--impl`` agrees with ``--device``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro.launch import lda_train as jcli
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch import lda_train as cli

W, K = 120, 8


def _args(ckpt_dir=None, **over):
    """The reference test's driver settings, on the CPU."""
    base = dict(minibatches=8, docs_per_batch=16, vocab=W, topics=K,
                lambda_k=4, inner_iters=4, tol=1e-9, log_every=0,
                doc_len_means="10,20,30", len_buckets="16,32",
                ckpt_every=3, seed=3, shards=1, device="cpu")
    base.update(over)
    if ckpt_dir is not None:
        base["ckpt_dir"] = str(ckpt_dir)
    argv = []
    for k, v in base.items():
        flag = k.replace("_", "-")
        if isinstance(v, bool):
            argv.append(f"--{flag}" if v else f"--no-{flag}")
        else:
            argv += [f"--{flag}", str(v)]
    return cli.build_parser().parse_args(argv)


@pytest.mark.parametrize("extra", [
    {}, {"sweep_policy": "packed"}, {"phi_acc_dtype": "bfloat16"},
    {"sync": "dense", "decay": "1,0.5"}])
def test_crash_resume_reproduces_trajectory(tmp_path, extra):
    """``--crash-at 5`` and the same command again: the rerun resumes at
    the m = 3 checkpoint and ends where the uninterrupted run ends, mean_r,
    iterations and phi_acc bit for bit (phi_acc, m, the generator's state
    and the stream cursor round-trip through the checkpoint)."""
    full = cli.train_loop(_args(**extra))
    ckdir = tmp_path / "ck"
    with pytest.raises(SystemExit, match="simulated crash"):
        cli.train_loop(_args(ckdir, crash_at=5, **extra))
    resumed = cli.train_loop(_args(ckdir, crash_at=5, **extra))
    assert resumed["first_m"] == 3
    assert resumed["mean_r"] == full["mean_r"][3:]
    assert resumed["iters"] == full["iters"][3:]
    assert resumed["phi_acc"].dtype == full["phi_acc"].dtype
    assert torch.equal(resumed["phi_acc"], full["phi_acc"])


def test_resume_prints_the_reference_restore_lines(tmp_path, capsys):
    ckdir = tmp_path / "ck"
    cli.train_loop(_args(ckdir, minibatches=3))
    cli.train_loop(_args(ckdir, minibatches=3))
    out = capsys.readouterr().out
    assert "[restore] resumed from checkpoint step 3 -> next minibatch 4" \
        in out
    assert "[restore] checkpoint already covers all 3 minibatches" in out


@pytest.mark.parametrize("flag,value", [("seed", 99), ("sync", "dense"),
                                        ("tol", 0.5),
                                        ("sync_dtype", "bfloat16")])
def test_resume_rejects_mismatched_flags(tmp_path, flag, value):
    """A checkpoint written under one set of trajectory-shaping flags is
    not spliced into a run with others (the reference's resume keys)."""
    ckdir = tmp_path / "ck"
    cli.train_loop(_args(ckdir, minibatches=3))
    with pytest.raises(ValueError, match=flag):
        cli.train_loop(_args(ckdir, minibatches=6, **{flag: value}))


def test_resume_keys_are_the_references():
    assert cli._RESUME_KEYS == jcli._RESUME_KEYS
    sig = cli._run_signature(_args())
    assert sig["impl"] == "jnp" and set(sig) == set(jcli._RESUME_KEYS)


def test_resume_may_switch_the_sweep_policy(tmp_path):
    """sweep_policy is not a resume key: both formulations compute one
    trajectory, so a run may resume under the other."""
    ckdir = tmp_path / "ck"
    cli.train_loop(_args(ckdir, minibatches=3))
    res = cli.train_loop(_args(ckdir, minibatches=5,
                               sweep_policy="packed"))
    assert res["first_m"] == 3 and len(res["mean_r"]) == 2


def test_driver_refuses_a_jax_written_checkpoint(tmp_path):
    """The reference's driver writes a JAX PRNG key in state/rng; the
    port cannot resume a torch generator from it and says so, never
    reseeding silently."""
    ckdir = tmp_path / "ck"
    jcli.train_loop(jcli.default_args(
        minibatches=2, docs_per_batch=16, vocab=W, topics=K, lambda_k=4,
        inner_iters=4, log_every=0, ckpt_dir=str(ckdir), ckpt_every=2,
        warmup_buckets=False))
    assert jckpt.latest_step(str(ckdir)) == 2
    with pytest.raises(ValueError, match="written by the JAX package"):
        cli.train_loop(_args(ckdir, minibatches=4))
    # an unrelated tree is the reference's "older/other tool" case
    other = tmp_path / "other"
    ckpt.save(str(other), 1, {"state": {"x": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="older/other tool"):
        cli.train_loop(_args(other, minibatches=2))


def test_warmup_leaves_the_result_as_it_was():
    """The warm-up runs on a throwaway state with its own generator: the
    run's draws, and so its trajectory and phi_acc, are those of a run
    without it."""
    warm = cli.train_loop(_args(minibatches=3))
    cold = cli.train_loop(_args(minibatches=3, warmup_buckets=False))
    assert warm["mean_r"] == cold["mean_r"]
    assert torch.equal(warm["phi_acc"], cold["phi_acc"])
    assert warm["warmup_s"] > 0.0 and cold["warmup_s"] == 0.0
    # on the CPU no kernel launches, in the warm-up or anywhere
    assert set(warm["warmup_launches"].values()) == {0}


def test_warmup_batches_reach_the_selective_sweep():
    """The warm-up's last batch has every slot counted, so with
    ``inner_iters`` 2 the step runs one selective iteration: every kernel
    of the policy sees its first launch before the clock starts."""
    from repro_torch.core import pobp

    args = _args()
    cfg, buckets = cli._build_cfg(args)
    pads, (ids, cnt) = cli._warmup_batches(args, buckets, cfg)
    assert [p[0].shape[1] for p in pads] == list(buckets)
    assert all(float(c.sum()) == 0.0 for _, c in pads)
    assert bool((cnt > 0).all()) and int(ids.max()) < W
    import dataclasses
    once, _ = pobp.make_train_step(
        dataclasses.replace(cfg, inner_iters=2, residual_tol=-1.0),
        device="cpu")
    _, diag = once(pobp.init_train_state(cfg, 0, device="cpu"), ids, cnt)
    assert diag["iters"] == 2


@pytest.mark.parametrize("impl,device,ok", [
    (None, "cpu", "jnp"), ("jnp", "cpu", "jnp"), ("pallas", "cpu", None),
    (None, "cuda", "pallas"), ("pallas", "cuda", "pallas"),
    ("jnp", "cuda", None)])
def test_impl_agrees_with_device(impl, device, ok):
    """``--impl pallas`` names the CUDA kernels and needs a CUDA device,
    ``jnp`` the plain versions and the CPU; a contradiction raises naming
    ``--device``, and no flag runs a plain version on the card."""
    extra = {} if impl is None else {"impl": impl}
    args = _args(device=device, **extra)
    if ok is None:
        with pytest.raises(ValueError, match="--device"):
            cli.resolve_impl(args)
    else:
        assert cli.resolve_impl(args) == ok


def test_crash_at_needs_a_checkpoint_dir_and_warns_before_the_first(
        tmp_path, capsys):
    with pytest.raises(ValueError, match="--crash-at needs --ckpt-dir"):
        cli.train_loop(_args(crash_at=2))
    with pytest.raises(SystemExit):
        cli.train_loop(_args(tmp_path / "ck", crash_at=2))
    assert "fires before the first checkpoint" in capsys.readouterr().out


def test_restore_fence_casts_phi_acc_both_ways(tmp_path):
    """phi_acc_dtype is not a resume key: a bf16 run resumes in float32
    and back, the restore casting at the fence (the reference's
    ``cast_dtypes``)."""
    ckdir = tmp_path / "ck"
    a = cli.train_loop(_args(ckdir, minibatches=3,
                             phi_acc_dtype="bfloat16"))
    assert a["phi_acc"].dtype == torch.bfloat16
    b = cli.train_loop(_args(ckdir, minibatches=6))
    assert b["first_m"] == 3 and b["phi_acc"].dtype == torch.float32
    c = cli.train_loop(_args(ckdir, minibatches=9,
                             phi_acc_dtype="bfloat16"))
    assert c["first_m"] == 6 and c["phi_acc"].dtype == torch.bfloat16
    saved, _, step = ckpt.restore_phi(str(ckdir))
    assert step == 9 and saved.dtype == torch.bfloat16


def test_cli_main_resumes_after_a_crash(tmp_path, capsys):
    argv = ["--minibatches", "4", "--docs-per-batch", "16", "--vocab",
            str(W), "--topics", str(K), "--lambda-k", "4", "--device", "cpu",
            "--shards", "1", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2",
            "--crash-at", "3"]
    with pytest.raises(SystemExit):
        cli.main(argv)
    res = cli.main(argv)
    out = capsys.readouterr().out
    assert res["first_m"] == 2 and "[done] 2 minibatches" in out


def test_cdf_draws_are_numpys_weighted_choice():
    """The driver's stream draws words through `topic_cdf` (a binary
    search a word instead of numpy's O(W) pass a call): the documents are
    those of ``Generator.choice``, and the reference's, bit for bit."""
    from repro.data.synthetic import lda_corpus_from_phi as jdraw
    from repro_torch.data.synthetic import lda_corpus_from_phi, topic_cdf

    phi = np.random.default_rng(1).dirichlet(np.full(W, 0.06),
                                             size=K).astype(np.float32)
    for seed in range(3):
        fast, _ = lda_corpus_from_phi(seed, 12, phi, doc_len_mean=30,
                                      cdf=topic_cdf(phi))
        slow, _ = lda_corpus_from_phi(seed, 12, phi, doc_len_mean=30)
        ref, _ = jdraw(seed, 12, phi, doc_len_mean=30)
        for (a, ca), (b, cb), (c, cc) in zip(fast, slow, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(ca, cc)


@pytest.mark.parametrize("shards", [2, 4])
def test_cli_runs_the_sharded_simulation(shards, capsys):
    """``--shards N`` (the default ``--backend sim``; ported since ROADMAP
    Queue 1, item 5) runs N data shards in lockstep: every token lands in
    phi_acc once, and the [comm] line bills the data psums."""
    res = cli.main(["--minibatches", "2", "--docs-per-batch", "16",
                    "--vocab", "200", "--topics", "8", "--inner-iters", "4",
                    "--log-every", "1", "--shards", str(shards),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[done] 2 minibatches" in out and "'power'" in out
    assert float(res["phi_acc"].sum()) == pytest.approx(res["tokens"],
                                                        rel=1e-5)
    assert res["bytes_by_phase"]["dense"] == 2 * 200 * 8 * 4
    with pytest.raises(ValueError, match="does not divide over --shards 3"):
        cli.main(["--minibatches", "1", "--docs-per-batch", "16",
                  "--shards", "3", "--device", "cpu"])


@pytest.mark.parametrize("sync", ["power", "dense"])
def test_sharded_cli_bills_what_the_reference_cli_bills(sync):
    """The two drivers with ``--shards 4`` on the same flags: the same
    ``bytes_by_phase`` (the payload shapes do not depend on the draws)."""
    from repro.launch import lda_train as jcli

    flags = dict(minibatches=2, docs_per_batch=16, vocab=200, topics=8,
                 lambda_k=4, inner_iters=4, sync=sync, decay="1,0.5",
                 log_every=0, warmup_buckets=False)
    theirs = jcli.train_loop(jcli.default_args(**flags, shards=4))
    mine = cli.train_loop(_args(**flags, shards=4))
    assert mine["bytes_by_phase"] == theirs["bytes_by_phase"]
    assert set(mine["bytes_by_phase"]) >= {"tokens", "dense", "decay"}

"""Compressed phi accumulators in the port (``repro_torch.core.quantize``),
held against the reference's ``tests/test_phi_acc_dtype.py``: stochastic
rounding exact on representable values, unbiased, the reference's bits
given one dither; bf16 storage; bf16 runs that leave float32 runs as they
were; sync payloads at bf16; checkpoints cast both ways; serving float32
from a bf16 checkpoint; and the bf16-vs-float32 mean_r gap budgeted
against the reference's own gap at the same settings."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jquant
from repro.dist import checkpoint as jckpt
from repro.launch import lda_train as jcli
from repro_torch.core import pobp, quantize
from repro_torch.core.sync import LocalReducer
from repro_torch.core.types import LDAConfig
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch import lda_train as cli


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------ stochastic rounding

def test_stochastic_round_exact_on_representables():
    x = torch.tensor([0.0, 1.0, -1.0, 0.5, 2.0, -3.0, 1.5])
    out = quantize.stochastic_round(x, torch.bfloat16, _gen(0))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), x)


def test_stochastic_round_unbiased():
    """E[sr(x)] == x: each draw lands on one of x's two bf16 neighbours,
    and the mean over many draws lands near x (tolerance as the
    reference's)."""
    x = torch.full((256,), 1.0 + 2.0 ** -12)
    lo, hi = 1.0, 1.0078125
    acc = torch.zeros(256, dtype=torch.float64)
    n = 200
    for i in range(n):
        out = quantize.stochastic_round(x, torch.bfloat16, _gen(i)).float()
        assert bool(((out == lo) | (out == hi)).all())
        acc += out.double()
    assert float((acc / n).mean()) == pytest.approx(float(x[0]), abs=2e-4)


def test_stochastic_round_f32_passthrough_and_validation():
    x = torch.tensor([1.234567])
    out = quantize.stochastic_round(x, torch.float32, _gen(0))
    assert torch.equal(out, x)
    with pytest.raises(ValueError):
        quantize.stochastic_round(x, torch.float16, _gen(0))


def test_phi_acc_dtype_resolver():
    assert quantize.phi_acc_dtype(LDAConfig(10, 4)) == torch.float32
    cfg = LDAConfig(10, 4, phi_acc_dtype="bfloat16")
    assert quantize.phi_acc_dtype(cfg) == torch.bfloat16
    with pytest.raises(ValueError):
        quantize.phi_acc_dtype(LDAConfig(10, 4, phi_acc_dtype="float16"))


def test_rounding_bits_equal_the_reference_formula_given_one_dither():
    """The reference's own stochastic_round and the port's formula fed the
    reference's dither (its ``randint`` under the same key) give the same
    bf16 bits, over ordinary, tiny, huge, negative and non-finite values
    (the uint32 sum wraps past the sign bit as the reference's does)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(500).astype(np.float32) * 1e3,
        rng.random(200).astype(np.float32) * 1e-38,
        np.array([0.0, -0.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan,
                  np.float32(np.finfo(np.float32).max)], np.float32),
        np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7F7FFFFF, 0x0000FFFF],
                 np.uint32).view(np.float32)])
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jquant.stochastic_round(jnp.asarray(x),
                                                  jnp.bfloat16, key))
        dither = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16,
                                               dtype=jnp.int32))
        got = quantize.round_with_dither(torch.from_numpy(x.copy()),
                                         torch.from_numpy(dither.copy()))
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


def test_rounding_passes_cover_every_element_once_in_order():
    """stochastic_round in passes of a few elements (odd, so passes end
    mid-row) gives the formula's bits under the dither those passes draw,
    one pass after the other from the generator; round_with_dither leaves
    its inputs as they were."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 9)).astype(np.float32) * 100)
    x0 = x.clone()
    with mock.patch.object(quantize, "_CHUNK", 7):
        got = quantize.stochastic_round(x, torch.bfloat16, _gen(3))
    g = _gen(3)
    dither = torch.cat([torch.randint(0, 1 << 16, (min(7, 45 - lo),),
                                      generator=g, dtype=torch.int32)
                        for lo in range(0, 45, 7)]).reshape(5, 9)
    d0 = dither.clone()
    want = quantize.round_with_dither(x, dither)
    assert got.shape == (5, 9) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(x, x0) and torch.equal(dither, d0)


# ------------------------------------------------------ the training step

def _cfg(**kw):
    base = dict(vocab_size=200, num_topics=8, lambda_k_abs=4, inner_iters=6,
                residual_tol=0.05)
    base.update(kw)
    return LDAConfig(**base)


def _mb(seed=0, D=16, L=24, W=200):
    from repro_torch.data.batching import docs_to_padded
    from repro_torch.data.synthetic import lda_corpus

    docs, _, _ = lda_corpus(seed, D, W, 8, doc_len_mean=20)
    return docs_to_padded(docs, max_len=L)


def test_bf16_storage_and_float32_accumulate():
    """init_train_state allocates bf16; the step accumulates in float32
    and folds back to bf16 by stochastic rounding, holding every token
    consumed to bf16's rounding."""
    cfg = _cfg(phi_acc_dtype="bfloat16")
    state = pobp.init_train_state(cfg, 1, device="cpu")
    assert state.phi_acc.dtype == torch.bfloat16
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _mb()
    for _ in range(2):
        state, diag = step(state, mb.word_ids, mb.counts)
    assert state.phi_acc.dtype == torch.bfloat16 and state.m == 2
    assert bool(torch.isfinite(state.phi_acc.float()).all())
    assert float(state.phi_acc.float().sum()) == pytest.approx(
        2 * float(mb.counts.sum()), rel=1e-2)


def test_rounding_draws_leave_the_run_stream_alone():
    """The dither's generator derives from the run's seed and the batch
    number: a bf16 step consumes exactly the run generator's draws a
    float32 step consumes, and batch m's dither is a function of (seed,
    m) alone."""
    mb = _mb(1)
    after = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(phi_acc_dtype=dtype)
        step, _ = pobp.make_train_step(cfg, device="cpu")
        state, _ = step(pobp.init_train_state(cfg, 5, device="cpu"),
                        mb.word_ids, mb.counts)
        after[dtype] = state.generator.get_state()
    assert torch.equal(after["float32"], after["bfloat16"])
    g = pobp.init_train_state(_cfg(), 5, device="cpu").generator
    torch.rand(10, generator=g)                  # the run's stream moves on
    draw = [torch.randint(0, 9, (50,), generator=pobp._sr_generator(x, m))
            for x, m in ((g, 3), (_gen(5), 3), (g, 4))]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0],
                                                             draw[2])


def _run(dtype, minibatches=6, **kw):
    base = ["--minibatches", str(minibatches), "--docs-per-batch", "16",
            "--vocab", "80", "--topics", "8", "--log-every", "0",
            "--no-warmup-buckets", "--phi-acc-dtype", dtype,
            "--device", "cpu"]
    for k, v in kw.items():
        base += [f"--{k.replace('_', '-')}", str(v)]
    return cli.train_loop(cli.build_parser().parse_args(base))


def test_bf16_run_does_not_perturb_f32_runs():
    a = _run("float32", minibatches=3)
    _run("bfloat16", minibatches=3)
    b = _run("float32", minibatches=3)
    assert torch.equal(a["phi_acc"], b["phi_acc"])
    assert a["mean_r"] == b["mean_r"]


def test_dense_and_power_payloads_ship_at_half_width():
    """Every phi and residual statistic sync ships at bf16 when phi_acc is
    stored bf16 (the reference's ``phi_wire``): the dense and power
    payloads' bytes halve; the residual word sums (compress=False) stay
    float32.  One shard meters nothing, so the test records the payloads
    the reducer casts."""
    seen = {}
    real = LocalReducer.psum
    current = []

    def record(self, x, phase, compress=True, dtype=None):
        wire = dtype if dtype is not None else self.sync_dtype
        size = torch.empty((), dtype=wire if compress else x.dtype
                           ).element_size()
        seen.setdefault(current[0], {})[phase] = x.numel() * size
        return real(self, x, phase, compress, dtype)

    mb = _mb(2)
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(phi_acc_dtype=dtype, residual_tol=0.0)
        step, _ = pobp.make_train_step(cfg, device="cpu")
        state = pobp.init_train_state(cfg, 0, device="cpu")
        current[:] = [dtype]
        with mock.patch.object(LocalReducer, "psum", record):
            step(state, mb.word_ids, mb.counts)
    for phase in ("dense", "power"):
        assert seen["bfloat16"][phase] * 2 == seen["float32"][phase]
    assert seen["bfloat16"]["model_rw_loop"] == \
        seen["float32"]["model_rw_loop"]


def test_sync_dtype_is_the_references_positional_parameter():
    """make_train_step(cfg, 1, "power", torch.bfloat16): the reference's
    order; the compressed syncs then take the bf16 round trip, which moves
    the result off the float32 one."""
    mb = _mb(3)
    cfg = _cfg()
    out = {}
    for wire in (torch.float32, torch.bfloat16):
        step, _ = pobp.make_train_step(cfg, 1, "power", wire, device="cpu")
        state = pobp.init_train_state(cfg, 0, device="cpu")
        out[wire], _ = step(state, mb.word_ids, mb.counts)
    assert not torch.equal(out[torch.float32].phi_acc,
                           out[torch.bfloat16].phi_acc)
    with pytest.raises(NotImplementedError, match="item 5"):
        pobp.make_train_step(cfg, 1, "power", torch.float32,
                             reducer=LocalReducer(), device="cpu")


# ------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip_both_directions(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt.save(d1, 1, {"state": {"phi_acc": torch.full((40, 8), 1.5,
                                                      dtype=torch.bfloat16)}})
    tpl32 = {"state": {"phi_acc": torch.zeros((40, 8))}}
    trees, _, _ = ckpt.restore(d1, 1, tpl32, cast_dtypes=("phi_acc",))
    assert trees["state"]["phi_acc"].dtype == torch.float32
    assert bool((trees["state"]["phi_acc"] == 1.5).all())
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.restore(d1, 1, tpl32)
    ckpt.save(d2, 1, {"state": {"phi_acc": torch.full((40, 8), 0.25)}})
    tpl16 = {"state": {"phi_acc": torch.zeros((40, 8), dtype=torch.bfloat16)}}
    trees, _, _ = ckpt.restore(d2, 1, tpl16, cast_dtypes=("phi_acc",))
    assert trees["state"]["phi_acc"].dtype == torch.bfloat16
    arr, _, _ = ckpt.restore_phi(d2)
    assert arr.dtype == torch.float32
    arr, _, _ = ckpt.restore_phi(d2, dtype=torch.bfloat16)
    assert arr.dtype == torch.bfloat16
    # the reference reads the port's bf16 checkpoint with the same cast
    jtree, _, _ = jckpt.restore(
        d1, 1, {"state": {"phi_acc": jnp.zeros((40, 8), jnp.float32)}},
        cast_dtypes=("phi_acc",))
    np.testing.assert_array_equal(np.asarray(jtree["state"]["phi_acc"]), 1.5)


def test_driver_switches_dtype_at_restore_fence(tmp_path):
    ck = str(tmp_path / "ck")
    _run("bfloat16", minibatches=4, ckpt_dir=ck, ckpt_every=2)
    res = _run("float32", minibatches=6, ckpt_dir=ck, ckpt_every=2)
    assert res["first_m"] == 4 and res["phi_acc"].dtype == torch.float32


def test_engine_serves_f32_from_bf16_checkpoint(tmp_path):
    from repro_torch.serve import FoldInEngine, SlabEngine

    ck = str(tmp_path / "ck")
    _run("bfloat16", minibatches=2, ckpt_dir=ck, ckpt_every=2)
    saved, _, _ = ckpt.restore_phi(ck)
    assert saved.dtype == torch.bfloat16
    doc = (np.asarray([1, 2, 3], np.int32), np.asarray([1.0, 2.0, 1.0],
                                                        np.float32))
    for eng in (FoldInEngine.from_checkpoint(ck, device="cpu"),
                SlabEngine.from_checkpoint(ck, slots=4, slot_len=8,
                                           device="cpu")):
        assert eng._phi.dtype == torch.float32
        eng.submit(doc)
        res = eng.drain()
        assert len(res) == 1
        theta = np.asarray(res[0].theta)
        assert np.isfinite(theta).all()
        np.testing.assert_allclose(theta.sum(), 1.0, atol=1e-5)


# --------------------------------------------------- the bf16 - f32 gap

def test_bf16_gap_within_the_references_own_gap():
    """At the reference test's settings (one shard: the port's), the port's
    per-batch |mean_r(bf16) - mean_r(f32)| and held-out perplexity gap are
    budgeted against the reference's own at the same settings, not against
    0.01, which the reference misses itself (|d| = 0.0106 at two shards):
    the largest port gap within 3x the reference's largest (the two draw
    different inits and dithers) and within 0.02, the perplexity gap
    within 2% relative."""
    common = dict(minibatches=6, docs_per_batch=16, vocab=80, topics=8,
                  log_every=0, warmup_buckets=False)
    ref = {dt: jcli.train_loop(jcli.default_args(**common, phi_acc_dtype=dt))
           for dt in ("float32", "bfloat16")}
    mine = {dt: _run(dt) for dt in ("float32", "bfloat16")}
    gap_ref = max(abs(a - b) for a, b in zip(ref["float32"]["mean_r"],
                                             ref["bfloat16"]["mean_r"]))
    gap = max(abs(a - b) for a, b in zip(mine["float32"]["mean_r"],
                                         mine["bfloat16"]["mean_r"]))
    assert gap <= 3 * gap_ref and gap <= 0.02, (gap, gap_ref)
    ppl32, ppl16 = mine["float32"]["ppl"], mine["bfloat16"]["ppl"]
    assert abs(ppl32 - ppl16) / ppl32 <= 2e-2

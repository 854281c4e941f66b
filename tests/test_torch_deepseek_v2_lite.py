"""DeepSeek-V2-Lite as the benchmark trains it, at a small size of the same
family on the CPU, in float32, against the plain reference of the
benchmark (``portbench/reference/lm.py``: plain torch, no kernel or model
code of the port, no JAX): the port's ``loss_fn`` and its gradients, YaRN
at the published sizes, the expert share (the parts that the cards of an
expert-parallel group compute add up to the whole layer), the dropless
layer against the capacity layer where nothing drops, the dropless layer
repeating bit for bit, the step's record (``obs``), and every registered
architecture unchanged with the new fields at their defaults.

Tolerances: float32 on both sides, the same routing (no near-ties at these
seeds), sums in other orders (the reference takes a sequence at a time and
adds the experts' rows by ``index_add``): the loss to 1e-5 relative, each
gradient leaf to 1e-4 relative L2, a layer's output to 1e-5 relative L2.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.drivers.lm_train import arch_config, ref_config  # noqa: E402
from portbench.reference import lm as ref  # noqa: E402
from repro_torch import configs, obs  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.attention import mla_rope  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    Draw, rope_freqs, tree_leaves, tree_map, yarn_range)

CONFIG = json.loads(
    (REPO / "portbench/configs/deepseek-v2-lite-ep4.json").read_text())
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=16, experts_held=4, n_layers=3, vocab_size=256)


def small(**kw) -> dict:
    return dict(CONFIG, **{**SMALL, **kw})


def f32_params(cfg, seed=0):
    return tree_map(lambda t: t.float(),
                    lm.init(cfg, seed=seed, device="cpu"))


def batch(seed=0, B=2, S=48, V=256):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, V, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("held", [4, 16])
def test_loss_and_grads_match_the_reference(held):
    c = small(experts_held=held)
    cfg = arch_config(c)
    params = f32_params(cfg, seed=1)
    b = batch(seed=2)
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    loss = lm.loss_fn(params, b, cfg)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want = ref.loss_and_grads(params, b["tokens"], b["labels"],
                                         ref_config(c))
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    for (path, _), g in zip(tree_leaves(params), grads):
        assert rel(g, want[path]) <= 1e-4, path


def test_yarn_at_the_published_sizes():
    cfg = arch_config(CONFIG)
    y = cfg.rope_scaling
    assert yarn_range(64, 10000.0, y) == (10, 23)
    inv, rope_scale, scale = mla_rope(cfg)
    i = torch.arange(32, dtype=torch.float64)
    extra = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    assert torch.allclose(inv.double(), want, rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert rope_scale == 1.0
    assert scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    ref_inv, ref_factor = ref.yarn_inv_freq(CONFIG)
    assert torch.equal(ref_inv, inv) and ref_factor == rope_scale
    assert ref.softmax_scale(CONFIG) == pytest.approx(scale, rel=1e-12)


def _layer(cfg, seed=3):
    """One MoE layer's params over all of cfg's experts, and an input."""
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, experts_held=cfg.moe.num_experts))
    p = tree_map(lambda t: t.float(),
                 moe.moe_params(Draw("cpu", seed), whole))
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1))
    return whole, p, x


def test_the_expert_shares_add_up_to_the_whole_layer():
    cfg = arch_config(small())
    whole, p, x = _layer(cfg)
    held, E = cfg.moe.n_held, cfg.moe.num_experts
    shared = ref.mlp(p["shared"], x, ref.F32)
    parts = []
    for r in range(E // held):
        share = dict(p, **{k: p[k][r * held:(r + 1) * held]
                           for k in ("wi", "wg", "wo")})
        y, _ = moe._moe_apply_dropless(share, x, cfg=cfg, model_index=r)
        parts.append(y)
    total = sum(parts) - (len(parts) - 1) * shared   # shared counted once
    y_whole, _ = moe.moe_apply(p, x, cfg=whole)
    y_ref = ref.moe(p, x, ref_config(small()), ref.F32, 0)[0]
    assert rel(total, y_ref) <= 1e-5
    assert rel(y_whole, y_ref) <= 1e-5


def test_dropless_equals_capacity_where_nothing_drops():
    cfg = arch_config(small())
    whole, p, x = _layer(cfg)
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    # a capacity of S + 1 slots an expert a row: a token takes an expert
    # at most once, so no queue overflows
    roomy = dataclasses.replace(whole, moe=dataclasses.replace(
        whole.moe, dropless=False, capacity_factor=E / k))
    assert moe.capacity(x.shape[1], roomy) > x.shape[1]
    out = {}
    for name, c in (("dropless", whole), ("capacity", roomy)):
        leaves = {n: t.detach().clone().requires_grad_()
                  for n, t in p.items() if n != "shared"}
        q = dict(p, **leaves)
        xi = x.clone().requires_grad_()
        y, aux = moe.moe_apply(q, xi, cfg=c)
        (y.square().sum() + aux).backward()
        out[name] = (y, aux, xi.grad, {n: t.grad for n, t in leaves.items()})
    (y0, a0, gx0, g0), (y1, a1, gx1, g1) = out["dropless"], out["capacity"]
    assert rel(y0, y1) <= 1e-5 and float(a0) == pytest.approx(float(a1),
                                                             rel=1e-6)
    assert rel(gx0, gx1) <= 1e-5
    for n in g0:
        assert rel(g0[n], g1[n]) <= 1e-5, n


def test_the_dropless_layer_repeats_bit_for_bit():
    cfg = arch_config(small())
    _, p, x = _layer(cfg)
    p = dict(p, **{k: p[k][:cfg.moe.n_held] for k in ("wi", "wg", "wo")})
    runs = []
    for _ in range(2):
        leaves = {n: t.detach().clone().requires_grad_()
                  for n, t in p.items() if n != "shared"}
        xi = x.clone().requires_grad_()
        y, aux = moe.moe_apply(dict(p, **leaves), xi, cfg=cfg)
        (y.square().sum() + aux).backward()
        runs.append([y, xi.grad] + [t.grad for t in leaves.values()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_the_step_is_recorded_with_its_counters():
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.powersync import PowerSyncConfig, residual_init

    obs.clear()
    cfg = arch_config(small(experts_held=16))     # every choice held
    step, _, mod = build_trainer(cfg, AdamWConfig(), PowerSyncConfig(), 1,
                                 "power", "cpu")
    params = mod.init(cfg, seed=0, device="cpu")
    b = batch(seed=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, adamw_init(params), residual_init(params), b)
    (rec,) = obs.steps()
    names = [s.name for s in rec.spans]
    assert names[0] == "lm.step"
    n_moe = cfg.n_layers - cfg.dense_first_n
    for n in ("lm.loss", "lm.sync", "lm.adamw"):
        assert names.count(n) == 1
    # the checkpointed MoE layers run their forward again in the backward:
    # their regions twice, the counters once
    assert names.count("lm.mla.attend") == cfg.n_layers + n_moe
    for n in ("lm.moe.route", "lm.moe.experts", "lm.moe.combine"):
        assert names.count(n) == 2 * n_moe
    T = b["tokens"].numel()
    c = rec.counters
    assert c["tokens"] == T and c["dropped"] == 0
    assert c["moe_rows"] == T * cfg.moe.top_k * n_moe
    assert T * cfg.moe.top_k / cfg.moe.num_experts <= c["moe_rows_max"] <= T
    ranges = {e.name for e in prof.events()}
    assert {"lm.mla.attend", "lm.moe.experts"} <= ranges
    obs.clear()


def test_the_counters_see_a_capacity_queue_drop():
    cfg = arch_config(small())
    cap = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False, capacity_factor=0.5))
    _, p, x = _layer(cfg)
    p = dict(p, **{k: p[k][:cfg.moe.n_held] for k in ("wi", "wg", "wo")})
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.step("lm.step"):
            moe.moe_apply(p, x, cfg=cap)
            moe.moe_apply(p, x, cfg=cfg)
    c = obs.steps()[-1].counters
    gates = torch.softmax(x.reshape(-1, x.shape[-1]) @ p["wr"], -1)
    held = int((moe.top_k(gates, cfg.moe.top_k)[1] < cfg.moe.n_held).sum())
    assert c["dropped"] > 0
    assert c["moe_rows"] + c["dropped"] == 2 * held
    obs.clear()


def test_the_dropless_counter_sees_an_expert_output_missing(monkeypatch):
    """A held choice whose expert output comes back all zero is counted
    as dropped: here the first held expert's rows of the third product."""
    cfg = arch_config(small())
    _, p, x = _layer(cfg)
    p = dict(p, **{k: p[k][:cfg.moe.n_held] for k in ("wi", "wg", "wo")})
    real, calls = moe._grouped, [0]

    def grouped(a, w, ends):
        out = real(a, w, ends)
        calls[0] += 1
        if calls[0] % 3 == 0:
            first = torch.arange(out.shape[0]) < ends[0]
            out = torch.where(first[:, None], 0, out)
        return out
    gates = torch.softmax(x.reshape(-1, x.shape[-1]) @ p["wr"], -1)
    first = int((moe.top_k(gates, cfg.moe.top_k)[1] == 0).sum())
    assert first > 0
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.step("lm.step"):
            moe.moe_apply(p, x, cfg=cfg)
        monkeypatch.setattr(moe, "_grouped", grouped)
        with obs.step("lm.step"):
            moe.moe_apply(p, x, cfg=cfg)
    sound, broken = (s.counters for s in obs.steps()[-2:])
    assert sound["dropped"] == 0
    assert broken["dropped"] == first
    assert broken["moe_rows"] == sound["moe_rows"]
    obs.clear()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_registered_archs_keep_the_new_fields_at_their_defaults(arch):
    for cfg in (configs.get_config(arch), configs.get_config(arch).reduced()):
        assert cfg.rope_scaling is None and cfg.norm_eps == 1e-5
        if cfg.moe is not None:
            m = cfg.moe
            assert (m.experts_held, m.norm_topk_prob, m.dropless) == \
                (0, True, False)
            assert m.n_held == m.num_experts
            p = moe.moe_params(Draw("meta"), cfg)
            assert p["wi"].shape[0] == m.num_experts
        if cfg.mla is not None:
            inv, rope_scale, scale = mla_rope(cfg)
            m = cfg.mla
            assert torch.equal(inv, rope_freqs(m.qk_rope, cfg.rope_theta))
            assert rope_scale == 1.0
            assert scale == (m.qk_nope + m.qk_rope) ** -0.5


@pytest.mark.cuda
def test_the_dropless_layer_repeats_bit_for_bit_on_the_card():
    """At the published widths and the cell's 16,384 tokens, in bf16: the
    forward and every gradient of two runs equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    cfg = arch_config(CONFIG)
    p = moe.moe_params(Draw("cuda", 0), cfg)
    x = torch.randn(4, 4096, cfg.d_model, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator("cuda").manual_seed(1))
    runs = []
    for _ in range(2):
        leaves = {n: t.detach().clone().requires_grad_()
                  for n, t in p.items() if n != "shared"}
        xi = x.clone().requires_grad_()
        y, aux = moe.moe_apply(dict(p, **leaves), xi, cfg=cfg)
        (y.float().square().mean() + aux).backward()
        runs.append([y, xi.grad] + [t.grad for t in leaves.values()])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))

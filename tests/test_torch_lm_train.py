"""The LM lab's training half in the port (``loss_fn``, train-mode remat)
against the JAX package's, for all ten architectures at ``reduced()``.

The reference's own params in float32 (perturbed as
``torch_lm_pairs.perturbed`` does, so that every constant leaf takes
part) go through the reference's ``jax.value_and_grad(loss_fn)`` and the
port's ``loss_fn`` and ``torch.autograd.grad``, on one batch made with
numpy: the loss within rtol 1e-4, each grad leaf within a relative L2
error of 1e-3 (float32 on both sides; in float32 both route every MoE
token alike, as ``test_torch_lm.py`` holds).  On the CPU the grads with
activation checkpointing (both policies) equal the grads without it bit
for bit, and ``mode="train"`` returns no caches."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import registry as ref_registry

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.models.common import (softmax_xent, tree_leaves,
                                       tree_unflatten)

from torch_lm_pairs import model_inputs, one_torch_thread, perturbed

B, S = 2, 16


def _batch(cfg, seed):
    inp = model_inputs(cfg, S, seed)
    inp["labels"] = np.roll(inp["tokens"], -1, axis=1)
    return inp


def _port_batch(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def port_loss_and_grads(mod, params, batch, cfg, remat=True):
    """``loss_fn`` (``remat``) or the same loss over ``forward(mode=
    "prefill")`` (no checkpointing) and its grads, in tree order."""
    leaves = [x.detach().requires_grad_() for _, x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if remat:
        loss = mod.loss_fn(p, batch, cfg)
    elif cfg.family == "audio":
        logits, _, _ = mod.forward(p, batch["tokens"], batch["frames"], cfg,
                                   mode="prefill")
        loss = softmax_xent(logits, batch["labels"])
    else:
        logits, _, aux = mod.forward(p, batch["tokens"], cfg,
                                     image_embeds=batch.get("image_embeds"),
                                     mode="prefill")
        loss = softmax_xent(logits, batch["labels"]) + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def ref_params_f32(arch, seed=0):
    cfg = ref_config(arch).reduced()
    if cfg.family == "audio":
        # a float32 block turns the encoder's scan carry float32 (its
        # frames are cast to bf16), which lax.scan refuses: unrolled stacks
        # are the same arithmetic without the carry check
        cfg = dataclasses.replace(cfg, scan_layers=False)
    mod = ref_registry.build(cfg)
    params = perturbed(jax.jit(lambda k: mod.init(k, cfg))(
        jax.random.PRNGKey(seed)), seed + 1)
    return cfg, mod, jax.tree.map(lambda a: a.astype(jnp.float32), params)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_f32_match_reference(arch):
    cfg, mod, params = ref_params_f32(arch)
    inp = _batch(cfg, seed=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: mod.loss_fn(p, inp, cfg)))(params)

    pcfg = get_config(arch).reduced()
    pmod = registry.build(pcfg)
    pparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")
    with one_torch_thread():
        ploss, pgrads = port_loss_and_grads(pmod, pparams, _port_batch(inp),
                                            pcfg)
    assert float(ploss) == pytest.approx(float(loss), rel=1e-4)
    want = jax.tree.leaves(grads)
    paths = [path for path, _ in tree_leaves(pparams)]
    assert len(want) == len(pgrads) == len(paths)
    for path, g, w in zip(paths, pgrads, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        norm = float(np.linalg.norm(w))
        err = float(np.linalg.norm(g.numpy() - w))
        assert err <= 1e-3 * norm, (arch, path, err, norm)


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_grads_equal_plain_grads_bit_for_bit(arch, policy):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    mod = registry.build(cfg)
    params = mod.init(cfg, seed=3, device="cpu")
    batch = _port_batch(_batch(cfg, seed=4))
    batch = {k: v.bfloat16() if v.is_floating_point() else v
             for k, v in batch.items()}
    with one_torch_thread():
        l1, g1 = port_loss_and_grads(mod, params, batch, cfg, remat=True)
        l0, g0 = port_loss_and_grads(mod, params, batch, cfg, remat=False)
    assert torch.equal(l1, l0)
    for (path, _), a, b in zip(tree_leaves(params), g1, g0):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), (arch, policy, path)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_train_mode_returns_no_caches(arch):
    cfg = get_config(arch).reduced()
    mod = registry.build(cfg)
    params = mod.init(cfg, seed=0, device="cpu")
    batch = _port_batch(_batch(cfg, seed=1))
    with torch.no_grad(), one_torch_thread():
        if cfg.family == "audio":
            out = mod.forward(params, batch["tokens"], batch["frames"], cfg,
                              mode="train")
            pre = mod.forward(params, batch["tokens"], batch["frames"], cfg,
                              mode="prefill")
        else:
            kw = dict(image_embeds=batch.get("image_embeds"))
            out = mod.forward(params, batch["tokens"], cfg, mode="train",
                              **kw)
            pre = mod.forward(params, batch["tokens"], cfg, mode="prefill",
                              **kw)
    assert out[1] == {} and pre[1]
    assert torch.equal(out[0], pre[0]) and torch.equal(out[2], pre[2])


class _OpCount(TorchDispatchMode):
    """Counts the aten ops run while open, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_recomputes_all_but_the_projections():
    """The backward pass of ``"dots"`` recomputes no projection (its
    ``mm`` count is the plain backward's) but does recompute attention's
    batched products (``bmm``, as many as ``"full"``, which recomputes
    every op of the layer, projections included)."""
    base = get_config("smollm-360m").reduced()
    mod = registry.build(base)
    params = mod.init(base, seed=0, device="cpu")
    batch = _port_batch(_batch(base, seed=1))

    def backward_ops(policy):
        cfg = dataclasses.replace(base, remat_policy=policy)
        leaves = [x.detach().requires_grad_() for _, x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        if policy is None:
            logits, _, _ = mod.forward(p, batch["tokens"], base,
                                       mode="prefill")
            loss = softmax_xent(logits, batch["labels"])
        else:
            loss = mod.loss_fn(p, batch, cfg)
        with _OpCount() as count:
            torch.autograd.grad(loss, leaves)
        return count.n

    with one_torch_thread():
        plain, dots, full = (backward_ops(None), backward_ops("dots"),
                             backward_ops("full"))
    assert dots["mm"] == plain["mm"] < full["mm"]
    assert plain["bmm"] < dots["bmm"] == full["bmm"]


def test_ssd_grads_stay_finite_where_the_reference_overflows():
    """At the full-width chunk (128) with dt near 5, ``cum[q] - cum[k]``
    above the diagonal passes float32's exp range.  The reference masks
    exp's result, so its backward is 0 x inf = NaN there; the port masks
    the exponent: the forward equal to the reference's (rtol 1e-4, atol
    1e-4), every grad finite."""
    from repro.models import ssm as r_ssm
    from repro.models.common import NULL_CTX

    from repro_torch.models import ssm

    cfg, pcfg = [dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, chunk=128)) for c in (ref_config("mamba2-780m").reduced(),
                                     get_config("mamba2-780m").reduced())]
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      r_ssm.ssm_params(jax.random.PRNGKey(0), cfg))
    rp["dt_bias"] = rp["dt_bias"] + 5.0
    x = np.random.default_rng(1).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)

    def ref_loss(p):
        return r_ssm.ssm_apply(p, jnp.asarray(x), cfg=cfg, ctx=NULL_CTX)[0] \
            .sum()

    y = jax.jit(lambda p: r_ssm.ssm_apply(p, jnp.asarray(x), cfg=cfg,
                                          ctx=NULL_CTX)[0])(rp)
    rgrads = jax.jit(jax.grad(ref_loss))(rp)
    assert any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(rgrads))

    pp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in rp.items()}
    with one_torch_thread():
        yt, _ = ssm.ssm_apply(pp, torch.from_numpy(x), cfg=pcfg)
        grads = torch.autograd.grad(yt.sum(), list(pp.values()))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    for name, g in zip(pp, grads):
        assert bool(torch.isfinite(g).all()), name

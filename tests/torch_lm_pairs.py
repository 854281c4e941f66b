"""Shared by the port's LM parity tests (``test_torch_lm.py``,
``test_torch_lm_bf16.py``): one architecture's prefill and teacher-forced
decode run through the JAX package's ``repro.models`` and the port's
``repro_torch.models`` on the reference's own params, carried across by
``convert.lm_params_from_reference``.

The init leaves that are constant (norm weights, biases, gates, the SSM's
A/D/dt) are perturbed from a numpy seed on both sides, so that each takes
part: at init the VLM's and the enc-dec's cross-attention gates are 0 and
would hide their cross branches from the logits.
"""

import dataclasses

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import registry as ref_registry

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as port_moe
from repro_torch.models import registry
from repro_torch.models.common import tree_map

B, P, N_DEC = 2, 8, 4          # streams, prefill tokens, decode steps
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread inside the block: the LM tests' tensors
    are small, and several test workers share the host's cores, where
    idle intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def perturbed(params, seed: int):
    """The reference's params with each constant leaf (every entry equal)
    moved by seeded noise of scale 0.1, in its dtype."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        flat = a.reshape(-1).astype(np.float32)
        if flat.size and np.all(flat == flat[0]):
            noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
            return jnp.asarray(a.astype(np.float32) + noise).astype(a.dtype)
        return jnp.asarray(a)

    return jax.tree.map(move, params)


def to_numpy32(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        tree)


def grow(tree, target):
    """Zero-pad each leaf of ``tree`` up to ``target``'s shape."""
    def pad(a, t):
        if tuple(a.shape) == tuple(t.shape):
            return a
        return np.pad(a, [(0, w - g) for g, w in zip(a.shape, t.shape)])
    return jax.tree.map(pad, tree, target)


def model_inputs(cfg, S: int, seed: int):
    rng = np.random.default_rng(seed)
    d = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        d["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        d["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return d


def ref_forward(mod, cfg):
    if cfg.family == "audio":
        return jax.jit(lambda p, t, f: mod.forward(p, t, f, cfg,
                                                   mode="prefill"))
    return jax.jit(lambda p, t, ie: mod.forward(p, t, cfg, image_embeds=ie,
                                                mode="prefill"))


def port_forward(mod, params, cfg, inp, n):
    t = torch.from_numpy(inp["tokens"][:, :n])
    if cfg.family == "audio":
        return mod.forward(params, t, torch.from_numpy(inp["frames"]), cfg,
                           mode="prefill")
    ie = inp.get("image_embeds")
    return mod.forward(params, t, cfg, mode="prefill",
                       image_embeds=None if ie is None
                       else torch.from_numpy(ie))


class routing:
    """Records, while open, the experts each MoE layer of either package
    chose for each token (the reference's through a debug callback around
    ``jax.lax.top_k``) and the port's top-k gate margins.  ``flips()``
    returns, per row, whether any choice differs, and the largest port
    margin among the differing choices that no earlier difference can
    explain."""

    def __enter__(self):
        self.ref, self.port, self.gaps = [], [], []
        self._jax_top_k, self._top_k = jax.lax.top_k, port_moe.top_k

        def ref_spy(x, k):
            v, i = self._jax_top_k(x, k)
            jax.debug.callback(lambda c: self.ref.append(np.asarray(c)), i,
                               ordered=True)
            return v, i

        def port_spy(x, k):
            v, i = self._top_k(x, k + 1)
            self.port.append(i[..., :k].numpy())
            self.gaps.append((v[..., k - 1] - v[..., k]).numpy())
            return v[..., :k], i[..., :k]
        jax.lax.top_k, port_moe.top_k = ref_spy, port_spy
        return self

    def __exit__(self, *exc):
        jax.lax.top_k, port_moe.top_k = self._jax_top_k, self._top_k

    def flips(self):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        flipped, worst = np.zeros(B, bool), 0.0
        seen = []                      # (row, token) of each earlier flip
        for r, p, gap in zip(self.ref, self.port, self.gaps):
            diff = np.any(np.sort(r, -1) != np.sort(p, -1), -1)   # [B, S]
            here = list(zip(*np.nonzero(diff)))
            for b, t in here:
                # a flip that no flip of an earlier layer can reach (the
                # same row, at this token or before) must be a near-tie
                if not any(sb == b and st <= t for sb, st in seen):
                    worst = max(worst, float(gap[b, t]))
            seen += here
            flipped |= diff.any(-1)
        self.ref, self.port, self.gaps = [], [], []
        return flipped, worst


def compare(route, mod, pmod, cfg, pcfg, params, pparams, inp, ref_args,
            dtype):
    """The forward over P tokens, then N_DEC decode steps, in both
    packages."""
    logits, caches, _ = ref_forward(mod, cfg)(params, *ref_args)
    plogits, pcaches, _ = port_forward(pmod, pparams, pcfg, inp, P)
    flips = [route.flips()]
    out = {"cfg": cfg, "fwd": (to_numpy32(logits), plogits.float().numpy()),
           "flips": flips,
           "caches": (to_numpy32(caches),
                      tree_map(lambda t: t.float().numpy(), pcaches))}

    # decode N_DEC tokens teacher-forced: each step of both packages starts
    # from the reference's caches (float32 caches in a float32 run, the
    # reference's cache dtypes in a bf16 run), so each step compares one
    # decode_step on the same inputs; the port's caches after the step are
    # kept beside the reference's
    target = ref_registry.cache_zeros(cfg, B, P + N_DEC)
    rc = jax.tree.map(
        lambda a, t: jnp.asarray(a, jnp.float32 if dtype == "f32"
                                 else t.dtype),
        grow(out["caches"][0], target), target)
    decode = jax.jit(lambda p, t, c, pos: mod.decode_step(p, t, c, pos, cfg))
    steps, step_caches = [], []
    for i in range(P, P + N_DEC):
        tok = inp["tokens"][:, i:i + 1]
        pc = jax.tree.map(lambda a: torch.from_numpy(np.array(
            a.astype(jnp.float32))).to(TORCH_DTYPE[a.dtype.name]), rc)
        plg, pc = pmod.decode_step(pparams, torch.from_numpy(tok), pc, i,
                                   pcfg)
        lg, rc = decode(params, tok, rc, jnp.int32(i))
        flips.append(route.flips())
        steps.append((to_numpy32(lg), plg.float().numpy()))
        step_caches.append((to_numpy32(rc),
                            tree_map(lambda t: t.float().numpy(), pc)))
    out["dec"], out["dec_caches"] = steps, step_caches
    return out


def run_pair(arch: str, dtype: str, seed: int = 0):
    """Prefill P tokens, then decode N_DEC more teacher-forced, in both
    packages; returns every logits array (float32 numpy) and the caches."""
    cfg = ref_config(arch).reduced()
    if dtype == "f32" and cfg.family == "audio":
        # the reference's encoder casts frames to bf16 and a float32 block
        # turns its scan carry float32, which lax.scan refuses: unrolled
        # stacks are the same arithmetic without the carry check
        cfg = dataclasses.replace(cfg, scan_layers=False)
    pcfg = get_config(arch).reduced()
    mod, pmod = ref_registry.build(cfg), registry.build(pcfg)
    params = perturbed(jax.jit(lambda k: mod.init(k, cfg))(
        jax.random.PRNGKey(seed)), seed + 1)
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")
    inp = model_inputs(cfg, P + N_DEC, seed + 2)
    # the frames (audio) or patch embeddings (vlm) beside the tokens
    ref_args = (inp["tokens"][:, :P],
                inp.get("frames", inp.get("image_embeds")))

    with routing() as route:
        out = compare(route, mod, pmod, cfg, pcfg, params, pparams, inp,
                      ref_args, dtype)
    return out


def true_vocab(a, cfg):
    return a[..., :cfg.vocab_size]


def held(got, want, tol, what):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)

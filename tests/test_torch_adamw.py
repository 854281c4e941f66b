"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw`` on identical trees: bf16 and f32 leaves,
1-D leaves (no weight decay) beside 2-D and 3-D ones, a list inside the
tree, the gradient clip active and not, through warm-up and past it.

Tolerances: master, m and v within rtol 1e-6, elementwise and of each
leaf's scale (atol 1e-6 x the leaf's largest magnitude): the float32 math
runs in the same order, but XLA may fuse a multiply and an add into one
rounding, and where ``b1 * m + (1 - b1) * g`` or ``p - lr * u`` nearly
cancels, one rounding of a term is a large share of the small result; the
global norm's sums may round apart in the last bit.  The bf16
params equal or within one bf16 ulp (a master that lands within an ulp
of a bf16 rounding boundary may round either way); ``step`` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref

from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw

SHAPES = {"embed": ((40, 8), "bf16"), "ln": ((8,), "bf16"),
          "stack": {"w": ((3, 8, 6), "bf16"), "b": ((3, 6), "f32")},
          "head_blocks": [{"w": ((8, 8), "f32"), "g": ((8,), "f32")}]}


def _tree(rng, scale=1.0):
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v) for v in spec]
        shape, dt = spec
        return (scale * rng.standard_normal(shape).astype(np.float32), dt)
    return make(SHAPES)


def _ref_tree(t):
    if isinstance(t, dict):
        return {k: _ref_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_ref_tree(v) for v in t]
    a, dt = t
    return jnp.asarray(a).astype(jnp.bfloat16 if dt == "bf16"
                                 else jnp.float32)


def _port_tree(t):
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_port_tree(v) for v in t]
    a, dt = t
    x = torch.from_numpy(a)
    return x.bfloat16() if dt == "bf16" else x


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.fixture(scope="module")
def runs():
    """Both optimizers stepped 25 times on the same grads (clip on and
    off), the states kept at steps 1, 5 and 25."""
    out = {}
    for clip in (0.5, 1e9):
        rng = np.random.default_rng(0)
        cfg = dict(lr=1e-2, warmup_steps=20, grad_clip=clip)
        p0 = _tree(rng)
        rparams, pparams = _ref_tree(p0), _port_tree(p0)
        rstate, pstate = ref.adamw_init(rparams), adamw.adamw_init(pparams)
        rcfg, pcfg = ref.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
        update = jax.jit(lambda g, s: ref.adamw_update(g, s, rcfg))
        for step in range(1, 26):
            g = _tree(rng, scale=0.3)
            rparams, rstate = update(_ref_tree(g), rstate)
            pparams, pstate = adamw.adamw_update(_port_tree(g), pstate, pcfg)
            if step in (1, 5, 25):
                out[clip, step] = (rparams, rstate, pparams, pstate)
    return out


@pytest.mark.parametrize("step", [1, 5, 25])
@pytest.mark.parametrize("clip", [0.5, 1e9])
def test_adamw_matches_reference(runs, clip, step):
    rparams, rstate, pparams, pstate = runs[clip, step]
    assert int(pstate.step) == int(rstate.step) == step
    assert pstate.step.dtype == torch.int32 and pstate.step.dim() == 0
    for name in ("master", "m", "v"):
        want = jax.tree.leaves(getattr(rstate, name))
        got = list(tree_leaves(getattr(pstate, name)))
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            assert g.dtype == torch.float32
            w = _np(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name} {path}")
    for (path, g), w in zip(tree_leaves(pparams), jax.tree.leaves(rparams)):
        # every leaf comes back bf16, the f32 ones of the init tree too
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, path
        gap = np.abs(g.float().numpy() - _np(w))
        assert np.all(gap <= _bf16_ulp(_np(w))), path


def test_clip_and_decay_take_part(runs):
    """The clip scales the step-1 update (so the two runs differ), and a
    1-D leaf is not decayed: with a zero grad its master does not move,
    a 2-D leaf's shrinks."""
    a = runs[0.5, 1][3].master["embed"]
    b = runs[1e9, 1][3].master["embed"]
    assert not torch.equal(a, b)
    p = {"w": torch.ones((2, 3)), "b": torch.ones((3,))}
    st = adamw.adamw_init(p)
    zero = {"w": torch.zeros((2, 3)), "b": torch.zeros((3,))}
    _, st = adamw.adamw_update(zero, st, adamw.AdamWConfig(lr=0.1))
    assert torch.equal(st.master["b"], torch.ones(3))
    assert bool((st.master["w"] < 1).all())


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    t = _tree(rng)
    want = float(ref._global_norm(_ref_tree(t)))
    got = float(adamw._global_norm(_port_tree(t)))
    assert got == pytest.approx(want, rel=1e-6)

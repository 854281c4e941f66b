"""The port's LM configs, param converter and decode caches against the JAX
package's: every config field for field (full and ``reduced()``), the
registry's lists and shapes, ``lm_params_from_reference`` (bf16 bits kept,
wrong trees refused), ``cache_zeros``' tree and shapes for all ten ids, and
the sliding-window cache's clamped write past its window (zamba2), decoded
step by step in float32 against the reference (rtol 1e-4)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.configs import base as ref_base
from repro.models import registry as ref_registry

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves

from torch_lm_pairs import one_torch_thread

ARCH_IDS = ref_configs.ARCH_IDS


@pytest.fixture(autouse=True, scope="module")
def _small_tensors():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(arch, reduced):
    want, got = ref_configs.get_config(arch), configs.get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.padded_vocab) == (want.hd, want.padded_vocab)


def test_registry_lists_and_shapes_equal_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    for shapes, ref_shapes in ((base.SHAPES, ref_base.SHAPES),
                               (base.SMOKE_SHAPES, ref_base.SMOKE_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in shapes.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref_shapes.items()}
    for arch in ARCH_IDS:
        for shape in base.SHAPES:
            assert configs.cell_supported(arch, shape) == \
                ref_configs.cell_supported(arch, shape)
    assert registry.MODEL_FAMILIES == ref_registry.MODEL_FAMILIES


@pytest.mark.parametrize("arch", ["smollm-360m", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_input_specs_match_reference(arch):
    cfg = configs.get_config(arch)
    for shape in base.SHAPES.values():
        want = ref_configs.input_specs(ref_configs.get_config(arch),
                                       ref_base.SHAPES[shape.name])
        got = configs.input_specs(cfg, shape)
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name


def _ref_cache_tree(cfg, B, S):
    return [(path, tuple(a.shape), a.dtype.name) for path, a in tree_leaves(
        jax.tree.map(np.asarray, ref_registry.cache_zeros(cfg, B, S)))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_zeros_tree_and_shapes_equal_reference(arch):
    # S = 40 runs past zamba2's reduced window (32): its attention cache
    # holds min(S, window) positions
    for reduced, B, S in ((True, 2, 40), (True, 3, 16), (False, 1, 8)):
        rcfg = ref_configs.get_config(arch)
        pcfg = configs.get_config(arch)
        if reduced:
            rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
        want = _ref_cache_tree(rcfg, B, S)
        # the full configs' caches are laid out on the meta device only
        tree = (registry.cache_zeros(pcfg, B, S, device="cpu") if reduced
                else registry._cache_tree(pcfg, B, S, configs.meta_tensor))
        got = [(path, tuple(t.shape), str(t.dtype).split(".")[-1])
               for path, t in tree_leaves(tree)]
        assert got == want
        if reduced:
            assert all(not t.any() for _, t in tree_leaves(tree))


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    cfg = ref_configs.get_config(arch).reduced()
    return jax.jit(lambda k: ref_registry.build(cfg).init(k, cfg))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed):
    return jax.tree.map(np.asarray,
                        _ref_init(arch)(jax.random.PRNGKey(seed)))


def ref_params(arch, seed=0):
    """The reference's reduced init params, as numpy (a fresh tree over
    arrays drawn once)."""
    return jax.tree.map(lambda a: a, _ref_params(arch, seed))


@pytest.mark.parametrize("arch,dtypes", [
    ("deepseek-v2-lite-16b", {"bfloat16", "float32"}),
    ("zamba2-2.7b", {"bfloat16", "float32"}),
    ("seamless-m4t-medium", {"bfloat16"})])
def test_lm_params_from_reference_keeps_bf16_bits(arch, dtypes):
    ref = ref_params(arch)
    got = convert.lm_params_from_reference(ref, configs.get_config(
        arch).reduced(), device="cpu")
    want_leaves, got_leaves = list(tree_leaves(ref)), list(tree_leaves(got))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    seen = set()
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        seen.add(w.dtype.name)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    assert seen == dtypes


def test_lm_params_from_reference_refuses_wrong_trees():
    pcfg = configs.get_config("olmoe-1b-7b").reduced()
    ref = ref_params("olmoe-1b-7b")

    def edited(fn):
        tree = jax.tree.map(lambda a: a, ref)
        fn(tree)
        return tree

    bad = {
        "missing key": edited(lambda t: t.pop("ln_f")),
        "extra key": edited(lambda t: t.update(extra=np.zeros(3, np.float32))),
        "wrong shape": edited(lambda t: t["stack"]["moe"].update(
            wr=t["stack"]["moe"]["wr"][:, :, :4])),
        "wrong dtype": edited(lambda t: t.update(
            embed=t["embed"].astype(np.float16))),
    }
    for name, tree in bad.items():
        with pytest.raises(ValueError):
            convert.lm_params_from_reference(tree, pcfg, device="cpu")
    # a dense-first model's head blocks are a list: its length is checked
    dref = ref_params("deepseek-v2-lite-16b")
    dref["head_blocks"] = dref["head_blocks"] * 2
    with pytest.raises(ValueError, match="list"):
        convert.lm_params_from_reference(
            dref, configs.get_config("deepseek-v2-lite-16b").reduced(),
            device="cpu")


def test_zamba2_decode_past_window_matches_reference_clamped_write():
    """The reduced zamba2's shared attention caches min(S, 32) positions;
    a decode at pos >= 32 writes at the clamped index 31, as
    ``jax.lax.dynamic_update_slice`` clamps it in the reference.  40 steps
    teacher-forced from zero caches, float32, every step's logits and
    caches held to rtol 1e-4."""
    arch, B, S = "zamba2-2.7b", 2, 40
    cfg = ref_configs.get_config(arch).reduced()
    pcfg = configs.get_config(arch).reduced()
    assert cfg.sliding_window == 32
    mod, pmod = ref_registry.build(cfg), registry.build(pcfg)
    np_params = jax.tree.map(lambda a: a.astype(np.float32),
                             ref_params(arch, seed=4))
    params = jax.tree.map(jnp.asarray, np_params)
    pparams = convert.lm_params_from_reference(np_params, pcfg,
                                               device="cpu")
    rc = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_registry.cache_zeros(cfg, B, S))
    pc = registry.cache_zeros(pcfg, B, S, device="cpu")
    pc = jax.tree.map(lambda t: t.float(), pc)
    assert pc["stack"]["attn_kv"]["k"].shape[2] == 32
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    decode = jax.jit(lambda p, t, c, pos: mod.decode_step(p, t, c, pos, cfg))
    for i in range(S):
        lg, rc = decode(params, tokens[:, i:i + 1], rc, jnp.int32(i))
        plg, pc = pmod.decode_step(pparams, torch.from_numpy(
            tokens[:, i:i + 1]), pc, i, pcfg)
        np.testing.assert_allclose(plg.numpy()[..., :cfg.vocab_size],
                                   np.asarray(lg)[..., :cfg.vocab_size],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for (path, w), (_, g) in zip(tree_leaves(jax.tree.map(np.asarray, rc)),
                                 tree_leaves(pc)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
    # the last write landed on the window's last row
    k = pc["stack"]["attn_kv"]["k"]
    assert k[:, :, -1].abs().sum() > 0

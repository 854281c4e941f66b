"""The port's sharding rule table (``repro_torch.dist.sharding``) held
against the reference's (``repro.dist.sharding``): the param specs of all
ten architectures leaf for leaf on the reference's ``jax.eval_shape(init)``
and the port's ``init(device="meta")``, before and after
``validate_specs`` on the 16 x 16 and 2 x 16 x 16 production meshes (as
objects with ``axis_names`` and a ``shape`` mapping, the reference tests'
``FakeMesh``); the decode caches' and the batches' specs; the serving
spec of phi; the reference's own assertions (``tests/test_sharding.py``);
and `placements` on a fake 2 x 2 ``DeviceMesh`` (a fake process group, in
a process of its own), whose split of a dim over two mesh axes must be
JAX's, the first axis major.  Specs are metadata: every comparison is
exact."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs.base import SHAPES as JSHAPES
from repro.dist import sharding as jsh
from repro.models import registry as jregistry
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import P
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": FakeMesh(), "2x16x16": FakePodMesh()}


def _ref_params(arch):
    cfg = jget_config(arch)
    mod = jregistry.build(cfg)
    return jax.eval_shape(lambda k: mod.init(k, cfg), jax.random.PRNGKey(0))


def _port_params(arch):
    cfg = get_config(arch)
    return registry.build(cfg).init(cfg, seed=0, device="meta")


def _ref_pairs(tree, specs):
    """(path keys, leaf shape, spec) of the reference's trees in flatten
    order."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(jsh._path_keys(p), tuple(leaf.shape), s)
            for (p, leaf), s in zip(leaves, spec_leaves)]


def _port_pairs(tree, specs):
    spec_leaves = [s for _, s in _spec_leaves(specs)]
    return [(sh._path_keys(p), tuple(leaf.shape), s)
            for (p, leaf), s in zip(tree_leaves(tree), spec_leaves)]


def _spec_leaves(specs, path=()):
    if isinstance(specs, P):
        yield path, specs
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_leaves(specs[k], path + (k,))
    else:
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, path + (i,))


def _assert_pairs_equal(got, want, what):
    assert len(got) == len(want), what
    for (gp, gs, gspec), (wp, ws, wspec) in zip(got, want):
        assert gp == wp and gs == ws, (what, gp, wp, gs, ws)
        assert gspec == wspec and len(gspec) == len(wspec), \
            (what, gp, gspec, wspec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references_before_and_after_validation(arch):
    jparams, params = _ref_params(arch), _port_params(arch)
    jspecs, specs = jsh.param_specs(jparams), sh.param_specs(params)
    _assert_pairs_equal(_port_pairs(params, specs),
                        _ref_pairs(jparams, jspecs), (arch, "raw"))
    for name, mesh in MESHES.items():
        _assert_pairs_equal(
            _port_pairs(params, sh.validate_specs(specs, params, mesh)),
            _ref_pairs(jparams, jsh.validate_specs(jspecs, jparams, mesh)),
            (arch, name))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_the_references(arch):
    B, S = 128, 64
    jcache = jregistry.cache_specs(jget_config(arch), B, S)
    cache = registry.cache_specs(get_config(arch), B, S)
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves(cache))
    for name, mesh in MESHES.items():
        jspecs = jsh.validate_specs(jsh.cache_pspecs(jcache, mesh), jcache,
                                    mesh)
        specs = sh.validate_specs(sh.cache_pspecs(cache, mesh), cache, mesh)
        _assert_pairs_equal(_port_pairs(cache, specs),
                            _ref_pairs(jcache, jspecs), (arch, name))
        got = [str(leaf.dtype).split(".")[-1] for _, leaf in
               tree_leaves(cache)]
        want = [str(x.dtype) for x in jax.tree_util.tree_leaves(jcache)]
        assert got == want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["smollm-360m", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_batch_specs_equal_the_references(arch, shape):
    jbatch = jinput_specs(jget_config(arch), JSHAPES[shape],
                          make=jax.ShapeDtypeStruct)
    batch = input_specs(get_config(arch), SHAPES[shape])
    for name, mesh in MESHES.items():
        jspecs = jsh.validate_specs(jsh.batch_specs(jbatch, mesh), jbatch,
                                    mesh)
        specs = sh.validate_specs(sh.batch_specs(batch, mesh), batch, mesh)
        _assert_pairs_equal(_port_pairs(batch, specs),
                            _ref_pairs(jbatch, jspecs), (arch, shape, name))


def test_the_references_assertions():
    """``tests/test_sharding.py``'s checks, on the port's table."""
    specs = sh.param_specs(_port_params("granite-3-2b"))
    assert specs["embed"] == P("model", "data")
    assert specs["stack"]["attn"]["wq"] == P(None, "data", "model")
    assert specs["stack"]["attn"]["wo"] == P(None, "model", "data")
    assert specs["stack"]["mlp"]["wi"] == P(None, "data", "model")
    assert specs["stack"]["ln1"]["w"] == P(None, None)
    specs = sh.param_specs(_port_params("olmoe-1b-7b"))
    assert specs["stack"]["moe"]["wi"] == P(None, "model", "data", None)
    assert specs["stack"]["moe"]["wo"] == P(None, "model", None, "data")
    assert specs["stack"]["moe"]["wr"] == P(None, "data", None)
    st = sh.param_specs(_port_params("deepseek-v2-lite-16b"))["stack"]["attn"]
    assert st["wdkv"] == P(None, "data", None)
    assert st["wuk"] == P(None, None, "model")

    w = {"w": P("data", "model")}
    fixed = sh.validate_specs(w, {"w": torch.empty((17, 32), device="meta")},
                              FakeMesh())
    assert fixed["w"] == P(None, "model")
    assert sh.validate_specs(w, {"w": torch.empty((32, 32), device="meta")},
                             FakeMesh())["w"] == P("data", "model")


def test_every_arch_every_param_divisible_after_validation():
    for mesh in MESHES.values():
        for arch in ARCH_IDS:
            params = _port_params(arch)
            fixed = sh.validate_specs(sh.param_specs(params), params, mesh)
            for (path, leaf), (_, spec) in zip(tree_leaves(params),
                                               _spec_leaves(fixed)):
                for i, ax in enumerate(spec):
                    if ax is not None:
                        assert leaf.shape[i] % sh._axis_size(mesh, ax) == 0, \
                            (arch, path, spec, leaf.shape)


def test_vocab_padding_divisible():
    for arch in ("granite-3-2b", "mamba2-780m", "olmoe-1b-7b",
                 "seamless-m4t-medium"):
        cfg = get_config(arch)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size


def test_phi_serving_spec_as_serving_and_growth_use_it():
    """``tests/test_serve.py:313-329`` and ``tests/test_vocab_growth.py:
    281-291``: topics over ``model`` when the mesh has one, any row count
    (a capacity rung, its +1 guard row), replicated without a model
    axis; equal to the reference's."""

    class OneByOne:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    class DataOnly:
        axis_names = ("data",)
        shape = {"data": 1}

    for rows in (64, 128, 129):
        phi = torch.zeros((rows, 16))
        got = sh.phi_serving_spec(OneByOne(), phi)
        assert got == P(None, "model")
        assert got == jsh.phi_serving_spec(OneByOne(), jnp.zeros((rows, 16)))
    assert sh.phi_serving_spec(DataOnly(), torch.zeros((64, 16))) == \
        P(None, None)
    # K that does not divide the model axis replicates, as the reference
    assert sh.phi_serving_spec(FakeMesh(), torch.zeros((64, 20))) == \
        P(None, None) == jsh.phi_serving_spec(FakeMesh(), jnp.zeros((64, 20)))
    assert sh.phi_serving_spec(FakeMesh(), torch.zeros((64, 32))) == \
        P(None, "model")


def test_spec_for_and_path_keys():
    leaf = torch.empty((4, 8, 16), device="meta")
    assert sh.spec_for(("stack", "moe", "wo"), leaf) == \
        P("model", None, "data")
    assert sh.spec_for(("stack", "mlp", "wo"), leaf) == P(None, "model",
                                                          "data")
    assert sh.spec_for(("unknown",), leaf) == P(None, None, None)
    assert sh.spec_for((), torch.empty(())) == P()
    assert sh._path_keys(("head_blocks", 0, "attn")) == \
        ("head_blocks", "0", "attn")
    assert repr(P("data", None)) == "P('data', None)"


_PLACEMENTS = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import (
    _compute_local_shape_and_global_offset as local_offset)
from repro_torch.dist.sharding import P, placements
from repro_torch.launch.mesh import make_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
out = {}
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
out["wq"] = [str(p) for p in placements(P(None, "data", "model"), mesh)]
out["wo"] = [str(p) for p in placements(P("model", "data"), mesh)]
out["rep"] = [str(p) for p in placements(P(None, None), mesh)]
out["both"] = [str(p) for p in placements(P(("data", "model"), None), mesh)]
# each mesh position's rows of an [8, 4] tensor split over (data, model)
spec = placements(P(("data", "model"), None), mesh)
rows = {}
for d in range(2):
    for m in range(2):
        _, off = local_offset((8, 4), mesh.shape, [d, m], spec)
        rows[f"{d}{m}"] = off[0]
out["offsets"] = rows
for bad in (P(("model", "data"), None), P("data", "data"), P("pod", None)):
    try:
        placements(bad, mesh)
        out[str(bad)] = "placed"
    except ValueError as e:
        out[str(bad)] = "refused"
pod = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
spec = placements(P(("pod", "data"), None, "model"), pod)
out["pod"] = [str(p) for p in spec]
rows = {}
for p_ in range(2):
    for d in range(2):
        _, off = local_offset((8, 4, 2), pod.shape, [p_, d, 0], spec)
        rows[f"{p_}{d}"] = off[0]
out["pod_offsets"] = rows
# ShardingCtx.ct / ct_seq: a DTensor redistributed to the spec, dims left
# out replicated; a plain tensor and an inactive ctx left as they are
from torch.distributed.tensor import distribute_tensor
from repro_torch.models.common import NULL_CTX, ShardingCtx
ctx = ShardingCtx(active=True, batch=("data",), model="model", seq="model",
                  mesh=mesh)
x = distribute_tensor(torch.empty((4, 8, 6), device="meta"), mesh,
                      [Replicate(), Replicate()], src_data_rank=None)
out["ct"] = [str(p) for p in ctx.ct(x, ctx.batch, None, ctx.model).placements]
out["ct_seq"] = [str(p) for p in ctx.ct_seq(x).placements]
y = distribute_tensor(torch.empty((4, 8, 6), device="meta"), mesh,
                      [Shard(0), Shard(2)], src_data_rank=None)
out["ct_drop"] = [str(p) for p in ctx.ct(y, ctx.batch).placements]
t = torch.zeros(3)
out["plain"] = ctx.ct(t, "data") is t and NULL_CTX.ct(x, "data") is x
out["no_seq"] = ShardingCtx(active=True, mesh=mesh).ct_seq(x) is x
print(json.dumps(out))
"""


def test_placements_on_a_fake_two_by_two_mesh():
    """`placements` on a ``DeviceMesh`` of a fake process group (its own
    process: the group is process global): each mesh dim shards the
    tensor dim that names its axis; a dim split over two axes in mesh
    order lands block ``i_data * 2 + i_model`` on position (data, model),
    JAX's order (the first axis major), also over (pod, data) of a
    2 x 2 x 2 mesh; a tuple out of mesh order, an axis named twice and an
    axis the mesh lacks are refused.  ``ShardingCtx.ct`` and ``ct_seq``
    (the reference's ``with_sharding_constraint``) redistribute a DTensor
    to the spec's placements and leave a plain tensor, or any tensor
    under ``NULL_CTX``, as it is."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_PLACEMENTS)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["wq"] == ["S(1)", "S(2)"]
    assert out["wo"] == ["S(1)", "S(0)"]
    assert out["rep"] == ["R", "R"]
    assert out["both"] == ["S(0)", "S(0)"]
    assert out["offsets"] == {"00": 0, "01": 2, "10": 4, "11": 6}
    assert out["P(('model', 'data'), None)"] == "refused"
    assert out["P('data', 'data')"] == "refused"
    assert out["P('pod', None)"] == "refused"
    assert out["pod"] == ["S(0)", "S(0)", "S(2)"]
    assert out["pod_offsets"] == {"00": 0, "01": 2, "10": 4, "11": 6}
    assert out["ct"] == ["S(0)", "S(2)"]
    assert out["ct_seq"] == ["S(0)", "S(1)"]
    assert out["ct_drop"] == ["S(0)", "R"]
    assert out["plain"] and out["no_seq"]

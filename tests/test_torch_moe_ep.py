"""The MoE's expert-parallel island in the port (``models/moe.py``, an
active ``ShardingCtx`` on a ``DeviceMesh``) held against the port's local
path and the reference's ``shard_map`` island (``tests/test_archs.py::
test_moe_manual_ep_matches_local``), on gloo meshes of processes on the
CPU: 1 x 1, a 1 x 2 model axis (each rank half the experts and half the
shared experts' columns) and a 2 x 1 data axis (each rank half the
tokens; aux averaged over the data axis).

Tolerances: in bfloat16 rtol = atol = 2e-2 and aux rtol 1e-4 (the
reference test's); in float32 rtol 1e-5 (atol 1e-6) against the port's
local path and rtol 1e-4 (atol 1e-5) against the reference; the ranks of
a mesh return equal outputs bit for bit.  The reference and the port take
the same params and inputs (the reference's draws).  Each mesh is one
spawn of a process a rank (a few seconds)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.common import NULL_CTX as JNULL
from repro.models.common import ShardingCtx as JCtx
from repro_torch.configs import get_config
from repro_torch.models import lm, moe
from repro_torch.models.common import NULL_CTX, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_moe_ranks  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _case(arch: str, dt: str, B: int = 2):
    """The reference's params and input (as in test_archs) in ``dt``, and
    the same values as torch tensors."""
    jdt, tdt = DTYPES[dt]
    cfg = jget_config(arch).reduced()
    p = jmoe.moe_params(jax.random.PRNGKey(0), cfg)
    if dt == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, 16, cfg.d_model),
                          jnp.float32).astype(jdt)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.float32 if a.dtype == jnp.float32 else tdt)

    return cfg, p, x, {"arch": arch, "p": jax.tree.map(t, p), "x": t(x)}


def _ref_island(cfg, p, x):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = JCtx(active=True, batch=("data",), model="model", mesh=mesh)
    with mesh:
        return jax.jit(lambda p_, x_: jmoe.moe_apply(p_, x_, cfg=cfg,
                                                     ctx=ctx))(p, x)


def _spawn(tmp_path, shape, inputs):
    work = str(tmp_path)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    world = shape[0] * shape[1]
    tmp_mp.start_processes(torch_moe_ranks.island_rank,
                           args=(world, work, shape), nprocs=world,
                           join=True, start_method="spawn")
    return [torch.load(os.path.join(work, f"rank{r}.pt"))
            for r in range(world)]


def _np(t):
    return t.float().numpy()


def _lm_case(arch):
    cfg = get_config(arch).reduced()
    params = tree_map(lambda a: a.float(), lm.init(cfg, seed=3,
                                                   device="cpu"))
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    return {"arch": arch, "params": params, "tokens": tokens}


@pytest.fixture(scope="module")
def one_by_one(tmp_path_factory):
    cases = {f"{a}-{dt}": _case(a, dt) for a in ARCHS for dt in DTYPES}
    out = _spawn(tmp_path_factory.mktemp("moe11"), (1, 1),
                 {"moe": {k: v[3] for k, v in cases.items()}})
    return cases, out[0]


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory):
    cases = {f"{a}-{dt}": _case(a, dt) for a in ARCHS for dt in DTYPES}
    lms = {f"lm-{a}": _lm_case(a) for a in ARCHS}
    out = _spawn(tmp_path_factory.mktemp("moe12"), (1, 2),
                 {"moe": {k: v[3] for k, v in cases.items()}, "lm": lms})
    return cases, lms, out


@pytest.fixture(scope="module")
def two_by_one(tmp_path_factory):
    cases = {a: _case(a, "f32") for a in ARCHS}
    out = _spawn(tmp_path_factory.mktemp("moe21"), (2, 1),
                 {"moe": {k: v[3] for k, v in cases.items()}})
    return cases, out


@pytest.mark.parametrize("arch", ARCHS)
def test_island_1x1_matches_the_local_path_in_bf16(one_by_one, arch):
    cases, out = one_by_one
    _, _, _, case = cases[f"{arch}-bf16"]
    cfg = get_config(arch).reduced()
    y1, a1 = moe.moe_apply(case["p"], case["x"], cfg=cfg, ctx=NULL_CTX)
    y2, a2 = out[f"{arch}-bf16"]
    assert y2.dtype == torch.bfloat16 and y2.shape == y1.shape
    np.testing.assert_allclose(_np(y2), _np(y1), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(a2), float(a1), rtol=1e-4)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_island_1x1_matches_the_reference_shard_map(one_by_one, arch, dt):
    cases, out = one_by_one
    cfg, p, x, _ = cases[f"{arch}-{dt}"]
    yr, ar = _ref_island(cfg, p, x)
    y2, a2 = out[f"{arch}-{dt}"]
    tol = dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else \
        dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(y2), np.asarray(yr, np.float32), **tol)
    np.testing.assert_allclose(float(a2), float(ar), rtol=1e-4)


def test_the_reference_island_matches_its_local_path_here(one_by_one):
    """The reference pair this file's tolerances come from, in f32."""
    cases, _ = one_by_one
    cfg, p, x, _ = cases["olmoe-1b-7b-f32"]
    yl, al = jmoe.moe_apply(p, x, cfg=cfg, ctx=JNULL)
    yr, ar = _ref_island(cfg, p, x)
    np.testing.assert_allclose(np.asarray(yr), np.asarray(yl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ar), float(al), rtol=1e-6)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_island_over_a_model_axis_of_two_matches_the_local_path(
        one_by_two, arch, dt):
    """Each rank routes to its 4 of the 8 experts and half the shared
    experts; the partial outputs meet in the all-reduce."""
    cases, _, out = one_by_two
    _, _, _, case = cases[f"{arch}-{dt}"]
    cfg = get_config(arch).reduced()
    y1, a1 = moe.moe_apply(case["p"], case["x"], cfg=cfg, ctx=NULL_CTX)
    assert [o["coord"] for o in out] == [(0, 0), (0, 1)]
    (y2, a2), (y3, a3) = out[0][f"{arch}-{dt}"], out[1][f"{arch}-{dt}"]
    assert torch.equal(y2, y3) and torch.equal(a2, a3)
    tol = dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else \
        dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(y2), _np(y1), **tol)
    np.testing.assert_allclose(float(a2), float(a1), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_with_ctx_matches_null_ctx(one_by_two, arch):
    """``lm.forward(..., ctx)`` on the 1 x 2 mesh with tensors every rank
    holds whole: the hints leave plain tensors as they are, and each MoE
    layer runs the island; the logits equal ``NULL_CTX``'s in float32."""
    _, lms, out = one_by_two
    case = lms[f"lm-{arch}"]
    cfg = get_config(arch).reduced()
    want = lm.forward(case["params"], case["tokens"], cfg, NULL_CTX,
                      mode="prefill")[0]
    got = [o[f"lm-{arch}"] for o in out]
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_island_over_a_data_axis_of_two_averages_aux(two_by_one, arch):
    """Each rank routes its one row (the expert queues are per row, so y
    is the local path's on the whole batch, gathered back); aux is the
    mean of the two rows' aux, as the reference's ``pmean``."""
    cases, out = two_by_one
    _, _, _, case = cases[arch]
    cfg = get_config(arch).reduced()
    y1, _ = moe.moe_apply(case["p"], case["x"], cfg=cfg, ctx=NULL_CTX)
    halves = [moe.moe_apply(case["p"], case["x"][i:i + 1], cfg=cfg,
                            ctx=NULL_CTX)[1] for i in range(2)]
    assert [o["coord"] for o in out] == [(0, 0), (1, 0)]
    (y2, a2), (y3, a3) = out[0][arch], out[1][arch]
    assert torch.equal(y2, y3) and torch.equal(a2, a3)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(a2), float(sum(halves)) / 2, rtol=1e-6)


def test_local_block_refuses_a_split_that_does_not_divide():
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, d):
            return (1, 3)[d]

        def get_local_rank(self, d):
            return 0

    from repro_torch.dist.sharding import P

    t = torch.zeros((8, 4))
    assert moe._local_block(t, P(None, None), Mesh()).shape == (8, 4)
    with pytest.raises(ValueError, match="does not split"):
        moe._local_block(t, P("model", None), Mesh())
    assert moe._local_block(torch.zeros((9, 4)), P("model", None),
                            Mesh()).shape == (3, 4)


def test_island_specs_are_the_references():
    """The weight specs of the reference's ``shard_map`` (``wspec``)."""
    from repro_torch.dist.sharding import P

    cfg = get_config("deepseek-v2-lite-16b").reduced()
    p = moe.moe_params(__import__("repro_torch.models.common",
                                  fromlist=["Draw"]).Draw("meta"), cfg)
    spec = moe._island_specs(p, "model")
    assert spec == {"wr": P(), "wi": P("model", None, None),
                    "wg": P("model", None, None),
                    "wo": P("model", None, None),
                    "shared": {"wi": P(None, "model"),
                               "wg": P(None, "model"),
                               "wo": P("model", None)}}
    assert "shared" not in moe._island_specs(
        {k: v for k, v in p.items() if k != "shared"}, "model")
    assert dataclasses.is_dataclass(NULL_CTX) and not NULL_CTX.active

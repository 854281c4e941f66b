"""The port's LM layers against the JAX package's on the same inputs and
params (numpy, from a seed): norms, RoPE, attention (the q-blocked form
padded and windowed, GQA / MLA / cross in prefill and decode), the MLPs,
the MoE's local path (both combines, with drops), and the SSD block
(chunked, chunk-size invariance, recurrent decode).

float32 inputs and params are held to rtol 1e-4 (atol 1e-5 to 1e-4, by the
output's scale); bfloat16 ones to the reference's own bf16 tolerance for a
layer (``tests/test_archs.py``'s MoE combine check: rtol 2e-2, atol 2e-2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import mlp as r_mlp
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro.models.common import NULL_CTX

from repro_torch.configs import get_config
from repro_torch.models import attention, common, mlp, moe, ssm
from repro_torch.models.common import tree_map

from torch_lm_pairs import one_torch_thread

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


@pytest.fixture(autouse=True, scope="module")
def _small_tensors():
    with one_torch_thread():
        yield


def pair(a: np.ndarray, dtype: str):
    """``a`` (float32 numpy) as a JAX array and a CPU tensor of ``dtype``,
    holding the same values (bf16 rounding happens once, in JAX, and is
    carried bit for bit)."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt) if a.dtype.kind == "f" else jnp.asarray(a)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))
                         if a.dtype.kind == "f" else np.array(a))
    return j, (t.to(tdt) if a.dtype.kind == "f" else t)


def params_pair(ref_params, dtype: str):
    """A reference param tree (cast to float32 for a float32 run) and the
    same values as tensors, each leaf keeping its dtype."""
    if dtype == "f32":
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
    port = jax.tree.map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16 if a.dtype == jnp.bfloat16
                                   else torch.float32), ref_params)
    return ref_params, port


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(fn, static_argnames=static)


def ref(fn, *args, **kw):
    """``fn(*args, **kw)`` of the reference, jitted once for each function
    and set of static arguments (configs, sizes, flags; arrays, dicts and
    None are traced), so that calls of one shape share a compile."""
    static = tuple(sorted(k for k, v in kw.items()
                          if not isinstance(v, (jax.Array, dict, type(None)))))
    return _jitted(fn, static)(*args, **kw)


def check(got, want, dtype, what=""):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        err_msg=what, **DTYPES[dtype][2])


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, shape, scale=1.0):
    return (scale * r.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ norms, RoPE

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_reference(dtype):
    r = rng(0)
    x, xt = pair(normal(r, (2, 5, 64), 3.0), dtype)
    w, wt = pair(1 + normal(r, (64,), 0.1), dtype)
    b, bt = pair(normal(r, (64,), 0.1), dtype)
    check(common.rmsnorm(xt, wt), r_common.rmsnorm(x, w), dtype)
    check(common.layernorm(xt, wt, bt), r_common.layernorm(x, w, b), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches_reference(dtype):
    r = rng(1)
    x, xt = pair(normal(r, (2, 7, 4, 32)), dtype)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (10000.0, 500000.0):
        check(common.apply_rope(xt, torch.from_numpy(pos),
                                common.rope_freqs(32, theta)),
              r_common.apply_rope(x, jnp.asarray(pos),
                                  r_common.rope_freqs(32, theta)), dtype)


def test_softmax_xent_and_causal_mask_match_reference():
    r = rng(13)
    logits = normal(r, (2, 6, 40), 3.0)
    labels = r.integers(0, 40, (2, 6)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1                  # ignored positions
    want = r_common.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = common.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(common.causal_mask(5).numpy(),
                                  np.asarray(r_common.causal_mask(5)))


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
@pytest.mark.parametrize("Sq,chunk", [(13, 4), (16, 16), (9, 64)])
def test_chunked_attend_matches_reference(causal, window, Sq, chunk):
    """Sq = 13 in blocks of 4 pads the last block; with a window of 5 the
    padded rows are fully masked (a uniform softmax in both)."""
    r = rng(2)
    q, qt = pair(normal(r, (2, Sq, 2, 3, 16)), "f32")
    k, kt = pair(normal(r, (2, Sq, 3, 16)), "f32")
    v, vt = pair(normal(r, (2, Sq, 3, 16)), "f32")
    kw = dict(causal=causal, window=window, scale=0.25, chunk=chunk)
    check(attention.chunked_attend(qt, kt, vt, **kw),
          ref(r_attn.chunked_attend, q, k, v, **kw), "f32")
    # a row masked everywhere: the finite mask value gives a uniform mix
    m = np.zeros((1, 1, 1, Sq, Sq), bool)
    got = attention._attend(qt, kt, vt, mask=torch.from_numpy(m), scale=0.25)
    want = ref(r_attn._attend, q, k, v, mask=jnp.asarray(m), scale=0.25,
                          ctx=NULL_CTX)
    check(got, want, "f32")
    assert torch.isfinite(got).all()


def attn_cfg(arch, **kw):
    return (dataclasses.replace(ref_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


ATTN_CASES = [("granite-3-2b", {}), ("qwen2-72b", {}),
              ("zamba2-2.7b", {"sliding_window": 6}),
              ("smollm-360m", {"attn_chunk": 4})]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,kw", ATTN_CASES)
def test_gqa_prefill_and_decode_match_reference(arch, kw, dtype):
    cfg, pcfg = attn_cfg(arch, **kw)
    rp = r_attn.gqa_params(jax.random.PRNGKey(3), cfg)
    if cfg.qkv_bias:                               # zeros at init
        rp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in rp.items()}
    rp, pp = params_pair(rp, dtype)
    r, B, S = rng(3), 2, 10
    x, xt = pair(normal(r, (B, S, cfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    w = cfg.sliding_window
    y, c = ref(r_attn.gqa_apply, rp, x, cfg=cfg, ctx=NULL_CTX,
                            positions=jnp.asarray(pos), window=w)
    yt, ct = attention.gqa_apply(pp, xt, cfg=pcfg,
                                 positions=torch.from_numpy(pos), window=w)
    check(yt, y, dtype, "prefill")
    check(ct["k"], c["k"], dtype, "k")
    check(ct["v"], c["v"], dtype, "v")
    # decode one token at pos S against the prefill cache grown to S + 2
    grow = ((0, 0), (0, 2), (0, 0), (0, 0))
    rc = {n: jnp.pad(c[n], grow) for n in ("k", "v")}
    pc = {n: torch.nn.functional.pad(ct[n], (0, 0, 0, 0, 0, 2))
          for n in ("k", "v")}
    x1, x1t = pair(normal(r, (B, 1, cfg.d_model)), dtype)
    p1 = np.full((B, 1), S, np.int32)
    y, c = ref(r_attn.gqa_apply, rp, x1, cfg=cfg, ctx=NULL_CTX,
                            positions=jnp.asarray(p1), cache=rc,
                            pos=jnp.int32(S), window=w)
    yt, ct = attention.gqa_apply(pp, x1t, cfg=pcfg,
                                 positions=torch.from_numpy(p1), cache=pc,
                                 pos=S, window=w)
    check(yt, y, dtype, "decode")
    check(ct["k"], c["k"], dtype, "decode k")
    assert ct["k"] is pc["k"]                      # written in place


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_prefill_and_decode_match_reference(dtype):
    cfg, pcfg = attn_cfg("deepseek-v2-lite-16b", attn_chunk=4)
    rp, pp = params_pair(r_attn.mla_params(jax.random.PRNGKey(4), cfg), dtype)
    r, B, S = rng(4), 2, 9
    x, xt = pair(normal(r, (B, S, cfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    y, c = ref(r_attn.mla_apply, rp, x, cfg=cfg, ctx=NULL_CTX,
                            positions=jnp.asarray(pos))
    yt, ct = attention.mla_apply(pp, xt, cfg=pcfg,
                                 positions=torch.from_numpy(pos))
    check(yt, y, dtype, "prefill")
    for n in ("ckv", "kr"):
        check(ct[n], c[n], dtype, n)
    rc = {n: jnp.pad(c[n], ((0, 0), (0, 3), (0, 0))) for n in c}
    pc = {n: torch.nn.functional.pad(ct[n], (0, 0, 0, 3)) for n in ct}
    for step in range(2):
        x1, x1t = pair(normal(r, (B, 1, cfg.d_model)), dtype)
        p1 = np.full((B, 1), S + step, np.int32)
        y, rc = ref(r_attn.mla_apply, rp, x1, cfg=cfg, ctx=NULL_CTX,
                                 positions=jnp.asarray(p1), cache=rc,
                                 pos=jnp.int32(S + step))
        yt, pc = attention.mla_apply(pp, x1t, cfg=pcfg,
                                     positions=torch.from_numpy(p1),
                                     cache=pc, pos=S + step)
        check(yt, y, dtype, f"decode {step}")
        check(pc["ckv"], rc["ckv"], dtype, f"decode {step} ckv")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_matches_reference(dtype):
    cfg, pcfg = attn_cfg("llama-3.2-vision-11b")
    rp, pp = params_pair(r_attn.cross_params(jax.random.PRNGKey(5), cfg),
                         dtype)
    r = rng(5)
    x, xt = pair(normal(r, (2, 3, cfg.d_model)), dtype)
    m, mt = pair(normal(r, (2, 11, cfg.d_model)), dtype)
    y, kv = ref(r_attn.cross_apply, rp, x, m, cfg=cfg, ctx=NULL_CTX)
    yt, kvt = attention.cross_apply(pp, xt, mt, cfg=pcfg)
    check(yt, y, dtype)
    check(kvt["mk"], kv["mk"], dtype)
    # with the memory's k/v cached (decode)
    x1, x1t = pair(normal(r, (2, 1, cfg.d_model)), dtype)
    y, _ = ref(r_attn.cross_apply, rp, x1, None, cfg=cfg, ctx=NULL_CTX,
               mem_kv=kv)
    yt, _ = attention.cross_apply(pp, x1t, None, cfg=pcfg, mem_kv=kvt)
    check(yt, y, dtype, "cached")


# --------------------------------------------------------------- MLP, MoE

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act, dtype):
    rp, pp = params_pair(r_mlp.mlp_params(jax.random.PRNGKey(6), 64, 96, act),
                         dtype)
    x, xt = pair(normal(rng(6), (2, 5, 64)), dtype)
    check(mlp.mlp_apply(pp, xt, act=act),
          ref(r_mlp.mlp_apply, rp, x, act=act, ctx=NULL_CTX), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", 1.0),
                                     ("olmoe-1b-7b", 1.25),
                                     ("deepseek-v2-lite-16b", 1.0)])
def test_moe_local_matches_reference(arch, cf, combine, dtype):
    """The tokens lie around one shared direction, so the router sends most
    of them to the same experts: at capacity factor 1.0 (16 tokens of 2
    choices over 8 experts, capacity 8) those queues overflow, and the
    dropped choices match too."""
    cfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf, combine=combine))
        for c in (ref_config(arch).reduced(), get_config(arch).reduced()))
    rp, pp = params_pair(r_moe.moe_params(jax.random.PRNGKey(7), cfg), dtype)
    r = rng(7)
    x, xt = pair(normal(r, (1, 1, cfg.d_model), 0.8)
                 + normal(r, (2, 16, cfg.d_model), 0.6), dtype)
    y, aux = ref(r_moe._moe_apply_local, rp, x, cfg=cfg, ctx=NULL_CTX)
    yt, auxt = moe.moe_apply(pp, xt, cfg=pcfg)
    check(yt, y, dtype)
    assert auxt.dtype == torch.float32
    np.testing.assert_allclose(float(auxt), float(aux), rtol=1e-5)
    # the queues overflowed: without drops the output differs
    if cf == 1.0:
        free = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=8.0))
        assert moe.capacity(16, pcfg) == 8
        assert not torch.allclose(moe.moe_apply(pp, xt, cfg=free)[0], yt)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    v, i = moe.top_k(x, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ri).tolist() == [[1, 2, 4]]
    assert v.tolist() == np.asarray(rv).tolist()


# -------------------------------------------------------------------- SSD

def ssm_cfgs(chunk=16, state=16):
    return [dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, chunk=chunk)) for c in (ref_config("mamba2-780m").reduced(),
                                       get_config("mamba2-780m").reduced())]


def ssm_params(cfg, dtype, seed=8):
    rp = r_ssm.ssm_params(jax.random.PRNGKey(seed), cfg)
    r = rng(seed)
    # A_log, D, dt_bias, conv_b and norm_w are constants at init
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        rp[name] = (rp[name] + jnp.asarray(normal(r, rp[name].shape, 0.3))
                    ).astype(rp[name].dtype)
    return params_pair(rp, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [32, 27])
def test_ssm_apply_matches_reference(T, dtype):
    """T = 27 pads to two chunks of 16: the final state and the conv tail
    are those of the padded sequence, in both."""
    cfg, pcfg = ssm_cfgs()
    rp, pp = ssm_params(cfg, dtype)
    x, xt = pair(normal(rng(9), (2, T, cfg.d_model), 0.5), dtype)
    y, st = ref(r_ssm.ssm_apply, rp, x, cfg=cfg, ctx=NULL_CTX)
    yt, stt = ssm.ssm_apply(pp, xt, cfg=pcfg)
    check(yt, y, dtype)
    check(stt["h"], st["h"], dtype, "h")
    check(stt["conv"], st["conv"], dtype, "conv")
    # from a given state
    y, _ = ref(r_ssm.ssm_apply, rp, x, cfg=cfg, ctx=NULL_CTX, state=st)
    yt, _ = ssm.ssm_apply(pp, xt, cfg=pcfg, state=stt)
    check(yt, y, dtype, "from a state")


def test_ssm_apply_chunk_size_invariance():
    """The port's SSD output does not depend on the chunk length (f32,
    the reference's own tolerance for the property, 2e-4), and each chunk
    length matches the reference."""
    x = normal(rng(10), (2, 64, 128))
    outs = []
    for chunk in (8, 16, 32):
        cfg, pcfg = ssm_cfgs(chunk)
        rp, pp = ssm_params(cfg, "f32", seed=11)
        xj, xt = pair(x, "f32")
        yt, _ = ssm.ssm_apply(pp, xt, cfg=pcfg)
        want, _ = ref(r_ssm.ssm_apply, rp, xj, cfg=cfg, ctx=NULL_CTX)
        check(yt, want, "f32")
        outs.append(yt.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_decode_step_matches_reference(dtype):
    """Eight recurrent steps from the chunked form's state, state written
    in place in the port."""
    cfg, pcfg = ssm_cfgs()
    rp, pp = ssm_params(cfg, dtype)
    r = rng(12)
    x, xt = pair(normal(r, (2, 16, cfg.d_model), 0.5), dtype)
    _, st = ref(r_ssm.ssm_apply, rp, x, cfg=cfg, ctx=NULL_CTX)
    stt = tree_map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.float32 if a.dtype == jnp.float32
                                   else torch.bfloat16), st)
    h0 = stt["h"]
    for step in range(8):
        x1, x1t = pair(normal(r, (2, 1, cfg.d_model), 0.5), dtype)
        y, st = ref(r_ssm.ssm_decode_step, rp, x1, st, cfg=cfg, ctx=NULL_CTX)
        yt, stt = ssm.ssm_decode_step(pp, x1t, stt, cfg=pcfg)
        check(yt, y, dtype, f"step {step}")
        check(stt["h"], st["h"], dtype, f"step {step} h")
        check(stt["conv"], st["conv"], dtype, f"step {step} conv")
    assert stt["h"] is h0

"""PowerSync in the port (``repro_torch.optim.powersync``): the JAX
package's five checks (``tests/test_powersync.py``) ported, with N data
shards in lockstep through ``SimReducer`` (the reference's
``vmap(axis_name="dp")``), and parity with the reference's
``powersync_tree`` under ``vmap`` on the same inputs.

Parity tolerances: the residual exactly (the same f32 ``g + r``, the same
selection, x + (-x) = +0.0 where the reference sets 0.0); the sent masks
equal wherever the accumulated value is non-zero (a tie among zero rows
moves no value); the synced mean exactly at 2 shards (one f32 add, then a
halving) and within rtol 1e-6 of each leaf's scale at 4 (the two sum the
shards in other orders); ``bytes_by_phase`` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.sync import CommMeter as RefMeter
from repro.core.sync import MeshReducer
from repro.optim import powersync as ref

from repro_torch.core.sync import CommMeter, SimReducer, lockstep
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.powersync import (PowerSyncConfig, dense_sync_tree,
                                         powersync_tree, residual_init)


def run_shards(fn, *stacked, meter=None):
    """``fn(reducer, *slices)`` on each shard of the stacked inputs, in
    lockstep; returns the per-shard results."""
    n = stacked[0].shape[0] if isinstance(stacked[0], torch.Tensor) else \
        next(tree_leaves(stacked[0]))[1].shape[0]
    red = SimReducer(n, meter=meter)

    def body(s):
        with red.meter.section():
            return fn(red, *[tree_map(lambda a: a[s], x) for x in stacked])
    return lockstep(body, n, [red])


def _stack(results, i):
    return torch.stack([r[i] for r in results])


def test_lambda_one_equals_dense_sync():
    """With lambda_rows = lambda_cols = 1 PowerSync is the dense
    all-reduce."""
    cfg = PowerSyncConfig(lambda_rows=1.0, lambda_cols=1.0, min_dense_size=1)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 16, 8)).astype(np.float32))

    def one(red, gs, rs):
        synced, res = powersync_tree({"w": gs}, {"w": rs}, red, cfg, 4)
        return synced["w"], res["w"]

    out = run_shards(one, g, torch.zeros_like(g))
    want = g.mean(0, keepdim=True).expand_as(g)
    torch.testing.assert_close(_stack(out, 0), want, rtol=1e-5, atol=1e-6)
    assert not _stack(out, 1).any()

    dense = run_shards(lambda red, gs: dense_sync_tree({"w": gs}, red, 4)
                       ["w"], g)
    torch.testing.assert_close(torch.stack(dense), want, rtol=1e-5,
                               atol=1e-6)


def test_error_feedback_conserves_mass():
    """transmitted + residual == grad + residual_prev, per shard."""
    cfg = PowerSyncConfig(lambda_rows=0.25, lambda_cols=0.5, min_dense_size=1)
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
    r0 = torch.from_numpy(0.1 * rng.standard_normal((2, 8, 8)).astype(
        np.float32))

    def one(red, gs, rs):
        synced, res = powersync_tree({"w": gs}, {"w": rs}, red, cfg, 2)
        return synced["w"], res["w"]

    out = run_shards(one, g, r0)
    synced, res = _stack(out, 0).numpy(), _stack(out, 1).numpy()
    acc = (g + r0).numpy()
    sent = res == 0.0
    np.testing.assert_array_equal(res[~sent], acc[~sent])
    sel = sent[0]
    assert sel.sum() == 2 * 4
    np.testing.assert_allclose(synced[0][sel], (acc[0][sel] + acc[1][sel])
                               / 2, rtol=1e-6, atol=0)
    assert not synced[0][~sel].any()


def test_selection_identical_across_shards():
    """Shards transmit identical coordinates (index-free collectives)."""
    cfg = PowerSyncConfig(lambda_rows=0.25, lambda_cols=0.25,
                          min_dense_size=1)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 16, 16)).astype(np.float32))

    def one(red, gs):
        _, res = powersync_tree({"w": gs}, {"w": torch.zeros_like(gs)}, red,
                                cfg, 4)
        return res["w"] == 0.0

    masks = run_shards(one, g)
    assert int(masks[0].sum()) == 4 * 4
    for m in masks[1:]:
        assert torch.equal(masks[0], m)


def test_bytes_reduction_matches_lambdas():
    meter = CommMeter()
    rows, cols = 64, 32
    cfg = PowerSyncConfig(lambda_rows=0.25, lambda_cols=0.5, min_dense_size=1)
    g = torch.randn((2, rows, cols), generator=torch.Generator().manual_seed(4))
    run_shards(lambda red, gs: powersync_tree(
        {"w": gs}, {"w": torch.zeros_like(gs)}, red, cfg, 2), g, meter=meter)
    payload = meter.phase_bytes("powersync_payload")
    dense = rows * cols * 4
    assert payload == int(0.25 * rows) * int(0.5 * cols) * 4
    assert payload < 0.2 * dense
    # the norm side channel is small: rows + cols floats
    assert meter.phase_bytes("powersync_norms") == (rows + cols) * 4


@settings(max_examples=10, deadline=None)
@given(st.integers(4, 40), st.integers(4, 40), st.integers(1, 4))
def test_powersync_eventual_transmission(rows, cols, seed):
    """Dynamic re-selection (the paper's Fig. 3): a constant gradient's
    mass at any coordinate is eventually transmitted."""
    cfg = PowerSyncConfig(lambda_rows=0.3, lambda_cols=0.5, min_dense_size=1)
    # bounded magnitude ratio (<= 3x): every coordinate is sent within
    # O(ratio / lambda) rounds
    gen = torch.Generator().manual_seed(seed)
    g = torch.rand((1, rows, cols), generator=gen) + 0.5
    r = torch.zeros((1, rows, cols))
    sent_total = torch.zeros((rows, cols))

    def one(red, gs, rs):
        synced, res = powersync_tree({"w": gs}, {"w": rs}, red, cfg, 1)
        return synced["w"], res["w"]

    for _ in range(30):
        out = run_shards(one, g, r)
        r = _stack(out, 1)
        sent_total += out[0][0]
    assert bool((sent_total > 0).all()), int((sent_total == 0).sum())


# ------------------------------------------------- parity with the reference

def _grads(n, seed):
    """A gradient tree with leaves of every kind PowerSync meets: a 2-D
    leaf with zero rows (tokens absent from the batch), a stacked 3-D
    leaf, a bf16 leaf, a 1-D leaf and a small 2-D leaf (both dense)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, 96, 48)).astype(np.float32)
    emb[:, ::3] = 0.0
    return {"embed": emb,
            "stack": {"w": rng.standard_normal((n, 3, 40, 64)).astype(
                np.float32),
                "wb": rng.standard_normal((n, 70, 80)).astype(np.float32)},
            "norm": rng.standard_normal((n, 48)).astype(np.float32),
            "small": rng.standard_normal((n, 16, 16)).astype(np.float32),
            "head_blocks": [{"w": rng.standard_normal((n, 50, 90)).astype(
                np.float32)}]}


BF16 = ("wb",)


def _ref_tree(t):
    def leaf(path, a):
        x = jnp.asarray(a)
        return x.astype(jnp.bfloat16) if path[-1].key in BF16 else x
    return jax.tree_util.tree_map_with_path(leaf, t)


def _port_tree(t, grads=True):
    def conv(x, name=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, name) for v in x]
        y = torch.from_numpy(x)
        return y.bfloat16() if grads and name in BF16 else y
    return conv(t)


@pytest.mark.parametrize("n,lr,lc", [(2, 0.2, 0.5), (2, 0.5, 0.25),
                                     (4, 0.2, 0.5)])
def test_powersync_matches_reference_under_vmap(n, lr, lc):
    g = _grads(n, seed=n)
    r = jax.tree.map(lambda a: 0.1 * np.random.default_rng(9).standard_normal(
        a.shape).astype(np.float32), g)
    kw = dict(lambda_rows=lr, lambda_cols=lc)

    rmeter = RefMeter()
    red = MeshReducer("dp", meter=rmeter)
    rcfg = ref.PowerSyncConfig(**kw)
    rs, rr = jax.vmap(lambda gs, rs_: ref.powersync_tree(gs, rs_, red, rcfg,
                                                         n),
                      axis_name="dp")(_ref_tree(g), jax.tree.map(jnp.asarray,
                                                                 r))

    meter = CommMeter()
    pg, pr = _port_tree(g), _port_tree(r, grads=False)
    out = run_shards(lambda red_, gs, rs_: powersync_tree(
        gs, rs_, red_, PowerSyncConfig(**kw), n), pg, pr, meter=meter)
    assert meter.bytes_by_phase == rmeter.bytes_by_phase
    accs = [a.float() + b for (_, a), (_, b) in zip(tree_leaves(pg),
                                                   tree_leaves(pr))]
    want_s, want_r = jax.tree.leaves(rs), jax.tree.leaves(rr)
    for s in range(n):
        got_s, got_r = list(tree_leaves(out[s][0])), list(tree_leaves(
            out[s][1]))
        assert len(got_s) == len(want_s) == len(got_r) == len(want_r)
        for (path, gs_), ws, (_, gr), wr, acc in zip(got_s, want_s, got_r,
                                                     want_r, accs):
            ws = np.asarray(jnp.asarray(ws[s], jnp.float32))
            wr = np.asarray(wr[s])
            assert gr.dtype == torch.float32
            np.testing.assert_array_equal(gr.numpy(), wr,
                                          err_msg=f"residual {path}")
            # the sent masks, wherever the accumulated value is non-zero
            live = acc[s].numpy() != 0
            np.testing.assert_array_equal((gr.numpy() == 0)[live],
                                          (wr == 0)[live])
            if n == 2:
                np.testing.assert_array_equal(gs_.float().numpy(), ws,
                                              err_msg=f"synced {path}")
            else:
                np.testing.assert_allclose(gs_.float().numpy(), ws, rtol=1e-6,
                                           atol=1e-6 * np.abs(ws).max(),
                                           err_msg=f"synced {path}")


def test_residual_init_and_dense_sync_keep_dtypes():
    p = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
         "b": [torch.zeros(5)]}
    r = residual_init(p)
    assert r["a"].dtype == torch.float32 and r["b"][0].shape == (5,)
    g = torch.randn((2, 3, 4)).bfloat16()
    out = run_shards(lambda red, gs: dense_sync_tree({"a": gs}, red, 2)["a"],
                     g)
    assert out[0].dtype == torch.bfloat16
    assert torch.equal(out[0], out[1])
    torch.testing.assert_close(out[0], ((g[0].float() + g[1].float()) / 2)
                               .bfloat16(), rtol=0, atol=0)


def test_a_leaf_of_two_to_the_31_elements_passes_powersyncs_checks(
        monkeypatch):
    """olmoe-1b-7b's expert leaves hold exactly 2^31 elements
    ([16, 64, 2048, 1024]): PowerSync syncs them, as the reference does.
    On meta tensors the pack and scatters are stood in for by the kernels'
    own argument checks (which also hold the int limits) and meta
    results, so the whole leaf's path runs without memory."""
    from repro_torch.core.sync import LocalReducer
    from repro_torch.kernels.power_pack import ops as pack_ops
    from repro_torch.optim import powersync as ps_mod

    calls = []

    def pack(mat, sel_w, sel_k):
        pack_ops._check_cuda_args(mat, sel_w, sel_k)
        calls.append(("pack", tuple(mat.shape), tuple(sel_k.shape)))
        return torch.empty(sel_k.shape, device="meta")

    def scatter(mat, sel_w, sel_k, vals):
        pack_ops._check_cuda_args(mat, sel_w, sel_k, vals)
        calls.append(("scatter", tuple(mat.shape), tuple(sel_k.shape)))
        return mat

    monkeypatch.setattr(ps_mod.pack_ops, "pack_rows", pack)
    monkeypatch.setattr(ps_mod.pack_ops, "scatter_add_rows", scatter)
    g = torch.empty((16, 64, 2048, 1024), device="meta")
    assert g.numel() == 2 ** 31
    synced, res = powersync_tree({"w": g}, {"w": g}, LocalReducer(),
                                 PowerSyncConfig(), 1)
    assert synced["w"].shape == g.shape and res["w"].shape == g.shape
    P, Pc = round(0.2 * 2 ** 21), round(0.5 * 1024)
    assert calls == [("pack", (2 ** 21, 1024), (P, Pc)),
                     ("scatter", (2 ** 21, 1024), (P, Pc)),
                     ("scatter", (2 ** 21, 1024), (P, Pc))]


@pytest.mark.parametrize("side", ["W", "K", "P", "Pk"])
def test_the_kernels_refuse_a_side_of_two_to_the_31(side):
    """The power-pack kernels take P, Pk, W and K as C ints: a side of
    2^31 is refused before launch, by name."""
    from repro_torch.kernels.power_pack import ops as pack_ops

    n = {"W": 4, "K": 4, "P": 2, "Pk": 2}
    n[side] = 2 ** 31
    mat = torch.empty((n["W"], n["K"]), device="meta")
    sel_w = torch.empty((n["P"],), dtype=torch.int32, device="meta")
    sel_k = torch.empty((n["P"], n["Pk"]), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=f"^{side} = 2147483648 is past"):
        pack_ops._check_cuda_args(mat, sel_w, sel_k)
    n[side] = 2 ** 31 - 1
    if side in ("W", "K"):       # one below the limit passes
        pack_ops._check_cuda_args(
            torch.empty((n["W"], n["K"]), device="meta"), sel_w, sel_k)

"""Checkpoints cross between the packages bit for bit: the port restores
what ``repro.dist.checkpoint.save`` wrote (float32 and bfloat16), and the
JAX package restores what the port saved.  ``convert.phi_from_reference``
carries a JAX phi into the port unchanged."""

import dataclasses
import json
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as jckpt
from repro_torch import convert
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models.common import tree_map

W, K = 150, 16


def _phi(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.gamma(0.3, 20.0, (W, K))).astype(np.float32)


def _bits(x: torch.Tensor) -> np.ndarray:
    """The raw bit pattern of a float32/bfloat16 tensor."""
    t = x.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_restores_jax_checkpoint_bit_exactly(tmp_path, dtype):
    phi = jnp.asarray(_phi()).astype(dtype)
    jckpt.save(str(tmp_path), 4,
               {"state": {"phi_acc": phi, "m": jnp.asarray(4, jnp.int32),
                          "rng": jax.random.PRNGKey(0)}},
               extra={"next_m": 4, "run": {"vocab": W, "topics": K}})
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.verify_step(str(tmp_path), 4) is None
    got, extra, step = ckpt.restore_phi(str(tmp_path))
    assert step == 4 and extra["run"]["topics"] == K
    assert got.shape == (W, K)
    want = np.asarray(phi)
    if dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), want.view(np.int16))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    # dtype= upcasts exactly as the reference's restore_phi(dtype=) does
    up, _, _ = ckpt.restore_phi(str(tmp_path), dtype=torch.float32)
    jup, _, _ = jckpt.restore_phi(str(tmp_path), dtype=jnp.float32)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jax_restores_port_checkpoint_bit_exactly(tmp_path, dtype):
    phi = torch.from_numpy(_phi(1)).to(dtype)
    ckpt.save(str(tmp_path), 9,
              {"state": {"phi_acc": phi,
                         "m": torch.tensor(9, dtype=torch.int32),
                         "rng": np.zeros(2, np.uint32)}},
              extra={"run": {"vocab": W, "topics": K}})
    assert jckpt.verify_step(str(tmp_path), 9) is None
    got, extra, step = jckpt.restore_phi(str(tmp_path))
    assert step == 9 and extra["run"]["vocab"] == W
    got = np.asarray(got)
    assert got.shape == (W, K) and got.dtype.name == str(dtype)[6:]
    np.testing.assert_array_equal(
        got.view(np.int16 if dtype == torch.bfloat16 else np.int32),
        _bits(phi))
    # the reference's template-driven restore reads the same tree back
    tree, _, _ = jckpt.restore(
        str(tmp_path), 9,
        {"state": {"phi_acc": jnp.zeros((W, K), got.dtype),
                   "m": jnp.asarray(0, jnp.int32),
                   "rng": jnp.zeros(2, jnp.uint32)}})
    assert int(tree["state"]["m"]) == 9


def test_restore_phi_errors_and_retention(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_phi(str(tmp_path / "empty"))
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"state": {"phi_acc": _phi(s)}})
    assert sorted(ckpt._all_steps(str(tmp_path))) == [3, 4, 5]
    with pytest.raises(ValueError, match="0 leaves"):
        ckpt.restore_phi(str(tmp_path), leaf="nope")
    leaf = tmp_path / "step_0000005" / "data.npz"
    leaf.write_bytes(leaf.read_bytes()[:100])
    assert ckpt.verify_step(str(tmp_path), 5) is not None
    assert ckpt.verify_step(str(tmp_path), 4) is None


def test_phi_from_reference_round_trips():
    phi = _phi(2)
    got = convert.phi_from_reference(phi, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (W, K)
    np.testing.assert_array_equal(got.numpy(), phi)
    # a bfloat16 JAX statistic (ml_dtypes numpy) arrives up-cast exactly
    jb = np.asarray(jnp.asarray(phi).astype(jnp.bfloat16))
    got_b = convert.phi_from_reference(jb, live_words=W - 3, device="cpu")
    np.testing.assert_array_equal(got_b.numpy(),
                                  np.asarray(jb.astype(np.float32)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convert.phi_from_reference(phi.astype(np.float64), device="cpu")
    with pytest.raises(ValueError, match=r"\[W, K\]"):
        convert.phi_from_reference(phi[0], device="cpu")
    with pytest.raises(ValueError, match="live_words"):
        convert.phi_from_reference(phi, live_words=W + 1, device="cpu")


# ------------------------------------------ the template-driven restore

def _tree(seed):
    """A tree of the reference's test shapes: float32, a bfloat16 leaf, a
    0-d int32."""
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nest": {"b": torch.randn((3,), generator=g).bfloat16(),
                     "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return [x for _, x in ckpt._flatten(tree)]


def test_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 10, {"params": tree},
              extra={"next_step": 10, "m": 3})
    out, extra, step = ckpt.restore(str(tmp_path), 10, {"params": tree})
    assert step == 10 and extra == {"next_step": 10, "m": 3}
    for a, b in zip(_leaves(out["params"]), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_restore_matches_the_reference_restore(tmp_path):
    """Both packages' template-driven restores read one JAX-written tree to
    the same bits, a uint32 [2] PRNG key included."""
    phi = jnp.asarray(_phi(3))
    jckpt.save(str(tmp_path), 5,
               {"state": {"phi_acc": phi, "m": jnp.asarray(5, jnp.int32),
                          "rng": jax.random.PRNGKey(4)}})
    tpl = {"state": {"phi_acc": torch.zeros((W, K)), "m": np.int32(0),
                     "rng": torch.zeros(2, dtype=torch.uint32)}}
    got, _, step = ckpt.restore(str(tmp_path), 5, tpl)
    want, _, _ = jckpt.restore(
        str(tmp_path), 5, {"state": {"phi_acc": phi, "m": jnp.int32(0),
                                     "rng": jax.random.PRNGKey(0)}})
    assert step == 5 and int(got["state"]["m"]) == 5
    np.testing.assert_array_equal(_bits(got["state"]["phi_acc"]),
                                  np.asarray(want["state"]["phi_acc"]
                                             ).view(np.int32))
    np.testing.assert_array_equal(got["state"]["rng"].view(torch.int32),
                                  np.asarray(want["state"]["rng"]
                                             ).view(np.int32))


@pytest.mark.parametrize("case", ["shape", "dtype", "key", "count"])
def test_template_mismatch_rejected(tmp_path, case):
    tree = _tree(2)
    ckpt.save(str(tmp_path), 1, {"t": tree})
    bad = {"t": {"a": tree["a"], "nest": dict(tree["nest"])}}
    if case == "shape":
        bad["t"]["a"] = torch.zeros((9, 4))
    elif case == "dtype":
        bad["t"]["nest"]["b"] = tree["nest"]["b"].float()
    elif case == "key":
        bad = {"u": bad["t"]}
    else:
        bad["t"]["extra"] = torch.zeros(1)
    match = {"shape": "shape mismatch", "dtype": "dtype mismatch",
             "key": "key mismatch", "count": "leaf count mismatch"}[case]
    with pytest.raises(ValueError, match=match):
        ckpt.restore(str(tmp_path), 1, bad)


def test_restore_latest_falls_back_past_torn_newest(tmp_path):
    tree = _tree(5)
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, {"t": tree}, extra={"next_step": s})
    with open(tmp_path / "step_0000003" / "data.npz", "wb") as f:
        f.write(b"\x00garbage, not a zip\xff" * 7)
    assert ckpt.verify_step(str(tmp_path), 3) is not None
    assert ckpt.verify_step(str(tmp_path), 2) is None
    with pytest.warns(RuntimeWarning, match="corrupt"):
        got = ckpt.restore_latest(str(tmp_path), {"t": tree})
    out, extra, step = got
    assert step == 2 and extra == {"next_step": 2}
    assert torch.equal(out["t"]["a"], tree["a"])


def test_restore_latest_detects_truncated_leaf_bytes(tmp_path):
    tree = _tree(6)
    ckpt.save(str(tmp_path), 1, {"t": tree})
    ckpt.save(str(tmp_path), 2, {"t": tree})
    trunc = {f"leaf_{i}": np.zeros(1, np.uint8) for i in range(3)}
    np.savez(str(tmp_path / "step_0000002" / "data.npz"), **trunc)
    bad = ckpt.verify_step(str(tmp_path), 2)
    assert bad is not None and "torn write" in bad
    with pytest.warns(RuntimeWarning, match="falling back"):
        _, _, step = ckpt.restore_latest(str(tmp_path), {"t": tree})
    assert step == 1


def test_restore_latest_all_corrupt_returns_none(tmp_path):
    tree = _tree(7)
    ckpt.save(str(tmp_path), 1, {"t": tree})
    with open(tmp_path / "step_0000001" / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert ckpt.restore_latest(str(tmp_path), {"t": tree}) is None
    assert ckpt.restore_latest(str(tmp_path / "none"), {"t": tree}) is None


def test_template_mismatch_on_intact_step_still_raises(tmp_path):
    tree = _tree(8)
    ckpt.save(str(tmp_path), 1, {"t": tree})
    ckpt.save(str(tmp_path), 2, {"t": tree})
    bad = {"t": {"a": torch.zeros((9, 4)), "nest": tree["nest"]}}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_latest(str(tmp_path), bad)


def test_peek_extra_skips_unreadable_newest_manifest(tmp_path):
    tree = _tree(9)
    ckpt.save(str(tmp_path), 1, {"t": tree}, extra={"next_step": 1})
    ckpt.save(str(tmp_path), 2, {"t": tree}, extra={"next_step": 2})
    assert ckpt.peek_extra(str(tmp_path), 2) == ({"next_step": 2}, 2)
    with open(tmp_path / "step_0000002" / "manifest.json", "w") as f:
        f.write("{broken")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        extra, step = ckpt.peek_extra(str(tmp_path))
    assert step == 1 and extra == {"next_step": 1}
    assert ckpt.peek_extra(str(tmp_path / "none")) is None


def test_grow_remap_and_shrink_follow_the_reference(tmp_path):
    """The elastic row reshard through `restore` and `restore_phi`: grow
    zero-pads, a fenced remap moves survivors and zeroes the rest, a
    remap-less shrink raises; each as the reference's `_resize_rows`."""
    phi = _phi(4)[:40]
    jckpt.save(str(tmp_path), 1, {"state": {"phi_acc": jnp.asarray(phi)}})
    remap = np.full(40, -1, np.int64)
    remap[::3] = np.arange(14)[::-1]             # 14 survivors, permuted
    for kw, jkw, rows in (({"grow_rows": ("phi_acc",)},
                           {"grow_rows": ("phi_acc",)}, 64),
                          ({"row_remaps": {"phi_acc": remap}},
                           {"row_remaps": {"phi_acc": remap}}, 20)):
        got, _, _ = ckpt.restore(
            str(tmp_path), 1, {"state": {"phi_acc": torch.zeros((rows, K))}},
            **kw)
        want, _, _ = jckpt.restore(
            str(tmp_path), 1, {"state": {"phi_acc": jnp.zeros((rows, K))}},
            **jkw)
        np.testing.assert_array_equal(got["state"]["phi_acc"].numpy(),
                                      np.asarray(want["state"]["phi_acc"]))
        arr, _, _ = ckpt.restore_phi(
            str(tmp_path), w_cap=rows,
            row_remap=kw.get("row_remaps", {}).get("phi_acc"))
        np.testing.assert_array_equal(arr.numpy(),
                                      np.asarray(want["state"]["phi_acc"]))
    # a shrink without a remap: refused by the template check in
    # `restore`, by `_resize_rows` in `restore_phi`, as in the reference
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1,
                     {"state": {"phi_acc": torch.zeros((20, K))}},
                     grow_rows=("phi_acc",))
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.restore(str(tmp_path), 1,
                      {"state": {"phi_acc": jnp.zeros((20, K))}},
                      grow_rows=("phi_acc",))
    for fn in (ckpt.restore_phi, jckpt.restore_phi):
        with pytest.raises(ValueError, match="cannot shrink"):
            fn(str(tmp_path), w_cap=20)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1,
                     {"state": {"phi_acc": torch.zeros((64, K))}})


def test_restore_puts_each_leaf_on_its_template_device(tmp_path):
    """A restored leaf lands on its template tensor's device (the meta
    device stands in for a card here); a non-tensor leaf on the CPU."""
    ckpt.save(str(tmp_path), 1, {"s": {"x": torch.ones(3), "m": np.int32(2)}})
    got, _, _ = ckpt.restore(
        str(tmp_path), 1, {"s": {"x": torch.empty(3, device="meta"),
                                 "m": np.int32(0)}})
    assert got["s"]["x"].device.type == "meta"
    assert got["s"]["m"].device.type == "cpu" and int(got["s"]["m"]) == 2


# ---------------------------------------- a resume across the packages

def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX driver writes a checkpoint at step 2; the port's restore
    reads its phi_acc and m bit for bit (the template's rng a uint32 [2]
    leaf); both packages then continue two mini-batches of the driver's
    stream, the reference's draws injected into the port: phi_acc and
    mean_r agree to rel 1e-4 (float sums in other orders)."""
    from repro.core import pobp as jp
    from repro.launch import lda_train as jcli
    from repro_torch.core import pobp
    from repro_torch.launch import lda_train as cli

    flags = dict(docs_per_batch=16, vocab=W, topics=K, lambda_k=4,
                 inner_iters=6, tol=0.05, seed=2, doc_len_means="10,20",
                 len_buckets="16,32")
    d = str(tmp_path / "ck")
    jcli.train_loop(jcli.default_args(**flags, minibatches=2, ckpt_dir=d,
                                      ckpt_every=2, log_every=0,
                                      warmup_buckets=False))
    tpl = {"state": {"phi_acc": torch.zeros((W, K)), "m": np.int32(0),
                     "rng": torch.zeros(2, dtype=torch.uint32)}}
    got, extra, step = ckpt.restore(str(d), 2, tpl)
    jtpl = {"state": {"phi_acc": jnp.zeros((W, K)), "m": jnp.int32(0),
                      "rng": jax.random.PRNGKey(0)}}
    jtree, _, _ = jckpt.restore(str(d), 2, jtpl)
    assert step == 2 and extra["next_m"] == 2 and int(got["state"]["m"]) == 2
    np.testing.assert_array_equal(
        _bits(got["state"]["phi_acc"]),
        np.asarray(jtree["state"]["phi_acc"]).view(np.int32))

    jargs = jcli.default_args(**flags, minibatches=4)
    jcfg = dataclasses.replace(jcli._build_cfg(jargs)[0],
                               sweep_policy="dense_layout")
    argv = [a for k, v in dict(flags, minibatches=4).items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg, buckets = cli._build_cfg(args)
    jstep, _ = jp.make_train_step(jcfg, 1)
    step_fn, _ = pobp.make_train_step(cfg, device="cpu")
    from repro.core.types import LDATrainState as JState
    jstate = JState(**jtree["state"])
    state = convert.train_state_from_reference(
        got["state"]["phi_acc"].numpy(), int(got["state"]["m"]), seed=0,
        device="cpu")
    for mb, _ in cli.synthetic_stream(args, buckets, 2)():
        _, sub = jax.random.split(jstate.rng)
        Dm, Lm = mb.word_ids.shape
        u0 = jax.random.uniform(sub, (Dm, max(cfg.init_pad_len, Lm), K),
                                minval=0.01, maxval=1.0)
        jstate, jdiag = jstep(jstate, jnp.asarray(mb.word_ids.numpy()),
                              jnp.asarray(mb.counts.numpy()))
        state, diag = step_fn(state, mb.word_ids, mb.counts,
                              u0=torch.from_numpy(np.array(u0)))
        assert diag["iters"] == int(jdiag["iters"])
        assert float(diag["mean_r"]) == pytest.approx(
            float(jdiag["mean_r"]), rel=1e-4)
    assert state.m == int(jstate.m) == 4
    np.testing.assert_allclose(state.phi_acc.numpy(),
                               np.asarray(jstate.phi_acc), rtol=1e-4,
                               atol=1e-4)


class _State(NamedTuple):
    master: Any
    m: Any
    step: Any


def _trainer_tree(seed, n=2):
    """An LM trainer state's shapes of containers: a dict with a list of
    blocks, a NamedTuple whose fields are not in sorted order, a 0-d int32
    step, bf16 and f32 leaves."""
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn((6, 4), generator=g).bfloat16(),
              "head_blocks": [{"w": torch.randn((4, 4), generator=g)},
                              {"w": torch.randn((4, 4), generator=g)}],
              "stack": {"b": torch.randn((3, 4), generator=g)}}
    master = tree_map(lambda x: x.float(), params)
    return {"params": params,
            "opt": _State(master=master, m=tree_map(torch.zeros_like, master),
                          step=torch.tensor(3, dtype=torch.int32)),
            "residual": {"embed": torch.zeros((n, 6, 4))}}


def test_lists_tuples_and_namedtuples_round_trip(tmp_path):
    tree = _trainer_tree(0)
    tree["extra_tuple"] = (torch.ones(2), torch.zeros(3, dtype=torch.int32))
    ckpt.save(str(tmp_path), 2, tree, extra={"next_step": 2})
    template = _trainer_tree(1)
    template["extra_tuple"] = (torch.zeros(2),
                               torch.ones(3, dtype=torch.int32))
    out, extra, step = ckpt.restore(str(tmp_path), 2, template)
    assert step == 2 and extra == {"next_step": 2}
    # the template's own container types come back
    assert isinstance(out["opt"], _State)
    assert isinstance(out["params"]["head_blocks"], list)
    assert isinstance(out["extra_tuple"], tuple)
    assert out["opt"].step.dim() == 0 and int(out["opt"].step) == 3
    got, want = ckpt._flatten(out), ckpt._flatten(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), key


def test_keys_are_the_references_keystr_keys(tmp_path):
    """The port writes the keys ``jax.tree_util.keystr`` gives the same
    tree in the reference (list items ``[0]``, NamedTuple fields
    ``.master`` in field order, dict keys sorted), in its order; each
    package restores what the other wrote."""
    tree = _trainer_tree(2)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else
        jnp.int32 if t.dtype == torch.int32 else jnp.float32), tree)
    ckpt.save(str(tmp_path / "port"), 1, tree)
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    keys = [rec["key"] for rec in json.loads(
        (tmp_path / "port" / "step_0000001" / "manifest.json").read_text()
    )["leaves"]]
    ref_keys = [rec["key"] for rec in json.loads(
        (tmp_path / "ref" / "step_0000001" / "manifest.json").read_text()
    )["leaves"]]
    assert keys == ref_keys
    assert "['opt'].master['head_blocks'][1]['w']" in keys
    assert keys.index("['opt'].master['embed']") < keys.index(
        "['opt'].m['embed']") < keys.index("['opt'].step")
    out, _, _ = ckpt.restore(str(tmp_path / "ref"), 1, _trainer_tree(3))
    for (key, a), (_, b) in zip(ckpt._flatten(out), ckpt._flatten(tree)):
        assert torch.equal(a, b), key
    jout, _, _ = jckpt.restore(str(tmp_path / "port"), 1, jtree)
    for a, b in zip(jax.tree.leaves(jout), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_restore_holds_no_leaf_in_a_reference_cycle(tmp_path):
    """With the garbage collector off, a restored tree's leaves are freed
    as soon as the tree is dropped: rebuilding it (``tree_unflatten``)
    leaves no reference cycle that holds them until a collection."""
    import gc
    import weakref

    from repro_torch.models.common import tree_leaves, tree_unflatten

    ckpt.save(str(tmp_path), 2, _trainer_tree(0))
    gc.collect()
    gc.disable()
    try:
        out, _, _ = ckpt.restore(str(tmp_path), 2, _trainer_tree(1))
        refs = [weakref.ref(leaf) for _, leaf in ckpt._flatten(out)]
        del out
        assert [r() is None for r in refs] == [True] * len(refs)
        tree = _trainer_tree(2)
        out = tree_unflatten(tree, [x.clone() for _, x in tree_leaves(tree)])
        refs = [weakref.ref(leaf) for _, leaf in tree_leaves(out)]
        del out
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


_SHARDED_RESTORE = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.sharding import P, phi_serving_spec
from repro_torch.launch.mesh import make_mesh

d = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                        world_size=1)
out = {}
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
rng = np.random.default_rng(3)
w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
b = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
ckpt.save(d, 2, {"params": {"w": w, "b": b}})
# the reference test's remesh path: each leaf through an explicit sharding
tree, _, step = ckpt.restore(d, 2, {"params": {"w": w, "b": b}},
                             shardings={"params": {"w": (mesh, P("data", None)),
                                                   "b": None}})
out["w_type"] = type(tree["params"]["w"]).__name__
out["w_placements"] = [str(p) for p in tree["params"]["w"].placements]
out["w_equal"] = bool(torch.equal(tree["params"]["w"].full_tensor(), w))
out["b_type"] = type(tree["params"]["b"]).__name__
out["b_equal"] = bool(torch.equal(tree["params"]["b"], b))
got = ckpt.restore_latest(d, {"params": {"w": w, "b": b}},
                          {"params": {"w": (mesh, P(None, "model")),
                                      "b": (mesh, P())}})
out["latest"] = [got[2], [str(p) for p in got[0]["params"]["w"].placements],
                 bool(torch.equal(got[0]["params"]["b"].full_tensor(), b))]
# restore_phi under the serving spec
phi = torch.from_numpy(rng.gamma(0.3, 20.0, (150, 16)).astype(np.float32))
ckpt.save(d, 3, {"state": {"phi_acc": phi, "m": torch.tensor(3)}},
          extra={"next_m": 3})
spec = phi_serving_spec(mesh, phi)
out["spec"] = list(spec)
got, _, step = ckpt.restore_phi(d, sharding=(mesh, spec))
out["phi"] = [type(got).__name__, [str(p) for p in got.placements],
              bool(torch.equal(got.full_tensor(), phi)), step]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_restore_with_shardings_places_dtensors_on_a_mesh(tmp_path):
    """``tests/test_checkpoint.py:75-86``'s remesh path in the port: a
    restore with ``shardings`` (the template's structure, a (DeviceMesh,
    spec) pair or None a leaf) gives DTensors equal to what was saved;
    ``restore_latest`` passes them through; ``restore_phi`` places phi by
    ``phi_serving_spec`` (a gloo group of one, in a process of its own)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _SHARDED_RESTORE], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["w_type"] == "DTensor" and out["w_equal"]
    assert out["w_placements"] == ["S(0)", "R"]
    assert out["b_type"] == "Tensor" and out["b_equal"]
    assert out["latest"] == [2, ["R", "S(1)"], True]
    assert out["spec"] == [None, "model"]
    assert out["phi"] == ["DTensor", ["R", "S(1)"], True, 3]

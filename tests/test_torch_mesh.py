"""The port's mesh execution (``torch.distributed`` over a ``DeviceMesh``,
one process a mesh position, gloo on the CPU) held against the JAX
package: the mesh body ``make_mesh_shard_fn`` on a 2 x 2 ``("data",
"model")`` mesh against the reference's body under two nested vmaps named
``"data"`` and ``"model"`` (the same psums shard_map binds, on one CPU
device); and the training driver's ``--backend shard_map``: a 2 x 2 run
to its end with the model-axis phases in its ``[comm]`` line, a 1 x 1
mesh equal to ``--shards 1`` bit for bit, crash-resume through the mesh.

Every rank draws the same init (the reference draws one replicated key
under shard_map); the test injects the reference's draw.  Tolerances as
``test_torch_multishard.py``: float32 rtol 1e-4, ``iters`` exact, bytes
exact.  The spawned tests take a few seconds each (a process a rank)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from repro.core import pobp as jp
from repro.core.types import LDAConfig as JConfig
from repro.data import bucketed_minibatch_stream as j_bucketed
from repro.data import lda_corpus
from repro.launch import lda_train as jcli
from repro_torch.launch import lda_train as cli
from repro_torch.launch import mesh as tmesh

import torch_mesh_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, K = 120, 8
BASE = dict(vocab_size=W, num_topics=K, lambda_w=0.3, lambda_k_abs=3,
            inner_iters=8, residual_tol=1e-6)


def _reference_grid_run(jcfg, sync, sync_dtype, stream):
    """The reference's mesh body under nested vmaps over ``stream``, from
    phi_acc = 0: per batch (global phi_acc, iters, mean_r), the injected
    draws, and the meter."""
    local, jmeter = jp.make_mesh_shard_fn(jcfg, ("data", "model"), sync,
                                          jnp.dtype(sync_dtype))

    def per_data(wid, cnt, phi_shards, key, w):
        return jax.vmap(local, in_axes=(None, None, 0, None, None),
                        axis_name="model")(wid, cnt, phi_shards, key, w)

    ref = jax.jit(jax.vmap(per_data, in_axes=(0, 0, None, None, None),
                           axis_name="data"))
    jphi = jnp.zeros((2, W, K // 2))
    batches, want = [], []
    for i, b in enumerate(stream):
        key = jax.random.PRNGKey(20 + i)
        _, Dl, L = b.word_ids.shape
        u0 = jax.random.uniform(key, (Dl, L, K // 2), minval=0.01,
                                maxval=1.0)
        new, iters, mean_r = ref(b.word_ids, b.counts, jphi, key,
                                 jnp.float32(1.0))
        jphi = new[0]
        want.append((np.concatenate([np.asarray(new)[0, 0],
                                     np.asarray(new)[0, 1]], axis=1),
                     int(np.asarray(iters)[0, 0]),
                     float(np.asarray(mean_r)[0, 0])))
        batches.append(tuple(torch.from_numpy(np.array(x))
                             for x in (b.word_ids, b.counts, u0)))
    return want, batches, jmeter


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.mark.parametrize("sync,sync_dtype", [
    ("power", "float32"), ("dense", "float32"), ("power", "bfloat16")])
def test_gloo_grid_matches_reference_nested_vmap(tmp_path, sync,
                                                 sync_dtype):
    """Four gloo ranks of a 2 x 2 mesh run ``make_mesh_shard_fn`` over two
    mini-batches of two length buckets; the reference runs its mesh body
    under nested vmaps.  Every rank ends each batch with the same
    iterations and mean_r (the loop's decision is taken from all-reduced
    values, which gloo hands every rank bit for bit), the data shards of
    one topic shard with identical statistics, the statistics within rtol
    1e-4 of the reference's (bf16 sync: within the budget of
    ``test_torch_multishard.py``, gloo summing the bf16 payloads), and
    each rank's meter equal to the reference's."""
    jcfg = JConfig(**BASE, sweep_policy="dense_layout")
    docs = lda_corpus(0, 64, W, K, doc_len_mean=50)[0]
    stream = list(j_bucketed(docs[16:48], 16, num_shards=2,
                             len_buckets=(32, 64), prefetch=0))
    assert len({b.word_ids.shape[-1] for b in stream}) == 2
    want, batches, jmeter = _reference_grid_run(jcfg, sync, sync_dtype,
                                                stream)
    torch.save({"cfg": BASE, "phi": torch.zeros((W, K)),
                "batches": batches}, tmp_path / "inputs.pt")
    tmp_mp.start_processes(torch_mesh_ranks.grid_rank,
                           args=(4, str(tmp_path), sync, sync_dtype),
                           nprocs=4, join=True, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    by_coord = {r["coord"]: r for r in ranks}
    f32 = (None if sync_dtype == "float32" else
           _reference_grid_run(jcfg, sync, "float32", stream)[0])
    for i, (jphi_i, jiters, jmean) in enumerate(want):
        assert len({r["out"][i][1] for r in ranks}) == 1
        assert len({r["out"][i][2] for r in ranks}) == 1
        for m in range(2):
            assert torch.equal(by_coord[(0, m)]["out"][i][0],
                               by_coord[(1, m)]["out"][i][0])
        phi = torch.cat([by_coord[(0, 0)]["out"][i][0],
                         by_coord[(0, 1)]["out"][i][0]], dim=1).numpy()
        if f32 is None:
            assert ranks[0]["out"][i][1] == jiters
            np.testing.assert_allclose(phi, jphi_i, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(ranks[0]["out"][i][2], jmean,
                                       rtol=1e-4)
        else:       # the budget of test_torch_multishard.py
            assert _rel(phi, jphi_i) <= 3 * _rel(jphi_i, f32[i][0])
    for r in ranks:
        assert r["bytes"] == jmeter.bytes_by_phase
        assert r["per_minibatch"] == [jmeter.per_minibatch_bytes(i)
                                      for i in (1, 4)]


def test_driver_shard_map_backend_smoke():
    """The reference's ``test_driver_shard_map_backend_smoke``, on the
    port: one command starts the 2 x 2 mesh (four gloo processes on the
    CPU), runs to its end, and prints the model-axis phases; every rank
    ends with the same iterations and mean_r."""
    env = dict(os.environ,
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lda_train",
         "--backend", "shard_map", "--mesh-shape", "2,2", "--device", "cpu",
         "--minibatches", "2", "--docs-per-batch", "16", "--vocab", "64",
         "--topics", "8", "--lambda-k", "4", "--inner-iters", "3",
         "--log-every", "1", "--no-warmup-buckets"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[done] 2 minibatches" in out.stdout
    assert "model_norm" in out.stdout and "model_rw" in out.stdout
    assert "model_rw_loop" in out.stdout
    assert "[mesh] 4 ranks over gloo: iters and mean_r equal on every " \
        "rank: True" in out.stdout
    # rank 0 alone prints its per-batch lines
    assert out.stdout.count("minibatch     1  mean_r") == 1


def _args(*extra):
    return cli.build_parser().parse_args(
        ["--minibatches", "3", "--docs-per-batch", "16", "--vocab", "64",
         "--topics", "8", "--lambda-k", "4", "--inner-iters", "5",
         "--log-every", "0", "--device", "cpu", *extra])


def test_one_by_one_mesh_equals_one_shard_bit_for_bit():
    """A 1 x 1 mesh runs what ``--backend sim --shards 1`` runs with the
    same seed (the same draws, the all-reduces identities, ``bp_update``
    for the dense sweep of one topic shard): mean_r, iterations and
    phi_acc equal bit for bit."""
    a = cli.train_loop(_args("--shards", "1"))
    b = cli.train_loop(_args("--backend", "shard_map", "--mesh-shape", "1,1"))
    assert a["mean_r"] == b["mean_r"] and a["iters"] == b["iters"]
    assert torch.equal(a["phi_acc"], b["phi_acc"])
    (rank,) = b["ranks"]
    assert rank["iters"] == b["iters"] and rank["mean_r"] == b["mean_r"]
    assert set(rank["launches"]) >= {"bp_update", "topic_sum"}


def test_mesh_crash_resume_restores_each_ranks_columns(tmp_path):
    """``--crash-at`` through the mesh ends the command by SystemExit;
    rank 0's checkpoint holds the global [W, K] phi_acc; the rerun
    resumes every rank from its columns and ends equal to the
    uninterrupted mesh run bit for bit."""
    from repro_torch.dist import checkpoint as ckpt

    grid = ("--backend", "shard_map", "--mesh-shape", "2,2")
    full = cli.train_loop(_args(*grid))
    run = _args(*grid, "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
                "--crash-at", "2")
    with pytest.raises(SystemExit, match="simulated crash"):
        cli.train_loop(run)
    phi, extra, step = ckpt.restore_phi(str(tmp_path))
    assert step == 1 and tuple(phi.shape) == (64, 8)
    again = cli.train_loop(run)
    assert again["first_m"] == 1
    assert again["mean_r"] == full["mean_r"][1:]
    assert torch.equal(again["phi_acc"], full["phi_acc"])


def test_mesh_chip_count():
    assert tmesh.mesh_chip_count(type("M", (), {"shape": (2, 16, 16)})) == 512


def test_production_mesh_needs_its_ranks():
    """As the reference's: the (16, 16) and (2, 16, 16) meshes raise when
    the world is smaller (here: no process group, one process)."""
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs (256|512) ranks"):
            tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        cli.train_loop(_args("--backend", "shard_map", "--mesh-shape", "2,2",
                             "--dist-backend", "nccl"))
    with pytest.raises(ValueError, match="'data,model' or 'pod,data,model'"):
        cli.train_loop(_args("--backend", "shard_map", "--mesh-shape", "4"))
    assert cli._mesh_dims(_args("--mesh", "multi")) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert cli._mesh_dims(jcli.default_args(mesh_shape="4,2")) == (
        (4, 2), ("data", "model"))

"""The port's dry run (``repro_torch.launch.dryrun``) held against the
reference's (``repro.launch.dryrun``): ``n_params``, ``n_active_params``,
``grad_accum_steps`` (both production meshes, every shape) and
``probe_plan`` for all ten architectures, exact; then the port's own runs
on a fake process group (each in a process of its own: the group is
process global, and the reference's module sets a 512-device XLA flag
when imported): ``run_cell`` and ``main`` at the smoke shapes on a fake
2 x 2 mesh (every family, a skipped cell, the record's keys with no torch
counterpart saying so), the smollm-360m record's three parity values at
full width (params 361,821,120, chips 256, model FLOPs 8,892,115,845,120,
as ``benchmarks/results/dryrun/smollm-360m__train_4k__single.json``), and
``run_lda_cell`` at a small W and K against the ring bytes of its psums
and ``core/sync.py``'s formulas."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _run(code: str, timeout=900) -> dict:
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=ENV,
                         timeout=timeout, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


_REFERENCE = r"""
import dataclasses, json
import jax
from repro.configs import ARCH_IDS, get_config
from repro.configs.base import SHAPES
from repro.launch import dryrun as d
from repro.models import registry

class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}

class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}

out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    mod = registry.build(cfg)
    total = d.n_params(jax.eval_shape(lambda k: mod.init(k, cfg),
                                      jax.random.PRNGKey(0)))
    mk, counts = d.probe_plan(cfg)
    out[arch] = {
        "total": total, "active": d.n_active_params(cfg, total),
        "accum": {f"{s}/{m}": d.grad_accum_steps(cfg, SHAPES[s], mesh)
                  for s in SHAPES
                  for m, mesh in (("16x16", FakeMesh()),
                                  ("2x16x16", FakePodMesh()))},
        "dp": [d._dp_size(FakeMesh()), d._dp_size(FakePodMesh())],
        "probe": [list(counts)] + [
            [mk(c).n_layers, mk(c).enc_layers, mk(c).scan_layers]
            for c in counts[:2]],
    }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    return _run(_REFERENCE)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_accum_and_probe_plan_equal_the_references(reference, arch):
    want = reference[arch]
    cfg = get_config(arch)
    total = dryrun.n_params(registry.build(cfg).init(cfg, seed=0,
                                                     device="meta"))
    assert total == want["total"]
    assert dryrun.n_active_params(cfg, total) == want["active"]
    for s in SHAPES:
        for m, mesh in (("16x16", FakeMesh()), ("2x16x16", FakePodMesh())):
            assert dryrun.grad_accum_steps(cfg, SHAPES[s], mesh) == \
                want["accum"][f"{s}/{m}"], (s, m)
    assert [dryrun._dp_size(FakeMesh()), dryrun._dp_size(FakePodMesh())] == \
        want["dp"]
    mk, counts = dryrun.probe_plan(cfg)
    assert [list(counts)] + [[mk(c).n_layers, mk(c).enc_layers,
                              mk(c).scan_layers] for c in counts[:2]] == \
        want["probe"]


_PORT = r"""
import io, json, contextlib, tempfile, os
from repro_torch.launch import dryrun as d

out = {}
mesh = d.dryrun_mesh("single", (2, 2))
cells = [("smollm-360m", "train_4k"), ("smollm-360m", "decode_32k"),
         ("olmoe-1b-7b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
         ("mamba2-780m", "long_500k"), ("zamba2-2.7b", "prefill_32k"),
         ("llama-3.2-vision-11b", "prefill_32k"),
         ("seamless-m4t-medium", "train_4k"), ("qwen2-72b", "long_500k")]
for arch, shape in cells:
    out[f"{arch}/{shape}"] = d.run_cell(arch, shape, "single", mesh=mesh,
                                        smoke=True)
tmp = tempfile.mkdtemp()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    d.main(["--arch", "granite-3-2b", "--shape", "prefill_32k", "--smoke",
            "--mesh-shape", "2,2", "--out", tmp])
    d.main(["--arch", "granite-3-2b", "--shape", "prefill_32k", "--smoke",
            "--mesh-shape", "2,2", "--out", tmp])
out["main_stdout"] = buf.getvalue()
out["main_files"] = sorted(os.listdir(tmp))
with open(os.path.join(tmp, out["main_files"][0])) as f:
    out["main_record"] = json.load(f)
for mode in ("power", "dense"):
    out[f"lda/{mode}"] = d.run_lda_cell(16, "single", mode, D_m=32, L=16,
                                        W=300, mesh=mesh)
full = d.run_cell("smollm-360m", "train_4k", "single", probes=False)
out["full"] = {k: full[k] for k in ("status", "params_total",
                                    "params_active", "chips", "model_flops",
                                    "state_bytes_per_device")}
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def port_runs():
    return _run(_PORT)


def test_run_cell_at_the_smoke_shapes_on_a_fake_two_by_two_mesh(port_runs):
    for key, rec in port_runs.items():
        if "/" not in key or key.startswith("lda/"):
            continue
        if key == "qwen2-72b/long_500k":
            assert rec["status"].startswith("skipped (full attention")
            continue
        assert rec["status"] == "ok", (key, rec["status"])
        assert rec["chips"] == 4
        for name in ("compile_s", "scan_counted_once", "hlo_flops",
                     "hlo_bytes"):
            assert rec[name].startswith("no torch counterpart"), name
        assert rec["memory"]["available"] is False
        assert rec["counted_flops"] > 0 and rec["counted_bytes_unfused"] > 0
        assert rec["counted_collective_bytes"]["total"] > 0
        assert rec["probe_counts"][:2] == [1, 2]
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["compute_s"] == rec["counted_flops"] / 989.4e12
        assert rec["model_flops"] > 0 and rec["useful_flop_ratio"] > 0
        state = rec["state_bytes_per_device"]
        assert state["total"] == sum(v for k, v in state.items()
                                     if k != "total") > 0
        assert ("adamw" in state) == key.endswith("train_4k")
        assert ("cache" in state) == (key.endswith("decode_32k")
                                      or key.endswith("long_500k"))


def test_main_writes_the_record_and_prints_the_references_lines(port_runs):
    out = port_runs["main_stdout"].splitlines()
    tag = "granite-3-2b__prefill_32k__single"
    assert out[0] == f"[dryrun] {tag} ..."
    assert out[1].startswith(f"[done] {tag}: ok dominant=")
    assert out[2] == f"[skip existing] {tag}"
    assert port_runs["main_files"] == [tag + ".json"]
    rec = port_runs["main_record"]
    assert rec["arch"] == "granite-3-2b" and rec["status"] == "ok"
    assert rec["hlo_flops"].startswith("no torch counterpart")


def test_the_smollm_record_at_full_width(port_runs):
    full = port_runs["full"]
    assert full["status"] == "ok"
    assert full["params_total"] == full["params_active"] == 361_821_120
    assert full["chips"] == 256
    assert full["model_flops"] == 8_892_115_845_120
    # params, AdamW state and batch: the reference record's
    # argument_size_in_bytes (21,181,572)
    assert full["state_bytes_per_device"]["total"] == 21_181_572


@pytest.mark.parametrize("mode", ["power", "dense"])
def test_run_lda_cell_at_a_small_width(port_runs, mode):
    """W = 300, K = 16 over a 2 x 2 mesh (8 topics a rank): the loop's
    bytes are its psums' ring bytes (G = 2: an all-reduce moves its
    payload once), the analytic key is core/sync.py's formula."""
    from repro_torch.core.sync import dense_sync_bytes, power_sync_bytes

    rec = port_runs[f"lda/{mode}"]
    assert rec["status"] == "ok" and rec["chips"] == 4
    P, Pk = rec["cfg"]["P"], rec["cfg"]["Pk"]
    W, Kl = 300, 8
    assert (P, Pk) == (30, 16)
    if mode == "power":
        # the packed d and r over the data axis (a rank's Pk: at most its
        # 8 topics), rw_delta [P] over the model axis
        loop = 2 * P * min(Pk, Kl) * 4 + P * 4
        assert rec["analytic_loop_bytes_per_iter"] == \
            power_sync_bytes(P, Pk, W)
    else:
        # the dense scatter and r over the data axis, the [W] residual and
        # the [Dl, L, 1] normalizer (16 x 16 documents) over the model axis
        loop = 2 * W * Kl * 4 + W * 4 + 16 * 16 * 4
        assert rec["analytic_loop_bytes_per_iter"] == \
            2 * dense_sync_bytes(W, Kl)
    assert rec["loop_coll_bytes_per_iter"] == loop
    assert rec["minibatch_coll_bytes_T200"] == \
        rec["once_coll_bytes"] + 199 * loop
    assert rec["hlo_flops_per_iter"].startswith("no torch counterpart")
    assert rec["probe_iters"] == [1, 3]


_FALLBACK = r"""
import json
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun as d

mesh = d.dryrun_mesh("single", (2, 2))
x = distribute_tensor(torch.empty(4, 30, device="meta"), mesh,
                      [Replicate(), Shard(1)])
w = distribute_tensor(torch.empty(7, 5, device="meta"), mesh,
                      [Replicate(), Replicate()])
out = {}
fb = d.ReplicateFallback()
with fb:
    out["view"] = list(x.view(4, 15, 2).shape)
out["view_fallbacks"] = fb.ops
fb, counter = d.ReplicateFallback(), d.CostCounter()
try:
    with counter, fb:
        x @ w
    out["mm"] = "ran"
except RuntimeError as e:
    out["mm"] = str(e).splitlines()[0]
out["mm_fallbacks"], out["mm_collectives"] = fb.ops, counter.collectives
print(json.dumps(out))
"""


def test_the_fallback_takes_dtensors_refusals_and_nothing_else():
    """A view that splits a dim sharded over 2 ranks into 15 x 2 is
    DTensor's refusal (an uneven unflatten): it runs again with the
    batch dim kept and is named.  A matmul of mismatched shapes is the
    op's own fault: it is raised as it is, with nothing replicated and
    no collective issued for it."""
    out = _run(_FALLBACK, timeout=300)
    assert out["view"] == [4, 15, 2]
    assert out["view_fallbacks"] == {"aten::view (batch dim kept)": 1}
    assert out["mm"].startswith("a and b must have same reduction dim")
    assert out["mm_fallbacks"] == {} and out["mm_collectives"] == []

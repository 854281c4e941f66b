"""The plain references agree with the port's CPU path at a tiny W and K,
and import nothing of the port or of the JAX package; no module of the
JAX stack or package is loaded by a run."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
import torch

import pbtiny
from portbench import gen, harness
from portbench.reference import pobp


def _model_and_batch(W=300, K=12, D=16, L=12, seed=5):
    g = torch.Generator().manual_seed(seed)
    phi_true, phi_acc = gen.make_model(g, W, K, conc=0.06, zipf=1.0,
                                       scale=2e5)
    lens = gen.doc_lengths(g, D, mean=14, sigma=0.5, minimum=4)
    docs = gen.make_docs(g, phi_true, lens, theta_conc=0.15)
    wid, cnt = gen.padded(docs, 0, D, L)
    return phi_acc, wid, cnt, g


CFG = dict(alpha=0.1, beta=0.01, lambda_w=0.1, lambda_k_abs=4,
           inner_iters=40, residual_tol=0.1)


def test_pobp_reference_agrees_with_the_port_step():
    from repro_torch.core.pobp import make_train_step
    from repro_torch.core.types import LDAConfig, LDATrainState

    phi_acc, wid, cnt, _ = _model_and_batch()
    W, K = phi_acc.shape
    D, L = wid.shape
    cfg = LDAConfig(vocab_size=W, num_topics=K, **CFG)
    step, _ = make_train_step(cfg, device="cpu")
    state = LDATrainState(phi_acc=phi_acc.clone(), m=0,
                          generator=torch.Generator().manual_seed(9))
    new_state, diag = step(state, wid, cnt)
    mu0 = pobp.init_messages(torch.Generator().manual_seed(9), D, L, K)
    new, theta, iters = pobp.minibatch(phi_acc, wid, cnt, mu0, CFG)
    assert iters == diag["iters"] > 1
    delta = (new - phi_acc).abs().sum()
    assert float((new_state.phi_acc - new).abs().sum() / delta) < 1e-5
    torch.testing.assert_close(diag["theta"], theta, rtol=1e-4, atol=1e-4)
    # rows of words outside the batch are left exactly as they were
    out = torch.ones(W, dtype=torch.bool)
    out[wid[cnt > 0].long()] = False
    assert torch.equal(new[out], phi_acc[out])


def test_pobp_reference_bf16_control_departs():
    phi_acc, wid, cnt, _ = _model_and_batch()
    D, L = wid.shape
    K = phi_acc.shape[1]
    mu0 = pobp.init_messages(torch.Generator().manual_seed(9), D, L, K)
    f32, _, _ = pobp.minibatch(phi_acc, wid, cnt, mu0, CFG)
    bf16, _, _ = pobp.minibatch(phi_acc, wid, cnt, mu0, CFG,
                                dtype=torch.bfloat16)
    delta = (f32 - phi_acc).abs().sum()
    assert float((bf16 - f32).abs().sum() / delta) > 1e-2


def test_training_run_follows_the_reference():
    rec = pbtiny.run("pubmed-k2000.train", seconds=0.3)
    got = {k: v["value"] for k, v in rec["check"]["compared"].items()}
    assert got["phi_gap"] < 1e-5 and got["theta_gap"] < 1e-4
    assert got["untouched_changed"] == 0
    assert rec["check"]["correct"]


@pytest.mark.parametrize("path", sorted(
    (harness.ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro",
                                           "repro_torch"), (path, n)


def test_a_run_loads_no_module_of_the_jax_stack():
    code = (
        "import sys; sys.path.insert(0, %r); import pbtiny\n"
        "from portbench import harness\n"
        "pbtiny.run('pubmed-k2000.train', seconds=0.2)\n"
        "print('LOADED', harness.forbidden_modules())\n"
        "print('PORT', 'repro_torch' in sys.modules)\n"
    ) % str(harness.ROOT / "tests")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
    assert "PORT True" in out.stdout


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    found = harness.forbidden_modules()
    assert "repro_torch_lookalike" not in found
    assert "jaxtyping_like" not in found
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()

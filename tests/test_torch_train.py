"""The port's LM trainer (``repro_torch.launch.train``) against the JAX
package's ``repro.launch.train``, at reduced smollm-360m with two data
shards in lockstep, batch 4, seq 16.

- Parity: the reference's own params injected, 10 steps beside the
  reference's ``main`` with the same flags: each step's loss within 2e-2
  absolute (bf16 params on both sides; two frameworks round apart), the
  bytes a step by phase equal.
- Crash-resume in the port: bit for bit on the CPU.
- Cross-package resume: a checkpoint the reference's trainer wrote resumes
  in the port, the next losses within the same 2e-2 of the reference's
  uninterrupted run; the keys the port writes are the reference's.
- The reference's convergence test (``tests/test_powersync.py``), ported.
- The VLM and enc-dec ids are refused; the default device is the card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist import checkpoint as ref_ckpt
from repro.launch.train import main as ref_main
from repro.models import registry as ref_registry
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.powersync import residual_init as ref_residual_init

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import train

from torch_lm_pairs import one_torch_thread

BASE = ["--arch", "smollm-360m", "--reduced", "--steps", "10", "--batch",
        "4", "--seq", "16", "--shards", "2", "--sync", "power",
        "--log-every", "100", "--ckpt-every", "4"]
TOL = 2e-2


def port_args(argv):
    return train.build_parser().parse_args(argv + ["--device", "cpu"])


def ref_params(arch="smollm-360m", seed=0):
    cfg = ref_config(arch).reduced()
    params = ref_registry.build(cfg).init(jax.random.PRNGKey(seed), cfg)
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), get_config(arch).reduced(),
        device="cpu")


def manifest_keys(directory, step):
    with open(os.path.join(directory, f"step_{step:07d}",
                           "manifest.json")) as f:
        return [rec["key"] for rec in json.load(f)["leaves"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's uninterrupted run and its crash at step 8 (a
    checkpoint at 4); the port's run from the reference's params, its own
    crash at 8 and resume, and its resume of the reference's checkpoint."""
    with one_torch_thread():
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    out = {}
    out["ref"] = ref_main(BASE)
    ref_dir = str(tmp_path_factory.mktemp("ref_ck"))
    with pytest.raises(SystemExit):
        ref_main(BASE + ["--ckpt-dir", ref_dir, "--crash-at", "8"])
    out["ref_dir"] = ref_dir

    out["port"] = train.train_loop(port_args(BASE), params=ref_params())
    port_dir = str(tmp_path_factory.mktemp("port_ck"))
    with pytest.raises(SystemExit, match="simulated crash"):
        train.train_loop(port_args(BASE + ["--ckpt-dir", port_dir,
                                           "--crash-at", "8"]),
                         params=ref_params())
    out["port_dir"] = port_dir
    out["keys"] = manifest_keys(port_dir, 4)
    out["resumed"] = train.train_loop(port_args(BASE + ["--ckpt-dir",
                                                        port_dir]))
    out["cross"] = train.train_loop(port_args(BASE + ["--ckpt-dir",
                                                      ref_dir]))
    return out


def test_losses_and_bytes_match_the_reference(runs):
    ref_losses, ref_meter = runs["ref"]
    losses, meter = runs["port"]
    assert len(losses) == len(ref_losses) == 10
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=TOL)
    assert meter.bytes_by_phase == ref_meter.bytes_by_phase
    assert set(meter.bytes_by_phase) == {"powersync_norms",
                                         "powersync_payload",
                                         "powersync_dense"}


def test_crash_resume_is_bit_for_bit(runs):
    resumed, _ = runs["resumed"]
    # resumed covers steps 4..9 (the crash at 8 came before its save)
    assert len(resumed) == 6
    assert resumed == runs["port"][0][4:]


def test_reference_checkpoint_resumes_in_the_port(runs):
    cross, _ = runs["cross"]
    assert len(cross) == 6
    np.testing.assert_allclose(cross, runs["ref"][0][4:], rtol=0, atol=TOL)


def test_checkpoint_keys_are_the_references(runs):
    assert runs["keys"] == manifest_keys(runs["ref_dir"], 4)
    assert "['opt'].step" in runs["keys"]
    assert runs["keys"][0] == "['opt'].master['embed']"


def test_trainer_state_keys_with_a_list_of_head_blocks(tmp_path):
    """DeepSeek's dense layer 0 sits in a list (``head_blocks``): the port
    writes the keys the reference's ``_flatten`` gives its trainer state
    (``jax.tree_util.keystr``), and the reference restores what the port
    wrote."""
    arch = "deepseek-v2-lite-16b"
    cfg = ref_config(arch).reduced()
    mod = ref_registry.build(cfg)

    def ref_state(key):
        params = mod.init(key, cfg)
        res = jax.tree.map(lambda r: jnp.broadcast_to(r, (2, *r.shape)),
                           ref_residual_init(params))
        params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        return {"params": params, "opt": ref_adamw_init(params),
                "residual": res}

    shapes = jax.eval_shape(ref_state, jax.random.PRNGKey(0))
    want = [k for k, _ in ref_ckpt._flatten(shapes)[0]]
    assert any("['head_blocks'][0]" in k for k in want)
    d = str(tmp_path)
    train.train_loop(port_args([
        "--arch", arch, "--reduced", "--steps", "1", "--batch", "2", "--seq",
        "8", "--shards", "2", "--ckpt-every", "1", "--ckpt-dir", d]))
    assert manifest_keys(d, 1) == want
    trees, extra, step = ref_ckpt.restore(d, 1, jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes))
    assert step == 1 and extra == {"next_step": 1, "seed": 0,
                                   "sync": "power"}
    assert int(trees["opt"].step) == 1


def test_crash_resume_with_float32_init_leaves(tmp_path):
    """mamba2-780m's A_log, D and dt_bias start float32 and are bf16 after
    a step (AdamW casts every master leaf): the port restores into a bf16
    template and resumes bit for bit.  The reference's trainer restores
    into its float32 init and refuses the checkpoint (a dtype mismatch)."""
    argv = ["--arch", "mamba2-780m", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "8", "--ckpt-every", "2", "--log-every", "100"]
    full, _ = train.train_loop(port_args(argv))
    d = str(tmp_path)
    with pytest.raises(SystemExit):
        train.train_loop(port_args(argv + ["--ckpt-dir", d, "--crash-at",
                                           "3"]))
    resumed, _ = train.train_loop(port_args(argv + ["--ckpt-dir", d]))
    assert resumed == full[2:]
    with pytest.raises(ValueError, match="dtype mismatch"):
        ref_main(argv + ["--ckpt-dir", d])


def test_training_converges_with_powersync():
    """The reference's convergence test, on the port: a tiny LM trained
    with PowerSync learns, ends close to dense sync, and sends under a
    quarter of the dense bytes."""
    args = ["--arch", "smollm-360m", "--reduced", "--steps", "40",
            "--batch", "8", "--seq", "32", "--shards", "2", "--log-every",
            "100"]
    with one_torch_thread():
        losses_p, meter_p = train.main(args + ["--sync", "power", "--device",
                                               "cpu"])
        losses_d, meter_d = train.main(args + ["--sync", "dense", "--device",
                                               "cpu"])
    assert losses_p[-1] < losses_p[0] - 0.3          # it learns
    assert losses_p[-1] < losses_d[-1] + 0.6         # close to dense
    payload = meter_p.phase_bytes("powersync_payload")
    dense = meter_d.phase_bytes("dense_grads")
    assert payload < 0.25 * dense, (payload, dense)  # >4x comm reduction


@pytest.mark.parametrize("arch,what", [("llama-3.2-vision-11b",
                                        "image_embeds"),
                                       ("seamless-m4t-medium", "frames")])
def test_vlm_and_audio_ids_are_refused(arch, what):
    with pytest.raises(ValueError, match=what):
        train.main(["--arch", arch, "--reduced", "--steps", "1",
                    "--device", "cpu"])


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--reduced", "--steps", "1"])

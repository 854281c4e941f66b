"""The LM cells' driver, reference, faults, work counts and metric readers
at a tiny size on the CPU (``lmtiny.py``), as ``pbtiny.py`` drives the
POBP cells; each planted fault of ``lm_faults.py`` fails the cell's limits,
and so does the control (the reference in float8 in the program's place).
One ``cuda``-marked case runs the cell's own step at its published widths
for 2 checked steps against the reference; it skips without a card."""

from __future__ import annotations

import dataclasses
import time

import pytest

import lmtiny
from portbench import check, harness, lm_faults, lm_work
from portbench.drivers import lm_train

CELLS = lmtiny.CELLS


def test_the_lm_cell_is_found_and_mapped():
    assert CELLS == ["deepseek-v2-lite-ep4.train"]
    spec = harness.cell_spec(CELLS[0])
    cfg = lm_train.arch_config(spec["config"])
    assert (cfg.n_layers, cfg.dense_first_n, cfg.vocab_size) == (5, 1, 25600)
    assert (cfg.d_model, cfg.n_heads, cfg.d_ff) == (2048, 16, 10944)
    m = cfg.moe
    assert (m.num_experts, m.n_held, m.top_k, m.d_expert, m.num_shared) == \
        (64, 16, 6, 1408, 2)
    assert m.dropless and not m.norm_topk_prob
    assert cfg.norm_eps == 1e-6 and cfg.rope_scaling.factor == 40.0
    assert spec["config"]["reduced"] == ["n_layers", "experts_held",
                                         "vocab_size"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "step_mfu.lm_train", "device.idle_pct.lm_train",
        "moe_experts_roofline", "mla_attend_roofline"}


def test_a_program_without_the_settings_is_refused(monkeypatch):
    from repro_torch import configs
    monkeypatch.delattr(configs, "YaRNSpec")
    with pytest.raises(RuntimeError):
        lm_train.arch_config(harness.cell_spec(CELLS[0])["config"])


def test_the_full_width_cell_is_refused_on_the_cpu():
    spec = harness.cell_spec(CELLS[0])
    with pytest.raises(ValueError):
        harness.driver("lm_train").run(spec, seed=1, seconds=0.1,
                                       trace_on=False, device="cpu",
                                       t_start=time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_reports(cell):
    rec = lmtiny.run(cell, trace_on=True)
    assert rec["check"]["correct"], rec["check"]
    assert set(rec["end_to_end"]) == {"train_tokens_per_s", "peak_mem_gib",
                                      "setup_s"}
    lm = rec["lm"]
    assert lm["steps"] and lm["traced"]
    assert len(lm["counters"]) == len(lm["traced"])
    assert all(c["dropped"] == 0 and c["moe_rows"] > 0
               for c in lm["counters"])
    rec["device"] = {"platform": "cpu"}         # run.py adds the card's
    line = harness.result_line(lmtiny.spec(cell), rec, trace=True)
    # no device on the CPU: the readers of device time leave their metrics
    # out, the window's share of the peak is read from the host clock
    assert set(line["metrics"]) == {"step_mfu.lm_train"}
    assert list(line["compared"]) == [
        "loss_gap", "grad_gap", "close_grad_gap", "route_flips", "sync_gap",
        "adamw_gap", "dropped"]


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    rec = lmtiny.run(cell)
    rec["device"] = {"platform": "cpu"}
    spec = lmtiny.spec(cell)
    line = harness.result_line(spec, rec, trace=False)
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["correct"] is True and line["failed"] == 0
    for phase in ("start_imports_context", "model", "batches", "first_step",
                  "checked_steps"):
        assert f" {phase} " in rec["notes"][0]
    assert rec["notes"][1].startswith("window ")
    assert set(line["compared"]) == set(spec["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_specs_come_from_the_cells_files(cell):
    spec, full = lmtiny.spec(cell), harness.cell_spec(cell)
    assert spec["traffic"]["driver"] == "lm_train"
    assert spec["limits"] == full["limits"]
    assert {k: v for k, v in spec["config"].items()
            if k not in lmtiny.SMALL} == {
        k: v for k, v in full["config"].items() if k not in lmtiny.SMALL}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    rec = lmtiny.run(cell, control="float8")
    assert rec["check"]["correct"]
    limits = lmtiny.spec(cell)["limits"]
    assert not check.verdict(rec["check"]["control"], limits)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", lm_faults.FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    rec = lmtiny.run(cell, program=lm_faults.train_program(fault))
    assert not rec["check"]["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", lm_faults.FAULTS)
def test_a_fault_in_the_windows_steps_alone_is_not_correct(cell, fault):
    """The set-up steps sound, every step of the window and after it
    broken: the check of the step after the window fails the run (its
    loss, its gradients under the program's routing, its routing, its
    AdamW update, the held choices it dropped).  On the card, some 45
    steps in, renormalised gates read under every limit there (PERF.md)."""
    after = int(lmtiny.spec(cell)["params"]["checked_steps"])
    rec = lmtiny.run(cell, program=lm_faults.train_program(fault, after))
    assert not rec["check"]["correct"]


def test_a_vanished_layer_is_read_against_its_leaf():
    import torch
    path = ("stack", "attn", "wq")
    want = {path: torch.stack([torch.ones(4, 4), torch.full((4, 4), 1e-10)])}
    have = {path: want[path].clone()}
    have[path][1] += 1e-10                      # its own scale: a gap of 1
    assert lm_train.grad_gap(have, want, "cpu") < 1e-8
    have[path][0] *= 1.5                        # a layer that counts
    assert lm_train.grad_gap(have, want, "cpu") == pytest.approx(0.5)


def test_the_work_counts_at_the_published_widths():
    spec = harness.cell_spec(CELLS[0])
    cfg = lm_train.arch_config(spec["config"])
    s = lm_work.as_shape(lm_train.shape(cfg, spec["traffic"]))
    assert lm_work.attention_params(s) == 13_762_560          # MLA 13.76 M
    rows = s.tokens * 6 * 16 / 64 * s.n_moe                   # on average
    per_token = lm_work.forward_flops(s, rows) / s.tokens
    matmul = 2 * lm_work.token_params(s) + lm_work.expert_flops(s, rows) \
        / s.tokens
    assert 615e6 < matmul < 625e6
    assert 720e6 < per_token < 730e6
    assert lm_work.step_flops(s, rows) == pytest.approx(
        3 * per_token * s.tokens)


def _rec(steps=2, traced=2, experts_s=0.5, attend_s=0.25):
    cfg = lm_train.arch_config(harness.cell_spec(CELLS[0])["config"])
    shape = lm_train.shape(cfg, {"batch": 4, "seq": 4096})
    return {"lm": {"steps": [{"wall_s": 0.5, "tokens": 16384}] * steps,
                   "window_s": 0.5 * steps, "traced": [{}] * traced,
                   "counters": [{"moe_rows": 98304}] * traced,
                   "shape": shape},
            "trace": {"busy_s": 0.9, "window_s": 1.0,
                      "regions": {"lm.moe.experts": experts_s,
                                  "lm.mla.attend": attend_s}}}


def test_the_readers_read_the_counted_work():
    rec = _rec()
    s = lm_work.as_shape(rec["lm"]["shape"])
    got = {m: harness.metric_reader(m)(rec) for m in
           ("step_mfu.lm_train", "device.idle_pct.lm_train",
            "moe_experts_roofline", "mla_attend_roofline")}
    peak = lm_work.BF16_FLOPS_PER_S
    assert got["step_mfu.lm_train"] == pytest.approx(
        100 * lm_work.step_flops(s, 98304) / peak / 0.5)
    assert got["device.idle_pct.lm_train"] == pytest.approx(10.0)
    assert got["moe_experts_roofline"] == pytest.approx(
        100 * 2 * 2 * lm_work.expert_flops(s, 98304) / peak / 0.5)
    assert got["mla_attend_roofline"] == pytest.approx(
        100 * 2 * lm_work.attention_flops(s, 9) / peak / 0.25)
    # a record without the program's counters or regions leaves them out
    bare = _rec()
    bare["lm"]["counters"] = []
    bare["trace"]["regions"] = {}
    for m in ("step_mfu.lm_train", "moe_experts_roofline",
              "mla_attend_roofline"):
        assert harness.metric_reader(m)(bare) is None
        assert harness.metric_reader(m)({}) is None


@pytest.mark.cuda
def test_the_cells_step_at_published_widths_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    spec = harness.cell_spec(CELLS[0])
    spec["params"] = dict(spec["params"], checked_steps=2)
    rec = harness.driver("lm_train").run(
        spec, seed=lmtiny.SEED, seconds=0.5, trace_on=False,
        device="cuda:0", t_start=time.time())
    assert rec["check"]["correct"], rec["check"]["compared"]
    assert rec["check"]["compared"]["dropped"]["value"] == 0
    assert dataclasses.is_dataclass(lm_train.arch_config(spec["config"]))

"""The port's span and counter record (``repro_torch.obs``) around the POBP
training step: it records only while a torch profiler records, keeps each
recorded step whole (the span tree of ``core/pobp.py`` and the step's
counters), changes no bit of the step, tags lockstep shards, keeps a ring
of `obs.RING` steps, and stamps its spans on the profiler's clock.

The ``cuda``-marked cases repeat the clock check on the card and check
that no span reaches the profiler's device timeline; they skip without a
card (on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_obs.py``).  The file imports neither ``jax`` nor
``repro``.
"""

import gc

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
from unittest import mock

from repro_torch import obs
from repro_torch.core import pobp, power
from repro_torch.core.types import LDAConfig
from repro_torch.data.batching import docs_to_padded
from repro_torch.data.synthetic import lda_corpus

W, K, PK = 300, 16, 4
NAMES = {"pobp.step", "pobp.iter", "pobp.select", "pobp.sweep",
         "pobp.refresh", "pobp.read"}


def _cfg(**kw):
    base = dict(vocab_size=W, num_topics=K, lambda_k_abs=PK, inner_iters=12,
                residual_tol=0.01)
    return LDAConfig(**{**base, **kw})


def _batch(seed=1, D=32):
    docs, _, _ = lda_corpus(seed, D, W, K, doc_len_mean=40)
    return docs_to_padded(docs, max_len=32)


def _profiled(fn, device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return prof, out


@pytest.fixture(autouse=True)
def _empty_record():
    obs.clear()
    yield
    obs.clear()


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (on the card: pytest -m cuda)")
    return device


def test_recording_follows_the_profilers_flag():
    assert obs.recording() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.recording() is True
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert obs.recording() is False


def test_off_a_step_records_nothing():
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _batch()
    step(pobp.init_train_state(cfg, device="cpu"), mb.word_ids, mb.counts)
    assert obs.steps() == []
    assert obs.active() is None


def _check_tree(rec, shards=(0,)):
    spans = rec.spans
    assert spans[0].name == "pobp.step" and spans[0].parent == -1
    assert {s.name for s in spans} <= NAMES
    for s in spans:
        assert s.step == rec.id and s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for n in shards:
        mine = [s for s in spans if s.shard == n and s.parent >= 0]
        top = [s.name for s in mine if s.parent == 0]
        assert set(top) <= {"pobp.iter", "pobp.read"}
        yield n, spans, mine


@pytest.mark.parametrize("sync_mode", ["power", "dense"])
def test_a_profiled_step_records_its_span_tree_and_counters(sync_mode):
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, sync_mode=sync_mode, device="cpu")
    mb = _batch()
    _, (_, diag) = _profiled(lambda: step(
        pobp.init_train_state(cfg, device="cpu"), mb.word_ids, mb.counts))
    [rec] = obs.steps()
    c = rec.counters
    assert c["iters"] == diag["iters"] > 1
    assert c["selective_iters"] == (c["iters"] - 1 if sync_mode == "power"
                                    else 0)
    assert c["tokens"] == int((mb.counts > 0).sum())
    assert (c["P"], c["Pk"], c["K"]) == (cfg.num_power_words, PK, K)
    assert (c["power_tokens"] > 0) == (sync_mode == "power")
    [(_, spans, mine)] = list(_check_tree(rec))
    iters = [i for i, s in enumerate(spans) if s.name == "pobp.iter"]
    assert len(iters) == c["iters"] - 1
    for i in iters:
        children = [s.name for s in spans if s.parent == i]
        assert children == (["pobp.select", "pobp.sweep", "pobp.refresh"]
                            if sync_mode == "power" else [])
    # one read a check: none once the cap is reached
    reads = [s for s in mine if s.name == "pobp.read"]
    assert len(reads) == c["iters"] - (c["iters"] == cfg.inner_iters)
    # reads and iterations alternate, a read first
    top = [s.name for s in sorted(mine, key=lambda s: s.start_ns)
           if s.parent == 0]
    assert top[::2] == ["pobp.read"] * len(top[::2])
    assert top[1::2] == ["pobp.iter"] * len(top[1::2])


@pytest.mark.parametrize("policy", ["auto", "packed"])
def test_power_tokens_count_the_selected_words_counted_tokens(policy):
    cfg = _cfg(sweep_policy=policy)
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _batch(seed=5)
    seen = []
    real = power.select_power_words

    def spy(r_w, P):
        sel = real(r_w, P)
        seen.append(sel.clone())
        return sel

    with mock.patch.object(power, "select_power_words", spy):
        _profiled(lambda: step(pobp.init_train_state(cfg, device="cpu"),
                               mb.word_ids, mb.counts))
    [rec] = obs.steps()
    c = rec.counters
    words = mb.word_ids[mb.counts > 0].long()
    per_sweep = [int(torch.isin(words, sel.long()).sum()) for sel in seen]
    assert len(seen) == c["selective_iters"] > 0
    assert c["power_tokens"] == sum(per_sweep)
    # between the P rarest present words' tokens and all counted tokens
    per_word = torch.unique(words, return_counts=True)[1]
    rarest = int(torch.sort(per_word).values[:cfg.num_power_words].sum())
    assert rarest * len(seen) <= c["power_tokens"] <= c["tokens"] * len(seen)


def test_recording_changes_no_bit_of_the_step():
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _batch(seed=2)
    off_state, off = step(pobp.init_train_state(cfg, seed=3, device="cpu"),
                          mb.word_ids, mb.counts)
    _, (on_state, on) = _profiled(lambda: step(
        pobp.init_train_state(cfg, seed=3, device="cpu"), mb.word_ids,
        mb.counts))
    assert len(obs.steps()) == 1
    assert on["iters"] == off["iters"]
    assert torch.equal(on_state.phi_acc, off_state.phi_acc)
    assert torch.equal(on["theta"], off["theta"])
    assert torch.equal(on["mean_r"], off["mean_r"])


def test_a_recorded_step_keeps_its_spans_as_numbers():
    """A span leaves no object that the garbage collector tracks: such
    survivors set off its passes, which took ~0.3 s each under the
    profiler on an H100 machine (PERF.md §6)."""
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _batch(seed=7)
    state = pobp.init_train_state(cfg, device="cpu")
    state, _ = step(state, mb.word_ids, mb.counts)

    def one_step():
        gc.collect()
        gc.disable()
        try:
            before = len(gc.get_objects())
            out = step(state, mb.word_ids, mb.counts)
            return len(gc.get_objects()) - before, out
        finally:
            gc.enable()

    _, (grown, _) = _profiled(one_step)
    [rec] = obs.steps()
    assert len(rec.spans) > 40 and grown < 30, (len(rec.spans), grown)


def test_a_lockstep_step_tags_both_shards():
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, num_shards=2, device="cpu")
    mb = _batch(seed=3)
    D, L = mb.word_ids.shape
    _, (_, diag) = _profiled(lambda: step(
        pobp.init_train_state(cfg, device="cpu"),
        mb.word_ids.reshape(2, D // 2, L), mb.counts.reshape(2, D // 2, L)))
    [rec] = obs.steps()
    c = rec.counters
    assert c["iters"] == diag["iters"]
    assert c["tokens"] == int((mb.counts > 0).sum())
    got = list(_check_tree(rec, shards=(0, 1)))
    for _, spans, mine in got:
        assert sum(s.name == "pobp.iter" for s in mine) == \
            c["selective_iters"] > 0
    assert {s.shard for s in rec.spans if s.name == "pobp.sweep"} == {0, 1}


def test_the_record_keeps_the_last_ring_of_steps():
    cfg = _cfg(inner_iters=2)
    step, _ = pobp.make_train_step(cfg, device="cpu")
    mb = _batch(seed=4, D=8)

    def run(n):
        state = pobp.init_train_state(cfg, device="cpu")
        for _ in range(n):
            state, _ = step(state, mb.word_ids, mb.counts)

    _profiled(lambda: run(obs.RING + 6))
    got = obs.steps()
    assert obs.RING == 64 and len(got) == 64
    ids = [s.id for s in got]
    assert ids == list(range(ids[0], ids[0] + 64))
    assert all(s.spans[0].name == "pobp.step" for s in got)
    # a new stretch of recording, after a step with the profiler off,
    # starts the record anew; clear() empties it
    run(1)
    assert len(obs.steps()) == 64
    _profiled(lambda: run(2))
    assert [s.id for s in obs.steps()] == [ids[-1] + 1, ids[-1] + 2]
    obs.clear()
    assert obs.steps() == []


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_step_lies_inside_its_profiler_range_on_one_clock(device):
    """A recorded ``pobp.step`` lies inside the ``record_function`` range
    around it, the range converted through ``trace_start_ns()``, within
    0.5 ms; no span reaches the device timeline."""
    _device(device)
    cfg = _cfg()
    step, _ = pobp.make_train_step(cfg, device=device)
    mb = _batch(seed=6)
    state = pobp.init_train_state(cfg, device=device)
    state, _ = step(state, mb.word_ids, mb.counts)     # builds the kernels

    def traced():
        for _ in range(2):
            with record_function("outer.step"):
                _, diag = step(state, mb.word_ids, mb.counts)
                float(diag["mean_r"])

    prof, _ = _profiled(traced, device)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    ranges = sorted((base + 1e3 * e.time_range.start,
                     base + 1e3 * e.time_range.end) for e in events
                    if e.name == "outer.step"
                    and e.device_type == DeviceType.CPU)
    roots = [s.spans[0] for s in obs.steps()]
    assert len(ranges) == len(roots) == 2
    for (r0, r1), root in zip(ranges, roots):
        assert r0 - 5e5 <= root.start_ns and root.end_ns <= r1 + 5e5
    assert not [e.name for e in events if e.name.startswith("pobp.")]
    if device == "cuda":
        assert any(e.device_type == DeviceType.CUDA for e in events)

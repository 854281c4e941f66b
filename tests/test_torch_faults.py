"""The port's fault injection (``repro_torch.dist.faults``) and the
client's chaos hardening against the reference's (``repro.dist.faults``,
``tests/test_faults.py``).

``FaultPlan`` is pure numpy, so every fate, every validation message and a
``ChaosTransport``'s event log over one op script equal the reference's.
At ``--staleness 0`` the committed phi under any eventually-delivering
schedule (drops, duplicates, a partition, one crash and restart) equals
the clean run's bit for bit, and equals the reference's committed phi for
the same workload.  The retry backoff's exponent is clamped where the
reference's ``2.0 ** attempt`` overflows, and sleeps what the reference
sleeps below it.  The driver's chaos and elastic runs equal a clean PS run
bit for bit; its refusals are the reference's, word for word.

Every transport here has a short pull timeout and is closed, so a lost
push fails fast and no transport thread outlives its test.
"""

import threading
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.dist import faults as jfaults
from repro.dist import paramserver as jps
from repro.launch import lda_train as jcli
from repro_torch.dist import faults
from repro_torch.dist import paramserver as ps
from repro_torch.launch import lda_train as cli

TIMEOUT = 5.0


# -------------------------------------------------------------- FaultPlan

@pytest.mark.parametrize("seed", [0, 3, 7, 1000])
def test_fault_plan_decisions_equal_the_reference(seed):
    kw = dict(seed=seed, drop_push=0.3, drop_pull=0.4, dup_push=0.5,
              delay_prob=0.5, delay_s=0.1,
              partitions=(("push", 5, 9), ("pull", 2, 4)))
    mine, theirs = faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    for kind in ("push", "pull"):
        for i in range(200):
            a, b = mine.decide(kind, i), theirs.decide(kind, i)
            assert (a.drop, a.duplicate, a.delay_s) == \
                (b.drop, b.duplicate, b.delay_s)
            np.testing.assert_array_equal(
                faults._decision_bits(seed, kind, i),
                jfaults._decision_bits(seed, kind, i))
    assert mine.active == theirs.active
    fates = [mine.decide("push", i) for i in range(64)]
    assert any(f.drop for f in fates) and any(not f.drop for f in fates)
    assert not np.array_equal(faults._decision_bits(seed, "push", 7),
                              faults._decision_bits(seed, "pull", 7))


def test_fault_plan_validation_messages_equal_the_reference():
    for kw in (dict(drop_push=1.0), dict(drop_pull=-0.1),
               dict(dup_push=1.5), dict(crash_server=1),
               dict(crash_at_push=3), dict(partitions=(("push", 5, 2),)),
               dict(partitions=(("sync", 0, 2),))):
        msgs = []
        for mod in (faults, jfaults):
            with pytest.raises(ValueError) as e:
                mod.FaultPlan(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for spec in ("nonsense", "1@x", "1@2@3"):
        msgs = []
        for mod in (faults, jfaults):
            with pytest.raises(ValueError, match="SERVER@PUSHOP") as e:
                mod.FaultPlan.parse_crash(spec)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for spec in ("1@6", "", "0@0"):
        assert faults.FaultPlan.parse_crash(spec) == \
            jfaults.FaultPlan.parse_crash(spec)
    assert not faults.FaultPlan().active
    assert faults.FaultPlan(drop_pull=0.1).active


def test_partition_window_drops_every_op_inside():
    plan = faults.FaultPlan(partitions=(("push", 2, 5),))
    assert [plan.decide("push", i).drop for i in range(7)] == \
        [False, False, True, True, True, False, False]
    assert not plan.decide("pull", 3).drop


def test_chaos_transport_event_log_equals_the_reference():
    """One plan, one op script (pushes, pulls, a crash and a restart by
    the schedule): the same futures fail, the same events in the same
    order, the same counts, the same wire bytes and server state."""
    plan_kw = dict(seed=5, drop_push=0.3, drop_pull=0.3, dup_push=0.4,
                   crash_server=1, crash_at_push=4, restart_after_pushes=2)
    logs = []
    for p_mod, f_mod in ((ps, faults), (jps, jfaults)):
        server = p_mod.ParamServer(np.zeros((9, 2), np.float32),
                                   num_servers=3, pull_timeout=0.05)
        t = f_mod.ChaosTransport(p_mod.SimTransport(server),
                                 f_mod.FaultPlan(**plan_kw))
        outcomes = []
        try:
            rng = np.random.default_rng(1)
            for i in range(10):
                rows = np.sort(rng.choice(9, 3, replace=False))
                fut = t.push_batch(i + 1, rows,
                                   rng.normal(size=(3, 2)).astype(np.float32),
                                   client_id="w0", seq=i)
                outcomes.append(type(fut.exception()).__name__
                                if fut.exception() else "ok")
                fut = t.pull(rows, 0)
                outcomes.append(type(fut.exception()).__name__
                                if fut.exception() else "ok")
        finally:
            t.close()
        logs.append((outcomes, t.events, t.event_counts(),
                     t.bytes_by_link(), server._phi.copy(),
                     server.recovery_log, server.duplicates_dropped))
    (o, ev, cnt, by, phi, rec, dup), (jo, jev, jcnt, jby, jphi, jrec,
                                     jdup) = logs
    assert o == jo and ev == jev and cnt == jcnt and by == jby
    assert rec == jrec and dup == jdup
    np.testing.assert_array_equal(phi.view(np.uint32), jphi.view(np.uint32))
    assert cnt["crash"] == cnt["restart"] == 1 and cnt["drop"] > 0


# -------------------------------------------- transport-level parity

def _run_workload(transport, server, *, n_batches=8, w=12, k=3, seed=0,
                  sync_at=(), staleness=0, client_id="w0", port=True):
    """The reference test's push/pull workload, on a CPU tensor (port) or a
    jnp array (reference)."""
    rng = np.random.default_rng(seed)
    mod = ps if port else jps
    phi = torch.zeros((w, k)) if port else jnp.zeros((w, k))
    client = mod.PSClient(transport, staleness=staleness,
                          client_id=client_id, retry_deadline_s=10.0,
                          backoff0_s=1e-4, backoff_max_s=2e-3)
    for m in range(1, n_batches + 1):
        rows = np.sort(rng.choice(w, size=4, replace=False))
        phi = client.begin_batch(m, rows, phi)
        delta = rng.normal(size=(4, k)).astype(np.float32)
        if port:
            phi = phi.clone()
            phi[torch.from_numpy(rows)] += torch.from_numpy(delta)
        else:
            phi = phi.at[jnp.asarray(rows)].add(jnp.asarray(delta))
        client.end_batch(m, phi, rows)
        if m in sync_at:
            client.flush()
            server.mark_synced()
            client.mark_durable()
    client.flush()
    return client


def _committed_phi(plan_kw=None, port=True, **kw):
    p_mod, f_mod = (ps, faults) if port else (jps, jfaults)
    server = p_mod.ParamServer(np.zeros((12, 3), np.float32), num_servers=3,
                               pull_timeout=TIMEOUT)
    inner = p_mod.SimTransport(server)
    transport = (inner if plan_kw is None else
                 f_mod.ChaosTransport(inner, f_mod.FaultPlan(**plan_kw)))
    try:
        client = _run_workload(transport, server, port=port, **kw)
    finally:
        transport.close()
    phi, version = server.snapshot()
    return phi, version, client.stats(), server, transport


@pytest.mark.parametrize("case", ["drops", "duplicates", "partition",
                                  "crash"])
def test_chaos_schedules_reach_bitexact_parity(case):
    """Each schedule commits the clean run's phi bit for bit, and the
    reference's committed phi for the same schedule."""
    plan_kw, sync_at = {
        "drops": (dict(seed=7, drop_push=0.4, drop_pull=0.4), ()),
        "duplicates": (dict(seed=1, dup_push=1.0), ()),
        "partition": (dict(partitions=(("push", 1, 4), ("pull", 2, 5))), ()),
        "crash": (dict(seed=2, drop_push=0.25, dup_push=0.25,
                       crash_server=1, crash_at_push=6), (4,))}[case]
    clean, v0, _, _, _ = _committed_phi(sync_at=sync_at)
    chaos, v1, stats, server, t = _committed_phi(plan_kw, sync_at=sync_at)
    ref, v2, jstats, jserver, jt = _committed_phi(plan_kw, port=False,
                                                  sync_at=sync_at)
    assert v1 == v0 == v2
    np.testing.assert_array_equal(chaos, clean)
    np.testing.assert_array_equal(chaos.view(np.uint32), ref.view(np.uint32))
    assert t.event_counts() == jt.event_counts()
    assert server.recovery_log == jserver.recovery_log
    assert server.duplicates_dropped == jserver.duplicates_dropped
    assert stats["retries"] == jstats["retries"]
    assert stats["retry_wire_bytes"] == jstats["retry_wire_bytes"]
    if case in ("drops", "partition"):
        assert stats["retries"] > 0
    if case == "drops":
        assert server.duplicates_dropped == 0
    if case == "duplicates":
        assert server.duplicates_dropped >= t.event_counts()["duplicate"] > 0
    if case == "crash":
        assert stats["recoveries"] >= 1 and stats["replayed_pushes"] > 0
        events = [e["event"] for e in server.recovery_log]
        assert events[:2] == ["crash", "restart"] and "recovered" in events
        counts = t.event_counts()
        assert counts["crash"] == 1 and counts["restart"] == 1


def test_retry_deadline_raises_a_named_timeout():
    server = ps.ParamServer(np.zeros((6, 2), np.float32), pull_timeout=0.2)
    plan = faults.FaultPlan(partitions=(("push", 0, 10**9),))
    t = faults.ChaosTransport(ps.SimTransport(server), plan)
    client = ps.PSClient(t, staleness=0, client_id="w9",
                         retry_deadline_s=0.05, backoff0_s=1e-3,
                         backoff_max_s=1e-2)
    try:
        rows = np.array([1])
        phi = client.begin_batch(1, rows, torch.zeros((6, 2)))
        new = phi.clone()
        new[1] += 1.0
        with pytest.raises(TimeoutError, match="w9"):
            client.end_batch(1, new, rows)
            client.flush()
    finally:
        t.close()
    assert not [th for th in threading.enumerate()
                if th.name.startswith("repro-ps")]


def test_retry_wire_bytes_are_billed_on_top_of_clean():
    clean_t_bytes = _committed_phi()[4].total_bytes
    _, _, stats, _, t = _committed_phi(dict(seed=7, drop_push=0.4,
                                            drop_pull=0.4))
    assert stats["retry_wire_bytes"] > 0
    assert t.total_bytes == clean_t_bytes
    _, _, _, _, t2 = _committed_phi(dict(seed=1, dup_push=1.0))
    assert t2.total_bytes > clean_t_bytes


# ----------------------------------------- eventual-delivery property

def _crash_plan(drop, dup, seed, crash):
    return dict(seed=seed, drop_push=drop, drop_pull=drop, dup_push=dup,
                crash_server=None if crash is None else crash[0],
                crash_at_push=None if crash is None else crash[1])


@settings(max_examples=10, deadline=None)
@given(drop=st.floats(0.0, 0.6), dup=st.floats(0.0, 1.0),
       seed=st.integers(0, 1000),
       crash=st.sampled_from([None, (0, 3), (2, 5)]))
@example(drop=0.375, dup=0.0, seed=67, crash=(2, 5))
def test_any_eventually_delivering_schedule_is_bitexact(drop, dup, seed,
                                                        crash):
    """The §17 pin as a property: any (drop < 1, dup, crash/restart)
    schedule commits the same phi as the clean run at S = 0.  The pinned
    example crashes shard 2 while the worker's next op is a pull from it:
    the reference never restarts the shard there."""
    clean, v0, _, _, _ = _committed_phi(n_batches=5, sync_at=(2,))
    chaos, v1, _, _, _ = _committed_phi(_crash_plan(drop, dup, seed, crash),
                                        n_batches=5, sync_at=(2,))
    assert v1 == v0
    np.testing.assert_array_equal(chaos, clean)


def test_a_worker_blocked_on_a_pull_brings_the_restart():
    """Shard 2 goes down at push op 5 while the worker's next op is a pull
    from it, so no push comes to bring the scheduled restart.  The port
    restarts the shard on the second pull it rejects with no push between
    (``restart_after_pushes`` = 2), logs it by pull op, and commits the
    clean run's phi bit for bit well within the client's retry deadline;
    the reference, given the same plan, only backs off."""
    plan_kw = _crash_plan(0.375, 0.0, 67, (2, 5))
    clean, v0, _, _, _ = _committed_phi(n_batches=5, sync_at=(2,))
    t0 = time.time()
    chaos, v1, stats, server, t = _committed_phi(plan_kw, n_batches=5,
                                                 sync_at=(2,))
    assert time.time() - t0 < 0.5 * 10.0       # the workload's deadline
    assert v1 == v0
    np.testing.assert_array_equal(chaos.view(np.uint32), clean.view(np.uint32))
    crash, restart = ([e for e in t.events if e["event"] == kind]
                      for kind in ("crash", "restart"))
    assert crash == [{"event": "crash", "server": 2, "push_op": 5}]
    assert len(restart) == 1 and restart[0]["server"] == 2
    assert "pull_op" in restart[0] and "push_op" not in restart[0]
    events = [e["event"] for e in server.recovery_log]
    assert events[:2] == ["crash", "restart"] and "recovered" in events
    assert stats["recoveries"] >= 1
    # the events replay: the same plan on the same workload logs the same
    again = _committed_phi(plan_kw, n_batches=5, sync_at=(2,))[4]
    assert again.events == t.events
    # the reference waits on the downed shard with no restart to come
    server_ref = jps.ParamServer(np.zeros((12, 3), np.float32),
                                 num_servers=3, pull_timeout=TIMEOUT)
    tr = jfaults.ChaosTransport(jps.SimTransport(server_ref),
                                jfaults.FaultPlan(**plan_kw))
    client = jps.PSClient(tr, staleness=0, client_id="w0",
                          retry_deadline_s=0.5, backoff0_s=1e-4,
                          backoff_max_s=2e-3)
    try:
        phi = jnp.zeros((12, 3))
        rng = np.random.default_rng(0)
        with pytest.raises(TimeoutError, match="exceeded retry deadline"):
            for m in range(1, 6):
                rows = np.sort(rng.choice(12, size=4, replace=False))
                phi = client.begin_batch(m, rows, phi)
                phi = phi.at[jnp.asarray(rows)].add(jnp.asarray(
                    rng.normal(size=(4, 3)).astype(np.float32)))
                client.end_batch(m, phi, rows)
                if m == 2:
                    client.flush()
                    server_ref.mark_synced()
                    client.mark_durable()
    finally:
        tr.close()
    assert [e["event"] for e in tr.events].count("restart") == 0
    assert not server_ref.is_up(2)


def test_stalled_pulls_count_only_on_the_downed_shard_between_pushes():
    """The pull-side restart counts pulls that address the downed shard,
    and a push starts the count again; before the crash and after the
    restart pulls count for nothing."""
    server = ps.ParamServer(np.zeros((9, 2), np.float32), num_servers=3,
                            pull_timeout=0.05)
    t = faults.ChaosTransport(ps.SimTransport(server), faults.FaultPlan(
        crash_server=1, crash_at_push=1, restart_after_pushes=3))
    down, up = np.array([3, 4]), np.array([0, 7])
    d = np.ones((2, 2), np.float32)
    try:
        t.pull(down, 0).result()                        # before the crash
        t.push_batch(1, up, d, client_id="w0", seq=0).result()
        t.push_batch(2, up, d, client_id="w0", seq=1).result()   # crash
        assert t.event_counts() == {"crash": 1}
        for rows in (down, up, down):                   # 2 on the shard
            t.pull(rows, 0).exception()
        t.push_batch(3, up, d, client_id="w0", seq=2).result()   # resets
        assert "restart" not in t.event_counts()
        t.pull(down, 0).exception()
        t.pull(down, 0).exception()
        assert "restart" not in t.event_counts()
        err = t.pull(down, 0).exception()               # the third
        assert isinstance(err, ps.ServerUnavailableError) and err.server == 1
        assert t.events[-1] == {"event": "restart", "server": 1,
                                "pull_op": 6}
        assert server.needs_replay() == {1}
        t.pull(down, 0).exception()
        assert t.event_counts()["restart"] == 1
    finally:
        t.close()


def _slept(mod, attempt, **kw):
    """What ``mod``'s client sleeps for retry ``attempt`` (its first)."""
    client = mod.PSClient(None, client_id="w3", **kw)
    got = []
    with mock.patch.object(mod.time, "sleep", got.append):
        client._backoff(attempt)
    return got[0]


@settings(max_examples=10, deadline=None)
@given(attempt=st.integers(0, 5000),
       backoff0=st.floats(1e-6, 1.0), backoff_max=st.floats(1e-3, 2.0))
def test_backoff_is_the_reference_below_the_overflow_and_clamped_past(
        attempt, backoff0, backoff_max):
    """The port sleeps the reference's backoff for every attempt below
    1024; from 1024 on the reference's ``2.0 ** attempt`` overflows, and
    the port sleeps its cap (with the same jitter)."""
    kw = dict(backoff0_s=backoff0, backoff_max_s=backoff_max)
    for a in (attempt % 1024, 1023, attempt + 1024):
        mine = _slept(ps, a, **kw)
        if a < 1024:
            assert mine == _slept(jps, a, **kw)
        else:
            with pytest.raises(OverflowError):
                _slept(jps, a, **kw)
            assert mine == _slept(ps, 1023, **kw)
            assert mine <= 1.5 * backoff_max


# ------------------------------------------------ driver integration

def _common(**kw):
    base = dict(minibatches=8, docs_per_batch=16, vocab=200, topics=8,
                lambda_k=4, inner_iters=5, log_every=0, shards=2, seed=11,
                backend="ps", staleness=0, ps_servers=3)
    base.update(kw)
    return base


def test_driver_refusals_equal_the_reference():
    for kw in (dict(backend="sim", chaos_drop=0.1),
               dict(backend="sim", elastic_workers="w0,w1"),
               dict(staleness=2, elastic_events="join:w1@2"),
               dict(chaos_crash="1@6", elastic_workers="w0,w1"),
               dict(chaos_crash="1@6", elastic_events="join:w1@2"),
               dict(elastic_workers="w0,w0"),
               dict(elastic_events="grow:w1@2"),
               dict(elastic_events="join-w1"),
               dict(decay="64,0.6"),
               dict(backend="ps", dynamic_vocab=True),
               dict(chaos_crash="nonsense", chaos_drop=0.1)):
        msgs = []
        for mod, dev in ((cli, {"device": "cpu"}), (jcli, {})):
            with pytest.raises(ValueError) as e:
                mod.train_loop(mod.default_args(**_common(**kw), **dev))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    with pytest.raises(TypeError, match="unknown driver arg"):
        cli.default_args(bogus=1)


def test_driver_chaos_run_is_bitexact_with_clean_ps():
    clean = cli.train_loop(cli.default_args(**_common(), device="cpu"))
    chaos = cli.train_loop(cli.default_args(
        **_common(), device="cpu", chaos_seed=5, chaos_drop=0.3,
        chaos_dup=0.3, chaos_crash="1@6", chaos_restart_after=2,
        ps_pull_timeout=TIMEOUT))
    assert torch.equal(chaos["phi_acc"], clean["phi_acc"])
    assert chaos["mean_r"] == clean["mean_r"]
    assert chaos["iters"] == clean["iters"]
    assert chaos["ps_retries"] > 0
    assert chaos["chaos_events"].get("drop", 0) > 0
    assert chaos["chaos_events"].get("crash", 0) == 1
    assert [e["event"] for e in chaos["ps_recovery_log"]].count(
        "recovered") >= 1
    assert chaos["ps_retry_wire_bytes"] > 0
    assert "ps.replay" in chaos["bytes_by_phase"]
    assert not [th for th in threading.enumerate()
                if th.name.startswith("repro-ps")]


def test_driver_elastic_membership_is_bitexact_with_clean_ps():
    """Workers join and leave mid-stream and one crashes right after its
    step: the survivor replays the batch (the generator's state put back),
    and the run equals the static one-worker run bit for bit."""
    kw = _common(minibatches=12)
    clean = cli.train_loop(cli.default_args(**kw, device="cpu"))
    elastic = cli.train_loop(cli.default_args(
        **kw, device="cpu", elastic_workers="w0,w1",
        elastic_events="join:w2@3,leave:w0@6,crash:w2@9"))
    assert torch.equal(elastic["phi_acc"], clean["phi_acc"])
    assert elastic["mean_r"] == clean["mean_r"]
    assert elastic["ps_workers"] == ["w1"]
    kinds = [e["event"] for e in elastic["elastic_log"]]
    assert kinds.count("join") == 1 and kinds.count("leave") == 1
    crash = next(e for e in elastic["elastic_log"] if e["event"] == "crash")
    assert crash["worker"] == "w2" and crash["replayed"]
    # one push a batch: the victim's pull was never pushed
    assert len(elastic["ps_copies"]) == 12 and len(kinds) == 3

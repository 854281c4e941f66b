"""The port's sync layer (``repro_torch.core.sync``): the byte meter's
merge rules, held against the reference's ``CommMeter`` fed the same
records from traced programs; and the reducers: the cast-record-sum-cast
order, the lockstep simulation's sums in shard order with a result of
each shard's own, and its failure modes (a shard that raises or leaves
the others waiting ends the run instead of hanging it).

Byte counts are integers and compared exactly; sums in float32 to the
bit where the port promises bits (one shard order)."""

import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sync as jsync
from repro_torch.core import sync
from repro_torch.core.sync import (CommMeter, LocalReducer, LockstepBroken,
                                   SimReducer, StackedReducer, lockstep)


def _reference_bytes(programs, live_w=None, iters=None):
    """The reference meter after tracing each program of ``programs``:
    lists of (phase, shape, dtype, w_rows), each list one jitted
    function (one trace) recording its payloads."""
    meter = jsync.CommMeter()
    for records in programs:
        def fn(x, records=records):
            for phase, shape, dtype, w_rows in records:
                meter.record(phase, jnp.zeros(shape, dtype) + x,
                             w_rows=w_rows)
            return x
        jax.jit(fn)(jnp.float32(0))
    if iters is not None:
        return meter.per_minibatch_bytes(iters, live_w=live_w)
    return (meter.bytes_by_phase if live_w is None
            else meter.bytes_by_phase_at(live_w))


def _port_bytes(programs, live_w=None, iters=None, runs=3):
    meter = CommMeter()
    for _ in range(runs):                 # an eager program runs repeatedly
        for records in programs:
            with meter.section():
                for phase, shape, dtype, w_rows in records:
                    meter.record(phase, torch.zeros(shape, dtype=dtype),
                                 w_rows=w_rows)
    if iters is not None:
        return meter.per_minibatch_bytes(iters, live_w=live_w)
    return (meter.bytes_by_phase if live_w is None
            else meter.bytes_by_phase_at(live_w))


F32, BF16 = (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)


def _programs(which):
    """Record lists as the shard bodies make them: the once-a-batch part
    at two length buckets (the L-dependent model_norm), the iteration
    body, a second sync mode's section, the decay."""
    d = 0 if which == "torch" else 1
    batch = lambda L, dt: [  # noqa: E731
        ("tokens", (), F32[d], None), ("model_norm", (8, L, 1), F32[d], None),
        ("dense", (120, 4), dt[d], 120), ("dense", (120, 4), dt[d], 120),
        ("model_rw", (120,), F32[d], 120), ("decay", (120, 4), F32[d], 120)]
    loop = lambda dt: [  # noqa: E731
        ("power", (36, 3), dt[d], 120), ("power", (36, 3), dt[d], 120),
        ("model_rw_loop", (36,), F32[d], 120)]
    dense_loop = lambda L: [  # noqa: E731
        ("model_norm_loop", (8, L, 1), F32[d], None),
        ("dense_loop", (120, 4), F32[d], 120),
        ("dense_loop", (120, 4), F32[d], 120),
        ("model_rw_loop", (120,), F32[d], 120)]
    return [batch(16, F32), batch(32, F32), loop(F32), loop(BF16),
            dense_loop(16), dense_loop(32)]


@pytest.mark.parametrize("live_w", [None, 45, 120, 500])
def test_meter_merges_logs_as_the_reference_merges_traces(live_w):
    """Identical logs count once however often a program runs; shape
    variants of one section (two length buckets) take the per-phase max;
    distinct sections (a bf16 run's loop, the dense-sync loop) add;
    ``w_rows`` payloads scale to ``live_w``: ``bytes_by_phase``,
    ``bytes_by_phase_at`` and ``per_minibatch_bytes`` equal the
    reference's integer for integer."""
    mine, theirs = _programs("torch"), _programs("jax")
    want = _reference_bytes(theirs, live_w)
    assert _port_bytes(mine, live_w) == want
    assert want["model_norm"] == 8 * 32 * 4            # the larger bucket
    for iters in (1, 2, 7):
        assert _port_bytes(mine, live_w, iters) == \
            _reference_bytes(theirs, live_w, iters)


def test_meter_eager_records_and_host_records_accumulate():
    meter = CommMeter()
    for _ in range(3):
        meter.record("decay", torch.zeros(4, 5))
    meter.record_host("ps.retry.push", 100, w_rows=10)
    assert meter.bytes_by_phase == {"decay": 240, "ps.retry.push": 100}
    assert meter.bytes_by_phase_at(5)["ps.retry.push"] == 50
    assert sync.LOOP_PHASES == jsync.LOOP_PHASES
    meter.reset()
    assert meter.total_bytes == 0


def test_sections_are_per_thread():
    """Two threads recording at once each fill their own section: two
    identical logs, counted once."""
    meter = CommMeter()
    barrier = threading.Barrier(2)

    def body():
        with meter.section():
            meter.record("dense", torch.zeros(3))
            barrier.wait(timeout=10)
            meter.record("dense", torch.zeros(3))

    threads = [threading.Thread(target=body) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert meter.bytes_by_phase == {"dense": 24}


def test_psum_casts_records_sums_and_casts_back():
    """The reference's order: the payload cast to the wire dtype, billed
    at that width, summed, cast back; ``compress=False`` ships float32;
    the local reducer bills nothing and round-trips through the wire."""
    x = torch.linspace(0.1, 3.3, 17)
    red = StackedReducer(2, sync_dtype=torch.bfloat16)
    xs = torch.stack([x, 2 * x])
    out = red.psum(xs, "power", w_rows=17)
    assert out.dtype == torch.float32
    assert torch.equal(out[0], (xs.bfloat16()[0] + xs.bfloat16()[1]).float())
    assert torch.equal(out[1], out[0])
    red.psum(xs, "model_rw", compress=False)
    assert red.meter.bytes_by_phase == {"power": 34, "model_rw": 68}
    loc = LocalReducer(sync_dtype="bfloat16")
    assert torch.equal(loc.psum(x, "dense"), x.bfloat16().float())
    assert loc.psum(x, "tokens", compress=False) is x
    assert loc.meter.total_bytes == 0
    loc.bill(x, "decay", w_rows=17)
    assert loc.meter.bytes_by_phase_at(1) == {"decay": 4}


def test_lockstep_sums_in_shard_order_each_shard_its_own_result():
    """Shard order 0..N-1, every shard the same bits, in a tensor of its
    own (updating it in place leaves the others alone); groups reduce
    apart; results come back in shard order; the shards' identical
    sections bill one shard's payload."""
    red = SimReducer(4, groups=[[0, 2], [1, 3]])
    vals = [torch.tensor([1e8, 1.0, -1e8]) * (s + 1) + s for s in range(4)]

    def body(s):
        with red.meter.section():      # each shard logs the same section
            out = red.psum(vals[s], "dense")
        mine = out.clone()
        out.add_(1000.0)
        return mine, out

    outs = lockstep(body, 4, [red])
    for grp in ([0, 2], [1, 3]):
        want = vals[grp[0]].clone()
        want.add_(vals[grp[1]])
        for s in grp:
            assert torch.equal(outs[s][0], want)
            assert torch.equal(outs[s][1], want + 1000.0)
    assert red.shards == 2
    assert red.meter.bytes_by_phase == {"dense": 12}


def test_lockstep_releases_the_others_when_a_shard_raises():
    red = SimReducer(3)

    def body(s):
        if s == 1:
            raise KeyError("shard one fails")
        return red.psum(torch.ones(2), "dense")

    with pytest.raises(KeyError, match="shard one fails"):
        lockstep(body, 3, [red])
    # the reducer serves the next run
    assert [float(o.sum()) for o in lockstep(
        lambda s: red.psum(torch.ones(2), "dense"), 3, [red])] == [6.0] * 3


def test_lockstep_refuses_shards_out_of_step():
    """A shard that skips a psum the others make, or meets a psum of
    another phase or shape, ends the run with an error, never a hang."""
    red = SimReducer(2)
    with pytest.raises(LockstepBroken, match="out of lockstep"):
        lockstep(lambda s: red.psum(torch.ones(2), "dense") if s else None,
                 2, [red])
    with pytest.raises(RuntimeError, match="out of lockstep"):
        lockstep(lambda s: red.psum(torch.ones(2 + s), "dense"), 2, [red])
    with pytest.raises(RuntimeError, match="outside a lockstep run"):
        red.psum(torch.ones(2), "dense")
    with pytest.raises(ValueError, match="equal groups"):
        SimReducer(3, groups=[[0, 1], [2]])

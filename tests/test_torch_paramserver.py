"""The port's parameter server (``repro_torch.dist.paramserver``) against
the reference's (``repro.dist.paramserver``): every test of
``tests/test_paramserver.py`` has a counterpart here.  Host logic gets the
same scripted ops in both packages and must end in the same state bit for
bit (server phi, committed version, bytes by link, duplicates dropped, the
recovery log, the bf16 wire bits); the client's replica copies run on a
CPU tensor (port) and a jnp array (reference); the driver's ``--backend
ps`` runs against its own ``--backend sim`` at the reference test's
tolerance, resumes bit for bit, and reads a checkpoint the reference's
driver wrote under ``--backend ps``.

Every transport here has a short pull timeout and is closed in a
``finally``, so a lost push fails fast and no transport thread outlives
its test.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import paramserver as jps
from repro.launch import lda_train as jcli
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import paramserver as ps
from repro_torch.launch import lda_train as cli

TIMEOUT = 5.0


def _servers(phi0, num_servers=1, **kw):
    kw.setdefault("pull_timeout", TIMEOUT)
    return (ps.ParamServer(phi0, num_servers=num_servers, **kw),
            jps.ParamServer(phi0, num_servers=num_servers, **kw))


def _same_server(mine, theirs):
    """Server state equal bit for bit: phi, version, dedup counter, log."""
    np.testing.assert_array_equal(mine._phi.view(np.uint32),
                                  theirs._phi.view(np.uint32))
    assert mine.committed == theirs.committed
    assert mine.duplicates_dropped == theirs.duplicates_dropped
    assert mine.recovery_log == theirs.recovery_log
    assert mine.manifest() == theirs.manifest()


def _no_transport_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("repro-ps")]


# ------------------------------------------------------------ row sharding

@pytest.mark.parametrize("w_cap,n", [(10, 3), (1, 1), (7, 7), (141043, 4)])
def test_row_shards_cover_balance_and_split(w_cap, n):
    mine, theirs = ps.RowShards(w_cap, n), jps.RowShards(w_cap, n)
    assert mine.ranges == theirs.ranges
    assert mine.ranges[0][0] == 0 and mine.ranges[-1][1] == w_cap
    rows = np.unique(np.random.default_rng(w_cap).integers(0, w_cap, 9))
    assert [mine.owner(int(r)) for r in rows] == \
        [theirs.owner(int(r)) for r in rows]
    got, want = mine.split(rows), theirs.split(rows)
    assert sorted(got) == sorted(want)
    for s in got:
        np.testing.assert_array_equal(got[s], want[s])
    with pytest.raises(ValueError):
        mine.owner(w_cap)
    with pytest.raises(ValueError):
        ps.RowShards(0, 3)
    if w_cap == 10:
        assert mine.ranges == [(0, 4), (4, 7), (7, 10)]
        assert sorted(mine.split(np.array([8, 9]))) == [2]


def test_touched_rows_of_ignores_padding_slots():
    wid = np.array([[1, 5, 0], [5, 2, 0]])
    cnt = np.array([[1.0, 1.0, 0.0], [2.0, 1.0, 0.0]])
    wid3 = np.array([[[0, 3]], [[3, 7]]])
    cnt3 = np.array([[[2.0, 1.0]], [[1.0, 0.0]]])
    for w, c, want in ((wid, cnt, [1, 2, 5]), (wid3, cnt3, [0, 3])):
        got = ps.touched_rows_of(w, c)
        np.testing.assert_array_equal(got, jps.touched_rows_of(w, c))
        np.testing.assert_array_equal(got, want)
        # the driver hands it the batch's CPU tensors
        np.testing.assert_array_equal(
            ps.touched_rows_of(torch.from_numpy(w), torch.from_numpy(c)),
            want)
        assert got.dtype == np.int64
    # never a read back from a device: a tensor off the CPU is refused
    with pytest.raises(ValueError, match="host arrays"):
        ps.touched_rows_of(torch.zeros(3, device="meta"), cnt)


# ------------------------------------------------------- server + transport

def test_server_push_pull_roundtrip_and_version_gate():
    mine, theirs = _servers(np.zeros((8, 3), np.float32), 2)
    rows = np.array([1, 5])
    delta = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, jt = ps.SimTransport(mine), jps.SimTransport(theirs)
    try:
        t.push_batch(1, rows, delta).result()
        jt.push_batch(1, rows, delta).result()
        (vals, ver), (jvals, jver) = (t.pull(rows, 1).result(),
                                      jt.pull(rows, 1).result())
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(vals, delta)
        assert ver == jver == 1
        _same_server(mine, theirs)
        assert t.bytes_by_link() == jt.bytes_by_link()
        with pytest.raises(TimeoutError):
            mine.serve_pull(0, np.array([1]), min_version=5, timeout=0.05)
        with pytest.raises(ValueError):
            mine.apply_push(0, np.array([7]), np.ones((1, 3), np.float32))
        with pytest.raises(ValueError, match="asks rows outside"):
            mine.serve_pull(1, np.array([2]), min_version=0)
    finally:
        t.close()
        jt.close()
    assert _no_transport_threads()


def test_transport_bills_per_link_in_both_directions():
    mine, theirs = _servers(np.zeros((8, 4), np.float32), 2)
    t, jt = ps.SimTransport(mine), jps.SimTransport(theirs)
    try:
        rows = np.array([0, 1, 6])          # 2 rows on s0, 1 row on s1
        for tr in (t, jt):
            tr.push_batch(1, rows, np.ones((3, 4), np.float32)).result()
            tr.pull(rows, 1).result()
        per_row = 4 * 4 + 4
        assert t.pushed_bytes == jt.pushed_bytes == [2 * per_row, per_row]
        assert t.pulled_bytes == jt.pulled_bytes == [2 * per_row, per_row]
        assert t.total_bytes == jt.total_bytes == 2 * 3 * per_row
        assert t.bytes_by_link() == jt.bytes_by_link()
        _same_server(mine, theirs)
    finally:
        t.close()
        jt.close()


def _special_floats():
    """Normal, subnormal, rounding-tie, overflow, inf and NaN float32 bit
    patterns (NaNs with payloads and both signs)."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.normal(size=64).astype(np.float32).view(np.uint32),
        (rng.normal(size=32) * 1e-40).astype(np.float32).view(np.uint32),
        np.array([0x0, 0x80000000, 0x1, 0x80000001, 0x00008000, 0x00018000,
                  0x3F808000, 0x3F818000, 0x7F7FFFFF, 0xFF7FFFFF,
                  0x7F7F8000, 0x7F800000, 0xFF800000, 0x7FC00000,
                  0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF,
                  0x7F80FFFF, 0xFFFFFFFF], np.uint32)])
    return bits.view(np.float32).reshape(-1, 4)


@pytest.mark.parametrize("wire", ["bfloat16", torch.bfloat16, jnp.bfloat16])
def test_bf16_wire_halves_value_bytes_and_round_trips(wire):
    """The port's bf16 wire (round to nearest even on the bits, no
    ml_dtypes) delivers the reference's bits for every input: normal,
    subnormal, ties, overflow to inf, inf and NaN; value bytes at 2."""
    x = _special_floats()
    mine, theirs = _servers(np.zeros((x.shape[0], 4), np.float32))
    t = ps.SimTransport(mine, wire_dtype=wire)
    jt = jps.SimTransport(theirs, wire_dtype=jnp.bfloat16)
    try:
        assert t.wire_dtype == "bfloat16" and t.wire_itemsize == 2
        np.testing.assert_array_equal(t._encode(x).view(np.uint32),
                                      jt._encode(x).view(np.uint32))
        rows = np.array([2])
        v = np.full((1, 4), 1.337, np.float32)
        t.push_batch(1, rows, v).result()
        jt.push_batch(1, rows, v).result()
        assert t.pushed_bytes == jt.pushed_bytes == [4 * 2 + 4]
        vals, _ = t.pull(rows, 1).result()
        jvals, _ = jt.pull(rows, 1).result()
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(
            vals, np.full((1, 4), np.float32(np.asarray(1.337,
                                                        jnp.bfloat16))))
        assert t.bytes_by_link() == jt.bytes_by_link()
    finally:
        t.close()
        jt.close()
    with pytest.raises(ValueError, match="wire dtype"):
        ps.SimTransport(mine, wire_dtype="float16")


def test_duplicate_push_is_idempotent():
    mine, theirs = _servers(np.zeros((4, 2), np.float32))
    rows = np.array([1])
    delta = np.full((1, 2), 3.0, np.float32)
    for srv in (mine, theirs):
        assert srv.apply_push(0, rows, delta, client_id="w0", seq=0)
        assert not srv.apply_push(0, rows, delta, client_id="w0", seq=0)
        srv.commit(1)
        vals, _ = srv.serve_pull(0, rows, min_version=1)
        np.testing.assert_array_equal(vals, delta)
        assert srv.duplicates_dropped == 1
        assert srv.apply_push(0, rows, delta, client_id="w1", seq=0)
        assert srv.apply_push(0, rows, delta)
        assert srv.apply_push(0, rows, delta)
    _same_server(mine, theirs)


def test_out_of_order_delta_commit_is_monotonic():
    mine, theirs = _servers(np.zeros((4, 2), np.float32))
    rows = np.array([2])
    for srv in (mine, theirs):
        srv.apply_push(0, rows, np.full((1, 2), 2.0, np.float32),
                       client_id="w0", seq=1)
        srv.commit(2)
        srv.apply_push(0, rows, np.full((1, 2), 1.0, np.float32),
                       client_id="w0", seq=0)
        srv.commit(1)
        assert srv.committed == 2
        vals, ver = srv.serve_pull(0, rows, min_version=2)
        np.testing.assert_array_equal(vals, [[3.0, 3.0]])
        assert ver == 2
    _same_server(mine, theirs)


def test_pull_timeout_names_shard_rows_and_version():
    mine, theirs = _servers(np.zeros((8, 2), np.float32), 2,
                            pull_timeout=0.05)
    msgs = []
    for srv in (mine, theirs):
        with pytest.raises(TimeoutError, match=r"server shard 1.*rows "
                                               r"\[4, 8\).*>= 7") as e:
            srv.serve_pull(1, np.array([5]), min_version=7)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_crash_restart_replay_state_machine():
    """The same crash / restart / replay script on both servers: the same
    refusals, the same phi, the same recovery log."""
    mine, theirs = _servers(np.zeros((4, 2), np.float32), pull_timeout=0.05)
    rows = np.array([0])
    one = np.ones((1, 2), np.float32)
    msgs = {id(mine): [], id(theirs): []}
    for srv, unavailable in ((mine, ps.ServerUnavailableError),
                             (theirs, jps.ServerUnavailableError)):
        srv.apply_push(0, rows, one, client_id="w0", seq=0)
        srv.commit(1)
        srv.mark_synced()
        srv.apply_push(0, rows, one, client_id="w0", seq=1)
        srv.commit(2)
        srv.crash(0)
        assert not srv.is_up(0)
        with pytest.raises(unavailable, match="shard 0") as e:
            srv.apply_push(0, rows, one)
        msgs[id(srv)].append(str(e.value))
        with pytest.raises(unavailable) as e:
            srv.serve_pull(0, rows, min_version=1)
        msgs[id(srv)].append(str(e.value))
        srv.restart(0)
        assert srv.needs_replay() == frozenset({0})
        with pytest.raises(TimeoutError, match="replay") as e:
            srv.serve_pull(0, rows, min_version=2)
        msgs[id(srv)].append(str(e.value))
        with pytest.raises(unavailable, match="replaying") as e:
            srv.apply_push(0, rows, one, client_id="w0", seq=1)
        msgs[id(srv)].append(str(e.value))
        assert srv.apply_push(0, rows, one, client_id="w0", seq=1,
                              replay=True)
        srv.mark_recovered(0)
        vals, _ = srv.serve_pull(0, rows, min_version=2)
        np.testing.assert_array_equal(vals, [[2.0, 2.0]])
    assert msgs[id(mine)] == msgs[id(theirs)]
    assert [e["event"] for e in mine.recovery_log] == \
        ["crash", "restart", "recovered"]
    _same_server(mine, theirs)
    snap, ver = mine.snapshot()
    np.testing.assert_array_equal(snap, theirs.snapshot()[0])
    assert ver == 2 and issubclass(ps.ServerUnavailableError,
                                   ps.TransportError)


def test_torch_distributed_transport_refuses_uninitialized(tmp_path):
    """The multi-host slot fails loudly without a process group; with one
    (a one-rank gloo group) it constructs and refuses every op."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="torch.distributed"):
        ps.TorchDistributedTransport(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        t = ps.TorchDistributedTransport(2)
        assert t.pushed_bytes == [0, 0] and t.total_bytes == 0
        with pytest.raises(NotImplementedError, match="multi-host PS push"):
            t.push_batch(1, np.array([0]), np.zeros((1, 2), np.float32))
        with pytest.raises(NotImplementedError, match="multi-host PS pull"):
            t.pull(np.array([0]), 0)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- client

def _clients(phi0, staleness, **kw):
    mine, theirs = _servers(phi0, **kw)
    return (ps.PSClient(ps.SimTransport(mine), staleness=staleness),
            jps.PSClient(jps.SimTransport(theirs), staleness=staleness),
            mine, theirs)


def test_client_s0_round_trip_is_barriered():
    """begin_batch / end_batch on a CPU tensor (port, in place) and a jnp
    array (reference): the same rows written, the same push."""
    c, jc, mine, theirs = _clients(np.zeros((6, 2), np.float32), 0)
    try:
        rows = np.array([0, 3])
        phi = torch.zeros((6, 2))
        got = c.begin_batch(1, rows, phi)
        jphi = jc.begin_batch(1, rows, jnp.zeros((6, 2)))
        assert got is phi
        np.testing.assert_array_equal(phi.numpy(), np.asarray(jphi))
        new = phi.clone()
        new[torch.from_numpy(rows)] += 1.0
        jnew = jphi.at[jnp.asarray(rows)].add(1.0)
        c.end_batch(1, new, rows)
        jc.end_batch(1, jnew, rows)
        assert mine.committed == theirs.committed == 1
        got2 = c.begin_batch(2, rows, new)
        jgot2 = jc.begin_batch(2, rows, jnew)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(jgot2))
        np.testing.assert_array_equal(got2.numpy()[rows], new.numpy()[rows])
        c.flush()
        jc.flush()
        _same_server(mine, theirs)
        assert c.copies[0]["rows"] == 2 and c.copies[0]["h2d_ms"] is None
        timed = ("pull_wait_s", "push_wait_s")
        assert {k: v for k, v in c.stats().items() if k not in timed} == \
            {k: v for k, v in jc.stats().items() if k not in timed}
    finally:
        c.transport.close()
        jc.transport.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_client_writes_pulled_rows_in_the_replica_dtype(dtype):
    """Pulled float32 rows land in a bf16 replica rounded to nearest, as
    ``jnp.asarray(vals, phi.dtype)`` rounds them; end_batch reads the
    updated rows back as float32."""
    rng = np.random.default_rng(3)
    phi0 = rng.normal(size=(12, 5)).astype(np.float32)
    c, jc, mine, theirs = _clients(phi0, 0, num_servers=3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    try:
        rows = np.array([1, 4, 5, 11])
        phi = c.begin_batch(1, rows, torch.zeros((12, 5), dtype=dtype))
        jphi = jc.begin_batch(1, rows, jnp.zeros((12, 5), jdt))
        np.testing.assert_array_equal(phi.float().numpy(),
                                      np.asarray(jphi, np.float32))
        bump = rng.normal(size=(4, 5)).astype(np.float32)
        new = phi.clone()
        new[torch.from_numpy(rows)] += torch.from_numpy(bump).to(dtype)
        jnew = jphi.at[jnp.asarray(rows)].add(jnp.asarray(bump, jdt))
        np.testing.assert_array_equal(new.float().numpy(),
                                      np.asarray(jnew, np.float32))
        c.end_batch(1, new, rows)
        jc.end_batch(1, jnew, rows)
        _same_server(mine, theirs)
    finally:
        c.transport.close()
        jc.transport.close()


def test_client_staleness_bounds_pending_and_serves_stale_pulls():
    c, jc, mine, theirs = _clients(np.zeros((6, 2), np.float32), 1)
    try:
        rows = np.array([1, 4])
        phi = c.begin_batch(1, rows, torch.zeros((6, 2)))
        jphi = jc.begin_batch(1, rows, jnp.zeros((6, 2)))
        c.prefetch(2, rows)
        jc.prefetch(2, rows)
        phi = c.begin_batch(2, rows, phi)      # must not block
        jphi = jc.begin_batch(2, rows, jphi)
        new = phi.clone()
        new[torch.from_numpy(rows)] += 2.0
        c.end_batch(2, new, rows)
        jc.end_batch(2, jphi.at[jnp.asarray(rows)].add(2.0), rows)
        c.flush()
        jc.flush()
        vals, _ = mine.serve_pull(0, np.array([1]), min_version=2)
        np.testing.assert_array_equal(vals, [[2.0, 2.0]])
        assert c.mean_touched_rows == jc.mean_touched_rows == 2.0
        _same_server(mine, theirs)
    finally:
        c.transport.close()
        jc.transport.close()
    with pytest.raises(ValueError):
        ps.PSClient(ps.SimTransport(ps.ParamServer(
            np.zeros((2, 2), np.float32))), staleness=-1)
    with pytest.raises(RuntimeError, match="matching begin_batch"):
        ps.PSClient(None).end_batch(1, torch.zeros((2, 2)), np.array([0]))


# ----------------------------------------- sliced sum and row sharding

def test_sliced_sum_is_bitexact_with_dense_sum():
    rng = np.random.default_rng(0)
    w_cap, k, n = 12, 3, 3
    deltas, touched = [], []
    for _ in range(n):
        rows = np.sort(rng.choice(w_cap, size=4, replace=False))
        d = np.zeros((w_cap, k), np.float32)
        d[rows] = rng.normal(size=(4, k)).astype(np.float32)
        deltas.append(d)
        touched.append(rows)
    dense = deltas[0] + deltas[1] + deltas[2]
    got = ps.sliced_sum(deltas, touched, w_cap)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, jps.sliced_sum(deltas, touched, w_cap))


@st.composite
def shard_payloads(draw):
    """Per-shard payloads zero off their touched rows and on the guard rows
    (the reference property suite's strategy)."""
    w = draw(st.integers(3, 24))
    k = draw(st.integers(1, 6))
    n = draw(st.integers(1, 4))
    live_w = draw(st.integers(1, w))
    deltas, touched = [], []
    for _ in range(n):
        n_rows = draw(st.integers(0, live_w))
        rows = np.sort(np.asarray(
            draw(st.lists(st.integers(0, live_w - 1), min_size=n_rows,
                          max_size=n_rows, unique=True)), np.int64))
        d = np.zeros((w, k), np.float32)
        if rows.size:
            vals = draw(st.lists(
                st.floats(-1e4, 1e4, width=32, allow_nan=False),
                min_size=int(rows.size) * k, max_size=int(rows.size) * k))
            d[rows] = np.asarray(vals, np.float32).reshape(rows.size, k)
        deltas.append(d)
        touched.append(rows)
    return deltas, touched, w


@given(shard_payloads(), st.booleans())
@settings(max_examples=40, deadline=None)
def test_sliced_sum_property_matches_reference_with_bf16_cast(payload, bf16):
    """The port's sliced sum equals the reference's bit for bit (compared
    with the reference's sliced_sum, not a dense sum), with the bf16 wire
    cast of each payload (the port's bits against ml_dtypes')."""
    deltas, touched, w = payload
    if bf16:
        mine_in = [ps.bf16_round_trip(d) for d in deltas]
        theirs_in = [d.astype(jnp.bfloat16).astype(np.float32)
                     for d in deltas]
        for a, b in zip(mine_in, theirs_in):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    else:
        mine_in = theirs_in = deltas
    got = ps.sliced_sum(mine_in, touched, w)
    want = jps.sliced_sum(theirs_in, touched, w)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@given(st.integers(1, 5000), st.integers(1, 64),
       st.lists(st.integers(0, 4999), max_size=40))
@settings(max_examples=40, deadline=None)
def test_row_shards_property_matches_reference(w, n, rows):
    mine, theirs = ps.RowShards(w, n), jps.RowShards(w, n)
    assert mine.ranges == theirs.ranges
    rows = np.unique(np.asarray([r % w for r in rows], np.int64))
    got, want = mine.split(rows), theirs.split(rows)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[s], want[s]) for s in got)
    if rows.size:
        assert np.concatenate([got[s] for s in sorted(got)]).tolist() == \
            rows.tolist()


# ------------------------------------------------------------- PSReducer

@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_ps_reducer_bills_push_and_pull_legs_as_the_reference(wire):
    """Around a `LocalReducer`: a row payload is billed as its push and its
    pull leg, a non-row payload not at all, the values take the wire's
    round trip as `LocalReducer`'s do; the bytes by phase (and at a touched
    row count) equal the reference's ``PSReducer`` over the same calls."""
    from repro.core import sync as jsync
    from repro_torch.core import sync

    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    r = rng.normal(size=(6,)).astype(np.float32)
    mine = sync.PSReducer(sync.LocalReducer(sync_dtype=wire))
    theirs = jsync.PSReducer(jsync.LocalReducer(
        sync_dtype=jnp.bfloat16 if wire == "bfloat16" else jnp.float32))
    got = mine.psum(torch.from_numpy(x), "dense", w_rows=40)
    want = theirs.psum(jnp.asarray(x), "dense", w_rows=40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), sync.LocalReducer(sync_dtype=wire).psum(
            torch.from_numpy(x), "dense").numpy())
    for red, arr in ((mine, torch.from_numpy(r)), (theirs, jnp.asarray(r))):
        red.psum(arr, "tokens", compress=False)
        red.psum(arr, "model_rw", compress=False, w_rows=40)
        red.bill(arr, "decay", w_rows=40)
    assert mine.meter.bytes_by_phase == theirs.meter.bytes_by_phase
    assert mine.meter.bytes_by_phase_at(10) == \
        theirs.meter.bytes_by_phase_at(10)
    assert "tokens" not in mine.meter.bytes_by_phase
    assert mine.meter.bytes_by_phase["dense.push"] == \
        40 * 6 * (2 if wire == "bfloat16" else 4)


def test_ps_reducer_around_lockstep_shards_bills_once_a_shard():
    """Around a `SimReducer` of 2 lockstep shards: each shard's psum sums
    as the plain `SimReducer` does, the non-row payloads are billed as
    there, the row payloads as push and pull legs, nothing twice."""
    from repro_torch.core import sync

    xs = [torch.arange(12.0).reshape(4, 3) + s for s in range(2)]
    plain, ps_red = sync.SimReducer(2), sync.PSReducer(sync.SimReducer(2))
    outs = {}
    for name, red in (("plain", plain), ("ps", ps_red)):
        def body(shard, red=red):
            with red.meter.section():
                return (red.psum(xs[shard], "dense", w_rows=4),
                        red.psum(xs[shard].sum(0), "tokens"))
        outs[name] = sync.lockstep(body, 2, [getattr(red, "inner", red)])
    for (a, b), (c, d) in zip(outs["plain"], outs["ps"]):
        assert torch.equal(a, c) and torch.equal(b, d)
    by, plain_by = ps_red.meter.bytes_by_phase, plain.meter.bytes_by_phase
    assert by == {"dense.push": plain_by["dense"],
                  "dense.pull": plain_by["dense"],
                  "tokens": plain_by["tokens"]}
    assert ps_red.inner.meter is ps_red.meter


# ------------------------------------------------------ driver integration

def _common(**kw):
    """The reference test's driver settings, on the CPU."""
    base = dict(minibatches=6, docs_per_batch=16, vocab=200, topics=8,
                lambda_k=4, inner_iters=5, log_every=0, shards=2, seed=11,
                device="cpu", ps_pull_timeout=TIMEOUT)
    base.update(kw)
    return base


@pytest.mark.parametrize("shards", [1, 2])
def test_ps_backend_matches_allreduce_at_s0(shards):
    """``--backend ps --staleness 0`` against ``--backend sim`` at the
    reference test's tolerance (mean_r atol 1e-6; phi_acc rtol 1e-6, atol
    1e-5), the same iterations; the measured wire bytes equal the
    touched-row model exactly; the meter splits each row payload into its
    push and pull legs."""
    ar = cli.train_loop(cli.default_args(**_common(shards=shards),
                                         backend="sim"))
    res = cli.train_loop(cli.default_args(**_common(shards=shards),
                                          backend="ps", staleness=0,
                                          ps_servers=3))
    assert res["iters"] == ar["iters"]
    np.testing.assert_allclose(res["mean_r"], ar["mean_r"], atol=1e-6)
    np.testing.assert_allclose(res["phi_acc"].numpy(), ar["phi_acc"].numpy(),
                               rtol=1e-6, atol=1e-5)
    assert res["ps_wire_bytes"] > 0
    assert 0 < res["mean_touched_rows"] <= 200
    n, k = len(res["mean_r"]), 8
    assert res["ps_wire_bytes"] == pytest.approx(
        2 * (k * 4 + 4) * res["mean_touched_rows"] * n)
    # Eq. 5 / 6 payloads (W = 200, K = 8, P = 20, Pk = 4) on each leg; the
    # sim meter bills them once, and with one shard not at all
    by = res["bytes_by_phase"]
    assert by["dense.push"] == by["dense.pull"] == 2 * 200 * 8 * 4
    assert by["power.push"] == by["power.pull"] == 2 * 20 * 4 * 4
    if shards > 1:
        assert (by["dense.push"], by["power.push"]) == (
            ar["bytes_by_phase"]["dense"], ar["bytes_by_phase"]["power"])
    # a non-row payload crosses between lockstep shards only
    assert ("tokens" in by) == (shards > 1)
    assert len(res["ps_copies"]) == n
    assert np.mean([c["rows"] for c in res["ps_copies"]]) == \
        res["mean_touched_rows"]
    assert res["ps_retries"] == 0 and res["chaos_events"] == {}
    assert _no_transport_threads()


def test_ps_staleness_converges():
    res = cli.train_loop(cli.default_args(**_common(), backend="ps",
                                          staleness=2, ps_servers=3,
                                          ps_latency=0.001))
    assert np.isfinite(res["ppl"])
    assert np.isfinite(res["mean_r"]).all()
    assert res["staleness"] == 2
    assert res["ps_pull_wait_s"] >= 0 and res["ps_push_wait_s"] >= 0
    held = float(res["phi_acc"].double().sum())
    assert held == pytest.approx(res["tokens"], rel=1e-5)


def test_ps_crash_resume_matches_uninterrupted(tmp_path):
    """``--crash-at 5`` and the command again resumes at the m = 3 fence and
    ends where the uninterrupted run ends, bit for bit; the manifest holds
    the server's state."""
    kw = _common(minibatches=8, backend="ps", staleness=0, ps_servers=3,
                 ckpt_dir=str(tmp_path), ckpt_every=3)
    with pytest.raises(SystemExit):
        cli.train_loop(cli.default_args(**kw, crash_at=5))
    assert _no_transport_threads()
    res = cli.train_loop(cli.default_args(**kw))
    base = cli.train_loop(cli.default_args(**_common(
        minibatches=8, backend="ps", staleness=0, ps_servers=3)))
    assert res["first_m"] == 3
    assert res["mean_r"] == base["mean_r"][3:]
    assert res["iters"] == base["iters"][3:]
    assert torch.equal(res["phi_acc"], base["phi_acc"])
    extra, _ = ckpt.peek_extra(str(tmp_path))
    assert extra["ps"]["num_servers"] == 3
    assert extra["ps"]["staleness"] == 0
    assert extra["ps"]["ranges"] == [list(r) for r in
                                     ps.RowShards(200, 3).ranges]
    assert extra["ps"]["version"] == 6 and extra["ps"]["w_cap"] == 200


def test_ps_resume_rejects_mismatched_staleness(tmp_path):
    kw = _common(minibatches=6, backend="ps", ps_servers=3,
                 ckpt_dir=str(tmp_path), ckpt_every=2)
    cli.train_loop(cli.default_args(**kw, staleness=0))
    kw["minibatches"] = 10
    with pytest.raises(ValueError, match="staleness"):
        cli.train_loop(cli.default_args(**kw, staleness=2))


def test_ps_rejects_decay():
    msgs = []
    for mod, dev in ((cli, {"device": "cpu"}), (jcli, {})):
        kw = {k: v for k, v in _common().items() if k != "device"}
        with pytest.raises(ValueError, match="decay") as e:
            mod.train_loop(mod.default_args(**kw, **dev, backend="ps",
                                            decay="64,0.6"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_reference_ps_checkpoint_extra_reads_in_the_port(tmp_path):
    """A checkpoint the reference's driver wrote under ``--backend ps``: the
    port reads its ``extra['ps']`` as the reference does; its rng, a JAX
    key, is refused by the port's driver as for every JAX checkpoint."""
    from repro.dist import checkpoint as jckpt

    kw = dict(minibatches=2, docs_per_batch=8, vocab=60, topics=4,
              lambda_k=2, inner_iters=2, log_every=0, shards=1, seed=5,
              backend="ps", ps_servers=3, staleness=1, ckpt_every=2,
              ckpt_dir=str(tmp_path), fixed_len=True, len_buckets="16",
              warmup_buckets=False, ps_pull_timeout=TIMEOUT)
    jcli.train_loop(jcli.default_args(**kw))
    extra, step = ckpt.peek_extra(str(tmp_path))
    jextra, jstep = jckpt.peek_extra(str(tmp_path))
    assert step == jstep == 2 and extra == jextra
    assert extra["ps"] == {"num_servers": 3, "w_cap": 60,
                           "ranges": [[0, 20], [20, 40], [40, 60]],
                           "version": 2, "staleness": 1}
    assert extra["run"]["backend"] == "ps"
    with pytest.raises(ValueError, match="JAX PRNG key"):
        cli.train_loop(cli.default_args(**{**kw, "minibatches": 4},
                                        device="cpu"))

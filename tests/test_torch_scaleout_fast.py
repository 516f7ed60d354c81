"""The port's elastic scale-out machinery
(``deeplearning4j_tpu_torch.parallel.leases`` / ``transport`` /
``scaleout``) on the CPU: every test of ``tests/test_scaleout_fast.py`` —
lease-table invariants, the rejoin handshake over a loopback hub,
checkpoint-resume round arithmetic, the reconnect backoff schedule and the
concurrent-gather straggler deadline, with a numpy FakeNet — and the port
held against the JAX package: the lease tables give the same grants and
the same snapshot JSON under one seeded failure schedule, and the
scale-out frames and backoff schedule are the same bytes and numbers.
The jobs over real nets are ``tests/test_torch_scaleout.py``. Every
blocking wait is bounded."""

import os
import threading
import time
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import leases as jleases
from deeplearning4j_tpu.parallel import transport as jtransport
from deeplearning4j_tpu_torch.obs import SpanContext, get_registry
from deeplearning4j_tpu_torch.parallel import (LeaseTable, ParamAveragingHub,
                                               WorkerClient,
                                               read_resume_state,
                                               worker_main)
from deeplearning4j_tpu_torch.parallel import transport
from deeplearning4j_tpu_torch.parallel.leases import (GRANT_NONE, GRANT_OK,
                                                      GRANT_RETRY)
from deeplearning4j_tpu_torch.parallel.scaleout import atomic_write_text
from deeplearning4j_tpu_torch.parallel.transport import backoff_delays


class FakeNet:
    """Minimal params_flat/set_params_flat/fit contract — deterministic
    (fit adds the scalar 'dataset'), host numpy, instant."""

    def __init__(self, n=4, delay=0.0):
        self.p = np.zeros(n, np.float32)
        self.delay = delay
        self.fitted = []

    def fit(self, ds):
        if self.delay:
            time.sleep(self.delay)
        self.fitted.append(float(ds))
        self.p = self.p + np.float32(ds)

    def params_flat(self):
        return self.p

    def set_params_flat(self, v):
        self.p = np.asarray(v, np.float32).copy()


# ---------------------------------------------------------------------------
# LeaseTable invariants
# ---------------------------------------------------------------------------

def test_lease_affinity_reproduces_round_robin_partitioning():
    """While every slot is live, leases land exactly like the old static
    ``parts[i % n_workers]`` split, epoch-major FIFO."""
    t = LeaseTable(n_shards=5, epochs=2, n_workers=2)
    got = {0: [], 1: []}
    for _ in range(10):
        for w in (0, 1):
            st, item = t.acquire(w)
            if st == GRANT_OK:
                got[w].append(item)
                t.complete(w, item)
    assert got[0] == [0, 2, 4, 5, 7, 9]     # shards 0,2,4 × epochs 0,1
    assert got[1] == [1, 3, 6, 8]           # shards 1,3 × epochs 0,1
    assert t.all_done()


def test_lease_steal_requires_absent_slot_and_settled_provisioning():
    t = LeaseTable(n_shards=2, epochs=1, n_workers=2)
    # slot 1 unsettled (provisioning window): worker 0 must NOT steal
    st, _ = t.acquire(0, stealable_slots=(), unsettled_slots={1})
    assert st == GRANT_OK                       # its own item first
    st, _ = t.acquire(0, stealable_slots=(), unsettled_slots={1})
    assert st == GRANT_RETRY                    # item 1 held back
    # slot 1 live (not stealable, not unsettled): nothing for worker 0
    st, _ = t.acquire(0, stealable_slots=(), unsettled_slots=())
    assert st == GRANT_NONE
    # slot 1 absent and settled: steal, counted as a reassignment
    st, item = t.acquire(0, stealable_slots={1}, unsettled_slots=())
    assert st == GRANT_OK and item == 1 and t.reassigned == 1


def test_lease_release_reacquire_and_stale_complete():
    t = LeaseTable(n_shards=2, epochs=1, n_workers=2)
    st, item = t.acquire(1)
    assert st == GRANT_OK and item == 1
    assert t.release_worker(1) == [1]
    # stale completion from the dropped worker's ghost is accepted only
    # while the item is still unclaimed (spares a re-run) ...
    assert t.complete(1, 1)
    assert t.all_done() is False              # item 0 still open
    # ... but once re-leased, the new owner's completion is the one that
    # counts and a stale one is ignored
    t2 = LeaseTable(n_shards=1, epochs=1, n_workers=2)
    _, i0 = t2.acquire(0)
    t2.release_worker(0)
    _, i0b = t2.acquire(1, stealable_slots={0})
    assert i0b == i0 and t2.reassigned == 1
    assert not t2.complete(0, i0)             # ghost report ignored
    assert t2.complete(1, i0) and t2.all_done()
    assert not t2.complete(1, i0)             # double complete ignored


def test_lease_exactly_once_under_random_failure_schedule():
    """Fuzz: random acquire/complete/kill interleavings always end with
    every item DONE exactly once and no leases outstanding."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        t = LeaseTable(n_shards=7, epochs=2, n_workers=3)
        live = {0, 1, 2}
        for _ in range(10 * t.n_items):       # safety bound, never hit
            if t.all_done():
                break
            w = int(rng.choice(sorted(live)))
            if rng.random() < 0.1 and len(live) > 1:    # kill w
                live.discard(w)
                t.release_worker(w)
                continue
            dead_slots = {s for s in range(3)
                          if s not in {x % 3 for x in live}}
            st, item = t.acquire(w, stealable_slots=dead_slots)
            if st == GRANT_OK:
                assert t.complete(w, item)
        c = t.counts()
        assert c["done"] == t.n_items and c["leased"] == 0, (trial, c)


def test_lease_snapshot_restore_roundtrip_and_geometry_guard():
    t = LeaseTable(n_shards=3, epochs=2, n_workers=2)
    for w in (0, 1):
        st, item = t.acquire(w)
        t.complete(w, item)
    snap = t.snapshot()
    r = LeaseTable.restore(snap, n_shards=3, epochs=2, n_workers=4)
    assert r is not None and set(r.completed) == set(t.completed)
    # a different job shape must NOT resume from this stamp
    assert LeaseTable.restore(snap, n_shards=4, epochs=2, n_workers=2) is None
    assert LeaseTable.restore(snap, n_shards=3, epochs=1, n_workers=2) is None
    assert LeaseTable.restore("garbage{", 3, 2, 2) is None


# ---------------------------------------------------------------------------
# backoff schedule + checkpoint-resume arithmetic
# ---------------------------------------------------------------------------

def test_backoff_schedule_is_bounded_exponential():
    assert backoff_delays(0.5, 8.0, 6) == [0.5, 1.0, 2.0, 4.0, 8.0, 8.0]
    assert backoff_delays(0.1, 1.0, 0) == []


def test_read_resume_state_round_arithmetic(tmp_path):
    assert read_resume_state(tmp_path) is None           # fresh dir
    table = LeaseTable(4, epochs=2, n_workers=2)
    st, item = table.acquire(0)
    table.complete(0, item)
    # stamp order mirrors _checkpoint: leases first, round stamp LAST
    atomic_write_text(tmp_path / "leases.json", table.snapshot())
    assert read_resume_state(tmp_path) is None           # no stamp yet
    atomic_write_text(tmp_path / "round.txt", "3")
    rnd, snap = read_resume_state(tmp_path)
    assert rnd == 3
    restored = LeaseTable.restore(snap, 4, 2, 2)
    assert restored.completed == (0,)
    # corrupt stamp -> treated as no resume, not a crash
    (tmp_path / "round.txt").write_text("not-a-round")
    assert read_resume_state(tmp_path) is None


def test_atomic_write_replaces_without_torn_state(tmp_path):
    p = tmp_path / "round.txt"
    atomic_write_text(p, "1")
    atomic_write_text(p, "2")
    assert p.read_text() == "2"
    assert not (tmp_path / "round.txt.tmp").exists()


def test_save_model_is_atomic_against_midwrite_crash(tmp_path, monkeypatch):
    """A crash while writing the checkpoint zip must leave the previous
    ``latest.zip`` byte-identical — master restart depends on it."""
    from deeplearning4j_tpu_torch.nn import (DenseLayer, MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    from deeplearning4j_tpu_torch.serde import model_serializer as ms
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_in=3, n_out=4, activation="tanh"))
            .layer(OutputLayer(n_in=4, n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    path = tmp_path / "latest.zip"
    ms.save_model(net, path)
    good = path.read_bytes()
    assert zipfile.is_zipfile(path) and not \
        (tmp_path / "latest.zip.tmp").exists()

    def boom(zf, name, tree):
        raise OSError("disk full (injected)")
    monkeypatch.setattr(ms, "_save_npz", boom)
    with pytest.raises(OSError, match="injected"):
        ms.save_model(net, path)
    assert path.read_bytes() == good        # old artifact untouched


# ---------------------------------------------------------------------------
# loopback hub: rejoin handshake, reassignment, straggler deadline
# ---------------------------------------------------------------------------

def _run_workers(hub, bodies):
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:   # noqa: BLE001 — surfaced in asserts
            errs.append(e)
    ts = [threading.Thread(target=wrap, args=(b,), daemon=True)
          for b in bodies]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return errs


def test_lease_job_over_loopback_hub_consumes_every_item_once():
    table = LeaseTable(n_shards=4, epochs=1, n_workers=2)
    hub = ParamAveragingHub(n_workers=2, worker_timeout=5.0,
                            lease_table=table).start()
    nets = [FakeNet(), FakeNet()]
    data = [1., 2., 3., 4.]
    errs = _run_workers(hub, [
        lambda i=i: worker_main(hub.address, nets[i], data, 2, worker_id=i,
                                lease=True, worker_timeout=8.0)
        for i in range(2)])
    final = hub.result(timeout=10)
    assert errs == []
    assert table.all_done() and table.counts()["reassigned"] == 0
    # affinity: w0 fitted shards {0,2}, w1 {1,3} — the old static split
    assert sorted(nets[0].fitted) == [1., 3.]
    assert sorted(nets[1].fitted) == [2., 4.]
    np.testing.assert_allclose(final, np.full(4, 5.0))   # mean(4, 6)


def test_rejoin_handshake_resumes_from_live_state():
    """Kill worker 1 mid-job; a replacement HELLOs under the same id,
    receives the REJOIN ack (current round + current mean), and the job
    completes with every partition consumed."""
    reg = get_registry()
    rejoins0 = reg.counter("dl4j_scaleout_rejoins_total").value()
    table = LeaseTable(n_shards=4, epochs=1, n_workers=2)
    hub = ParamAveragingHub(n_workers=2, worker_timeout=3.0,
                            lease_table=table).start()
    data = [1., 2., 3., 4.]
    n0, n1, n1b = FakeNet(), FakeNet(), FakeNet()

    def victim_then_rejoin():
        with pytest.raises(RuntimeError, match="injected"):
            worker_main(hub.address, n1, data, 1, fail_after_steps=1,
                        worker_id=1, lease=True, worker_timeout=6.0)
        assert hub.wait_dropped(1, timeout=5)
        worker_main(hub.address, n1b, data, 1, worker_id=1, lease=True,
                    worker_timeout=6.0)

    with pytest.warns(UserWarning, match="failed mid-job"):
        errs = _run_workers(hub, [
            lambda: worker_main(hub.address, n0, data, 1, worker_id=0,
                                lease=True, worker_timeout=6.0),
            victim_then_rejoin])
    final = hub.result(timeout=10)
    assert errs == []
    assert final is not None and table.all_done()
    assert hub.rejoins == 1 and hub.dropped == [1]
    assert reg.counter("dl4j_scaleout_rejoins_total").value() == rejoins0 + 1
    # the rejoiner adopted the job's live mean before its first fit (its
    # params are NOT a from-zero trajectory: it fitted at most its own
    # leases on top of an averaged state)
    assert n1b.fitted != []


def test_rejoin_ack_carries_current_mean_params():
    hub = ParamAveragingHub(n_workers=2, worker_timeout=2.0).start()
    a = WorkerClient(hub.address, worker_id=0, timeout=5.0)
    b = WorkerClient(hub.address, worker_id=1, timeout=5.0)
    assert a.rejoin_params is None            # no round yet
    r = {}
    t = threading.Thread(
        target=lambda: r.update(m=a.average(np.full(3, 2.0, np.float32))))
    t.start()
    mb = b.average(np.full(3, 4.0, np.float32))
    t.join(timeout=10)
    np.testing.assert_allclose(mb, np.full(3, 3.0))
    # a later (re)joiner is handed round + current mean in the ack
    c = WorkerClient(hub.address, worker_id=7, timeout=5.0)
    assert c.round_offset == 1
    np.testing.assert_allclose(c.rejoin_params, np.full(3, 3.0))
    for cl in (a, b, c):
        cl.done()
    hub.result(timeout=5)


def test_duplicate_worker_id_gets_distinct_assigned_identity():
    """A live-duplicate dialer is uniquified by the hub at _register;
    the REJOIN ack echoes the registered wid so the worker's drift
    audit labels by hub-side identity instead of overwriting the
    colliding worker's replica series."""
    hub = ParamAveragingHub(n_workers=2, worker_timeout=2.0).start()
    a = WorkerClient(hub.address, worker_id=3, timeout=5.0)
    b = WorkerClient(hub.address, worker_id=3, timeout=5.0)
    assert a.assigned_id == 3
    assert b.assigned_id != 3          # uniquified, and the worker knows
    r = {}
    t = threading.Thread(
        target=lambda: r.update(m=a.average(np.full(2, 1.0, np.float32))))
    t.start()
    mb = b.average(np.full(2, 3.0, np.float32))
    t.join(timeout=10)
    np.testing.assert_allclose(mb, np.full(2, 2.0))
    for cl in (a, b):
        cl.done()
    hub.result(timeout=5)


@pytest.mark.filterwarnings("ignore:scaleout. worker")
def test_straggler_times_out_alone_round_closes_at_deadline():
    """Head-of-line fix: a healthy worker's round closes at the deadline
    with the frames that landed; the hung worker stalls only itself."""
    hub = ParamAveragingHub(n_workers=2, worker_timeout=1.0).start()
    a = WorkerClient(hub.address, worker_id=0, timeout=10.0)
    _straggler = WorkerClient(hub.address, worker_id=1, timeout=10.0)
    t0 = time.monotonic()
    mean = a.average(np.full(2, 6.0, np.float32))     # b never contributes
    took = time.monotonic() - t0
    np.testing.assert_allclose(mean, np.full(2, 6.0))  # averaged alone
    assert 0.5 <= took < 5.0, took
    a.done()
    hub.stop()


def test_worker_with_timeout_gets_clean_connection_error_not_hang():
    """The worker-hang bug: hub dies at broadcast →
    a worker with a finite timeout and no retry budget raises a clean
    ConnectionError instead of blocking forever in average()."""
    hub = ParamAveragingHub(n_workers=1, worker_timeout=5.0).start()
    cl = WorkerClient(hub.address, worker_id=0, timeout=3.0, max_retries=0)
    hub.stop()
    with pytest.raises(ConnectionError, match="not recovered"):
        cl.average(np.ones(2, np.float32))


def test_worker_client_reattaches_to_restarted_hub(tmp_path):
    """Master restart: hub 1 dies mid-job; hub 2 binds the SAME address
    with the checkpointed mean; the worker's bounded retry-with-backoff
    re-dials, re-HELLOs, and finishes the job."""
    path = str(tmp_path / "hub.sock")        # AF_UNIX: restartable addr
    table = LeaseTable(n_shards=6, epochs=1, n_workers=1)
    hub1 = ParamAveragingHub(n_workers=1, address=path, worker_timeout=3.0,
                             lease_table=table, fail_after_rounds=2).start()
    net = FakeNet(delay=0.1)
    res = {}

    def w():
        worker_main(path, net, [1., 2., 3., 4., 5., 6.], 1, worker_id=0,
                    lease=True, worker_timeout=4.0, max_retries=8,
                    backoff_base=0.1, backoff_max=1.0)
        res["ok"] = True

    t = threading.Thread(target=w, daemon=True)
    t.start()
    deadline = time.monotonic() + 20
    while not hub1.fail_injected and time.monotonic() < deadline:
        time.sleep(0.05)
    assert hub1.fail_injected
    mean1 = hub1.result(timeout=5)
    hub2 = ParamAveragingHub(n_workers=1, address=path, worker_timeout=3.0,
                             lease_table=table, start_round=hub1.rounds,
                             initial_params=mean1).start()
    t.join(timeout=30)
    final = hub2.result(timeout=10)
    assert res.get("ok"), "worker did not survive the master restart"
    assert table.all_done()
    assert hub2.rounds > hub1.rounds        # round numbering continued
    assert final is not None


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lease_table_matches_reference_under_failure_schedule(seed):
    """One seeded schedule of acquire / complete / worker deaths (with
    steal and provisioning sets) through both packages' tables: the same
    grants, completions, releases, counts and snapshot JSON."""
    rng = np.random.default_rng(seed)
    ours = LeaseTable(n_shards=7, epochs=2, n_workers=3)
    ref = jleases.LeaseTable(n_shards=7, epochs=2, n_workers=3)
    live = {0, 1, 2}
    for _ in range(200):
        if ours.all_done():
            break
        w = int(rng.choice(sorted(live)))
        r = rng.random()
        if r < 0.1 and len(live) > 1:
            live.discard(w)
            assert ours.release_worker(w) == ref.release_worker(w)
            continue
        dead = {s for s in range(3) if s not in {x % 3 for x in live}}
        unsettled = {int(rng.integers(0, 3))} if r > 0.9 else set()
        a = ours.acquire(w, stealable_slots=dead, unsettled_slots=unsettled)
        b = ref.acquire(w, stealable_slots=dead, unsettled_slots=unsettled)
        assert a == b
        if a[0] == GRANT_OK and rng.random() < 0.9:
            assert ours.complete(w, a[1]) == ref.complete(w, a[1])
        ghost = int(rng.integers(0, ours.n_items))
        assert ours.complete(w, ghost) == ref.complete(w, ghost)
        assert ours.counts() == ref.counts()
        assert ours.snapshot() == ref.snapshot()
    snap = ref.snapshot()
    mine = LeaseTable.restore(snap, 7, 2, 3)
    theirs = jleases.LeaseTable.restore(ours.snapshot(), 7, 2, 3)
    assert mine.completed == theirs.completed == ours.completed


def test_scaleout_wire_constants_and_frames_match_reference():
    for name in ("KIND_PARAMS", "KIND_DONE", "KIND_HELLO", "KIND_SPANCTX",
                 "KIND_REJOIN", "KIND_LEASE_REQ", "KIND_LEASE",
                 "KIND_LEASE_DONE", "KIND_FLEET_SUBMIT",
                 "KIND_FLEET_RESULT"):
        assert getattr(transport, name) == getattr(jtransport, name), name
    assert transport.FRAME_HEADER.format == jtransport.FRAME_HEADER.format
    for args in ((0.5, 8.0, 6), (0.1, 1.0, 0), (0.25, 3.0, 9)):
        assert backoff_delays(*args) == jtransport.backoff_delays(*args)
    ctx = SpanContext("0123456789abcdef", "fedcba9876543210")
    from deeplearning4j_tpu.obs import SpanContext as JSpanContext
    jctx = JSpanContext("0123456789abcdef", "fedcba9876543210")
    assert transport.pack_span_context(ctx) == \
        jtransport.pack_span_context(jctx)
    assert transport.pack_span_context(None) == b""
    back = transport.unpack_span_context(jtransport.pack_span_context(jctx))
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert transport.unpack_span_context(b"\xff\xfe") is None


def test_port_worker_talks_to_reference_hub():
    """A port worker against the JAX package's hub (and the reverse): the
    frames are the same bytes, so the job runs across packages."""
    from deeplearning4j_tpu.parallel import ParamAveragingHub as JHub
    from deeplearning4j_tpu.parallel import WorkerClient as JClient
    for hub_cls, a_cls, b_cls in ((JHub, WorkerClient, JClient),
                                  (ParamAveragingHub, JClient,
                                   WorkerClient)):
        hub = hub_cls(n_workers=2, worker_timeout=5.0).start()
        try:
            a = a_cls(hub.address, worker_id=0, timeout=5.0)
            b = b_cls(hub.address, worker_id=1, timeout=5.0)
            r = {}
            t = threading.Thread(target=lambda: r.update(
                m=a.average(np.full(3, 1.0, np.float32))), daemon=True)
            t.start()
            mb = b.average(np.full(3, 5.0, np.float32))
            t.join(timeout=10)
            np.testing.assert_array_equal(mb, np.full(3, 3.0, np.float32))
            np.testing.assert_array_equal(r["m"], mb)
            assert a.last_round == b.last_round == 1
            a.done()
            b.done()
            assert hub.result(timeout=10) is not None
        finally:
            hub.stop()

"""The port's SLO plane (``obs.reqtrace``, ``obs.slo``) against the JAX
package's, on the CPU: the same event streams with explicit timestamps
give equal trace derivations, records and span trees (identical ids),
equal ``SLOTracker.report()`` dicts and equal gauges; a FlightRecorder
dump written by each package loads in the other.
"""

from __future__ import annotations

import json
import math

import pytest

import deeplearning4j_tpu.obs as jobs
import deeplearning4j_tpu_torch.obs as tobs

T0_EPOCH, T0_PERF = 1_700_000_000.25, 100.0


def _trace(obs, rid=0, replica="0", ttft=0.1, gaps=(0.01, 0.01),
           fail=False, kind="generate"):
    """The reference test's synthetic lifecycle, on ``obs``'s
    RequestTrace, with a fixed clock anchor."""
    tr = obs.RequestTrace(request_id=rid, replica=replica, kind=kind,
                          t0_epoch=T0_EPOCH, t0_perf=T0_PERF)
    t = 100.0
    tr.event("submit", ts=t)
    tr.event("queue", ts=t)
    tr.event("admit", ts=t + ttft / 2, slot=0)
    tr.event("prefill", ts=t + ttft, slot=0, tokens=4, time_s=ttft / 2)
    tr.event("token", ts=t + ttft, i=0)
    for i, g in enumerate(gaps):
        t += g
        tr.event("token", ts=t + ttft, i=i + 1)
    if fail:
        tr.event("fail", ts=t + ttft, error="boom")
    else:
        tr.event("finish", ts=t + ttft, reason="length")
    return tr


def _preempted(obs):
    tr = obs.RequestTrace(request_id=1, t0_epoch=T0_EPOCH,
                          t0_perf=T0_PERF)
    tr.event("submit", ts=0.0)
    tr.event("prefill", ts=0.1, slot=0, tokens=3, time_s=0.1)
    tr.event("token", ts=0.1, i=0)
    tr.event("token", ts=0.11, i=1)
    tr.event("preempt", ts=0.112, slot=0, generated=2)
    tr.event("requeue", ts=0.112)
    tr.event("prefill", ts=0.5, slot=1, tokens=5, time_s=0.05)
    tr.event("token", ts=0.5, i=2)
    tr.event("token", ts=0.51, i=3)
    tr.event("finish", ts=0.52, reason="length")
    return tr


@pytest.mark.parametrize("make", [
    lambda o: _trace(o, ttft=0.2, gaps=(0.01, 0.03, 0.02)),
    lambda o: _trace(o, fail=True, kind="score"),
    lambda o: _trace(o, gaps=()),
    _preempted,
], ids=["plain", "failed", "one_token", "requeue_gap"])
def test_trace_derivations_and_records_equal(make):
    j, t = make(jobs), make(tobs)
    assert t.summary() == j.summary()
    assert t.to_record() == j.to_record()
    assert t.itl_samples() == j.itl_samples()
    assert (t.ttft_s(), t.latency_s(), t.finish_reason(), t.n_tokens(),
            t.preemptions()) == (j.ttft_s(), j.latency_s(),
                                 j.finish_reason(), j.n_tokens(),
                                 j.preemptions())


def test_requeue_gap_is_an_itl_sample():
    itl = _preempted(tobs).itl_samples()
    assert itl == pytest.approx([0.01, 0.39, 0.01])


def test_span_trees_have_identical_ids():
    jt, tt = jobs.Tracer(), tobs.Tracer()
    js = _trace(jobs, rid=7, replica="r1", gaps=(0.01, 0.02)) \
        .assemble_spans(jt)
    ts = _trace(tobs, rid=7, replica="r1", gaps=(0.01, 0.02)) \
        .assemble_spans(tt)
    assert [s.record() for s in ts] == [s.record() for s in js]
    root = ts[-1]
    assert root.name == "serving.request" and root.parent_id is None
    assert len({s.trace_id for s in tt.spans()}) == 1


def _cfg(obs, **kw):
    base = dict(ttft_s=0.5, itl_s=0.05, quantile=0.9,
                max_error_rate=0.1, window_s=math.inf)
    base.update(kw)
    return obs.SLOConfig(**base)


def _stream(obs, tracker):
    for i in range(8):
        tracker.observe(_trace(obs, rid=i, ttft=0.1, gaps=(0.01, 0.02)),
                        ts=float(i))
    tracker.observe(_trace(obs, rid=8, ttft=0.9, gaps=(0.01,)), ts=8.0)
    tracker.observe(_trace(obs, rid=9, ttft=0.1, gaps=(0.2,),
                           kind="beam"), ts=9.0)
    tracker.observe(_trace(obs, rid=10, fail=True), ts=10.0)
    assert tracker.observe_summary({"status": "cancel"}) is None


def test_slo_reports_and_gauges_equal():
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jtr = jobs.SLOTracker(_cfg(jobs), replica="2", registry=jreg)
    ttr = tobs.SLOTracker(_cfg(tobs), replica="2", registry=treg)
    _stream(jobs, jtr)
    _stream(tobs, ttr)
    rep = ttr.report()
    assert rep == jtr.report()
    assert rep["window"]["requests"] == 11
    assert rep["goodput"] == pytest.approx(8 / 11)
    assert rep["by_kind"]["beam"]["goodput"] == 0.0
    assert rep["met"] is False
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.get("dl4j_slo_window_requests").value(replica="2") == 11
    assert (ttr.goodput(), ttr.error_rate(), ttr.burn_rate(),
            ttr.latest_ts) == (jtr.goodput(), jtr.error_rate(),
                               jtr.burn_rate(), jtr.latest_ts)


@pytest.mark.parametrize("kw,ts", [
    (dict(window_s=10.0), (0.0, 5.0, 11.0)),
    (dict(window_max=4), tuple(float(i) for i in range(10))),
], ids=["window_s", "window_max"])
def test_slo_window_pruning_equal(kw, ts):
    jtr = jobs.SLOTracker(_cfg(jobs, **kw), registry=False)
    ttr = tobs.SLOTracker(_cfg(tobs, **kw), registry=False)
    for i, t in enumerate(ts):
        bad = i == 0
        jtr.observe(_trace(jobs, ttft=0.9 if bad else 0.1), ts=t)
        ttr.observe(_trace(tobs, ttft=0.9 if bad else 0.1), ts=t)
    assert ttr.report() == jtr.report()
    assert ttr.report()["window"]["requests"] == (2 if "window_s" in kw
                                                  else 4)


def test_slo_empty_report_and_config_validation():
    assert tobs.SLOTracker(registry=False).report() == \
        jobs.SLOTracker(registry=False).report()
    for bad in (dict(quantile=1.5), dict(ttft_s=-1.0), dict(itl_s=0.0)):
        with pytest.raises(ValueError) as jerr:
            jobs.SLOConfig(**bad)
        with pytest.raises(ValueError) as terr:
            tobs.SLOConfig(**bad)
        assert str(terr.value) == str(jerr.value)


def _fill(obs, fr):
    for i in range(5):
        fr.record_request(_trace(obs, rid=i, replica=fr.replica))
        fr.record_snapshot(step=i, slots=[i, None], queue=[],
                           queue_depth=0, occupancy=0.5, ts=float(i))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flight_recorder_dumps_load_in_both_packages(tmp_path, writer):
    wobs = tobs if writer == "port" else jobs
    fr = wobs.FlightRecorder(capacity_requests=3, capacity_snapshots=2,
                             replica="9")
    _fill(wobs, fr)
    assert [t.request_id for t in fr.requests()] == [2, 3, 4]
    assert [s["step"] for s in fr.snapshots()] == [3, 4]
    path = fr.dump(tmp_path / "bb.jsonl", reason="test")
    with open(path, "a") as f:
        f.write('{"kind": "reqtrace", "request_id": 9, "summ')
    mine, theirs = tobs.load_flight_records(path), \
        jobs.load_flight_records(path)
    for recs in (mine, theirs):
        for r in recs:
            r.pop("dumped_at", None)
    assert mine == theirs
    kinds = [r["kind"] for r in mine]
    assert kinds.count("reqtrace") == 3 and kinds.count("snapshot") == 2
    assert mine[0]["kind"] == "flightrec" and mine[0]["reason"] == "test"
    st = fr.debug_state()
    assert st["replica"] == "9" and st["requests_recorded"] == 3 \
        and st["last_snapshot"]["step"] == 4 and fr.dumps == 1
    # the two packages write the same records
    other = (jobs if writer == "port" else tobs).FlightRecorder(
        capacity_requests=3, capacity_snapshots=2, replica="9")
    _fill(jobs if writer == "port" else tobs, other)
    opath = other.dump(tmp_path / "other.jsonl", reason="test")
    a = [json.loads(ln) for ln in open(path).read().splitlines()[:-1]]
    b = [json.loads(ln) for ln in open(opath)]
    for r in a + b:
        r.pop("dumped_at", None)
        r.pop("ts", None) if r.get("kind") == "memcensus" else None
    assert [r for r in a if r["kind"] != "memcensus"] == \
        [r for r in b if r["kind"] != "memcensus"]


def test_live_flight_recorders_and_torn_lines(tmp_path):
    fr = tobs.FlightRecorder(replica="zz-live")
    assert any(r is fr for r in tobs.live_flight_recorders())
    p = tmp_path / "torn.jsonl"
    p.write_text(json.dumps({"kind": "snapshot", "step": 1}) + "\n"
                 + json.dumps({"kind": "ignored"}) + "\n"
                 + '{"kind": "reqtrace", "request_id": 1, "summ')
    recs = tobs.load_flight_records(p)
    assert len(recs) == 1 and recs[0]["step"] == 1
    assert recs == jobs.load_flight_records(p)
    assert tobs.load_flight_records(tmp_path / "missing.jsonl") == []

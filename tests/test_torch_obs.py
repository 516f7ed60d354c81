"""The port's observability core (``deeplearning4j_tpu_torch.obs``: the
registry, spans, the compile sentinel's metrics, fidelity probes) against
the JAX package's ``obs``, on the CPU.

- the same sequence of operations on both registries renders
  byte-identical Prometheus text, equal snapshots and quantiles, and both
  refuse the same bad registrations;
- ``derived_span_id`` ids and ``SpanContext`` headers are identical and
  cross-load; span nesting, sync on tensors, JSONL export read back by
  both packages' ``load_spans``;
- ``MetricsListener`` registers the reference's names, kinds, help and
  labels (byte-identical exposition);
- the compile sentinel counts, times and spans compiles of a
  ``CompiledStep`` and warns on a retrace after ``mark_warm``;
- fidelity reports equal the reference's on the same logits;
- the reference's metric-name lint passes over the port's sites.
"""

from __future__ import annotations

import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.obs as jobs
import deeplearning4j_tpu_torch.obs as tobs
from deeplearning4j_tpu.obs import fidelity as jfid
from deeplearning4j_tpu_torch.obs import fidelity as tfid

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"


def _drive(reg):
    """One fixed sequence of registry operations."""
    c = reg.counter("dl4j_t_requests_total", "Requests\nseen",
                    labelnames=("reason",))
    c.inc(reason="eos")
    c.inc(2.5, reason="length")
    c.inc(reason='we"ird\\')
    reg.counter("dl4j_t_plain_total", "plain")
    g = reg.gauge("dl4j_t_depth", "Queue depth", labelnames=("replica",))
    g.set(3, replica="0")
    g.inc(0.25, replica="1")
    g.dec(1.0, replica="1")
    reg.gauge("dl4j_t_unlabeled", "").set(1e16)
    h = reg.histogram("dl4j_t_seconds", "Latency")
    for v in (1e-5, 3e-4, 0.002, 0.002, 0.5, 7.0, 300.0):
        h.observe(v)
    h.observe_many([0.01, 0.02, 1e-4])
    hb = reg.histogram("dl4j_t_ratio", "Ratio", labelnames=("kind",),
                       buckets=tuple(i / 20 for i in range(1, 21)))
    hb.observe_many([0.05, 0.3, 0.99, 1.5], kind="beam")
    hb.observe(float("nan"), kind="score")
    return reg


def test_prometheus_text_is_byte_identical():
    j, t = _drive(jobs.MetricsRegistry()), _drive(tobs.MetricsRegistry())
    assert t.to_prometheus() == j.to_prometheus()
    assert json.dumps(t.snapshot(), sort_keys=True, default=str) == \
        json.dumps(j.snapshot(), sort_keys=True, default=str)
    for q in (0.0, 0.3, 0.5, 0.95, 1.0):
        assert t.get("dl4j_t_seconds").quantile(q) == \
            j.get("dl4j_t_seconds").quantile(q)
    assert t.names() == j.names()
    assert jobs.MetricsRegistry().to_prometheus() == \
        tobs.MetricsRegistry().to_prometheus() == ""


@pytest.mark.parametrize("bad", [
    lambda r: r.counter("dl4j_x", "no _total"),
    lambda r: r.gauge("other_x", "outside the namespace"),
    lambda r: r.gauge("dl4j_bad-name", ""),
    lambda r: (r.gauge("dl4j_dup", ""), r.counter("dl4j_dup_total", ""),
               r.histogram("dl4j_dup", "")),
    lambda r: (r.gauge("dl4j_lab", "", labelnames=("a",)),
               r.gauge("dl4j_lab", "", labelnames=("b",))),
    lambda r: r.gauge("dl4j_lab2", "", labelnames=("a",)).set(1, b="x"),
    lambda r: r.counter("dl4j_neg_total", "").inc(-1),
    lambda r: r.histogram("dl4j_hq", "").quantile(1.5),
    lambda r: r.histogram("dl4j_hb", "", buckets=(0.0, 1.0)),
], ids=["counter_suffix", "namespace", "name", "kind_mismatch",
        "label_mismatch", "label_values", "negative_inc", "quantile",
        "buckets"])
def test_registry_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as jerr:
        bad(jobs.MetricsRegistry())
    with pytest.raises(ValueError) as terr:
        bad(tobs.MetricsRegistry())
    assert str(terr.value) == str(jerr.value)


def test_label_children_write_what_keyword_writes_write():
    """``labels()`` resolves a label set once; its writes render the
    same exposition as the keyword writes of the reference."""
    j, t = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jc = j.counter("dl4j_c_total", "c", labelnames=("kind",))
    tc = t.counter("dl4j_c_total", "c", labelnames=("kind",)).labels(
        kind="beam")
    jg = j.gauge("dl4j_g", "g", labelnames=("replica", "kind"))
    tg = t.gauge("dl4j_g", "g", labelnames=("replica", "kind")).labels(
        kind="score", replica="0")
    jh = j.histogram("dl4j_h", "h", labelnames=("kind",))
    th = t.histogram("dl4j_h", "h", labelnames=("kind",)).labels(kind="x")
    t.gauge("dl4j_unused", "u", labelnames=("replica",)).labels(replica="1")
    j.gauge("dl4j_unused", "u", labelnames=("replica",))
    for v in (1.0, 2.5):
        jc.inc(v, kind="beam")
        tc.inc(v)
        jg.set(v, replica="0", kind="score")
        tg.set(v)
        jh.observe(v / 10, kind="x")
        th.observe(v / 10)
    jg.dec(0.5, replica="0", kind="score")
    tg.dec(0.5)
    assert t.to_prometheus() == j.to_prometheus()
    with pytest.raises(ValueError, match="only go up"):
        tc.inc(-1)
    with pytest.raises(ValueError, match="do not match"):
        t.get("dl4j_g").labels(replica="0")


def test_registry_get_or_create_and_reset():
    reg = tobs.MetricsRegistry()
    a = reg.counter("dl4j_same_total", "h", labelnames=("kind",))
    assert reg.counter("dl4j_same_total", "other help",
                       labelnames=("kind",)) is a
    a.inc(kind="beam")
    reg.reset()
    assert reg.names() == [] and a.value(kind="beam") == 1.0
    assert tobs.get_registry() is tobs.get_registry()


@pytest.mark.parametrize("parts", [("dl4j_serving", "0", 3, "12.500000"),
                                   ("abc",), ("t", "prefill", 0),
                                   ("dl4j_compile", "decode_step")])
def test_derived_span_ids_identical(parts):
    assert tobs.derived_span_id(*parts) == jobs.derived_span_id(*parts)


def test_span_context_headers_cross_load():
    ctx = tobs.SpanContext("0123456789abcdef", "fedcba9876543210")
    hdr = ctx.to_header()
    assert hdr == jobs.SpanContext(ctx.trace_id, ctx.span_id).to_header()
    back = jobs.SpanContext.from_header(hdr)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert tobs.SpanContext.from_header(hdr) == ctx
    for bad in (None, "", "{not json", json.dumps({"trace_id": 1})):
        assert tobs.SpanContext.from_header(bad) is None
        assert jobs.SpanContext.from_header(bad) is None


def test_span_nesting_sync_and_jsonl_export(tmp_path):
    tracer = tobs.Tracer(max_spans=3)
    with tracer.span("root", attrs={"k": 1}) as root:
        with tracer.span("child", sync={"a": [torch.ones(3)],
                                        "b": (torch.zeros(2), 5)}) as ch:
            assert tracer.current_context() == ch.context
        remote = tobs.SpanContext("t" * 16, "s" * 16)
        with tracer.use_context(remote):
            with tracer.span("adopted") as ad:
                pass
    assert ch.parent_id == root.span_id and ch.trace_id == root.trace_id
    assert ch.synced and not root.synced
    assert ad.trace_id == "t" * 16 and ad.parent_id == "s" * 16
    assert tracer.current_context() is None
    # the ring keeps the newest spans; drops are counted
    with tracer.span("late"):
        pass
    assert [s.name for s in tracer.spans()] == ["adopted", "root", "late"]
    assert tracer.dropped == 1
    path = tmp_path / "spans.jsonl"
    assert tracer.export_jsonl(path, clear=True) == 3
    assert tracer.spans() == []
    with open(path, "a") as f:
        f.write('{"kind": "span", "name": "torn')
    mine, theirs = tobs.load_spans(path), jobs.load_spans(path)
    assert mine == theirs and [r["name"] for r in mine] == \
        ["adopted", "root", "late"]
    assert set(mine[0]) == {"kind", "name", "trace_id", "span_id",
                            "parent_id", "start_ts", "time_s", "synced",
                            "attrs"}
    assert tobs.load_spans(tmp_path / "missing.jsonl") == []


def test_span_sync_waits_on_nothing_for_host_values():
    from deeplearning4j_tpu_torch.obs.spans import block_until_ready
    assert block_until_ready(torch.ones(2))
    assert block_until_ready([1, {"x": np.ones(2)}])


def test_metrics_listener_registers_the_reference_metrics():
    from deeplearning4j_tpu.nn.listeners import MetricsListener as JML
    from deeplearning4j_tpu_torch.nn.listeners import MetricsListener as TML
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    JML(registry=jreg)
    TML(registry=treg)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.names() == [
        "dl4j_device_memory_bytes", "dl4j_obs_overhead_seconds_total",
        "dl4j_train_epochs_total", "dl4j_train_examples_per_second",
        "dl4j_train_examples_total", "dl4j_train_iterations_total",
        "dl4j_train_loss", "dl4j_train_step_seconds"]


def _compiled(fn, name):
    from deeplearning4j_tpu_torch.nn._compiled import CompiledStep
    return CompiledStep(fn, tuple, name)


def test_compile_sentinel_metrics_spans_and_retraces():
    reg = tobs.MetricsRegistry()
    s = tobs.CompileSentinel("probe", _compiled(lambda x: x * 2, "probe"),
                             registry=reg)
    tracer = tobs.get_tracer()
    s(torch.ones(3))
    s(torch.ones(3))
    s(torch.ones(4))
    assert s.compiles == 2 and len(s.signatures) == 2
    total = reg.get("dl4j_compile_total")
    assert total.value(component="probe") == 2
    assert reg.get("dl4j_compile_seconds").count(component="probe") == 2
    tid = jobs.derived_span_id("dl4j_compile", "probe")
    spans = [sp for sp in tracer.spans() if sp.trace_id == tid]
    assert [sp.span_id for sp in spans[-2:]] == [
        jobs.derived_span_id(tid, 1), jobs.derived_span_id(tid, 2)]
    assert spans[-1].name == "compile.probe" and \
        spans[-1].attrs["retrace"] is False
    s.mark_warm()
    s(torch.ones(3))                        # seen: no compile
    assert s.retraces_after_warm == 0
    with pytest.warns(RuntimeWarning, match="retrace"):
        s(torch.ones(5))
    assert s.retraces_after_warm == 1
    assert reg.get("dl4j_compile_retraces_total").value(
        component="probe") == 1
    assert s.report() == {"name": "probe", "compiles": 3, "signatures": 3,
                          "warm": True, "retraces_after_warm": 1}
    assert s.overhead_seconds > 0
    # the wrapper is transparent: other attributes are the step's
    assert s.calls["direct"] == 5 and s.last == "direct"


def test_compile_metrics_exposition_matches_reference():
    """The sentinel's three instruments render as the reference's: the
    same names, help, kinds and label names (observed values aside)."""
    import jax
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    js = jobs.CompileSentinel("decode_step", jax.jit(lambda x: x + 1),
                              registry=jreg)
    ts = tobs.CompileSentinel("decode_step",
                              _compiled(lambda x: x + 1, "decode_step"),
                              registry=treg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js(np.ones(3, np.float32))
        ts(torch.ones(3))

    def shape(text):
        return [ln.split(" ")[0] if not ln.startswith("#") else ln
                for ln in text.splitlines()]
    assert shape(treg.to_prometheus()) == shape(jreg.to_prometheus())
    assert treg.get("dl4j_compile_total").value(component="decode_step") \
        == jreg.get("dl4j_compile_total").value(component="decode_step") == 1


def _logits(seed, shape=(2, 5, 17)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3


def test_compare_logits_matches_reference():
    ref, cand = _logits(0), _logits(0) + 0.05 * _logits(1)
    cand[1, 3] = ref[1, 3][::-1]              # a greedy mismatch
    want = jfid.compare_logits(ref, cand, top_k=4)
    got = tfid.compare_logits(torch.as_tensor(ref), torch.as_tensor(cand),
                              top_k=4)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert got == tfid.compare_logits(ref, cand, top_k=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfid.compare_logits(ref, cand[:1])


def test_fidelity_probe_gauges_match_reference():
    ref, cand = _logits(2, (6, 11)), _logits(3, (6, 11))
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jrep = jobs.FidelityProbe("bf16_vs_fp32", registry=jreg).compare(
        ref, cand)
    trep = tobs.FidelityProbe("bf16_vs_fp32", registry=treg).compare(
        torch.as_tensor(ref), torch.as_tensor(cand))
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert trep["kind"] == jrep["kind"] == "bf16_vs_fp32"
    assert tfid.latest_reports()[-1]["kind"] == "bf16_vs_fp32"
    tfid.reset_reports()
    assert tfid.latest_reports() == []
    seen = []
    tobs.FidelityProbe("pair", registry=treg).run(
        lambda x: seen.append("ref") or x, lambda x: seen.append("cand") or x,
        torch.ones(2, 3))
    assert seen == ["ref", "cand"]


def test_compare_trees_and_measured_bounds():
    rng = np.random.default_rng(4)
    ref = {"b": [rng.standard_normal(5), None],
           "a": rng.standard_normal((2, 3))}
    got = {"b": [ref["b"][0] * (1 + 1e-6), None], "a": ref["a"] + 1e-7}
    want = jfid.compare_trees(ref, got)
    mine = tfid.compare_trees(
        {"b": [torch.as_tensor(ref["b"][0]), None],
         "a": torch.as_tensor(ref["a"])},
        {"b": [torch.as_tensor(got["b"][0]), None],
         "a": torch.as_tensor(got["a"])})
    for k, v in want.items():
        assert mine[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k
    bound = tobs.MeasuredBound(measured_abs=1e-6, measured_rel=1e-6,
                               source="test")
    tobs.assert_trees_close(ref, got, bound)
    with pytest.raises(AssertionError, match="measured bound"):
        tobs.assert_trees_close(ref, {"b": [ref["b"][0] + 1.0, None],
                                      "a": ref["a"]}, bound)
    with pytest.raises(ValueError, match="structures differ"):
        tfid.compare_trees(ref, {"a": ref["a"]})


def _lint():
    spec = importlib.util.spec_from_file_location(
        "check_metric_names", ROOT / "scripts" / "check_metric_names.py")
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    return lint


def test_metric_name_lint_clean_over_the_port():
    lint = _lint()
    files = sorted(f for f in PORT.rglob("*.py")
                   if "__pycache__" not in f.parts)
    assert lint.check(files=files) == []
    # and the port's sites name only metrics the reference registers
    names = {m.group(2) for f in files
             for m in lint._SITE.finditer(f.read_text())}
    ref = {m.group(2) for f in lint._files()
           for m in lint._SITE.finditer(f.read_text())}
    assert names and names <= ref, sorted(names - ref)


def test_port_readme_section_names_only_registered_metrics():
    lint = _lint()
    known = {m.group(2) for f in lint._files()
             for m in lint._SITE.finditer(f.read_text())}
    assert lint.check_docs(known, doc_files=[ROOT / "README.md"]) == []

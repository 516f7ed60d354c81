"""The port's scale-out job (``SparkDl4jMultiLayer`` /
``SparkComputationGraph`` over ``ParamAveragingHub``) on real nets on the
CPU: the thread-harness cases of ``tests/test_scaleout.py`` at the
reference's tiny sizes (rounds, freq-1 equivalence, worker failure, the
fault matrix with rejoin, lease reassignment and master restart, the
checkpoint stamp, the CG alias), the two scale-out tests of
``tests/test_obs.py`` (one stitched trace tree; the ``dl4j_scaleout_*``
metrics beside a fit and a ParallelInference flush), and a no-failure
2-worker job held against the JAX package's job from the same start
(params within 1e-5). The two-process job stays slow, as the reference
marks it. Every blocking wait is bounded (``worker_timeout``).
"""

from __future__ import annotations

import re
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import (DenseLayer, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.obs import (derived_span_id, get_registry,
                                          get_tracer, load_spans)
from deeplearning4j_tpu_torch.parallel import (
    MasterDiedError, ParameterAveragingTrainingMaster, SparkDl4jMultiLayer,
    read_resume_state)
from deeplearning4j_tpu_torch.train import Sgd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _conf(m, t, seed, lr=5e-2):
    return (m.NeuralNetConfiguration.builder().seed(seed).updater(t.Sgd(lr))
            .list()
            .layer(m.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())


def _net(seed=11):
    import deeplearning4j_tpu_torch.nn as m
    import deeplearning4j_tpu_torch.train as t
    return MultiLayerNetwork(_conf(m, t, seed)).init(device="cpu")


def _data(n_batches=8, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(batch, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
        out.append(DataSet(x, y))
    return out


def _job_score(net, datasets):
    x = np.concatenate([np.asarray(d.features) for d in datasets])
    y = np.concatenate([np.asarray(d.labels) for d in datasets])
    return float(net.score(DataSet(x, y)))


def _flat(net):
    return net.params_flat().detach().cpu().numpy()


def test_spark_fit_runs_rounds_and_trains():
    net = _net()
    datasets = _data()
    score0 = _job_score(net.clone(), datasets)
    tm = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=2, epochs_per_fit=3,
        worker_timeout=60.0)
    spark = SparkDl4jMultiLayer(net, tm)
    trained = spark.fit(datasets)
    assert trained is net
    assert spark.rounds >= 2
    assert spark.dropped_workers == []
    assert _job_score(net, datasets) < score0


def test_spark_param_averaging_freq1_matches_sequential_two_workers():
    """freq=1 Sgd averaging with THE SAME batch on both workers equals one
    worker's step (both replicas walk identical trajectories)."""
    datasets = _data(n_batches=2, seed=3)
    same = [datasets[0], datasets[0]]
    net = _net(seed=7)
    tm = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=1, epochs_per_fit=1,
        worker_timeout=60.0)
    SparkDl4jMultiLayer(net, tm).fit(same)
    solo = _net(seed=7)
    solo.fit(datasets[0])
    np.testing.assert_allclose(_flat(net), _flat(solo), rtol=1e-6,
                               atol=1e-7)


def test_spark_tolerates_worker_failure():
    net = _net()
    tm = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=2, epochs_per_fit=2,
        worker_timeout=15.0)
    spark = SparkDl4jMultiLayer(net, tm)
    with pytest.warns(UserWarning, match="failed mid-job"):
        spark.fit(_data(), fail_worker=1, fail_after_steps=1)
    assert spark.dropped_workers == [1]
    assert spark.rounds >= 1


def test_spark_all_workers_fail_raises():
    tm1 = ParameterAveragingTrainingMaster(
        n_workers=1, averaging_frequency=5, epochs_per_fit=1,
        worker_timeout=10.0)
    with pytest.raises(RuntimeError, match="no averaged parameters"):
        with pytest.warns(UserWarning):
            SparkDl4jMultiLayer(_net(), tm1).fit(
                _data(n_batches=2), fail_worker=0, fail_after_steps=1)


def test_spark_checkpoints_between_rounds_and_resume(tmp_path):
    net = _net()
    datasets = _data()
    tm = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=2, epochs_per_fit=2,
        worker_timeout=60.0, checkpoint_dir=str(tmp_path / "ck"))
    spark = SparkDl4jMultiLayer(net, tm)
    spark.fit(datasets)
    ck = tmp_path / "ck"
    assert (ck / "latest.zip").exists()
    assert int((ck / "round.txt").read_text()) == spark.rounds
    assert not (ck / "leases.json").exists()   # a finished job's stamp goes
    from deeplearning4j_tpu_torch.serde import ModelSerializer
    resumed = ModelSerializer.restore_multi_layer_network(
        str(ck / "latest.zip"), device="cpu")
    np.testing.assert_array_equal(_flat(resumed), _flat(net))
    tm2 = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=2, epochs_per_fit=1,
        worker_timeout=60.0)
    SparkDl4jMultiLayer(resumed, tm2).fit(datasets)


# ---------------------------------------------------------------------------
# fault matrix: each failure schedule completes the job, covers every
# partition, and lands within tolerance of the uninterrupted run's loss
# ---------------------------------------------------------------------------

_MATRIX_TM = dict(n_workers=4, averaging_frequency=2, epochs_per_fit=2,
                  worker_timeout=20.0)
_LOSS_TOL = 0.15


@pytest.fixture(scope="module")
def clean_loss():
    datasets = _data()
    net = _net()
    SparkDl4jMultiLayer(net, ParameterAveragingTrainingMaster(
        **_MATRIX_TM)).fit(datasets)
    return _job_score(net, datasets)


def test_fault_matrix_worker_kill_rejoins_and_job_completes(clean_loss):
    datasets = _data()
    net = _net()
    spark = SparkDl4jMultiLayer(
        net, ParameterAveragingTrainingMaster(**_MATRIX_TM))
    with pytest.warns(UserWarning, match="failed mid-job"):
        spark.fit(datasets, fail_worker=2, fail_after_steps=1,
                  respawn_failed=True)
    assert 2 in spark.dropped_workers
    assert spark.rejoins >= 1
    counts = spark.lease_table.counts()
    assert spark.lease_table.all_done() and counts["leased"] == 0
    loss = _job_score(net, datasets)
    assert abs(loss - clean_loss) < _LOSS_TOL, (loss, clean_loss)


def test_fault_matrix_worker_kill_no_rejoin_leases_reassigned(clean_loss):
    datasets = _data()
    net = _net()
    spark = SparkDl4jMultiLayer(
        net, ParameterAveragingTrainingMaster(**_MATRIX_TM))
    with pytest.warns(UserWarning, match="failed mid-job"):
        spark.fit(datasets, fail_worker=1, fail_after_steps=1)
    assert spark.dropped_workers == [1] and spark.rejoins == 0
    counts = spark.lease_table.counts()
    assert spark.lease_table.all_done() and counts["leased"] == 0
    assert counts["reassigned"] >= 1
    loss = _job_score(net, datasets)
    assert abs(loss - clean_loss) < _LOSS_TOL, (loss, clean_loss)


def test_fault_matrix_master_kill_restart_from_checkpoint(tmp_path,
                                                          clean_loss):
    datasets = _data()
    ck = tmp_path / "ck"
    kwargs = dict(_MATRIX_TM, checkpoint_dir=str(ck), worker_timeout=10.0,
                  worker_retries=2, worker_backoff=0.1)
    net = _net()
    spark = SparkDl4jMultiLayer(net, ParameterAveragingTrainingMaster(**kwargs))
    with pytest.raises(MasterDiedError):
        spark.fit(datasets, fail_master_after_rounds=1)
    stamp = read_resume_state(ck)
    assert stamp is not None and stamp[0] == spark.rounds >= 1
    assert not spark.lease_table.all_done()
    done_before = set(spark.lease_table.completed)

    net2 = _net(seed=99)     # params come from the checkpoint, not seed
    spark2 = SparkDl4jMultiLayer(net2,
                                 ParameterAveragingTrainingMaster(**kwargs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # late drops of run-1 ghosts
        spark2.fit(datasets)
    assert spark2.resumed
    assert spark2.rounds > spark.rounds
    assert spark2.lease_table.all_done()
    assert done_before >= set(
        __import__("json").loads(stamp[1])["completed"])
    assert not (ck / "leases.json").exists()
    assert int((ck / "round.txt").read_text()) == spark2.rounds
    loss = _job_score(net2, datasets)
    assert abs(loss - clean_loss) < _LOSS_TOL, (loss, clean_loss)


def test_spark_computation_graph_alias_trains_cg():
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import SparkComputationGraph
    gb = (NeuralNetConfiguration.builder().seed(2).updater(Sgd(5e-2))
          .graph_builder()
          .add_inputs("in")
          .add_layer("d", DenseLayer(n_in=6, n_out=8, activation="tanh"),
                     "in")
          .add_layer("out", OutputLayer(n_in=8, n_out=3,
                                        activation="softmax", loss="mcxent"),
                     "d")
          .set_outputs("out"))
    cg = ComputationGraph(gb.build()).init([(6,)], device="cpu")
    datasets = _data(n_batches=4)
    x = np.concatenate([np.asarray(d.features) for d in datasets])
    y = np.concatenate([np.asarray(d.labels) for d in datasets])
    s0 = cg.clone().score(DataSet(x, y))
    tm = ParameterAveragingTrainingMaster(
        n_workers=2, averaging_frequency=2, epochs_per_fit=3,
        worker_timeout=60.0)
    spark = SparkComputationGraph(cg, tm)
    spark.fit(datasets)
    assert spark.rounds >= 1
    assert cg.score(DataSet(x, y)) < s0


# ---------------------------------------------------------------------------
# observability: one stitched trace tree; the metrics beside a fit and an
# inference flush
# ---------------------------------------------------------------------------

def test_scaleout_stitches_one_trace_tree(tmp_path):
    tracer = get_tracer()
    tracer.clear()
    tm = ParameterAveragingTrainingMaster(
        n_workers=4, averaging_frequency=2, epochs_per_fit=1,
        worker_timeout=60.0)
    SparkDl4jMultiLayer(_net(), tm).fit(_data(n_batches=8))

    spans = [s for s in tracer.spans() if s.name.startswith("scaleout")]
    jobs = [s for s in spans if s.name == "scaleout_job"]
    rounds = [s for s in spans if s.name == "scaleout_round"
              and not s.attrs.get("empty")]
    fits = [s for s in spans if s.name == "scaleout_worker_fit"]
    assert len(jobs) == 1 and rounds and len(fits) == 8
    job = jobs[0]
    assert all(s.trace_id == job.trace_id for s in spans)
    assert all(s.parent_id == job.span_id for s in rounds)
    round_ids = {s.span_id for s in rounds}
    assert all(f.parent_id in round_ids for f in fits)
    assert {f.attrs["worker"] for f in fits} == {0, 1, 2, 3}
    assert rounds[0].span_id == derived_span_id(
        job.trace_id, "round", rounds[0].attrs["round"])
    path = tmp_path / "trace.jsonl"
    tracer.export_jsonl(path, clear=True)
    recs = [r for r in load_spans(path) if r["name"].startswith("scaleout")]
    by_id = {r["span_id"]: r for r in recs}
    roots = set()
    for r in recs:
        node = r
        while node["parent_id"] in by_id:
            node = by_id[node["parent_id"]]
        roots.add(node["span_id"])
    assert roots == {job.span_id}


_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
                     r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|NaN|[+-]Inf)$")


def test_metrics_serve_fit_scaleout_and_inference():
    """The exposition after a small fit with the telemetry listener, a
    4-worker thread-harness job and a dynamic-batching inference flush
    holds the train histograms, the batch occupancy and the scale-out
    counters (the port has no UI server: the registry's own text)."""
    from deeplearning4j_tpu_torch.nn.listeners import MetricsListener
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    reg = get_registry()
    reg.reset()
    net = _net()
    net.set_listeners(MetricsListener())
    net.fit(_data(n_batches=4))
    tm = ParameterAveragingTrainingMaster(
        n_workers=4, averaging_frequency=2, epochs_per_fit=1,
        worker_timeout=60.0)
    SparkDl4jMultiLayer(_net(), tm).fit(_data(n_batches=8))
    inf = ParallelInference(net, max_batch=64, device="cpu")
    for _ in range(3):
        inf.submit(np.random.default_rng(0).normal(
            size=(8, 6)).astype(np.float32))
    assert len(inf.flush()) == 3
    text = reg.to_prometheus()
    assert text.endswith("\n")
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert _SAMPLE.match(line), line
    assert "dl4j_train_step_seconds_bucket" in text
    assert "dl4j_train_step_seconds_count" in text
    assert "dl4j_inference_batch_occupancy 0.375" in text  # 24/64
    assert "dl4j_inference_queue_wait_seconds_count 3" in text
    assert "dl4j_scaleout_rounds_total" in text
    assert "dl4j_scaleout_worker_steps_total 8" in text


# ---------------------------------------------------------------------------
# parity with the JAX package's job
# ---------------------------------------------------------------------------

def test_two_worker_job_matches_reference_job():
    """A no-failure 2-worker job (freq 1, 4 shards, 2 epochs) from the
    same start in both packages: the averaged params agree within f32
    1e-5, and so does the round count."""
    import deeplearning4j_tpu.data as jdata
    import deeplearning4j_tpu.nn as jnn
    import deeplearning4j_tpu.parallel as jpar
    import deeplearning4j_tpu.train as jtrain
    import deeplearning4j_tpu_torch.nn as tnn
    jnet = jnn.MultiLayerNetwork(_conf(jnn, jtrain, 4)).init()
    net = tnn.MultiLayerNetwork(_conf(tnn, __import__(
        "deeplearning4j_tpu_torch.train", fromlist=["x"]), 4)).init(
        device="cpu")
    net.params, net.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    np.testing.assert_array_equal(_flat(net), np.asarray(jnet.params_flat()))
    data = _data(n_batches=4, seed=5)
    kw = dict(n_workers=2, averaging_frequency=1, epochs_per_fit=2,
              worker_timeout=60.0)
    spark = SparkDl4jMultiLayer(net, ParameterAveragingTrainingMaster(**kw))
    spark.fit(data)
    jspark = jpar.SparkDl4jMultiLayer(
        jnet, jpar.ParameterAveragingTrainingMaster(**kw))
    jspark.fit([jdata.DataSet(np.asarray(d.features), np.asarray(d.labels))
                for d in data])
    assert spark.rounds == jspark.rounds == 4
    np.testing.assert_allclose(_flat(net), np.asarray(jnet.params_flat()),
                               rtol=0, atol=1e-5)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    import deeplearning4j_tpu_torch.nn as m
    import deeplearning4j_tpu_torch.train as t
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import worker_main

    port = int(sys.argv[1]); wid = int(sys.argv[2]); out = sys.argv[3]
    conf = (m.NeuralNetConfiguration.builder().seed(11).updater(t.Sgd(5e-2))
            .list()
            .layer(m.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    net = m.MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(wid)      # each process: its own partition
    ds = [DataSet(rng.normal(size=(16, 6)).astype("float32"),
                  np.eye(3, dtype="float32")[rng.integers(0, 3, 16)])
          for _ in range(4)]
    worker_main(("127.0.0.1", port), net, ds, averaging_frequency=2,
                epochs=1, worker_id=wid, worker_timeout=120.0)
    np.savez(out, w=net.params_flat().numpy())
""").format(repo=str(REPO))


@pytest.mark.slow
def test_two_process_spark_job(tmp_path):
    """Real process boundary: two subprocess workers + an in-process hub."""
    from deeplearning4j_tpu_torch.parallel import ParamAveragingHub
    hub = ParamAveragingHub(n_workers=2, worker_timeout=120.0).start()
    try:
        port = hub.address[1]
        procs, outs = [], []
        for wid in range(2):
            out = tmp_path / f"w{wid}.npz"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(port), str(wid),
                 str(out)], cwd=str(REPO)))
        for p in procs:
            assert p.wait(timeout=300) == 0
        final = hub.result(timeout=30)
    finally:
        hub.stop()
    assert final is not None and hub.rounds >= 2
    np.testing.assert_allclose(np.load(outs[0])["w"], np.load(outs[1])["w"],
                               rtol=1e-6, atol=1e-7)

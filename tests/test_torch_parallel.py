"""The port's ``parallel`` against the JAX package's
(``tests/test_parallel.py``: the mesh, ``ParallelWrapper`` dp/tp over
MLNs and graphs, the tp layers, ``ParallelInference`` over a mesh,
parameter averaging, the generic and LM pipelines, the sharded LM loss).

The port runs at world 4 over gloo on the CPU, in ranks spawned once for
the file (``torch_parallel_ranks.RankPool``; they import the port only),
from the JAX net's initial weights and the same seeded numpy inputs. The
JAX side is the reference's own claim of each case: its parallel result
equals the single-device one, so the port's world-4 result is held
against the JAX single-device function (and, for parameter averaging,
against the JAX trainer over 4 of the 8 virtual devices) at the
reference tests' tolerances. The ring, MoE and dry-run cases are in
``test_torch_moe_ring.py`` and ``test_torch_parallel_dryrun.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.parallel as jpar
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.zoo import transformer as jtfm

from torch_parallel_ranks import RankPool, build, port_net

JPKG = (jnn, jtrain, jpar, False)
WORLD = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def jnet(name, *classes, **kw):
    """The JAX net of builder ``name`` (class names resolved in nn, then
    parallel) and its weights as the payload."""
    cls = tuple(getattr(jnn, c, None) or getattr(jpar, c) for c in classes)
    net = build(JPKG, name, *cls, **kw)
    return net, weights(net)


def weights(net):
    return {"params": jax.tree_util.tree_map(np.asarray, net.params),
            "states": jax.tree_util.tree_map(np.asarray, net.states)}


def close(got, want, **tol):
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **tol), got, want)


def onehot(rng, n, k, shape=None):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, shape or n)]


# ------------------------------------------------------------ mesh, dp

def test_mesh_spec_validation(pool):
    r = pool.run("mesh_spec")
    assert all(x["shape"] == {"dp": 2, "tp": 2} for x in r)
    assert all(x["odd"] and x["bogus"] for x in r)
    # rank r at row-major place r: dp groups stride 2, tp groups adjacent
    assert r[0]["groups"] == ((0, 2), (0, 1))
    assert r[3]["groups"] == ((1, 3), (2, 3))
    # the reference's placements: replicated P(), the batch over dp
    assert r[0]["specs"] == ((), (("dp",),))
    # hosts (dcn) outer, a host's ranks (ici) inner
    assert r[0]["hybrid"] == ({"dp": 2, "tp": 2}, (0, 1))


def test_dp_fit_matches_single_device(pool):
    """ParallelWrapper (dp=4) reaches the JAX single-device fit's
    solution (10 epochs of the 144-example Iris batch)."""
    from deeplearning4j_tpu.data import IrisDataSetIterator
    it = IrisDataSetIterator(batch_size=144, num_examples=144)
    b = next(iter(it))
    it.reset()
    single, w = jnet("iris_mlp")
    single.fit(it, epochs=10)
    r = pool.run("dp_fit", dict(w, x=np.asarray(b.features),
                                y=np.asarray(b.labels), epochs=10))
    close(r[0]["params"], single.params, rtol=1e-4, atol=1e-5)
    assert r[0]["audit"]["bit_identical"] and \
        r[0]["audit"]["max_drift"] == 0.0


def test_fsdp_sharding(pool):
    specs = pool.run("fsdp_sharding")[0]
    assert specs == {"big": (None, "fsdp"), "small": ()}
    mesh = jpar.make_mesh(jax.devices()[:4], fsdp=4)
    jsh = jpar.shard_params_fsdp(mesh, {"big": jnp.zeros((16, 1024 * 16)),
                                        "small": jnp.zeros((4,))})
    assert tuple(jsh["big"].spec) == specs["big"]


# ------------------------------------------------------------------ tp

def test_tp_mln_matches_single_device(pool):
    """Column/RowParallelDense under dp2 × tp2 track the single-device
    trajectory (losses at atol 1e-5), W split over tp."""
    rng = np.random.default_rng(0)
    x = rng.random((64, 32), np.float32)
    y = onehot(rng, 64, 4)
    net1, w = jnet("tp_mlp", "DenseLayer", "DenseLayer")
    losses1 = [net1.fit(JDataSet(x, y)) for _ in range(5)]
    r = pool.run("tp_mln", dict(w, x=x, y=y))[0]
    np.testing.assert_allclose(r["losses"], losses1, atol=1e-5)
    assert r["specs"]["layer_0"]["W"] == (None, "tp")
    assert r["specs"]["layer_1"]["W"] == ("tp", None)
    close(r["params"], net1.params, rtol=1e-4, atol=1e-5)


def test_tp_computation_graph_matches_single_device(pool):
    """A tp ComputationGraph: node-keyed placements, and the sharded loss
    and gradients of the global batch equal the single-device ones."""
    rng = np.random.default_rng(1)
    x = rng.random((32, 16), np.float32)
    y = onehot(rng, 32, 3)
    net, w = jnet("tp_cg_net", "ColumnParallelDense", "RowParallelDense")

    def loss(p):
        return net._loss(p, net.states, {"in": jnp.asarray(x)},
                         {"out": jnp.asarray(y)}, None, None, None)[0]
    ref, grads = jax.value_and_grad(loss)(net.params)
    r = pool.run("tp_cg", dict(w, x=x, y=y))[0]
    np.testing.assert_allclose(r["loss"], float(ref), atol=1e-5)
    assert r["specs"]["h1"]["W"] == (None, "tp")
    assert r["specs"]["h2"]["W"] == ("tp", None)
    close(r["grads"], grads, atol=1e-5)


def test_tp_sharded_attention_compiles(pool):
    """ShardedSelfAttention split over tp2 equals the unsharded layer
    (output and the gradient of its Wq)."""
    from deeplearning4j_tpu.nn.layers.base import Ctx
    layer = jpar.ShardedSelfAttention(n_in=16, n_out=16, n_heads=4)
    params, state, _ = layer.init(jax.random.PRNGKey(0), (6, 16))
    x = np.random.default_rng(0).random((4, 6, 16), np.float32)

    def f(p):
        return jnn.SelfAttentionLayer.apply(layer, p, state, jnp.asarray(x),
                                            Ctx())[0]
    ref = f(params)
    g = jax.grad(lambda p: jnp.sum(f(p) ** 2))(params)["Wq"]
    r = pool.run("tp_attention", {"params": jax.tree_util.tree_map(
        np.asarray, params), "x": x})[0]
    assert r["specs"]["Wq"] == (None, "tp") and r["specs"]["Wo"] == \
        ("tp", None)
    np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(r["gWq"], np.asarray(g), atol=1e-5)


def test_tp_row_sharded_embedding(pool):
    from deeplearning4j_tpu.nn.layers.base import Ctx
    layer = jpar.RowShardedEmbeddingSequence(n_in=32, n_out=12)
    params, state, _ = layer.init(jax.random.PRNGKey(0), (6,))
    ids = np.random.default_rng(0).integers(0, 32, (4, 6))
    ref, _ = layer.apply(params, state, jnp.asarray(ids), Ctx())
    r = pool.run("tp_row_embedding", {"params": jax.tree_util.tree_map(
        np.asarray, params), "ids": ids})[0]
    assert r["specs"]["W"] == ("tp", None)
    np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-6)


def test_tp_channel_sharded_conv_pair(pool):
    from deeplearning4j_tpu.nn.layers.base import Ctx
    c1 = jpar.ChannelShardedConvolution(n_out=8, kernel_size=(3, 3),
                                        convolution_mode="same",
                                        activation="relu")
    c2 = jpar.InputChannelShardedConvolution(n_out=4, kernel_size=(3, 3),
                                             convolution_mode="same",
                                             activation="identity")
    p1, s1, shape1 = c1.init(jax.random.PRNGKey(0), (8, 8, 3))
    p2, s2, _ = c2.init(jax.random.PRNGKey(1), shape1)
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    h, _ = c1.apply(p1, s1, jnp.asarray(x), Ctx())
    ref, _ = c2.apply(p2, s2, h, Ctx())
    tn = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    r = pool.run("tp_conv_pair", {"p1": tn(p1), "p2": tn(p2), "x": x})[0]
    np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-5)
    assert r["specs"][0]["W"] == (None, None, None, "tp")
    assert r["specs"][1]["W"] == (None, None, "tp", None)
    assert r["grouped"]


def test_sharded_attention_rejects_uneven_heads(pool):
    r = pool.run("uneven_heads")
    assert r[0] is True and r[1] is True and r[2] is None


def test_parallel_wrapper_pads_to_batch_axes_only(pool):
    """A 6-row batch on dp2 × tp2 pads to the dp extent only (none here)
    and its loss is the single-device loss."""
    rng = np.random.default_rng(0)
    x = rng.random((6, 32), np.float32)
    y = onehot(rng, 6, 4)
    net, w = jnet("tp_mlp", "ColumnParallelDense", "RowParallelDense")
    ref = float(net._loss(net.params, net.states, jnp.asarray(x),
                          jnp.asarray(y), None, None, None)[0])
    r = pool.run("pads_to_batch_axes", dict(w, x=x, y=y))
    np.testing.assert_allclose(r[0], ref, atol=1e-5)


def test_parallel_inference_does_not_mutate_net(pool):
    """ParallelInference over a dp4 mesh serves a snapshot of a net
    trained on dp2 × tp2; the trainer keeps working; ``refresh`` picks up
    new params. Served rows equal the JAX net's after the same step."""
    rng = np.random.default_rng(0)
    x = rng.random((16, 32), np.float32)
    y = onehot(rng, 16, 4)
    net, w = jnet("tp_mlp", "DenseLayer", "DenseLayer")
    net.fit(JDataSet(x, y))
    r = pool.run("pi_does_not_mutate", dict(w, x=x, y=y))[0]
    assert r["out"].shape == (5, 4) and r["untouched"]
    np.testing.assert_allclose(r["out"], np.asarray(net.output(x[:5])),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(r["loss"])
    np.testing.assert_allclose(r["out2"], r["want2"], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- graphs, BN

def _cg_data(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            onehot(rng, n, 5))


def test_parallel_wrapper_computation_graph(pool):
    """dp4 over the residual conv graph (two BNs, their statistics over
    the global batch) tracks the single-device trajectory."""
    x, y = _cg_data(3, 64)
    single, w = jnet("small_cg")
    for _ in range(4):
        single.fit([JDataSet(x, y)])
    r = pool.run("pw_cg", dict(w, x=x, y=y, steps=4))[0]
    close(r["params"], single.params, rtol=2e-4, atol=1e-5)
    close(r["states"], single.states, rtol=2e-4, atol=1e-5)


def test_parallel_wrapper_computation_graph_remat(pool):
    x, y = _cg_data(4, 32)
    single, w = jnet("small_cg")
    ref = single.fit([JDataSet(x, y)])
    l1, l2 = pool.run("pw_cg_remat", dict(w, x=x, y=y))[0]
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    np.testing.assert_allclose(l1, ref, rtol=1e-5)


def test_parallel_inference_computation_graph(pool):
    x, _ = _cg_data(5, 24)
    net, w = jnet("small_cg")
    got = pool.run("pi_cg", dict(w, x=x))
    want = np.asarray(net.output(jnp.asarray(x)))
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)


def test_parallel_wrapper_multidataset_cg(pool):
    """A two-input two-output graph trains through ParallelWrapper on
    MultiDataSets as on one device; ParallelInference pads 22 rows to the
    dp extent and returns per-output arrays."""
    from deeplearning4j_tpu.data.dataset import MultiDataSet
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((32, 6)).astype(np.float32)
    xb = rng.standard_normal((32, 4)).astype(np.float32)
    y1, y2 = onehot(rng, 32, 3), onehot(rng, 32, 2)
    single, w = jnet("mds_cg")
    for _ in range(3):
        single.fit([MultiDataSet([xa, xb], [y1, y2])])
    trained = jax.tree_util.tree_map(np.asarray, single.params)
    r = pool.run("pw_mds_cg", dict(w, xa=xa, xb=xb, y1=y1, y2=y2,
                                   trained=trained))[0]
    close(r["params"], single.params, rtol=2e-4, atol=1e-5)
    want = single.output(jnp.asarray(xa[:22]), jnp.asarray(xb[:22]))
    assert len(r["outs"]) == 2
    for g, wnt in zip(r["outs"], want):
        np.testing.assert_allclose(g, np.asarray(wnt), rtol=1e-5, atol=1e-6)


def test_parallel_wrapper_fit_scanned_matches_fit(pool):
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((16, 6)).astype(np.float32) for _ in range(4)]
    ys = [onehot(rng, 16, 3) for _ in range(4)]
    single, w = jnet("scan_mlp")
    single.fit(JList([JDataSet(a, b) for a, b in zip(xs, ys)],
                     batch_size=16), epochs=3)
    r = pool.run("pw_fit_scanned", dict(w, xs=xs, ys=ys))[0]
    close(r["scanned"], r["fit"], rtol=2e-5, atol=1e-6)
    close(r["fit"], single.params, rtol=1e-4, atol=1e-5)
    assert np.isfinite(r["last"])
    assert r["ragged"] and r["divide"] and r["zero"] is None


# ------------------------------------------------- parameter averaging

def test_parameter_averaging_freq1_sgd_matches_sync_dp(pool):
    """One freq-1 Sgd round over dp4 (4 microbatches of 16) equals one
    synchronous step on the whole 64-row batch: the JAX single-device
    step and the port's ParallelWrapper."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = onehot(rng, 64, 3)
    single, w = jnet("pa_mlp")
    single.fit(JDataSet(x, y))
    r = pool.run("pa_freq1_sgd", dict(w, x=x, y=y))[0]
    assert r["rounds"] == 1
    close(r["pa"], single.params, rtol=2e-4, atol=2e-5)
    close(r["pa"], r["pw"], rtol=2e-4, atol=2e-5)


def _pa_jax(net, batches, freq, epochs=1):
    tr = jpar.ParameterAveragingTrainer(
        net, mesh=jpar.make_mesh(jax.devices()[:WORLD], dp=WORLD),
        averaging_frequency=freq)
    for _ in range(epochs):
        tr.fit(JList(batches, batch_size=8))
    return net


def test_parameter_averaging_freq_gt1_converges(pool, devices8):
    """freq 2 with Adam over dp4: the first epoch's two rounds equal the
    JAX trainer's over 4 devices, and 15 epochs halve the score."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, 4)).astype(np.float32)
    wm = rng.standard_normal((4, 3))
    y = np.eye(3, dtype=np.float32)[(x @ wm).argmax(1)]
    net, w = jnet("pa_adam")
    _pa_jax(net, [JDataSet(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
                  for i in range(16)], 2)
    r = pool.run("pa_adam_rounds", dict(w, x=x, y=y))[0]
    close(r["first"], net.params, rtol=2e-4, atol=2e-5)
    assert r["s"] < r["s0"] * 0.5
    assert r["out"] == (128, 3)


def test_parameter_averaging_respects_label_masks(pool, devices8):
    """The labels mask reaches the local steps: masked and unmasked
    training differ, and the masked round equals the JAX trainer's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 6, 3)).astype(np.float32)
    y = onehot(rng, 64, 2, (64, 6))
    m = np.zeros((64, 6), np.float32)
    m[:, :3] = 1.0
    net, w = jnet("rnn_net")
    k = 64 // WORLD
    tr = jpar.ParameterAveragingTrainer(
        net, mesh=jpar.make_mesh(jax.devices()[:WORLD], dp=WORLD),
        averaging_frequency=1)
    tr.fit(JList([JDataSet(x[i * k:(i + 1) * k], y[i * k:(i + 1) * k],
                           labels_mask=m[i * k:(i + 1) * k])
                  for i in range(WORLD)], batch_size=k))
    r = pool.run("pa_label_masks", dict(w, x=x, y=y, m=m))[0]
    assert not np.allclose(r[True]["layer_1"]["W"], r[False]["layer_1"]["W"])
    close(r[True], net.params, rtol=2e-4, atol=2e-5)


def test_param_averaging_computation_graph(pool):
    x, y = _cg_data(12, 64)
    single, w = jnet("small_cg", seed=21)
    r = pool.run("pa_cg", dict(w, x=x, y=y))[0]
    assert r["loss"] is not None and np.isfinite(r["loss"])
    assert r["mds"]
    # every replica stepped on the same full batch: the average is the
    # single-device step
    single.fit([JDataSet(x, y)])
    close(r["params"], single.params, rtol=2e-4, atol=1e-5)


# ----------------------------------------------------------- pipelines

def _mb_data(n=32, f=16, k=4, mb=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, f), np.float32)
    y = onehot(rng, n, k)
    x_mb, y_mb = jpar.microbatches(x, y, mb)
    return x_mb, y_mb


def _mb_mean(net, x_mb, y_mb):
    return float(np.mean([float(net._loss(
        net.params, net.states, jnp.asarray(a), jnp.asarray(b), None, None,
        None)[0]) for a, b in zip(x_mb, y_mb)]))


def test_generic_pipeline_partitioner_balance():
    net = port_net("pp_mlp")
    jn = build(JPKG, "pp_mlp")
    from deeplearning4j_tpu_torch.parallel import partition_layers
    stages = partition_layers(net, 2)
    assert stages == jpar.partition_layers(jn, 2)
    assert [i for s in stages for i in s] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        partition_layers(net, 9)


def test_generic_pipeline_loss_matches_single_device(pool):
    """The generic MLN pipeline (pp2, and pp2 × dp2) gives the
    single-device microbatched loss, and trains."""
    x_mb, y_mb = _mb_data()
    net, w = jnet("pp_mlp")
    ref = _mb_mean(net, x_mb, y_mb)
    r = pool.run("generic_pipeline", dict(w, x_mb=x_mb, y_mb=y_mb, mb=8))
    assert r[0]["stages"] == jpar.partition_layers(net, 2)
    for rank in (0, 1):
        np.testing.assert_allclose(r[rank]["pp2"], ref, atol=1e-5)
        assert r[rank]["losses"][-1] < r[rank]["losses"][0]
    for x in r:
        np.testing.assert_allclose(x["pp2dp2"], ref, atol=1e-5)


def test_generic_pipeline_pp_sharded_params(pool):
    """shard_params_pp's placements split the big leaves over pp, as the
    reference's, and the pipelined loss reads the same tree."""
    x_mb, y_mb = _mb_data()
    net, w = jnet("pp_mlp")
    mesh = jpar.make_mesh(jax.devices()[:2], pp=2)
    jsh = jpar.shard_params_pp(mesh, net.params, min_size=64)
    r = pool.run("generic_pipeline", dict(w, x_mb=x_mb, y_mb=y_mb, mb=8))
    assert r[0]["pp_spec"] == tuple(jsh["layer_0"]["W"].sharding.spec) + \
        (None,) * (2 - len(jsh["layer_0"]["W"].sharding.spec))
    assert "pp" in r[0]["pp_spec"]


def test_generic_pipeline_batchnorm(pool):
    """BatchNorm in the pipeline: loss and running stats equal the
    sequential microbatched loop (GPipe per-microbatch statistics)."""
    rng = np.random.default_rng(0)
    x = rng.random((16, 8), np.float32)
    y = onehot(rng, 16, 2)
    x_mb, y_mb = jpar.microbatches(x, y, 4)
    net, w = jnet("pp_bn_net")
    states, losses = net.states, []
    for a, b in zip(x_mb, y_mb):
        loss, states = net._loss(net.params, states, jnp.asarray(a),
                                 jnp.asarray(b), None, None, None)
        losses.append(float(loss))
    r = pool.run("generic_pipeline_bn", dict(w, x_mb=x_mb, y_mb=y_mb,
                                             mb=4))
    for rank in (0, 1):
        np.testing.assert_allclose(r[rank]["loss"], np.mean(losses),
                                   atol=1e-5)
        close(r[rank]["states"], states, atol=1e-5)
        assert r[rank]["losses"][-1] < r[rank]["losses"][0]
        assert not np.allclose(r[rank]["mean_after"],
                               np.asarray(net.states["layer_1"]["mean"]))


def test_cg_pipeline_linear_chain(pool):
    x_mb, y_mb = _mb_data(n=16, mb=4)
    cg, w = jnet("linear_cg")
    ref = float(np.mean([float(cg._loss(
        cg.params, cg.states, {"in": jnp.asarray(a)}, {"out": jnp.asarray(b)},
        None, None, None)[0]) for a, b in zip(x_mb, y_mb)]))
    r = pool.run("cg_pipeline", dict(w, x_mb=x_mb, y_mb=y_mb, mb=4))
    for rank in (0, 1):
        np.testing.assert_allclose(r[rank]["losses"][0], ref, atol=1e-5)
        assert r[rank]["losses"][-1] < r[rank]["losses"][0]
        assert r[rank]["keys"] == ["d1", "d2", "out"]
    assert all(x["branchy"] for x in r)


def test_generic_pipeline_dropout_rng(pool):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 12)).astype(np.float32)
    y = onehot(rng, 32, 4, (4, 8))
    _, w = jnet("dropout_mlp", dropout=0.5)
    r = pool.run("generic_pipeline_dropout", dict(w, x=x, y=y))[0]
    assert r["la"] != r["base"] and r["lb"] != r["base"] and \
        r["la"] != r["lb"]
    assert r["gmax"] > 0
    np.testing.assert_allclose(*r["d0"], rtol=1e-6)


# ------------------------------------------------- the LM over a mesh

LM = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
          max_seq=8)


def _lm_payload(cfg_kw, b=4, t=8, seed=0):
    cfg = jtfm.TransformerConfig(**cfg_kw, dtype=jnp.float32, remat=False)
    params = jtfm.init_params(jax.random.PRNGKey(seed), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (b, t), 0,
                             cfg.vocab_size)
    tgt = jax.random.randint(jax.random.PRNGKey(2), (b, t), 0,
                             cfg.vocab_size)
    return cfg, params, np.asarray(ids), np.asarray(tgt)


def test_pipeline_matches_single(pool):
    """The LM pipeline over pp2 × dp2 and pp2 × tp2 gives the
    single-device loss."""
    cfg_kw = dict(LM, vocab_size=61, n_layers=4)
    cfg, params, ids, tgt = _lm_payload(cfg_kw)
    ref = float(jax.jit(lambda p: jtfm.lm_loss(
        p, cfg, jnp.asarray(ids), jnp.asarray(tgt)))(params))
    meshes = [{"pp": 2, "dp": 2}, {"pp": 2, "tp": 2}]
    r = pool.run("pipeline_lm", {
        "cfg": cfg_kw, "params": jax.tree_util.tree_map(np.asarray, params),
        "ids_mb": ids.reshape(2, 2, 8), "tgt_mb": tgt.reshape(2, 2, 8),
        "meshes": meshes})
    for x in r:
        for m in meshes:
            assert abs(x[str(m)] - ref) < 2e-4, (m, x[str(m)], ref)


def test_tp_sharded_step_matches_single(pool):
    """The LM's step over dp2 × tp2, tp2 × sp2 and dp2 × sp2 (heads, MLP
    and vocabulary split over tp; the sequence over sp) computes the
    single-device loss and gradients."""
    cfg, params, ids, tgt = _lm_payload(LM)
    ref, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.lm_loss(
        p, cfg, jnp.asarray(ids), jnp.asarray(tgt))))(params)
    meshes = [{"dp": 2, "tp": 2}, {"tp": 2, "sp": 2}, {"dp": 2, "sp": 2}]
    r = pool.run("lm_mesh_loss", {
        "cfg": LM, "params": jax.tree_util.tree_map(np.asarray, params),
        "ids": ids, "tgt": tgt, "meshes": meshes})
    for x in r:
        for m in meshes:
            assert abs(x[str(m)]["loss"] - float(ref)) < 2e-4, m
            close(x[str(m)]["grads"], grads["blocks"], atol=1e-5)


def test_active_groups_reach_autograd_threads(pool):
    """A step's groups travel with it, explicitly: the BN net's loss
    under the dp group (BN's statistics the global batch's, its backward
    summing their cotangents: on CUDA the backward runs on autograd's
    own threads) while another thread computes the same rows' loss with
    no groups. Summed over the ranks, the first gives the JAX global
    batch's loss, gradient and running stats; the second is the rank's
    own rows' loss."""
    rng = np.random.default_rng(3)
    x = rng.random((16, 8), np.float32)
    y = onehot(rng, 16, 2)
    net, w = jnet("pp_bn_net")
    (ref, states), grads = jax.value_and_grad(
        lambda p: net._loss(p, net.states, jnp.asarray(x), jnp.asarray(y),
                            None, None, None), has_aux=True)(net.params)
    r = pool.run("groups_travel", dict(w, x=x, y=y))
    for rank, got in enumerate(r):
        rows = slice(rank * 4, (rank + 1) * 4)
        own = net._loss(net.params, net.states, jnp.asarray(x[rows]),
                        jnp.asarray(y[rows]), None, None, None)[0]
        np.testing.assert_allclose(got["loss"], float(ref), rtol=1e-5)
        np.testing.assert_allclose(got["own"], float(own), rtol=1e-5)
        close(got["grads"], grads, atol=1e-5)
        close(got["states"], states, atol=1e-5)


def test_loss_shares_sum_to_the_global_batch(pool):
    """Under the dp group each rank's loss is its share of the global
    batch's: summed over the 4 ranks, the JAX loss of the whole batch —
    the means over examples (masked), rmse and fmeasure (global counts),
    a callable of the user's (a 1/size share), YOLO2's head (the global
    object count)."""
    from deeplearning4j_tpu.nn import losses as jlosses
    from deeplearning4j_tpu.nn.layers import objdetect as jod
    rng = np.random.default_rng(5)
    b = 8
    logits = rng.standard_normal((b, 5)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pl = {"probs": probs, "onehot": onehot(rng, b, 5),
          "mask": np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32),
          "reg": rng.standard_normal((b, 3)).astype(np.float32),
          "reg_t": rng.standard_normal((b, 3)).astype(np.float32),
          "sig": 1 / (1 + np.exp(-rng.standard_normal((b, 1)))).astype(
              np.float32),
          "bin": (rng.random((b, 1)) > 0.5).astype(np.float32),
          "multi": (rng.random((b, 4)) > 0.5).astype(np.float32),
          "scores": rng.standard_normal((b, 4)).astype(np.float32)}
    cases = {"mcxent": ("onehot", "probs", "mask"),
             "mse": ("reg_t", "reg", None), "rmse": ("reg_t", "reg", None),
             "fmeasure": ("bin", "sig", None),
             "multi_label": ("multi", "scores", None),
             "user": ("reg_t", "reg", None)}
    anchors = [(1.0, 1.0), (2.5, 1.2)]
    volume = rng.standard_normal((b, 4, 4, 2 * 8)).astype(np.float32)
    labels = np.zeros((b, 4, 4, 4 + 3), np.float32)
    for i in (0, 3, 4, 5):
        cy, cx = rng.integers(0, 4, 2)
        labels[i, cy, cx, :4] = [cx + 0.1, cy + 0.2, cx + 0.9, cy + 0.7]
        labels[i, cy, cx, 4 + i % 3] = 1.0
    r = pool.run("loss_shares", dict(pl, cases=cases, anchors=anchors,
                                     volume=volume, yolo_labels=labels))
    want = {}
    for name, (lab, pred, mask) in cases.items():
        if name == "user":
            want[name] = float(np.mean((pl[pred] - pl[lab]) ** 2))
            continue
        want[name] = float(jlosses.get(name)(
            jnp.asarray(pl[lab]), jnp.asarray(pl[pred]),
            mask=None if mask is None else jnp.asarray(pl[mask])))
    want["yolo2"] = float(jod.Yolo2OutputLayer(anchors=anchors)
                          .compute_loss(jnp.asarray(volume),
                                        jnp.asarray(labels)))
    for got in r:
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)

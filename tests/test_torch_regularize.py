"""The port's regularization and failure detection in the train step —
weight constraints (``train/constraints.py``), dropout and weight noise
(``nn/weightnoise.py``, the dropout family of ``nn/layers/core.py``, input
dropout in both nets) and gradient-anomaly detection
(``train/anomaly.py``) — against the JAX package, on the CPU.

- constraints: each against the reference's ``apply``; an MLN and a CG
  under constraints after each of 5 steps within 1e-6 of the JAX nets';
  frozen layers bit-identical (``tests/test_layers_special.py:204,236``);
- the random ops: the reference's own masks and noise (drawn with its
  keys, read back as numpy) fed to the port's ``*_apply`` functions give
  the reference's output within 1e-6; the port's own draws keep the
  keep rate within 4 sigma and differ from step to step; inference is
  unaffected (``tests/test_weightnoise.py``);
- the anomaly detector: stats against the reference's ``grad_stats``; a
  NaN batch leaves params, updater state and BN states bit-identical and
  raises one step late (``tests/test_tracing_race.py:242``); the "warn"
  mode applies the update; a healthy run records nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import weightnoise as jwn
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu.train import anomaly as janom
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import weightnoise as twn
from deeplearning4j_tpu_torch.nn._compiled import tensors
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.train import anomaly as tanom
from deeplearning4j_tpu_torch.train import constraints as tcons

ATOL = 1e-6
KEY = jax.random.PRNGKey(0)


def _np(t):
    return t.detach().numpy()


def _sync(jnet, tnet):
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


def _snapshot(net):
    return [t.detach().clone() for t in tensors(
        (net.params, net.states, net._opt_state))]


# ----------------------------------------------------------- constraints

CONSTRAINTS = {
    "max_norm": lambda m: m.MaxNormConstraint(0.7, dims=0),
    "min_max_norm": lambda m: m.MinMaxNormConstraint(0.3, 0.8, rate=0.5),
    "non_negative": lambda m: m.NonNegativeConstraint(),
    "unit_norm": lambda m: m.UnitNormConstraint(dims=1),
}


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraint_apply_matches_reference(name):
    w = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    got = CONSTRAINTS[name](tcons).apply(torch.as_tensor(w))
    want = CONSTRAINTS[name](jtrain).apply(jnp.asarray(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _constrained_mln(m, cons, frozen=False):
    b = (m.NeuralNetConfiguration.builder().seed(0)
         .updater(m_updater(m)(5e-2))
         .constrain_weights(cons).constrain_bias(
             CONSTRAINTS["non_negative"](
                 jtrain if m is jnn else ttrain)))
    return m.MultiLayerNetwork(
        b.list().layer(m.DenseLayer(n_in=6, n_out=8, activation="tanh",
                                    frozen=frozen))
        .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent")).build())


def m_updater(m):
    return jtrain.Adam if m is jnn else ttrain.Adam


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_mln_constraints_hold_after_each_step(name):
    jnet = _constrained_mln(jnn, CONSTRAINTS[name](jtrain)).init((6,))
    tnet = _constrained_mln(tnn, CONSTRAINTS[name](ttrain)).init(
        (6,), device="cpu")
    _sync(jnet, tnet)
    rng = np.random.default_rng(1)
    for _ in range(5):
        x = rng.standard_normal((16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        for path, jw in jax.tree_util.tree_leaves_with_path(jnet.params):
            k = [p.key for p in path]
            np.testing.assert_allclose(_np(tnet.params[k[0]][k[1]]),
                                       np.asarray(jw), atol=ATOL,
                                       err_msg=f"{name} {k}")
        assert (_np(tnet.params["layer_1"]["b"]) >= 0).all()
    if name == "max_norm":
        for key in ("layer_0", "layer_1"):
            norms = np.linalg.norm(_np(tnet.params[key]["W"]), axis=0)
            assert (norms <= 0.7 + 1e-5).all()


def test_frozen_layer_immune_to_constraints():
    tnet = _constrained_mln(tnn, ttrain.MaxNormConstraint(0.1),
                            frozen=True).init((6,), device="cpu")
    w0 = tnet.params["layer_0"]["W"].detach().clone()
    b0 = tnet.params["layer_0"]["b"].detach().clone()
    rng = np.random.default_rng(2)
    tnet.fit(DataSet(rng.standard_normal((8, 6)).astype(np.float32),
                     np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]))
    assert torch.equal(tnet.params["layer_0"]["W"], w0)
    assert torch.equal(tnet.params["layer_0"]["b"], b0)
    norms = np.linalg.norm(_np(tnet.params["layer_1"]["W"]), axis=0)
    assert (norms <= 0.1 + 1e-6).all()


def test_cg_constraints_match_jax_net():
    def conf(m, t):
        return m.ComputationGraph(
            m.NeuralNetConfiguration.builder().seed(3).updater(t.Sgd(0.5))
            .constrain_weights(t.MaxNormConstraint(0.4))
            .graph_builder().add_inputs("in")
            .add_layer("h", m.DenseLayer(n_in=5, n_out=7,
                                         activation="relu"), "in")
            .add_layer("out", m.OutputLayer(n_in=7, n_out=2), "h")
            .set_outputs("out").build())
    jnet = conf(jnn, jtrain).init([(5,)])
    tnet = conf(tnn, ttrain).init([(5,)], device="cpu")
    _sync(jnet, tnet)
    rng = np.random.default_rng(4)
    for _ in range(5):
        x = rng.standard_normal((12, 5)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 12)]
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    for node in ("h", "out"):
        np.testing.assert_allclose(_np(tnet.params[node]["W"]),
                                   np.asarray(jnet.params[node]["W"]),
                                   atol=ATOL)


# --------------------------------------------------- dropout and noise

def _jax_layer(layer, x, key=KEY):
    """The reference layer's train output and the key its draw used."""
    ctx = JCtx(train=True, rng=key)
    y, _ = layer.apply({}, {}, jnp.asarray(x), ctx)
    return np.asarray(y), jax.random.split(key)[1]


X = np.random.default_rng(5).standard_normal((6, 4, 8)).astype(np.float32)


def test_dropout_apply_on_reference_mask():
    y, k = _jax_layer(jcore.DropoutLayer(rate=0.3), X)
    mask = np.array(jax.random.bernoulli(k, 0.7, X.shape))
    got = tcore.dropout_apply(torch.as_tensor(X), torch.as_tensor(mask), 0.7)
    np.testing.assert_allclose(_np(got), y, atol=ATOL)


def test_spatial_dropout_apply_on_reference_mask():
    y, k = _jax_layer(jcore.SpatialDropout(rate=0.5), X)
    mask = np.array(jax.random.bernoulli(k, 0.5, (6, 1, 8)))
    assert tcore.spatial_mask_shape(torch.as_tensor(X)) == (6, 1, 8)
    got = tcore.dropout_apply(torch.as_tensor(X), torch.as_tensor(mask), 0.5)
    np.testing.assert_allclose(_np(got), y, atol=ATOL)


def test_alpha_dropout_apply_on_reference_mask():
    y, k = _jax_layer(jcore.AlphaDropout(rate=0.2), X)
    mask = np.array(jax.random.bernoulli(k, 0.8, X.shape))
    got = tcore.alpha_dropout_apply(torch.as_tensor(X),
                                    torch.as_tensor(mask), 0.2)
    np.testing.assert_allclose(_np(got), y, atol=ATOL)


def test_gaussian_dropout_and_noise_apply_on_reference_draws():
    y, k = _jax_layer(jcore.GaussianDropout(rate=0.4), X)
    z = torch.as_tensor(np.array(jax.random.normal(k, X.shape)))
    np.testing.assert_allclose(
        _np(tcore.gaussian_dropout_apply(torch.as_tensor(X), z, 0.4)), y,
        atol=ATOL)
    y, k = _jax_layer(jcore.GaussianNoise(stddev=0.3), X)
    z = torch.as_tensor(np.array(jax.random.normal(k, X.shape)))
    np.testing.assert_allclose(
        _np(tcore.gaussian_noise_apply(torch.as_tensor(X), z, 0.3)), y,
        atol=ATOL)


def _wn_params():
    r = np.random.default_rng(6)
    return {"W": r.standard_normal((4, 3)).astype(np.float32),
            "b": r.standard_normal(3).astype(np.float32),
            "RW": r.standard_normal((3, 3)).astype(np.float32)}


def _jax_draws(params, sample):
    """The reference's per-leaf draws (its ``_map_leaves`` key split)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(KEY, len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [sample(k, leaf) for k, leaf in zip(keys, leaves)])


@pytest.mark.parametrize("kind", ["dropconnect", "normal_add",
                                  "uniform_mul_bias", "bernoulli_mul"])
def test_weight_noise_apply_on_reference_draws(kind):
    p = _wn_params()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if kind == "dropconnect":
        jw, tw = jwn.DropConnect(0.6), twn.DropConnect(0.6)

        def sample(k, w):
            return jax.random.bernoulli(k, 0.6, w.shape)
    else:
        dist = {"normal_add": "NormalDistribution",
                "uniform_mul_bias": "UniformDistribution",
                "bernoulli_mul": "BernoulliDistribution"}[kind]
        args = {"NormalDistribution": (0.1, 0.5),
                "UniformDistribution": (0.5, 1.5),
                "BernoulliDistribution": (0.7,)}[dist]
        kw = dict(apply_to_bias=kind == "uniform_mul_bias",
                  additive=kind == "normal_add")
        jw = jwn.WeightNoise(getattr(jwn, dist)(*args), **kw)
        tw = twn.WeightNoise(getattr(twn, dist)(*args), **kw)

        def sample(k, w):
            return jw.distribution.sample(k, w.shape, w.dtype)
    want = jw.apply(jp, KEY)
    draws = _jax_draws(jp, sample)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    noise = {k: (None if v.ndim < 2 and not tw.apply_to_bias
                 else torch.as_tensor(np.array(draws[k])))
             for k, v in p.items()}
    got = tw.apply(tp, noise)
    for k in p:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    # the port's own draw leaves the same leaves alone
    own = tw.draw(tp, torch.Generator().manual_seed(0))
    assert [k for k in sorted(p) if own[k] is None] == \
        [k for k in sorted(p) if noise[k] is None]


def _sigma_ok(frac, keep, n):
    return abs(frac - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)


def test_own_draws_keep_rate_within_4_sigma_and_differ():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 500)
    for layer, keep in ((tcore.DropoutLayer(rate=0.3), 0.7),
                        (tcore.SpatialDropout(rate=0.5), 0.5)):
        ctx = tnn.Ctx(train=True, rng=gen)
        a, _ = layer.apply({}, {}, x, ctx)
        b, _ = layer.apply({}, {}, x, ctx)
        n = a.numel() if keep == 0.7 else 64 * 500
        assert _sigma_ok(float((a != 0).float().mean()), keep, n)
        assert not torch.equal(a, b)
    dc = twn.DropConnect(0.8)
    m = dc.draw({"W": torch.ones(200, 100)}, gen)["W"]
    assert _sigma_ok(float(m.float().mean()), 0.8, m.numel())
    g, _ = tcore.GaussianNoise(stddev=0.5).apply(
        {}, {}, torch.zeros(10000), tnn.Ctx(train=True, rng=gen))
    assert abs(float(g.std()) - 0.5) < 4 * 0.5 / np.sqrt(2 * 10000)


@pytest.mark.parametrize("layer", [
    tcore.DropoutLayer(rate=0.5), tcore.GaussianDropout(rate=0.5),
    tcore.GaussianNoise(stddev=1.0), tcore.AlphaDropout(rate=0.5),
    tcore.SpatialDropout(rate=0.5)], ids=lambda layer: type(layer).__name__)
def test_noise_layers_are_identity_at_inference(layer):
    x = torch.as_tensor(X)
    y, _ = layer.apply({}, {}, x, tnn.Ctx(train=False))
    assert y is x


def _noisy_mln(m, noise=None, dropout=0.0, seed=7):
    return m.MultiLayerNetwork(
        m.NeuralNetConfiguration.builder().seed(seed)
        .updater(m_updater(m)(1e-2)).list()
        .layer(m.DenseLayer(n_in=8, n_out=16, activation="relu",
                            weight_noise=noise))
        .layer(m.DenseLayer(n_in=16, n_out=16, activation="relu",
                            dropout=dropout))
        .layer(m.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .build())


def test_inference_unaffected_by_noise_and_dropout():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    clean = _noisy_mln(tnn).init((8,), device="cpu")
    noisy = _noisy_mln(tnn, twn.DropConnect(0.5), 0.4).init((8,),
                                                            device="cpu")
    assert torch.equal(clean.output(x), noisy.output(x))
    jnet = _noisy_mln(jnn, jwn.DropConnect(0.5), 0.4).init((8,))
    _sync(jnet, noisy)
    np.testing.assert_allclose(_np(noisy.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL)


def test_train_step_draws_new_masks_and_fits():
    """Input dropout and DropConnect draw from the net's generator: two
    train forwards differ, a train forward differs from inference, and
    fitting under both still lowers the loss."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    net = _noisy_mln(tnn, twn.DropConnect(0.8), 0.2).init((8,),
                                                          device="cpu")
    assert net._gen.device.type == "cpu"
    xt = torch.as_tensor(x)
    with torch.no_grad():
        a, _ = net._forward(net.params, net.states, xt, train=True,
                            rng=net._gen)
        b, _ = net._forward(net.params, net.states, xt, train=True,
                            rng=net._gen)
        c, _ = net._forward(net.params, net.states, xt, train=False,
                            rng=None)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    ds = DataSet(x, y)
    first = net.score(ds)
    for _ in range(30):
        net.fit(ds)
    assert net.score(ds) < first


def test_cg_input_dropout_and_weight_noise_fit():
    net = tnn.ComputationGraph(
        tnn.NeuralNetConfiguration.builder().seed(1)
        .updater(ttrain.Adam(1e-2)).graph_builder().add_inputs("in")
        .add_layer("h", tnn.DenseLayer(n_in=5, n_out=9, activation="relu",
                                       dropout=0.3,
                                       weight_noise=twn.WeightNoise()),
                   "in")
        .add_layer("out", tnn.OutputLayer(n_in=9, n_out=2), "h")
        .set_outputs("out").build()).init([(5,)], device="cpu")
    rng = np.random.default_rng(10)
    ds = DataSet(rng.standard_normal((32, 5)).astype(np.float32),
                 np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)])
    first = net.score(ds)
    for _ in range(30):
        net.fit(ds)
    assert net.score(ds) < first


# ------------------------------------------------------ anomaly detection

def test_grad_stats_match_reference():
    rng = np.random.default_rng(11)
    g = {"layer_0": {"W": rng.standard_normal((4, 3)).astype(np.float32),
                     "b": rng.standard_normal(3).astype(np.float32)},
         "layer_1": {}, "layer_2": {"W": np.array([[1.0, np.inf]],
                                                  np.float32)}}
    want = janom.grad_stats(jax.tree_util.tree_map(jnp.asarray, g))
    tg = {k: {n: torch.as_tensor(a) for n, a in v.items()}
          for k, v in g.items()}
    got = tanom.stats_dict(tanom.stat_groups(tg),
                           tanom.grad_stats(tg).tolist())
    assert sorted(got) == sorted(want) == ["layer_0", "layer_2"]
    for k in got:
        for f in tanom.FIELDS:
            np.testing.assert_allclose(got[k][f], float(want[k][f]),
                                       rtol=1e-6)


def _bn_mln(m):
    return m.MultiLayerNetwork(
        m.NeuralNetConfiguration.builder().seed(1)
        .updater(m_updater(m)(1e-3)).list()
        .layer(m.DenseLayer(n_in=4, n_out=8, activation="relu"))
        .layer(m.BatchNormalization())
        .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent")).build())


def _batches(n, bad=None):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        x = rng.standard_normal((16, 4)).astype(np.float32)
        if i == bad:
            x[0, 0] = np.nan
        out.append(DataSet(x, np.eye(3, dtype=np.float32)[
            rng.integers(0, 3, 16)]))
    return out


class _Steps:
    deferred_score_ok = True

    def __init__(self):
        self.seen = []

    def iteration_done(self, net, it, ep, score):
        self.seen.append(it)


def test_nan_batch_is_a_full_noop_and_raises_one_step_late():
    net = _bn_mln(tnn).init((4,), device="cpu")
    det = ttrain.GradientAnomalyDetector()
    net.enable_gradient_anomaly_detection(det)
    batches = _batches(4, bad=1)
    net.fit(batches[0])
    before = _snapshot(net)
    steps = _Steps()
    net.set_listeners(steps)
    with pytest.raises(FloatingPointError, match="nonfinite"):
        net.fit(batches[1:])
    # step 2 (the NaN batch) was checked after step 3 ran: one step late
    assert net._step_count == 3
    assert {a.iteration for a in det.anomalies} == {2}
    assert {a.kind for a in det.anomalies} == {"nonfinite"}
    # the pending step is delivered; the raise comes from step 3's check
    # before its own report, as in the reference's fit loop
    assert steps.seen == [2]
    # step 3 applied on top of the unchanged state of step 1: replaying
    # step 1 then step 3 on a fresh net gives the same tensors
    ref = _bn_mln(tnn).init((4,), device="cpu")
    ref.fit(batches[0])
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(ref), before))
    ref.fit(batches[2])
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(ref),
                                                 _snapshot(net)))


def test_nan_last_batch_leaves_everything_bit_identical():
    """As the reference's test_poisoned_batch_is_full_noop_including_bn_
    state: params, updater state and BN running stats unchanged; the
    detector (strict=False) records the anomaly at the flush."""
    net = _bn_mln(tnn).init((4,), device="cpu")
    net.enable_gradient_anomaly_detection(
        ttrain.GradientAnomalyDetector(strict=False))
    batches = _batches(2, bad=1)
    net.fit(batches[0])
    before = _snapshot(net)
    net.fit(batches[1])
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(net)))
    assert {a.kind for a in net._anomaly_detector.anomalies} == \
        {"nonfinite"}


def test_warn_mode_applies_the_update():
    net = _bn_mln(tnn).init((4,), device="cpu")
    net.enable_gradient_anomaly_detection(
        ttrain.GradientAnomalyDetector(strict=False, gate_updates=False))
    net.fit(_batches(2, bad=1))
    assert not torch.isfinite(net.params["layer_0"]["W"]).all()
    assert net._anomaly_detector.anomalies


def test_healthy_run_matches_jax_net_with_detector():
    jnet = _bn_mln(jnn).init((4,))
    jnet.enable_gradient_anomaly_detection(
        janom.GradientAnomalyDetector(strict=False))
    tnet = _bn_mln(tnn).init((4,), device="cpu")
    tnet.enable_gradient_anomaly_detection(
        ttrain.GradientAnomalyDetector(strict=False))
    _sync(jnet, tnet)
    batches = _batches(4)
    jnet.fit([JDataSet(b.features, b.labels) for b in batches])
    tnet.fit(batches)
    jd, td = jnet._anomaly_detector, tnet._anomaly_detector
    assert not jd.anomalies and not td.anomalies
    assert jd._seen == td._seen
    for k in jd._ema:
        np.testing.assert_allclose(td._ema[k], jd._ema[k], rtol=1e-5)
    np.testing.assert_allclose(_np(tnet.params["layer_0"]["W"]),
                               np.asarray(jnet.params["layer_0"]["W"]),
                               atol=1e-5)


def test_cg_gate_and_disable():
    net = tnn.ComputationGraph(
        tnn.NeuralNetConfiguration.builder().seed(2)
        .updater(ttrain.Momentum(0.1, 0.9)).graph_builder()
        .add_inputs("in")
        .add_layer("h", tnn.DenseLayer(n_in=4, n_out=6), "in")
        .add_layer("bn", tnn.BatchNormalization(), "h")
        .add_layer("out", tnn.OutputLayer(n_in=6, n_out=3), "bn")
        .set_outputs("out").build()).init([(4,)], device="cpu")
    net.enable_gradient_anomaly_detection(
        ttrain.GradientAnomalyDetector(strict=False))
    batches = _batches(2, bad=1)
    net.fit(batches[0])
    before = _snapshot(net)
    net.fit(batches[1])
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(net)))
    assert net.enable_gradient_anomaly_detection(False) is net
    assert net._anomaly_detector is None and net._step_fn is None

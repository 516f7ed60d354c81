"""The port's learning-rate schedules and the twelve updaters
(``deeplearning4j_tpu_torch/train/schedules.py``, ``train/updaters.py``)
against the JAX package, on the CPU.

- every schedule's ``value_at`` over iterations 0-200, ITERATION and EPOCH
  typed, against the reference's (f32, 1e-6 relative), and its step-side
  form (an int32 count tensor in, an f32 tensor out) against the same;
- each of the twelve updaters, with a constant lr and with a schedule,
  as a transform against optax (5 steps, 1e-6) and through an MLN's
  ``fit`` against the JAX net's (params after 5 steps within 1e-5), once
  more with a gradient normalization set;
- the state is allocated by ``init`` and updated in place (the step stays
  capturable), and the lr of a scheduled step is the schedule's at the
  updater's own count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train.schedules as jsch
import deeplearning4j_tpu.train.updaters as jupd
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train.schedules as tsch
import deeplearning4j_tpu_torch.train.updaters as tupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn._compiled import tensors

SCHED_RTOL = 1e-6
# every schedule here peaks at 0.1: where a value is a small difference of
# f32 terms (the cosine's tail, 1 + cos near -1), the reference's own f32
# result carries an absolute error of a rounding of the peak, and torch's
# and XLA's cos differ by one
SCHED_ATOL = 2 * float(np.finfo(np.float32).eps) * 0.1
TRANSFORM_ATOL = 1e-6
NET_ATOL = 1e-5

SCHEDULES = {
    "fixed": lambda m, t: m.FixedSchedule(t, value=0.05),
    "step": lambda m, t: m.StepSchedule(t, initial_value=0.1,
                                        decay_rate=0.5, step=7),
    "exponential": lambda m, t: m.ExponentialSchedule(
        t, initial_value=0.1, gamma=0.99),
    "inverse": lambda m, t: m.InverseSchedule(t, initial_value=0.1,
                                              gamma=0.05, power=0.75),
    "poly": lambda m, t: m.PolySchedule(t, initial_value=0.1, power=2.0,
                                        max_iter=150),
    "sigmoid": lambda m, t: m.SigmoidSchedule(t, initial_value=0.1,
                                              gamma=0.05, step_size=60),
    "map": lambda m, t: m.MapSchedule(t, values={0: 0.1, 10: 0.05,
                                                 75: 0.01}),
    "cycle": lambda m, t: m.CycleSchedule(
        t, initial_value=1e-3, max_value=0.1, cycle_length=120,
        annealing_start_fraction=0.8, annealing_decay=0.2),
    "warmup_cosine": lambda m, t: m.WarmupCosineSchedule(
        t, peak_value=0.1, warmup_steps=20, total_steps=180,
        end_value=1e-3),
}


@pytest.mark.parametrize("kind", ["iteration", "epoch"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_value_at_matches_reference(name, kind):
    js = SCHEDULES[name](jsch, kind)
    ts = SCHEDULES[name](tsch, kind)
    for it in range(201):
        ep = it // 7
        want = float(np.float32(js.value_at(it, ep)))
        got = ts.value_at(it, ep)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=SCHED_RTOL,
                                   atol=SCHED_ATOL,
                                   err_msg=f"{name} {kind} at {it}")


@pytest.mark.parametrize("kind", ["iteration", "epoch"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_step_form_matches_optax_form(name, kind):
    """The device form (an int32 count in) against the reference's
    ``to_optax`` on an int32 count, EPOCH types at 7 steps an epoch."""
    jf = SCHEDULES[name](jsch, kind).to_optax(7)
    ts = SCHEDULES[name](tsch, kind)
    want = np.asarray(jax.vmap(jf)(jnp.arange(201, dtype=jnp.int32)),
                      np.float32)
    for step in range(201):
        got = ts.at(torch.tensor(step, dtype=torch.int32), 7)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(
            got.item(), float(want[step]),
            rtol=SCHED_RTOL, atol=SCHED_ATOL,
            err_msg=f"{name} {kind} at {step}")


def _updaters(m, sched=None):
    """The updaters of module ``m``, each lr a StepSchedule of ``sched``
    (a schedules module) when given."""
    def lr(v):
        return sched.StepSchedule(initial_value=v, decay_rate=0.5, step=2) \
            if sched else v
    return {
        "sgd": m.Sgd(lr(0.1)), "momentum": m.Momentum(lr(0.1), 0.9),
        "nesterovs": m.Nesterovs(lr(0.05), 0.8), "adam": m.Adam(lr(1e-2)),
        "adamw": m.AdamW(lr(1e-2), weight_decay=0.1),
        "amsgrad": m.AMSGrad(lr(1e-2)), "nadam": m.Nadam(lr(1e-2)),
        "adamax": m.AdaMax(lr(2e-2)), "adadelta": m.AdaDelta(lr(1.0)),
        "adagrad": m.AdaGrad(lr(0.1)), "rmsprop": m.RmsProp(lr(1e-2)),
        "lion": m.Lion(lr(1e-2), weight_decay=0.05),
        "lamb": m.Lamb(lr(1e-2), weight_decay=0.01),
    }


UPDATER_NAMES = sorted(_updaters(tupd))


def _tree(rng):
    return {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": {},
            "d": {"gamma": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("sched", [False, True], ids=["const", "schedule"])
@pytest.mark.parametrize("name", UPDATER_NAMES)
def test_updater_transform_matches_optax(name, sched):
    jopt = _updaters(jupd, jsch if sched else None)[name].to_optax()
    topt = _updaters(tupd, tsch if sched else None)[name].to_transform()
    rng = np.random.default_rng(21)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = tupd.tree_map(lambda a: torch.as_tensor(a.copy()), p0)
    ts = topt.init(tp)
    state_ids = [id(t) for t in tensors(ts)]
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = tupd.tree_map(lambda a: torch.as_tensor(a.copy()), g)
        tu, ts2 = topt.update(tg, ts, tp)
        assert tu is tg and ts2 is ts               # in place
        tupd.apply_updates(tupd.tree_leaves(tp), tupd.tree_leaves(tu))
        for n in p0:
            for k in p0[n]:
                np.testing.assert_allclose(
                    tp[n][k].numpy(), np.asarray(jp[n][k]),
                    atol=TRANSFORM_ATOL, err_msg=f"{name} {n}/{k}")
    assert [id(t) for t in tensors(ts)] == state_ids


def test_scheduled_lr_is_the_schedules_at_the_updaters_count():
    """Sgd under a schedule: update k is −schedule(k)·g for k = 0, 1, …
    (the count the transform keeps, incremented after use)."""
    sched = tsch.ExponentialSchedule(initial_value=0.5, gamma=0.9)
    opt = tupd.Sgd(sched).to_transform()
    p = {"w": torch.zeros(3)}
    st = opt.init(p)
    for k in range(6):
        u, _ = opt.update({"w": torch.ones(3)}, st, p)
        np.testing.assert_allclose(u["w"].numpy(),
                                   -np.float32(sched.value_at(k, 0)),
                                   rtol=1e-6)
    assert int(st[1]["count"]) == 6


def test_epoch_schedule_divides_by_iters_per_epoch():
    sched = tsch.StepSchedule(tsch.ScheduleType.EPOCH, initial_value=1.0,
                              decay_rate=0.5, step=1)
    opt = tupd.Sgd(sched).to_transform(iters_per_epoch=3)
    p = {"w": torch.zeros(1)}
    st = opt.init(p)
    got = [float(opt.update({"w": torch.ones(1)}, st, p)[0]["w"])
           for _ in range(7)]
    assert got == [-1.0] * 3 + [-0.5] * 3 + [-0.25]


def _mln(m, updater, grad_norm=None):
    b = (m.NeuralNetConfiguration.builder().seed(3).updater(updater))
    if grad_norm:
        b = b.gradient_normalization(grad_norm) \
            .gradient_normalization_threshold(0.5)
    return m.MultiLayerNetwork(
        b.list().layer(m.DenseLayer(n_in=6, n_out=8, activation="tanh"))
        .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent")).build())


@pytest.mark.parametrize("sched,grad_norm", [
    (False, None), (True, None), (False, "clip_l2_per_layer")],
    ids=["const", "schedule", "grad_norm"])
@pytest.mark.parametrize("name", UPDATER_NAMES)
def test_updater_mln_5_steps_match_jax_net(name, sched, grad_norm):
    jnet = _mln(jnn, _updaters(jupd, jsch if sched else None)[name], grad_norm).init((6,))
    tnet = _mln(tnn, _updaters(tupd, tsch if sched else None)[name], grad_norm).init(
        (6,), device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((10, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)])
               for _ in range(5)]
    jnet.fit([JDataSet(x, y) for x, y in batches])
    tnet.fit([DataSet(x, y) for x, y in batches])
    for (path, jw) in jax.tree_util.tree_leaves_with_path(jnet.params):
        keys = [p.key for p in path]
        np.testing.assert_allclose(
            tnet.params[keys[0]][keys[1]].detach().numpy(), np.asarray(jw),
            atol=NET_ATOL, err_msg=f"{name} {keys}")


def test_lr_must_be_a_number_or_schedule():
    with pytest.raises(TypeError, match="Schedule"):
        tupd.Sgd(learning_rate=lambda step: 0.1).to_transform()

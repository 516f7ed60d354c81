"""The port's checkpointer (``serde.orbax_ckpt`` on
``torch.distributed.checkpoint``): every test of
``tests/test_checkpointing.py`` — a round trip with retention, a sharded
round trip (here a gloo world of 2 under fsdp through the port's mesh,
where the updater state is split over the ranks), the preemption
watchdog's interval and SIGTERM save, and resume equivalence (fit 4 epochs
straight == fit 2, checkpoint, restore into a fresh net, fit 2) — plus
the async path with ``save_interval_steps``. Bars: restored tensors equal
the saved ones bit for bit; a resumed run equals the uninterrupted one
within 1e-6.
"""

from __future__ import annotations

import signal

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.serde.orbax_ckpt import (
    CheckpointingTrainerMixin, OrbaxCheckpointer, PreemptionWatchdog)

from torch_parallel_ranks import RankPool, build

torch.set_num_threads(2)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer_0": {"W": torch.randn(8, 4, generator=g),
                        "b": torch.zeros(4)},
            "layer_1": {"W": torch.randn(4, 2, generator=g)}}


def _scaled(p, s):
    return {k: {n: t * s for n, t in v.items()} for k, v in p.items()}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), (a, b)
    else:
        assert a == b


def test_orbax_roundtrip_and_retention(tmp_path):
    ckpt = OrbaxCheckpointer(tmp_path, max_to_keep=2, async_=False)
    p = _params()
    for step in (1, 2, 3):
        ckpt.save(step, _scaled(p, step), metadata={"step_count": step},
                  force=True)
    ckpt.wait()
    assert ckpt.latest_step() == 3
    rp, rs, ro, meta = ckpt.restore(params_like=p)
    _assert_tree_equal(rp, _scaled(p, 3))
    assert rs is None and ro is None
    assert meta["step_count"] == 3
    # without a template the tree comes back from its saved structure
    rp2, _, _, _ = ckpt.restore(step=2)
    _assert_tree_equal(rp2, _scaled(p, 2))
    # retention: only the last two steps survive
    with pytest.raises(Exception):
        ckpt.restore(step=1, params_like=p)
    ckpt.close()


def test_async_save_interval_and_staging(tmp_path):
    """Async saves stage host copies at ``save``: the trees may change in
    place while the write runs. ``save_interval_steps`` skips the steps
    that are not its multiples unless forced."""
    ckpt = OrbaxCheckpointer(tmp_path, max_to_keep=3, async_=True,
                             save_interval_steps=2)
    p = _params(3)
    opt = (torch.tensor(5, dtype=torch.int32),
           {"mu": _scaled(p, 0.5)}, [None, 2.5])
    want = {k: {n: t.clone() for n, t in v.items()} for k, v in p.items()}
    assert not ckpt.save(1, p)                 # not a multiple of 2
    assert ckpt.save(2, p, opt_state=opt)
    for v in p.values():                       # train on, in place
        for t in v.values():
            t.add_(1.0)
    assert ckpt.save(3, p, force=True)
    assert not ckpt.save(3, p)                 # already past
    ckpt.wait()
    assert ckpt.latest_step() == 3
    rp, _, ro, _ = ckpt.restore(step=2, params_like=want,
                                opt_state_like=opt)
    _assert_tree_equal(rp, want)
    _assert_tree_equal(ro, opt)
    _, _, ro2, _ = ckpt.restore(step=2)        # structure from the save
    _assert_tree_equal(ro2, opt)
    ckpt.close()


def test_preemption_watchdog_interval_and_sigterm(tmp_path):
    ckpt = OrbaxCheckpointer(tmp_path, async_=False)
    dog = PreemptionWatchdog(ckpt, interval_s=10_000.0)
    p = _params(1)
    assert not dog.maybe_save(1, p)      # interval not elapsed
    dog._last -= 20_000.0                # pretend time passed
    assert dog.maybe_save(2, p)
    ckpt.wait()
    assert ckpt.latest_step() == 2
    old = signal.getsignal(signal.SIGTERM)
    try:
        dog.install_signal_handler(lambda: (7, p, None, None))
        with pytest.raises(SystemExit) as exc_info:
            signal.raise_signal(signal.SIGTERM)
        assert exc_info.value.code == 143
        assert ckpt.latest_step() == 7
    finally:
        signal.signal(signal.SIGTERM, old)
    ckpt.close()


def _mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(3).updater(t.Adam(1e-2))
            .list()
            .layer(m.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return m.MultiLayerNetwork(conf).init((4,), device="cpu")


@pytest.mark.parametrize("async_", [False, True])
def test_resume_training_equivalence(tmp_path, async_):
    """fit 4 epochs straight == fit 2, checkpoint, restore into a FRESH
    net, fit 2 more — the elastic-resume guarantee."""
    import deeplearning4j_tpu_torch.nn as m
    import deeplearning4j_tpu_torch.train as t
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    straight = _mlp(m, t)
    straight.fit(x, y, epochs=4)
    interrupted = _mlp(m, t)
    interrupted.fit(x, y, epochs=2)
    ckpt = OrbaxCheckpointer(tmp_path, async_=async_)
    ckpt.save(interrupted._step_count, interrupted.params,
              interrupted.states, interrupted._opt_state,
              metadata={"step_count": interrupted._step_count,
                        "epoch_count": interrupted.epoch_count}, force=True)
    ckpt.wait()
    resumed = _mlp(m, t)
    resumed.fit(x, y, epochs=1)  # builds the updater state, then overwritten
    ids = [id(v) for v in resumed.params["layer_0"].values()]
    step = CheckpointingTrainerMixin.resume(resumed, ckpt)
    assert step == 2 and resumed._step_count == 2
    # restored in place: the net keeps its tensors (and its graphs)
    assert ids == [id(v) for v in resumed.params["layer_0"].values()]
    _assert_tree_equal(resumed._opt_state, interrupted._opt_state)
    resumed.fit(x, y, epochs=2)
    ckpt.close()
    for a, b in zip(straight.params_flat(), resumed.params_flat()):
        np.testing.assert_allclose(a.item(), b.item(), atol=1e-6)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def test_per_rank_checkpoint_under_fsdp_world_2(pool, tmp_path):
    """A gloo world of 2 through the port's mesh, fsdp splitting the
    updater state: each rank saves its own slice asynchronously while it
    trains on; a fresh pair of ranks resumed from the save retraces the
    uninterrupted run exactly."""
    import deeplearning4j_tpu.nn as jnn
    import deeplearning4j_tpu.parallel as jpar
    import deeplearning4j_tpu.train as jtrain
    wide = build((jnn, jtrain, jpar, False), "wide_mlp")
    rng = np.random.default_rng(0)
    wx = rng.standard_normal((16, 128)).astype(np.float32)
    wy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    r = pool.run("orbax_fsdp", dict(
        wide_params=np_(wide.params), wide_states=np_(wide.states), wx=wx,
        wy=wy, dir=str(tmp_path / "ck")))
    for rank, out in enumerate(r):
        assert out["step"] == 2
        assert out["resumed"] == out["straight"]
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               out["restored"], out["state_then"])
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               out["params"], out["params2"])
        assert {"__0_0.distcp", "__1_0.distcp", ".metadata",
                "structure.json.r0", "structure.json.r1"} <= \
            set(out["files"])
    # the split state: each rank held (and restored) its own half
    halves = [[a.shape for a in jax.tree_util.tree_leaves(o["restored"])]
              for o in r]
    assert (64, 256) in [tuple(s) for s in halves[0]] or \
        (128, 128) in [tuple(s) for s in halves[0]]

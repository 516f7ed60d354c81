"""Ranks for the port's parallel parity tests
(``tests/test_torch_parallel*.py``, ``test_torch_moe_ring.py`` and the
parallel cases of ``test_torch_early_stopping.py`` and
``test_torch_parallel_inference.py``).

:class:`RankPool` starts ``world`` processes running this file: each
joins one gloo group (a file store in a temporary directory) and then
runs the cases the test process hands it, one at a time, every rank the
same case: the test writes ``task_<n>.pkl`` (a case name and a payload of
numpy arrays), each rank writes ``result_<n>_<rank>.pkl`` (its result,
or the traceback of its error). A rank that does not answer within the
case's timeout fails the test and the pool is started anew for the next
one. The ranks import the port only — never jax or the JAX package; the
tests compute the reference side themselves.

The network builders take the package's modules as arguments, so that a
test builds the same configuration in both packages.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# --------------------------------------------------------------- the pool

class RankPool:
    """``world`` ranks over gloo on the CPU (see the module docstring)."""

    def __init__(self, world: int):
        self.world = world
        self._start()

    def _start(self):
        self.dir = tempfile.mkdtemp(prefix="dl4j_ranks_")
        self.n = 0
        env = dict(os.environ, OMP_NUM_THREADS="1")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r),
             str(self.world), self.dir], env=env,
            stdout=subprocess.DEVNULL, stderr=open(
                os.path.join(self.dir, f"err_{r}.txt"), "w"))
            for r in range(self.world)]

    def run(self, name, payload=None, timeout=120.0):
        """Run case ``name`` on every rank → the ranks' results, in rank
        order; a rank's error raises here with its traceback."""
        n = self.n
        self.n += 1
        tmp = os.path.join(self.dir, f"task_{n}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump((name, payload), f)
        os.replace(tmp, os.path.join(self.dir, f"task_{n}.pkl"))
        deadline = time.time() + timeout
        out = [None] * self.world
        left = set(range(self.world))
        while left:
            for r in list(left):
                p = os.path.join(self.dir, f"result_{n}_{r}.pkl")
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        out[r] = pickle.load(f)
                    left.discard(r)
            if not left:
                break
            dead = [r for r in left if self.procs[r].poll() is not None]
            if dead or time.time() > deadline:
                errs = "".join(open(os.path.join(self.dir, f"err_{r}.txt"))
                               .read()[-3000:] for r in sorted(left))
                self.close()
                self._start()
                raise AssertionError(
                    f"case {name}: ranks {sorted(left)} "
                    f"{'died' if dead else 'did not answer'}\n{errs}")
            time.sleep(0.005)
        bad = [r for r, (kind, _) in enumerate(out) if kind == "error"]
        if bad:
            msg = out[bad[0]][1]
            self.close()
            self._start()
            raise AssertionError(f"case {name} failed on rank {bad[0]}:\n"
                                 f"{msg}")
        return [v for _, v in out]

    def close(self):
        try:
            with open(os.path.join(self.dir, f"task_{self.n}.pkl"),
                      "wb") as f:
                pickle.dump(("__stop__", None), f)
        except OSError:
            pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def _serve(rank, world, workdir):
    import faulthandler
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world, timeout=timedelta(seconds=90))
    n = 0
    while True:
        task = os.path.join(workdir, f"task_{n}.pkl")
        while not os.path.exists(task):
            time.sleep(0.002)
        with open(task, "rb") as f:
            name, payload = pickle.load(f)
        if name == "__stop__":
            break
        # a rank stuck in a case writes its stack where the pool reads it
        faulthandler.dump_traceback_later(100, file=sys.stderr)
        try:
            res = ("ok", CASES[name](rank, world, payload))
        except BaseException:                 # noqa: BLE001 — reported
            res = ("error", traceback.format_exc())
        faulthandler.cancel_dump_traceback_later()
        tmp = os.path.join(workdir, f"result_{n}_{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, os.path.join(workdir, f"result_{n}_{rank}.pkl"))
        n += 1
    dist.destroy_process_group()


# -------------------------------------------------- shared net builders

def iris_mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(5).updater(t.Sgd(0.5))
            .list()
            .layer(m.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (4,)


def tp_mlp(m, t, cls1, cls2, seed=7):
    conf = (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(t.Adam(1e-3)).list()
            .layer(cls1(n_in=32, n_out=64, activation="relu"))
            .layer(cls2(n_out=32, activation="relu"))
            .layer(m.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (32,)


def pp_mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(7).updater(t.Adam(1e-3))
            .list()
            .layer(m.DenseLayer(n_in=16, n_out=48, activation="relu"))
            .layer(m.DenseLayer(n_out=24, activation="relu"))
            .layer(m.DenseLayer(n_out=24, activation="relu"))
            .layer(m.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (16,)


def pp_bn_net(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(0).updater(t.Adam(1e-3))
            .list()
            .layer(m.DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(m.BatchNormalization())
            .layer(m.DenseLayer(n_out=12, activation="relu"))
            .layer(m.OutputLayer(n_out=2, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (8,)


def dropout_mlp(m, t, dropout):
    conf = (m.NeuralNetConfiguration.builder().seed(9).list()
            .layer(m.DenseLayer(n_in=12, n_out=24, activation="relu"))
            .layer(m.DenseLayer(n_out=24, activation="relu",
                                dropout=dropout))
            .layer(m.DenseLayer(n_out=12, activation="relu"))
            .layer(m.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (12,)


def small_cg(m, t, seed=7):
    """The residual conv graph of the reference's wrapper tests (two
    BNs)."""
    b = m.NeuralNetConfiguration.builder().seed(seed).updater(t.Sgd(0.1))
    g = b.graph_builder().add_inputs("in")
    g.add_layer("c1", m.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                         convolution_mode="same",
                                         activation="identity"), "in")
    g.add_layer("bn1", m.BatchNormalization(activation="relu"), "c1")
    g.add_layer("c2", m.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                         convolution_mode="same",
                                         activation="identity"), "bn1")
    g.add_layer("bn2", m.BatchNormalization(activation="identity"), "c2")
    g.add_vertex("add", m.ElementWiseVertex(op="add"), "bn2", "bn1")
    g.add_layer("act", m.ActivationLayer(activation="relu"), "add")
    g.add_layer("out", m.OutputLayer(n_out=5, activation="softmax",
                                     loss="mcxent"), "act")
    g.set_outputs("out")
    g.set_input_types(m.InputType.convolutional(8, 8, 3))
    return g.build(), None


def mds_cg(m, t):
    b = m.NeuralNetConfiguration.builder().seed(11).updater(t.Sgd(0.1))
    g = b.graph_builder().add_inputs("a", "b")
    g.add_layer("da", m.DenseLayer(n_in=6, n_out=8, activation="tanh"), "a")
    g.add_layer("db", m.DenseLayer(n_in=4, n_out=8, activation="tanh"), "b")
    g.add_vertex("m", m.MergeVertex(), "da", "db")
    g.add_layer("o1", m.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                    loss="mcxent"), "m")
    g.add_layer("o2", m.OutputLayer(n_in=16, n_out=2, activation="softmax",
                                    loss="mcxent"), "m")
    g.set_outputs("o1", "o2")
    return g.build(), [(6,), (4,)]


def tp_cg_net(m, t, cls1, cls2):
    g = (m.NeuralNetConfiguration.builder().seed(3).updater(t.Adam(1e-3))
         .graph_builder().add_inputs("in")
         .add_layer("h1", cls1(n_in=16, n_out=32, activation="relu"), "in")
         .add_layer("h2", cls2(n_out=16, activation="relu"), "h1")
         .add_layer("out", m.OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"), "h2")
         .set_outputs("out"))
    return g.build(), [(16,)]


def wide_mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(8).updater(t.Adam(1e-2))
            .list()
            .layer(m.DenseLayer(n_in=128, n_out=256, activation="relu"))
            .layer(m.OutputLayer(n_in=256, n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (128,)


def linear_cg(m, t):
    gb = (m.NeuralNetConfiguration.builder().seed(6).updater(t.Adam(1e-3))
          .graph_builder().add_inputs("in")
          .add_layer("d1", m.DenseLayer(n_in=16, n_out=32,
                                        activation="relu"), "in")
          .add_layer("d2", m.DenseLayer(n_out=16, activation="relu"), "d1")
          .add_layer("out", m.OutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"), "d2")
          .set_outputs("out"))
    return gb.build(), [(16,)]


def pa_mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(11).updater(t.Sgd(5e-2))
            .list()
            .layer(m.DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(m.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(6))
            .build())
    return conf, None


def pa_adam(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(4).updater(t.Adam(2e-2))
            .list()
            .layer(m.DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(m.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(4))
            .build())
    return conf, None


def rnn_net(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(2).updater(t.Sgd(5e-2))
            .list()
            .layer(m.SimpleRnn(n_in=3, n_out=8, activation="tanh"))
            .layer(m.RnnOutputLayer(n_in=8, n_out=2, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(m.InputType.recurrent(3, 6))
            .build())
    return conf, None


def scan_mlp(m, t):
    conf = (m.NeuralNetConfiguration.builder().seed(13).updater(t.Sgd(0.2))
            .list()
            .layer(m.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(m.OutputLayer(n_in=12, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (6,)


def dry_mlp(m, t, cls1, cls2):
    conf = (m.NeuralNetConfiguration.builder().seed(5).updater(t.Adam(1e-3))
            .list()
            .layer(cls1(n_in=16, n_out=32, activation="relu"))
            .layer(cls2(n_out=16, activation="relu"))
            .layer(m.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .build())
    return conf, (16,)


def es_mlp(m, t, seed=7):
    conf = (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(t.Adam(2e-2)).list()
            .layer(m.DenseLayer(n_in=5, n_out=24, activation="relu"))
            .layer(m.OutputLayer(n_in=24, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(5)).build())
    return conf, None


def es_cg(m, t):
    b = m.NeuralNetConfiguration.builder().seed(3).updater(t.Adam(5e-3))
    g = b.graph_builder().add_inputs("in")
    g.add_layer("d1", m.DenseLayer(n_in=5, n_out=16, activation="tanh"),
                "in")
    g.add_layer("out", m.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                     loss="mcxent"), "d1")
    g.set_outputs("out")
    return g.build(), [(5,)]


BUILDERS = {f.__name__: f for f in (
    iris_mlp, tp_mlp, pp_mlp, pp_bn_net, dropout_mlp, small_cg, mds_cg,
    linear_cg, pa_mlp, pa_adam, rnn_net, scan_mlp, dry_mlp, es_mlp, es_cg,
    tp_cg_net, wide_mlp)}


def build(pkg, name, *args, **kw):
    """A net of builder ``name`` in ``pkg`` ((nn, train, parallel, port?)
    modules), initialized (the port's on the CPU)."""
    m, t, _, port = pkg
    conf, shape = BUILDERS[name](m, t, *args, **kw)
    net = m.ComputationGraph(conf) if hasattr(conf, "nodes") \
        else m.MultiLayerNetwork(conf)
    kw = {"device": "cpu"} if port else {}
    return net.init(**kw) if shape is None else net.init(shape, **kw)


# ------------------------------------------------------------- port side

def _port():
    import deeplearning4j_tpu_torch.nn as tnn
    import deeplearning4j_tpu_torch.parallel as tpar
    import deeplearning4j_tpu_torch.train as ttrain
    return tnn, ttrain, tpar, True


def _cls(pkg, name):
    """A layer class by name: nn's, else parallel's."""
    m, _, par, _ = pkg
    return getattr(m, name, None) or getattr(par, name)


def port_net(name, payload=None, *args, **kw):
    """The port's net of builder ``name`` on the CPU, on the payload's
    weights (``params``/``states``: the JAX net's, as numpy) if given."""
    pkg = _port()
    args = tuple(_cls(pkg, a) if isinstance(a, str) and a[0].isupper()
                 else a for a in args)
    net = build(pkg, name, *args, **kw)
    if payload is not None and "params" in payload:
        net.params, net.states = pkg[0].params_from_numpy(
            payload["params"], payload["states"], "cpu")
    return net


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy().copy()
    return tree


def ds(x, y, **kw):
    from deeplearning4j_tpu_torch.data import DataSet
    return DataSet(x, y, **kw)


def cpu_mesh(devices=None, **axes):
    from deeplearning4j_tpu_torch.parallel import make_mesh
    return make_mesh(devices, device="cpu", **axes)


def pg(tree):
    """A tree of placements → their specs."""
    if isinstance(tree, dict):
        return {k: pg(v) for k, v in tree.items()}
    return tuple(tree.spec)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_cases  # noqa: F401  (registers the cases)
    import torch_parallel_ranks
    torch_parallel_ranks._serve(int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3])

"""The port's side of the parallel parity cases, run on every rank of a
``torch_parallel_ranks.RankPool`` (gloo on the CPU). Each case builds the
port's nets on the payload's weights (the JAX net's, as numpy), runs the
parallel entry point a user would call, and returns numpy results; the
tests hold them against the JAX package. Imports the port only."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_parallel_ranks import case, cpu_mesh, ds, np_tree, pg, port_net


def _par():
    import deeplearning4j_tpu_torch.parallel as par
    return par


def _list(batches):
    """The batches one by one (the iterator's batch size is theirs)."""
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    return ListDataSetIterator(batches,
                               batch_size=batches[0].num_examples())


def _adam(lr):
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import build_optimizer
    return build_optimizer(Adam(lr))


def _raises(fn, exc, match=None):
    try:
        fn()
    except exc as e:
        return match is None or match in str(e)
    return False


# ------------------------------------------------------------ mesh, dp

@case
def mesh_spec(rank, world, p):
    par = _par()
    mesh = cpu_mesh(dp=2, tp=2)
    par.bootstrap_distributed()          # the world exists: a no-op
    hybrid = par.hybrid_mesh_2d({"tp": 2}, {"dp": 2}, device="cpu")
    return {"shape": mesh.shape,
            "odd": _raises(lambda: cpu_mesh(dp=3), ValueError),
            "bogus": _raises(lambda: par.MeshSpec({"bogus": 4}), ValueError),
            "groups": (mesh.group("dp").ranks, mesh.group("tp").ranks),
            "specs": (par.replicated(mesh).spec,
                      par.batch_sharding(mesh).spec),
            "hybrid": (hybrid.shape, hybrid.group("tp").ranks)}


@case
def dp_fit(rank, world, p):
    par = _par()
    net = port_net("iris_mlp", p)
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=world))
    for _ in range(p["epochs"]):
        pw.fit([ds(p["x"], p["y"])])
    return {"params": np_tree(net.params), "audit": pw.audit_drift()}


@case
def fsdp_sharding(rank, world, p):
    par = _par()
    mesh = cpu_mesh(fsdp=world)
    params = {"big": torch.zeros((16, 1024 * 16)), "small": torch.zeros(4)}
    return pg(par.shard_params_fsdp(mesh, params))


@case
def tp_mln(rank, world, p):
    par = _par()
    net = port_net("tp_mlp", p, "ColumnParallelDense", "RowParallelDense")
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=2, tp=2))
    losses = [pw.fit([ds(p["x"], p["y"])]) for _ in range(5)]
    return {"losses": losses, "specs": pg(pw.placements),
            "params": np_tree(net.params)}


@case
def tp_cg(rank, world, p):
    par = _par()
    net = port_net("tp_cg_net", p, "ColumnParallelDense", "RowParallelDense")
    mesh = cpu_mesh(dp=2, tp=2)
    pw = par.ParallelWrapper(net, mesh=mesh)
    grads, loss = pw.gradient_and_score(ds(p["x"], p["y"]))
    return {"loss": loss, "specs": pg(par.network_param_shardings(mesh, net)),
            "grads": np_tree(grads)}


@case
def groups_travel(rank, world, p):
    """The BN net's loss of this rank's rows under the dp group, and on
    another thread, between that forward and its backward, the same rows'
    loss with no groups; the grads and the loss summed over the ranks."""
    import threading
    from deeplearning4j_tpu_torch import _dist
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    net = port_net("pp_bn_net", p)
    g = cpu_mesh(dp=world).group("dp")
    lo, hi = g.slice_of(p["x"].shape[0])
    x, y = torch.tensor(p["x"][lo:hi]), torch.tensor(p["y"][lo:hi])
    loss, states = net._loss(net.params, net.states, x, y, None, None, None,
                             _dist.Groups(batch=g))
    own = []
    t = threading.Thread(target=lambda: own.append(float(net._loss(
        net.params, net.states, x, y, None, None, None)[0])))
    t.start()
    t.join(timeout=60)
    if t.is_alive() or not own:
        raise RuntimeError("the thread without groups did not finish")
    leaves = list(tree_leaves(net.params))
    gs = list(torch.autograd.grad(loss, leaves))
    total = loss.detach().reshape(1).clone()
    _dist.sum_(gs + [total], g)
    grads = _unflatten_like(net.params, iter(gs))
    return {"loss": float(total[0]), "own": own[0], "grads": np_tree(grads),
            "states": np_tree(states)}


def _unflatten_like(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], it) for k in sorted(tree)}
    return next(it)


@case
def loss_shares(rank, world, p):
    """Each loss of this rank's rows under the dp group (the registry's,
    a callable of the user's, YOLO2's head), summed over the ranks."""
    from deeplearning4j_tpu_torch import _dist
    from deeplearning4j_tpu_torch.nn import losses
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        Yolo2OutputLayer
    g = cpu_mesh(dp=world).group("dp")
    lo, hi = g.slice_of(p["probs"].shape[0])

    def rows(name):
        return torch.tensor(p[name][lo:hi])

    out = {}
    for name, (lab, pred, mask) in p["cases"].items():
        fn = (lambda l_, p_, mask=None: ((p_ - l_) ** 2).mean()) \
            if name == "user" else name
        out[name] = losses.score(fn, rows(lab), rows(pred),
                                 None if mask is None else rows(mask), g)
    yolo = Yolo2OutputLayer(anchors=p["anchors"])
    out["yolo2"] = yolo.compute_loss(rows("volume"), rows("yolo_labels"),
                                     groups=_dist.Groups(batch=g))
    keys = sorted(out)
    total = torch.stack([out[k].float().reshape(()) for k in keys])
    g.all_reduce_(total)
    return dict(zip(keys, total.tolist()))


@case
def tp_attention(rank, world, p):
    from deeplearning4j_tpu_torch import _dist
    from deeplearning4j_tpu_torch.nn.layers.base import Ctx
    from deeplearning4j_tpu_torch.parallel.tp import layer_param_shardings
    par = _par()
    layer = par.ShardedSelfAttention(n_in=16, n_out=16, n_heads=4)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in p["params"].items()}
    mesh = cpu_mesh(dp=2, tp=2)
    x = torch.tensor(p["x"])
    y, _ = layer.apply(params, {}, x,
                       Ctx(groups=_dist.Groups(tp=mesh.group("tp"))))
    (g,) = torch.autograd.grad((y ** 2).sum(), [params["Wq"]])
    g = mesh.group("tp").all_reduce_(g.clone())
    return {"y": y.detach().numpy(), "gWq": g.numpy(),
            "specs": pg(layer_param_shardings(mesh, layer, params))}


@case
def tp_row_embedding(rank, world, p):
    from deeplearning4j_tpu_torch import _dist
    from deeplearning4j_tpu_torch.nn.layers.base import Ctx
    from deeplearning4j_tpu_torch.parallel.tp import layer_param_shardings
    par = _par()
    layer = par.RowShardedEmbeddingSequence(n_in=32, n_out=12)
    params = {k: torch.tensor(v) for k, v in p["params"].items()}
    mesh = cpu_mesh(tp=world)
    y, _ = layer.apply(params, {}, torch.tensor(p["ids"]),
                       Ctx(groups=_dist.Groups(tp=mesh.group("tp"))))
    return {"y": y.numpy(),
            "specs": pg(layer_param_shardings(mesh, layer, params))}


@case
def tp_conv_pair(rank, world, p):
    from deeplearning4j_tpu_torch import _dist
    from deeplearning4j_tpu_torch.nn.layers.base import Ctx
    from deeplearning4j_tpu_torch.parallel.tp import layer_param_shardings
    par = _par()
    c1 = par.ChannelShardedConvolution(n_out=8, kernel_size=(3, 3),
                                       convolution_mode="same",
                                       activation="relu")
    c2 = par.InputChannelShardedConvolution(n_out=4, kernel_size=(3, 3),
                                            convolution_mode="same",
                                            activation="identity")
    p1 = {k: torch.tensor(v) for k, v in p["p1"].items()}
    p2 = {k: torch.tensor(v) for k, v in p["p2"].items()}
    mesh = cpu_mesh(dp=2, tp=2)
    ctx = Ctx(groups=_dist.Groups(tp=mesh.group("tp")))
    h, _ = c1.apply(p1, {}, torch.tensor(p["x"]), ctx)
    y, _ = c2.apply(p2, {}, h, ctx)
    bad = par.InputChannelShardedConvolution(n_out=4, kernel_size=(3, 3),
                                             groups=2)
    pb = {"W": torch.zeros((3, 3, 2, 4)), "b": torch.zeros(4)}
    return {"y": y.numpy(),
            "specs": (pg(layer_param_shardings(mesh, c1, p1)),
                      pg(layer_param_shardings(mesh, c2, p2))),
            "grouped": _raises(lambda: layer_param_shardings(mesh, bad, pb),
                               ValueError, "group")}


@case
def uneven_heads(rank, world, p):
    from deeplearning4j_tpu_torch.parallel.tp import layer_param_shardings
    par = _par()
    layer = par.ShardedSelfAttention(n_in=12, n_out=12, n_heads=3)
    params = {k: torch.zeros((12, 12)) for k in ("Wq", "Wk", "Wv", "Wo")}
    mesh = cpu_mesh([0, 1], tp=2)
    if not mesh.member:
        return None
    return _raises(lambda: layer_param_shardings(mesh, layer, params),
                   ValueError, "divisible by tp")


@case
def pads_to_batch_axes(rank, world, p):
    par = _par()
    net = port_net("tp_mlp", p, "ColumnParallelDense", "RowParallelDense")
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=2, tp=2))
    return pw.fit([ds(p["x"], p["y"])])


@case
def pi_does_not_mutate(rank, world, p):
    par = _par()
    net = port_net("tp_mlp", p, "ColumnParallelDense", "RowParallelDense")
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=2, tp=2))
    pw.fit([ds(p["x"], p["y"])])
    before = np_tree(net.params)
    pi = par.ParallelInference(net, mesh=cpu_mesh(dp=world))
    out = pi.output(p["x"][:5]).numpy()
    same = all(np.array_equal(a, b) for a, b in zip(
        _leaves(before), _leaves(np_tree(net.params))))
    loss = pw.fit([ds(p["x"], p["y"])])
    out2 = pi.refresh().output(p["x"][:5]).numpy()
    return {"out": out, "untouched": same, "loss": loss, "out2": out2,
            "want2": net.output(torch.tensor(p["x"][:5])).detach().numpy()}


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    return [t]


@case
def pw_cg(rank, world, p):
    par = _par()
    net = port_net("small_cg", p)
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=world))
    losses = [pw.fit([ds(p["x"], p["y"])]) for _ in range(p["steps"])]
    return {"params": np_tree(net.params), "states": np_tree(net.states),
            "losses": losses}


@case
def pw_cg_remat(rank, world, p):
    par = _par()
    out = []
    for remat in (None, 3):
        net = port_net("small_cg", p)
        net.remat_segments = remat
        pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=world))
        out.append(pw.fit([ds(p["x"], p["y"])]))
    return out


@case
def pi_cg(rank, world, p):
    par = _par()
    net = port_net("small_cg", p)
    pi = par.ParallelInference(net, mesh=cpu_mesh(dp=world))
    return pi.output(p["x"]).numpy()


@case
def pw_mds_cg(rank, world, p):
    from deeplearning4j_tpu_torch.data import MultiDataSet
    par = _par()
    net = port_net("mds_cg", p)
    pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=world))
    mds = MultiDataSet([p["xa"], p["xb"]], [p["y1"], p["y2"]])
    for _ in range(3):
        pw.fit([mds])
    served = port_net("mds_cg", dict(params=p["trained"],
                                     states=p["states"]))
    pi = par.ParallelInference(served, mesh=cpu_mesh(dp=world))
    got = pi.output([p["xa"][:22], p["xb"][:22]])
    return {"params": np_tree(net.params),
            "outs": [g.numpy() for g in got]}


@case
def pw_fit_scanned(rank, world, p):
    par = _par()
    batches = [ds(x, y) for x, y in zip(p["xs"], p["ys"])]
    a = port_net("scan_mlp", p)
    pw_a = par.ParallelWrapper(a, mesh=cpu_mesh(dp=world))
    for _ in range(3):
        pw_a.fit(batches)
    b = port_net("scan_mlp", p)
    pw_b = par.ParallelWrapper(b, mesh=cpu_mesh(dp=world))
    last = pw_b.fit_scanned(batches, epochs=3)
    ragged = batches + [ds(np.zeros((8, 6), np.float32),
                           np.zeros((8, 3), np.float32))]
    odd = [ds(np.zeros((6, 6), np.float32), np.zeros((6, 3), np.float32))]
    return {"fit": np_tree(a.params), "scanned": np_tree(b.params),
            "last": last,
            "ragged": _raises(lambda: pw_b.fit_scanned(ragged), ValueError,
                              "equally-shaped"),
            "divide": _raises(lambda: pw_b.fit_scanned(odd), ValueError,
                              "divide"),
            "zero": pw_b.fit_scanned(batches, epochs=0)}


# ---------------------------------------------------- parameter averaging

@case
def pa_freq1_sgd(rank, world, p):
    par = _par()
    x, y = p["x"], p["y"]
    k = len(x) // world
    net_pa = port_net("pa_mlp", p)
    pa = par.ParameterAveragingTrainer(net_pa, mesh=cpu_mesh(dp=world),
                                       averaging_frequency=1)
    pa.fit(_list([ds(x[i * k:(i + 1) * k], y[i * k:(i + 1) * k])
                  for i in range(world)]), epochs=1)
    net_pw = port_net("pa_mlp", p)
    par.ParallelWrapper(net_pw, mesh=cpu_mesh(dp=world)).fit([ds(x, y)])
    return {"pa": np_tree(net_pa.params), "pw": np_tree(net_pw.params),
            "rounds": pa.rounds}


@case
def pa_adam_rounds(rank, world, p):
    par = _par()
    x, y = p["x"], p["y"]
    net = port_net("pa_adam", p)
    pa = par.ParameterAveragingTrainer(net, mesh=cpu_mesh(dp=world),
                                       averaging_frequency=2)
    it = _list([ds(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
                for i in range(len(x) // 8)])
    s0 = net.score(ds(x, y))
    pa.fit(it, epochs=1)
    first = np_tree(net.params)
    for _ in range(14):
        pa.fit(it, epochs=1)
    return {"first": first, "s0": s0, "s": net.score(ds(x, y)),
            "out": tuple(net.output(torch.tensor(x)).shape)}


@case
def pa_label_masks(rank, world, p):
    par = _par()
    x, y, m = p["x"], p["y"], p["m"]
    out = {}
    for use in (True, False):
        net = port_net("rnn_net", p)
        k = len(x) // world
        it = _list([ds(x[i * k:(i + 1) * k], y[i * k:(i + 1) * k],
                       labels_mask=m[i * k:(i + 1) * k] if use else None)
                    for i in range(world)])
        par.ParameterAveragingTrainer(net, mesh=cpu_mesh(dp=world),
                                      averaging_frequency=1).fit(it)
        out[use] = np_tree(net.params)
    return out


@case
def pa_cg(rank, world, p):
    from deeplearning4j_tpu_torch.data import MultiDataSet
    par = _par()
    net = port_net("small_cg", p)
    tr = par.ParameterAveragingTrainer(net, mesh=cpu_mesh(dp=world),
                                       averaging_frequency=1)
    loss = tr.fit([ds(p["x"], p["y"])] * world)
    mds = MultiDataSet([p["x"], p["x"]], [p["y"]])
    return {"loss": loss, "params": np_tree(net.params),
            "mds": _raises(lambda: tr.fit([mds] * 2), NotImplementedError,
                           "MultiDataSet")}


# ---------------------------------------------------------- pipelines

def _pp_loss(net, mesh, p, rng=None):
    par = _par()
    fn = par.make_mln_pipeline_loss(mesh, net, microbatch=p["mb"])
    return fn, fn(net.params, p["x_mb"], p["y_mb"], rng)


@case
def generic_pipeline(rank, world, p):
    par = _par()
    net = port_net("pp_mlp", p)
    out = {"stages": par.partition_layers(net, 2)}
    mesh2 = cpu_mesh([0, 1], pp=2)
    if mesh2.member:
        _, loss = _pp_loss(net, mesh2, p)
        out["pp2"] = float(loss)
        params = {k: {n: t.detach().clone().requires_grad_()
                      for n, t in v.items()} for k, v in net.params.items()}
        opt = _adam(1e-2)
        state = opt.init(params)
        step = par.make_mln_pipeline_train_step(mesh2, net, opt,
                                                microbatch=p["mb"])
        losses = []
        for _ in range(10):
            params, state, loss = step(params, state, p["x_mb"], p["y_mb"])
            losses.append(float(loss))
        out["losses"] = losses
    mesh4 = cpu_mesh(pp=2, dp=2)
    _, loss4 = _pp_loss(net, mesh4, p)
    out["pp2dp2"] = float(loss4)
    sh = par.shard_params_pp(mesh4, net.params, min_size=64)
    out["pp_spec"] = pg(sh)["layer_0"]["W"]
    return out


@case
def generic_pipeline_bn(rank, world, p):
    par = _par()
    net = port_net("pp_bn_net", p)
    mesh = cpu_mesh([0, 1], pp=2)
    if not mesh.member:
        return None
    fn = par.make_mln_pipeline_loss(mesh, net, microbatch=p["mb"])
    loss, states = fn(net.params, net.states, p["x_mb"], p["y_mb"])
    opt = _adam(1e-2)
    params = {k: {n: t.detach().clone().requires_grad_()
                  for n, t in v.items()} for k, v in net.params.items()}
    st = {k: {n: t.clone() for n, t in v.items()}
          for k, v in net.states.items()}
    state = opt.init(params)
    step = par.make_mln_pipeline_train_step(mesh, net, opt,
                                            microbatch=p["mb"])
    losses = []
    for _ in range(10):
        params, st, state, l = step(params, st, state, p["x_mb"], p["y_mb"])
        losses.append(float(l))
    return {"loss": float(loss), "states": np_tree(states),
            "losses": losses, "mean_after": np_tree(st["layer_1"]["mean"])}


@case
def cg_pipeline(rank, world, p):
    par = _par()
    cg = port_net("linear_cg", p)
    mesh = cpu_mesh([0, 1], pp=2)
    out = {}
    if mesh.member:
        opt = _adam(1e-2)
        step, view = par.make_cg_pipeline_train_step(mesh, cg, opt,
                                                     microbatch=p["mb"])
        params = {k: {n: t.detach().clone().requires_grad_()
                      for n, t in v.items()} for k, v in view.params.items()}
        state = opt.init(params)
        losses = []
        for _ in range(10):
            params, state, loss = step(params, state, p["x_mb"], p["y_mb"])
            losses.append(float(loss))
        out = {"losses": losses, "keys": sorted(view.to_graph(params))}
    from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                             MergeVertex,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    from deeplearning4j_tpu_torch.train import Adam
    gb = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-3))
          .graph_builder().add_inputs("in")
          .add_layer("a", DenseLayer(n_in=16, n_out=8, activation="relu"),
                     "in")
          .add_layer("b", DenseLayer(n_in=16, n_out=8, activation="relu"),
                     "in")
          .add_vertex("m", MergeVertex(), "a", "b")
          .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                        loss="mcxent"), "m")
          .set_outputs("out"))
    cg2 = ComputationGraph(gb.build()).init([(16,)], device="cpu")
    mesh4 = cpu_mesh(pp=2, dp=2)
    out["branchy"] = _raises(
        lambda: par.make_cg_pipeline_train_step(mesh4, cg2, _adam(1e-2), 4),
        ValueError, "chain")
    return out


@case
def generic_pipeline_dropout(rank, world, p):
    par = _par()
    mesh = cpu_mesh([0, 1], pp=2)
    if not mesh.member:
        return None
    net = port_net("dropout_mlp", p, 0.5)
    fn = par.make_mln_pipeline_loss(mesh, net, microbatch=8)
    x, y = p["x"], p["y"]
    base = float(fn(net.params, x, y))
    la, lb = float(fn(net.params, x, y, 1)), float(fn(net.params, x, y, 2))
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    leaves = tree_leaves(net.params)
    gs = torch.autograd.grad(fn(net.params, x, y, 1), leaves,
                             allow_unused=True)
    g_max = max(float(g.abs().max()) for g in gs if g is not None)
    net0 = port_net("dropout_mlp", p, 0.0)
    fn0 = par.make_mln_pipeline_loss(mesh, net0, microbatch=8)
    return {"base": base, "la": la, "lb": lb, "gmax": g_max,
            "d0": (float(fn0(net0.params, x, y)),
                   float(fn0(net0.params, x, y, 3)))}


@case
def pipeline_lm(rank, world, p):
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    par = _par()
    cfg = tfm.TransformerConfig(**p["cfg"], dtype=torch.float32,
                                remat=False)
    params = tfm.params_from_numpy(p["params"], cfg, device="cpu")
    out = {}
    for axes in p["meshes"]:
        mesh = cpu_mesh(**axes)
        fn = par.make_pipeline_loss(mesh, cfg)
        out[str(axes)] = float(fn(par.place_params_for_pipeline(
            mesh, params), p["ids_mb"], p["tgt_mb"]))
    return out


# --------------------------------------------------- transformer over a mesh

def _lm(p, **over):
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(**dict(p["cfg"], **over),
                                dtype=torch.float32, remat=False)
    return tfm, cfg, tfm.params_from_numpy(p["params"], cfg, device="cpu")


@case
def lm_mesh_loss(rank, world, p):
    """One step of ``make_train_step(cfg, SGD(lr=0), mesh)``: its loss is
    the sharded loss of the global batch; the grads are returned too."""
    out = {}
    for axes in p["meshes"]:
        tfm, cfg, params = _lm(p)
        opt = torch.optim.SGD(tfm.param_leaves(params), lr=0.0)
        step = tfm.make_train_step(cfg, opt, cpu_mesh(**axes))
        loss = step(params, p["ids"], p["tgt"])
        out[str(axes)] = {"loss": float(loss), "grads": np_tree(
            {k: v.grad for k, v in params["blocks"].items()})}
    return out


@case
def ring_train_step(rank, world, p):
    tfm, cfg, params = _lm(p, use_ring_attention=True, fused_loss=False)
    mesh = cpu_mesh(dp=2, sp=2)
    opt = torch.optim.Adam(tfm.param_leaves(params), lr=1e-2, eps=1e-8)
    step = tfm.make_ring_train_step(cfg, opt, mesh)
    losses = [float(step(params, p["ids"], p["tgt"])) for _ in range(2)]
    cfg_mono = dataclasses.replace(cfg, use_ring_attention=False)
    guards = {
        "flag": _raises(lambda: tfm.make_ring_train_step(cfg_mono, opt,
                                                         mesh), ValueError),
        "moe": _raises(lambda: tfm.make_ring_train_step(
            dataclasses.replace(cfg, n_experts=4), opt, mesh),
            NotImplementedError),
        "long": _raises(lambda: step(params, np.zeros((4, 64), np.int64),
                                     np.zeros((4, 64), np.int64)),
                        ValueError, "exceeds")}
    return {"losses": losses, "params": np_tree(params), "guards": guards}


@case
def moe_dp(rank, world, p):
    """The MoE LM's sharded loss and grads over dp (capacity and aux over
    the global batch) and over dp × ep, and a tp split of its experts."""
    out = {}
    for axes in p["meshes"]:
        tfm, cfg, params = _lm(p)
        opt = torch.optim.SGD(tfm.param_leaves(params), lr=0.0)
        step = tfm.make_train_step(cfg, opt, cpu_mesh(**axes))
        loss = step(params, p["ids"], p["tgt"])
        out[str(axes)] = {"loss": float(loss), "grads": np_tree(
            {k: v.grad for k, v in params["blocks"].items()})}
    return out


@case
def ring(rank, world, p):
    """ring_attention on a (dp, sp) mesh: outputs, and q/k/v grads of
    sum(out²)."""
    par = _par()
    out = {}
    for name, axes, causal, flash in p["runs"]:
        mesh = cpu_mesh(**axes)
        q, k, v = (torch.tensor(a, requires_grad=True)
                   for a in (p[name + "_q"], p[name + "_k"], p[name + "_v"]))
        y = par.ring_attention(mesh, q, k, v, causal=causal,
                               use_flash=flash)
        res = {"out": y.detach().numpy()}
        if p.get(name + "_grads"):
            res["grads"] = [g.numpy() for g in
                            torch.autograd.grad((y ** 2).sum(), [q, k, v])]
        out[f"{name}/{causal}/{flash}"] = res
    return out


# ------------------------------------------------------ dry run cases

@case
def dryrun_lm(rank, world, p):
    """Cases A, B and K: the dense dp×tp LM, the MoE dp×tp×ep LM (one
    Adam step each) and the ring step over dp×sp against the monolithic
    step."""
    out = {}
    for name, axes, over in p["runs"]:
        tfm, cfg, params = _lm(dict(p, params=p["params_" + name],
                                    cfg=p["cfg_" + name]), **over)
        opt = torch.optim.Adam(tfm.param_leaves(params), lr=1e-3, eps=1e-8)
        step = tfm.make_ring_train_step(cfg, opt, cpu_mesh(**axes)) \
            if over.get("use_ring_attention") else \
            tfm.make_train_step(cfg, opt, cpu_mesh(**axes))
        out[name] = float(step(params, p["ids_" + name], p["tgt_" + name]))
    return out


@case
def dryrun_pipeline(rank, world, p):
    """Cases C and H: the pipelined LM step (pp × dp) — its loss, then a
    second step after the update; D/E: the generic MLN and CG
    pipelines."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    par = _par()
    cfg = tfm.TransformerConfig(**p["cfg"], dtype=torch.float32,
                                remat=False)
    params = tfm.params_from_numpy(p["lm_params"], cfg, device="cpu")
    mesh = cpu_mesh(pp=2, dp=2)
    opt = _adam(1e-3)
    state = opt.init(params)
    step = par.make_pipeline_train_step(mesh, cfg, opt)
    _, _, loss_c = step(par.place_params_for_pipeline(mesh, params), state,
                        p["ids_mb"], p["tgt_mb"])
    net = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
    opt2 = _adam(1e-3)
    step_d = par.make_mln_pipeline_train_step(mesh, net, opt2,
                                              microbatch=p["mb"])
    _, _, loss_d = step_d(net.params, opt2.init(net.params), p["x_mb"],
                          p["y_mb"])
    cg = port_net("linear_cg", dict(params=p["cg_params"],
                                    states=p["cg_states"]))
    opt3 = _adam(1e-3)
    step_e, view = par.make_cg_pipeline_train_step(mesh, cg, opt3,
                                                   microbatch=p["mb"])
    _, _, loss_e = step_e(view.params, opt3.init(view.params), p["x_mb"],
                          p["y_mb"])
    return {"C": float(loss_c), "D": float(loss_d), "E": float(loss_e)}


@case
def dryrun_wrapper(rank, world, p):
    """Cases D (dp×tp MLN), F (remat == plain under dp), G (fsdp ==
    monolithic) and I (checkpoint, restore, resume == uninterrupted)."""
    import os
    import tempfile
    from deeplearning4j_tpu_torch import serde
    par = _par()
    x, y = p["x"], p["y"]
    out = {}
    net_tp = port_net("dry_mlp", p, "ColumnParallelDense",
                      "RowParallelDense")
    out["D"] = par.ParallelWrapper(
        net_tp, mesh=cpu_mesh(dp=2, tp=2)).fit([ds(x, y)])
    mesh_dp = cpu_mesh([0, 1], dp=2)
    if mesh_dp.member:
        net_rm = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
        net_rm.remat_segments = 2
        net_pl = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
        out["F"] = (par.ParallelWrapper(net_rm, mesh=mesh_dp).fit([ds(x, y)]),
                    par.ParallelWrapper(net_pl, mesh=mesh_dp).fit([ds(x, y)]))
    net_fs = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
    pw_fs = par.ParallelWrapper(net_fs, mesh=cpu_mesh(fsdp=world),
                                use_fsdp=True)
    out["G"] = pw_fs.fit([ds(x, y)])
    wide = port_net("wide_mlp", dict(params=p["wide_params"],
                                     states=p["wide_states"]))
    pw_w = par.ParallelWrapper(wide, mesh=cpu_mesh(fsdp=world),
                               use_fsdp=True)
    out["G_wide"] = [pw_w.fit([ds(p["wx"], p["wy"])]) for _ in range(3)]
    out["G_specs"] = pg(pw_w.placements)
    out["G_state"] = sorted(tuple(t.shape) for t in _opt_leaves(wide))
    out["G_params"] = np_tree(wide.params)
    if mesh_dp.member:
        net_ck = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
        net_un = port_net("dry_mlp", p, "DenseLayer", "DenseLayer")
        par.ParallelWrapper(net_ck, mesh=mesh_dp).fit([ds(x, y)])
        par.ParallelWrapper(net_un, mesh=mesh_dp).fit([ds(x, y)])
        path = os.path.join(tempfile.mkdtemp(), f"mid{rank}.zip")
        serde.save_model(net_ck, path, save_updater=True)
        net_rs = serde.load_model(path, device="cpu")
        out["I"] = (par.ParallelWrapper(net_rs, mesh=mesh_dp).fit([ds(x, y)]),
                    par.ParallelWrapper(net_un, mesh=mesh_dp).fit([ds(x, y)]))
    return out


def _opt_leaves(net):
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    return [t for t in tensors(net._opt_state) if t.dim() > 0]


# ------------------------------------------------ early stopping, serving

@case
def early_stopping_parallel(rank, world, p):
    import deeplearning4j_tpu_torch.nn.early_stopping as es
    par = _par()
    out = {}
    for name in ("es_mlp", "es_cg"):
        net = port_net(name, p[name])
        pw = par.ParallelWrapper(net, mesh=cpu_mesh(dp=world))
        from deeplearning4j_tpu_torch.data import ListDataSetIterator

        def it_():
            # the file's iterators: the four batches merged (batch_size
            # None), one step an epoch
            return ListDataSetIterator(
                [ds(a, b) for a, b in zip(p["xs"], p["ys"])],
                batch_size=None)
        it = it_()
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(p["epochs"][name])],
            score_calculator=es.DataSetLossCalculator(it_()))
        r = es.EarlyStoppingParallelTrainer(cfg, pw, it).fit()
        out[name] = {"epochs": r.total_epochs, "best": r.best_model_score,
                     "scores": [r.score_vs_epoch[k]
                                for k in sorted(r.score_vs_epoch)],
                     "params": np_tree(net.params)}
    out["type"] = _raises(lambda: es.EarlyStoppingParallelTrainer(
        cfg, object(), it), TypeError)
    return out


@case
def pi_mesh(rank, world, p):
    """ParallelInference over a dp mesh (batches padded to dp, outputs
    gathered on every rank), over dp × tp with tp layers, and its
    refusals."""
    par = _par()
    out = {}
    net = port_net("tp_mlp", p, "ColumnParallelDense", "RowParallelDense")
    for axes in ({"dp": world}, {"dp": 2, "tp": 2}):
        pi = par.ParallelInference(net, mesh=cpu_mesh(**axes))
        out[str(axes)] = pi.output(p["x"]).numpy()
        if "tp" not in axes:
            parts = [pi.submit(p["x"][:3]), pi.submit(p["x"][3:7])]
            flushed = pi.flush()
            out["futures"] = [f.result().numpy() for f in parts]
            out["flushed"] = [f.numpy() for f in flushed]
    out["timer"] = _raises(lambda: par.ParallelInference(
        net, mesh=cpu_mesh(dp=world), max_wait_ms=5), ValueError)
    return out


# ------------------------------------------------------ checkpointing

@case
def orbax_fsdp(rank, world, p):
    """The per-rank checkpoint under fsdp (the updater state split over
    the ranks): two steps, an async save while two more steps run, then
    a fresh net resumed from the save takes the same two steps."""
    import os
    from deeplearning4j_tpu_torch.serde.orbax_ckpt import (
        CheckpointingTrainerMixin, OrbaxCheckpointer)
    par = _par()
    batch = ds(p["wx"], p["wy"])

    def fresh():
        net = port_net("wide_mlp", dict(params=p["wide_params"],
                                         states=p["wide_states"]))
        return net, par.ParallelWrapper(net, mesh=cpu_mesh(fsdp=world),
                                        use_fsdp=True)

    net, pw = fresh()
    first = [pw.fit([batch]) for _ in range(2)]
    ck = OrbaxCheckpointer(p["dir"], max_to_keep=2, async_=True)
    assert ck.save(net._step_count, net.params, net.states, net._opt_state,
                   metadata={"step_count": net._step_count,
                             "epoch_count": net.epoch_count})
    state_then = np_tree(net._opt_state)
    straight = [pw.fit([batch]) for _ in range(2)]
    ck.wait()
    net2, pw2 = fresh()
    pw2.fit([batch])                 # builds the (split) updater state
    step = CheckpointingTrainerMixin.resume(net2, ck)
    restored = np_tree(net2._opt_state)
    resumed = [pw2.fit([batch]) for _ in range(2)]
    ck.close()
    files = sorted(os.listdir(os.path.join(p["dir"], str(step))))
    return dict(first=first, straight=straight, resumed=resumed, step=step,
                state_then=state_then, restored=restored, files=files,
                params=np_tree(net.params), params2=np_tree(net2.params))

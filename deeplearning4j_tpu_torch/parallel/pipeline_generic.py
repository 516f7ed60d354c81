"""Generic pipeline parallelism — port of
``deeplearning4j_tpu/parallel/pipeline_generic.py``: ANY sequential layer
stack (MultiLayerNetwork, or a linear-chain ComputationGraph through
:class:`_SequentialView`) split into GPipe stages over the mesh's 'pp'
axis.

Stages are contiguous layer runs balanced by parameter count
(:func:`partition_layers`). Every rank runs its own stage (SPMD; its
place on the pp axis) in a fill-drain loop over M microbatches: at each
tick it applies its stage to its buffer and hands the result to the
next stage (``_dist.shift``, whose backward hands the cotangents back),
so one autograd program serves forward and backward, as ``jax.grad``
through the reference's ``ppermute`` loop does. Boundary activations are
flattened and zero-padded to one width, so every hop moves one shape.

Semantics are the reference's (GPipe): BatchNormalization's batch
statistics are per MICROBATCH; each stage updates its own layers' states
on the ticks that carry a real microbatch, and the states are
reassembled after the drain (each layer's from its owning stage, averaged
over dp). With ``rng`` (an int) dropout and weight noise draw per
microbatch and layer, decorrelated over dp; ``rng=None`` draws none, and
a net without dropout or weight noise ignores it. The loss is the mean
over microbatches of the last stage's loss, averaged over dp.

At rest every rank holds the whole params (:func:`shard_params_pp`
records the reference's 1/pp layout as placements); a stage reads its own
layers, so a param's gradient is nonzero on its owning stage only, and
the train step sums the gradients over pp and dp before the update.
"""

from __future__ import annotations

import math
from typing import List

import torch

from .. import _dist
from ..nn._compiled import tensors
from ..nn.layers.base import Ctx
from ..nn.layers.core import (LossLayer, OutputLayer, dropout_apply,
                              keep_mask)
from ..nn.layers.wrappers import unwrap
from ..nn.multi_layer_network import _unflatten
from ..nn.weightnoise import maybe_apply_weight_noise
from ..train.updaters import apply_updates, tree_leaves
from .mesh import Sharding, tree_map


def partition_layers(net, n_stages: int) -> List[List[int]]:
    """Contiguous stages balanced by parameter count (the final loss/output
    layer rides with the last stage). Greedy: close a stage once it holds
    its fair share of the remaining parameters."""
    sizes = [sum(t.numel() for t in tensors(net.params[f"layer_{i}"]))
             for i in range(len(net.layers))]
    n = len(sizes)
    if n_stages > n:
        raise ValueError(f"{n_stages} stages > {n} layers")
    stages, start, remaining = [], 0, sum(sizes)
    for s in range(n_stages):
        stages_left = n_stages - s
        target = remaining / stages_left
        end, acc = start, 0
        max_end = n - (stages_left - 1)     # >= 1 layer a remaining stage
        while end < max_end and (acc < target or end == start):
            acc += sizes[end]
            end += 1
        stages.append(list(range(start, end)))
        remaining -= acc
        start = end
    return stages


def _is_head(net, i):
    return i == len(net.layers) - 1 and isinstance(
        unwrap(net.layers[i]), (OutputLayer, LossLayer))


def _run(net, params, states, h, idx_list, gen_of=None):
    """Apply layers ``idx_list`` (stopping before the output head) in
    train mode → (h, new states of those layers)."""
    new = {}
    for i in idx_list:
        layer = net.layers[i]
        if _is_head(net, i):
            break
        key = f"layer_{i}"
        if i in net._preprocessors:
            h = net._preprocessors[i](h)
        gen = None if gen_of is None else gen_of(i)
        p_i = params[key]
        if gen is not None:
            if getattr(layer, "dropout", 0.0) > 0.0:
                keep = 1.0 - layer.dropout
                h = dropout_apply(h, keep_mask(h.shape, keep, gen, h.device),
                                  keep)
            p_i = maybe_apply_weight_noise(layer, p_i, gen, True)
        h, new[key] = layer.apply(p_i, states[key], h,
                                  Ctx(train=True, rng=gen))
    return h, new


def _boundary_shapes(net, stages, batch: int):
    """Per-stage input shapes (with the batch dim), from one no-grad pass
    over zeros."""
    dev = tensors(net.params)[0].device
    x = torch.zeros((batch,) + tuple(net._init_input_shape), device=dev)
    shapes = [tuple(x.shape)]
    with torch.no_grad():
        for idx_list in stages:
            x, _ = _run(net, net.params, net.states, x, idx_list)
            shapes.append(tuple(x.shape))
    return shapes


def shard_params_pp(mesh, params, min_size: int = 2 ** 12):
    """The reference's ZeRO-3-over-'pp' at-rest layout: each large leaf's
    first axis that divides is split over 'pp' (placements: a tree of
    ``Sharding``). The port's ranks hold the params whole; the pipelined
    step reads the same tree."""
    n = mesh.shape["pp"]

    def sh(leaf):
        if leaf.numel() < min_size:
            return Sharding(mesh, ())
        for d, dim in enumerate(leaf.shape):
            if dim % n == 0:
                spec = [None] * leaf.dim()
                spec[d] = "pp"
                return Sharding(mesh, tuple(spec))
        return Sharding(mesh, ())

    return tree_map(sh, params)


def _mb_gen(rng, mb, layer, dp_index, device):
    """The generator of one (microbatch, layer) draw."""
    seed = ((int(rng) * 1_000_003 + mb) * 1_009 + layer) * 31 + dp_index
    return torch.Generator(device=device).manual_seed(seed % (2 ** 62))


def make_mln_pipeline_loss(mesh, net, microbatch: int):
    """Pipelined loss of a sequential net over the mesh ('pp' required,
    'dp' optional). Stateless nets: ``loss = fn(params, x_mb, y_mb,
    rng=None)``. Stateful nets (BatchNorm): ``(loss, new_states) =
    fn(params, states, x_mb, y_mb, rng=None)``. ``x_mb``/``y_mb`` are the
    global (M, microbatch, ...) arrays on every rank; under dp each rank
    takes its rows of every microbatch. Collective: every rank of the mesh
    calls it."""
    pp = mesh.group("pp")
    dp = mesh.group("dp")
    n_stages, stage = pp.size, pp.index
    stateful = any(bool(s) for s in net.states.values())
    stages = partition_layers(net, n_stages)
    stage_of = {i: s for s, idx in enumerate(stages) for i in idx}
    out_layer = unwrap(net.layers[-1])
    if not isinstance(out_layer, (OutputLayer, LossLayer)):
        raise ValueError("last layer must be an OutputLayer/LossLayer")
    last_i = len(net.layers) - 1
    shapes = _boundary_shapes(net, stages, microbatch)
    flat_sizes = [math.prod(s[1:]) for s in shapes]
    fmax = max(flat_sizes)
    needs_rng = any(getattr(l, "dropout", 0.0) > 0.0
                    or getattr(l, "weight_noise", None) is not None
                    for l in net.layers)
    mine = stages[stage]
    loss_stage = stage == n_stages - 1
    reduce_all = mesh.group("pp", "dp")

    def stage_fn(params, states, flat, tgt, gen_of):
        h = flat[:, :flat_sizes[stage]].reshape(
            (flat.shape[0],) + shapes[stage][1:])
        h, new = _run(net, params, states, h, mine, gen_of)
        out = h.reshape(h.shape[0], -1)
        if out.shape[1] < fmax:
            out = torch.nn.functional.pad(out, (0, fmax - out.shape[1]))
        if not loss_stage:
            return out, None, new
        hl = h
        if last_i in net._preprocessors:
            hl = net._preprocessors[last_i](hl)
        key = f"layer_{last_i}"
        if isinstance(out_layer, OutputLayer):
            mb_loss = out_layer.compute_loss(params[key], hl, tgt)
        else:
            mb_loss = out_layer.compute_loss(hl, tgt)
        return out, mb_loss.float(), new

    def loss_with_states(params, states, x_mb, y_mb, rng=None):
        if not needs_rng:
            rng = None
        x_mb, y_mb = torch.as_tensor(x_mb), torch.as_tensor(y_mb)
        dev = tensors(params)[0].device
        lo, hi = dp.slice_of(x_mb.shape[1])
        x_mb, y_mb = x_mb[:, lo:hi].to(dev), y_mb[:, lo:hi].to(dev)
        n_mb, mb_local = x_mb.shape[0], x_mb.shape[1]
        buf = torch.zeros((mb_local, fmax), dtype=torch.float32, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        cur = dict(states)
        anchor = tensors(params)[0]
        for tick in range(n_mb + n_stages - 1):
            # the microbatch this stage works on at this tick keys its
            # dropout and weight-noise draws
            my_mb = min(max(tick - stage, 0), n_mb - 1)
            gen_of = None if rng is None else (
                lambda i, m=my_mb: _mb_gen(rng, m, i, dp.index, dev))
            if stage == 0 and tick < n_mb:
                x = x_mb[tick].reshape(mb_local, -1).float()
                if x.shape[1] < fmax:
                    x = torch.nn.functional.pad(x, (0, fmax - x.shape[1]))
            else:
                x = buf
            out_idx = tick - (n_stages - 1)
            tgt = y_mb[min(max(out_idx, 0), n_mb - 1)]
            y, mb_loss, new = stage_fn(params, cur, x, tgt, gen_of)
            # only ticks that carry a real microbatch advance the stats
            if stateful and 0 <= tick - stage < n_mb:
                cur.update(new)
            if loss_stage and 0 <= out_idx < n_mb:
                total = total + mb_loss
            buf = _hop(y, buf, pp, anchor)
        total = _dist.tie(total, buf)
        loss = _dist.reduce_from((total / n_mb / dp.size).reshape(1),
                                 reduce_all).reshape(())
        if not stateful:
            return loss, states
        with torch.no_grad():
            merged = {}
            for i in range(len(net.layers)):
                key = f"layer_{i}"
                own = float(stage == stage_of[i])

                def pick(leaf, own=own):
                    v = pp.all_reduce_(leaf.float() * own)
                    return (dp.all_reduce_(v) / dp.size).to(leaf.dtype)
                merged[key] = tree_map(pick, cur[key])
        return loss, merged

    if stateful:
        return loss_with_states

    def loss(params, x_mb, y_mb, rng=None):
        return loss_with_states(params, net.states, x_mb, y_mb, rng)[0]

    return loss


def _hop(y, buf, pp, anchor):
    """Hand ``y`` to the next stage. Every rank must run every hop's
    backward, in the hops' order, or the ranks' sends and receives stop
    pairing up: ``y`` is tied to the previous hop's output and to a
    param (``anchor``), so that the hop lies on the path from the loss to
    the params on every rank, whatever its stage reads."""
    if torch.is_grad_enabled():
        y = _dist.tie(y, buf, anchor)
    return _dist.shift(y, pp)


def _sum_grads(params, loss, group):
    """Gradients of ``loss`` wrt every leaf of ``params``, summed over
    ``group`` (one all-reduce a dtype); zeros where a leaf is unused."""
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return _dist.sum_([torch.zeros_like(p) if g is None else g
                       for p, g in zip(leaves, gs)], group)


def make_mln_pipeline_train_step(mesh, net, optimizer, microbatch: int):
    """Pipelined train step of any sequential net, the port's updaters
    (``train.updaters`` transformations: ``opt_state =
    optimizer.init(params)``). Stateless: ``(params, opt_state, x_mb,
    y_mb, rng=None) → (params, opt_state, loss)``; stateful (BatchNorm):
    ``(params, states, opt_state, x_mb, y_mb, rng=None) → (params,
    states, opt_state, loss)``. Params and state update in place."""
    loss_fn = make_mln_pipeline_loss(mesh, net, microbatch)
    stateful = any(bool(s) for s in net.states.values())
    group = mesh.group("pp", "dp")

    def update(params, opt_state, loss):
        gs = _sum_grads(params, loss, group)
        with torch.no_grad():
            grads = _unflatten(params, iter(gs))
            updates, opt_state = optimizer.update(grads, opt_state, params)
            apply_updates(tree_leaves(params), tree_leaves(updates))
        return opt_state

    if stateful:
        def step_s(params, states, opt_state, x_mb, y_mb, rng=None):
            loss, new_states = loss_fn(params, states, x_mb, y_mb, rng)
            opt_state = update(params, opt_state, loss)
            return params, new_states, opt_state, loss.detach()
        return step_s

    def step(params, opt_state, x_mb, y_mb, rng=None):
        loss = loss_fn(params, x_mb, y_mb, rng)
        opt_state = update(params, opt_state, loss)
        return params, opt_state, loss.detach()

    return step


class _SequentialView:
    """MLN-shaped facade over a linear-chain ComputationGraph, so the
    generic pipeline applies unchanged. Params/states are re-keyed
    node-name → 'layer_i'; ``to_graph``/``from_graph`` convert."""

    def __init__(self, cg):
        from ..nn.layers.base import Layer as _Layer
        order = [n for n in cg.conf.topo_order if n not in cg.conf.inputs]
        for k, name in enumerate(order):
            node = cg.conf.nodes[name]
            if not isinstance(node.op, _Layer):
                raise ValueError(
                    f"CG pipeline needs a pure layer chain; '{name}' is a "
                    f"{type(node.op).__name__} vertex")
            expect = cg.conf.inputs[0] if k == 0 else order[k - 1]
            if list(node.inputs) != [expect]:
                raise ValueError(
                    f"CG pipeline needs a linear chain; '{name}' consumes "
                    f"{list(node.inputs)} (expected ['{expect}'])")
        self.names = order
        self.layers = [cg.conf.nodes[n].op for n in order]
        self.params = {f"layer_{i}": cg.params[n]
                       for i, n in enumerate(order)}
        self.states = {f"layer_{i}": cg.states[n]
                       for i, n in enumerate(order)}
        self._preprocessors = {i: cg._preprocessors[n]
                               for i, n in enumerate(order)
                               if n in cg._preprocessors}
        self._init_input_shape = tuple(cg._init_shapes[0])

    def to_graph(self, params):
        return {n: params[f"layer_{i}"] for i, n in enumerate(self.names)}

    def from_graph(self, params):
        return {f"layer_{i}": params[n] for i, n in enumerate(self.names)}


def make_cg_pipeline_train_step(mesh, cg, optimizer, microbatch: int):
    """Pipeline a linear-chain ComputationGraph: returns (step, view)
    where ``view.params``/``view.states`` are the 'layer_i'-keyed tree
    (``view.to_graph`` maps results back onto the graph)."""
    view = _SequentialView(cg)
    return make_mln_pipeline_train_step(mesh, view, optimizer,
                                        microbatch), view


def microbatches(x, y, microbatch: int):
    """Host-side reshape: (B, ...) → (M, mb, ...); B must divide evenly."""
    import numpy as np
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] % microbatch:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatch {microbatch}")
    m = x.shape[0] // microbatch
    return (x.reshape((m, microbatch) + x.shape[1:]),
            y.reshape((m, microbatch) + y.shape[1:]))

"""Pipeline parallelism for the transformer LM — port of
``deeplearning4j_tpu/parallel/pipeline.py``: GPipe-style microbatched
stages over the mesh's 'pp' axis.

The stacked blocks (leading L axis) split into L/P contiguous blocks a
stage. Every rank runs its stage (SPMD; its place on the pp axis) in a
fill-drain loop over M microbatches, handing its activations to the next
stage each tick (``_dist.shift``; the backward hands the cotangents
back): stage 0 embeds, the last stage computes the LM loss, MoE aux
losses accrue on every stage's real ticks, and the loss is summed over
the stages and averaged over dp — the reference's program, with
autograd for ``jax.grad``. Blocks split over an active tp axis as in
``zoo/transformer.py``. At rest every rank holds the params whole; a
stage reads its blocks, and the train step sums the gradients over pp,
dp (and tp for split params) before the update.
"""

from __future__ import annotations

import torch

from .. import _dist
from ..zoo import transformer as tfm
from ..nn.multi_layer_network import _unflatten
from .pipeline_generic import _hop


def _stage_blocks(blocks, stage, n_stages, n_layers):
    per = n_layers // n_stages
    return {k: w[stage * per:(stage + 1) * per] for k, w in blocks.items()}


def make_pipeline_loss(mesh, cfg: tfm.TransformerConfig,
                       aux_weight: float = 1e-2):
    """Pipelined LM loss over the mesh ('pp' required; 'dp'/'tp'
    optional): ``loss = fn(params, ids (M, mb, T), targets (M, mb, T))``
    with the global arrays on every rank. ``cfg.n_layers`` must divide by
    the pp size. Collective."""
    pp = mesh.group("pp")
    n_stages, stage = pp.size, pp.index
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={n_stages}")
    dp = mesh.group("dp")
    tp = mesh.group("tp") if mesh.shape.get("tp", 1) > 1 else None
    reduce_all = mesh.group("pp", "dp")
    per = cfg.n_layers // n_stages
    import dataclasses
    cfg = dataclasses.replace(cfg, groups=_dist.Groups(tp=tp))
    stage_cfg = dataclasses.replace(cfg, n_layers=per)

    def loss(params, ids_mb, tgt_mb):
        dev = params["embed"].device
        ids_mb = torch.as_tensor(ids_mb).long()
        tgt_mb = torch.as_tensor(tgt_mb).long()
        lo, hi = dp.slice_of(ids_mb.shape[1])
        ids_mb, tgt_mb = ids_mb[:, lo:hi].to(dev), tgt_mb[:, lo:hi].to(dev)
        n_mb, mb, t = ids_mb.shape
        blocks = _stage_blocks(params["blocks"], stage, n_stages,
                               cfg.n_layers)
        buf = torch.zeros((mb, t, cfg.d_model), dtype=cfg.dtype, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for tick in range(n_mb + n_stages - 1):
            x = tfm.embed(params, cfg, ids_mb[tick]) \
                if stage == 0 and tick < n_mb else buf
            y, aux = tfm.apply_blocks(blocks, stage_cfg, x)
            if 0 <= tick - stage < n_mb:      # a real microbatch
                total = total + aux_weight * aux.float() / n_mb
            out_idx = tick - (n_stages - 1)
            if stage == n_stages - 1 and 0 <= out_idx < n_mb:
                logits = tfm.head_logits(params, cfg, y)
                logp = torch.log_softmax(logits, dim=-1)
                nll = -logp.gather(-1, tgt_mb[out_idx][..., None])[..., 0]
                total = total + nll.mean() / n_mb
            buf = _hop(y, buf, pp, params["embed"])
        total = _dist.tie(total, buf)
        return _dist.reduce_from((total / dp.size).reshape(1),
                                 reduce_all).reshape(())

    return loss


def make_pipeline_train_step(mesh, cfg: tfm.TransformerConfig, optimizer):
    """Pipelined train step with the port's updaters (``opt_state =
    optimizer.init(params)``): ``(params, opt_state, ids_mb, tgt_mb) →
    (params, opt_state, loss)``, params updated in place. The gradients
    are summed over pp and dp, and over tp for the params tp splits."""
    loss_fn = make_pipeline_loss(mesh, cfg)
    split = tfm._split_axes(cfg, mesh)
    batch = [a for a in ("pp", "dp") if a in mesh.axis_names]

    def step(params, opt_state, ids_mb, tgt_mb):
        from ..train.updaters import apply_updates, tree_leaves
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(params, ids_mb, tgt_mb)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        axes_of = {id(p): tuple(a) for p, a in tfm._by_key(params, split)}
        by = {}
        for p, g in zip(leaves, gs):
            by.setdefault(axes_of[id(p)], []).append(g)
        for axes, part in by.items():
            _dist.sum_(part, mesh.group(*batch, *axes))
        with torch.no_grad():
            gtree = _unflatten(params, iter(gs))
            updates, opt_state = optimizer.update(gtree, opt_state, params)
            apply_updates(leaves, tree_leaves(updates))
        return params, opt_state, loss.detach()

    return step


def place_params_for_pipeline(mesh, params):
    """The params for the pipelined step: every rank holds them whole
    (the reference places the blocks 1/pp a stage; a stage here reads its
    own blocks), so this checks the depth splits and returns them."""
    L = next(iter(params["blocks"].values())).shape[0]
    if L % mesh.shape["pp"]:
        raise ValueError(f"{L} blocks do not split over "
                         f"pp={mesh.shape['pp']}")
    return params

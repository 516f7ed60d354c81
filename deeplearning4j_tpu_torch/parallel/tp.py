"""Tensor parallelism for user-built networks — port of
``deeplearning4j_tpu/parallel/tp.py``: column/row-parallel layers and the
placement resolver for any MultiLayerNetwork / ComputationGraph.

A layer DECLARES the split of its params (``param_pspecs``, the
reference's PartitionSpecs as tuples) and :func:`network_param_shardings`
assembles the placements of a whole net. The reference lets GSPMD insert
the collectives; here each layer runs its split product itself when its
``Ctx`` carries a tp group (``ctx.groups.tp``, which ``ParallelWrapper``
and ``ParallelInference`` hand down over a mesh with a tp axis), through
Megatron's maps in ``_dist``: a column-parallel layer takes the replicated
input through f (``copy_to``), multiplies by its slice of the output
columns and gathers the slices (``gather_from``); a row-parallel layer
takes its slice of the input features (``scatter_to``), multiplies by its
rows and sums the partial products (g, ``reduce_from``). Each layer's
output is replicated, so any layers compose; a split that the shapes do
not divide runs whole, as the reference keeps such a leaf replicated.
Without a tp group (one device) every layer is its plain parent.

The params stay whole on every rank; a layer reads its slice of them, so
the gradient of a split leaf is nonzero on its slice only, and
``ParallelWrapper`` assembles the whole gradient from the tp ranks'
slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import _dist
from ..nn.layers.attention import SelfAttentionLayer, multi_head_attention
from ..nn.layers.base import apply_time_mask
from ..nn.layers.conv import ConvolutionLayer
from ..nn.layers.core import (DenseLayer, EmbeddingLayer,
                              EmbeddingSequenceLayer, OutputLayer)
from .mesh import Sharding, tree_map


def _split(g, n):
    """(g, lo, hi) of an axis of ``n`` over the tp group ``g``, or None
    when there is none or ``n`` does not divide."""
    if g is None or n % g.size:
        return None
    lo, hi = g.slice_of(n)
    return g, lo, hi


def _column(x, w, b, g, lo, hi):
    """The column-parallel product: this rank's output columns, gathered
    (pre-activation)."""
    y = _dist.copy_to(x, g) @ w[:, lo:hi].to(x.dtype)
    if b is not None:
        y = y + b[lo:hi].to(x.dtype)
    return _dist.gather_from(y, g)


@dataclass
class ColumnParallelDense(DenseLayer):
    """Dense with W split over output features: (nIn, nOut/tp) a rank,
    the bias likewise."""

    def param_pspecs(self):
        return {"W": (None, "tp"), "b": ("tp",)}

    def apply(self, params, state, x, ctx):
        sp = _split(ctx.groups.tp, params["W"].shape[1])
        if sp is None:
            return super().apply(params, state, x, ctx)
        x = self._cast_in(x)
        y = _column(x, params["W"], params.get("b") if self.has_bias
                    else None, *sp)
        return self.activation_fn()(y), state


@dataclass
class RowParallelDense(DenseLayer):
    """Dense with W split over input features: each rank multiplies its
    slice of the input by its rows; the partial products are summed."""

    def param_pspecs(self):
        return {"W": ("tp", None), "b": ()}

    def apply(self, params, state, x, ctx):
        sp = _split(ctx.groups.tp, params["W"].shape[0])
        if sp is None:
            return super().apply(params, state, x, ctx)
        g, lo, hi = sp
        x = self._cast_in(x)
        y = _dist.reduce_from(
            _dist.scatter_to(x, g) @ params["W"][lo:hi].to(x.dtype), g)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class ColumnParallelOutputLayer(OutputLayer):
    """Output layer with a column-parallel projection (a large class head
    split over classes); the loss reads the gathered logits."""

    def param_pspecs(self):
        return {"W": (None, "tp"), "b": ("tp",)}

    def _tp_logits(self, params, x, tp):
        sp = _split(tp, params["W"].shape[1])
        if sp is None:
            return self.pre_activation(params, x)
        return _column(x, params["W"], params.get("b") if self.has_bias
                       else None, *sp)

    def compute_loss(self, params, x, labels, mask=None,
                     groups=_dist.NONE):
        return self.logits_loss(self._tp_logits(params, x, groups.tp),
                                labels, mask, groups.batch)

    def apply(self, params, state, x, ctx):
        x = self._cast_in(x)
        return self.activation_fn()(
            self._tp_logits(params, x, ctx.groups.tp)), state


def _row_embed(layer, params, state, x, ctx, parent):
    """The vocab-split lookup: each rank looks up the ids in its rows of
    the table (zero elsewhere), the ranks' rows are summed."""
    sp = _split(ctx.groups.tp, params["W"].shape[0])
    if sp is None:
        return parent.apply(layer, params, state, x, ctx)
    g, lo, hi = sp
    ids = x.to(torch.int64)
    if ids.dim() > 1 and ids.shape[-1] == 1 and \
            not isinstance(layer, EmbeddingSequenceLayer):
        ids = ids[..., 0]
    local = ids - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = params["W"][lo:hi][local.clamp(0, hi - lo - 1)]
    y = _dist.reduce_from(rows * inside[..., None].to(rows.dtype), g)
    if layer.has_bias:
        y = y + params["b"]
    return layer.activation_fn()(y), state


@dataclass
class RowShardedEmbedding(EmbeddingLayer):
    """Embedding table split over the VOCAB axis: (vocab/tp, nOut) a
    rank; each id lives on one rank (Megatron's VocabParallelEmbedding).
    Requires vocab % tp == 0 to split (runs whole otherwise)."""

    def param_pspecs(self):
        return {"W": ("tp", None), "b": ()}

    def apply(self, params, state, x, ctx):
        return _row_embed(self, params, state, x, ctx, EmbeddingLayer)


@dataclass
class RowShardedEmbeddingSequence(EmbeddingSequenceLayer):
    """Sequence variant of RowShardedEmbedding ((B, T) ids → (B, T,
    nOut))."""

    def param_pspecs(self):
        return {"W": ("tp", None), "b": ()}

    def apply(self, params, state, x, ctx):
        return _row_embed(self, params, state, x, ctx,
                          EmbeddingSequenceLayer)


@dataclass
class ChannelShardedConvolution(ConvolutionLayer):
    """Conv2D with the kernel split over OUTPUT channels: HWIO (kh, kw,
    cin, cout/tp) a rank, bias (cout/tp) — the column-parallel split for
    CNNs; the channel slices are gathered (NHWC: the last axis)."""

    def param_pspecs(self):
        return {"W": (None, None, None, "tp"), "b": ("tp",)}

    def apply(self, params, state, x, ctx):
        sp = _split(ctx.groups.tp, params["W"].shape[3])
        if sp is None:
            return super().apply(params, state, x, ctx)
        g, lo, hi = sp
        p = {"W": params["W"][..., lo:hi]}
        if self.has_bias:
            p["b"] = params["b"][lo:hi]
        plain = dataclasses.replace(self, activation="identity")
        y, _ = ConvolutionLayer.apply(plain, p, state, _dist.copy_to(x, g),
                                      ctx)
        return self.activation_fn()(_dist.gather_from(y, g)), state


@dataclass
class InputChannelShardedConvolution(ConvolutionLayer):
    """Conv2D split over INPUT channels: HWIO (kh, kw, cin/tp, cout) a
    rank; each rank convolves its slice of the input channels and the
    partial sums are summed (Megatron g for convs)."""

    def param_pspecs(self):
        return {"W": (None, None, "tp", None), "b": ()}

    def validate_tp(self, mesh):
        if self.groups != 1 and mesh.shape.get("tp", 1) > 1:
            raise ValueError(
                "InputChannelShardedConvolution: grouped/depthwise convs "
                "cannot row-shard input channels (each group's channels "
                "must stay together); use ChannelShardedConvolution")

    def apply(self, params, state, x, ctx):
        sp = _split(ctx.groups.tp, params["W"].shape[2])
        if sp is None or self.groups != 1:
            return super().apply(params, state, x, ctx)
        g, lo, hi = sp
        plain = dataclasses.replace(self, activation="identity",
                                    has_bias=False)
        y, _ = ConvolutionLayer.apply(
            plain, {"W": params["W"][:, :, lo:hi]}, state,
            _dist.scatter_to(x, g), ctx)
        y = _dist.reduce_from(y, g)
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        return self.activation_fn()(y), state


@dataclass
class ShardedSelfAttention(SelfAttentionLayer):
    """Multi-head attention with Megatron head sharding: Q/K/V projections
    column-parallel (heads split over 'tp'), the output projection
    row-parallel. Requires n_heads % tp == 0 (``validate_tp``: the mesh is
    not known at construction)."""

    def param_pspecs(self):
        return {"Wq": (None, "tp"), "Wk": (None, "tp"),
                "Wv": (None, "tp"), "Wo": ("tp", None)}

    def validate_tp(self, mesh):
        tp = mesh.shape.get("tp", 1)
        if tp > 1 and self.n_heads % tp:
            raise ValueError(
                f"ShardedSelfAttention needs n_heads ({self.n_heads}) "
                f"divisible by tp ({tp}); an uneven split cuts through a "
                "head")

    def apply(self, params, state, x, ctx):
        g = ctx.groups.tp
        if g is None or self.n_heads % g.size:
            return super().apply(params, state, x, ctx)
        x = self._cast_in(x)
        hd = self._head_dim(x.shape[-1])
        h = self.n_heads // g.size
        lo, hi = g.index * h * hd, (g.index + 1) * h * hd
        p = {"Wq": params["Wq"][:, lo:hi], "Wk": params["Wk"][:, lo:hi],
             "Wv": params["Wv"][:, lo:hi], "Wo": params["Wo"][lo:hi]}
        xf = _dist.copy_to(x, g)
        y = multi_head_attention(p, xf, xf, h, hd, mask=ctx.mask,
                                 is_causal=self.is_causal, impl=self.impl)
        return apply_time_mask(_dist.reduce_from(y, g), ctx.mask), state


def _resolve_spec(mesh, spec):
    """Drop axes the mesh doesn't have so specs degrade gracefully."""
    return tuple(a if (a is None or a in mesh.axis_names) else None
                 for a in spec)


def layer_param_shardings(mesh, layer, params):
    """Placements of ONE layer's params: the declared split where the
    shapes divide, replicated otherwise."""
    specs = getattr(layer, "param_pspecs", lambda: {})() or {}
    validate = getattr(layer, "validate_tp", None)
    if validate is not None:
        validate(mesh)
    rep = Sharding(mesh, ())

    def sh(key, leaf):
        spec = specs.get(key)
        if spec is None:
            return rep
        spec = _resolve_spec(mesh, spec)
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim()):
            if ax is not None and dim % mesh.shape[ax] != 0:
                return rep   # indivisible — keep replicated rather than fail
        return Sharding(mesh, spec) if any(a is not None for a in spec) \
            else rep

    return {k: (sh(k, v) if isinstance(v, torch.Tensor)
                else tree_map(lambda _: rep, v))
            for k, v in params.items()}


def network_param_shardings(mesh, net):
    """Placements for a whole MultiLayerNetwork (params keyed 'layer_i')
    or ComputationGraph (params keyed by node name)."""
    out = {}
    if hasattr(net, "layers") and isinstance(net.params, dict) \
            and all(k.startswith("layer_") for k in net.params):
        for i, layer in enumerate(net.layers):
            key = f"layer_{i}"
            out[key] = layer_param_shardings(mesh, layer, net.params[key])
        return out
    for name, p in net.params.items():
        node = net.conf.nodes.get(name)
        op = getattr(node, "op", None)
        out[name] = layer_param_shardings(mesh, op, p) if op is not None \
            else tree_map(lambda _: Sharding(mesh, ()), p)
    return out

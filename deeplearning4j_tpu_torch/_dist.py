"""The collectives a parallel step runs, and the groups it runs them over.

A leaf module (it imports torch only), so that the layers and the losses
can take groups without importing ``parallel``, which imports them.

**Groups.** :class:`Group` is a ``torch.distributed`` process group with
its ranks in mesh order; ``parallel.mesh.Mesh.group(*axes)`` makes them.

**A step's groups.** A parallel step hands its :class:`Groups` down
explicitly: the layers find them on their ``Ctx`` (``ctx.groups``), the
losses take ``group=`` (the batch group), the transformer reads
``cfg.groups``. Each forward captures what it was given, so a backward
and the recompute of a checkpointed segment, on autograd's threads, see
the same groups, and two steps in one process do not meet.

- ``batch``: the group over the mesh's batch axes (dp, fsdp). Every loss
  that reduces through ``nn.losses._mean`` then returns this rank's rows'
  sum over the count of the whole global batch (:func:`global_mean`), the
  L1/L2 terms come in a ``1/size`` share each (:func:`share`), and
  BatchNormalization takes its statistics over the global batch. The sum
  of the ranks' losses is then the reference's loss of the global batch,
  and the sum of their gradients its gradient;
- ``tp``: the tensor-parallel group the layers of ``parallel/tp.py``
  split their products over (Megatron's f and g below);
- ``sp``, ``ep`` and ``expert`` (the ep and tp axes together): the
  transformer's sequence and expert splits.

**Collectives with a gradient** (``torch.autograd.Function``s):
:func:`all_reduce_sum` (the sum, and the sum of the cotangents back),
and the four Megatron maps over the tp group: :func:`copy_to` (f:
identity forward, sum of the cotangents back), :func:`reduce_from` (g:
sum forward, identity back), :func:`gather_from` (concatenate the ranks'
slices of the last axis; back: this rank's slice) and :func:`scatter_to`
(this rank's slice; back: gather). A failed collective raises; nothing
here runs a step on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Group:
    """A process group over ``ranks`` (global ranks, in mesh order);
    ``index`` is this rank's place among them. ``pg=None`` is this rank
    alone: its collectives return their input."""

    def __init__(self, pg, ranks: Sequence[int]):
        self.pg = pg
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    def __repr__(self):
        return f"Group(ranks={self.ranks})"

    def all_reduce_(self, t):
        """In-place sum over the group (every rank's ``t`` the same
        shape)."""
        if self.pg is not None:
            dist.all_reduce(t, group=self.pg)
        return t

    def all_gather(self, t, dim=0):
        """The ranks' ``t`` concatenated along ``dim``, in group order."""
        t = t.contiguous()
        if self.pg is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t, src_index=0):
        if self.pg is not None:
            dist.broadcast(t, src=self.ranks[src_index], group=self.pg)
        return t

    def slice_of(self, n: int):
        """This rank's [lo, hi) of ``n`` split evenly over the group."""
        if n % self.size:
            raise ValueError(f"{n} does not split evenly over {self.size} "
                             "ranks")
        k = n // self.size
        return self.index * k, (self.index + 1) * k


@dataclasses.dataclass(frozen=True)
class Groups:
    """The groups of a parallel step (see the module docstring); None
    where the step does not split that way."""

    batch: Optional[Group] = None
    tp: Optional[Group] = None
    sp: Optional[Group] = None
    ep: Optional[Group] = None
    expert: Optional[Group] = None


NONE = Groups()


def global_count(n, g: Group):
    """The sum over ``g`` of a count (a 0-d tensor, no gradient)."""
    n = n.detach().float().reshape(1).clone()
    return g.all_reduce_(n)[0]


def global_mean(per_ex, m, g: Group):
    """This rank's share of the global batch's mean of ``per_ex``: its
    (masked) sum over the whole batch's (masked) count. Without a mask
    every rank holds the same number of rows (the wrapper pads to the
    batch axes), so the count needs no collective."""
    if m is None:
        return per_ex.sum() / (per_ex.shape[0] * g.size)
    count = global_count(m.sum(), g)
    return (per_ex * m).sum() / torch.clamp(count, min=1.0)


def sum_(ts, g: Group):
    """Each tensor of ``ts`` summed over ``g`` in place: one all-reduce of
    a flat buffer a dtype, the same on every rank."""
    by = {}
    for t in ts:
        by.setdefault(t.dtype, []).append(t)
    for group in by.values():
        flat = g.all_reduce_(torch.cat([t.reshape(-1) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return ts


def share(x, g: Optional[Group]):
    """This rank's share over the batch group ``g`` of a term every rank
    computes in full (an L1/L2 term), or of a mean over its own rows
    (every rank holds as many): ``x / size``, the ranks' shares summing
    to the global batch's."""
    return x if g is None else x / g.size


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g):
        ctx.g = g
        return g.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, dt):
        return ctx.g.all_reduce_(dt.clone()), None


def all_reduce_sum(t, g: Group):
    """Sum over ``g`` with a gradient: each rank's loss reads the sum,
    so the cotangent of a rank's part is the sum of all cotangents."""
    return _AllReduceSum.apply(t, g)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return ctx.g.all_reduce_(dx.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dx):
        return dx, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return g.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, dx):
        lo, hi = ctx.g.slice_of(dx.shape[ctx.dim])
        return dx.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        lo, hi = g.slice_of(x.shape[dim])
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, dx):
        return ctx.g.all_gather(dx, dim=ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    """All-gather whose inputs' cotangents are summed over the group
    (each rank's slice feeds every rank's consumer)."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return g.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, dx):
        dx = ctx.g.all_reduce_(dx.contiguous().clone())
        lo, hi = ctx.g.slice_of(dx.shape[ctx.dim])
        return dx.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None


def copy_to(x, g: Group):
    """Megatron's f: a replicated input entering a split product."""
    return _CopyTo.apply(x, g)


def reduce_from(x, g: Group):
    """Megatron's g: the ranks' partial products summed."""
    return _ReduceFrom.apply(x, g)


def gather_from(x, g: Group, dim: int = -1):
    """The ranks' slices concatenated along ``dim``; the consumer is
    replicated, so the cotangent of a slice is its part of the
    consumer's."""
    return _GatherFrom.apply(x, g, dim % x.dim())


def scatter_to(x, g: Group, dim: int = -1):
    """This rank's slice of a replicated input along ``dim``."""
    return _ScatterTo.apply(x, g, dim % x.dim())


def gather_sum(x, g: Group, dim: int):
    """The ranks' slices concatenated along ``dim`` for consumers that
    differ by rank (sequence-parallel keys and values): a slice's
    cotangent is the sum of every rank's."""
    return _GatherSum.apply(x, g, dim % x.dim())


class _Shift(torch.autograd.Function):
    """The ring's hop: send to the next rank of the group, receive from
    the previous; the cotangents travel back the other way. Several
    tensors hop together, in one node, so that every rank runs the hops'
    backwards in the same order (the sends and receives pair up rank by
    rank, in order)."""

    @staticmethod
    def forward(ctx, g, step, *xs):
        ctx.g, ctx.step = g, step
        return _p2p(xs, g, step)

    @staticmethod
    def backward(ctx, *dxs):
        return (None, None) + _p2p(dxs, ctx.g, -ctx.step)


def _p2p(xs, g, step):
    n = g.size
    if n == 1 or step % n == 0:
        return tuple(x.clone() for x in xs)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    to = g.ranks[(g.index + step) % n]
    frm = g.ranks[(g.index - step) % n]
    ops = [dist.P2POp(dist.isend, x, to, g.pg) for x in xs] + \
        [dist.P2POp(dist.irecv, o, frm, g.pg) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


def shift(xs, g: Group, step: int = 1):
    """Rank i's tensors ``xs`` (a tensor or a tuple) arrive at rank i +
    ``step`` of the ring ``g``. Every rank must run the backward of every
    hop, in the order of the hops: chain each hop's input to the previous
    hop's output, and the last hop's output to the result (:func:`tie`),
    so that each hop lies on the path from the loss to the inputs the
    gradient is taken for."""
    one = isinstance(xs, torch.Tensor)
    out = _Shift.apply(g, step, *((xs,) if one else xs))
    return out[0] if one else out


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return (dx,) + tuple(torch.zeros(s, dtype=t, device=d)
                             for s, t, d in ctx.shapes)


def tie(x, *deps):
    """``x`` unchanged, with ``deps`` made its inputs: its backward runs
    before theirs."""
    return _Tie.apply(x, *deps)

"""Segmented rematerialization for both nets' train-time forward (the
reference runs each segment under ``jax.checkpoint``:
``nn/computation_graph.py:226-324``, ``nn/multi_layer_network.py:173``).

:func:`checkpoint_segment` runs a segment under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: only
what crosses the segment's boundary is kept for the backward; the rest is
recomputed there, inside the same (captured) train step.

A recompute must draw the dropout masks and weight noise the forward
drew. The layers draw them from the net's ``torch.Generator``, which
``checkpoint``'s ``preserve_rng_state`` does not cover (it saves the
default generators only), and a generator's state cannot be read or set
while a CUDA graph is being captured. So the segment's first run records
every tensor drawn from an explicit generator (a call with a
``generator=`` keyword, seen through a ``TorchFunctionMode``) and the
recompute is handed the same tensors, in the same order, instead of
drawing again. The generator advances once, in the forward, exactly as
the monolithic forward advances it, so the masks and the whole
trajectory equal the monolithic walk's.

The tape keeps a copy of each draw, so a later in-place op on the drawn
tensor cannot change it. A draw reaches the recompute three ways: as the
op's result (``torch.rand(..., generator=g)``); in place, into the
tensor a method named with a trailing ``_`` fills (``z.uniform_(
generator=g)``, ``nn.init.trunc_normal_(z, generator=g)``), which the
replay fills with the taped values; and into ``out=``, which the replay
fills likewise.

The segment's outputs (carried activations, running states, output
pre-activations) come from the first run only; a recompute's are
discarded, so the BN states come out of the forward once, as under
``jax.checkpoint``. Outside autograd (``torch.no_grad``) a segment is
simply called.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


class _DrawTape(TorchFunctionMode):
    """Records the tensors a segment draws from explicit generators, or
    hands them back in order on a recompute."""

    def __init__(self, draws, replay):
        super().__init__()
        self.draws, self.replay, self.i = draws, replay, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("generator") is None:
            return func(*args, **kwargs)
        target = kwargs.get("out")
        if target is None and getattr(func, "__name__", "").endswith("_") \
                and args and isinstance(args[0], torch.Tensor):
            target = args[0]                # an in-place draw
        if self.replay:
            taped = self.draws[self.i]
            self.i += 1
            if target is None:
                return taped
            with torch.no_grad():
                target.copy_(taped)
            return target
        out = func(*args, **kwargs)
        self.draws.append((out if target is None else target).clone())
        return out


def checkpoint_segment(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    if not torch.is_grad_enabled():
        return fn(*args)
    draws, runs = [], [0]

    def run(*a):
        replay = runs[0] > 0
        runs[0] += 1
        with _DrawTape(draws, replay):
            return fn(*a)

    from torch.utils.checkpoint import checkpoint
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)

"""Memory workspaces — port of ``deeplearning4j_tpu/ndarray/workspace.py``
(``org.nd4j.linalg.api.memory.MemoryWorkspace``: libnd4j's arena that
reuses scratch buffers across iterations).

On the card the arena is a CUDA graph's memory pool: :func:`jit_in_workspace`
turns a function of tensors into a compiled callable
(``nn/_compiled.py``'s :class:`CompiledStep`) that runs the first call of
each input signature eagerly, captures the second as a CUDA graph and
replays it after, its intermediates in one pool that every replay reuses.
Donated arguments (``donate_argnums``) are the ones the function may
update in place: they are passed through by identity, as the compiled
train step passes its params, never copied into a static input. A graph
bakes their addresses, so it is captured per donated tensor; pass the
same tensors each call to replay it. The other tensor arguments are
copied into the graph's static inputs; ``static_argnums`` are Python
values, part of the signature. On the CPU the function is called
directly.

:func:`live_buffer_bytes` and :func:`device_memory_stats` read
``torch.cuda.memory_allocated`` / ``memory_stats``; without a card they
report 0 and ``{}``.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch

from ..nn._compiled import Bound, CompiledStep


@dataclass
class WorkspaceConfig:
    """Mirrors WorkspaceConfiguration: which argnums to donate on the step fn."""

    name: str = "WS_TRAIN"
    donate_argnums: tuple = ()
    donate_argnames: tuple = ()


_active: list = []


@contextlib.contextmanager
def workspace(config: WorkspaceConfig | None = None, name: str = "WS"):
    """Scoped workspace; inside the scope `current()` returns the config."""
    cfg = config or WorkspaceConfig(name=name)
    _active.append(cfg)
    try:
        yield cfg
    finally:
        _active.pop()


def current() -> WorkspaceConfig | None:
    return _active[-1] if _active else None


def jit_in_workspace(fn=None, *, donate_argnums=(), static_argnums=(),
                     **_jit_kw):
    """``fn`` as a compiled callable (see the module docstring). The
    returned callable's ``compiled`` is its :class:`CompiledStep`
    (``.last``, ``.calls``)."""
    if fn is None:
        return functools.partial(jit_in_workspace,
                                 donate_argnums=donate_argnums,
                                 static_argnums=static_argnums)
    donate = {donate_argnums} if isinstance(donate_argnums, int) \
        else set(donate_argnums)
    step = CompiledStep(fn, lambda: [],
                        getattr(fn, "__name__", "jit_in_workspace"))

    @functools.wraps(fn)
    def call(*args):
        # a Python value (a static argument) is keyed by its repr and
        # passed as it is; a donated tensor by identity
        return step(*(Bound(a) if i in donate else a
                      for i, a in enumerate(args)))

    call.compiled = step
    return call


def live_buffer_bytes() -> int:
    """Bytes the caching allocator holds in live tensors on every card
    (0 without one)."""
    if not torch.cuda.is_available():
        return 0
    return int(sum(torch.cuda.memory_allocated(i)
                   for i in range(torch.cuda.device_count())))


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each card, by ``cuda:i`` ({} without
    one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}

"""The port's ``parallel``: ``ParallelInference`` on one device (dynamic
batching, the deadline flush, futures). The mesh half — dp/fsdp/tp,
``ParallelWrapper``, pipeline, ring attention, the scale-out transport —
is not ported yet (ROADMAP.md queue 1 item 6)."""

from .wrapper import ParallelInference

__all__ = ["ParallelInference"]

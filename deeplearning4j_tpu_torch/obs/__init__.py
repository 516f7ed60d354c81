"""Observability of the port. So far only the compile sentinel
(``obs.compiles``); the metrics registry and spans are not ported yet."""

from .compiles import CompileSentinel

__all__ = ["CompileSentinel"]

"""Host-side utilities of the port: ``native`` (ctypes bindings for the
repository's ``native/`` runtime)."""

from . import native

__all__ = ["native"]

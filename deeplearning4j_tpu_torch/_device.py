"""The port's device rule: entry points run on the CUDA card unless the
caller asks for the CPU, and never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a card raises; only an
    explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def tree_to(tree, device):
    """Move every tensor leaf of nested dicts and lists to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device=device)


class HostRead:
    """A tensor's value read on the host later: on CUDA the copy into
    pinned host memory is queued now, behind the work that makes the
    tensor, and :meth:`get` waits for that copy only (the fit loop reads a
    step's loss this way after it has queued the next step). On the CPU
    it holds the tensor."""

    def __init__(self, t):
        t = t.detach()
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def get(self):
        """The value as Python numbers (``tolist``: a float for a 0-d
        tensor)."""
        if self._event is not None:
            self._event.synchronize()
        return self._buf.tolist()

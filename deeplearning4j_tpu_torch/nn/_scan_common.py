"""Shared pieces of the ``fit_scanned`` contract (MultiLayerNetwork and
ComputationGraph): the listener gate and the post-epoch listener replay.
The port's own copy of ``deeplearning4j_tpu/nn/_scan_common.py``."""

from __future__ import annotations


def check_scan_listeners(net):
    """A scanned epoch fetches its losses after its last step: only
    listeners that opted into deferred scores may run, and per-step
    anomaly gating cannot."""
    for ls in net.listeners:
        if not getattr(ls, "deferred_score_ok", False):
            raise ValueError(
                f"listener {type(ls).__name__} needs exact per-"
                "iteration model state; use fit()")
    if getattr(net, "_anomaly_detector", None) is not None:
        raise ValueError("gradient anomaly detection gates per step; "
                         "use fit()")


def replay_scan_listeners(net, losses, n_batches):
    """Fire per-iteration listeners from the epoch's (K,) loss tensor
    (ONE device fetch for all K losses), then epoch-end hooks."""
    if not net.listeners:
        return
    host_losses = losses.detach().cpu().tolist()
    base = net._step_count - n_batches
    for i, lv in enumerate(host_losses):
        for listener in net.listeners:
            listener.iteration_done(net, base + i + 1,
                                    net.epoch_count - 1, float(lv))
    for listener in net.listeners:
        if hasattr(listener, "on_epoch_end"):
            listener.on_epoch_end(net)

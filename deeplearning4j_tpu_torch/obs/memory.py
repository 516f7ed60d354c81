"""Memory census — device-memory attribution over named components. Port
of ``deeplearning4j_tpu/obs/memory.py``.

Two sources, combined:

- :func:`tree_bytes` — tree attribution. Sums ``numel * element_size``
  over the tensors of a named component (params, optimizer state, KV
  cache, running states) given as nested dicts, lists and tuples of
  tensors, or as anything with a ``state_dict()``. It works on every
  device, so the CPU tests get real numbers.
- :func:`device_memory_stats` — the allocator's own view, mapped from
  ``torch.cuda.memory_stats()`` onto the reference's keys
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``); ``None``
  on the CPU. The census carries BOTH: tree bytes attribute, allocator
  bytes bound — the gap between them is the caching allocator's slack
  and the workspaces, itself a number worth watching.

:func:`emit_census` publishes a census as
``dl4j_mem_component_bytes{component, replica}`` gauges on the process
registry and remembers the latest census per (source, replica), which
:func:`debug_state` and the flight recorder's dumps carry.

Label discipline (``scripts/check_metric_names.py`` enforces): the
``dl4j_mem_*`` / ``dl4j_kv_*`` / ``dl4j_compile_*`` plane may label by
``component`` and ``replica`` ONLY — component names are a small fixed
vocabulary (params / optimizer / kv_cache / grads / workspace / states /
total), never per-request identity.

No package-relative import at module load, and torch only inside the
functions that read tensors or the allocator.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

# the small fixed component vocabulary — emit_census warns (via ValueError)
# on names outside it so dashboards aggregate a stable label set
KNOWN_COMPONENTS = ("params", "optimizer", "kv_cache", "grads",
                    "workspace", "states", "total")

# the allocator's view: the reference's key ← torch.cuda.memory_stats()'s
_DEVICE_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _leaf_nbytes(x) -> int:
    """A tensor's or array's ``nbytes`` (``numel * element_size``)."""
    nb = getattr(x, "nbytes", None)
    return 0 if nb is None else int(nb)


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples; an object with a
    ``state_dict()`` (a module, an optimizer) is walked through it."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif callable(getattr(tree, "state_dict", None)):
        yield from _leaves(tree.state_dict())
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total bytes held by a tree's tensor leaves (None leaves free)."""
    return sum(_leaf_nbytes(leaf) for leaf in _leaves(tree))


def component_bytes(components: Dict[str, Any]) -> Dict[str, int]:
    """{name: tree} → {name: bytes}; a ``total`` row is appended."""
    out = {name: tree_bytes(tree) for name, tree in components.items()}
    out["total"] = sum(out.values())
    return out


def per_replica_bytes(tree) -> Dict[str, int]:
    """Bytes each device actually holds of ``tree``: a CUDA tensor counts
    on its card's index, anything else on replica "0"."""
    acc: Dict[str, int] = {}
    for leaf in _leaves(tree):
        get_device = getattr(leaf, "get_device", None)  # -1 on the CPU
        index = get_device() if get_device is not None else -1
        key = str(index) if index >= 0 else "0"
        acc[key] = acc.get(key, 0) + _leaf_nbytes(leaf)
    return acc or {"0": 0}


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """The caching allocator's view of one card (``device``: an index, a
    ``torch.device`` or None for the current card): ``bytes_in_use`` ←
    ``allocated_bytes.all.current``, ``peak_bytes_in_use`` ←
    ``allocated_bytes.all.peak``, ``bytes_limit`` ← the card's total
    memory (``torch.cuda.mem_get_info()[1]``). None on the CPU — callers
    fall back to tree sizes, they never go blind."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            return None
        # the allocator's nested stats: memory_stats() flattens every
        # key in Python, a cost a poll between train steps need not pay
        alloc = torch.cuda.memory_stats_as_nested_dict(dev).get(
            "allocated_bytes", {}).get("all", {})
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        limit = _LIMITS.get(index)
        if limit is None:            # the card's total: read once
            limit = _LIMITS[index] = torch.cuda.mem_get_info(index)[1]
    except Exception:  # noqa: BLE001 — absence is an expected backend trait
        return None
    return {"bytes_in_use": float(alloc.get("current", 0)),
            "peak_bytes_in_use": float(alloc.get("peak", 0)),
            "bytes_limit": float(limit)}


_LIMITS: Dict[int, int] = {}


# --------------------------------------------------------------- census

# latest census per (source, replica) — what debug_state() serves
_CENSUSES: Dict[tuple, Dict[str, Any]] = {}
_LOCK = threading.Lock()


def emit_census(components: Dict[str, Any], *, replica: str = "0",
                source: str = "train", registry=None,
                per_replica: bool = False) -> Dict[str, Any]:
    """Attribute ``components`` ({name: tree}) and publish.

    Sets ``dl4j_mem_component_bytes{component, replica}`` gauges,
    attaches the allocator stats where there is a card (graceful
    absence on the CPU — the tree numbers stand alone), and records the
    census for :func:`latest_censuses`.

    ``registry`` is a :class:`~.registry.MetricsRegistry`; ``None``
    means the process-wide registry.

    With ``per_replica=True`` the GAUGES are per-device: each component
    split by the devices its tensors live on.
    The aggregate numbers live in the returned census record's
    ``component_bytes``; they are deliberately NOT also written under
    ``replica`` — device ids start at "0" and would silently overwrite
    the aggregate row, leaving components that don't sum to ``total``.

    Returns the census record (plain data, JSON-able).
    """
    for name in components:
        if name not in KNOWN_COMPONENTS:
            raise ValueError(
                f"unknown memory component {name!r}: pick from "
                f"{KNOWN_COMPONENTS[:-1]} (a stable label vocabulary — "
                "extend KNOWN_COMPONENTS deliberately)")
    if registry is None:
        from . import get_registry
        registry = get_registry()
    gauge = registry.gauge(
        "dl4j_mem_component_bytes",
        "Device bytes attributed to a named component (pytree census; "
        "the allocator view rides the census record)",
        labelnames=("component", "replica"))
    rep = str(replica)
    if per_replica:
        # one walk: the aggregate is the sum over the devices
        split: Dict[str, Dict[str, int]] = {}
        for name, tree in components.items():
            for dev, nbytes in per_replica_bytes(tree).items():
                split.setdefault(dev, {})
                split[dev][name] = split[dev].get(name, 0) + nbytes
        by_comp = {name: sum(c.get(name, 0) for c in split.values())
                   for name in components}
        by_comp["total"] = sum(by_comp.values())
    else:
        by_comp = component_bytes(components)
    census: Dict[str, Any] = {
        "kind": "memcensus", "source": source, "replica": rep,
        "ts": time.time(), "component_bytes": by_comp,
    }
    if per_replica:
        for dev, comps in split.items():
            comps["total"] = sum(comps.values())
            for name, nbytes in comps.items():
                gauge.set(float(nbytes), component=name, replica=dev)
        census["per_replica_bytes"] = split
    else:
        for name, nbytes in by_comp.items():
            gauge.set(float(nbytes), component=name, replica=rep)
    stats = device_memory_stats()
    census["device"] = stats                  # None on CPU — explicit
    census["device_source"] = "memory_stats" if stats else "pytree"
    with _LOCK:
        _CENSUSES[(source, rep)] = census
    return census


def latest_censuses() -> List[Dict[str, Any]]:
    """Every (source, replica)'s most recent census, stable order."""
    with _LOCK:
        return [_CENSUSES[k] for k in sorted(_CENSUSES)]


def reset_censuses():
    """Drop recorded censuses (tests)."""
    with _LOCK:
        _CENSUSES.clear()


def debug_state() -> Dict[str, Any]:
    """The memory plane's live state: the latest census per
    source/replica, the live allocator view, and the KV-residency
    accounting of every live scheduler (via its flight recorder's
    ``extra_state``)."""
    kv = []
    try:
        from .reqtrace import live_flight_recorders
        for fr in live_flight_recorders():
            if fr.extra_state is None:
                continue
            try:
                state = fr.extra_state()
            except Exception as e:  # noqa: BLE001 — debug must not raise
                state = {"error": repr(e)}
            if "kv" in state:
                kv.append({"replica": fr.replica, **state["kv"]})
    except Exception:  # noqa: BLE001 — debug must not raise
        pass
    return {"censuses": latest_censuses(),
            "device": device_memory_stats(),
            "kv": kv}

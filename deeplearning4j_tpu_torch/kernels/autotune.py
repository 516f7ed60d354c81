"""The autotune store: persistent cost records for every tuned surface.
Port of ``deeplearning4j_tpu/kernels/autotune.py``.

Each candidate is timed on the device it will run on with a marginal
chain of calls (:func:`_time_once`), the fastest wins, and the verdict is
kept as a cost record so that one process's sweep serves every later run
on the same card. One store, one key grammar; the port's tuned surfaces:

- ``serving_page_len: / serving_prefill_chunk: / serving_decode_slots:``
  — the serving knobs (``serving/tune.py``);
- ``paged_decode:...`` — the fidelity-gated K2-vs-gather promotion
  verdicts (``kernels/paged_attention.py``);
- ``quant_kv:... / quant_w:...`` — int8 KV pages and int8 weights
  (``serving/quant.py``);
- ``spec_decode:...`` — speculative decoding's draft arms
  (``serving/spec.py``).

A key's KIND is everything before the first ``:``. Every record is::

    {"choice": [...],                 # the winning candidate
     "meta":   {"measured_at": ..., "best_s": ...,
                "measurements": [[cand, seconds|null], ...], ...},
     "sha":    "..." | absent}        # source fingerprint, see below

**Sha invalidation**: a record written with ``sha=`` (the digest of the
source that was measured — :func:`source_sha`, which takes functions,
classes, modules and file paths, so a record can carry the bytes of a
``.cu`` source) is only served while the caller presents the SAME sha. A
lookup with another sha deletes the record, counts into
``dl4j_autotune_invalidations_total`` and falls through to a new
measurement. Records without a sha (the serving knobs: the measured code
is the caller itself) never invalidate this way.

Where the port differs from the reference:

- **the store is the port's own**: ``$DL4J_TORCH_DATA/autotune.json``,
  else ``~/.deeplearning4j_tpu_torch/autotune.json`` — never the JAX
  package's ``~/.deeplearning4j_tpu``, so that no verdict measured on a
  TPU can serve the card;
- **backends are ``torch.device.type``** (``"cuda"`` / ``"cpu"``) in every
  key, so that a CPU key is the JAX package's letter for letter;
- :func:`_time_once` ends each chain with ``torch.cuda.synchronize`` on
  the card (a plain host read on the CPU) and warms a call up twice: on
  the card a compiled step runs its first call eagerly and captures its
  graph on the second, and the chain times replays only;
- :func:`autotune` does not catch a candidate's exception: a kernel that
  fails to build or launch raises, it is never recorded as a slow
  candidate.

``_disk_cache`` / ``_entry_choice`` are the reference's deprecated shims,
kept with it; new code uses :func:`records` / :func:`choice`.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

_memory_cache: Dict[str, Tuple] = {}
_CACHE_PATH = Path(os.environ.get(
    "DL4J_TORCH_DATA",
    Path.home() / ".deeplearning4j_tpu_torch")) / "autotune.json"


# ------------------------------------------------------------- store --

def _load_store() -> dict:
    try:
        return json.loads(_CACHE_PATH.read_text())
    except Exception:  # noqa: BLE001 — absent/corrupt cache = empty
        return {}


def _save_store(store: dict):
    try:
        _CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
        _CACHE_PATH.write_text(json.dumps(store, indent=1))
    except OSError:
        pass  # read-only home: the in-process cache still works


def _normalize(entry) -> dict:
    """A disk entry is the bare choice list (legacy) or a ``{"choice",
    "meta", "sha"}`` record."""
    if isinstance(entry, dict):
        return {"choice": list(entry.get("choice", [])),
                "meta": entry.get("meta"),
                "sha": entry.get("sha")}
    return {"choice": list(entry), "meta": None, "sha": None}


def _kind(key: str) -> str:
    return key.split(":", 1)[0]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``: the JAX package's
    ``jnp.dtype(...).name`` for the same dtype."""
    return str(dtype).replace("torch.", "")


# ------------------------------------------------------ public reads --

def records(kind: Optional[str] = None) -> Dict[str, dict]:
    """Every persisted cost record, ``{key: {choice, meta, sha}}``.
    ``kind=`` prefix-matches the key's kind segment: ``"serving"``
    returns every ``serving_*`` family, ``"serving_page_len"`` one."""
    out = {}
    for key, entry in _load_store().items():
        if kind is not None and not _kind(key).startswith(kind):
            continue
        out[key] = _normalize(entry)
    return out


def lookup(key: str, sha: Optional[str] = None) -> Optional[dict]:
    """The record for ``key`` or None. A caller's ``sha`` that differs
    from the record's deletes the record (memory and disk), counts the
    invalidation and returns None: the caller measures again."""
    store = _load_store()
    if key not in store:
        return None
    rec = _normalize(store[key])
    if sha is not None and rec["sha"] is not None and rec["sha"] != sha:
        invalidate(key, reason="sha")
        return None
    return rec


def choice(key: str, sha: Optional[str] = None) -> Optional[Tuple]:
    """The cached winner for ``key`` as a tuple, or None (a miss, or
    sha-invalidated — see :func:`lookup`)."""
    rec = lookup(key, sha=sha)
    return None if rec is None else tuple(rec["choice"])


def measurement_meta(key: str) -> Optional[dict]:
    """The measurement provenance recorded for ``key``, or None (a miss,
    a legacy entry)."""
    rec = lookup(key)
    return None if rec is None else rec["meta"]


# ----------------------------------------------------- public writes --

def put(key: str, chosen, meta: Optional[dict] = None,
        sha: Optional[str] = None):
    """Persist one cost record (memory and disk): ``chosen`` the winner,
    ``meta`` its provenance, ``sha`` the fingerprint that gates it."""
    store = _load_store()
    entry = {"choice": list(chosen)}
    if meta is not None:
        entry["meta"] = meta
    if sha is not None:
        entry["sha"] = sha
    store[key] = entry
    _memory_cache[key] = tuple(chosen)
    _save_store(store)


def invalidate(key: str, reason: str = "explicit") -> bool:
    """Drop one record from memory and disk; counts into
    ``dl4j_autotune_invalidations_total{kernel,reason}``. True if a disk
    record existed."""
    _memory_cache.pop(key, None)
    store = _load_store()
    existed = store.pop(key, None) is not None
    if existed:
        _save_store(store)
        from ..obs import get_registry
        get_registry().counter(
            "dl4j_autotune_invalidations_total",
            "Cost records dropped (sha change, explicit reset)",
            labelnames=("kernel", "reason")).inc(
                kernel=_kind(key), reason=reason)
    return existed


def clear_cache():
    _memory_cache.clear()
    try:
        _CACHE_PATH.unlink()
    except OSError:
        pass


def source_sha(*objs) -> str:
    """Fingerprint of the SOURCE of functions, classes and modules, and
    of the bytes of files (a ``str`` or ``Path``) — the ``sha=`` a kernel
    stamps its records with, so that an edit of its Python or its CUDA
    source invalidates them. A comment-only edit re-races too."""
    h = hashlib.sha256()
    for obj in objs:
        if isinstance(obj, (str, Path)):
            h.update(Path(obj).read_bytes())
        else:
            h.update(inspect.getsource(obj).encode())
    return h.hexdigest()[:16]


# -------------------------------------------------------- measurement --

def _fetch(x: torch.Tensor):
    """Wait for ``x``: on the card the device's queue drains
    (``torch.cuda.synchronize``), on the CPU one element is read."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    else:
        float(x.reshape(-1)[0])


def _time_once(run: Callable[[], object], reps: int = 8) -> float:
    """Marginal seconds a call: a chain of ``reps`` calls ended by one
    :func:`_fetch`, less one call ended the same way, over ``reps - 1``.
    Two calls warm up first (on the card a compiled step's first call is
    eager and its second captures the graph the chain replays)."""
    for _ in range(2):
        _fetch(run())
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = run()
    _fetch(out)
    t_n = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fetch(run())
    t_1 = time.perf_counter() - t0
    return max((t_n - t_1) / (reps - 1), 1e-9)


def autotune(key: str, candidates: Iterable[Tuple],
             make_run: Callable[[Tuple], Optional[Callable[[], object]]],
             enabled: bool = True, sha: Optional[str] = None) -> Tuple:
    """The fastest candidate for ``key``, cached thereafter.

    ``make_run(candidate)`` returns a nullary closure that runs the
    candidate (returning a tensor), or None where the candidate does not
    fit the shape. With ``enabled=False`` (or no valid candidate) the
    FIRST candidate is returned untimed. A candidate that raises is not
    caught. ``sha=`` stamps the record with the measured source's
    fingerprint (see :func:`lookup`)."""
    from ..obs import get_registry
    reg = get_registry()
    if key in _memory_cache and sha is None:
        reg.counter("dl4j_autotune_cache_hits_total",
                    "Autotune lookups served from cache",
                    labelnames=("level",)).inc(level="memory")
        return _memory_cache[key]
    cached = lookup(key, sha=sha)
    if cached is not None:
        level = "memory" if key in _memory_cache else "disk"
        reg.counter("dl4j_autotune_cache_hits_total",
                    "Autotune lookups served from cache",
                    labelnames=("level",)).inc(level=level)
        chosen = tuple(cached["choice"])
        _memory_cache[key] = chosen
        return chosen

    candidates = [c for c in candidates]
    if not enabled:
        chosen = candidates[0]
        _memory_cache[key] = chosen
        return chosen

    m_measure = reg.counter("dl4j_autotune_measurements_total",
                            "Candidate configs timed on the device")
    m_time = reg.histogram("dl4j_autotune_candidate_seconds",
                           "Marginal per-call seconds of timed candidates")
    best, best_t = None, float("inf")
    measurements = []
    for cand in candidates:
        run = make_run(cand)
        if run is None:                     # invalid for the shape
            measurements.append([list(cand), None])
            continue
        t = _time_once(run)
        m_measure.inc()
        m_time.observe(t)
        measurements.append([list(cand), t])
        if t < best_t:
            best, best_t = cand, t
    if best is None:
        best = candidates[0]
    put(key, best,
        meta={"measured_at": time.time(),
              "best_s": None if best_t == float("inf") else best_t,
              "candidates": len(candidates),
              "measurements": measurements},
        sha=sha)
    return best


# ------------------------------------------- deprecated private shims --

def _disk_cache() -> dict:
    """Deprecated: use :func:`records` (normalized) instead."""
    warnings.warn("autotune._disk_cache is deprecated; use "
                  "autotune.records()", DeprecationWarning, stacklevel=2)
    return _load_store()


def _entry_choice(entry):
    """Deprecated: use :func:`choice`/:func:`lookup` instead."""
    warnings.warn("autotune._entry_choice is deprecated; use "
                  "autotune.choice()/lookup()", DeprecationWarning,
                  stacklevel=2)
    return tuple(_normalize(entry)["choice"])

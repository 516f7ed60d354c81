"""Distributed checkpointing — async, with retention, per-rank shards. Port
of ``deeplearning4j_tpu/serde/orbax_ckpt.py`` on
``torch.distributed.checkpoint`` (the card has no orbax; the names are the
reference's, so a reader finds the counterpart).

Reference counterpart: DL4J's CheckpointListener + ModelSerializer write a
zip from host memory on one node. A sharded job must checkpoint without
gathering to one rank and without stalling the step loop:

- each step is a directory ``<directory>/<step>/`` that
  ``torch.distributed.checkpoint`` writes (its ``.metadata`` file, written
  last, marks a whole checkpoint), plus each rank's
  ``structure.json.r<rank>`` (its trees' shapes, so that a restore without
  templates can rebuild them) and ``metadata.json`` (the caller's
  metadata);
- under a process group of more than one rank every rank writes its own
  view of the trees under its own keys (``r<rank>/...``): its slice of a
  leaf that fsdp or tp split, its copy of a replicated one. Nothing is
  gathered; a restore needs the world size and the layout of the save.
  The checkpoint's collectives run on a gloo group of their own, so that
  an async save never interleaves with the training step's collectives;
- ``async_=True`` stages the tensors to host memory at ``save`` and writes
  them in the background (``torch.distributed.checkpoint.async_save``);
  ``wait()`` finishes the writes, and the next ``save`` waits for the
  previous one first, as orbax does;
- ``max_to_keep`` keeps the newest whole checkpoints (rank 0 deletes the
  rest once a save has finished); ``save_interval_steps`` skips a step
  that is not a multiple of it unless ``force``.

``restore(*_like=...)`` loads into new tensors shaped, typed and placed as
the templates (a net on the card restores straight onto the card);
without templates the trees come back on the host.
:class:`CheckpointingTrainerMixin` copies a restore into a net's own
tensors in place, so that its compiled step's graphs stay valid.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import shutil
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_STRUCTURE = "structure.json"
_METADATA = "metadata.json"
_DONE = ".metadata"         # written last by torch.distributed.checkpoint
_ITEMS = ("params", "states", "opt_state")


def _skeleton(tree, prefix: str, flat: Dict[str, torch.Tensor]):
    """JSON skeleton of ``tree``; its tensors go into ``flat`` by path."""
    if isinstance(tree, dict):
        return {"d": [[k, _skeleton(v, f"{prefix}/{k}", flat)]
                      for k, v in tree.items()]}
    if isinstance(tree, (tuple, list)):
        return {"t" if isinstance(tree, tuple) else "l":
                [_skeleton(v, f"{prefix}/{i}", flat)
                 for i, v in enumerate(tree)]}
    if isinstance(tree, torch.Tensor):
        flat[prefix] = tree
        return {"k": prefix}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"v": tree}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}"
                    f" at {prefix}")


def _build(skel, leaf):
    """The tree of ``skel`` with each tensor key replaced by ``leaf(key)``."""
    if "d" in skel:
        return {k: _build(v, leaf) for k, v in skel["d"]}
    if "t" in skel:
        return tuple(_build(v, leaf) for v in skel["t"])
    if "l" in skel:
        return [_build(v, leaf) for v in skel["l"]]
    if "k" in skel:
        return leaf(skel["k"])
    return skel["v"]


def _copy_tree(dst, src):
    """Copy ``src``'s tensors into ``dst``'s (one structure), in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


def _has_tensors(tree) -> bool:
    flat: Dict[str, torch.Tensor] = {}
    _skeleton(tree, "", flat)
    return bool(flat)


def _dcp():
    """``torch.distributed.checkpoint``, imported where it is used (it
    costs seconds at import)."""
    import torch.distributed.checkpoint as dcp
    return dcp


def _kwargs(fn, **kw):
    """``kw`` restricted to what ``fn`` takes (the checkpoint API's
    keywords move between torch versions)."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


class OrbaxCheckpointer:
    """Async per-rank checkpoints with retention (see the module
    docstring). Under a process group every rank constructs it (the
    checkpoint group is made collectively) and every rank calls ``save``
    and ``restore`` with its own trees."""

    def __init__(self, directory, max_to_keep: int = 3, async_: bool = True,
                 save_interval_steps: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_ = async_
        self.save_interval_steps = max(1, int(save_interval_steps))
        self._dist = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self._dist else 0
        self.world = dist.get_world_size() if self._dist else 1
        self._group = dist.new_group(backend="gloo") \
            if self._dist and self.world > 1 else None
        self._pending = None            # (step, future) of an async save
        self._last_saved: Optional[int] = self._steps()[-1] \
            if self._steps() else None

    # ------------------------------------------------------------ layout
    def _prefix(self, item: str) -> str:
        return f"r{self.rank}/{item}" if self.world > 1 else item

    def _steps(self):
        """Whole checkpoints on disk, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _DONE).exists())

    def _io(self, **kw):
        if self._dist:
            return dict(kw, process_group=self._group)
        return dict(kw, no_dist=True)

    @contextlib.contextmanager
    def _quiet(self):
        """Outside a process group the checkpoint API warns that it
        assumes one process — which is what ``no_dist`` asked for."""
        with warnings.catch_warnings():
            if not self._dist:
                warnings.filterwarnings("ignore",
                                        "torch.distributed is disabled")
            yield

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, states=None, opt_state=None,
             metadata: Optional[dict] = None, force: bool = False) -> bool:
        """Start the save of ``step`` (async unless ``async_=False``);
        False if ``save_interval_steps`` skips it."""
        step = int(step)
        if not force and (step % self.save_interval_steps or (
                self._last_saved is not None and step <= self._last_saved)):
            return False
        self.wait()
        path = self.directory / str(step)
        if (path / _DONE).exists():
            raise ValueError(f"step {step} is already saved under "
                             f"{self.directory}")
        flat: Dict[str, torch.Tensor] = {}
        skel = {"params": _skeleton(params, self._prefix("params"), flat)}
        for name, tree in (("states", states), ("opt_state", opt_state)):
            if tree is not None and _has_tensors(tree):
                skel[name] = _skeleton(tree, self._prefix(name), flat)
        # staged: host copies taken now, so training may go on in place
        # while an async write runs (a card's tensors cross to the host
        # here, once)
        flat = {k: v.detach().to("cpu", copy=True) for k, v in flat.items()}
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{_STRUCTURE}.r{self.rank}").write_text(json.dumps(skel))
        if self.rank == 0 and metadata:
            (path / _METADATA).write_text(json.dumps(metadata))
        io = self._io(checkpoint_id=str(path))
        dcp = _dcp()
        with self._quiet():
            if self.async_:
                self._pending = (step, dcp.async_save(
                    flat, **_kwargs(dcp.async_save, **io)))
            else:
                dcp.save(flat, **_kwargs(dcp.save, **io))
        if not self.async_:
            self._finish(step)
        self._last_saved = step
        return True

    def _finish(self, step: int):
        """A save is whole: apply the retention policy (rank 0)."""
        if self.rank != 0 or not self.max_to_keep:
            return
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def wait(self):
        """Finish the pending async save (and its retention)."""
        if self._pending is not None:
            step, fut = self._pending
            self._pending = None
            with self._quiet():
                fut.result()
            self._finish(step)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, params_like=None,
                states_like=None, opt_state_like=None):
        """Restore ``(params, states, opt_state, metadata)`` of ``step``
        (default the latest). ``*_like`` trees give the shapes, dtypes and
        devices of the restored tensors; an item saved without a template
        comes back from its saved structure, on the host."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.directory / str(int(step))
        if not (path / _DONE).exists():
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        skel = json.loads((path / f"{_STRUCTURE}.r{self.rank}").read_text())
        dcp = _dcp()
        saved = dcp.FileSystemReader(str(path)).read_metadata() \
            .state_dict_metadata
        likes = {"params": params_like, "states": states_like,
                 "opt_state": opt_state_like}
        flat: Dict[str, torch.Tensor] = {}
        trees: Dict[str, Any] = {}
        for name in _ITEMS:
            if name not in skel:
                trees[name] = None
                continue
            like = likes[name]
            if like is not None:
                tmpl: Dict[str, torch.Tensor] = {}
                shape = _skeleton(like, self._prefix(name), tmpl)
                missing = set(tmpl) - set(saved)
                if missing:
                    raise KeyError(f"{name}: the checkpoint of step {step} "
                                   f"has no {sorted(missing)[:3]}")
                trees[name] = _build(shape, lambda k: flat.setdefault(
                    k, torch.empty_like(tmpl[k])))
            else:
                def fresh(k):
                    md = saved[k]
                    return flat.setdefault(k, torch.empty(
                        tuple(md.size), dtype=md.properties.dtype))
                trees[name] = _build(skel[name], fresh)
        with self._quiet():
            dcp.load(flat, **_kwargs(dcp.load, **self._io(
                checkpoint_id=str(path))))
        meta_path = path / _METADATA
        meta = json.loads(meta_path.read_text()) if meta_path.exists() \
            else None
        return trees["params"], trees["states"], trees["opt_state"], meta

    def close(self):
        self.wait()
        if self._group is not None:
            dist.destroy_process_group(self._group)
            self._group = None


class PreemptionWatchdog:
    """Elastic/failure handling: checkpoint on a deadline so preemption
    (SIGTERM with grace period, maintenance events) never loses more than
    ``interval_s`` of work. Reference counterpart: Spark/Aeron trainers
    restarting from the last ModelSerializer write."""

    def __init__(self, checkpointer: OrbaxCheckpointer,
                 interval_s: float = 300.0):
        self.ckpt = checkpointer
        self.interval_s = interval_s
        self._last = time.monotonic()
        self._installed = False

    def maybe_save(self, step: int, params, states=None,
                   opt_state=None) -> bool:
        now = time.monotonic()
        if now - self._last >= self.interval_s:
            self.ckpt.save(step, params, states, opt_state, force=True)
            self._last = now
            return True
        return False

    def install_signal_handler(self, get_state_fn):
        """On SIGTERM: synchronously save ``get_state_fn() -> (step,
        params, states, opt_state)`` before the process dies."""
        import signal

        def handler(signum, frame):
            step, params, states, opt_state = get_state_fn()
            self.ckpt.save(step, params, states, opt_state, force=True)
            self.ckpt.wait()
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, handler)
        self._installed = True


class CheckpointingTrainerMixin:
    """Glue for MultiLayerNetwork/ComputationGraph: ``resume``."""

    @staticmethod
    def resume(net, checkpointer: OrbaxCheckpointer):
        """Restore the latest checkpoint into ``net`` in place (params,
        running states and, where the net's updater exists, its state)
        and return its step (0 when there is none)."""
        step = checkpointer.latest_step()
        if step is None:
            return 0
        params, states, opt_state, meta = checkpointer.restore(
            params_like=net.params,
            states_like=net.states if _has_tensors(net.states) else None,
            opt_state_like=net._opt_state)
        with torch.no_grad():
            _copy_tree(net.params, params)
            if states is not None:
                _copy_tree(net.states, states)
            if opt_state is not None and net._opt_state is not None:
                _copy_tree(net._opt_state, opt_state)
        if meta:
            net._step_count = meta.get("step_count", step)
            net.epoch_count = meta.get("epoch_count", 0)
        return step

"""The device mesh over ``torch.distributed`` ranks — port of
``deeplearning4j_tpu/parallel/mesh.py``.

The reference drives a ``jax.sharding.Mesh`` of devices from one process
and lets GSPMD insert the collectives. Torch runs one process per rank
(SPMD), so a :class:`Mesh` here is the ranks of the world laid out on
named axes, with a process group for every set of axes:

  dp    data parallel (batch split; gradients summed over it)
  fsdp  fully-sharded data parallel (a batch axis too; the updater state
        and the update split over it)
  pp    pipeline parallel (stages)
  tp    tensor parallel (Megatron column/row products)
  sp    sequence parallel (ring attention)
  ep    expert parallel

Rank r sits at the row-major place r of ``MeshSpec.axes`` over the
``devices`` ranks (ascending), as the reference reshapes its device list.
:meth:`Mesh.group` returns the group of the ranks that differ from this
one only along the named axes (``_dist.Group``); every group is made when
the mesh is, by every rank of the world in the same order, as
``torch.distributed.new_group`` requires — so ``make_mesh`` is collective:
every rank calls it, with the same arguments. A rank outside ``devices``
gets a mesh it is not a ``member`` of, and no groups.

``make_mesh`` starts a world of one by itself when no process group
exists: NCCL on the card, gloo on the CPU, over an in-process store, with
no launcher — so ``ParallelWrapper(net, make_mesh(dp=1))`` runs as written
on one card. Several ranks come from a launcher (``torchrun``) through
:func:`bootstrap_distributed`, or from spawned processes that start their
group themselves. The mesh's ``device`` is where its ranks compute:
``None`` is this rank's CUDA device (``LOCAL_RANK``), and raises without
a card; only an explicit ``"cpu"`` runs on the host.

The placements (:class:`Sharding`) carry the reference's
``PartitionSpec`` as a tuple: ``()`` replicated, ``(None, "fsdp")`` the
last axis of a matrix split over fsdp.

Not a ``DeviceMesh``: the reference's ``mesh.shape`` is a dict of axis
sizes and a mesh may cover part of the world, which ``DeviceMesh``
(``shape`` a tuple, over the whole world) does not give.
"""

from __future__ import annotations

import itertools
import math
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _dist
from .._device import resolve_device

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")
BATCH_AXES = ("dp", "fsdp")


@dataclass
class MeshSpec:
    """{axis_name: size}; axes of size 1 are kept (harmless, simplifies
    specs)."""

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for a in self.axes:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis '{a}'; known: {AXES}")

    @property
    def size(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1

    def build(self, devices: Optional[Sequence[int]] = None,
              device=None) -> "Mesh":
        dev = _mesh_device(device)
        _ensure_world(dev)
        ranks = list(range(dist.get_world_size())) if devices is None \
            else [int(r) for r in devices]
        if self.size != len(ranks):
            raise ValueError(
                f"mesh spec {self.axes} needs {self.size} devices, got "
                f"{len(ranks)}")
        if ranks != sorted(set(ranks)) or ranks[-1] >= dist.get_world_size():
            raise ValueError(f"devices must be ascending ranks of the world "
                             f"of {dist.get_world_size()}, got {ranks}")
        return Mesh(dict(self.axes), ranks, dev)


class Sharding(NamedTuple):
    """A placement on a mesh: ``spec`` names, per tensor axis, the mesh
    axis it is split over (None: whole); ``()`` is replicated."""
    mesh: "Mesh"
    spec: Tuple


class Mesh:
    """Ranks on named axes (see the module docstring)."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int],
                 device: torch.device):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.size = math.prod(axes.values()) if axes else 1
        self.device = device
        self.devices = np.asarray(ranks).reshape(
            tuple(axes.values()) or (1,))
        me = dist.get_rank()
        self.member = me in ranks
        self.coordinate = {}
        if self.member:
            at = np.argwhere(self.devices == me)[0]
            self.coordinate = {a: int(i) for a, i in
                               zip(self.axis_names, at)}
        self._groups = {}
        world = list(range(dist.get_world_size()))
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for sub in itertools.combinations(names, n):
                keep = [names.index(a) for a in sub]
                rest = [i for i in range(len(names)) if i not in keep]
                grid = np.transpose(self.devices, rest + keep).reshape(
                    -1, math.prod(self.shape[a] for a in sub))
                for row in grid:
                    row = [int(r) for r in row]
                    pg = dist.group.WORLD if row == world else \
                        dist.new_group(row)
                    if me in row:
                        self._groups[sub] = _dist.Group(pg, row)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    def group(self, *axes) -> _dist.Group:
        """The group along ``axes`` (absent axes are dropped; none left:
        this rank alone, whose collectives are no-ops)."""
        if not self.member:
            raise RuntimeError(f"rank {dist.get_rank()} is not in {self}")
        sub = tuple(a for a in self.axis_names if a in axes)
        if not sub:
            return _dist.Group(None, [dist.get_rank()])
        return self._groups[sub]

    def batch_axes(self, *axes_present):
        return tuple(a for a in BATCH_AXES if a in self.axis_names and
                     (not axes_present or a in axes_present))

    def batch_size(self, *axes_present) -> int:
        """How many ranks one global batch is split over."""
        return math.prod(self.shape[a] for a in self.batch_axes(
            *axes_present))

    def batch_index(self, *axes_present) -> int:
        """This rank's place among the batch shards, row-major."""
        i = 0
        for a in self.batch_axes(*axes_present):
            i = i * self.shape[a] + self.coordinate[a]
        return i


def _mesh_device(device):
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _ensure_world(dev):
    """A world of one when no group exists (NCCL on the card, gloo on the
    CPU, an in-process store); an existing world is used as it is."""
    if dist.is_initialized():
        if dev.type == "cpu" and dist.get_backend() == "nccl":
            raise ValueError("an NCCL world cannot run a CPU mesh")
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(devices=None, *, device=None, **axes) -> Mesh:
    """``make_mesh(dp=2, tp=4)`` → a :class:`Mesh` over the world's ranks
    (or the ascending ranks ``devices``); collective."""
    return MeshSpec(axes).build(devices, device)


def data_parallel_mesh(devices=None, *, device=None) -> Mesh:
    dev = _mesh_device(device)
    _ensure_world(dev)
    n = dist.get_world_size() if devices is None else len(devices)
    return make_mesh(devices, device=dev, dp=n)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, *axes_present: str) -> Sharding:
    """The leading (batch) dim split over dp (and fsdp if present)."""
    ax = mesh.batch_axes(*axes_present)
    return Sharding(mesh, (ax,) if ax else (None,))


def shard_params_fsdp(mesh: Mesh, params, min_size: int = 2 ** 14):
    """ZeRO-3 layout: each large leaf's LAST axis that divides evenly is
    split over 'fsdp'; small leaves stay replicated. Returns the matching
    tree of :class:`Sharding`."""
    if "fsdp" not in mesh.axis_names:
        raise ValueError("mesh has no fsdp axis")
    n = mesh.shape["fsdp"]

    def spec(leaf):
        if leaf.dim() == 0 or leaf.numel() < min_size:
            return Sharding(mesh, ())
        for ax in range(leaf.dim() - 1, -1, -1):
            if leaf.shape[ax] % n == 0:
                parts = [None] * leaf.dim()
                parts[ax] = "fsdp"
                return Sharding(mesh, tuple(parts))
        return Sharding(mesh, ())

    return tree_map(spec, params)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


_CLUSTER_ENV = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID", "WORLD_SIZE")


def bootstrap_distributed(coordinator: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, *,
                          device=None) -> None:
    """Multi-process init (reference: the cluster bootstrap). Under
    ``torchrun`` the arguments come from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); elsewhere pass
    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``.
    Safe to call when already initialized.

    A failed init raises when the caller clearly asked for several
    processes (arguments, or the launcher's environment): falling back to
    one process is a quiet misconfiguration. Only a bare call with no
    launcher around it warns and stays single-process."""
    if dist.is_initialized():
        return
    env = {k: os.environ.get(k) for k in _CLUSTER_ENV}
    requested = any(v is not None for v in
                    (coordinator, num_processes, process_id)) or \
        any(env.values())
    if not requested:
        warnings.warn("no coordinator and no launcher environment: "
                      "continuing single-process", RuntimeWarning,
                      stacklevel=2)
        return
    dev = _mesh_device(device)
    kw = {}
    if coordinator:
        kw["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **kw)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"multi-process bootstrap failed (coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})"
            " — refusing to fall back to single-process training") from e


def hybrid_mesh_2d(ici_axes: Dict[str, int], dcn_axes: Dict[str, int], *,
                   device=None) -> Mesh:
    """Hosts × local devices: the ``dcn_axes`` outer (across hosts), the
    ``ici_axes`` inner (the ranks of one host, which a launcher numbers
    consecutively). With ``LOCAL_WORLD_SIZE`` set, the inner axes must
    cover exactly one host's ranks."""
    inner = math.prod(ici_axes.values()) if ici_axes else 1
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) != inner:
        raise ValueError(f"ici axes {ici_axes} cover {inner} ranks, a host "
                         f"has {local}")
    both = dict(dcn_axes)
    for a, n in ici_axes.items():
        if a in both:
            raise ValueError(f"axis '{a}' is both a dcn and an ici axis")
        both[a] = n
    return make_mesh(device=device, **both)

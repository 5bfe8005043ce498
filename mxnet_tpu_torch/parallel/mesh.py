"""Named meshes over worker processes (``mxnet_tpu/parallel/mesh.py``).

The JAX package's mesh is a grid of chips with a named axis each, and an
array's sharding says which slice of it a chip holds.  Here a mesh is a
grid of ``torch.distributed`` ranks, one device each (``cuda:(rank %
device_count)``, or the CPU), and a sharding says which rows of an array
a rank holds.  This slice of the port has only the ``data`` axis: the
batch's dim 0 split across ranks (:func:`batch_sharding`), parameters
replicated (:func:`replicated`), and ZeRO-1's optimizer state split by
rows (:func:`zero_spec`).  The ``model``/``pipe``/``seq``/``expert`` axes
raise, naming ROADMAP item 7.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "get_mesh",
           "make_mesh", "current_mesh", "use_mesh", "data_parallel_mesh",
           "global_data_parallel_mesh", "batch_sharding", "replicated",
           "zero_spec", "AXIS_SLICE"]

AXIS_SLICE = ("tensor, pipeline, sequence and expert parallelism (mesh "
              "axes other than 'data', param_specs) wait for the port's "
              "model-parallel slice (ROADMAP item 7)")

_LOCAL = threading.local()


def _world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None``: not split), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class Mesh:
    """Ranks on a grid with named axes (``mesh.shape``: axis -> size).
    ``devices`` holds the ranks, as the JAX mesh's holds its chips."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError("a %d-d grid of ranks for axes %s"
                             % (self.devices.ndim, self.axis_names))
        for a in self.axis_names:
            if a != "data":
                raise MXNetError("mesh axis %r: %s" % (a, AXIS_SLICE))

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def ranks(self):
        return [int(r) for r in self.devices.flat]

    def __repr__(self):
        return "Mesh(%s, ranks=%s)" % (dict(self.shape), self.ranks)


class NamedSharding:
    """Where the rows of an array live on a mesh: ``spec`` names, per
    dimension, the axis it is split along (``None``: whole on every
    rank)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def index(self, shape, rank: Optional[int] = None):
        """The slices of an array of ``shape`` that ``rank`` (this
        process's by default) holds."""
        if rank is None:
            rank = _world()[1]
        pos = self.mesh.ranks.index(rank)
        out = []
        for d, dim in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            if axis is None:
                out.append(slice(0, dim))
                continue
            n = self.mesh.shape[axis]
            rows = dim // n
            out.append(slice(pos * rows, (pos + 1) * rows))
        return tuple(out)


def make_mesh(axis_shapes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis_name: size}`` over ``devices`` (ranks; every
    rank of the process group by default)."""
    devices = list(devices if devices is not None
                   else range(_world()[0]))
    sizes = list(axis_shapes.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError("mesh of %d devices requested, %d available"
                         % (total, len(devices)))
    grid = np.array(devices[:total]).reshape(sizes)
    return Mesh(grid, tuple(axis_shapes.keys()))


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    """A 1-d ``data`` mesh over every rank (or the first N)."""
    n = num_devices or _world()[0]
    return make_mesh({"data": n})


def global_data_parallel_mesh(per_process: Optional[int] = None,
                              axis: str = "data",
                              local_batch: Optional[int] = None
                              ) -> Optional[Mesh]:
    """The ``data`` axis over every process, rank-major, one device each
    (``per_process`` and ``local_batch`` can only keep that one).  None
    for a single-process job: the caller uses a local mesh and never
    believes it has cross-process sync when it does not."""
    world, _ = _world()
    if world <= 1:
        return None
    return make_mesh({axis: world})


def current_mesh() -> Optional[Mesh]:
    return getattr(_LOCAL, "mesh", None)


def get_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The innermost ``with use_mesh(m):`` mesh, else a fresh data mesh."""
    cur = current_mesh()
    return cur if cur is not None else data_parallel_mesh(num_devices)


class _MeshScope:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = getattr(_LOCAL, "mesh", None)
        _LOCAL.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _LOCAL.mesh = self.prev


def use_mesh(mesh: Mesh) -> _MeshScope:
    """``with use_mesh(m): ...`` sets the framework's active mesh."""
    return _MeshScope(mesh)


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data"
                   ) -> NamedSharding:
    """Dim 0 (the batch) split along ``axis``: a rank holds its rows of
    the global batch."""
    spec = [None] * ndim
    spec[0] = axis
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def zero_spec(base_spec: PartitionSpec, shape: Sequence[int], n: int,
              axis: str = "data") -> PartitionSpec:
    """ZeRO sharding of a state leaf: ``base_spec`` with ``axis`` folded
    into the first unsplit dim whose size divides by ``n`` (and is at
    least ``n``).  A leaf with no such dim keeps ``base_spec``; one whose
    spec already names ``axis`` is returned as it is."""
    entries = list(base_spec) + [None] * (len(shape) - len(base_spec))
    used = [a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    if axis in used:
        return PartitionSpec(*entries)
    for d, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim >= n and dim % n == 0:
            entries[d] = axis
            break
    return PartitionSpec(*entries)

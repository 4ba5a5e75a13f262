"""A device mesh and the arrays sharded over it.

The counterparts of ``jax.sharding.Mesh``, ``PartitionSpec`` and a
sharded ``jax.Array`` for the port's domain decomposition
(``domain.py``) and pipeline split (``pipeline.py``): within a process
one controller drives every shard it owns, each shard a tensor on its
mesh position's device.  An entry of the mesh may repeat a device
("virtual shards"): a 2 x 2 mesh on one GPU, or 8 shards on the CPU.  A
mesh of distinct GPUs (one shard per GPU of a node, in one process or
one process a GPU) takes the same code, but no machine with several
GPUs has run it; processes sharing one GPU have.

Across processes the design is multi-controller, as the JAX package's
multi-host launch is: every process builds the same global mesh, and
``owners`` names the process (its rank in the ``torch.distributed``
group) that holds each position (``make_host_mesh``: rank r owns the
r-th run of positions in row-major order, as ``jax.devices()`` orders
them by process).  A ``ShardedArray`` then holds the shards of this
process's positions only; what a neighbour on another process holds
arrives through ``transport.py``.  Without ``owners`` every position is
this process's.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import to_numpy, to_torch

Coord = Tuple[int, ...]


class Mesh:
    """``devices``: an n-d array (nested sequence) of ``torch.device`` (or
    device strings), one axis per name in ``axis_names``; ``shape`` maps
    each axis name to its size, as JAX's mesh does."""

    def __init__(self, devices, axis_names: Sequence[str], owners=None,
                 rank: int = 0):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(given[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims needs {arr.ndim} "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))
        # the rank that holds each position (None: this process, all)
        self.owners = (None if owners is None else
                       np.asarray(owners, dtype=np.int64).reshape(arr.shape))
        self.rank = rank

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every mesh position, row-major."""
        return list(np.ndindex(self.devices.shape))

    def device(self, coord: Coord) -> torch.device:
        return self.devices[tuple(coord)]

    @property
    def distributed(self) -> bool:
        """Does another process hold some position?"""
        return self.owners is not None and bool(
            (self.owners != self.rank).any())

    def owner(self, coord: Coord) -> int:
        """The rank that holds position ``coord``."""
        return (self.rank if self.owners is None
                else int(self.owners[tuple(coord)]))

    def is_local(self, coord: Coord) -> bool:
        return self.owner(coord) == self.rank

    def local_coords(self):
        """This process's positions, row-major."""
        return [c for c in self.coords() if self.is_local(c)]

    def local_devices(self):
        """The devices of this process's positions, each once."""
        return list(dict.fromkeys(self.device(c)
                                  for c in self.local_coords()))

    def index(self, coord: Coord, axis: Optional[str]) -> int:
        """The position of ``coord`` along mesh axis ``axis`` (0 for
        None)."""
        return 0 if axis is None else coord[self.axis_names.index(axis)]

    def one_device(self) -> Optional[torch.device]:
        """The device every shard of this process shares, or None."""
        devs = self.local_devices()
        return devs[0] if len(devs) == 1 else None

    def __repr__(self) -> str:
        hosts = ("" if self.owners is None else
                 f", rank {self.rank} of {int(self.owners.max()) + 1}")
        return (f"Mesh({dict(self.shape)}, "
                f"devices={sorted({str(d) for d in self.devices.flat})}"
                f"{hosts})")


class ShardedArray:
    """A global array held as one tensor per mesh position.

    ``spec[a]`` is the mesh axis array dim ``a`` is split over (None:
    whole); positions that differ only along axes the spec leaves out
    hold equal copies.  ``shape`` is the global shape.  ``shards`` holds
    this process's positions only (``Mesh.local_coords``)."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...], shards: Dict[Coord, torch.Tensor]):
        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(shape)
        self.shards = shards

    @classmethod
    def place(cls, mesh: Mesh, spec, value) -> "ShardedArray":
        """``value`` (a numpy array or tensor, global shape) cut into the
        blocks ``spec`` gives each of this process's mesh positions, each
        on its device."""
        t = to_torch(value)
        spec = tuple(spec) + (None,) * (t.ndim - len(spec))
        shards = {}
        for c in mesh.local_coords():
            idx = []
            for a, ax in enumerate(spec):
                n = mesh.shape[ax] if ax is not None else 1
                b = t.shape[a] // n
                i = mesh.index(c, ax)
                idx.append(slice(i * b, (i + 1) * b))
            shards[c] = t[tuple(idx)].to(mesh.device(c)).contiguous()
        return cls(mesh, spec, tuple(t.shape), shards)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def block_index(self, coord: Coord) -> Tuple[int, ...]:
        """The block of the global array that position ``coord`` holds,
        per array dim."""
        return tuple(self.mesh.index(coord, ax) for ax in self.spec)

    def block_slices(self, coord: Coord) -> Tuple[slice, ...]:
        """Where position ``coord``'s shard lies in the global array."""
        n = [self.mesh.shape[ax] if ax is not None else 1
             for ax in self.spec]
        return tuple(slice(b * (s // k), (b + 1) * (s // k)) for b, s, k in
                     zip(self.block_index(coord), self.shape, n))

    def gather(self, device="cpu") -> torch.Tensor:
        """The global array on ``device``; raises where another process
        holds some of its shards (nothing gathers across processes)."""
        if self.mesh.distributed:
            raise ValueError(
                "gather of a ShardedArray whose mesh spans processes: this "
                "process holds only the shards of its own positions "
                "(read .shards, or gather on a mesh of one process)")
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for c, t in self.shards.items():
            blk = self.block_index(c)
            if blk in seen:
                continue
            seen.add(blk)
            idx = tuple(slice(b * n, (b + 1) * n)
                        for b, n in zip(blk, t.shape))
            out[idx] = t.to(device)
        return out

    def numpy(self) -> np.ndarray:
        return to_numpy(self.gather("cpu"))

    def copy_(self, other: "ShardedArray") -> "ShardedArray":
        """Shard-by-shard copy of an array of the same layout."""
        for c, t in self.shards.items():
            t.copy_(other.shards[c], non_blocking=True)
        return self

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh})")


def make_mesh(devices, shape: Sequence[int],
              axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over ``devices`` in row-major order; a list
    shorter than the mesh repeats its devices cyclically (virtual
    shards)."""
    devices = [torch.device(d) for d in devices]
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    for i, d in zip(range(n), itertools.cycle(devices)):
        arr[i] = d
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def mesh_shape_2d(n: int) -> Tuple[int, int]:
    """The near-square 2-D ('x', 'y') shape of n devices."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def make_host_mesh(local_devices, shape: Sequence[int],
                   axis_names: Sequence[str], rank: int, world: int
                   ) -> Mesh:
    """The global mesh of ``shape`` over ``world`` processes, as this
    process (``rank``) sees it: process r holds the r-th run of
    ``size // world`` positions in row-major order, its own on
    ``local_devices`` in order (a shorter list repeats, as
    ``make_mesh``'s does).  A position of another process carries the
    device its owner gives it (the same index there), as a label."""
    n = int(np.prod(shape))
    if n % world:
        raise ValueError(f"a mesh of {n} positions does not divide over "
                         f"{world} processes")
    per = n // world
    local_devices = [torch.device(d) for d in local_devices]
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = local_devices[i % per % len(local_devices)]
    owners = np.arange(n) // per
    return Mesh(arr.reshape(tuple(shape)), axis_names,
                owners=owners.reshape(tuple(shape)), rank=rank)

"""A device mesh and the arrays sharded over it.

The counterparts of ``jax.sharding.Mesh``, ``PartitionSpec`` and a
sharded ``jax.Array`` for the port's single-controller domain
decomposition (``domain.py``): one process drives every shard, each
shard a tensor on its mesh position's device.  An entry of the mesh may
repeat a device ("virtual shards"): a 2 x 2 mesh on one GPU, or 8
shards on the CPU.  A mesh of distinct devices (one shard per GPU of a
node) takes the same code, but has not yet been run on distinct
devices.
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

    def __init__(self, devices, axis_names: Sequence[str]):
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

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every mesh position, row-major."""
        return list(np.ndindex(self.devices.shape))

    def device(self, coord: Coord) -> torch.device:
        return self.devices[tuple(coord)]

    def index(self, coord: Coord, axis: Optional[str]) -> int:
        """The position of ``coord`` along mesh axis ``axis`` (0 for
        None)."""
        return 0 if axis is None else coord[self.axis_names.index(axis)]

    def one_device(self) -> Optional[torch.device]:
        """The device every shard shares, or None."""
        devs = set(self.devices.flat)
        return next(iter(devs)) if len(devs) == 1 else None

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


class ShardedArray:
    """A global array held as one tensor per mesh position.

    ``spec[a]`` is the mesh axis array dim ``a`` is split over (None:
    whole); positions that differ only along axes the spec leaves out
    hold equal copies.  ``shape`` is the global shape."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...], shards: Dict[Coord, torch.Tensor]):
        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(shape)
        self.shards = shards

    @classmethod
    def place(cls, mesh: Mesh, spec, value) -> "ShardedArray":
        """``value`` (a numpy array or tensor, global shape) cut into the
        blocks ``spec`` gives each mesh position, each on its device."""
        t = to_torch(value)
        spec = tuple(spec) + (None,) * (t.ndim - len(spec))
        shards = {}
        for c in mesh.coords():
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

    def gather(self, device="cpu") -> torch.Tensor:
        """The global array on ``device``."""
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

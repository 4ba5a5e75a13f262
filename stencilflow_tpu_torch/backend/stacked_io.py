"""Shared plumbing of the streaming kernels (panel, overlap, stream).

Counterpart of ``stencilflow_tpu/backend/stacked_io.py``: how program
inputs enter a kernel and results leave it is the same for all — the
copy-BC centre read, the plain versions' global gathers and boundary
selects, and the wrapper that checks its tensors and either runs the
plain version (CPU tensors) or launches the generated CUDA kernel (CUDA
tensors, no fallback).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ir
from ..dtypes import is_narrow, to_torch, to_torch_dtype
from . import build
from .promotion import fill_value

THREADS = 256
# the stream kernel's ring spill (K3c): the most device memory one plan's
# spilled rings may take (every block's region of the spill buffer); a
# tile whose spill buffer is larger is refused
SPILL_BYTES_CAP = 4 << 30


def copy_group(itemsize: int, hk: int, K: int, shard=None):
    """(g, hk') for a ring input of ``itemsize``-byte cells loaded into
    slots of its own type (K1's, K3a's and K4's loader): it moves by
    ``cp.async`` in groups of ``g`` cells (8: 16 bytes, where its k-halo
    ``hk`` is a multiple of 8 already; else 2: 4 bytes), its k-halo
    widened to ``hk'``, the multiple of ``g`` at or above ``hk``, so
    that every group's global and shared addresses are multiples of its
    size (the plane's rows of ``K`` cells, a block's k origin, a
    multiple of 8, and the region's rows, its tile plus ``2 hk'``).
    ``shard`` = (Bk, xk): a shard's k core and exchanged k halo (its
    widened plane's rows of Bk + 2 xk cells start at global k origin -
    xk, every origin a multiple of Bk).  (1, hk) where that cannot be
    proven from the shapes (odd ``K``, a shard's odd core or halo, cells
    of 4 or 8 bytes, which the loader moves a cell a copy): the input
    keeps a cell a copy, synchronous for a 2-byte cell."""
    if itemsize != 2:
        return 1, hk
    for g in (8, 2):
        if (g == 8 and hk % 8) or K % g or (
                shard is not None and (shard[0] % g or shard[1] % g)):
            continue
        return g, -(-hk // g) * g
    return 1, hk


def check_aligned(arrays, groups) -> None:
    """Raise ValueError before a launch where an input that the kernel
    loads by ``cp.async`` groups (``groups``: input -> cells a group of
    2 bytes each) does not start at a multiple of the group's bytes:
    the copy would fault on a misaligned address.  There is no quiet
    switch to the synchronous loads."""
    for f, g in groups.items():
        if g > 1 and arrays[f].data_ptr() % (2 * g):
            raise ValueError(f"input {f!r} at {arrays[f].data_ptr():#x} is "
                             f"not aligned to the {2 * g}-byte copies the "
                             "kernel loads it by")


def accesses_with_center(kspec: ir.KernelSpec):
    """{field: offsets list}, with the copy-BC centre read added."""
    accs = {f: list(v) for f, v in kspec.accesses().items()}
    for f, bc in kspec.boundary_conditions.items():
        if bc.kind == ir.BCKind.COPY and f in accs:
            accs[f].append(tuple(0 if o is not None else None
                                 for o in accs[f][0]))
    return accs


def check_scope(program: ir.Program) -> None:
    """What the kernels refuse, with ValueError so that
    compile_chain_best takes the dense lowering: programs without an
    array input (the wrapper takes its device from one)."""
    if all(s.is_scalar for s in program.inputs.values()):
        raise ValueError("the kernels need an array input")


def check_ring_storage(ring_storage: str) -> None:
    """The JAX package's refusal of a ring storage it does not know."""
    if ring_storage not in ("off", "bfloat16"):
        raise ValueError(f"ring_storage must be 'off' or 'bfloat16', "
                         f"got {ring_storage!r}")


def rounded_rings(program: ir.Program, ring, ring_storage: str
                  ) -> frozenset:
    """The rings that round to bf16 at their store under
    ``ring_storage="bfloat16"``: the float32 fields of the ring set
    ``ring`` (f32 compute; other types are left alone, as the JAX
    package's ``rs_round`` leaves them)."""
    check_ring_storage(ring_storage)
    if ring_storage == "off":
        return frozenset()
    return frozenset(f for f in ring
                     if np.dtype(program.field_dtype(f)) == np.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even) and read back in
    its own float type: a bf16 ring's store and read."""
    return x.to(torch.bfloat16).to(x.dtype)


def first_fit(placed, size: int, mask: int) -> int:
    """The lowest offset where ``size`` bytes overlap no placed ``(offset,
    size, mask)`` live in a phase of ``mask``."""
    off = 0
    for o, n in sorted((o, n) for o, n, m in placed if m & mask):
        if o - off >= size:
            break
        off = max(off, o + n)
    return off


def place_by_phase(items, base: int, cap: int = 0):
    """Shared memory packed by liveness (the panel kernel's rings of one
    step, the spill rung's arena): first-fit ``(first phase, key, bytes,
    mask, early mask)`` items in order of their first phase, each live
    in ``early mask`` where that still ends by ``cap`` bytes (else in
    ``mask``): ({key: offset}, {key: mask}, {key: bytes}, end)."""
    placed, offset, live, size = [], {}, {}, {}
    for _p, key, nbytes, mask, early in sorted(items, key=lambda it: it[0]):
        at = first_fit(placed, nbytes, early)
        if base + at + nbytes <= cap:
            mask = early
        else:
            at = first_fit(placed, nbytes, mask)
        placed.append((at, nbytes, mask))
        offset[key], live[key], size[key] = base + at, mask, nbytes
    return offset, live, size, base + max((o + n for o, n, _m in placed),
                                          default=0)


def or_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def gather_global(arr: torch.Tensor, dim_mask, coords, dims):
    """``arr`` (spanned dims only) read at global ``coords`` (one python
    int or broadcastable tensor per dim), 0 where a target leaves the
    domain."""
    idx, inb = [], None
    for d in range(3):
        if not dim_mask[d]:
            continue
        c = coords[d]
        if isinstance(c, int):
            if not 0 <= c < dims[d]:
                inb = False
            idx.append(min(max(c, 0), dims[d] - 1))
        else:
            m = (c >= 0) & (c < dims[d])
            inb = m if inb is None or inb is True else (
                inb if inb is False else inb & m)
            idx.append(c.clamp(0, dims[d] - 1))
    val = arr[tuple(idx)]
    if inb is False:
        return torch.zeros_like(val)
    if inb is None:
        return val
    return torch.where(inb, val, torch.zeros((), dtype=arr.dtype,
                                             device=arr.device))


def bc_select(bc, dtype, mask, val, center_fn):
    """Apply a read's boundary condition under ``mask`` (python bool,
    tensor or None)."""
    if mask is None or mask is False:
        return val
    if bc is not None and bc.kind == ir.BCKind.COPY:
        center = center_fn()
        if mask is True:
            return center
        return torch.where(mask, center, val)
    fill = torch.tensor(fill_value(bc, dtype).item(),
                        dtype=to_torch_dtype(dtype), device=val.device)
    if mask is True:
        return fill.expand(val.shape)
    return torch.where(mask, fill, val)


def check_arrays(program: ir.Program, arrays, device_type: str,
                 dims=None, io_dtype=None):
    """Device, dtype (``io_dtype`` where given, else the input's), shape
    and contiguity of every array input (spanning ``dims``, the
    program's dimensions by default)."""
    dims = dims or program.dimensions
    for n, spec in program.inputs.items():
        if spec.is_scalar:
            continue
        a = arrays[n]
        shape = tuple(dims[d] for d in range(3) if spec.dim_mask[d])
        if a.device.type != device_type:
            raise ValueError(f"input {n!r} is on {a.device}, expected "
                             f"{device_type}")
        want = io_dtype or to_torch_dtype(spec.dtype)
        if a.dtype != want:
            raise TypeError(f"input {n!r} is {a.dtype}, expected {want}")
        if tuple(a.shape) != shape:
            raise ValueError(f"input {n!r} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"input {n!r} is not contiguous")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (an entry
    point built for the card never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU")
    return device


def run_kernel(program, arrays, lib, plain, extra=None, in_dims=None,
               out_dims=None, origin_i=None, origin_jk=None, io_dtype=None,
               out=None, groups=None):
    """Shared wrapper body: CPU tensors take ``plain``; CUDA tensors
    launch ``lib()``'s kernel or raise.  ``extra(device)`` gives device
    tensors the kernel reads after the array inputs.  Inputs span
    ``in_dims`` and outputs are ``out_dims`` (both the program's (I, J,
    K) by default); ``origin_i`` is the local kernel's launch argument,
    ``origin_jk`` a shard's (j, k) origin; ``io_dtype`` the torch type
    of the kernel's array inputs and outputs where it is not the
    program's (bf16 compute); ``out`` the output tensors to write
    (contiguous, of the outputs' shape and type; allocated otherwise);
    ``groups`` the plan's ``cp.async`` groups of 2-byte inputs
    (``check_aligned``).  Returns the outputs and whether the kernel was
    launched."""
    first = next(a for n, a in arrays.items()
                 if not program.inputs[n].is_scalar)
    if first.device.type == "cpu":
        check_arrays(program, arrays, "cpu", in_dims)
        got = plain()
        if out is None:
            return got, False
        for o in program.outputs:
            out[o].copy_(got[o])
        return dict(out), False
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    check_arrays(program, arrays, "cuda", in_dims, io_dtype)
    check_aligned(arrays, groups or {})
    dims = tuple(out_dims or program.dimensions)
    if out is None:
        outs = [torch.empty(dims, device=first.device, dtype=io_dtype
                            or to_torch_dtype(program.kernels[o].dtype))
                for o in program.outputs]
    else:
        outs = [out[o] for o in program.outputs]
        for o, t in zip(program.outputs, outs):
            if (tuple(t.shape) != dims or t.device != first.device
                    or not t.is_contiguous()):
                raise ValueError(f"output {o!r} buffer does not fit the "
                                 "kernel")
    build.launch(lib(), program, arrays,
                 [arrays[n] for n, s in program.inputs.items()
                  if not s.is_scalar]
                 + (list(extra(first.device)) if extra else []), outs,
                 origin_i=origin_i, origin_jk=origin_jk)
    return dict(zip(program.outputs, outs)), True


def has_narrow(program: ir.Program) -> bool:
    """Has ``program`` a field typed bfloat16 or float16?"""
    return any(is_narrow(program.field_dtype(n))
               for n in list(program.inputs) + list(program.kernels))


def launch_mode(program: ir.Program, rounds: bool = False,
                place: str = "") -> str:
    """The key a launch counts under in its kernel module's
    ``launches_by`` (a ``collections.Counter``): ``place`` (the stream
    kernel's "spill", "local" or "shard"; "" for the whole domain on
    chip) joined with "narrow" for a program with a bfloat16 or float16
    field, or "bf16" where the plan rounds (a ring, an output or its band
    operands to bf16); "exact" where neither applies.  (The stream
    kernel counts a plan under a compute type by ``stream.compute_key``.)"""
    kind = "narrow" if has_narrow(program) else "bf16" if rounds else ""
    return "_".join(k for k in (place, kind) if k) or "exact"


def spanned_arrays(program: ir.Program, inputs, device=None):
    """Inputs as tensors at their spanned shapes (scalars stay 0-d
    host values)."""
    dims = program.dimensions
    out = {}
    for n, spec in program.inputs.items():
        v = inputs[n]
        if spec.is_scalar:
            out[n] = to_torch(v) if not torch.is_tensor(v) else v
            continue
        v = v.to(device) if torch.is_tensor(v) else to_torch(v, device)
        out[n] = v.reshape(tuple(dims[d] for d in range(3)
                                 if spec.dim_mask[d])).contiguous()
    return out

"""Shared plumbing of the streaming kernels (panel, overlap, stream).

Counterpart of ``stencilflow_tpu/backend/stacked_io.py``: how program
inputs enter a kernel and results leave it is the same for all — the
copy-BC centre read, the planner's cost model, the plain versions'
global gathers and boundary selects, and the wrapper that checks its
tensors and either runs the plain version (CPU tensors) or launches the
generated CUDA kernel (CUDA tensors, no fallback).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import ir
from ..config import H100_SM_COUNT, H100_SMEM_PER_SM
from ..dtypes import to_torch_dtype
from . import build
from .promotion import check_kernel_dtypes, fill_value

THREADS = 256
# the stream kernel's ring spill (K3c): the most device memory one plan's
# spilled rings may take (every block's region of the spill buffer); a
# tile whose spill buffer is larger is refused
SPILL_BYTES_CAP = 4 << 30


def accesses_with_center(kspec: ir.KernelSpec):
    """{field: offsets list}, with the copy-BC centre read added."""
    accs = {f: list(v) for f, v in kspec.accesses().items()}
    for f, bc in kspec.boundary_conditions.items():
        if bc.kind == ir.BCKind.COPY and f in accs:
            accs[f].append(tuple(0 if o is not None else None
                                 for o in accs[f][0]))
    return accs


def check_scope(program: ir.Program) -> None:
    """What the kernels refuse, with ValueError / NotImplementedError so
    that compile_chain_best takes the dense lowering: float16 fields, and
    programs without an array input (the wrapper takes its device from
    one)."""
    check_kernel_dtypes(program)
    if all(s.is_scalar for s in program.inputs.values()):
        raise ValueError("the kernels need an array input")


def wave_cost(n_blocks: int, smem: int, work: int) -> float:
    """Planner cost of a tile: the blocks resident on one SM share it, so
    time goes as waves x blocks per SM x per-block work (cells), scaled
    up when fewer than 16 warps per SM are left to hide latency.  A model
    to be calibrated on the card, not a measurement."""
    per_sm = max(1, min(2048 // THREADS,
                        H100_SMEM_PER_SM // (smem + 1024)))
    waves = math.ceil(n_blocks / (H100_SM_COUNT * per_sm))
    latency = max(1.0, 16 / (per_sm * THREADS // 32))
    return waves * per_sm * work * latency


def tile_cost(n_blocks: int, smem: int, work: int) -> float:
    """``wave_cost`` with the blocks resident on one SM capped by the
    blocks there are to spread (ceil(n_blocks / 132)).  A grid of fewer
    blocks than the SMs' slots leaves warps idle: on an H100 SXM (700 W),
    ``python -m stencilflow_tpu_torch.sweep`` ran the stream kernel on
    box-r2 256^3 x 8 at (64, 8), 128 blocks, in 3.61 ms and at (32, 8),
    256 blocks, in 2.55 ms, which plain wave_cost ranks the other way
    round."""
    per_sm = max(1, min(2048 // THREADS, H100_SMEM_PER_SM // (smem + 1024),
                        -(-n_blocks // H100_SM_COUNT)))
    waves = math.ceil(n_blocks / (H100_SM_COUNT * per_sm))
    latency = max(1.0, 16 / (per_sm * THREADS // 32))
    return waves * per_sm * work * latency


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
                 dims=None):
    """Device, dtype, shape and contiguity of every array input (spanning
    ``dims``, the program's dimensions by default)."""
    dims = dims or program.dimensions
    for n, spec in program.inputs.items():
        if spec.is_scalar:
            continue
        a = arrays[n]
        shape = tuple(dims[d] for d in range(3) if spec.dim_mask[d])
        if a.device.type != device_type:
            raise ValueError(f"input {n!r} is on {a.device}, expected "
                             f"{device_type}")
        if a.dtype != to_torch_dtype(spec.dtype):
            raise TypeError(f"input {n!r} is {a.dtype}, expected "
                            f"{to_torch_dtype(spec.dtype)}")
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
               out_dims=None, origin_i=None):
    """Shared wrapper body: CPU tensors take ``plain``; CUDA tensors
    launch ``lib()``'s kernel or raise.  ``extra(device)`` gives device
    tensors the kernel reads after the array inputs.  Inputs span
    ``in_dims`` and outputs are ``out_dims`` (both the program's (I, J,
    K) by default); ``origin_i`` is the local kernel's launch argument.
    Returns the outputs and whether the kernel was launched."""
    first = next(a for n, a in arrays.items()
                 if not program.inputs[n].is_scalar)
    if first.device.type == "cpu":
        check_arrays(program, arrays, "cpu", in_dims)
        return plain(), False
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    check_arrays(program, arrays, "cuda", in_dims)
    outs = [torch.empty(out_dims or program.dimensions, device=first.device,
                        dtype=to_torch_dtype(program.kernels[o].dtype))
            for o in program.outputs]
    build.launch(lib(), program, arrays,
                 [arrays[n] for n, s in program.inputs.items()
                  if not s.is_scalar]
                 + (list(extra(first.device)) if extra else []), outs,
                 origin_i=origin_i)
    return dict(zip(program.outputs, outs)), True


def spanned_arrays(program: ir.Program, inputs, device=None):
    """Inputs as tensors at their spanned shapes (scalars stay 0-d
    host values)."""
    dims = program.dimensions
    out = {}
    for n, spec in program.inputs.items():
        v = inputs[n]
        if spec.is_scalar:
            out[n] = torch.as_tensor(np.asarray(v)) if not \
                torch.is_tensor(v) else v
            continue
        v = torch.as_tensor(v, device=device)
        out[n] = v.reshape(tuple(dims[d] for d in range(3)
                                 if spec.dim_mask[d])).contiguous()
    return out

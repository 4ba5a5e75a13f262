"""Torch evaluator of a stencil chain over halo-widened tiles.

Port of ``stencilflow_tpu/backend/tile_eval.py``: the same widened-tile
semantics (out-of-tile reads wrap into the tile's invalid margin, which
each stage's radius shrinks and never reaches the core; out-of-*domain*
reads are fixed up with boundary-condition masks over global
coordinates), evaluated with torch ops on any device.  It is the plain
evaluator of the port: ``dense.py`` runs the whole padded domain as one
tile, and the plain versions of the panel and overlap kernels run their
block schedules through ``eval_kernel_statements``.

Every value travels with its numpy type (promotion.py), and each op
casts its operands to the oracle's result dtype before computing, so
results match the numpy oracle bit for bit wherever torch's elementwise
ops are IEEE-exact (+ - * / sqrt, comparisons, selects, min/max, abs).
The narrow floats need nothing more: torch's bfloat16 and float16 ops
compute in float32 and round the result once, as numpy's float16 and
ml_dtypes' bfloat16 do, and its conversions to bf16 pass through float32
as ml_dtypes' do.  Only float64 -> float16 differs (numpy rounds once,
torch through float32): ``to_dtype`` rounds to odd first.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ir
from ..dtypes import (is_floating, is_narrow, scalar, to_numpy_dtype,
                      to_torch_dtype)
from ..frontend.chain import ChainGraph
from .promotion import (BOOL, F32, I32, WEAK_FLOAT, canonical, compute_join,
                        compute_pin, const_dtype_of, const_type, fill_value,
                        is_bool, is_float, is_weak, result_type, strong,
                        weak, weak_value, xla_convert_scalar)

Vec3 = Tuple[int, int, int]


def device_const(value, tdt: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=tdt)`` on ``device``.  On a GPU the
    value, rounded on the host as ``torch.tensor`` rounds it, is written
    by a fill kernel, not copied from host memory: a copy waits for the
    device, which a CUDA graph capture refuses."""
    host = torch.tensor(value, dtype=tdt)
    if torch.device(device).type == "cpu":
        return host
    return torch.full((), host.item(), dtype=tdt, device=device)


def to_dtype(t: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    """``t.to(tdt)``, with float64 -> float16 rounded once as numpy
    rounds it: to float32 rounding to odd (the inexact low bit set),
    then to float16 (float32 keeps more than 11 + 2 bits)."""
    if t.dtype != torch.float64 or tdt != torch.float16:
        return t if t.dtype == tdt else t.to(tdt)
    f = t.to(torch.float32)
    back = f.to(torch.float64)
    inexact = (back != t) & (t == t)
    bits = f.view(torch.int32)
    bits = torch.where(inexact & (back.abs() > t.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(torch.float16)


def as_type(value, ty_from, ty_to, device):
    """``value`` (a tensor, or a python number when ``ty_from`` is weak)
    converted to the strong numpy dtype ``ty_to`` as a tensor."""
    tdt = to_torch_dtype(ty_to)
    if is_weak(ty_from) and is_narrow(ty_to):
        value = scalar(value, ty_to)   # rounded as numpy rounds it
    if is_weak(ty_from) or not torch.is_tensor(value):
        return device_const(value, tdt, device)
    return to_dtype(value, tdt)


def _global_oob_mask(offsets: ir.Offsets, tile_shape: Sequence[int],
                     origin: Sequence[int], halo: Vec3, dimensions: Vec3,
                     device, cache: Optional[dict] = None):
    """Mask of widened-tile positions whose shifted read leaves the domain.

    Global coordinate of widened-tile cell x in dim d is
    ``origin[d] + x_d - halo[d]``; the read targets global + offset."""
    key = (tuple(offsets), tuple(tile_shape))
    if cache is not None and key in cache:
        return cache[key]
    mask = None
    for d, o in enumerate(offsets):
        if o is None:
            continue
        if (o == 0 and origin[d] - halo[d] == 0
                and tile_shape[d] == dimensions[d]):
            continue   # statically in bounds
        shape = [1] * len(tile_shape)
        shape[d] = tile_shape[d]
        g = torch.arange(tile_shape[d], device=device).reshape(shape) \
            + (origin[d] - halo[d] + o)
        m = (g < 0) | (g >= dimensions[d])
        mask = m if mask is None else (mask | m)
    if mask is not None:
        mask = mask.expand(tuple(tile_shape))
    if cache is not None:
        cache[key] = mask
    return mask


def read_access_tile(buf, offsets: ir.Offsets,
                     bc: Optional[ir.BoundaryCondition],
                     origin: Sequence[int], halo: Vec3, dimensions: Vec3,
                     cache: Optional[dict] = None):
    """Materialize ``field[x + o]`` over a widened tile with its BC applied."""
    shifted = buf
    for d, o in enumerate(offsets):
        if o:
            shifted = torch.roll(shifted, -o, dims=d)
    mask = _global_oob_mask(offsets, buf.shape, origin, halo, dimensions,
                            buf.device, cache)
    if mask is None:
        return shifted
    if bc is not None and bc.kind == ir.BCKind.COPY:
        return torch.where(mask, buf, shifted)
    fill = fill_value(bc, to_numpy_dtype(buf.dtype))
    return torch.where(mask, device_const(fill.item(), buf.dtype,
                                          buf.device), shifted)


class _Abs(torch.autograd.Function):
    """``torch.abs`` differentiated as JAX differentiates ``abs``:
    ``select(x >= 0, g, -g)``, so the derivative at 0 is 1 (torch's own
    is 0).  Used where the operand requires grad."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


_BINOPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mult": torch.mul,
    "div": torch.div,
}

_CMPOPS = {
    "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
}

_CALLS: Dict[str, Callable] = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
}

_FOLD = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mult": lambda a, b: a * b, "div": lambda a, b: a / b,
}


def eval_expr_generic(expr: ir.Expr, env: Dict[str, Any], read_fn,
                      pin: np.dtype, device):
    """Walk one expression; returns ``(value, type)``.

    ``read_fn(field, offsets)`` materializes an Access as a tensor of the
    field's dtype; Refs resolve through ``env``; float constants pin to
    ``pin`` (const_dtype_of)."""
    def rec(e):
        return eval_expr_generic(e, env, read_fn, pin, device)

    def cast(v, ty_from, ty_to):
        return as_type(v, ty_from, ty_to, device)

    if isinstance(expr, ir.Const):
        return const_type(expr.value, pin)
    if isinstance(expr, ir.Ref):
        return env[expr.name]
    if isinstance(expr, ir.Access):
        val, dt = read_fn(expr.field, expr.offsets)
        return val, dt
    if isinstance(expr, ir.BinOp):
        (a, at), (b, bt) = rec(expr.left), rec(expr.right)
        if is_weak(at) and is_weak(bt):
            v = _FOLD[expr.op](at[1], bt[1])
            return v, weak(v)
        ty = result_type(at, bt)
        if expr.op == "div" and not is_float(ty):
            ty = np.dtype(np.float64)   # numpy true division
        a, b = cast(a, at, ty), cast(b, bt, ty)
        if is_bool(ty):
            if expr.op == "add":
                return a | b, ty
            if expr.op == "mult":
                return a & b, ty
            raise TypeError("numpy rejects bool - bool and bool / bool")
        return _BINOPS[expr.op](a, b), ty
    if isinstance(expr, ir.UnaryOp):
        a, at = rec(expr.operand)
        if is_weak(at):
            return -at[1], weak(-at[1])
        if is_bool(at):
            raise TypeError("numpy rejects unary minus on bool")
        return torch.neg(a), at
    if isinstance(expr, ir.Compare):
        (a, at), (b, bt) = rec(expr.left), rec(expr.right)
        ty = strong(result_type(at, bt))
        return _CMPOPS[expr.op](cast(a, at, ty), cast(b, bt, ty)), \
            np.dtype(np.bool_)
    if isinstance(expr, ir.BoolOp):
        parts = [rec(o) for o in expr.operands]
        ty = parts[0][1]
        for _, t in parts[1:]:
            ty = result_type(ty, t)
        ty = strong(ty)
        if is_float(ty):
            raise TypeError("numpy rejects bitwise and/or on floats")
        acc = cast(*parts[0], ty)
        for v, t in parts[1:]:
            v = cast(v, t, ty)
            acc = (acc & v) if expr.op == "and" else (acc | v)
        return acc, ty
    if isinstance(expr, ir.Select):
        c, ct = rec(expr.cond)
        (t, tt), (f, ft) = rec(expr.if_true), rec(expr.if_false)
        ty = strong(result_type(tt, ft, ufunc=False))
        c = cast(c, ct, ct if not is_weak(ct) else strong(ct))
        if c.dtype != torch.bool:
            c = c != 0
        return torch.where(c, cast(t, tt, ty), cast(f, ft, ty)), ty
    if isinstance(expr, ir.Call):
        args = [rec(a) for a in expr.args]
        if expr.fn in ("min", "max"):
            (a, at), (b, bt) = args
            ty = strong(result_type(at, bt))
            fn = torch.minimum if expr.fn == "min" else torch.maximum
            return fn(cast(a, at, ty), cast(b, bt, ty)), ty
        (a, at), = args
        if expr.fn == "abs":
            if is_bool(at):
                return a, at
            ty = strong(at)
            a = cast(a, at, ty)
            return (_Abs.apply(a) if a.requires_grad else torch.abs(a)), ty
        ty = at if is_float(at) and not is_weak(at) else np.dtype(np.float64)
        return _CALLS[expr.fn](cast(a, at, ty)), ty
    raise TypeError(f"unknown expression node {type(expr)}")


def carrier(ty) -> torch.dtype:
    """The torch type a value of node type ``ty`` travels in under a
    compute type: float32 for every float (a narrow value is held
    exactly), the type itself otherwise."""
    ty = np.dtype(ty)
    return torch.float32 if is_floating(ty) else to_torch_dtype(ty)


def round_to(x: torch.Tensor, ty) -> torch.Tensor:
    """A float32 tensor rounded to the float type ``ty`` (to nearest,
    ties to even), still float32."""
    if not is_narrow(ty):
        return x
    return x.to(to_torch_dtype(ty)).to(torch.float32)


def xla_convert(v: torch.Tensor, frm, to) -> torch.Tensor:
    """A carried value of type ``frm`` as one of ``to``, as XLA converts
    (promotion.xla_convert_scalar): to bool ``!= 0``, float to integer
    truncated and saturated with NaN at 0, integer to float through
    float32, integer to integer wrapped."""
    frm, to = np.dtype(frm), np.dtype(to)
    if frm == to:
        return v
    if to.kind == "b":
        return v != 0
    if is_floating(to):
        return round_to(v.to(torch.float32), to)
    if is_floating(frm):
        info = np.iinfo(to)
        x = v.to(torch.float64)
        x = torch.where(x == x, x, torch.zeros_like(x))
        return x.trunc().clamp(info.min, info.max).to(carrier(to))
    return v.to(carrier(to))


def to_compute(v: torch.Tensor, frm, compute) -> torch.Tensor:
    """An array of the program's type ``frm`` as the JAX package casts it
    to ``compute`` before the kernel: canonicalised to its 32-bit type
    (float64 rounded to float32, int64 wrapped), then converted."""
    frm = np.dtype(frm)
    mid = canonical(frm)
    if v.dtype != carrier(mid):
        v = v.to(carrier(mid))
    return xla_convert(v, mid, compute)


def from_compute(v: torch.Tensor, compute, kdt) -> torch.Tensor:
    """An output plane of ``compute`` as the program's kernel type
    ``kdt``: converted to its 32-bit type, as the JAX package's outputs
    leave, then held in ``kdt`` (a float64 output widens exactly)."""
    kdt = np.dtype(kdt)
    v = xla_convert(v, compute, canonical(kdt))
    return v.to(to_torch_dtype(kdt))


def _operand(v, ty_from, ty_to, device) -> torch.Tensor:
    """Operand ``v`` of node type ``ty_from`` at a site of ``ty_to``: a
    weak scalar converted as jnp converts it, a constant as XLA does,
    a tensor by ``xla_convert``."""
    if is_weak(ty_from):
        return device_const(weak_value(ty_from, ty_to).item(),
                            carrier(ty_to), device)
    if not torch.is_tensor(v):
        return device_const(xla_convert_scalar(v, ty_from, ty_to).item(),
                            carrier(ty_to), device)
    return xla_convert(v, ty_from, ty_to)


def _weak_fold_call(fn: str, ty):
    """A transcendental of a Python literal: jnp gives a weakly typed
    float32, kept here as a weak float of that value."""
    v = float(_CALLS[fn](torch.tensor(float(ty[1]), dtype=torch.float32)))
    return v, (WEAK_FLOAT, v)


def eval_expr_compute(expr: ir.Expr, env: Dict[str, Any], read_fn, device,
                      compute, pin):
    """``eval_expr_generic`` under the compute type ``compute`` (a numpy
    dtype), the stream kernel's ``compute_dtype``: array reads are of
    that type, scalar inputs of their own 32-bit type, float constants
    of ``pin`` (``promotion.compute_pin``); each site takes jnp's type
    (``promotion.compute_join``), a float site computes in float32 and
    rounds its result to its type, an integer one wraps, a bool ``+``
    and ``*`` are or and and.  Values travel as ``carrier`` tensors
    (weak scalars as Python numbers, constants as numpy scalars).
    Raises TypeError where jnp raises (bool minus, bitwise and/or of
    floats)."""
    def rec(e):
        return eval_expr_compute(e, env, read_fn, device, compute, pin)

    def opnd(v, ty_from, ty_to):
        return _operand(v, ty_from, ty_to, device)

    if isinstance(expr, ir.Const):
        return const_type(expr.value, pin)
    if isinstance(expr, ir.Ref):
        return env[expr.name]
    if isinstance(expr, ir.Access):
        val, dt = read_fn(expr.field, expr.offsets)
        if val.ndim == 0:   # a scalar input keeps its own type
            ty = canonical(dt)
            return val.to(carrier(ty)), ty
        return val, np.dtype(compute)
    if isinstance(expr, ir.BinOp):
        (a, at), (b, bt) = rec(expr.left), rec(expr.right)
        if is_weak(at) and is_weak(bt):
            v = _FOLD[expr.op](at[1], bt[1])
            return v, weak(v)
        ty = compute_join(at, bt)
        if expr.op == "div" and not is_floating(ty):
            ty = F32   # jnp's true division of integers
        a, b = opnd(a, at, ty), opnd(b, bt, ty)
        if is_bool(ty):
            if expr.op == "add":
                return a | b, ty
            if expr.op == "mult":
                return a & b, ty
            raise TypeError("jnp rejects bool - bool")
        r = _BINOPS[expr.op](a, b)
        return (round_to(r, ty) if is_floating(ty) else r), ty
    if isinstance(expr, ir.UnaryOp):
        a, at = rec(expr.operand)
        if is_weak(at):
            return -at[1], weak(-at[1])
        if is_bool(at):
            raise TypeError("jnp rejects unary minus on bool")
        if not torch.is_tensor(a):
            a = opnd(a, at, at)
        return torch.neg(a), at
    if isinstance(expr, ir.Compare):
        (a, at), (b, bt) = rec(expr.left), rec(expr.right)
        ty = compute_join(at, bt)
        if is_weak(ty):
            ty = F32 if ty[0] == WEAK_FLOAT else I32
        return _CMPOPS[expr.op](opnd(a, at, ty), opnd(b, bt, ty)), BOOL
    if isinstance(expr, ir.BoolOp):
        parts = [rec(o) for o in expr.operands]
        ty = compute_join(*[t for _v, t in parts])
        if is_weak(ty):
            ty = F32 if ty[0] == WEAK_FLOAT else I32
        if is_floating(ty):
            raise TypeError("jnp rejects bitwise and/or on floats")
        acc = opnd(*parts[0], ty)
        for v, t in parts[1:]:
            v = opnd(v, t, ty)
            acc = (acc & v) if expr.op == "and" else (acc | v)
        return acc, ty
    if isinstance(expr, ir.Select):
        c, ct = rec(expr.cond)
        (t, tt), (f, ft) = rec(expr.if_true), rec(expr.if_false)
        c = opnd(c, ct, BOOL)
        ty = compute_join(tt, ft)
        if is_weak(ty):
            ty = F32 if ty[0] == WEAK_FLOAT else I32
        return torch.where(c, opnd(t, tt, ty), opnd(f, ft, ty)), ty
    if isinstance(expr, ir.Call):
        args = [rec(a) for a in expr.args]
        if expr.fn in ("min", "max"):
            (a, at), (b, bt) = args
            if is_weak(at) and is_weak(bt):
                v = (min if expr.fn == "min" else max)(at[1], bt[1])
                return v, weak(v)
            ty = compute_join(at, bt)
            a, b = opnd(a, at, ty), opnd(b, bt, ty)
            if is_bool(ty):
                return ((a & b) if expr.fn == "min" else (a | b)), ty
            fn = torch.minimum if expr.fn == "min" else torch.maximum
            return fn(a, b), ty
        (a, at), = args
        if is_weak(at):
            if expr.fn == "abs":
                return abs(at[1]), weak(abs(at[1]))
            return _weak_fold_call(expr.fn, at)
        a = opnd(a, at, at)
        if expr.fn == "abs":
            return (a if is_bool(at) else torch.abs(a)), at
        ty = at if is_floating(at) else F32
        return round_to(_CALLS[expr.fn](opnd(a, at, ty)), ty), ty
    raise TypeError(f"unknown expression node {type(expr)}")


def eval_kernel_statements(kspec: ir.KernelSpec, read_fn, shape, device,
                           compute=None):
    """Evaluate a kernel's statements with a custom read; returns the
    output statement's value broadcast to ``shape`` and cast to the
    kernel dtype.  ``compute``: under that compute type (a numpy dtype,
    ``eval_expr_compute``), the result converted to it, as its
    ``carrier`` tensor."""
    if compute is not None:
        pin = compute_pin(kspec)
        env: Dict[str, Any] = {}
        for stmt in kspec.statements:
            env[stmt.lhs] = eval_expr_compute(stmt.rhs, env, read_fn,
                                              device, compute, pin)
        val, ty = env[kspec.output_statement.lhs]
        if is_weak(ty):   # jnp.asarray: int32 or float32, then the cast
            base = F32 if ty[0] == WEAK_FLOAT else I32
            val, ty = weak_value(ty, base), base
        val = _operand(val, ty, compute, device)
        return val.expand(tuple(shape))
    pin = const_dtype_of(kspec)
    env = {}
    for stmt in kspec.statements:
        env[stmt.lhs] = eval_expr_generic(stmt.rhs, env, read_fn, pin,
                                          device)
    val, ty = env[kspec.output_statement.lhs]
    val = as_type(val, ty, strong(ty), device)
    return to_dtype(val, to_torch_dtype(kspec.dtype)).expand(tuple(shape))


def broadcast_input_tile(arr, dim_mask: Tuple[bool, bool, bool],
                         tile_shape: Vec3):
    """Expand a lower-dimensional input's tile slice to the full widened-tile
    shape (size-1 in unspanned dims, broadcast)."""
    if arr.ndim == 0:
        return arr
    shape = tuple(t if m else 1 for t, m in zip(tile_shape, dim_mask))
    return arr.reshape(shape).expand(tuple(tile_shape))


def evaluate_chain_tile(program: ir.Program, graph: ChainGraph,
                        tile_fields: Dict[str, Any],
                        origin: Sequence[int], halo: Vec3,
                        keep: Optional[Sequence[str]] = None
                        ) -> Dict[str, Any]:
    """Evaluate every kernel of ``graph.kernel_order`` over one widened
    tile.

    ``tile_fields`` maps each program input the evaluated kernels read
    to its widened-tile tensor (spanned dims only for lower-dimensional
    inputs, 0-d for scalars), and may also hold precomputed upstream
    kernel tiles (a pipeline segment's carried fields,
    ``parallel/pipeline.py``); ``origin`` is the global offset of the
    tile core.  Returns kernel results at the widened tile shape: the
    program outputs, or the kernels ``keep`` names."""
    dims = program.dimensions
    tile_shape = None
    device = None
    given = {n: s for n, s in program.inputs.items() if n in tile_fields}
    for iname, spec in given.items():
        if not spec.is_scalar:
            device = tile_fields[iname].device
            if all(spec.dim_mask):
                tile_shape = tuple(tile_fields[iname].shape)
    if tile_shape is None:   # a carried kernel tile is full rank
        for name, arr in tile_fields.items():
            if name in program.kernels:
                tile_shape, device = tuple(arr.shape), arr.device
                break
    if tile_shape is None:
        guess = [(dims[d] + 2 * halo[d]) if dims[d] > 1 else 1
                 for d in range(3)]
        for iname, spec in given.items():
            if spec.is_scalar:
                continue
            it = iter(tile_fields[iname].shape)
            for d, m in enumerate(spec.dim_mask):
                if m:
                    guess[d] = next(it)
        tile_shape = tuple(guess)
    fields: Dict[str, Any] = {}
    for iname, spec in given.items():
        arr = tile_fields[iname]
        if spec.is_scalar and device is not None and arr.device != device:
            arr = arr.to(device) if arr.requires_grad else \
                device_const(arr.item(), arr.dtype, device)
        fields[iname] = arr if spec.is_scalar else \
            broadcast_input_tile(arr, spec.dim_mask, tile_shape)
    for name, arr in tile_fields.items():   # precomputed upstream tiles
        fields.setdefault(name, arr)

    names = list(keep) if keep is not None else list(program.outputs)
    order = graph.kernel_order
    last_use: Dict[str, int] = {}
    for idx, kname in enumerate(order):
        for f in program.kernels[kname].accesses():
            last_use[f] = idx

    mask_cache: Dict[Any, Any] = {}
    for idx, kname in enumerate(order):
        kspec = program.kernels[kname]

        def read_fn(field, offsets, bcs=kspec.boundary_conditions):
            buf = fields[field]
            dt = np.dtype(program.field_dtype(field))
            if buf.ndim == 0:
                return buf, dt
            return read_access_tile(buf, offsets, bcs.get(field), origin,
                                    halo, dims, mask_cache), dt

        fields[kname] = eval_kernel_statements(kspec, read_fn, tile_shape,
                                               device)
        for f in [f for f, last in last_use.items() if last == idx]:
            if f not in names and f in program.kernels:
                del fields[f]
    return {n: fields[n] for n in names}

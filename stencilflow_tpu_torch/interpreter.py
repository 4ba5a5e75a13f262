"""Whole-domain chain interpreter — the framework's numerical oracle.

Evaluates every kernel of a program over the full (padded 3-D) domain in
topological order, with exact boundary-condition semantics matching the
reference's CPU backend (stencilflow/stencil/cpu.py:58-102):

* an access ``f[x + o]`` is out-of-bounds iff for some spanned dim ``d``,
  ``x_d + o_d`` falls outside ``[0, D_d)``;
* ``constant`` BC: OOB reads yield the configured value;
* ``copy`` BC: OOB reads yield the field's center value ``f[x]``;
* ``shrink`` BC: OOB reads yield JUNK_VAL (caller prunes the halo).

This is the port's copy of ``stencilflow_tpu/interpreter.py`` in its numpy
mode only (bit-exact CPU oracle, float64 capable): the jax.numpy mode and its
narrow-float rounding hooks are dropped, the mixed int x float promotion
(``_match_mixed``) and the float-constant pinning are kept unchanged.

float16 is numpy's own: each op computes in float32 and rounds to float16.
bfloat16 is not (``dtypes.BFLOAT16`` only carries bits), so a bf16 value
is evaluated as ``_Bf16``, the float32 values it holds, and each site that
meets one takes its type from the lattice ml_dtypes gives the JAX
package's oracle (``promotion.result_type``): a bf16 result computes in
float32 and rounds to bf16, once, as an ml_dtypes ufunc does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import ir
from .backend.promotion import result_type, weak
from .config import JUNK_VAL
from .dtypes import BFLOAT16, cast, round_bf16, to_float32
from .frontend.chain import ChainGraph

_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mult": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}

_CMPOPS = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def _call_table(xp):
    return {
        "sin": xp.sin, "cos": xp.cos, "tan": xp.tan,
        "sinh": xp.sinh, "cosh": xp.cosh, "tanh": xp.tanh,
        "sqrt": xp.sqrt, "exp": xp.exp, "log": xp.log,
        "abs": xp.abs,
        "min": xp.minimum, "max": xp.maximum,
    }


def _match_mixed(a, b):
    """Mixed int x float promotion — the framework's defined semantics
    (spec'd round 5, ADVICE r4): a STRONG integer/bool operand meeting a
    STRONG floating operand converts to that float dtype before the op,
    i.e. JAX's no-f64 lattice (int32 * float32 computes in float32).
    numpy's NEP 50 would widen int32/int64 x float32 to float64 — a
    compute dtype the TPU backends cannot express, so the jnp engines
    could never match the oracle bit-exactly on such programs.  Weak
    python scalars are untouched (NEP 50 already agrees with JAX there);
    float x float and int x int keep numpy semantics."""
    da = getattr(a, "dtype", None)
    db = getattr(b, "dtype", None)
    if da is None or db is None:
        return a, b
    from .dtypes import is_floating
    da, db = np.dtype(da), np.dtype(db)
    fa, fb = is_floating(da), is_floating(db)
    if fa and not fb and db.kind in "iub":
        return a, b.astype(da)
    if fb and not fa and da.kind in "iub":
        return a.astype(db), b
    return a, b


class _Bf16:
    """A bfloat16 value under evaluation: the float32 values it holds."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


def _type_of(x):
    """An operand's type in promotion.py's lattice."""
    if isinstance(x, _Bf16):
        return BFLOAT16
    if isinstance(x, (bool, np.bool_)):
        return np.dtype(np.bool_)
    if isinstance(x, (int, float)):
        return weak(x)
    return np.dtype(x.dtype)


def _as(x, ty):
    """Operand ``x`` as numpy values of type ``ty`` (bf16: float32)."""
    if isinstance(x, _Bf16):
        return x.v if ty == BFLOAT16 else x.v.astype(ty)
    if ty == BFLOAT16:
        return round_bf16(x)
    return np.asarray(x).astype(ty)


def _bf16_site(fn, a, b, rounds: bool = True):
    """``fn(a, b)`` where an operand is bf16: both as the site's type,
    then a bf16 result rounded and wrapped; a comparison (``rounds``
    False) gives its bools."""
    ty = result_type(_type_of(a), _type_of(b))
    r = fn(_as(a, ty), _as(b, ty))
    if ty != BFLOAT16 or not rounds:
        return r
    return _Bf16(round_bf16(r))


def _binary(fn, a, b, rounds: bool = True):
    if isinstance(a, _Bf16) or isinstance(b, _Bf16):
        return _bf16_site(fn, a, b, rounds=rounds)
    return fn(*_match_mixed(a, b))


def _broadcast_to_domain(xp, arr, dim_mask, dimensions):
    """Expand a (possibly lower-dimensional) field to the full 3-D domain."""
    arr = xp.asarray(arr)
    if all(dim_mask):
        return arr.reshape(dimensions)
    shape = tuple(d if m else 1 for d, m in zip(dimensions, dim_mask))
    return xp.broadcast_to(arr.reshape(shape), tuple(dimensions))


def _oob_mask(xp, offsets, dimensions):
    """Boolean mask of positions whose shifted read falls outside the domain
    (reference: cpu.py:71-78 — OOB iff p < -o or p >= D - o per dim)."""
    mask = None
    for d, o in enumerate(offsets):
        if o is None or o == 0:
            continue
        idx_shape = [1, 1, 1]
        idx_shape[d] = dimensions[d]
        idx = xp.arange(dimensions[d]).reshape(idx_shape)
        m = (idx < -o) if o < 0 else (idx >= dimensions[d] - o)
        mask = m if mask is None else (mask | m)
    if mask is None:
        return None
    return xp.broadcast_to(mask, tuple(dimensions))


def _shifted(xp, arr3, offsets, fill):
    """result[x] = arr3[x + o], OOB positions = fill."""
    if all(o is None or o == 0 for o in offsets):
        return arr3
    pads = []
    slices = []
    for d, o in enumerate(offsets):
        o = 0 if o is None else o
        if o >= 0:
            pads.append((0, o))
            slices.append(slice(o, o + arr3.shape[d]))
        else:
            pads.append((-o, 0))
            slices.append(slice(0, arr3.shape[d]))
    padded = xp.pad(arr3, pads, mode="constant", constant_values=fill)
    return padded[tuple(slices)]


def read_access(xp, arr3, offsets, bc: ir.BoundaryCondition, dimensions):
    """Materialize one relative access over the whole domain with its BC."""
    if bc is None or bc.kind == ir.BCKind.CONSTANT:
        fill = bc.value if bc is not None else 0.0
        return _shifted(xp, arr3, offsets, fill)
    if bc.kind == ir.BCKind.SHRINK:
        return _shifted(xp, arr3, offsets, JUNK_VAL)
    if bc.kind == ir.BCKind.COPY:
        shifted = _shifted(xp, arr3, offsets, 0.0)
        mask = _oob_mask(xp, offsets, dimensions)
        if mask is None:
            return shifted
        return xp.where(mask, arr3, shifted)
    raise ValueError(f"unknown boundary condition {bc!r}")


class ChainInterpreter:
    """Evaluates a parsed program end-to-end over full arrays."""

    def __init__(self, program: ir.Program,
                 graph: Optional[ChainGraph] = None):
        self.program = program
        self.graph = graph or ChainGraph.build(program)
        self.xp = np
        self.calls = _call_table(np)
        self._kdtype: Optional[np.dtype] = None

    # -- expression evaluation ------------------------------------------------
    def _eval(self, expr: ir.Expr, fields: Dict[str, Any],
              env: Dict[str, Any], bcs: Dict[str, ir.BoundaryCondition]):
        xp = self.xp
        if isinstance(expr, ir.Const):
            # Float consts are PINNED to a floating kernel's dtype in
            # every engine: under numpy a bare python float is a strong
            # f64 (NEP 50) that would widen the op; under jnp a weak
            # const DEMOTES against a narrower neighbor (weak f32 + bf16
            # -> bf16 in JAX's lattice, where the oracle computes f32).
            # A strong numpy scalar of the kernel dtype gives the same
            # bits as a weak const in uniform kernels and oracle-exact
            # promotion in mixed ones.
            if isinstance(expr.value, float) and self._kdtype is not None:
                if self._kdtype == BFLOAT16:
                    return _Bf16(round_bf16(np.float64(expr.value)))
                return self._kdtype.type(expr.value)
            return expr.value
        if isinstance(expr, ir.Ref):
            return env[expr.name]
        if isinstance(expr, ir.Access):
            arr3 = fields[expr.field]
            if isinstance(arr3, _Bf16):   # the fill rounds to bf16
                return _Bf16(round_bf16(read_access(
                    xp, arr3.v, expr.offsets, bcs.get(expr.field),
                    self.program.dimensions)))
            return read_access(xp, arr3, expr.offsets, bcs.get(expr.field),
                               self.program.dimensions)
        if isinstance(expr, ir.BinOp):
            return _binary(_BINOPS[expr.op],
                           self._eval(expr.left, fields, env, bcs),
                           self._eval(expr.right, fields, env, bcs))
        if isinstance(expr, ir.UnaryOp):
            v = self._eval(expr.operand, fields, env, bcs)
            return _Bf16(-v.v) if isinstance(v, _Bf16) else -v
        if isinstance(expr, ir.Compare):
            return _binary(_CMPOPS[expr.op],
                           self._eval(expr.left, fields, env, bcs),
                           self._eval(expr.right, fields, env, bcs),
                           rounds=False)
        if isinstance(expr, ir.BoolOp):
            vals = [self._eval(o, fields, env, bcs) for o in expr.operands]
            if any(isinstance(v, _Bf16) for v in vals):
                raise TypeError("bitwise and/or is not defined on bfloat16")
            acc = vals[0]
            for v in vals[1:]:
                acc = (acc & v) if expr.op == "and" else (acc | v)
            return acc
        if isinstance(expr, ir.Select):
            t = self._eval(expr.if_true, fields, env, bcs)
            f = self._eval(expr.if_false, fields, env, bcs)
            cond = self._eval(expr.cond, fields, env, bcs)
            if isinstance(cond, _Bf16):
                cond = cond.v != 0
            if isinstance(t, _Bf16) or isinstance(f, _Bf16):
                ty = result_type(_type_of(t), _type_of(f), ufunc=False)
                r = xp.where(cond, _as(t, ty), _as(f, ty))
                return _Bf16(r) if ty == BFLOAT16 else r
            t, f = _match_mixed(t, f)
            return (xp.where(cond, t, f))
        if isinstance(expr, ir.Call):
            args = [self._eval(a, fields, env, bcs) for a in expr.args]
            if len(args) == 2:   # min/max: binary ufunc-shaped sites
                return _binary(self.calls[expr.fn], *args)
            if isinstance(args[0], _Bf16):   # in float32, rounded once
                return _Bf16(round_bf16(self.calls[expr.fn](args[0].v)))
            return (self.calls[expr.fn](*args))
        raise TypeError(f"unknown expression node {type(expr)}")

    # -- kernel & chain evaluation ---------------------------------------------
    def eval_kernel(self, kname: str, fields: Dict[str, Any]):
        from .dtypes import is_floating
        kspec = self.program.kernels[kname]
        dt = np.dtype(kspec.dtype)
        # is_floating, not kind == "f": ml_dtypes bfloat16 has kind "V",
        # and an unpinned python-float const promotes a bf16 chain to
        # float32 under numpy (jnp keeps consts weak -> per-op bf16).
        # In NON-floating kernels float consts pin to float32 — the
        # framework's defined semantics: numpy would otherwise
        # materialize a weak const STRONG float64 inside np.where /
        # np.minimum, forcing f64 compute the TPU backends cannot
        # express, so f32 is the spec and every engine implements it.
        self._kdtype = dt if is_floating(dt) else np.dtype(np.float32)
        env: Dict[str, Any] = {}
        for stmt in kspec.statements:
            env[stmt.lhs] = self._eval(stmt.rhs, fields, env,
                                       kspec.boundary_conditions)
        result = env[kspec.output_statement.lhs]
        if isinstance(result, _Bf16):
            result = result.v
            if dt == BFLOAT16:   # already rounded: stays as it is
                return _Bf16(np.broadcast_to(
                    result, tuple(self.program.dimensions)))
        result = self.xp.asarray(result)
        if result.shape != tuple(self.program.dimensions):
            result = self.xp.broadcast_to(result,
                                          tuple(self.program.dimensions))
        if dt == BFLOAT16:
            return _Bf16(round_bf16(result))
        return result.astype(kspec.dtype)

    def __call__(self, inputs: Dict[str, Any],
                 keep_intermediates: bool = False) -> Dict[str, Any]:
        """Run the whole chain; returns outputs (or all kernel results)."""
        xp = self.xp
        fields: Dict[str, Any] = {}
        for iname, spec in self.program.inputs.items():
            value = inputs[iname]
            if np.dtype(spec.dtype) == BFLOAT16:
                value = to_float32(cast(value, BFLOAT16))
            if spec.is_scalar:
                fields[iname] = xp.asarray(value)
            else:
                fields[iname] = _broadcast_to_domain(
                    xp, value, spec.dim_mask, self.program.dimensions)
            if np.dtype(spec.dtype) == BFLOAT16:
                fields[iname] = _Bf16(fields[iname])
        for kname in self.graph.kernel_order:
            fields[kname] = self.eval_kernel(kname, fields)

        def out(k, shape=None):   # bf16 back to its bits
            v = fields[k]
            if isinstance(v, _Bf16):
                v = cast(v.v, BFLOAT16)
            return v if shape is None else v.reshape(shape)
        if keep_intermediates:
            return {k: out(k) for k in self.program.kernels}
        raw = self.program.raw_dimensions
        return {o: out(o, raw) for o in self.program.outputs}


def run_interpreter(program: ir.Program,
                    inputs: Dict[str, Any]) -> Dict[str, Any]:
    return ChainInterpreter(program)(inputs)

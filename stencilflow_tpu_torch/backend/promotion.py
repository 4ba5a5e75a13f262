"""The oracle's dtype lattice, node by node.

The numpy oracle (interpreter.py) evaluates every expression node with
numpy's NEP 50 promotion, plus the framework's mixed rule: a strong
integer/bool operand meeting a strong float converts to that float
(``interpreter._match_mixed``).  torch promotes differently (0-d tensors
rank below dimensioned ones, integer true division gives float32, bool +
bool is defined), so the port never lets torch or C++ promote: both the
torch evaluator (tile_eval.py) and the CUDA emitter (codegen.py) ask this
module for each node's numpy dtype and cast their operands to it first.

A node type is a numpy dtype (strong) or a weak python scalar
``(WEAK_INT | WEAK_FLOAT, value)``; weak types only arise from integer
constants and arithmetic folded over them (the parser pins float
constants to the kernel dtype, ``const_dtype_of``).  Same rules as the
JAX package's native simulator emitter (``sim/native.py _res_ty``).

The narrow floats: float16 is numpy's own, so NEP 50 types its sites.
bfloat16 (``dtypes.BFLOAT16``) takes the rows ml_dtypes gives the JAX
package's oracle: with float32 or float64 the wider float; with a strong
int or bool bf16 (the mixed rule); with a weak scalar float32 at a ufunc
site (ml_dtypes' loops compute there in float32) and at ``np.where``
bf16 for a weak int, float64 for a weak float (``np.result_type``); with
float16 float32 at a ufunc site (ml_dtypes' loops again) and no common
type at ``np.where`` (TypeError, as ``np.result_type`` refuses it).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from .. import ir
from ..dtypes import BFLOAT16, FLOAT16, is_floating, scalar

WEAK_INT, WEAK_FLOAT = "wi", "wf"


def is_weak(ty) -> bool:
    return isinstance(ty, tuple)


def is_float(ty) -> bool:
    if is_weak(ty):
        return ty[0] == WEAK_FLOAT
    return is_floating(ty)


def is_bool(ty) -> bool:
    return not is_weak(ty) and np.dtype(ty).kind == "b"


def weak(value) -> tuple:
    if isinstance(value, (bool, np.bool_)):
        raise TypeError("bool constants are strong")
    if isinstance(value, (int, np.integer)):
        return (WEAK_INT, int(value))
    return (WEAK_FLOAT, float(value))


def strong(ty) -> np.dtype:
    """numpy functions (np.where, np.minimum, np.abs) materialize weak
    python scalars as strong int64 / float64."""
    if not is_weak(ty):
        return np.dtype(ty)
    return np.dtype(np.int64 if ty[0] == WEAK_INT else np.float64)


def result_type(*tys, ufunc: bool = True) -> Any:
    """Result type of a binary site: NEP 50, except that a strong
    int/bool meeting a strong float takes that float dtype.  ``ufunc``
    False: an ``np.where`` site (it differs for bf16 and a weak scalar)."""
    if all(is_weak(t) for t in tys):
        return (WEAK_FLOAT, None) if any(t[0] == WEAK_FLOAT for t in tys) \
            else (WEAK_INT, None)
    strongs = [np.dtype(t) for t in tys if not is_weak(t)]
    if BFLOAT16 in strongs:
        return _bf16_result(tys, strongs, ufunc)
    flts = [t for t in strongs if is_floating(t)]
    if flts and any(t.kind in "iub" for t in strongs):
        return np.result_type(*flts)
    args = [(1 if t[0] == WEAK_INT else 1.0) if is_weak(t) else t
            for t in tys]
    return np.result_type(*args)


def _bf16_result(tys, strongs, ufunc: bool) -> np.dtype:
    others = [t for t in strongs if t != BFLOAT16]
    if FLOAT16 in others and not ufunc:
        raise TypeError("bfloat16 meets float16: the two have no common "
                        "type at an np.where site (numpy's result_type "
                        "refuses them, as the JAX package's oracle does)")
    # at a ufunc site ml_dtypes' loops compute the pair in float32
    flts = [t for t in others if t.kind == "f"]
    if flts:
        return np.result_type(np.float32, *flts)
    weaks = [t for t in tys if is_weak(t)]
    if weaks and ufunc:
        return F32
    if any(t[0] == WEAK_FLOAT for t in weaks):
        return np.dtype(np.float64)
    return BFLOAT16


def const_dtype_of(kspec: ir.KernelSpec) -> np.dtype:
    """Pin dtype for a kernel's float constants: the kernel dtype when it
    is floating, else float32 (the oracle's rule, interpreter.eval_kernel)."""
    dt = np.dtype(kspec.dtype)
    return dt if is_floating(dt) else np.dtype(np.float32)


def const_type(value, pin: np.dtype):
    """(value, type) of a constant: floats pinned strong, bools strong,
    ints weak."""
    if isinstance(value, (bool, np.bool_)):
        return bool(value), np.dtype(np.bool_)
    if isinstance(value, float):
        return scalar(value, pin), pin
    return value, weak(value)


def fill_value(bc, dtype) -> np.generic:
    """The value an out-of-domain read yields under a constant or shrink
    BC, cast to the field dtype exactly as the oracle's ``np.pad`` casts
    it (no BC means constant 0; bf16: the rounded value as float32)."""
    from ..config import JUNK_VAL
    if bc is not None and bc.kind == ir.BCKind.SHRINK:
        v = JUNK_VAL
    else:
        v = bc.value if bc is not None else 0.0
    if np.dtype(dtype) == BFLOAT16:
        return scalar(v, dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        return np.pad(np.zeros(1, np.dtype(dtype)), (1, 0),
                      constant_values=v)[0]


# -- a compute type (the stream kernel's ``compute_dtype``) -----------------
#
# The JAX package casts every array input to the compute type before the
# kernel (scalars keep their own type), evaluates each stage with jnp on
# those arrays in its default 32-bit mode, casts each stage's result to
# the compute type at its store and the outputs to their kernel types
# at the end.  jnp types a site by its own lattice, not numpy's: a value
# of the compute type meeting a Python integer (weak) keeps its type, a
# float constant (pinned to its kernel's type, ``compute_pin``) or a
# float scalar input is strong, bool meets anything as that type, an
# integer meets a float as that float (the framework's mixed rule agrees),
# bfloat16 meets float16 as float32, and integer true division gives
# float32.  Conversions are XLA's: float to integer truncates, saturates
# and sends NaN to 0, anything to bool is ``!= 0``.

F32 = np.dtype(np.float32)
I32 = np.dtype(np.int32)
BOOL = np.dtype(np.bool_)

# the compute types the port computes in, by their canonical names
COMPUTE_TYPES = {"float32": F32, "bfloat16": BFLOAT16, "float16": FLOAT16,
                 "int32": I32, "bool": BOOL}

# jax.dtypes.canonicalize_dtype under the JAX package's default 32-bit mode
_CANONICAL = {np.dtype(np.float64): F32, np.dtype(np.int64): I32,
              np.dtype(np.uint64): np.dtype(np.uint32)}


def canonical_name(name: str) -> str:
    """A compute type's name as the JAX package's 32-bit mode names it."""
    return {a.name: b.name for a, b in _CANONICAL.items()}.get(name, name)


def canonical(dt) -> np.dtype:
    """``dt`` as the JAX package's 32-bit mode holds it."""
    dt = np.dtype(dt)
    return _CANONICAL.get(dt, dt)


def compute_pin(kspec: ir.KernelSpec) -> np.dtype:
    """The strong type of a kernel's float constants under a compute
    type: ``const_dtype_of`` canonicalised (a float64 kernel's pin is a
    float32 in 32-bit mode)."""
    return canonical(const_dtype_of(kspec))


def _join2(a: np.dtype, b: np.dtype) -> np.dtype:
    if a == b or b.kind == "b":
        return a
    if a.kind == "b":
        return b
    fa, fb = is_floating(a), is_floating(b)
    if fa != fb:
        return a if fa else b
    if fa:   # bf16 and f16 meet in float32, either meets float32 there
        return a if a.itemsize > b.itemsize else b if b.itemsize > \
            a.itemsize else F32
    return canonical(np.promote_types(a, b))


def compute_join(*tys):
    """Type of a site of operands ``tys`` under a compute type (jnp's
    lattice in 32-bit mode); weak with weak gives a weak type, which the
    caller folds.  A weak Python integer meeting bool gives int32, a weak
    float meeting an integer or bool float32 (jnp's weakly typed results,
    kept strong here)."""
    strongs = [np.dtype(t) for t in tys if not is_weak(t)]
    weaks = [t for t in tys if is_weak(t)]
    if not strongs:
        return result_type(*weaks)
    ty = strongs[0]
    for t in strongs[1:]:
        ty = _join2(ty, t)
    if weaks and not is_floating(ty):
        if any(w[0] == WEAK_FLOAT for w in weaks):
            return F32
        if ty.kind == "b":
            return I32
    return ty


def weak_value(ty, to: np.dtype):
    """The weak scalar ``ty`` converted to ``to`` as jnp converts a Python
    scalar meeting an array of that type (a float through float32) — a
    numpy scalar of ``to`` (for bf16 the float32 scalar of its value)."""
    to = np.dtype(to)
    v = ty[1]
    if to.kind == "b":
        return np.bool_(v != 0)
    if is_floating(to):
        return scalar(np.float32(v), to)
    with np.errstate(over="ignore", invalid="ignore"):
        return to.type(int(v))


def xla_convert_scalar(value, frm: np.dtype, to: np.dtype):
    """One value of ``frm`` converted to ``to`` as XLA converts it: to
    bool ``!= 0``, from bool 0 or 1, float to integer truncated and
    saturated with NaN at 0, integer to integer wrapped, to a narrow
    float through float32 (``scalar``)."""
    frm, to = np.dtype(frm), np.dtype(to)
    if to.kind == "b":
        return np.bool_(float(value) != 0 if is_floating(frm)
                        else int(value) != 0)
    if frm.kind == "b":
        return scalar(int(bool(value)), to)
    if is_floating(to):
        return scalar(np.float32(value), to)
    info = np.iinfo(to)
    if is_floating(frm):
        v = float(value)
        if v != v:
            return to.type(0)
        return to.type(int(min(max(math.trunc(v) if math.isfinite(v)
                                   else v, info.min), info.max)))
    return np.array(int(value)).astype(np.int64).astype(to)[()]


def static_input(program: ir.Program, f: str) -> bool:
    """Is ``f`` an array input that does not span i (the JAX package's
    stream kernel holds its plane whole, of the compute type)?"""
    spec = program.inputs.get(f)
    return spec is not None and not spec.is_scalar and not spec.dim_mask[0]


def compute_fill(bc, compute: np.dtype, static: bool = False):
    """The value an out-of-domain read yields under a constant or shrink
    BC when the field's planes are of ``compute``: the fill converted to
    that type, a float through float32.  Under bool compute the JAX
    package's rings carry bool as 0/1 int32, so a ring field's fill
    reaches bool through int32 first (0.5 gives False); a ``static``
    input (an array that does not span i) keeps bool planes, and its fill
    is cast directly (0.5 gives True)."""
    compute = np.dtype(compute)
    if compute.kind == "b":
        return np.bool_(fill_value(bc, BOOL if static else I32) != 0)
    if is_floating(compute):   # a float fill rounds through float32
        with np.errstate(over="ignore"):
            return scalar(fill_value(bc, F32), compute)
    return fill_value(bc, compute)


def check_compute_program(program: ir.Program, name: str):
    """The type ``compute_dtype`` ``name`` computes in, or None where it
    changes nothing: float32 on a program whose arrays and kernels are
    all float32 (scalars keep their own type either way).  Raises
    NotImplementedError for a type outside ``COMPUTE_TYPES`` and for a
    scalar input whose type the port does not carry (unsigned)."""
    if name not in COMPUTE_TYPES:
        raise NotImplementedError(
            f"compute_dtype {name!r}: the port's stream kernel computes in "
            f"{', '.join(COMPUTE_TYPES)} (float64 and int64 as their "
            "32-bit types); the JAX package also takes the narrower "
            "integer types")
    for n, spec in program.inputs.items():
        if spec.is_scalar and canonical(spec.dtype).kind == "u":
            raise NotImplementedError(
                f"compute_dtype={name!r} with the unsigned scalar {n!r}")
    fields = [n for n, s in program.inputs.items() if not s.is_scalar]
    if name == "float32" and all(
            np.dtype(program.field_dtype(f)) == F32
            for f in fields + list(program.kernels)):
        return None
    return COMPUTE_TYPES[name]

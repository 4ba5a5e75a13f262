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

from typing import Any

import numpy as np

from .. import ir
from ..dtypes import BFLOAT16, FLOAT16, dtype_to_str, is_floating, scalar

WEAK_INT, WEAK_FLOAT = "wi", "wf"


def is_weak(ty) -> bool:
    return isinstance(ty, tuple)


def is_float(ty) -> bool:
    if is_weak(ty):
        return ty[0] == WEAK_FLOAT
    return is_floating(ty)


def is_bool(ty) -> bool:
    return not is_weak(ty) and ty != BF16 and np.dtype(ty).kind == "b"


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


# -- a narrow compute (the stream kernel's compute_dtype "bfloat16" or
#    "float16") ------------------------------------------------------------
#
# The JAX package casts every array input to the compute type before the
# kernel and evaluates each stage with jnp on those arrays: an op of two
# values of that type rounds its result to it after every operation, a
# Python scalar (weak) is converted to it first, a float32 scalar input or
# a float constant (pinned to np.float32, a strong type) promotes the site
# to float32, and the stage result rounds to the compute type at its
# store.  Node types here: ``BF16`` (an f32 value that holds a value of
# the compute type, bf16 or f16), float32, bool, and weak scalars.

BF16 = "bf16"
F32 = np.dtype(np.float32)


def bf16_join(*tys):
    """Result type of a site under bf16 compute: float32 wins over bf16,
    bf16 over weak scalars and bool (the framework's mixed rule), bool
    with bool stays bool.  Raises NotImplementedError elsewhere."""
    if F32 in tys:
        return F32
    if BF16 in tys:
        return BF16
    if all(not is_weak(t) and np.dtype(t) == np.bool_ for t in tys):
        return np.dtype(np.bool_)
    raise NotImplementedError(
        f"a site of types {tys} under bf16 compute")


def narrow_value(value, dtype) -> float:
    """``value`` as float32, rounded to the narrow ``dtype`` (BFLOAT16 or
    FLOAT16; to nearest, ties to even), as a weak scalar or a BC's fill
    meets an array of that type under a narrow compute."""
    return float(scalar(np.float32(value), dtype))


def check_compute_program(program: ir.Program, name: str) -> None:
    """A ``compute_dtype`` (``name``) is ported for float32 programs:
    every input (scalars too) and every kernel float32.  The JAX package
    casts the arrays of any other program to it (an int, float64 or
    narrow field, and float32 compute of a non-float32 program): still to
    port, NotImplementedError naming ROADMAP Queue 1 item 11."""
    for f in list(program.inputs) + list(program.kernels):
        dt = np.dtype(program.field_dtype(f))
        if dt != np.float32:
            raise NotImplementedError(
                f"compute_dtype={name!r} of a program with a "
                f"{dtype_to_str(dt)} field ({f!r}): the JAX package casts "
                "its arrays to the compute type; the port computes "
                "float32 programs only (ROADMAP Queue 1 item 11)")

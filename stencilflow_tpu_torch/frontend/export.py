"""Program -> JSON dialect (the inverse of the parser).

Copied from ``stencilflow_tpu/frontend/export.py`` with no change of
meaning: computation strings re-emitted in Python syntax with
dimensional indices relative to the canonical iterators
(``kernel_to_string``, which ``report.full_dump`` prints), the
relative-offset form of the reference's
``generate_relative_access_kernel_string`` (kernel.py:327-368,
``kernel_to_relative``), and whole programs (``program_to_json``, which
``cli adjoint`` writes).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from .. import ir
from ..config import ITERATORS
from ..dtypes import dtype_to_str


def _index_str(offsets: ir.Offsets, raw_rank: int) -> str:
    """Render a canonical 3-offset vector as a dialect index list.

    Full-rank fields use the program's raw rank (trailing iterators);
    lower-dimensional fields list only their spanned dims.
    """
    parts = []
    for it, o in zip(ITERATORS, offsets):
        if o is None:
            continue
        if o == 0:
            parts.append(it)
        elif o > 0:
            parts.append(f"{it}+{o}")
        else:
            parts.append(f"{it}-{-o}")
    # drop leading padded dims down to the raw rank for full-rank accesses
    if len(parts) > raw_rank:
        dropped = parts[:len(parts) - raw_rank]
        if not all(d in ITERATORS for d in dropped):
            # explicit raise (not assert: python -O would silently drop
            # the offset term and emit a DIFFERENT stencil)
            raise ValueError(
                f"nonzero offset in a padded dim: {parts}")
        parts = parts[len(parts) - raw_rank:]
    return "[" + ", ".join(parts) + "]"


def expr_to_str(expr: ir.Expr, raw_rank: int) -> str:
    rec = lambda e: expr_to_str(e, raw_rank)
    if isinstance(expr, ir.Const):
        return repr(expr.value)
    if isinstance(expr, ir.Ref):
        return expr.name
    if isinstance(expr, ir.Access):
        if all(o is None for o in expr.offsets):
            return expr.field          # scalar input
        return expr.field + _index_str(expr.offsets, raw_rank)
    if isinstance(expr, ir.BinOp):
        sym = {"add": "+", "sub": "-", "mult": "*", "div": "/"}[expr.op]
        return f"({rec(expr.left)} {sym} {rec(expr.right)})"
    if isinstance(expr, ir.UnaryOp):
        return f"(-{rec(expr.operand)})"
    if isinstance(expr, ir.Compare):
        sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
               "eq": "==", "ne": "!="}[expr.op]
        return f"({rec(expr.left)} {sym} {rec(expr.right)})"
    if isinstance(expr, ir.BoolOp):
        return "(" + f" {expr.op} ".join(rec(o)
                                         for o in expr.operands) + ")"
    if isinstance(expr, ir.Select):
        return (f"({rec(expr.if_true)} if {rec(expr.cond)} "
                f"else {rec(expr.if_false)})")
    if isinstance(expr, ir.Call):
        return f"{expr.fn}({', '.join(rec(a) for a in expr.args)})"
    raise TypeError(f"unknown expression node {type(expr)}")


def kernel_to_string(kspec: ir.KernelSpec, raw_rank: int) -> str:
    """Multi-statement computation string in the dialect's ';' form."""
    return "; ".join(f"{s.lhs} = {expr_to_str(s.rhs, raw_rank)}"
                     for s in kspec.statements)


def kernel_to_relative(kspec: ir.KernelSpec) -> str:
    """Computation string with RELATIVE-offset subscripts
    (``a[0, -1, 0]``) — the reference's
    ``generate_relative_access_kernel_string`` form (kernel.py:327-368),
    shown by ``cli report --verbose``."""

    def walk(e: ir.Expr) -> str:
        if isinstance(e, ir.Access):
            offs = [o for o in e.offsets if o is not None]
            if not offs:
                return e.field
            return e.field + "[" + ", ".join(str(o) for o in offs) + "]"
        if isinstance(e, ir.Const):
            return repr(e.value)
        if isinstance(e, ir.Ref):
            return e.name
        if isinstance(e, ir.BinOp):
            sym = {"add": "+", "sub": "-", "mult": "*",
                   "div": "/"}[e.op]
            return f"({walk(e.left)} {sym} {walk(e.right)})"
        if isinstance(e, ir.UnaryOp):
            return f"(-{walk(e.operand)})"
        if isinstance(e, ir.Compare):
            sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
                   "eq": "==", "ne": "!="}[e.op]
            return f"({walk(e.left)} {sym} {walk(e.right)})"
        if isinstance(e, ir.BoolOp):
            return "(" + f" {e.op} ".join(walk(o)
                                          for o in e.operands) + ")"
        if isinstance(e, ir.Select):
            return (f"({walk(e.if_true)} if {walk(e.cond)} "
                    f"else {walk(e.if_false)})")
        if isinstance(e, ir.Call):
            return f"{e.fn}({', '.join(walk(a) for a in e.args)})"
        raise TypeError(f"unknown expression node {type(e)}")

    return "; ".join(f"{s.lhs} = {walk(s.rhs)}"
                     for s in kspec.statements)


def program_to_json(program: ir.Program,
                    embed_data: bool = True) -> Dict[str, Any]:
    """Serialize a Program back to the JSON dialect.

    ``embed_data``: inline ndarray input data as lists (otherwise emit a
    ``constant:0.0`` placeholder the caller replaces with file paths).
    """
    raw_rank = len(program.raw_dimensions)
    iters = list(ITERATORS)

    inputs: Dict[str, Any] = {}
    for name, spec in program.inputs.items():
        entry: Dict[str, Any] = {"data_type": dtype_to_str(spec.dtype)}
        data = spec.data
        if isinstance(data, np.ndarray):
            entry["data"] = data.tolist() if embed_data else "constant:0.0"
        elif isinstance(data, str):
            # relative data file paths resolve against the SOURCE
            # program's directory at load time: rebase so the exported
            # JSON works from any directory
            if (not data.startswith(("constant:", "random:"))
                    and not os.path.isabs(data) and program.path):
                data = os.path.join(
                    os.path.dirname(os.path.abspath(program.path)), data)
            entry["data"] = data
        elif isinstance(data, list):
            entry["data"] = data
        elif np.isscalar(data):
            entry["data"] = float(data)
        else:
            entry["data"] = "constant:0.0"
        # spanned iterator names, trimmed to the raw rank's iterators
        spanned = [iters[d] for d in range(3) if spec.dim_mask[d]]
        full = iters[3 - raw_rank:]
        if spanned != full:
            entry["input_dims"] = spanned
        inputs[name] = entry

    kernels: Dict[str, Any] = {}
    for name, kspec in program.kernels.items():
        kernels[name] = {
            "computation_string": kernel_to_string(kspec, raw_rank),
            "boundary_conditions": {
                f: {"type": bc.kind.value, "value": bc.value}
                for f, bc in kspec.boundary_conditions.items()},
            "data_type": dtype_to_str(kspec.dtype),
        }

    out: Dict[str, Any] = {
        "inputs": inputs,
        "outputs": list(program.outputs),
        "dimensions": list(program.raw_dimensions),
        "program": kernels,
    }
    if program.vectorization != 1:
        out["vectorization"] = program.vectorization
    if program.constants:
        out["constants"] = dict(program.constants)
    return out

"""Canonicalization passes over the IR — only the rows rotation so far.

Copied from ``stencilflow_tpu/frontend/canonicalize.py`` with no change
of meaning, cut to ``rotate_2d_to_rows`` (the row-streaming lowering,
``backend.compile_chain_rows``, is its one user in the port).
"""
from __future__ import annotations

import dataclasses

from .. import ir


def rotate_2d_to_rows(program: ir.Program) -> ir.Program:
    """Axis-rotate a 2-D program's padded domain ``(1, J, K) -> (J, 1, K)``.

    The dialect pads 2-D programs with a LEADING size-1 dim, which leaves
    a 2-D program's whole (J, K) plane as a streaming kernel's per-step
    working set.  Rotating j into the streamed i axis makes the per-step
    unit a ROW of K elements (j-offsets become i-offsets served by ring
    planes), so tall 2-D domains stream along their rows.

    A pure iteration-space relabeling: dim masks and access offsets are
    permuted by (j, i, k); boundary conditions are per-field and follow
    their dim; input ARRAYS are unchanged (no field spans both i and j in
    a 2-D program, so spanned-dim order is preserved).  Outputs come back
    shaped ``(J, 1, K)`` — ``raw_dimensions`` is set accordingly; callers
    reshape to the original raw (J, K).
    """
    dims = program.dimensions
    if len(program.raw_dimensions) != 2 or dims[0] != 1:
        raise ValueError("rotate_2d_to_rows applies to 2-D programs only")

    def rot_expr(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Access):
            o = e.offsets
            if o[0] not in (None, 0):
                raise ValueError(
                    f"unexpected i-offset in a 2-D program: {e!r}")
            return ir.Access(e.field, (o[1], o[0], o[2]))
        return e

    kernels = {}
    for name, k in program.kernels.items():
        stmts = [ir.Assign(s.lhs, ir.rewrite_expr(s.rhs, rot_expr))
                 for s in k.statements]
        kernels[name] = ir.KernelSpec(k.name, stmts, k.dtype,
                                      dict(k.boundary_conditions),
                                      k.source)
    inputs = {
        n: dataclasses.replace(
            s, dim_mask=(s.dim_mask[1], s.dim_mask[0], s.dim_mask[2]))
        for n, s in program.inputs.items()}
    return dataclasses.replace(
        program, name=program.name + "_rows",
        dimensions=(dims[1], 1, dims[2]),
        raw_dimensions=(dims[1], 1, dims[2]),
        inputs=inputs, kernels=kernels)

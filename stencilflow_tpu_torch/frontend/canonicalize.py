"""Canonicalization passes — the reference's importer roles over our IR.

The reference's ``canonicalize_sdfg`` / ``sdfg_to_stencilflow``
(stencilflow/sdfg_to_stencilflow.py:267-332,522-767) turn
general DaCe programs into the stencil dialect via: SSA versioning of
multiply-written fields, predication of data-dependent control flow
(if/else → ternary, min/max → compare+ternary), constant specialization, and
dead-code cleanup.  The same roles here operate on the typed IR:

* :func:`version_program` — accept an *ordered op list* where output names
  repeat (iterative updates, e.g. ``b = f(a); b = f(b)``) and rewrite it to
  the single-assignment chain dialect with ``__1``-style versions (the last
  write keeps the name, reference :590-632);
* :func:`predicate_min_max` — rewrite min/max calls to compare+select
  (reference ``_MinMaxPredicator`` :358-402);
* :func:`specialize_constants` — fold named constants / scalar inputs into
  literals (reference ``specialize_scalars``, sdfg_generator.py:225-233);
* :func:`remove_dead_kernels` — drop kernels no output depends on
  (reference ``remove_unused_sinks`` :71-104);
* :func:`rotate_2d_to_rows` — the row-streaming relabeling of a 2-D
  program (``backend.compile_chain_rows``).

Copied from ``stencilflow_tpu/frontend/canonicalize.py`` with no change
of meaning: the port cannot import the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from .chain import ChainGraph


# ---------------------------------------------------------------------------
# Expression rewriting helpers
# ---------------------------------------------------------------------------

# the generic bottom-up rewrite lives on the IR (ir.rewrite_expr)
rewrite_expr = ir.rewrite_expr


def rename_fields(kspec: ir.KernelSpec,
                  renames: Dict[str, str]) -> ir.KernelSpec:
    """Return a kernel with field accesses (and their BCs) renamed."""
    def fn(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Access) and e.field in renames:
            return ir.Access(renames[e.field], e.offsets)
        return e

    stmts = [ir.Assign(s.lhs, rewrite_expr(s.rhs, fn))
             for s in kspec.statements]
    bcs = {renames.get(f, f): bc
           for f, bc in kspec.boundary_conditions.items()}
    return ir.KernelSpec(kspec.name, stmts, kspec.dtype, bcs, kspec.source)


# ---------------------------------------------------------------------------
# SSA versioning (reference: sdfg_to_stencilflow.py:590-632)
# ---------------------------------------------------------------------------

def version_program(ops: Sequence[Tuple[str, ir.KernelSpec]],
                    outputs: Sequence[str]) -> Dict[str, ir.KernelSpec]:
    """Rewrite an ordered op list with repeated output names into the
    single-assignment dialect.

    Each op ``(target, kernel)`` may write a name previously written (or an
    input name).  Intermediate versions get ``name__1, name__2, ...``; the
    LAST write keeps the bare name, and every read resolves to the version
    live at that point.  Returns the new ``{kernel_name: spec}`` map in
    order.
    """
    write_counts: Dict[str, int] = {}
    for target, _ in ops:
        write_counts[target] = write_counts.get(target, 0) + 1

    seen: Dict[str, int] = {}
    current: Dict[str, str] = {}   # live version per base name
    result: Dict[str, ir.KernelSpec] = {}
    for target, kspec in ops:
        renames = dict(current)
        seen[target] = seen.get(target, 0) + 1
        if seen[target] == write_counts[target]:
            vname = target                      # final write keeps the name
        else:
            vname = f"{target}__{seen[target]}"
        spec = rename_fields(kspec, renames)
        spec = ir.KernelSpec(vname, spec.statements, spec.dtype,
                             spec.boundary_conditions, spec.source)
        result[vname] = spec
        current[target] = vname
    for o in outputs:
        if o not in result:
            raise ValueError(f"output '{o}' never written")
    return result


def program_from_op_list(ops: Sequence, dimensions: Sequence[int],
                         inputs: Dict, outputs: Sequence[str],
                         name: str = "oplist",
                         constants: Optional[Dict[str, float]] = None,
                         vectorization: int = 1) -> ir.Program:
    """Ordered-op-list frontend: the importer entry that DRIVES
    :func:`version_program` (the reference's iterative-rebinding ingestion,
    sdfg_to_stencilflow.py:590-632 — COSMO programs write the same field
    repeatedly; the SDFG walk produced exactly such an op list).

    ``ops`` is a sequence of ``(target, computation_string)`` or
    ``(target, computation_string, boundary_conditions)`` or
    ``(target, computation_string, boundary_conditions, data_type)``
    tuples where targets MAY repeat (``b = f(a); b = f(b)``) and may read
    their own previous version with offsets.  Reads resolve to the version
    live at that point; the last write of each name keeps the bare name.
    ``inputs``/``outputs``/``dimensions`` use the program-JSON dialect.
    Returns a normal single-assignment :class:`~stencilflow_tpu_torch.ir.Program`
    (round-trips through ``cli canonicalize`` / ``program_to_json``).
    """
    from .parser import (_pad_computation_string, parse_computation,
                         parse_program)
    raw = tuple(int(d) for d in dimensions)
    # reuse the JSON parser for input-spec normalization (dtype map,
    # input_dims masks) by parsing a no-op probe program
    targets = {op[0] for op in ops}
    clash = targets & set(inputs)
    if clash:
        raise ValueError(
            f"op target(s) {sorted(clash)} collide with input names; "
            "rename the inputs (the final write keeps the bare name)")
    probe = {
        "inputs": inputs, "outputs": ["__probe__"],
        "dimensions": list(raw),
        "program": {"__probe__": {
            "computation_string": "__probe__ = 0.0",
            "boundary_conditions": {},
            "data_type": "float32"}},
    }
    base = parse_program(probe, name="__probe__")
    input_specs = base.inputs
    masks = {n: sp.dim_mask for n, sp in input_specs.items()}
    input_dims = {n: [it for it, m in zip(("i", "j", "k"), sp.dim_mask)
                      if m]
                  for n, sp in input_specs.items() if not all(sp.dim_mask)}
    constants = dict(constants or {})

    if vectorization < 1:
        raise ValueError("vectorization must be >= 1")
    if raw[-1] % vectorization != 0:
        raise ValueError(
            f"vectorization {vectorization} must divide the innermost "
            f"dim ({raw[-1]})")

    op_specs = []
    # reads resolve to the version live at that point: a field is only
    # readable once written (or when it is an input) — pre-seeding every
    # target would silently resolve early reads to FUTURE versions
    written = dict(masks)
    for op in ops:
        target, computation = op[0], op[1]
        bcs_json = op[2] if len(op) > 2 and op[2] is not None else {}
        dtype = np.dtype(op[3]) if len(op) > 3 and op[3] is not None \
            else np.dtype(np.float32)
        stmts = parse_computation(
            target, _pad_computation_string(computation, len(raw)),
            written, input_dims, constants)
        if stmts[-1].lhs != target:
            raise ValueError(
                f"op for {target!r} must end with an assignment to it")
        # center reads of already-assigned temporaries became Refs at
        # parse time, so every remaining Access must name an input or a
        # previously-written target (its live version)
        for s in stmts:
            for node in ir.walk(s.rhs):
                if (isinstance(node, ir.Access)
                        and node.field not in written):
                    raise ValueError(
                        f"op for {target!r} reads {node.field!r} before "
                        "any write (and it is not an input)")
        bcs = {f: ir.BoundaryCondition.from_json(bc)
               for f, bc in bcs_json.items()}
        op_specs.append((target, ir.KernelSpec(
            target, stmts, dtype, bcs, source=computation)))
        written.setdefault(target, (True, True, True))

    kernels = version_program(op_specs, list(outputs))
    dims3 = (1,) * (3 - len(raw)) + raw
    program = ir.Program(
        name=name, dimensions=dims3, raw_dimensions=raw,
        inputs=input_specs, outputs=list(outputs), kernels=kernels,
        vectorization=vectorization,
    )
    from .parser import _validate
    _validate(program)
    return program


def nest_dimension(program: ir.Program, extent: int,
                   inputs_spanning: Optional[Sequence[str]] = None
                   ) -> ir.Program:
    """Collapse an outer loop into the stencil domain (the reference's
    ``NestK`` transformation, stencil/nestk.py:41-176): a 2-D program
    applied independently across ``extent`` vertical levels becomes one
    3-D program whose padded leading dim spans the levels.

    ``inputs_spanning`` names the inputs that gain the new dim (their
    data then has one 2-D slice per level, the loop's indexed array);
    default: every non-scalar input.  Inputs left out stay lower-rank
    (broadcast across levels — the loop-invariant arrays).  Kernel code
    is unchanged — accesses keep a zero offset in the new dim, exactly
    DimensionAdder's access/shape update.
    """
    if program.dimensions[0] != 1 or len(program.raw_dimensions) != 2:
        raise ValueError(
            "nest_dimension lifts a 2-D program into the padded leading "
            f"dim; program spans {program.raw_dimensions}")
    if extent < 1:
        raise ValueError("extent must be >= 1")
    if inputs_spanning is None:
        inputs_spanning = [n for n, sp in program.inputs.items()
                           if not sp.is_scalar]
    unknown = [n for n in inputs_spanning if n not in program.inputs]
    if unknown:
        raise ValueError(f"unknown input(s) {unknown}")

    program = copy.deepcopy(program)
    spanning = set(inputs_spanning)
    for name, spec in program.inputs.items():
        if name in spanning and not spec.is_scalar:
            spec.dim_mask = (True,) + tuple(spec.dim_mask[1:])
    # accesses of newly spanning inputs: the None (unspanned) entry in the
    # lifted dim becomes offset 0
    def lift(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Access) and e.field in spanning and \
                e.offsets[0] is None:
            return ir.Access(e.field, (0,) + tuple(e.offsets[1:]))
        return e

    for kspec in program.kernels.values():
        kspec.statements[:] = [ir.Assign(s.lhs, rewrite_expr(s.rhs, lift))
                               for s in kspec.statements]
    program.dimensions = (extent,) + tuple(program.dimensions[1:])
    program.raw_dimensions = (extent,) + tuple(program.raw_dimensions)
    program.name = f"{program.name}_nested{extent}"
    return program


# ---------------------------------------------------------------------------
# Predication (reference: _MinMaxPredicator, _Predicator)
# ---------------------------------------------------------------------------

def predicate_min_max(program: ir.Program) -> ir.Program:
    """Rewrite min/max calls into compare + select (ternary) form."""
    def fn(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Call) and e.fn in ("min", "max") and \
                len(e.args) == 2:
            a, b = e.args
            cmp_op = "lt" if e.fn == "min" else "gt"
            return ir.Select(ir.Compare(cmp_op, a, b), a, b)
        return e

    program = copy.deepcopy(program)
    for kname, kspec in program.kernels.items():
        kspec.statements[:] = [
            ir.Assign(s.lhs, rewrite_expr(s.rhs, fn))
            for s in kspec.statements
        ]
    return program


# ---------------------------------------------------------------------------
# Constant specialization (reference: specialize_scalars)
# ---------------------------------------------------------------------------

def specialize_constants(program: ir.Program,
                         values: Optional[Dict[str, float]] = None
                         ) -> ir.Program:
    """Bake scalar inputs (with known data) and named constants into
    literal constants, dropping the corresponding inputs."""
    program = copy.deepcopy(program)
    scalar_values: Dict[str, float] = dict(program.constants)
    if values:
        scalar_values.update(values)
    clash = {n for n in scalar_values
             if n in program.inputs and not program.inputs[n].is_scalar}
    if clash:
        raise ValueError(
            f"constant name(s) {sorted(clash)} collide with non-scalar "
            "inputs; specializing would silently replace array reads")
    for name, spec in list(program.inputs.items()):
        if not spec.is_scalar or name in (values or {}):
            continue
        data = spec.data
        if isinstance(data, str):
            if data.startswith("constant:"):
                scalar_values[name] = float(data.split(":", 1)[1])
        elif np.isscalar(data) or getattr(data, "ndim", None) == 0:
            scalar_values[name] = float(data)

    def fn(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Access) and e.field in scalar_values:
            return ir.Const(scalar_values[e.field])
        if isinstance(e, ir.Ref) and e.name in scalar_values:
            return ir.Const(scalar_values[e.name])
        return e

    for kspec in program.kernels.values():
        kspec.statements[:] = [
            ir.Assign(s.lhs, rewrite_expr(s.rhs, fn))
            for s in kspec.statements
        ]
        for name in list(kspec.boundary_conditions):
            if name in scalar_values:
                del kspec.boundary_conditions[name]
    for name in scalar_values:
        program.inputs.pop(name, None)
    return program


# ---------------------------------------------------------------------------
# Dead-kernel elimination (reference: remove_unused_sinks)
# ---------------------------------------------------------------------------

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


def remove_dead_kernels(program: ir.Program) -> ir.Program:
    """Drop kernels (and inputs) that no program output depends on."""
    program = copy.deepcopy(program)
    graph = ChainGraph.build(program)
    live: set = set()
    stack = list(program.outputs)
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(graph.producers(n))
    program.kernels = {k: v for k, v in program.kernels.items()
                       if k in live}
    program.inputs = {k: v for k, v in program.inputs.items() if k in live}
    return program


def canonicalize(program: ir.Program,
                 constants: Optional[Dict[str, float]] = None,
                 min_max_to_select: bool = False) -> ir.Program:
    """The standard pass pipeline (reference canonicalize_sdfg order)."""
    program = remove_dead_kernels(program)
    if constants:
        program = specialize_constants(program, constants)
    if min_max_to_select:
        program = predicate_min_max(program)
    return program

"""Traced-Python frontend: write stencil chains as plain Python functions.

The reference's second frontend imports DaCe SDFG programs (COSMO weather
kernels) into the JSON dialect (stencilflow/
sdfg_to_stencilflow.py:522-767).  The TPU-native analogue imports *Python
functions over symbolic fields*: the function is executed once with
``StencilValue`` tracers, every relative access and arithmetic op is
recorded into the typed IR, and stage boundaries are materialized exactly
where a derived value is re-accessed at an offset (the defining property of
a stencil stage).  The result is a normal :class:`~stencilflow_tpu_torch.ir.Program`
— same analyses, simulator, and backends as JSON programs.

    from stencilflow_tpu_torch.frontend.trace import trace_program

    def laplace2(a):
        b = 0.25 * (a[0,-1,0] + a[0,1,0] + a[0,0,-1] + a[0,0,1])
        c = 0.25 * (b[0,-1,0] + b[0,1,0] + b[0,0,-1] + b[0,0,1])
        return {"c": c}

    program = trace_program(laplace2, dimensions=(1, 64, 64),
                            inputs={"a": np.float32})

Copied from ``stencilflow_tpu/frontend/trace.py`` with no change of
meaning: the port cannot import the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .. import ir


class TraceError(ValueError):
    pass


@dataclasses.dataclass
class _Ctx:
    dimensions: Tuple[int, int, int]
    default_bc: ir.BoundaryCondition
    dtype: np.dtype
    kernels: Dict[str, ir.KernelSpec] = dataclasses.field(
        default_factory=dict)
    input_masks: Dict[str, Tuple[bool, bool, bool]] = dataclasses.field(
        default_factory=dict)
    bcs: Dict[str, ir.BoundaryCondition] = dataclasses.field(
        default_factory=dict)
    counter: int = 0

    def fresh(self) -> str:
        name = f"t{self.counter}"
        self.counter += 1
        while name in self.kernels or name in self.input_masks:
            name = f"t{self.counter}"
            self.counter += 1
        return name

    def materialize(self, value: "StencilValue", name: Optional[str] = None
                    ) -> str:
        """Turn an expression value into a named kernel stage (idempotent:
        repeated offset accesses of one value share a single stage)."""
        if name is None and isinstance(value.expr, ir.Access) and \
                all(o in (0, None) for o in value.expr.offsets):
            return value.expr.field  # already a plain field read
        if name is None and value._mat is not None:
            return value._mat
        if name is not None and (name in self.kernels
                                 or name in self.input_masks):
            raise TraceError(
                f"output name {name!r} collides with an "
                f"{'input' if name in self.input_masks else 'existing stage'}"
                "; pick a distinct output name")
        name = name or self.fresh()
        used = sorted({n.field for n in ir.walk(value.expr)
                       if isinstance(n, ir.Access)})
        bcs = {f: self.bcs.get(f, self.default_bc) for f in used}
        self.kernels[name] = ir.KernelSpec(
            name=name,
            statements=[ir.Assign(name, value.expr)],
            dtype=self.dtype,
            boundary_conditions=bcs,
            source=f"traced:{name}",
        )
        value._mat = name
        return name


def _lift(ctx: _Ctx, x) -> "StencilValue":
    if isinstance(x, StencilValue):
        return x
    if isinstance(x, (int, float, np.integer, np.floating)):
        return StencilValue(ctx, ir.Const(float(x)))
    raise TraceError(f"cannot use {type(x).__name__} in a traced stencil")


class StencilValue:
    """Symbolic value recorded during tracing."""

    def __init__(self, ctx: _Ctx, expr: ir.Expr):
        self._ctx = ctx
        self.expr = expr
        self._mat: Optional[str] = None  # stage name once materialized

    # -- stage access --------------------------------------------------------
    def __getitem__(self, idx) -> "StencilValue":
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) != 3:
            raise TraceError(
                "accesses use 3 relative offsets [di, dj, dk]")
        offsets = tuple(int(o) for o in idx)
        field = self._ctx.materialize(self)
        mask = self._ctx.input_masks.get(field, (True, True, True))
        canon = tuple(o if m else None
                      for o, m in zip(offsets, mask))
        for o, m in zip(offsets, mask):
            if not m and o != 0:
                raise TraceError(
                    f"offset {offsets} on field '{field}' which does not "
                    "span that dimension")
        return StencilValue(self._ctx, ir.Access(field, canon))

    def named(self, name: str) -> "StencilValue":
        """Give this value a stable stage name."""
        field = self._ctx.materialize(self, name)
        mask = self._ctx.input_masks.get(field, (True, True, True))
        canon = tuple(0 if m else None for m in mask)
        return StencilValue(self._ctx, ir.Access(field, canon))

    # -- arithmetic ----------------------------------------------------------
    def _bin(self, op: str, other, reverse=False) -> "StencilValue":
        other = _lift(self._ctx, other)
        a, b = (other, self) if reverse else (self, other)
        return StencilValue(self._ctx, ir.BinOp(op, a.expr, b.expr))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mult", o)
    def __rmul__(self, o): return self._bin("mult", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, True)
    def __neg__(self): return StencilValue(
        self._ctx, ir.UnaryOp("neg", self.expr))

    def _cmp(self, op: str, other) -> "StencilValue":
        other = _lift(self._ctx, other)
        return StencilValue(self._ctx,
                            ir.Compare(op, self.expr, other.expr))

    def __bool__(self):
        # default object truthiness would silently mistrace data-dependent
        # Python control flow (if/min/max on traced comparisons always
        # taking one branch) — fail loudly instead
        raise TraceError(
            "data-dependent Python control flow cannot be traced; use "
            "where(...)/minimum(...)/maximum(...) on traced values")

    def __lt__(self, o): return self._cmp("lt", o)
    def __le__(self, o): return self._cmp("le", o)
    def __gt__(self, o): return self._cmp("gt", o)
    def __ge__(self, o): return self._cmp("ge", o)

    def where(self, if_true, if_false) -> "StencilValue":
        """``self`` as a predicate: select(if_true, if_false)."""
        t = _lift(self._ctx, if_true)
        f = _lift(self._ctx, if_false)
        return StencilValue(self._ctx,
                            ir.Select(self.expr, t.expr, f.expr))


def _make_call(fn_name: str):
    def call(*args):
        ctx = next(a._ctx for a in args if isinstance(a, StencilValue))
        exprs = tuple(_lift(ctx, a).expr for a in args)
        return StencilValue(ctx, ir.Call(fn_name, exprs))
    return call


sin = _make_call("sin")
cos = _make_call("cos")
tan = _make_call("tan")
sqrt = _make_call("sqrt")
exp = _make_call("exp")
log = _make_call("log")
tanh = _make_call("tanh")
minimum = _make_call("min")
maximum = _make_call("max")
absolute = _make_call("abs")


def trace_program(fn: Callable, dimensions: Sequence[int],
                  inputs: Dict[str, Any],
                  name: str = "traced",
                  dtype: Any = np.float32,
                  boundary: Union[str, ir.BoundaryCondition] = "constant",
                  boundary_value: float = 0.0,
                  input_data: Optional[Dict[str, Any]] = None,
                  vectorization: int = 1) -> ir.Program:
    """Trace ``fn`` into a Program.

    ``inputs`` maps input names to a dtype (full-rank field) or a dict
    ``{"dtype": ..., "dims": [spanned iterator names], "bc": {...}}``.
    ``fn`` receives one tracer per input and returns a dict of outputs (or a
    single value, named "out").
    """
    raw = tuple(int(d) for d in dimensions)
    if not 1 <= len(raw) <= 3:
        raise TraceError(f"dimensions must have 1-3 entries, got "
                         f"{len(raw)}")
    dims3 = (1,) * (3 - len(raw)) + raw
    if isinstance(boundary, ir.BoundaryCondition):
        default_bc = boundary
    else:
        default_bc = ir.BoundaryCondition(ir.BCKind(boundary),
                                          boundary_value)
    ctx = _Ctx(dims3, default_bc, np.dtype(dtype))

    input_specs: Dict[str, ir.InputSpec] = {}
    args = []
    for iname, spec in inputs.items():
        if isinstance(spec, dict):
            in_dtype = np.dtype(spec.get("dtype", dtype))
            dim_names = spec.get("dims")
            bc = spec.get("bc")
            if bc is not None:
                ctx.bcs[iname] = ir.BoundaryCondition.from_json(bc) \
                    if isinstance(bc, dict) else bc
        else:
            in_dtype = np.dtype(spec)
            dim_names = None
        if dim_names is None:
            pad = 3 - len(raw)
            mask = (False,) * pad + (True,) * len(raw)
        else:
            iters = ("i", "j", "k")
            mask = tuple(it in dim_names for it in iters)
        ctx.input_masks[iname] = mask
        data = (input_data or {}).get(iname, "constant:0.0")
        input_specs[iname] = ir.InputSpec(iname, in_dtype, mask, data)
        canon = tuple(0 if m else None for m in mask)
        args.append(StencilValue(ctx, ir.Access(iname, canon)))

    result = fn(*args)
    if isinstance(result, StencilValue):
        result = {"out": result}
    if not isinstance(result, dict) or not result:
        raise TraceError("traced function must return a StencilValue or a "
                         "non-empty dict of them")
    outputs = []
    for oname, val in result.items():
        if not isinstance(val, StencilValue):
            raise TraceError(f"output '{oname}' is not a traced value")
        ctx.materialize(val, oname)
        outputs.append(oname)

    return ir.Program(
        name=name,
        dimensions=dims3,
        raw_dimensions=raw,
        inputs=input_specs,
        outputs=outputs,
        kernels=ctx.kernels,
        vectorization=vectorization,
    )

"""Typed intermediate representation for stencil-chain programs.

The reference keeps its program model implicit in a web of networkx graphs and
queue objects (kernel_chain_graph.py / compute_graph.py / kernel.py).  We use
small immutable dataclasses instead: a ``Program`` holds ``InputSpec`` /
``KernelSpec`` entries, and each kernel's computation is a list of ``Assign``
statements over a tiny expression tree.

Index convention (identical to the reference,
stencilflow/compute_graph_nodes.py:189-238): every program is
canonicalized to 3 dimensions with iterators ``(i, j, k)``; 1-D/2-D programs
get size-1 leading dims.  A field access stores a 3-long offset vector where
``None`` marks dimensions the field does not span (lower-dimensional inputs,
or leading padded dims).

Copied from ``stencilflow_tpu/ir.py`` with no change of meaning: the
port cannot import the JAX package, whose ``__init__`` imports jax.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Offsets = Tuple[Optional[int], Optional[int], Optional[int]]


# ---------------------------------------------------------------------------
# Expression tree
# ---------------------------------------------------------------------------

class Expr:
    """Base class for expression nodes."""
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float

    def __repr__(self):
        return f"{self.value!r}"


@dataclasses.dataclass(frozen=True)
class Ref(Expr):
    """Reference to a temporary assigned earlier in the same kernel."""
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Access(Expr):
    """Read of a field (program input or upstream kernel) at a relative offset."""
    field: str
    offsets: Offsets  # 3-long, None in dims the field does not span

    def __repr__(self):
        idx = ", ".join("-" if o is None else str(o) for o in self.offsets)
        return f"{self.field}[{idx}]"


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # add | sub | mult | div
    left: Expr
    right: Expr

    def __repr__(self):
        sym = {"add": "+", "sub": "-", "mult": "*", "div": "/"}[self.op]
        return f"({self.left!r} {sym} {self.right!r})"


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # neg
    operand: Expr

    def __repr__(self):
        return f"(-{self.operand!r})"


@dataclasses.dataclass(frozen=True)
class Compare(Expr):
    op: str  # lt | le | gt | ge | eq | ne
    left: Expr
    right: Expr

    def __repr__(self):
        sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
               "eq": "==", "ne": "!="}[self.op]
        return f"({self.left!r} {sym} {self.right!r})"


@dataclasses.dataclass(frozen=True)
class BoolOp(Expr):
    op: str  # and | or
    operands: Tuple[Expr, ...]

    def __repr__(self):
        return f" {self.op} ".join(repr(o) for o in self.operands)


@dataclasses.dataclass(frozen=True)
class Select(Expr):
    """Ternary ``a if cond else b`` (reference: Ternary node)."""
    cond: Expr
    if_true: Expr
    if_false: Expr

    def __repr__(self):
        return f"({self.if_true!r} if {self.cond!r} else {self.if_false!r})"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    fn: str  # sin, cos, tan, sinh, cosh, tanh, sqrt, exp, log, abs, min, max
    args: Tuple[Expr, ...]

    def __repr__(self):
        return f"{self.fn}({', '.join(repr(a) for a in self.args)})"


@dataclasses.dataclass(frozen=True)
class Assign:
    lhs: str
    rhs: Expr

    def __repr__(self):
        return f"{self.lhs} = {self.rhs!r}"


def rewrite_expr(expr: Expr, fn) -> Expr:
    """Bottom-up expression rewrite: ``fn`` is applied to every node after
    its children have been rewritten."""
    if isinstance(expr, BinOp):
        expr = BinOp(expr.op, rewrite_expr(expr.left, fn),
                     rewrite_expr(expr.right, fn))
    elif isinstance(expr, UnaryOp):
        expr = UnaryOp(expr.op, rewrite_expr(expr.operand, fn))
    elif isinstance(expr, Compare):
        expr = Compare(expr.op, rewrite_expr(expr.left, fn),
                       rewrite_expr(expr.right, fn))
    elif isinstance(expr, BoolOp):
        expr = BoolOp(expr.op, tuple(rewrite_expr(o, fn)
                                     for o in expr.operands))
    elif isinstance(expr, Select):
        expr = Select(rewrite_expr(expr.cond, fn),
                      rewrite_expr(expr.if_true, fn),
                      rewrite_expr(expr.if_false, fn))
    elif isinstance(expr, Call):
        expr = Call(expr.fn, tuple(rewrite_expr(a, fn)
                                   for a in expr.args))
    return fn(expr)


def rename_fields(expr: Expr, ren: Dict[str, str]) -> Expr:
    """Rebuild an expression with Access fields renamed through ``ren``
    (temporary Refs are kernel-local and untouched)."""
    def fn(e: Expr) -> Expr:
        if isinstance(e, Access) and e.field in ren:
            return dataclasses.replace(e, field=ren[e.field])
        return e
    return rewrite_expr(expr, fn)


def walk(expr: Expr):
    """Yield every node of an expression tree (pre-order)."""
    yield expr
    if isinstance(expr, BinOp):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, UnaryOp):
        yield from walk(expr.operand)
    elif isinstance(expr, Compare):
        yield from walk(expr.left)
        yield from walk(expr.right)
    elif isinstance(expr, BoolOp):
        for o in expr.operands:
            yield from walk(o)
    elif isinstance(expr, Select):
        yield from walk(expr.cond)
        yield from walk(expr.if_true)
        yield from walk(expr.if_false)
    elif isinstance(expr, Call):
        for a in expr.args:
            yield from walk(a)


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------

class BCKind(str, enum.Enum):
    """Out-of-domain read handling (reference: base_node_class.py:24-42 and
    stencil/cpu.py:84-99)."""
    CONSTANT = "constant"   # read yields a fixed value
    COPY = "copy"           # read yields the field's center value
    SHRINK = "shrink"       # read yields JUNK_VAL; user prunes the halo


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    kind: BCKind
    value: float = 0.0

    @staticmethod
    def from_json(spec: Dict[str, Any]) -> "BoundaryCondition":
        kind = BCKind(spec["type"])
        return BoundaryCondition(kind, float(spec.get("value", 0.0)))


# ---------------------------------------------------------------------------
# Program containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InputSpec:
    name: str
    dtype: np.dtype
    dim_mask: Tuple[bool, bool, bool]  # which of (i, j, k) the field spans
    data: Any  # scalar | list | ndarray | "constant:v" | "random:a,b" | path

    @property
    def is_scalar(self) -> bool:
        return not any(self.dim_mask)

    def shape(self, dimensions: Sequence[int]) -> Tuple[int, ...]:
        """Concrete shape of this input given the global domain."""
        return tuple(d for d, m in zip(dimensions, self.dim_mask) if m)


@dataclasses.dataclass
class KernelSpec:
    name: str
    statements: List[Assign]
    dtype: np.dtype
    boundary_conditions: Dict[str, BoundaryCondition]
    source: str = ""  # original computation string (for diagnostics / report)

    @property
    def output_statement(self) -> Assign:
        """The statement producing the kernel's output value.

        With multiple statements, temporaries consumed later are internal; the
        final statement's value is the kernel result (reference merges
        same-name nodes and picks the zero-out-degree node,
        compute_graph.py:173-186).
        """
        return self.statements[-1]

    def accesses(self) -> Dict[str, List[Offsets]]:
        """All field accesses, per field, in first-seen order.

        Only names assigned by an EARLIER statement are local
        temporaries; an Access naming a later-assigned (or the final)
        lhs is a real field read — the parser resolves earlier-assigned
        center reads to Refs, and op lists read a target's previous
        version through its own name.  Excluding all lhs names would
        hide such reads from validation and the chain graph.  The walk
        is kept for the statements it ran over (a composed stage's IR has
        tens of thousands of accesses, which the planners read often);
        each call returns fresh lists."""
        key = tuple(map(id, self.statements))
        memo = self.__dict__.get("_accesses")
        if memo is None or memo[0] != key:
            memo = self.__dict__["_accesses"] = (key, self._walk_accesses())
        return {f: list(v) for f, v in memo[1].items()}

    def _walk_accesses(self) -> Dict[str, List[Offsets]]:
        out: Dict[str, List[Offsets]] = {}
        seen: set = set()      # (field, offsets): linear in the accesses
        assigned: set = set()
        for stmt in self.statements:
            for node in walk(stmt.rhs):
                if isinstance(node, Access) and node.field not in assigned:
                    lst = out.setdefault(node.field, [])
                    if (node.field, node.offsets) not in seen:
                        seen.add((node.field, node.offsets))
                        lst.append(node.offsets)
            assigned.add(stmt.lhs)
        return out

    def input_fields(self) -> List[str]:
        return list(self.accesses().keys())


@dataclasses.dataclass
class Program:
    name: str
    dimensions: Tuple[int, int, int]       # canonical, padded to 3
    raw_dimensions: Tuple[int, ...]        # as written in the JSON
    inputs: Dict[str, InputSpec]
    outputs: List[str]
    kernels: Dict[str, KernelSpec]         # insertion order = JSON order
    vectorization: int = 1
    constants: Dict[str, float] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None             # source file, for relative data paths

    @property
    def total_elements(self) -> int:
        n = 1
        for d in self.dimensions:
            n *= d
        return n

    def field_dim_mask(self, field: str) -> Tuple[bool, bool, bool]:
        if field in self.inputs:
            return self.inputs[field].dim_mask
        # kernel outputs are stored at the full padded 3-D domain shape
        return (True, True, True)

    def field_dtype(self, field: str) -> np.dtype:
        if field in self.inputs:
            return self.inputs[field].dtype
        return self.kernels[field].dtype

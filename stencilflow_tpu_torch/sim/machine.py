"""Cycle-accurate streaming machine (copy of the JAX package's
``sim/machine.py``).

Models the element-per-cycle dataflow schedule of the chain: every kernel is
a processing element with a program counter over the row-major element
stream; producer→consumer edges are bounded ring FIFOs sized by the
delay/line-buffer analysis; kernel pipeline latency is modeled with an
output delay line.  The run has the reference simulator's phase structure —
saturation (warmup), steady streaming, drain — and its proof discipline:
exceeding an edge's computed capacity raises with full pipeline diagnostics
(the reference StencilFlow's simulator.py and kernel.py).

Per-kernel computation is compiled once to a Python closure over the access
values (the reference re-generates and re-parses the kernel string every
cycle, kernel.py:703-706 — its biggest performance sin; we don't repeat it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import ir
from ..backend.promotion import result_type, weak
from ..config import JUNK_VAL
from ..dtypes import BFLOAT16, cast, round_bf16, to_float32
from ..frontend.analysis import ChainAnalysis, flatten_index


class SimulationError(RuntimeError):
    pass


def access_windows(program, analysis):
    """Flat retention window [lo, hi] per (field, consumer), extended to
    the center element where a copy BC needs it."""
    dims = program.dimensions
    windows = {}
    for kname in analysis.graph.kernel_order:
        kspec = program.kernels[kname]
        for field, offs in kspec.accesses().items():
            flat = [flatten_index([x or 0 for x in o], dims) for o in offs]
            lo, hi = min(flat), max(flat)
            bc = kspec.boundary_conditions.get(field)
            if bc is not None and bc.kind == ir.BCKind.COPY:
                lo, hi = min(lo, 0), max(hi, 0)
            windows[(field, kname)] = (lo, hi)
    return windows


def fire_schedule(program, analysis, windows):
    """Self-consistent streaming schedule: F[k] = cycle of kernel k's
    element-0 fire, C[f] = cycle of field f's element-0 emission.

    F[k] = max over read fields f of (C[f] + hi(f, k)) + 1, clamped >= 0;
    C[input] = 0; C[k] = F[k] + latency(k).  This is the machine-exact
    refinement of the reference's delay-alignment model
    (kernel_chain_graph.py:476-559), scalar-valued so asymmetric and
    negative offsets are handled exactly."""
    C = {n: 0 for n in program.inputs}
    F = {}
    for kname in analysis.graph.kernel_order:
        lag = 0
        for f in analysis.graph.producers(kname):
            lo, hi = windows[(f, kname)]
            lag = max(lag, C[f] + hi + 1)
        F[kname] = lag
        C[kname] = lag + analysis.kernel_latencies[kname]
    return F, C


class DeadlockError(SimulationError):
    pass


def edge_capacities(program, analysis, windows=None, slack: int = 0
                    ) -> Dict[Tuple[str, str], int]:
    """Machine-exact static FIFO bound per edge, from the fire schedule.

    Element t of edge (f, c) is pushed at cycle C[f] + t (emit phase) and
    released once c's pc passes t - lo (fire phase, same cycle ordering),
    so with both running exactly on schedule the peak occupancy is
        F[c] - C[f] - lo + 1.
    The emit phase precedes fire within a cycle, so the bound is exact on
    both sides; ``slack=0`` is proven tight by the fuzz corpus (the run
    completes without deadlock at these capacities, and shrinking any
    attained edge by one element would stall its producer).  This supplants
    the reference's elastic 2048-deep FIFO floors
    (sdfg_generator.py:31) with a provable machine-exact bound.
    """
    if windows is None:
        windows = access_windows(program, analysis)
    F, C = fire_schedule(program, analysis, windows)
    caps: Dict[Tuple[str, str], int] = {}
    for (src, dst), eb in analysis.edges.items():
        if (src, dst) not in windows:
            caps[(src, dst)] = 1
            continue
        lo = windows[(src, dst)][0]
        cap = F[dst] - C[src] - lo + 1 + slack
        caps[(src, dst)] = max(cap, eb.internal_size + 1)
    return caps


# ---------------------------------------------------------------------------
# Kernel compilation: IR -> python closure
# ---------------------------------------------------------------------------

class Bf16Scalar:
    """A bfloat16 scalar of this machine (the port has no ml_dtypes): the
    float32 value it holds.  Its sites take the oracle's lattice
    (promotion.result_type, as interpreter.py's bf16 values do): a bf16
    result computes in float32 and rounds once; numpy's ufuncs reach the
    one-argument functions through the methods of their names."""
    __slots__ = ("v",)
    dtype = BFLOAT16

    def __init__(self, x):
        self.v = x.v if isinstance(x, Bf16Scalar) else \
            round_bf16(np.float64(x) if isinstance(x, (int, float))
                       else x)[()]

    def __float__(self):
        return float(self.v)

    def __int__(self):
        return int(self.v)

    def __bool__(self):
        return bool(self.v != 0)

    def __neg__(self):
        return Bf16Scalar(-self.v)

    def __abs__(self):
        return Bf16Scalar(abs(self.v))

    def _fn(name):
        def fn(self):
            return Bf16Scalar(getattr(np, name)(self.v))
        fn.__name__ = name
        return fn

    sin, cos, tan = _fn("sin"), _fn("cos"), _fn("tan")
    sinh, cosh, tanh = _fn("sinh"), _fn("cosh"), _fn("tanh")
    sqrt, exp, log = _fn("sqrt"), _fn("exp"), _fn("log")
    del _fn


def _lattice_type(x):
    if isinstance(x, Bf16Scalar):
        return BFLOAT16
    if isinstance(x, (bool, np.bool_)):
        return np.dtype(np.bool_)
    if isinstance(x, (int, float)):
        return weak(x)
    return np.dtype(x.dtype)


def _bf16_site(op, a, b, ufunc: bool = True):
    """``op(a, b)`` where an operand is a Bf16Scalar."""
    ty = result_type(_lattice_type(a), _lattice_type(b), ufunc=ufunc)

    def conv(x):
        if ty == BFLOAT16:
            return Bf16Scalar(x).v
        return np.dtype(ty).type(x.v if isinstance(x, Bf16Scalar) else x)
    r = op(conv(a), conv(b))
    if ty == BFLOAT16 and not isinstance(r, np.bool_):
        return Bf16Scalar(r)
    return r


def scalar_type(dtype):
    """The scalar constructor of ``dtype`` in this machine."""
    dtype = np.dtype(dtype)
    return Bf16Scalar if dtype == BFLOAT16 else dtype.type


# numpy scalar functions, NOT math.*: the oracle (interpreter.py) computes
# with numpy, where sqrt(-1) is NaN and exp overflow is inf — math.sqrt
# would raise and reject programs the oracle (and the C++ core) evaluate;
# np funcs also keep the narrow dtype (math.sin(np.float32) widens to
# float64, silently breaking per-op rounding downstream); min/max are
# NaN-propagating like np.minimum/np.maximum
_FN_SRC = {
    "sin": "np.sin", "cos": "np.cos", "tan": "np.tan",
    "sinh": "np.sinh", "cosh": "np.cosh", "tanh": "np.tanh",
    "sqrt": "np.sqrt", "exp": "np.exp", "log": "np.log",
    "abs": "np.abs", "min": "_f_min", "max": "_f_max",
}

# binops/compares emit through _b(...)/_c(...) wrappers so mixed
# int x float sites apply the framework's JAX-lattice promotion spec
# (interpreter._match_mixed) before numpy's scalar op — a bare
# `np.int32 * np.float32` would compute float64, which the kernels
# do not compute
_BIN_SRC = {"add": "_b_add", "sub": "_b_sub", "mult": "_b_mult",
            "div": "_b_div"}
_CMP_SRC = {"lt": "_c_lt", "le": "_c_le", "gt": "_c_gt", "ge": "_c_ge",
            "eq": "_c_eq", "ne": "_c_ne"}


def _expr_src(expr: ir.Expr, access_ids: Dict[Tuple[str, ir.Offsets], int]
              ) -> str:
    if isinstance(expr, ir.Const):
        # _dt pins float consts to the kernel dtype (see compile_kernel_fn)
        # so numpy-scalar ops round per-op like every other engine
        if isinstance(expr.value, float):
            return f"_dt({expr.value!r})"
        return repr(expr.value)
    if isinstance(expr, ir.Ref):
        return f"_t_{expr.name}"
    if isinstance(expr, ir.Access):
        return f"v[{access_ids[(expr.field, expr.offsets)]}]"
    if isinstance(expr, ir.BinOp):
        return (f"{_BIN_SRC[expr.op]}({_expr_src(expr.left, access_ids)}, "
                f"{_expr_src(expr.right, access_ids)})")
    if isinstance(expr, ir.UnaryOp):
        return f"(-{_expr_src(expr.operand, access_ids)})"
    if isinstance(expr, ir.Compare):
        return (f"{_CMP_SRC[expr.op]}({_expr_src(expr.left, access_ids)}, "
                f"{_expr_src(expr.right, access_ids)})")
    if isinstance(expr, ir.BoolOp):
        # BITWISE &/| like the oracle (interpreter.py _eval): python
        # `and`/`or` would return an OPERAND (short-circuit value
        # semantics) where the oracle reduces with & — on ints the two
        # genuinely differ (4 and 3 -> 3, but 4 & 3 -> 0), and on floats
        # the oracle raises TypeError where `and` silently succeeds
        joiner = " & " if expr.op == "and" else " | "
        return "(" + joiner.join(_expr_src(o, access_ids)
                                 for o in expr.operands) + ")"
    if isinstance(expr, ir.Select):
        # _sel promotes the taken branch to np.result_type(a, b) like the
        # oracle's np.where (a bare python conditional would keep the
        # branch's own type, diverging in mixed-dtype kernels)
        return (f"_sel({_expr_src(expr.cond, access_ids)}, "
                f"{_expr_src(expr.if_true, access_ids)}, "
                f"{_expr_src(expr.if_false, access_ids)})")
    if isinstance(expr, ir.Call):
        args = ", ".join(_expr_src(a, access_ids) for a in expr.args)
        return f"{_FN_SRC[expr.fn]}({args})"
    raise TypeError(f"unknown expression node {type(expr)}")


def compile_kernel_fn(kspec: ir.KernelSpec,
                      access_ids: Dict[Tuple[str, ir.Offsets], int]
                      ) -> Callable[[List[float]], float]:
    """Compile the kernel's statements to ``fn(access_values) -> result``."""
    lines = ["def _kernel(v):"]
    for stmt in kspec.statements:
        lines.append(f"    _t_{stmt.lhs} = "
                     f"{_expr_src(stmt.rhs, access_ids)}")
    lines.append(f"    return _t_{kspec.output_statement.lhs}")
    src = "\n".join(lines)
    dt = np.dtype(kspec.dtype)
    from ..dtypes import is_floating
    # Type-pair memos: np.result_type over two scalars depends only on
    # their TYPES under NEP 50 (numpy scalars strong, python int/float
    # weak), and every site sees the same operand types each cycle —
    # the innermost loop pays dict lookups, not dtype dispatch
    # (this engine is already the 100-1000x fallback).
    _rt_memo: Dict[Tuple[type, type], Any] = {}
    _mx_memo: Dict[Tuple[type, type], Any] = {}
    _MISS = object()

    def _mx(a, b):
        """interpreter._match_mixed for scalars: a strong int/bool
        meeting a strong float converts to that float dtype (the
        framework's JAX-lattice mixed-promotion spec)."""
        key = (type(a), type(b))
        cast = _mx_memo.get(key, _MISS)
        if cast is _MISS:
            from ..dtypes import is_floating as _isf
            da = getattr(a, "dtype", None)
            db = getattr(b, "dtype", None)
            cast = None
            if da is not None and db is not None:
                fa, fb = _isf(da), _isf(db)
                if fa and not fb and np.dtype(db).kind in "iub":
                    cast = (1, scalar_type(da))
                elif fb and not fa and np.dtype(da).kind in "iub":
                    cast = (0, scalar_type(db))
            _mx_memo[key] = cast
        if cast is None:
            return a, b
        side, ty = cast
        return (a, ty(b)) if side else (ty(a), b)

    def _mk_bin(op):
        def f(a, b, op=op):
            a, b = _mx(a, b)
            if isinstance(a, Bf16Scalar) or isinstance(b, Bf16Scalar):
                return _bf16_site(op, a, b)
            return op(a, b)
        return f

    import operator as _op

    def _sel(c, a, b):
        # np.where semantics: promote to result_type and CONVERT with
        # astype's wraparound (np.where(c, 300, int8) is 44; r.type(300)
        # would raise OverflowError — the ufunc rule, not where's).
        # Only python ints need the astype detour; everything else takes
        # the cheap scalar constructor (this runs per element).
        a, b = _mx(a, b)
        if isinstance(a, Bf16Scalar) or isinstance(b, Bf16Scalar):
            return _bf16_site(lambda x, y: x if c else y, a, b,
                              ufunc=False)
        key = (type(a), type(b))
        r = _rt_memo.get(key)
        if r is None:
            r = _rt_memo[key] = np.result_type(a, b)
        v = a if c else b
        if type(v) is int:
            return np.asarray(v).astype(r)[()]
        return r.type(v)

    ns: Dict[str, Any] = {
        "np": np,
        # float consts pin to the kernel dtype (floating kernels) or
        # float32 (non-floating — the framework's defined semantics;
        # see interpreter.eval_kernel)
        "_dt": scalar_type(dt) if is_floating(dt) else np.float32,
        "_sel": _sel,
        "_b_add": _mk_bin(_op.add), "_b_sub": _mk_bin(_op.sub),
        "_b_mult": _mk_bin(_op.mul), "_b_div": _mk_bin(_op.truediv),
        "_c_lt": _mk_bin(_op.lt), "_c_le": _mk_bin(_op.le),
        "_c_gt": _mk_bin(_op.gt), "_c_ge": _mk_bin(_op.ge),
        "_c_eq": _mk_bin(_op.eq), "_c_ne": _mk_bin(_op.ne),
        "_f_min": _mk_bin(np.minimum), "_f_max": _mk_bin(np.maximum),
    }
    exec(src, ns)  # noqa: S102 — source is generated from the typed IR
    return ns["_kernel"]


# ---------------------------------------------------------------------------
# Machine structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Edge:
    src: str
    dst: str
    capacity: int
    data: List[float] = dataclasses.field(default_factory=list)
    base: int = 0          # flat index of data[0] in the element stream
    arrived: int = 0       # #elements pushed so far
    high_water: int = 0
    occ_sum: int = 0       # Σ occupancy over cycles (mean = occ_sum/cycles)

    def occupancy(self) -> int:
        return self.arrived - self.base

    def push(self, value: float) -> bool:
        if self.occupancy() >= self.capacity:
            return False
        self.data.append(value)
        self.arrived += 1
        self.high_water = max(self.high_water, self.occupancy())
        return True

    def peek(self, flat_idx: int) -> float:
        # Proof discipline, underflow side (the reference's BoundedQueue
        # raised on both over- and underflow, bounded_queue.py:121-139):
        # a read below base is a released/stale element, above arrived a
        # not-yet-produced one — both are scheduling bugs, never silently
        # served.
        if not self.base <= flat_idx < self.arrived:
            raise SimulationError(
                f"stale/underflow read on edge {self.src}->{self.dst}: "
                f"element {flat_idx} outside live window "
                f"[{self.base}, {self.arrived})")
        return self.data[flat_idx - self.base]

    def release_to(self, new_base: int) -> None:
        """Drop elements below ``new_base`` (no longer readable); clamped
        to what has actually arrived."""
        new_base = min(new_base, self.arrived)
        if new_base > self.base:
            del self.data[:new_base - self.base]
            self.base = new_base


@dataclasses.dataclass
class _AccessPlan:
    field: str
    offsets: ir.Offsets
    flat_offset: int
    # the SOURCE node's dtype: edges carry the producer's type (the oracle
    # evaluates with each field array in its own dtype and casts only the
    # kernel result, interpreter.py:eval_kernel) — values are cast to this
    # on read, NOT to the consumer's kernel dtype
    src_dtype: Any = float


@dataclasses.dataclass
class _KernelState:
    name: str
    fn: Callable
    accesses: List[_AccessPlan]
    in_edges: Dict[str, _Edge]
    out_edges: List[_Edge]
    latency: int
    bcs: Dict[str, ir.BoundaryCondition]
    dtype: Any
    pace: int = 0   # model start cycle: element t fires no earlier than pace+t
    # per-edge stream window [t+min_off, t+max_off]
    min_off: Dict[str, int] = dataclasses.field(default_factory=dict)
    max_off: Dict[str, int] = dataclasses.field(default_factory=dict)
    pc: int = 0
    pipeline: List[Tuple[int, int, float]] = dataclasses.field(
        default_factory=list)  # (ready_cycle, flat_idx, value)
    first_fire: Optional[int] = None
    last_fire: Optional[int] = None
    stall_cycles: int = 0


@dataclasses.dataclass
class SimResult:
    outputs: Dict[str, np.ndarray]
    cycles: int
    edge_high_water: Dict[Tuple[str, str], int]
    kernel_stats: Dict[str, Dict[str, Any]]
    # mean FIFO occupancy over the whole run (reference: the per-buffer
    # mean in kernel.py:117-164's performance printout)
    edge_mean_occupancy: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)


class Simulator:
    """Build + run the streaming machine for one program."""

    def __init__(self, program: ir.Program,
                 analysis: Optional[ChainAnalysis] = None,
                 slack: int = 0):
        self.program = program
        self.analysis = analysis or ChainAnalysis.run(program)
        self.graph = self.analysis.graph
        self.dims = program.dimensions
        self.N = program.total_elements
        self.slack = slack
        self._build()

    # -- construction --------------------------------------------------------
    def _build(self):
        program, graph, analysis = self.program, self.graph, self.analysis
        self.edges: Dict[Tuple[str, str], _Edge] = {}
        self.kernels: Dict[str, _KernelState] = {}

        self._windows = access_windows(program, analysis)
        self._F, self._C = fire_schedule(program, analysis, self._windows)
        self._pace = self._F

        # Capacity: the machine-exact static bound (see edge_capacities;
        # slack defaults to 0 — proven tight across the fuzz corpus).
        for key, cap in edge_capacities(program, analysis, self._windows,
                                        self.slack).items():
            self.edges[key] = _Edge(key[0], key[1], cap)

        for kname in graph.kernel_order:
            kspec = program.kernels[kname]
            acc_map = kspec.accesses()
            access_ids: Dict[Tuple[str, ir.Offsets], int] = {}
            plans: List[_AccessPlan] = []
            for field, offs in acc_map.items():
                if field in program.inputs:
                    sdt = scalar_type(program.inputs[field].dtype)
                else:
                    sdt = scalar_type(program.kernels[field].dtype)
                for o in offs:
                    access_ids[(field, o)] = len(plans)
                    plans.append(_AccessPlan(
                        field, o, flatten_index(
                            [x or 0 for x in o], self.dims), sdt))
            in_edges = {f: self.edges[(f, kname)] for f in acc_map}
            st = _KernelState(
                name=kname,
                fn=compile_kernel_fn(kspec, access_ids),
                accesses=plans,
                in_edges=in_edges,
                out_edges=[],
                latency=analysis.kernel_latencies[kname],
                bcs=kspec.boundary_conditions,
                dtype=scalar_type(kspec.dtype),
                pace=self._pace[kname],
            )
            for f in acc_map:
                st.min_off[f], st.max_off[f] = self._windows[(f, kname)]
            self.kernels[kname] = st

        for (src, dst), e in self.edges.items():
            if src in self.kernels:
                self.kernels[src].out_edges.append(e)

        # scalar inputs are compile-time values on every access (typed
        # numpy scalars — int64 magnitudes stay exact)
        self.scalars: Dict[str, np.generic] = {}

    # -- helpers -------------------------------------------------------------
    def _coords(self, flat: int) -> Tuple[int, int, int]:
        I, J, K = self.dims
        return (flat // (J * K), (flat // K) % J, flat % K)

    def _is_oob(self, flat: int, offsets: ir.Offsets) -> bool:
        i, j, k = self._coords(flat)
        pos = (i, j, k)
        for d, o in enumerate(offsets):
            if o is None or o == 0:
                continue
            t = pos[d] + o
            if t < 0 or t >= self.dims[d]:
                return True
        return False

    def _read_access(self, st: _KernelState, plan: _AccessPlan, t: int):
        if plan.field in self.scalars:
            return self.scalars[plan.field]
        bc = st.bcs.get(plan.field)
        if self._is_oob(t, plan.offsets):
            if bc is None or bc.kind == ir.BCKind.CONSTANT:
                return bc.value if bc is not None else 0.0
            if bc.kind == ir.BCKind.SHRINK:
                return JUNK_VAL
            if bc.kind == ir.BCKind.COPY:
                return st.in_edges[plan.field].peek(t)
            raise SimulationError(f"unknown BC {bc!r}")
        return st.in_edges[plan.field].peek(t + plan.flat_offset)

    def _can_fire(self, st: _KernelState, cycle: int) -> bool:
        t = st.pc
        if t >= self.N:
            return False
        if cycle < st.pace + t:
            return False  # paced to the model schedule (buffer-bound proof)
        for f, e in st.in_edges.items():
            if f in self.scalars:
                continue
            need = min(self.N, t + st.max_off[f] + 1)
            if e.arrived < need:
                return False
        return True

    # -- run -----------------------------------------------------------------
    def run(self, inputs: Dict[str, Any],
            trace: Optional[Any] = None) -> SimResult:
        """``trace``: a path or writable file — stream one CSV row per
        cycle (program counters of every kernel, then the occupancy of
        every edge FIFO), the reference's FULL-log per-cycle dump
        (simulator.py:189-205) in a greppable/plottable form.  Closed
        (when opened here) even when the run raises, so the cycles
        leading up to a failure are on disk."""
        trace_fh = None
        if trace is not None:
            trace_fh = (open(trace, "w") if isinstance(trace, (str,
                        bytes, os.PathLike)) else trace)
            cols = (["cycle"] + [f"pc:{k}" for k in self.kernels] +
                    [f"occ:{s}->{d}" for (s, d) in self.edges])
            trace_fh.write(",".join(cols) + "\n")
        try:
            # numpy scalar math may legitimately produce NaN/inf (the
            # oracle's semantics, e.g. sqrt of a shrink-BC junk halo) —
            # suppress the RuntimeWarnings, don't turn them into noise
            with np.errstate(all="ignore"):
                return self._run(inputs, trace_fh)
        finally:
            if trace_fh is not None and trace_fh is not trace:
                trace_fh.close()

    def _run(self, inputs: Dict[str, Any], trace_fh) -> SimResult:
        program = self.program
        N = self.N

        input_arrays: Dict[str, np.ndarray] = {}
        input_sent: Dict[Tuple[str, str], int] = {}
        for name, spec in program.inputs.items():
            arr = np.asarray(inputs[name])
            if np.dtype(spec.dtype) == BFLOAT16:   # its float32 values
                arr = to_float32(cast(arr, BFLOAT16))
                if spec.is_scalar:
                    self.scalars[name] = Bf16Scalar(arr.reshape(())[()])
                    continue
            if spec.is_scalar:
                # keep the typed numpy scalar: a python-float detour was
                # the machine's 2^53 envelope on int64 SCALARS (access
                # reads re-cast via src_dtype).  reshape(()): a scalar
                # given as a shape-(1,) array is the 0-d scalar it stands
                # for (the original stores a 1-element array here)
                self.scalars[name] = arr.astype(spec.dtype).reshape(())[()]
                continue
            full = np.broadcast_to(
                arr.reshape(tuple(d if m else 1
                                  for d, m in zip(self.dims, spec.dim_mask))),
                tuple(self.dims)).reshape(-1)
            input_arrays[name] = full
            for dst in self.graph.consumers(name):
                input_sent[(name, dst)] = 0

        # a bf16 output collects its float32 values, cast at the end
        out_arrays = {o: np.zeros(N, dtype=np.float32 if np.dtype(
                          program.kernels[o].dtype) == BFLOAT16 else
                          program.kernels[o].dtype)
                      for o in program.outputs}
        out_pc = {o: 0 for o in program.outputs}

        cycle = 0
        stagnant = 0
        max_stall = 4 * (N + self.analysis.critical_path_cycles + 64)
        order = self.graph.kernel_order

        while any(pc < N for pc in out_pc.values()):
            progressed = False

            # kernels: emit due pipeline results to out edges (and outputs).
            # Edges whose consumer already finished are drained sinks —
            # discard into them (the pipeline's drain phase).
            for kname in order:
                st = self.kernels[kname]
                while st.pipeline and st.pipeline[0][0] <= cycle:
                    _, idx, value = st.pipeline[0]
                    ok = all(e.occupancy() < e.capacity or
                             self.kernels[e.dst].pc >= N
                             for e in st.out_edges)
                    if not ok:
                        st.stall_cycles += 1
                        break
                    for e in st.out_edges:
                        if self.kernels[e.dst].pc < N:
                            e.push(value)
                    if kname in out_arrays and out_pc[kname] == idx:
                        out_arrays[kname][idx] = value
                        out_pc[kname] = idx + 1
                    st.pipeline.pop(0)
                    progressed = True

            # kernels: fire
            for kname in order:
                st = self.kernels[kname]
                # warmup discard: elements below the access window are never
                # read — release them even before the first fire
                # (reference: dist_to_center warmup, kernel.py:166-174)
                for f, e in st.in_edges.items():
                    if f not in self.scalars:
                        e.release_to(st.pc + st.min_off[f])
                if not self._can_fire(st, cycle):
                    continue
                t = st.pc
                # evaluate with each access in its PRODUCER's dtype (numpy
                # scalar promotion then bit-matches the array oracle, which
                # keeps field arrays in their own dtypes and casts only the
                # kernel result)
                vals = [p.src_dtype(self._read_access(st, p, t))
                        for p in st.accesses]
                try:
                    res = st.dtype(st.fn(vals))
                except (ValueError, OverflowError, ZeroDivisionError) as exc:
                    raise SimulationError(
                        f"{kname}@{t}: {exc}") from exc
                # keep the numpy scalar: converting through python float
                # here was the machine's own 2^53 transport envelope for
                # int64 results (closed with the native core's typed
                # edges); floats are already exact
                st.pipeline.append((cycle + st.latency, t, res))
                if st.first_fire is None:
                    st.first_fire = cycle
                st.last_fire = cycle
                st.pc = t + 1
                for f, e in st.in_edges.items():
                    if f in self.scalars:
                        continue
                    e.release_to(st.pc + st.min_off[f])
                progressed = True

            # inputs feed successor edges (one element/cycle/edge);
            # finished consumers absorb silently
            for name, arr in input_arrays.items():
                for dst in self.graph.consumers(name):
                    sent = input_sent[(name, dst)]
                    if sent >= N:
                        continue
                    if self.kernels[dst].pc >= N:
                        input_sent[(name, dst)] = N
                        continue
                    e = self.edges[(name, dst)]
                    if e.push(arr[sent]):
                        input_sent[(name, dst)] = sent + 1
                        progressed = True

            if trace_fh is not None:
                row = ([str(cycle)] +
                       [str(st.pc) for st in self.kernels.values()] +
                       [str(e.occupancy()) for e in self.edges.values()])
                trace_fh.write(",".join(row) + "\n")
            for e in self.edges.values():
                e.occ_sum += e.occupancy()
            cycle += 1
            stagnant = 0 if progressed else stagnant + 1
            # pipeline latencies can legitimately idle for O(max op latency)
            if stagnant > 2048 or cycle > max_stall:
                raise DeadlockError(self.diagnostics(cycle, out_pc))

        outputs = {
            o: cast(out_arrays[o], program.kernels[o].dtype).reshape(
                program.raw_dimensions)
            for o in program.outputs
        }
        stats = {
            k: {"first_fire": st.first_fire, "last_fire": st.last_fire,
                "stall_cycles": st.stall_cycles, "pc": st.pc}
            for k, st in self.kernels.items()
        }
        return SimResult(
            outputs=outputs,
            cycles=cycle,
            edge_high_water={k: e.high_water
                             for k, e in self.edges.items()},
            kernel_stats=stats,
            edge_mean_occupancy={k: e.occ_sum / max(cycle, 1)
                                 for k, e in self.edges.items()},
        )

    # -- diagnostics ---------------------------------------------------------
    def diagnostics(self, cycle: int, out_pc: Dict[str, int]) -> str:
        lines = [f"simulation stalled at cycle {cycle}"]
        for o, pc in out_pc.items():
            lines.append(f"  output {o}: {pc}/{self.N}")
        for kname, st in self.kernels.items():
            lines.append(
                f"  kernel {kname}: pc={st.pc} pipeline={len(st.pipeline)} "
                f"stalls={st.stall_cycles}")
            for f, e in st.in_edges.items():
                lines.append(
                    f"    edge {f}->{kname}: occ={e.occupancy()}/"
                    f"{e.capacity} arrived={e.arrived} high={e.high_water}")
        return "\n".join(lines)

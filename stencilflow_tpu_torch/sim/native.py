"""Native simulator core: per-program C++ code generation (copy of the
JAX package's ``sim/native.py``; ``generate_cpp`` emits the same text).

The reference's native code is *generated* (DaCe emits OpenCL/HLS C++ from
the SDFG, README.md:43-48); we mirror that architecture for the simulator:
the streaming machine (machine.py) is specialized into a self-contained C++
translation unit for one program — kernels unrolled, expressions inlined,
ring capacities baked — compiled with g++ into a shared object and driven
through ctypes.  Semantics are identical to the Python machine (same fire /
emit / feed phases, same overflow-as-proof discipline); throughput is two to
three orders of magnitude higher, which is what makes cycle-accurate
validation of large domains practical (the reference's pure-Python simulator
is documented as too slow for exactly this, SURVEY.md §2.2).

Compiled objects are cached under ``stencilflow_tpu_torch/_build/sim/``
(git-ignored), keyed by source hash: built at first use from the
generated source, never shared with the JAX package's cache.

Integer and bool kernels run natively with numpy scalar semantics (typed
expression emitter, per-dtype wraparound, true division to float64, weak
python-int constants — see ``_expr_cpp_typed``).  FIFO transport is
TYPED per edge by the producer's dtype: int64 edges carry long long and
int64 scalar inputs cross the ABI bit-for-bit (bit-exact at any
magnitude); everything else embeds exactly in double.  The bfloat16
branches are kept as in the original (the port's parser refuses
bfloat16 today), so the generated text stays the original's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import ir
from ..backend.codegen import _host_cast_sentinels
from ..backend.codegen import _i64 as _cpp_i64
from ..config import JUNK_VAL
from ..dtypes import is_floating
from ..frontend.analysis import ChainAnalysis, flatten_index
from .machine import (SimResult, SimulationError, access_windows,
                      edge_capacities, fire_schedule)


class NativeBuildError(SimulationError):
    """g++ unavailable or compile failure — callers fall back to Python."""


_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "sim")

_FN_CPP = {
    "sin": "std::sin", "cos": "std::cos", "tan": "std::tan",
    "sinh": "std::sinh", "cosh": "std::cosh", "tanh": "std::tanh",
    "sqrt": "std::sqrt", "exp": "std::exp", "log": "std::log",
    # NaN-propagating like the numpy oracle (np.minimum/np.maximum);
    # std::fmin/fmax would SUPPRESS a NaN operand
    "abs": "std::fabs", "min": "sf_min", "max": "sf_max",
}
_BIN_CPP = {"add": "+", "sub": "-", "mult": "*", "div": "/"}
_CMP_CPP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
            "eq": "==", "ne": "!="}

# per-op rounding wrapper by kernel dtype (matching the numpy oracle's
# narrow-scalar semantics); transcendental calls evaluate in double and
# round once, which is exact for sqrt and within 1 ulp for sin/exp/...
_RND_CPP = {
    "f64": "({})",
    "f32": "(double)(float)({})",
    "f16": "(double)(_Float16)({})",
    "bf16": "rnd_bf16({})",
}

# integer kernels: C storage type + the double->int cast helper that
# reproduces numpy's float->int conversion (numpy casts through a 32-bit
# cvttsd2si for widths <= 32 — out-of-range values land on INT32_MIN whose
# low bits the narrow store keeps — and a 64-bit one for int64)
_INT_CT = {
    "i8": ("int8_t", "sf_d2i32"),
    "i16": ("int16_t", "sf_d2i32"),
    "i32": ("int32_t", "sf_d2i32"),
    "i64": ("int64_t", "sf_d2i64"),
}


def _round_mode(dtype) -> str:
    """Rounding-wrapper key for a FLOATING dtype (the per-op-rounding
    emitter and _rnd_of; int/bool kernels go through the typed emitter
    and never ask for a rounding mode)."""
    dt = np.dtype(dtype)
    if dt == np.float64:
        return "f64"
    if dt == np.float32:
        return "f32"
    if dt == np.float16:
        return "f16"
    if dt.name == "bfloat16":
        return "bf16"
    raise NativeBuildError(
        f"native simulator: no rounding mode for dtype {dt.name}")


def _expr_cpp(expr: ir.Expr, access_ids: Dict[Tuple[str, ir.Offsets], int],
              mode: str = "f64",
              bool_temps: frozenset = frozenset()) -> str:
    """C++ source for an expression; every operation result is rounded to
    the kernel dtype (``mode``), matching numpy narrow-scalar semantics.
    ``bool_temps``: statement names whose value is bool (comparison
    results) — legal operands for and/or."""
    def rnd(src: str) -> str:
        return _RND_CPP[mode].format(f"({src})")

    rec = lambda e: _expr_cpp(e, access_ids, mode, bool_temps)
    if isinstance(expr, ir.Const):
        # pin float consts to the kernel dtype so every op sees the same
        # operand bits as the numpy oracle (per-op rounding)
        if mode != "f64" and isinstance(expr.value, float):
            return f"({rnd(repr(expr.value))})"
        return f"{expr.value!r}"
    if isinstance(expr, ir.Ref):
        return f"t_{expr.name}"
    if isinstance(expr, ir.Access):
        return f"v{access_ids[(expr.field, expr.offsets)]}"
    if isinstance(expr, ir.BinOp):
        return rnd(f"{rec(expr.left)} {_BIN_CPP[expr.op]} {rec(expr.right)}")
    if isinstance(expr, ir.UnaryOp):
        return f"(-{rec(expr.operand)})"
    if isinstance(expr, ir.Compare):
        return (f"(double)({rec(expr.left)} "
                f"{_CMP_CPP[expr.op]} {rec(expr.right)})")
    if isinstance(expr, ir.BoolOp):
        # only bool-valued operands (comparisons, or temps holding
        # comparison results) reach && soundly: the oracle reduces
        # and/or with bitwise &/|, which RAISES on floats — route
        # anything else to the Python machine, which mirrors that
        if not all(isinstance(o, (ir.Compare, ir.BoolOp))
                   or (isinstance(o, ir.Ref) and o.name in bool_temps)
                   for o in expr.operands):
            raise NativeBuildError(
                "and/or on non-comparison operands: the oracle's "
                "bitwise &/| rejects floats; Python machine fallback")
        op = "&&" if expr.op == "and" else "||"
        inner = f" {op} ".join(f"({rec(o)} != 0.0)" for o in expr.operands)
        return f"(double)({inner})"
    if isinstance(expr, ir.Select):
        return (f"(({rec(expr.cond)} != 0.0) ? "
                f"{rec(expr.if_true)} : {rec(expr.if_false)})")
    if isinstance(expr, ir.Call):
        args = ", ".join(rec(a) for a in expr.args)
        return rnd(f"{_FN_CPP[expr.fn]}({args})")
    raise TypeError(f"unknown expression node {type(expr)}")


# --- typed expression emitter (int / bool / mixed-dtype kernels) -----------
#
# The oracle (interpreter.py) evaluates each kernel with every field array
# kept in its PRODUCER's dtype, numpy promotion per op, and one cast of the
# kernel result to the kernel dtype.  Uniform floating kernels (every access
# already the kernel dtype) keep the proven `_expr_cpp` per-op-rounding
# emitter above; everything else — integer and bool kernels, mixed-dtype
# chains — goes through this emitter, which tracks each node's numpy result
# dtype (np.result_type, with python-int/float constants kept weak per
# NEP 50) and emits C++ with the matching arithmetic: same-width wraparound
# for ints (-fwrapv), true division to float64, per-op rounding for narrow
# floats, np.where-style branch promotion for selects.

# Weak (python-scalar) node types carry their VALUE: weakness only arises
# from constants and arithmetic over constants, so the value is always
# known at codegen — which lets the emitter reproduce NEP 50's
# OverflowError acceptance (np.int8(x) + 300 raises in the oracle) by
# refusing such programs into the Python machine.
_WI, _WF = "wi", "wf"   # tag of ("wi", int_value) / ("wf", float_value)


def _is_weak(ty) -> bool:
    return isinstance(ty, tuple)


def _is_flt(ty) -> bool:
    if _is_weak(ty):
        return ty[0] == _WF
    return isinstance(ty, np.dtype) and is_floating(ty)


def _is_bool(ty) -> bool:
    return isinstance(ty, np.dtype) and ty.kind == "b"


def _res_ty(*tys):
    """Result dtype at a binary site: numpy NEP 50 weak-scalar
    semantics, EXCEPT that a strong integer/bool meeting a strong float
    takes that float dtype — the framework's JAX-lattice mixed-promotion
    spec (interpreter._match_mixed; numpy alone would widen int32 x
    float32 to float64, which the kernels do not compute).  Raises
    NativeBuildError (-> Python machine fallback) when numpy itself
    rejects a promotion (e.g. ml_dtypes bf16 x weak float)."""
    if all(_is_weak(t) for t in tys):
        return (_WF, None) if any(t[0] == _WF for t in tys) \
            else (_WI, None)
    strong = [t for t in tys if not _is_weak(t)]
    flts = [t for t in strong if is_floating(t)]
    if flts and any(np.dtype(t).kind in "iub" for t in strong):
        # mixed spec: ints convert to the float side (weak scalars
        # cannot override a strong float under NEP 50 either)
        args = [t for t in flts]
    else:
        args = [(1 if t[0] == _WI else 1.0) if _is_weak(t) else t
                for t in tys]
    try:
        return np.result_type(*args)
    except Exception as exc:   # e.g. DTypePromotionError (bf16 x int)
        raise NativeBuildError(
            f"numpy rejects the dtype promotion {tys}: {exc}") from exc


def _check_weak_fits(rd, *tys):
    """NEP 50 UFUNC rule: a weak python int out of range for the result
    dtype raises OverflowError in the oracle's arithmetic (np.add,
    np.minimum, ...) — but NOT in np.where, which wraps, nor in
    comparisons; call this only at ufunc-shaped sites."""
    if not (isinstance(rd, np.dtype) and rd.kind in "iu"):
        return
    for t in tys:
        if (_is_weak(t) and t[0] == _WI and t[1] is not None
                and not (np.iinfo(rd).min <= t[1] <= np.iinfo(rd).max)):
            raise NativeBuildError(
                f"python int {t[1]} out of bounds for {rd} (NEP 50 "
                "OverflowError in the oracle)")


def _ct_of(ty) -> str:
    """C storage type for a node type (floats live in rounded doubles)."""
    if _is_weak(ty):
        return "long long" if ty[0] == _WI else "double"
    if _is_flt(ty):
        return "double"
    if _is_bool(ty):
        return "bool"
    return _INT_CT[f"i{8 * ty.itemsize}"][0]


def _rnd_of(ty):
    """Per-op rounding wrapper for a floating node type."""
    if _is_weak(ty):
        return "({})".format
    return _RND_CPP[_round_mode(ty)].format


def _cast_double_to(src: str, ty) -> str:
    """Cast a double-valued C++ expr to a concrete numpy dtype's value."""
    if _is_bool(ty):
        return f"(({src}) != 0.0)"
    if _is_flt(ty):
        return _rnd_of(ty)(f"({src})")
    ct, castfn = _INT_CT[f"i{8 * ty.itemsize}"]
    return f"({ct}){castfn}({src})"


def _truthy(src: str, ty) -> str:
    if _is_bool(ty):
        return f"({src})"
    return f"(({src}) != {'0.0' if _is_flt(ty) else '0'})"


def _expr_cpp_typed(expr: ir.Expr,
                    access_ids: Dict[Tuple[str, ir.Offsets], int],
                    acc_tys: List[Any], kdt: np.dtype,
                    stypes: Dict[str, Any]) -> Tuple[str, Any]:
    """C++ source + inferred numpy type for one expression node."""
    def rec(e):
        return _expr_cpp_typed(e, access_ids, acc_tys, kdt, stypes)

    def to_ty(src: str, src_ty, ty) -> str:
        """Convert a value of node type src_ty to node type ty."""
        if src_ty == ty:
            return src
        if _is_flt(ty):
            return _rnd_of(ty)(f"(double)({src})")
        if _is_bool(ty):
            return _truthy(src, src_ty)
        ct = _ct_of(ty)
        if _is_flt(src_ty):
            castfn = _INT_CT[f"i{8 * ty.itemsize}"][1]
            return f"({ct}){castfn}((double)({src}))"
        return f"({ct})({src})"

    def strong(ty):
        """numpy funcs MATERIALIZE weak python scalars into strong
        float64/int64 (np.where, np.minimum, np.abs — unlike plain
        python arithmetic, which keeps them weak in the oracle)."""
        if not _is_weak(ty):
            return ty
        return np.dtype(np.int64 if ty[0] == _WI else np.float64)

    def weak_const(v):
        if isinstance(v, int) and not isinstance(v, bool):
            return f"({v}LL)", (_WI, v)
        return f"{float(v)!r}", (_WF, float(v))

    if isinstance(expr, ir.Const):
        if isinstance(expr.value, bool):
            return ("true" if expr.value else "false"), np.dtype(bool)
        if isinstance(expr.value, float):
            # float consts pin to the kernel dtype (floating kernels) or
            # float32 (non-floating — the framework's defined semantics;
            # see interpreter.eval_kernel)
            pin = kdt if is_floating(kdt) else np.dtype(np.float32)
            v = float(np.asarray(expr.value, np.float64).astype(pin))
            return f"{v!r}", pin
        return weak_const(expr.value)
    if isinstance(expr, ir.Ref):
        return f"t_{expr.name}", stypes[expr.name]
    if isinstance(expr, ir.Access):
        idx = access_ids[(expr.field, expr.offsets)]
        return f"v{idx}", acc_tys[idx]
    if isinstance(expr, ir.BinOp):
        l, lt = rec(expr.left)
        r, rt = rec(expr.right)
        if _is_weak(lt) and _is_weak(rt):
            # plain python arithmetic over constants: fold, stay weak
            try:
                v = {"add": lambda a, b: a + b,
                     "sub": lambda a, b: a - b,
                     "mult": lambda a, b: a * b,
                     "div": lambda a, b: a / b}[expr.op](lt[1], rt[1])
            except ZeroDivisionError as exc:
                raise NativeBuildError(
                    "constant division by zero raises in the oracle; "
                    "Python machine fallback") from exc
            return weak_const(v)
        ty = _res_ty(lt, rt)
        _check_weak_fits(ty, lt, rt)   # arithmetic is a ufunc
        if expr.op == "div":   # numpy true division: ints go to float64
            if not _is_flt(ty):
                ty = np.dtype(np.float64)
            return (_rnd_of(ty)(f"(double)({l}) / (double)({r})"), ty)
        sym = _BIN_CPP[expr.op]
        if _is_bool(ty):       # numpy bool_ arithmetic: + is OR, * is AND
            if expr.op == "add":
                return f"(({l}) || ({r}))", ty
            if expr.op == "mult":
                return f"(({l}) && ({r}))", ty
            raise NativeBuildError(
                "bool - bool is a TypeError in numpy (the oracle rejects "
                "this program); Python machine fallback")
        if _is_flt(ty):
            # operands whose type differs from the promoted float dtype
            # convert FIRST (numpy/oracle semantics: the mixed int x
            # float spec casts the int to the float dtype, rounding it,
            # BEFORE the op — computing in double and rounding once
            # would double-round differently for |int| > 2^24 at f32)
            l2 = l if lt == ty else to_ty(l, lt, ty)
            r2 = r if rt == ty else to_ty(r, rt, ty)
            return _rnd_of(ty)(f"(double)({l2}) {sym} (double)({r2})"), ty
        ct = _ct_of(ty)        # same-width integer wraparound per op
        return f"({ct})(({ct})({l}) {sym} ({ct})({r}))", ty
    if isinstance(expr, ir.UnaryOp):
        o, ot = rec(expr.operand)
        if _is_bool(ot):
            raise NativeBuildError(
                "unary minus on bool is a TypeError in numpy; Python "
                "machine fallback")
        if _is_weak(ot):
            return weak_const(-ot[1])
        if _is_flt(ot):
            return f"(-({o}))", ot
        ct = _ct_of(ot)
        return f"({ct})(-({ct})({o}))", ot
    if isinstance(expr, ir.Compare):
        l, lt = rec(expr.left)
        r, rt = rec(expr.right)
        # numpy compares in the promoted dtype; no _check_weak_fits —
        # comparisons do NOT raise on out-of-range weak ints.  Mixed
        # int x float sites promote to the FLOAT dtype (the framework's
        # JAX-lattice spec), so the int operand must round through f32
        # before an f32 compare — a bare C compare would promote both
        # to double (exact) and diverge from the other engines.
        ty = _res_ty(lt, rt)
        if isinstance(ty, np.dtype) and _is_flt(ty):
            l, r = to_ty(l, lt, ty), to_ty(r, rt, ty)
        return f"(({l}) {_CMP_CPP[expr.op]} ({r}))", np.dtype(bool)
    if isinstance(expr, ir.BoolOp):
        # the oracle reduces and/or with BITWISE &/| (interpreter.py
        # _eval) — ints combine bitwise (4 and 3 -> 4 & 3 = 0); floats
        # raise TypeError there, so they must not reach this emitter
        parts = [rec(o) for o in expr.operands]
        ty = parts[0][1]
        for _, t in parts[1:]:
            if _is_flt(ty) or _is_flt(t):
                raise NativeBuildError(
                    "and/or on floats is a TypeError in the oracle "
                    "(bitwise &/|); Python machine fallback")
            ty = _res_ty(ty, t)
        ty = strong(ty)
        ct = _ct_of(ty)
        op = "&" if expr.op == "and" else "|"
        joined = f" {op} ".join(f"({ct})({s})" for s, _ in parts)
        return f"({ct})({joined})", ty
    if isinstance(expr, ir.Select):
        c, ct_ = rec(expr.cond)
        t, tt = rec(expr.if_true)
        f, ft = rec(expr.if_false)
        # np.where promotes both branches; all-weak branches materialize
        # STRONG (np.where(c, 1.0, 0.5) is a strong float64)
        ty = strong(_res_ty(tt, ft))
        return (f"({_truthy(c, ct_)} ? {to_ty(t, tt, ty)} : "
                f"{to_ty(f, ft, ty)})"), ty
    if isinstance(expr, ir.Call):
        args = [rec(a) for a in expr.args]
        if expr.fn in ("min", "max"):
            (a, at), (b, bt) = args
            ty = strong(_res_ty(at, bt))   # np.minimum materializes
            _check_weak_fits(ty, at, bt)   # ufunc: weak ints must fit
            if _is_flt(ty):    # NaN-propagating like np.minimum/maximum
                fn = "sf_min" if expr.fn == "min" else "sf_max"
                a2 = a if at == ty else to_ty(a, at, ty)
                b2 = b if bt == ty else to_ty(b, bt, ty)
                return _rnd_of(ty)(
                    f"{fn}((double)({a2}), (double)({b2}))"), ty
            fn = "std::min" if expr.fn == "min" else "std::max"
            src = (f"{fn}<long long>((long long)({a}), "
                   f"(long long)({b}))")
            return f"({_ct_of(ty)}){src}", ty
        if expr.fn == "abs":
            (a, at), = args
            if _is_bool(at):   # np.abs on bool_ is the identity
                return a, at
            ty = strong(at)    # np.abs materializes weak scalars
            if not _is_flt(ty):
                return f"({_ct_of(ty)})sf_iabs((long long)({a}))", ty
            return _rnd_of(ty)(f"std::fabs((double)({a}))"), ty
        # transcendentals: integral/weak arguments promote to float64
        (a, at), = args
        ty = at if _is_flt(at) and not _is_weak(at) else np.dtype(
            np.float64)
        return _rnd_of(ty)(f"{_FN_CPP[expr.fn]}((double)({a}))"), ty
    raise TypeError(f"unknown expression node {type(expr)}")


def generate_cpp(program: ir.Program, analysis: ChainAnalysis,
                 slack: int = 0) -> str:
    """Emit the specialized C++ translation unit for one program."""
    graph = analysis.graph
    dims = program.dimensions
    N = program.total_elements
    order = graph.kernel_order

    # shared with machine.py: retention windows + machine-exact schedule
    windows = access_windows(program, analysis)
    F, C = fire_schedule(program, analysis, windows)

    edge_ids: Dict[Tuple[str, str], int] = {}
    edge_caps: List[int] = []
    for key, cap in edge_capacities(program, analysis, windows,
                                    slack).items():
        edge_ids[key] = len(edge_caps)
        edge_caps.append(cap)

    def _producer_dtype(field: str) -> np.dtype:
        if field in program.inputs:
            return np.dtype(program.inputs[field].dtype)
        return np.dtype(program.kernels[field].dtype)

    # typed transport: int64 producers get long long edges/pipes (every
    # other dtype embeds exactly in double) — no |int64| >= 2^53
    # envelope
    i64_edges = {e for (src, _dst), e in edge_ids.items()
                 if _producer_dtype(src) == np.int64}
    idx_d: Dict[int, int] = {}
    idx_i: Dict[int, int] = {}
    for e in range(len(edge_caps)):
        tgt = idx_i if e in i64_edges else idx_d
        tgt[e] = len(tgt)

    def E(e: int) -> str:
        if e in i64_edges:
            return f"edges64[{idx_i[e]}]"
        return f"edges[{idx_d[e]}]"

    array_inputs = [n for n, s in program.inputs.items() if not s.is_scalar]
    scalar_inputs = [n for n, s in program.inputs.items() if s.is_scalar]
    outputs = list(program.outputs)

    L: List[str] = []
    w = L.append
    w("// generated by stencilflow_tpu.sim.native — streaming machine")
    w(f"// program: {program.name}")
    w("#include <cmath>\n#include <cstdio>\n#include <cstring>")
    w("#include <algorithm>")
    w("#include <vector>\n#include <cstdint>")
    w(f"static const long long N = {N}LL;")
    w(f"static const long long DI = {dims[0]}, DJ = {dims[1]}, "
      f"DK = {dims[2]};")
    w(f"static const int N_EDGES_D = {len(idx_d)};")
    w(f"static const int N_EDGES_I = {len(idx_i)};")
    caps_d = ", ".join(str(edge_caps[e]) for e in sorted(idx_d))
    caps_i = ", ".join(str(edge_caps[e]) for e in sorted(idx_i))
    w(f"static const long long EDGE_CAP_D[] = {{{caps_d or '0'}}};")
    w(f"static const long long EDGE_CAP_I[] = {{{caps_i or '0'}}};")
    s = _host_cast_sentinels()
    w(f"""
// numpy float->int casts: NaN / out-of-range results are HOST-specific
// (x86 cvttsd2si lands everything on the width's minimum; aarch64 fcvtzs
// saturates and converts NaN to 0), so the values below were PROBED from
// the running numpy at codegen time — the generated core matches the
// oracle's own behavior on any architecture (ADVICE r4).  In-range
// truncates toward zero; numpy converts to widths <= 32 through the
// 32-bit form (the narrow store then keeps the low bits), and int64
// through the 64-bit form.
static inline int32_t sf_d2i32(double v) {{
  if (v > -2147483649.0 && v < 2147483648.0) return (int32_t)v;
  if (v != v) return (int32_t)({s['nan32']}L);
  return v > 0 ? (int32_t)({s['pos32']}L) : (int32_t)({s['neg32']}L);
}}
static inline int64_t sf_d2i64(double v) {{
  if (v >= -9223372036854775808.0 && v < 9223372036854775808.0)
    return (int64_t)v;
  if (v != v) return {_cpp_i64(s['nan64'])};
  return v > 0 ? {_cpp_i64(s['pos64'])} : {_cpp_i64(s['neg64'])};
}}""")
    w("""
// stale-read fault record (proof discipline, underflow side — the
// reference's BoundedQueue raised on both sides, bounded_queue.py:121-139)
static int g_fault_edge = -1;
static long long g_fault_idx = 0, g_fault_lo = 0, g_fault_hi = 0;
// NaN-propagating min/max (numpy semantics; std::fmin/fmax suppress NaN)
static inline double sf_min(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : std::fmin(a, b));
}
static inline double sf_max(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : std::fmax(a, b));
}
// np.abs on ints (INT_MIN wraps to itself, like numpy; -fwrapv)
static inline long long sf_iabs(long long a) { return a < 0 ? -a : a; }
// round-to-nearest-even bfloat16 (the TPU compute dtype); NaN passthrough
static inline double rnd_bf16(double v) {
  float f = (float)v;
  if (f != f) return (double)f;
  uint32_t b; std::memcpy(&b, &f, 4);
  uint32_t lsb = (b >> 16) & 1u;
  b += 0x7fffu + lsb; b &= 0xffff0000u;
  std::memcpy(&f, &b, 4);
  return (double)f;
}
// FIFO transport is TYPED per edge by the PRODUCER's dtype: double for
// every dtype whose values embed exactly (float32/64, bool, int <= 32
// bits — |int32| < 2^53), and long long for int64 producers, closing
// the former |values| >= 2^53 envelope (VERDICT r4 #8; the reference's
// transport-fidelity-as-proof discipline, bounded_queue.py:121-139).
template <typename T>
struct Edge {
  // fixed-capacity circular buffer: element with stream index t lives at
  // data[t % cap] while t is in [base, arrived)
  std::vector<T> data; long long base=0, arrived=0, high=0, cap=0;
  long long occ_sum=0;
  inline void init(long long c) { cap = c; data.assign((size_t)c, T(0)); }
  inline long long occ() const { return arrived - base; }
  inline bool push(T v) {
    if (occ() >= cap) return false;
    data[(size_t)(arrived % cap)] = v; ++arrived;
    if (occ() > high) high = occ();
    return true;
  }
  inline T peek(long long flat, int eid) const {
    if (flat < base || flat >= arrived) {
      if (g_fault_edge < 0) {
        g_fault_edge = eid; g_fault_idx = flat;
        g_fault_lo = base; g_fault_hi = arrived;
      }
      return T(0);
    }
    return data[(size_t)(flat % cap)];
  }
  inline void release_to(long long nb) {
    if (nb > arrived) nb = arrived;   // never past what has arrived
    if (nb > base) base = nb;
  }
};
template <typename T>
struct Pipe { long long ready, idx; T value; };
static inline bool oob(long long flat, int oi, int oj, int ok,
                       bool mi, bool mj, bool mk) {
  long long i = flat / (DJ*DK), j = (flat / DK) % DJ, k = flat % DK;
  if (mi) { long long t = i + oi; if (t < 0 || t >= DI) return true; }
  if (mj) { long long t = j + oj; if (t < 0 || t >= DJ) return true; }
  if (mk) { long long t = k + ok; if (t < 0 || t >= DK) return true; }
  return false;
}
""")
    w('extern "C" {')
    w("int simulate(const double** arr_inputs, const double* scalars,")
    w("             double** outputs, long long* stats, char* err, "
      "int errlen) {")
    w("  g_fault_edge = -1;  // file-scope fault record: reset per run")
    w("  std::vector<Edge<double>> edges(N_EDGES_D);")
    w("  std::vector<Edge<long long>> edges64(N_EDGES_I);")
    w("  for (int e = 0; e < N_EDGES_D; ++e) "
      "edges[e].init(EDGE_CAP_D[e]);")
    w("  for (int e = 0; e < N_EDGES_I; ++e) "
      "edges64[e].init(EDGE_CAP_I[e]);")
    for i, name in enumerate(scalar_inputs):
        # int64 scalars cross the double* ABI bit-for-bit (the runner
        # packs them via .view), exactly like int64 array slots — no
        # |value| < 2**53 envelope on scalars either
        if np.dtype(program.inputs[name].dtype) == np.int64:
            w(f"  const long long sc_{name} = "
              f"((const long long*)scalars)[{i}];")
        else:
            w(f"  const double sc_{name} = scalars[{i}];")
    for i, name in enumerate(array_inputs):
        ict = ("long long" if _producer_dtype(name) == np.int64
               else "double")
        w(f"  const {ict}* in_{name} = "
          f"(const {ict}*)arr_inputs[{i}];")
        for dst in graph.consumers(name):
            w(f"  long long sent_{name}_{dst} = 0;")
    for i, o in enumerate(outputs):
        oct_ = ("long long"
                if np.dtype(program.kernels[o].dtype) == np.int64
                else "double")
        w(f"  {oct_}* out_{o} = ({oct_}*)outputs[{i}];")
        w(f"  long long opc_{o} = 0;")
    pace = F
    for kname in order:
        lat = analysis.kernel_latencies[kname]
        pvt = ("long long"
               if np.dtype(program.kernels[kname].dtype) == np.int64
               else "double")
        w(f"  long long pc_{kname} = 0; "
          f"std::vector<Pipe<{pvt}>> pl_{kname};")
        w(f"  const long long lat_{kname} = {lat};")
        w(f"  const long long pace_{kname} = {pace[kname]};")
        w(f"  long long ff_{kname} = -1, lf_{kname} = -1, "
          f"st_{kname} = 0;")
    w("  long long cycle = 0, stagnant = 0;")
    cp = analysis.critical_path_cycles
    w(f"  const long long MAX_CYCLES = 8 * (N + {cp} + 1024);")
    done = " && ".join(f"opc_{o} >= N" for o in outputs) or "true"
    w(f"  while (!({done})) {{")
    w("    bool progressed = false;")

    # emit phase (finished consumers' edges are drained sinks)
    for kname in order:
        consumers = [c for c in graph.consumers(kname)
                     if c in program.kernels]
        out_edges = [(edge_ids[(kname, c)], c) for c in consumers]
        w(f"    while (!pl_{kname}.empty() && "
          f"pl_{kname}.front().ready <= cycle) {{")
        cond = " && ".join(
            f"({E(e)}.occ() < {E(e)}.cap || pc_{c} >= N)"
            for e, c in out_edges) or "true"
        w(f"      if (!({cond})) {{ ++st_{kname}; break; }}")
        w(f"      auto val = pl_{kname}.front().value;")
        for e, c in out_edges:
            w(f"      if (pc_{c} < N) {E(e)}.push(val);")
        if kname in outputs:
            w(f"      if (opc_{kname} == pl_{kname}.front().idx) "
              f"{{ out_{kname}[opc_{kname}++] = val; }}")
        w(f"      pl_{kname}.erase(pl_{kname}.begin()); progressed = true;")
        w("    }")

    # fire phase
    for kname in order:
        kspec = program.kernels[kname]
        acc_map = kspec.accesses()
        access_ids: Dict[Tuple[str, ir.Offsets], int] = {}
        plans = []
        for field, offs in acc_map.items():
            for o in offs:
                access_ids[(field, o)] = len(plans)
                plans.append((field, o))
        # availability
        avail = []
        for field in acc_map:
            if field in scalar_inputs:
                continue
            mx = windows[(field, kname)][1]
            e = edge_ids[(field, kname)]
            avail.append(f"{E(e)}.arrived >= "
                         f"std::min(N, pc_{kname} + ({mx}) + 1)")
        # warmup discard: keep each in-edge released to the window floor
        for field in acc_map:
            if field in scalar_inputs:
                continue
            mn = windows[(field, kname)][0]
            e = edge_ids[(field, kname)]
            w(f"    {E(e)}.release_to(pc_{kname} + ({mn}LL));")
        avail_c = " && ".join(avail) or "true"
        w(f"    if (pc_{kname} < N && cycle >= pace_{kname} + pc_{kname}"
          f" && {avail_c}) {{")
        w(f"      const long long t = pc_{kname};")
        kdt = np.dtype(kspec.dtype)

        def src_dtype(field: str) -> np.dtype:
            if field in program.inputs:
                return np.dtype(program.inputs[field].dtype)
            return np.dtype(program.kernels[field].dtype)

        # uniform floating kernels (every access already the kernel dtype)
        # keep the proven per-op-rounding emitter; int/bool/mixed-dtype
        # kernels go through the typed emitter (oracle: edges carry the
        # PRODUCER's dtype; the kernel result is cast once at emit)
        uniform = (is_floating(kdt)
                   and all(src_dtype(f) == kdt for f, _ in plans))
        if uniform:
            mode = _round_mode(kspec.dtype)
            rnd = _RND_CPP[mode].format
        else:
            mode = None
            acc_tys = [src_dtype(f) for f, _ in plans]
            # ml_dtypes bfloat16 has inconsistent scalar promotion
            # (np.result_type(1, bf16) says bf16 but the ufunc computes
            # f32) — mixed-dtype kernels touching bf16 take the Python
            # machine, whose numpy scalars reproduce whatever the oracle
            # does; uniform bf16 kernels keep the fast path above
            if any(dt.name == "bfloat16" for dt in acc_tys + [kdt]):
                raise NativeBuildError(
                    "mixed-dtype kernel involving bfloat16: scalar "
                    "promotion is not well-defined in numpy/ml_dtypes; "
                    "Python machine fallback")
        for idx, (field, offs) in enumerate(plans):
            bc = kspec.boundary_conditions.get(field)
            dense = [x if x is not None else 0 for x in offs]
            mask = [x is not None for x in offs]
            flat_off = flatten_index(dense, dims)
            if field in scalar_inputs:
                # per-access rounding/cast to the edge's dtype, exactly
                # like array accesses (machine.py casts via src_dtype)
                if uniform:
                    w(f"      double v{idx} = {rnd(f'sc_{field}')};")
                elif np.dtype(src_dtype(field)) == np.int64:
                    # sc_ is already long long (typed ABI slot) and the
                    # per-access cast target IS the producer dtype
                    w(f"      long long v{idx} = sc_{field};")
                else:
                    pd = acc_tys[idx]
                    w(f"      {_ct_of(pd)} v{idx} = "
                      f"{_cast_double_to(f'sc_{field}', pd)};")
                continue
            e = edge_ids[(field, kname)]
            oobc = (f"oob(t, {dense[0]}, {dense[1]}, {dense[2]}, "
                    f"{str(mask[0]).lower()}, {str(mask[1]).lower()}, "
                    f"{str(mask[2]).lower()})")
            if bc is None or bc.kind == ir.BCKind.CONSTANT:
                alt = f"{(bc.value if bc is not None else 0.0)!r}"
            elif bc.kind == ir.BCKind.COPY:
                alt = f"{E(e)}.peek(t, {e})"
            else:  # SHRINK
                alt = f"{JUNK_VAL!r}"
            if uniform:
                w(f"      double v{idx} = {oobc} ? {alt} : "
                  f"{E(e)}.peek(t + {flat_off}LL, {e});")
                if mode != "f64":
                    w(f"      v{idx} = {rnd(f'v{idx}')};")
            elif e in i64_edges:
                # typed transport: the edge carries long long exactly;
                # a constant/shrink fill truncates toward zero like
                # numpy's float->int64 cast of an in-range value
                if bc is None or bc.kind in (ir.BCKind.CONSTANT,
                                             ir.BCKind.SHRINK):
                    alt = f"(long long)({alt})"
                w(f"      long long v{idx} = {oobc} ? {alt} : "
                  f"{E(e)}.peek(t + {flat_off}LL, {e});")
            else:
                pd = acc_tys[idx]
                w(f"      double r{idx} = {oobc} ? {alt} : "
                  f"{E(e)}.peek(t + {flat_off}LL, {e});")
                w(f"      {_ct_of(pd)} v{idx} = "
                  f"{_cast_double_to(f'r{idx}', pd)};")
        if uniform:
            bool_temps: set = set()
            for stmt in kspec.statements:
                if isinstance(stmt.rhs, (ir.Compare, ir.BoolOp)) or (
                        isinstance(stmt.rhs, ir.Ref)
                        and stmt.rhs.name in bool_temps):
                    bool_temps.add(stmt.lhs)
                src = _expr_cpp(stmt.rhs, access_ids, mode=mode,
                                bool_temps=frozenset(bool_temps))
                if mode != "f64":
                    src = rnd(f"({src})")
                w(f"      double t_{stmt.lhs} = {src};")
            res = f"t_{kspec.output_statement.lhs}"
        else:
            # statement temps keep their inferred numpy type (the Python
            # machine's `_t_*` locals are uncast)
            stypes: Dict[str, Any] = {}
            for stmt in kspec.statements:
                src, ty = _expr_cpp_typed(stmt.rhs, access_ids, acc_tys,
                                          kdt, stypes)
                stypes[stmt.lhs] = ty
                w(f"      {_ct_of(ty)} t_{stmt.lhs} = {src};")
            out_name = kspec.output_statement.lhs
            out_ty = stypes[out_name]
            # one result cast to the kernel dtype (oracle: .astype at the
            # end of eval_kernel)
            if out_ty == kdt:
                res = f"t_{out_name}"
            elif not _is_flt(out_ty) and kdt.kind in "iu":
                # integral temp -> integral kernel dtype: C truncation,
                # exactly numpy's same-kind astype
                res = f"({_ct_of(kdt)})(t_{out_name})"
            else:
                res = _cast_double_to(f"(double)(t_{out_name})", kdt)
        w('      if (g_fault_edge >= 0) {')
        w('        snprintf(err, errlen, "stale/underflow read on edge %d '
          'at kernel ' + kname + ': element %lld outside live window '
          '[%lld, %lld)", g_fault_edge, g_fault_idx, g_fault_lo, '
          'g_fault_hi);')
        w("        return 2;")
        w("      }")
        w(f"      pl_{kname}.push_back({{cycle + lat_{kname}, t, {res}}});")
        w(f"      if (ff_{kname} < 0) ff_{kname} = cycle;")
        w(f"      lf_{kname} = cycle;")
        w(f"      pc_{kname} = t + 1;")
        for field in acc_map:
            if field in scalar_inputs:
                continue
            mn = windows[(field, kname)][0]
            e = edge_ids[(field, kname)]
            w(f"      {E(e)}.release_to(pc_{kname} + ({mn}LL));")
        w("      progressed = true;")
        w("    }")

    # input feed phase (finished consumers absorb silently)
    for name in array_inputs:
        for dst in graph.consumers(name):
            e = edge_ids[(name, dst)]
            w(f"    if (sent_{name}_{dst} < N) {{")
            w(f"      if (pc_{dst} >= N) {{ sent_{name}_{dst} = N; }}")
            w(f"      else if ({E(e)}.push("
              f"in_{name}[sent_{name}_{dst}])) "
              f"{{ ++sent_{name}_{dst}; progressed = true; }}")
            w("    }")

    w("    for (int e = 0; e < N_EDGES_D; ++e) "
      "edges[e].occ_sum += edges[e].occ();")
    w("    for (int e = 0; e < N_EDGES_I; ++e) "
      "edges64[e].occ_sum += edges64[e].occ();")
    w("    ++cycle; stagnant = progressed ? 0 : stagnant + 1;")
    w("    if (stagnant > 4096 || cycle > MAX_CYCLES) {")
    pcs = ", ".join(f"pc_{k}" for k in order[:6])
    w(f'      snprintf(err, errlen, "deadlock at cycle %lld; '
      f'pcs: {" ".join("%lld" for _ in order[:6])}", cycle'
      + ("" if not order else ", " + pcs) + ");")
    w("      return 1;")
    w("    }")
    w("  }")
    # stats: [cycles, edge highs..., edge occ_sums..., per-kernel
    # ff/lf/stall...]
    w("  int si = 0; stats[si++] = cycle;")
    for e in range(len(edge_caps)):
        w(f"  stats[si++] = {E(e)}.high;")
    for e in range(len(edge_caps)):
        w(f"  stats[si++] = {E(e)}.occ_sum;")
    for kname in order:
        w(f"  stats[si++] = ff_{kname}; stats[si++] = lf_{kname}; "
          f"stats[si++] = st_{kname};")
    w("  return 0;")
    w("}")
    w("}")
    return "\n".join(L)


def _build(source: str) -> str:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    h = hashlib.sha256(source.encode()).hexdigest()[:16]
    so_path = os.path.join(_CACHE_DIR, f"sim_{h}.so")
    if os.path.exists(so_path):
        return so_path
    src_path = os.path.join(_CACHE_DIR, f"sim_{h}.cpp")
    with open(src_path, "w") as f:
        f.write(source)
    # unique temp name: concurrent builds of the same program (pytest -n,
    # parallel CLI runs) must not interleave writes before the atomic rename
    tmp = f"{so_path}.tmp.{os.getpid()}"
    # -fwrapv: defined two's-complement wraparound for signed overflow, the
    # semantics numpy's same-dtype integer arithmetic has (int kernels)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-fwrapv",
           "-o", tmp, src_path]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise NativeBuildError(f"g++ not found: {exc}") from exc
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native simulator build failed:\n{proc.stderr[:2000]}")
    os.replace(tmp, so_path)
    return so_path


class NativeSimulator:
    """C++-backed simulator with the Python machine's exact semantics."""

    def __init__(self, program: ir.Program,
                 analysis: Optional[ChainAnalysis] = None, slack: int = 0):
        self.program = program
        self.analysis = analysis or ChainAnalysis.run(program)
        self.graph = self.analysis.graph
        self.source = generate_cpp(program, self.analysis, slack)
        self.so_path = _build(self.source)
        self.lib = ctypes.CDLL(self.so_path)
        self.lib.simulate.restype = ctypes.c_int
        self.lib.simulate.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_char_p, ctypes.c_int,
        ]

    def run(self, inputs: Dict[str, Any]) -> SimResult:
        program = self.program
        dims = program.dimensions
        N = program.total_elements
        array_names = [n for n, s in program.inputs.items()
                       if not s.is_scalar]
        scalar_names = [n for n, s in program.inputs.items() if s.is_scalar]

        arrs = []
        for name in array_names:
            spec = program.inputs[name]
            # int64 inputs travel TYPED (long long edges in the core);
            # everything else embeds exactly in double
            mdt = (np.int64 if np.dtype(spec.dtype) == np.int64
                   else np.float64)
            a = np.asarray(inputs[name]).astype(spec.dtype).astype(mdt)
            shape = tuple(d if m else 1
                          for d, m in zip(dims, spec.dim_mask))
            full = np.ascontiguousarray(
                np.broadcast_to(a.reshape(shape), tuple(dims)).reshape(-1))
            arrs.append(full)
        scalars = np.zeros(max(1, len(scalar_names)), dtype=np.float64)
        for i, n in enumerate(scalar_names):
            spec = program.inputs[n]
            # reshape(()): a shape-(1,) scalar reads as its 0-d value,
            # as in machine.py
            v = np.asarray(inputs[n]).astype(spec.dtype).reshape(())
            if np.dtype(spec.dtype) == np.int64:
                # bit-for-bit through the double* ABI; the generated
                # core reads this slot back as long long
                scalars.view(np.int64)[i] = v[()]
            else:
                scalars[i] = float(v)

        outs = [np.zeros(N, dtype=(np.int64 if np.dtype(
                    program.kernels[o].dtype) == np.int64
                    else np.float64))
                for o in program.outputs]

        # pointers pass through the double** ABI bit-for-bit; the
        # generated core casts int64 slots back to long long*
        DP = ctypes.POINTER(ctypes.c_double)
        in_ptrs = (DP * max(1, len(arrs)))(
            *[a.ctypes.data_as(DP) for a in arrs] or [DP()])
        out_ptrs = (DP * max(1, len(outs)))(
            *[o.ctypes.data_as(DP) for o in outs] or [DP()])
        n_stats = (1 + 2 * len(self.analysis.edges)
                   + 3 * len(program.kernels))
        stats = np.zeros(n_stats, dtype=np.int64)
        err = ctypes.create_string_buffer(1024)

        rc = self.lib.simulate(
            in_ptrs, scalars.ctypes.data_as(DP), out_ptrs,
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            err, len(err))
        if rc == 1:   # stall: same exception type as the Python machine
            from .machine import DeadlockError
            raise DeadlockError(err.value.decode())
        if rc != 0:
            raise SimulationError(err.value.decode())

        edge_keys = list(self.analysis.edges.keys())
        cycles = int(stats[0])
        high = {k: int(stats[1 + i]) for i, k in enumerate(edge_keys)}
        mean = {k: int(stats[1 + len(edge_keys) + i]) / max(cycles, 1)
                for i, k in enumerate(edge_keys)}
        base = 1 + 2 * len(edge_keys)
        kstats = {}
        for i, kname in enumerate(self.graph.kernel_order):
            kstats[kname] = {
                "first_fire": int(stats[base + 3 * i]),
                "last_fire": int(stats[base + 3 * i + 1]),
                "stall_cycles": int(stats[base + 3 * i + 2]),
            }
        outputs = {}
        for o, buf in zip(program.outputs, outs):
            outputs[o] = buf.astype(program.kernels[o].dtype).reshape(
                program.raw_dimensions)
        return SimResult(outputs=outputs, cycles=cycles,
                         edge_high_water=high, kernel_stats=kstats,
                         edge_mean_occupancy=mean)

"""CUDA C++ generated per program from the IR.

The kernels are not fixed code: like the TPU kernels, whose bodies are
traced from the IR per program (``tile_eval.eval_kernel_statements``),
each program gets its own translation unit:

* one ``SF_HD`` stage function per kernel: pure per-cell math over the
  values of the stage's reads, typed node by node with the oracle's
  lattice (promotion.py) and emitted in the node's own C type —
  ``float`` arithmetic for float32 (``-fmad=false``, so bit-exact against
  numpy for + - * / sqrt), integer arithmetic through unsigned casts
  (numpy's wraparound; signed overflow is undefined in C++), NaN-
  propagating ``sf_min``/``sf_max``, and float->int casts with numpy's
  out-of-range results probed from the running numpy;
* one skeleton that evaluates those functions: the panel streamer
  (``panel_source``), the overlap streamer (``overlap_source``), the
  stream kernel with its banded transforms (``stream_source``), the group
  streamer (``group_source``) — the last two with block bodies that also
  compile with g++ — or a host loop nest over the whole domain
  (``host_source``), which compiles with g++ so the generated math is
  tested without a GPU.

The typed emitter extends the JAX package's native simulator emitter
(``sim/native.py _expr_cpp_typed``) from double-carried values to native
C types.  A narrow float (bfloat16, float16) is stored in 2 bytes
(``sf_bf16``, ``sf_half``: ``stype``) and a stage holds its values in
them too: a same-type ``+ - *`` is the card's bf16 / f16 instruction
(``sf_bf_add``, ``sf_h_mul``, ...: ``add.rn.bf16``, ``mul.rn.f16``, never
contracted into an fma), which rounds its result once, as numpy and
ml_dtypes do (a float32 operation rounded again is that same function,
24 >= 2p + 2); a division or a function computes in float and rounds once
(``sf_f2bf``, ``sf_f2h``), a narrow value meeting another type widens
exactly, and a read or a store moves the 2 bytes as they are.  Under the
stream kernel's compute type (``compute_dtype``) a stage is typed as jnp
types it in the reference's 32-bit mode (``StageEmitter.expr_compute``:
a narrow value in ``float`` (``ctype``), each operation rounded by
``sf_bfr`` / ``sf_hr``) and converts as XLA converts (``cconv``;
``sf_xi32`` saturates float to int32).  Reads carry boundary conditions
from global coordinates: an offset read whose target leaves the domain
in any dim with a nonzero offset yields the fill value (constant,
shrink) or the centre (copy).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .. import ir
from ..dtypes import (BFLOAT16, FLOAT16, dtype_to_str, is_floating, is_narrow,
                      scalar)
from ..frontend.analysis import ChainAnalysis
from .promotion import (BOOL, F32, I32, canonical, compute_fill,
                        compute_join, compute_pin, const_dtype_of,
                        const_type, fill_value, is_bool, is_float, is_weak,
                        result_type, static_input, strong, weak_value)
from .stacked_io import THREADS, accesses_with_center, has_narrow

_CT = {"float32": "float", "float64": "double", "int8": "int8_t",
       "int16": "int16_t", "int32": "int32_t", "int64": "int64_t",
       "bool": "bool"}
_SYM = {"add": "+", "sub": "-", "mult": "*", "div": "/"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
        "ne": "!="}


def ctype(dt) -> str:
    """The C type a value of ``dt`` computes in (float for the narrow
    floats: a compute type's values; the typed emitter keeps narrow
    values in ``stype``)."""
    if is_narrow(dt):
        return "float"
    name = np.dtype(dt).name
    if name not in _CT:
        raise NotImplementedError(f"no C type for {name}")
    return _CT[name]


def stype(dt) -> str:
    """The C type an array or a shared-memory slot of ``dt`` holds."""
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return "sf_bf16"
    if dt == FLOAT16:
        return "sf_half"
    return ctype(dt)


def load(dt, lv: str) -> str:
    """A stored value (``lv`` of ``stype(dt)``) as its ``ctype`` value (a
    narrow one widened to float, exactly)."""
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return f"sf_bf2f({lv})"
    if dt == FLOAT16:
        return f"sf_h2f({lv})"
    return lv


def store(dt, v: str) -> str:
    """Value ``v`` of ``dt`` as ``stype(dt)`` stores it: a float rounded to
    a narrow ``dt`` (exact where it is rounded already), a 2-byte value
    passed through (the C overloads of ``sf_f2bf`` / ``sf_f2h``)."""
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return f"sf_f2bf({v})"
    if dt == FLOAT16:
        return f"sf_f2h({v})"
    return v


def zero(dt) -> str:
    """A stored zero of ``dt``."""
    return store(dt, "0.0f") if is_narrow(dt) else literal(0, dt)


def value(dt, v) -> str:
    """C literal of ``v`` as a value of ``dt`` in the typed emitter: a
    narrow float by its 2-byte bits (``sf_bfk`` / ``sf_hk``: no
    conversion on the card), else ``literal``."""
    dt = np.dtype(dt)
    if not is_narrow(dt):
        return literal(v, dt)
    f = np.float32(scalar(v, dt))
    if dt == FLOAT16:
        return f"sf_hk(0x{int(np.float16(f).view(np.uint16)):04x}u)"
    return f"sf_bfk(0x{int(f.view(np.uint32)) >> 16:04x}u)"


def _rnd(dt) -> str:
    """The C function rounding a float to narrow ``dt``."""
    return "sf_bfr" if np.dtype(dt) == BFLOAT16 else "sf_hr"


def _nat(dt) -> str:
    """The prefix of narrow ``dt``'s value functions (``sf_bf_add``,
    ``sf_h_min``, ...)."""
    return "sf_bf" if np.dtype(dt) == BFLOAT16 else "sf_h"


def _ut(dt) -> str:
    """Unsigned type that carries an integer dtype's wraparound."""
    return "uint64_t" if np.dtype(dt).itemsize == 8 else "uint32_t"


def _host_cast_sentinels() -> Dict[str, int]:
    """numpy's float->int NaN / out-of-range cast results on this host."""
    out: Dict[str, int] = {}
    with np.errstate(invalid="ignore", over="ignore"):
        for name, dt in (("32", np.int32), ("64", np.int64)):
            out["nan" + name] = int(np.array(np.nan).astype(dt)[()])
            out["pos" + name] = int(np.array(1e300).astype(dt)[()])
            out["neg" + name] = int(np.array(-1e300).astype(dt)[()])
    return out


def _i64(v: int) -> str:
    return "(-9223372036854775807LL - 1)" if v == -2 ** 63 else f"{v}LL"


def literal(value, dt) -> str:
    """C literal of ``value`` as numpy dtype ``dt`` (a narrow float:
    rounded to it, as a float)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return "true" if bool(value) else "false"
    ct = ctype(dt)
    if is_floating(dt):
        v = float(scalar(value, dt)) if is_narrow(dt) else float(value)
        if math.isnan(v):
            return f"(({ct})NAN)"
        if math.isinf(v):
            return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
        return f"(({ct}){v.hex()})"
    return f"(({ct}){_i64(int(value))})"


def prelude() -> str:
    s = _host_cast_sentinels()
    fns = []
    for fn in ("sin", "cos", "tan", "sinh", "cosh", "tanh", "sqrt", "exp",
               "log", "fabs"):
        fns.append(f"SF_HD float sf_{fn}(float x) {{ return {fn}f(x); }}\n"
                   f"SF_HD double sf_{fn}(double x) {{ return {fn}(x); }}")
    return f"""// generated by stencilflow_tpu_torch.backend.codegen
#include <stdint.h>
#include <string.h>
#include <math.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_HD __host__ __device__ __forceinline__
#else
#define SF_HD static inline
#endif
// NaN-propagating min/max (np.minimum / np.maximum; fminf drops NaN)
SF_HD float sf_min(float a, float b) {{
  return a != a ? a : (b != b ? b : (b < a ? b : a)); }}
SF_HD double sf_min(double a, double b) {{
  return a != a ? a : (b != b ? b : (b < a ? b : a)); }}
SF_HD float sf_max(float a, float b) {{
  return a != a ? a : (b != b ? b : (b > a ? b : a)); }}
SF_HD double sf_max(double a, double b) {{
  return a != a ? a : (b != b ? b : (b > a ? b : a)); }}
SF_HD int64_t sf_imin(int64_t a, int64_t b) {{ return b < a ? b : a; }}
SF_HD int64_t sf_imax(int64_t a, int64_t b) {{ return b > a ? b : a; }}
// np.abs on ints wraps INT_MIN onto itself
SF_HD int32_t sf_iabs32(int32_t a) {{
  return a < 0 ? (int32_t)(0u - (uint32_t)a) : a; }}
SF_HD int64_t sf_iabs64(int64_t a) {{
  return a < 0 ? (int64_t)(0ull - (uint64_t)a) : a; }}
// numpy float->int casts: in range truncate; NaN / out of range give
// the values numpy gives on the host that generated this file
SF_HD int32_t sf_f2i32(double v) {{
  if (v > -2147483649.0 && v < 2147483648.0) return (int32_t)v;
  if (v != v) return (int32_t)({s['nan32']}LL);
  return v > 0 ? (int32_t)({s['pos32']}LL) : (int32_t)({s['neg32']}LL);
}}
SF_HD int64_t sf_f2i64(double v) {{
  if (v >= -9223372036854775808.0 && v < 9223372036854775808.0)
    return (int64_t)v;
  if (v != v) return {_i64(s['nan64'])};
  return v > 0 ? {_i64(s['pos64'])} : {_i64(s['neg64'])};
}}
SF_HD long long sf_clamp(long long x, long long n) {{
  return x < 0 ? 0 : (x >= n ? n - 1 : x); }}
""" + "\n".join(fns) + "\n"


# float16 (programs typed float16): stored in 2 bytes, computed in 2 bytes
# where the card has the instruction.  sf_f2h rounds a float to nearest,
# ties to even (and passes a float16 value through), sf_h2f widens
# exactly, sf_hr rounds a float once (the stream kernel's compute type),
# sf_d2hr rounds a double to float16 once (to float rounding to odd first,
# as numpy's double -> half).  The typed emitter's values stay float16:
# sf_h_add / sf_h_sub / sf_h_mul are add.rn.f16 / sub.rn.f16 / mul.rn.f16
# on the card (inline PTX: no contraction into fma), equal to the float
# operation rounded once since float32 holds 24 >= 2 x 11 + 2 bits
# (Figueroa 1995); on the host they are that float operation.  sf_hk is a
# constant by its bits, sf_h_neg / sf_h_abs / sf_h_min / sf_h_max pass an
# operand's bits through, and sf_hq gives a value passed through as
# sf_f2h gives its float (a NaN as the conversion makes it).  On the host
# a struct carries the bits, so a missed conversion does not compile.
# Emitted, after _BF16_MACROS (the bfloat16 half of the narrow types),
# only into sources of programs with a narrow field (_common).
_HALF_MACROS = """#ifdef __CUDACC__
#include <cuda_fp16.h>
typedef __half sf_half;
SF_DEV sf_half sf_f2h(const float v) { return __float2half_rn(v); }
SF_DEV float sf_h2f(const sf_half v) { return __half2float(v); }
SF_DEV sf_half sf_hk(const unsigned short u) { return __ushort_as_half(u); }
SF_DEV unsigned short sf_hu(const sf_half v) { return __half_as_ushort(v); }
#define SF_H_OP(name, op) \
  SF_DEV sf_half name(const sf_half a, const sf_half b) { \
    unsigned short r; \
    asm(op " %0, %1, %2;" : "=h"(r) : "h"(sf_hu(a)), "h"(sf_hu(b))); \
    return sf_hk(r); }
SF_H_OP(sf_h_add, "add.rn.f16")
SF_H_OP(sf_h_sub, "sub.rn.f16")
SF_H_OP(sf_h_mul, "mul.rn.f16")
#else
struct sf_half { uint16_t u; };
SF_DEV sf_half sf_f2h(const float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  const uint32_t sign = u & 0x80000000u;
  u ^= sign;
  uint32_t o;
  if (u >= 0x47800000u) {   // 65536 and up: inf, or NaN kept quiet
    o = u > 0x7f800000u ? 0x7e00u | ((u >> 13) & 0x3ffu) : 0x7c00u;
  } else if (u < 0x38800000u) {   // below 2^-14: subnormal, by an add
    float f, magic;
    const uint32_t m = 126u << 23;
    memcpy(&f, &u, 4);
    memcpy(&magic, &m, 4);
    f += magic;
    memcpy(&o, &f, 4);
    o -= m;
  } else {
    o = (u + 0xc8000fffu + ((u >> 13) & 1u)) >> 13;
  }
  sf_half h;
  h.u = (uint16_t)(o | (sign >> 16));
  return h;
}
SF_DEV float sf_h2f(const sf_half h) {
  const uint32_t sign = (uint32_t)(h.u & 0x8000u) << 16;
  const uint32_t e = (h.u >> 10) & 0x1fu, m = h.u & 0x3ffu;
  uint32_t u;
  if (e == 0x1fu) {
    u = sign | 0x7f800000u | (m << 13);
  } else if (e) {
    u = sign | ((e + 112u) << 23) | (m << 13);
  } else {
    const float f = (float)m * 5.9604644775390625e-8f;
    memcpy(&u, &f, 4);
    u |= sign;
  }
  float r;
  memcpy(&r, &u, 4);
  return r;
}
SF_DEV sf_half sf_hk(const unsigned short u) {
  sf_half h;
  h.u = u;
  return h;
}
SF_DEV unsigned short sf_hu(const sf_half v) { return v.u; }
SF_DEV sf_half sf_h_add(const sf_half a, const sf_half b) {
  return sf_f2h(sf_h2f(a) + sf_h2f(b)); }
SF_DEV sf_half sf_h_sub(const sf_half a, const sf_half b) {
  return sf_f2h(sf_h2f(a) - sf_h2f(b)); }
SF_DEV sf_half sf_h_mul(const sf_half a, const sf_half b) {
  return sf_f2h(sf_h2f(a) * sf_h2f(b)); }
#endif
SF_DEV float sf_hr(const float v) { return sf_h2f(sf_f2h(v)); }
SF_DEV sf_half sf_f2h(const sf_half v) { return v; }
SF_DEV sf_half sf_h_neg(const sf_half a) {
  return sf_hk((unsigned short)(sf_hu(a) ^ 0x8000u)); }
SF_DEV sf_half sf_h_abs(const sf_half a) {
  return sf_hk((unsigned short)(sf_hu(a) & 0x7fffu)); }
SF_DEV sf_half sf_h_min(const sf_half a, const sf_half b) {
  const float x = sf_h2f(a), y = sf_h2f(b);
  return x != x ? a : (y != y ? b : (y < x ? b : a)); }
SF_DEV sf_half sf_h_max(const sf_half a, const sf_half b) {
  const float x = sf_h2f(a), y = sf_h2f(b);
  return x != x ? a : (y != y ? b : (y > x ? b : a)); }
SF_DEV sf_half sf_hq(const sf_half v) {
  const float x = sf_h2f(v);
  return x != x ? sf_f2h(x) : v; }
SF_DEV float sf_d2hr(const double d) {
  float f = (float)d;
  if ((double)f != d && d == d) {
    uint32_t u;
    memcpy(&u, &f, 4);
    if (fabs((double)f) > fabs(d)) u -= 1u;
    u |= 1u;
    memcpy(&f, &u, 4);
  }
  return sf_hr(f);
}
"""


# XLA's float -> int32 convert (a stage's result stored under int32
# compute): truncated, saturated, NaN to 0, as cvt.rzi.s32.f32 gives it;
# emitted only into sources computing in int32 (_common)
_XI32_MACRO = """SF_HD int32_t sf_xi32(const float v) {
  return v != v ? 0 : v >= 2147483648.0f ? 2147483647
      : v <= -2147483648.0f ? (-2147483647 - 1) : (int32_t)v;
}
"""


# -- typed expression emitter --------------------------------------------------

def conv(src: str, ty_from, ty_to) -> str:
    """C expression converting a value of node type ``ty_from`` to the
    strong dtype ``ty_to`` (the typed emitter's values: a narrow one is
    held in its 2 bytes, widened exactly where it meets another type, and
    a value converted to a narrow type is rounded once into them)."""
    ty_to = np.dtype(ty_to)
    if is_weak(ty_from):
        return value(ty_to, ty_from[1]) if ty_to.kind != "b" \
            else ("true" if ty_from[1] else "false")
    ty_from = np.dtype(ty_from)
    if ty_from == ty_to:
        return src
    if is_narrow(ty_from):
        src, ty_from = load(ty_from, src), np.dtype(np.float32)
        if ty_to == ty_from:
            return src
    if is_narrow(ty_to):
        if ty_to == FLOAT16 and ty_from == np.float64:
            return f"sf_f2h(sf_d2hr((double)({src})))"
        return store(ty_to, f"(float)({src})")
    ct = ctype(ty_to)
    if ty_to.kind == "b":
        return f"(({src}) != 0)"
    if is_floating(ty_to) or not is_floating(ty_from):
        return f"(({ct})({src}))"
    f2i = "sf_f2i64" if ty_to.itemsize == 8 else "sf_f2i32"
    return f"(({ct}){f2i}((double)({src})))"


class StageEmitter:
    """Emits one kernel's stage function (``compute``: computed in that
    type, the stream kernel's ``compute_dtype``, ``expr_compute``).

    Without a compute type (``expr``: the typed emitter) a value of a
    narrow type is held in its 2 bytes (``stype``) from its read to its
    store: a same-type ``+ - *`` is the card's own bf16 / f16 instruction
    (``sf_bf_add``, ...), equal bit for bit to the float operation
    rounded once; a division or a function computes in float and rounds
    its result once (``store``); a narrow value meeting another type is
    widened exactly (``load``).  ``canon``: the C expressions whose NaN
    is the one a conversion gives (an instruction's or a conversion's
    result); a stage result of a narrow type that is not one passes
    through ``sf_bfq`` / ``sf_hq``, so that every result is what the
    float path's store gave."""

    def __init__(self, program: ir.Program, kspec: ir.KernelSpec,
                 compute=None):
        self.program = program
        self.kspec = kspec
        self.compute = compute
        self.pin = const_dtype_of(kspec) if compute is None else \
            compute_pin(kspec)
        self.accesses: List[Tuple[str, ir.Offsets]] = [
            (f, offs) for f, lst in kspec.accesses().items()
            for offs in lst]
        self.ids = {a: i for i, a in enumerate(self.accesses)}
        self.env: Dict[str, Tuple[str, object]] = {}
        self.canon: set = set()

    def _rounded(self, src: str, ty) -> Tuple[str, object]:
        """A narrow result computed by an instruction or a conversion."""
        self.canon.add(src)
        return src, ty

    def expr(self, e: ir.Expr):
        rec = self.expr
        if isinstance(e, ir.Const):
            v, ty = const_type(e.value, self.pin)
            return (str(v) if is_weak(ty) else value(ty, v)), ty
        if isinstance(e, ir.Ref):
            return self.env[e.name]
        if isinstance(e, ir.Access):
            return (f"v{self.ids[(e.field, e.offsets)]}",
                    np.dtype(self.program.field_dtype(e.field)))
        if isinstance(e, ir.BinOp):
            (a, at), (b, bt) = rec(e.left), rec(e.right)
            if is_weak(at) and is_weak(bt):
                v = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
                     "mult": lambda x, y: x * y,
                     "div": lambda x, y: x / y}[e.op](at[1], bt[1])
                return str(v), (("wf" if isinstance(v, float) else "wi"), v)
            ty = result_type(at, bt)
            if e.op == "div" and not is_float(ty):
                ty = np.dtype(np.float64)
            a, b = conv(a, at, ty), conv(b, bt, ty)
            if is_bool(ty):
                if e.op == "add":
                    return f"(({a}) || ({b}))", ty
                if e.op == "mult":
                    return f"(({a}) && ({b}))", ty
                raise TypeError("numpy rejects bool - bool and bool / bool")
            if is_float(ty):
                if is_narrow(ty):
                    if e.op == "div":
                        return self._rounded(store(
                            ty, f"(({load(ty, a)}) / ({load(ty, b)}))"), ty)
                    return self._rounded(
                        f"{_nat(ty)}_{e.op[:3]}({a}, {b})", ty)
                return f"(({a}) {_SYM[e.op]} ({b}))", ty
            ut = _ut(ty)
            return (f"(({ctype(ty)})(({ut})({a}) {_SYM[e.op]} "
                    f"({ut})({b})))"), ty
        if isinstance(e, ir.UnaryOp):
            a, at = rec(e.operand)
            if is_weak(at):
                return str(-at[1]), (at[0], -at[1])
            if is_bool(at):
                raise TypeError("numpy rejects unary minus on bool")
            if is_narrow(at):
                return f"{_nat(at)}_neg({a})", at
            if is_float(at):
                return f"(-({a}))", at
            ut = _ut(at)
            return f"(({ctype(at)})(({ut})0 - ({ut})({a})))", at
        if isinstance(e, ir.Compare):
            (a, at), (b, bt) = rec(e.left), rec(e.right)
            ty = strong(result_type(at, bt))

            def side(x, xt):   # a narrow comparison compares floats
                if not is_narrow(ty):
                    return conv(x, xt, ty)
                return literal(xt[1], ty) if is_weak(xt) else load(
                    ty, conv(x, xt, ty))
            return (f"(({side(a, at)}) {_CMP[e.op]} ({side(b, bt)}))",
                    np.dtype(np.bool_))
        if isinstance(e, ir.BoolOp):
            parts = [rec(o) for o in e.operands]
            ty = parts[0][1]
            for _, t in parts[1:]:
                ty = result_type(ty, t)
            ty = strong(ty)
            if is_float(ty):
                raise TypeError("numpy rejects bitwise and/or on floats")
            op = " & " if e.op == "and" else " | "
            joined = op.join(f"({conv(s, t, ty)})" for s, t in parts)
            return f"(({ctype(ty)})({joined}))", ty
        if isinstance(e, ir.Select):
            c, ct = rec(e.cond)
            (t, tt), (f, ft) = rec(e.if_true), rec(e.if_false)
            ty = strong(result_type(tt, ft, ufunc=False))
            cond = conv(c, ct, np.dtype(np.bool_))
            return (f"(({cond}) ? ({conv(t, tt, ty)}) : "
                    f"({conv(f, ft, ty)}))"), ty
        if isinstance(e, ir.Call):
            args = [rec(a) for a in e.args]
            if e.fn in ("min", "max"):
                (a, at), (b, bt) = args
                ty = strong(result_type(at, bt))
                a, b = conv(a, at, ty), conv(b, bt, ty)
                if is_narrow(ty):
                    return f"{_nat(ty)}_{e.fn}({a}, {b})", ty
                if is_float(ty):
                    return f"sf_{e.fn}({a}, {b})", ty
                return (f"(({ctype(ty)})sf_i{e.fn}((int64_t)({a}), "
                        f"(int64_t)({b})))"), ty
            (a, at), = args
            if e.fn == "abs":
                if is_bool(at):
                    return a, at
                ty = strong(at)
                a = conv(a, at, ty)
                if is_narrow(ty):
                    return f"{_nat(ty)}_abs({a})", ty
                if is_float(ty):
                    return f"sf_fabs({a})", ty
                fn = "sf_iabs64" if ty.itemsize == 8 else "sf_iabs32"
                cast = "int64_t" if ty.itemsize == 8 else "int32_t"
                return f"(({ctype(ty)}){fn}(({cast})({a})))", ty
            ty = at if is_float(at) and not is_weak(at) \
                else np.dtype(np.float64)
            a = conv(a, at, ty)
            if is_narrow(ty):
                return self._rounded(
                    store(ty, f"sf_{e.fn}({load(ty, a)})"), ty)
            return f"sf_{e.fn}({a})", ty
        raise TypeError(f"unknown expression node {type(e)}")

    def cconv(self, src: str, ty_from, ty_to) -> str:
        """C expression converting a value of node type ``ty_from`` to
        ``ty_to`` under a compute type, as XLA converts
        (``tile_eval.xla_convert``): a weak scalar as jnp converts it, to
        bool ``!= 0``, a float to int32 saturated (``sf_xi32``), a float to
        a narrow float rounded; a narrow value is carried in float, so
        widening it to float32 is free."""
        ty_to = np.dtype(ty_to)
        if is_weak(ty_from):
            return literal(weak_value(ty_from, ty_to), ty_to)
        ty_from = np.dtype(ty_from)
        if ty_from == ty_to:
            return src
        if ty_to.kind == "b":
            return f"(({src}) != 0)"
        if is_floating(ty_to):
            if is_floating(ty_from) and not is_narrow(ty_to):
                return src
            v = f"(({ctype(ty_to)})({src}))"
            return f"{_rnd(ty_to)}({v[1:-1]})" if is_narrow(ty_to) else v
        if is_floating(ty_from):
            if ty_to != I32:
                raise NotImplementedError(f"float to {ty_to} under a "
                                          "compute type")
            return f"sf_xi32((float)({src}))"
        return f"(({ctype(ty_to)})({src}))"

    def expr_compute(self, e: ir.Expr):
        """``expr`` under the compute type ``self.compute`` (tile_eval
        ``eval_expr_compute``'s rule): array reads are values of it,
        scalars of their own 32-bit type, float constants of the kernel's
        pin; each site takes jnp's type (``compute_join``), a float site
        computes in float and rounds its result where the type is narrow
        (``sf_bfr``, ``sf_hr``), an integer one wraps, a bool ``+`` and
        ``*`` are or and and."""
        rec = self.expr_compute
        cv = self.cconv

        def weakless(ty):
            return (F32 if ty[0] == "wf" else I32) if is_weak(ty) else ty

        def rnd(src, ty):
            return f"{_rnd(ty)}({src})" if is_narrow(ty) else src
        if isinstance(e, ir.Const):
            v, ty = const_type(e.value, self.pin)
            return (str(v) if is_weak(ty) else literal(v, ty)), ty
        if isinstance(e, ir.Ref):
            return self.env[e.name]
        if isinstance(e, ir.Access):
            v = f"v{self.ids[(e.field, e.offsets)]}"
            spec = self.program.inputs.get(e.field)
            if spec is None or not spec.is_scalar:
                return v, self.compute
            dt = np.dtype(spec.dtype)
            ty = canonical(dt)
            return (v if ty == dt else f"(({ctype(ty)})({v}))"), ty
        if isinstance(e, ir.BinOp):
            (a, at), (b, bt) = rec(e.left), rec(e.right)
            if is_weak(at) and is_weak(bt):
                return self.expr(e)
            ty = compute_join(at, bt)
            if e.op == "div" and not is_floating(ty):
                ty = F32   # jnp's true division of integers
            a, b = cv(a, at, ty), cv(b, bt, ty)
            if is_bool(ty):
                if e.op in ("add", "mult"):
                    op = "||" if e.op == "add" else "&&"
                    return f"(({a}) {op} ({b}))", ty
                raise TypeError("jnp rejects bool - bool")
            if is_floating(ty):
                return rnd(f"(({a}) {_SYM[e.op]} ({b}))", ty), ty
            ut = _ut(ty)
            return (f"(({ctype(ty)})(({ut})({a}) {_SYM[e.op]} "
                    f"({ut})({b})))"), ty
        if isinstance(e, ir.UnaryOp):
            a, at = rec(e.operand)
            if is_weak(at):
                return str(-at[1]), (at[0], -at[1])
            if is_bool(at):
                raise TypeError("jnp rejects unary minus on bool")
            if is_floating(at):
                return f"(-({a}))", at
            ut = _ut(at)
            return f"(({ctype(at)})(({ut})0 - ({ut})({a})))", at
        if isinstance(e, ir.Compare):
            (a, at), (b, bt) = rec(e.left), rec(e.right)
            ty = weakless(compute_join(at, bt))
            return (f"(({cv(a, at, ty)}) {_CMP[e.op]} ({cv(b, bt, ty)}))",
                    BOOL)
        if isinstance(e, ir.BoolOp):
            parts = [rec(o) for o in e.operands]
            ty = weakless(compute_join(*[t for _s, t in parts]))
            if is_floating(ty):
                raise TypeError("jnp rejects bitwise and/or on floats")
            op = " & " if e.op == "and" else " | "
            joined = op.join(f"({cv(x, t, ty)})" for x, t in parts)
            return f"(({ctype(ty)})({joined}))", ty
        if isinstance(e, ir.Select):
            c, ct = rec(e.cond)
            (t, tt), (f, ft) = rec(e.if_true), rec(e.if_false)
            ty = weakless(compute_join(tt, ft))
            return (f"(({cv(c, ct, BOOL)}) ? ({cv(t, tt, ty)}) : "
                    f"({cv(f, ft, ty)}))"), ty
        if isinstance(e, ir.Call):
            args = [rec(a) for a in e.args]
            if e.fn in ("min", "max"):
                (a, at), (b, bt) = args
                if is_weak(at) and is_weak(bt):
                    v = (min if e.fn == "min" else max)(at[1], bt[1])
                    return str(v), (at[0] if at[1] == v else bt[0], v)
                ty = compute_join(at, bt)
                a, b = cv(a, at, ty), cv(b, bt, ty)
                if is_bool(ty):
                    op = "&&" if e.fn == "min" else "||"
                    return f"(({a}) {op} ({b}))", ty
                if is_floating(ty):
                    return f"sf_{e.fn}({a}, {b})", ty
                return (f"(({ctype(ty)})sf_i{e.fn}((int64_t)({a}), "
                        f"(int64_t)({b})))"), ty
            (a, at), = args
            if is_weak(at):
                if e.fn == "abs":
                    return str(abs(at[1])), (at[0], abs(at[1]))
                from .tile_eval import _weak_fold_call
                v, ty = _weak_fold_call(e.fn, at)
                return repr(v), ty
            if e.fn == "abs":
                if is_bool(at):
                    return a, at
                if is_floating(at):
                    return f"sf_fabs({a})", at
                return f"(({ctype(at)})sf_iabs32((int32_t)({a})))", at
            ty = at if is_floating(at) else F32
            return rnd(f"sf_{e.fn}({cv(a, at, ty)})", ty), ty
        raise TypeError(f"unknown expression node {type(e)}")

    def function(self, name: str) -> str:
        """The stage function: a parameter a read, of its field's stored
        type (a narrow value in its 2 bytes), the result of the kernel's
        stored type."""
        if self.compute is not None:
            return self._function_compute(name)
        params = ", ".join(
            f"const {stype(self.program.field_dtype(f))} v{i}"
            for i, (f, _) in enumerate(self.accesses)) or "void"
        body, declared = [], {}
        for stmt in self.kspec.statements:
            src, ty = self.expr(stmt.rhs)
            if is_weak(ty):
                self.env[stmt.lhs] = (src, ty)
                continue
            # a name assigned again (``f = ...; f = g(f)``, as SDFG
            # imports write) gets a fresh C name: t_f, t_f__2, ...
            n = declared[stmt.lhs] = declared.get(stmt.lhs, 0) + 1
            var = f"t_{stmt.lhs}" + (f"__{n}" if n > 1 else "")
            body.append(f"  const {stype(ty)} {var} = {src};")
            if src in self.canon:
                self.canon.add(var)
            self.env[stmt.lhs] = (var, ty)
        src, ty = self.env[self.kspec.output_statement.lhs]
        kdt = np.dtype(self.kspec.dtype)
        out = conv(src, strong(ty), kdt) if not is_weak(ty) \
            else conv(src, ty, kdt)
        if is_narrow(kdt) and out not in self.canon and not \
                out.startswith(("sf_f2bf(", "sf_f2h(")):
            out = f"{_nat(kdt)}q({out})"
        # the narrow conversions are device functions on the card
        qual = "SF_DEV" if has_narrow(self.program) else "SF_HD"
        return (f"{qual} {stype(kdt)} {name}({params}) {{\n"
                + "\n".join(body) + f"\n  return {out};\n}}\n")

    def _function_compute(self, name: str) -> str:
        """The stage function under a compute type: array parameters of
        its C type (float for a narrow one), scalars of their own, the
        result converted to it (``cconv``)."""
        cd = self.compute

        def ptype(f):   # a scalar keeps its type, an array is of cd
            spec = self.program.inputs.get(f)
            return spec.dtype if spec is not None and spec.is_scalar else cd
        params = ", ".join(f"const {ctype(ptype(f))} v{i}" for i, (f, _)
                           in enumerate(self.accesses)) or "void"
        body, declared = [], {}
        for stmt in self.kspec.statements:
            src, ty = self.expr_compute(stmt.rhs)
            if is_weak(ty):
                self.env[stmt.lhs] = (src, ty)
                continue
            n = declared[stmt.lhs] = declared.get(stmt.lhs, 0) + 1
            var = f"t_{stmt.lhs}" + (f"__{n}" if n > 1 else "")
            body.append(f"  const {ctype(ty)} {var} = {src};")
            self.env[stmt.lhs] = (var, ty)
        src, ty = self.env[self.kspec.output_statement.lhs]
        if is_weak(ty):   # jnp.asarray: int32 or float32, then the cast
            base = F32 if ty[0] == "wf" else I32
            src, ty = literal(weak_value(ty, base), base), base
        out = self.cconv(src, ty, cd)
        return (f"SF_DEV {ctype(cd)} {name}({params}) {{\n"
                + "\n".join(body) + f"\n  return {out};\n}}\n")


def check_compute_types(program: ir.Program, compute) -> None:
    """Raise TypeError, naming the kernel, where jnp rejects a site under
    the compute type ``compute`` (bool minus, bitwise and/or of floats):
    the JAX package raises there when it traces the kernel."""
    for name, kspec in program.kernels.items():
        try:
            StageEmitter(program, kspec, compute).function("sf_check")
        except TypeError as e:
            raise TypeError(f"kernel {name!r} under compute_dtype "
                            f"{dtype_to_str(np.dtype(compute))!r}: {e}"
                            ) from None


# -- reads with boundary conditions --------------------------------------------

def _flat(dim_mask, coords, dims) -> str:
    """Row-major flat index of clamped coords over the spanned dims."""
    idx = "0LL"
    for d in range(3):
        if dim_mask[d]:
            idx = (f"({idx}) * {dims[d]}LL + sf_clamp({coords[d]}, "
                   f"{dims[d]})")
    return idx


def _inb(dim_mask, coords, dims) -> str:
    terms = [f"({coords[d]}) >= 0 && ({coords[d]}) < {dims[d]}"
             for d in range(3) if dim_mask[d]]
    return " && ".join(terms) or "true"


def read_expr(program: ir.Program, kspec: ir.KernelSpec, field: str,
              offsets: ir.Offsets, pos: Tuple[str, str, str],
              onchip, scalar_slot: Dict[str, int], at_pos=None,
              at_dims=None, masked: bool = True, compute=None) -> str:
    """C expression reading ``field`` at ``offsets`` from the cell whose
    global coords are ``pos``, boundary condition applied (unless
    ``masked`` is False: the mask-free interior read, zero beyond the
    domain).  ``onchip(o)`` gives the shared-memory lvalue of an on-chip
    field at offset vector ``o`` (or None: read the global array
    ``g_<field>``, whose cell is at ``at_pos`` in an array spanning
    ``at_dims`` — ``pos`` and the program's dimensions unless a chunk's
    local slab is read).  ``compute``: under a compute type the global
    arrays hold that type and a constant BC's fill is converted to it."""
    dt = np.dtype(program.field_dtype(field))
    if field in program.inputs and program.inputs[field].is_scalar:
        sv = f"sc.x{scalar_slot[field]}"   # a narrow one: its float
        return store(dt, sv) if compute is None and is_narrow(dt) else sv
    dims = program.dimensions
    at_pos, at_dims = at_pos or pos, at_dims or dims
    mask = program.field_dim_mask(field)
    offs = [o or 0 for o in offsets]
    terms = [f"({pos[d]} + {offs[d]} < 0 || {pos[d]} + {offs[d]} >= "
             f"{dims[d]})" for d in range(3) if offs[d]]

    def at(o):
        lv = onchip(o)
        if lv is not None:
            return lv
        c = [f"({at_pos[d]} + {o[d]})" for d in range(3)]
        g = f"g_{field}[{_flat(mask, c, at_dims)}]"
        if compute is None:   # the stored cell is the value
            return f"(({_inb(mask, c, at_dims)}) ? {g} : {value(dt, 0)})"
        return (f"(({_inb(mask, c, at_dims)}) ? {load(compute, g)} : "
                f"{literal(0, compute)})")

    val = at(offs)
    if not terms or not masked:
        return val
    m = " || ".join(terms)
    bc = kspec.boundary_conditions.get(field)
    if bc is not None and bc.kind == ir.BCKind.COPY:
        return f"(({m}) ? {at((0, 0, 0))} : {val})"
    fill = value(dt, fill_value(bc, dt)) if compute is None else \
        literal(compute_fill(bc, compute, static_input(program, field)),
                compute)
    return f"(({m}) ? {fill} : {val})"


def _stage_call(program, kspec, idx, pos, onchip, slots, at_pos=None,
                at_dims=None, masked: bool = True,
                compute=None) -> List[str]:
    em = StageEmitter(program, kspec)

    def vtype(f):   # under a compute type an array is of it
        if compute is None or (f in program.inputs
                               and program.inputs[f].is_scalar):
            return program.field_dtype(f)
        return compute
    # the typed emitter's values are stored types (a narrow one in its 2
    # bytes); a compute type's are its C type
    vt = stype if compute is None else ctype
    lines = [f"const {vt(vtype(f))} v{i} = "
             + read_expr(program, kspec, f, offs, pos, onchip(f), slots,
                         at_pos, at_dims, masked, compute) + ";"
             for i, (f, offs) in enumerate(em.accesses)]
    args = ", ".join(f"v{i}" for i in range(len(em.accesses)))
    rt = kspec.dtype if compute is None else compute
    lines.append(f"const {vt(rt)} r = sf_stage_{idx}({args});")
    return lines


def _common(program: ir.Program, analysis: ChainAnalysis, skip=(),
            compute=None):
    """(kernel order, prelude + scalar struct + one stage function per
    kernel not in ``skip``, scalar slots); ``compute``: stage functions
    computed in that type, after the stream kernel's and the narrow
    macros they call (and ``_XI32_MACRO`` under int32); a program with a
    narrow field gets those
    macros (the bf16 ones, and the float16 ones, ``_HALF_MACROS``) and
    device-only stage functions."""
    order = analysis.graph.kernel_order
    funcs = [StageEmitter(program, program.kernels[k], compute).function(
        f"sf_stage_{i}") for i, k in enumerate(order) if k not in skip]
    scalars = [n for n, s in program.inputs.items() if s.is_scalar]
    slots = {n: i for i, n in enumerate(scalars)}
    struct = ("struct SfScalars {\n  int unused_;\n"
              + "".join(f"  {ctype(program.inputs[n].dtype)} x{i};\n"
                        for i, n in enumerate(scalars)) + "};\n")
    narrow = has_narrow(program)
    macros = _STREAM_MACROS + _BF16_MACROS \
        if compute is not None or narrow else ""
    if narrow or compute == FLOAT16:
        macros += _HALF_MACROS
    if compute == I32:
        macros += _XI32_MACRO
    return order, prelude() + macros + struct + "\n".join(funcs), slots


def _params(program: ir.Program, n_pool: int = 0,
            origin: bool = False, spill: bool = False,
            compute=None) -> Tuple[str, str]:
    """Kernel parameter list and the matching launch arguments; ``n_pool``
    float32 tables follow the array inputs in ``in``; ``origin`` adds the
    local kernel's ``origin_i`` (``origin`` 3: and a shard's ``origin_j``,
    ``origin_k``); ``spill`` the stream kernel's spill
    buffer ``sf_spill`` (written and read back by the block, so neither
    const nor restrict: no read goes through the non-coherent path);
    ``compute``: array inputs and outputs are of that narrow type (a
    narrow compute)."""
    params, args = [], []
    arrays = [n for n, s in program.inputs.items() if not s.is_scalar]
    for i, n in enumerate(arrays):
        ct = stype(program.inputs[n].dtype if compute is None else compute)
        params.append(f"const {ct}* __restrict__ g_{n}")
        args.append(f"(const {ct}*)in[{i}]")
    for i in range(n_pool):
        params.append(f"const float* __restrict__ pc{i}")
        args.append(f"(const float*)in[{len(arrays) + i}]")
    for i, o in enumerate(program.outputs):
        ct = stype(program.kernels[o].dtype if compute is None else compute)
        params.append(f"{ct}* __restrict__ o_{o}")
        args.append(f"({ct}*)out[{i}]")
    params.append("const SfScalars sc")
    args.append("sc")
    if origin:
        params.append("const int origin_i")
        args.append("origin_i")
    if origin == 3:
        params += ["const int origin_j", "const int origin_k"]
        args += ["origin_j", "origin_k"]
    if spill:
        params.append("unsigned char* const sf_spill")
        args.append("sf_spill")
    return ", ".join(params), ", ".join(args)


def _launcher(program, kernel: str, grid: str, smem: int, slots,
              n_pool: int = 0, origin: bool = False,
              spill: bool = False, threads: int = THREADS,
              compute=None) -> str:
    params, args = _params(program, n_pool, origin, spill, compute)
    copies = "".join(f"  memcpy(&sc.x{i}, scal + {8 * i}, sizeof(sc.x{i}));\n"
                     for i in slots.values())
    if spill:   # the spill buffer follows the tables in ``in``
        n_arrays = sum(not s.is_scalar for s in program.inputs.values())
        copies += (f"  unsigned char* const sf_spill = (unsigned char*)"
                   f"in[{n_arrays + n_pool}];\n")
    name = "sf_shard_launch" if origin == 3 else \
        "sf_local_launch" if origin else "sf_launch"
    origin_arg = "const int origin_i, " if origin else ""
    if origin == 3:
        origin_arg += "const int origin_j, const int origin_k, "
    return f"""
extern "C" int {name}(const void* const* in, void* const* out,
    const unsigned char* scal, {origin_arg}void* stream) {{
  SfScalars sc;
  sc.unused_ = 0;
{copies}  cudaError_t e = cudaFuncSetAttribute(
      {kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});
  if (e != cudaSuccess) return (int)e;
  {kernel}<<<{grid}, {threads}, {smem}, (cudaStream_t)stream>>>({args});
  return (int)cudaGetLastError();
}}
"""


# the panel kernel's input loads (K1): one element per cp.async (4 or 8
# bytes), zero-filled where the source lies outside the domain (src-size
# 0), completed by commit groups; on the host the copies happen at the
# point of issue and the waits do nothing
_PANEL_MACROS = """#ifdef __CUDACC__
SF_DEV void sf_cp4(void* dst, const void* src, const bool inb) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(inb ? 4 : 0) : "memory");
}
SF_DEV void sf_cp8(void* dst, const void* src, const bool inb) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(inb ? 8 : 0) : "memory");
}
#define SF_CP_COMMIT() asm volatile("cp.async.commit_group;" ::: "memory")
#define SF_CP_WAIT_AHEAD() asm volatile("cp.async.wait_group %0;" :: "n"(SF_AHEAD) : "memory")
#else
SF_DEV void sf_cp4(void* dst, const void* src, const bool inb) {
  if (inb) memcpy(dst, src, 4); else memset(dst, 0, 4);
}
SF_DEV void sf_cp8(void* dst, const void* src, const bool inb) {
  if (inb) memcpy(dst, src, 8); else memset(dst, 0, 8);
}
#define SF_CP_COMMIT()
#define SF_CP_WAIT_AHEAD()
#endif
// x - n where x reaches n: a ring slot kept in [0, n) without a modulo
SF_DEV int sf_wrap(const int x, const int n) { return x >= n ? x - n : x; }
"""

# a group of 8 cells of 2 bytes per cp.async (16 bytes, through L2 only),
# zero-filled outside the domain; emitted only into sources whose plan
# loads a 2-byte ring input by such groups (``_load_group``)
_CP16_MACRO = """#ifdef __CUDACC__
SF_DEV void sf_cp16(void* dst, const void* src, const bool inb) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(inb ? 16 : 0) : "memory");
}
#else
SF_DEV void sf_cp16(void* dst, const void* src, const bool inb) {
  if (inb) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
#endif
"""


def _load_group(plan, f: str) -> int:
    """Cells of ring input ``f`` one cp.async of the loader moves: the
    plan's group of a 2-byte input (8 or 2, ``stacked_io.copy_group``),
    else 1 (a cell a copy: cp.async for 4 and 8 bytes, a synchronous
    store otherwise)."""
    return getattr(plan, "copy_groups", {}).get(f, 1)


def _load_width(plan, f: str) -> int:
    """The loader's region loop width of ring input ``f``: its region's
    row in groups."""
    return plan.region(f)[1] // _load_group(plan, f)


def _group_macros(plan) -> List[str]:
    """``_CP16_MACRO`` where the plan loads a 2-byte input by groups of 8
    cells."""
    return [_CP16_MACRO] if 8 in getattr(plan, "copy_groups", {}).values() \
        else []


def _slot(plan, f: str, d: int) -> str:
    """Slot of ring ``f`` holding plane t - d at step t, from the step's
    counter m<S> = t mod S (S the ring's slots)."""
    return _slot_of(plan.slots(f), d)


def _slot_of(S: int, d: int) -> str:
    """Slot of a ring of ``S`` planes holding plane t - d at step t."""
    c = (-d) % S
    if S == 1:
        return "0"
    return f"m{S}" if c == 0 else f"sf_wrap(m{S} + {c}, {S})"


def _region_loop(RJ: int, RK: int, body: List[str]) -> List[str]:
    """The passes of a block's threads over an RJ x RK region in
    row-major order: the thread's first row jl and column kl come from
    one division by a constant before the i-march, later ones by adding
    the stride's constant row and column steps (no division in a pass).
    The loop is not unrolled: unrolled, nvcc keeps every pass's addresses
    live and needs 180-240 registers, one block per SM."""
    return ["{",
            f"  int jl = jl0_{RK}, kl = kl0_{RK};",
            "#pragma unroll 1",
            f"  for (int p = tid; p < {RJ * RK}; p += SF_NT) {{"] \
        + ["    " + b for b in body] \
        + [f"    kl += SF_NT % {RK};", f"    jl += SF_NT / {RK};",
           f"    if (kl >= {RK}) {{ kl -= {RK}; ++jl; }}", "  }", "}"]


def _skeleton_macros(threads: int) -> List[str]:
    """K1's skeleton (the panel streamer, shared by the stream kernel's
    on-chip body): the input planes' lead, the threads of a block (one
    runs a block on the host) and the cp.async / slot macros."""
    from .panel import AHEAD
    return [f"#define SF_AHEAD {AHEAD}",
            f"#ifdef __CUDACC__\n#define SF_NT {threads}\n#else\n"
            "#define SF_NT 1\n#endif", _PANEL_MACROS]


def _thread_origins(widths) -> List[str]:
    """A thread's first (jl, kl) in a region of each width: the one
    division before the i-march (``_region_loop``)."""
    return [f"  const int jl0_{w} = tid / {w}, kl0_{w} = tid - jl0_{w} * {w};"
            for w in widths]


def _input_loads(program, plan, fields, t_expr: str, slot,
                 atype=None) -> List[str]:
    """cp.async of plane ``t_expr`` of every ring input in ``fields`` into
    its ``slot(f)``, zero beyond the (j, k) domain: a cell a copy of 4 or
    8 bytes, a group of 2 or 8 cells of 2 bytes where the plan aligns
    them (``_load_group``: the region's left edge, rows and slots at
    multiples of the group), else synchronous stores (1 and 2 bytes, and
    a copy that converts); the arrays' planes are (J, K) (a chunk's
    slabs too), or a shard's widened plane (PJ, PK), whose cell (0, 0)
    is global (wj, wk), read where it holds the cell.  ``atype(f)``: the
    type of input ``f``'s array (the stream kernel's ``StreamPlan.dtype``;
    else the field's)."""
    atype = atype or program.field_dtype
    _, J, K = program.dimensions
    sharded = bool(getattr(plan, "shard", (0, 0))[0])
    PJ, PK = plan.plane() if sharded else (J, K)
    out = []
    for f in fields:
        RJ, RK = plan.region(f)
        hj, hk = plan.halo[f]
        size = np.dtype(atype(f)).itemsize
        cell = "(gj - wj) * {PK} + (gk - wk)" if sharded else "gj * {K} + gk"
        src = (f"g_{f} + (long long)({t_expr}) * {PJ * PK}LL + "
               f"(inb ? {cell.format(PK=PK, K=K)} : 0)")
        dst = f"r_{f} + {slot(f)} * {RJ * RK} + p"
        cdt = getattr(plan, "compute_narrow", None)
        if cdt is not None:
            # narrow arrays: synchronous copies (cp.async moves 4 bytes or
            # more), into 2-byte slots or a band pass's f32 source slots
            st = (f"*({dst}) = inb ? *({src}) : {zero(cdt)};"
                  if plan.narrow_slots(f) else
                  f"*({dst}) = inb ? {load(cdt, '*(' + src + ')')} : 0.0f;")
        elif size in (4, 8):
            st = f"sf_cp{size}({dst}, {src}, inb);"
        else:
            st = (f"*({dst}) = inb ? *({src}) : "
                  f"{zero(atype(f))};")
        inb = f"gj >= 0 && gj < {J} && gk >= 0 && gk < {K}"
        if sharded:
            inb += (f" && gj - wj < {PJ} && gk - wk < {PK}")
        g = _load_group(plan, f)
        if g > 1:   # a group of g cells, wholly in or out of the domain
            st = (f"sf_cp{2 * g}(r_{f} + {slot(f)} * {RJ * RK} + p * {g}, "
                  f"{src}, inb);")
        out += _region_loop(RJ, RK // g, [
            f"const int gj = j0 - {hj} + jl, gk = k0 - {hk} + kl"
            + (f" * {g};" if g > 1 else ";"),
            f"const bool inb = {inb};", st])
    return out


def _ingest(program, plan, fields, planes: int,
            atype=None) -> Tuple[List[str], List[str]]:
    """(prologue, the step's ingest) of K1's input planes: the prologue
    puts the first AHEAD planes in flight; step t issues plane t + AHEAD
    into its own slot, then waits for plane t and a barrier (``atype``:
    ``_input_loads``)."""
    from .panel import AHEAD
    if not fields:
        return [], []
    pro = ["  // prologue: the first AHEAD planes in flight"]
    for a in range(min(AHEAD, planes)):
        pro += ["  " + y for y in _input_loads(
            program, plan, fields, str(a),
            lambda f, a=a: str(a % plan.slots(f)), atype)] + [
                "  SF_CP_COMMIT();"]
    step = ["    // plane t + AHEAD in flight, then wait for plane t",
            f"    if (t + {AHEAD} < {planes}) {{"]
    step += ["      " + y for y in _input_loads(
        program, plan, fields, f"t + {AHEAD}",
        lambda f: _slot(plan, f, -AHEAD), atype)]
    step += ["    }", "    SF_CP_COMMIT();", "    SF_CP_WAIT_AHEAD();"]
    for f in fields:
        if plan.rounded(f) and getattr(plan, "compute_narrow",
                                       None) is None:
            # a cp.async copy cannot convert: each thread rounds the cells
            # of plane t it copied itself, once they have landed
            RJ, RK = plan.region(f)
            step += ["    " + y for y in _region_loop(RJ, RK, [
                f"float* const x = r_{f} + {_slot(plan, f, 0)} * "
                f"{RJ * RK} + p;", "*x = sf_bfr(*x);"])]
    step.append("    SF_SYNC();")
    return pro, step


def _ring_reader(program, plan, s: str, RK: int, ptrs: Dict, xs: set,
                 ringed, rtype=None):
    """``onchip`` of ``read_expr`` for stage ``s`` over rings ``ringed``:
    a read of field f at offset o is one load from the base ``b_f_d``
    (ring slot of plane delta d, set once per stage and step: ``ptrs``)
    at the thread's cell (``p``, or ``x<FK>`` for a region of another
    width: ``xs``) plus a constant."""
    def onchip(f):
        if f not in ringed:
            return lambda o: None
        FK = plan.region(f)[1]
        dj = plan.halo[f][0] - plan.halo[s][0]
        dk = plan.halo[f][1] - plan.halo[s][1]

        def at(o):
            d = plan.lag[s] - o[0]
            ptrs[f, d] = f"b_{f}_{d}"
            x = "p" if FK == RK else f"x{FK}"
            if FK != RK:
                xs.add(FK)
            return _from_slot(program, plan, f, f"b_{f}_{d}[{x} + "
                              f"{(dj + o[1]) * FK + dk + o[2]}]", rtype)
        return at
    return onchip


def _ring_bases(program, plan, ptrs, ind: str, rtype=None) -> List[str]:
    return [f"{ind}const {_slot_type(program, plan, f, rtype)}* const "
            f"{name} = "
            f"r_{f} + {_slot(plan, f, d)} * {math.prod(plan.region(f))};"
            for (f, d), name in sorted(ptrs.items())]


def _cell_pre(hj: int, hk: int, xs) -> List[str]:
    """A region loop's cell: global (gj, gk), and its flat index in
    regions of other widths."""
    return ([f"const int gj = j0 - {hj} + jl, gk = k0 - {hk} + kl;",
             "(void)gj; (void)gk;"]
            + [f"const int x{w} = jl * {w} + kl;" for w in sorted(xs)])


def _two_bodies(RJ: int, RK: int, pre, bodies, free: str,
                ind: str) -> List[str]:
    """The mask-free body where ``free`` holds (the block and step), the
    masked one elsewhere, each a region loop."""
    return ([f"{ind}if ({free}) {{  // mask-free"]
            + [ind + "  " + y for y in _region_loop(RJ, RK, pre + bodies[0])]
            + [f"{ind}}} else {{  // masked"]
            + [ind + "  " + y for y in _region_loop(RJ, RK, pre + bodies[1])]
            + [f"{ind}}}"])


def _region_loop3(RI: int, RJ: int, RK: int, body: List[str]) -> List[str]:
    """``_region_loop`` over an RI x RJ x RK region (rows il of RJ x RK
    cells, flat index p): a thread's first (il, jl, kl) comes from
    ``_thread_origins3`` before the march, later ones by constant steps
    with carries (no division in a pass)."""
    s = f"{RJ}x{RK}"
    if RJ == 1:
        head = [f"  int il = il0_{s}, kl = kl0_{s};", "  const int jl = 0;"]
        step = [f"    kl += SF_NT % {RK};", f"    il += SF_NT / {RK};",
                f"    if (kl >= {RK}) {{ kl -= {RK}; ++il; }}"]
    else:
        head = [f"  int il = il0_{s}, jl = jl0_{s}, kl = kl0_{s};"]
        step = [f"    kl += SF_NT % {RK};", f"    jl += SF_NT / {RK} % {RJ};",
                f"    il += SF_NT / {RJ * RK};",
                f"    if (kl >= {RK}) {{ kl -= {RK}; ++jl; }}",
                f"    if (jl >= {RJ}) {{ jl -= {RJ}; ++il; }}"]
    return (["{"] + head
            + ["#pragma unroll 1",
               f"  for (int p = tid; p < {RI * RJ * RK}; p += SF_NT) {{"]
            + ["    " + b for b in body] + step + ["  }", "}"])


def _thread_origins3(shapes) -> List[str]:
    """A thread's first (il, jl, kl) in a region of each (RJ, RK) row
    shape: the divisions before the march (``_region_loop3``)."""
    out = []
    for RJ, RK in sorted(shapes):
        s, n = f"{RJ}x{RK}", RJ * RK
        out.append(f"  const int il0_{s} = tid / {n}, jl0_{s} = (tid - "
                   f"il0_{s} * {n}) / {RK}, kl0_{s} = tid - il0_{s} * {n} "
                   f"- jl0_{s} * {RK};  (void)jl0_{s};")
    return out


def _block_reader(name: str, shape_f, shape_s, drow: int, dj: int, dk: int,
                  xs: set):
    """A read of a row-major block ``name`` of rows of ``shape_f`` (FJ x
    FK cells) by a region loop over rows of ``shape_s``: one load at a
    constant offset from the thread's cell (``p``, or ``x<FJ>_<FK>`` for
    another row shape: ``xs``), the block's row ``drow`` being the
    reader's row 0."""
    FJ, FK = shape_f

    def at(o):
        x = "p"
        if tuple(shape_f) != tuple(shape_s):
            x = f"x{FJ}_{FK}"
            xs.add((FJ, FK))
        return (f"{name}[{x} + "
                f"{(drow + o[0]) * FJ * FK + (dj + o[1]) * FK + dk + o[2]}]")
    return at


def _cell_pre3(gi: str, hj: int, hk: int, xs) -> List[str]:
    """A 3-D region loop's cell: global (gi, gj, gk) from row ``gi`` + il,
    and its flat index in blocks of other row shapes."""
    return ([f"const int gi = {gi} + il, gj = j0 - {hj} + jl, "
             f"gk = k0 - {hk} + kl;", "(void)gi; (void)gj; (void)gk;"]
            + [f"const int x{FJ}_{FK} = (il * {FJ} + jl) * {FK} + kl;"
               for FJ, FK in sorted(xs)])


def _two_bodies3(R: int, RJ: int, RK: int, pres, bodies, free: str,
                 ind: str) -> List[str]:
    """``_two_bodies`` over a 3-D region; ``free`` None keeps the masked
    body alone."""
    if free is None:
        return [ind + y for y in _region_loop3(R, RJ, RK,
                                               pres[1] + bodies[1])]
    return ([f"{ind}if ({free}) {{  // mask-free"]
            + [ind + "  " + y for y in _region_loop3(R, RJ, RK,
                                                     pres[0] + bodies[0])]
            + [f"{ind}}} else {{  // masked"]
            + [ind + "  " + y for y in _region_loop3(R, RJ, RK,
                                                     pres[1] + bodies[1])]
            + [f"{ind}}}"])


def _flat_at(dim_mask, coords, dims) -> str:
    """Row-major flat index of in-range coords over the spanned dims."""
    idx = None
    for d in range(3):
        if dim_mask[d]:
            idx = (f"(long long)({coords[d]})" if idx is None
                   else f"({idx}) * {dims[d]}LL + ({coords[d]})")
    return idx or "0LL"


def _async_copy(program, f: str, dst: str, src: str) -> str:
    """One element of ``f`` from ``src`` to shared ``dst``: a cp.async
    zero-filled where ``inb`` is false (synchronous for 1- and 2-byte
    types)."""
    size = np.dtype(program.field_dtype(f)).itemsize
    if size in (4, 8):
        return f"sf_cp{size}({dst}, {src}, inb);"
    return (f"*({dst}) = inb ? *({src}) : "
            f"{zero(program.field_dtype(f))};")


_CP_WAIT_ALL = """#ifdef __CUDACC__
#define SF_CP_WAIT_ALL() asm volatile("cp.async.wait_group 0;" ::: "memory")
#else
#define SF_CP_WAIT_ALL()
#endif
"""


def panel_source(program: ir.Program, analysis: ChainAnalysis, plan) -> str:
    """The panel streamer for ``plan`` (backend/panel.py PanelPlan), K1.

    Per plane step t: the threads issue the cp.async loads of plane t +
    AHEAD of every ring input into its slot, wait until plane t has
    landed, and after a barrier every live stage s evaluates its region
    for plane q = t - lag(s), then a barrier.  Ring slots rotate by
    per-step counters (t mod S for each slot count S), so every ring
    read is one shared-memory load at a constant offset from a per-step
    slot base plus the thread's cell: no modulo or division in a read.
    Each stage has a mask-free body and a masked one (boundary conditions
    from global coordinates), taken per block and step: mask-free where
    the block's widest reach lies inside the (j, k) domain and the
    stage's i reach inside [0, I).  Shared memory is
    ``plan.ring_offsets``: rings of one step packed by liveness;
    ``__launch_bounds__`` asks for the blocks per SM that it leaves room
    for, and a block has ``plan.threads`` threads.  Like
    ``stream_source``, the block body also compiles with g++ into
    ``sf_host_launch`` (one thread a block, shared memory NaN-filled)."""
    I, J, K = dims = program.dimensions
    order, head, slots = _common(program, analysis)
    tj, tk = plan.tile
    ntj, ntk = plan.grid(dims)
    offs = plan.ring_offsets(program)
    params, args = _params(program)
    from .panel import i_reach, reach
    Hj, Hk = reach(program, plan)
    L = [head, _STREAM_MACROS] + _bf16_macros(plan, program) + \
        _skeleton_macros(plan.threads) + _group_macros(plan) + [
         "// panel streamer (backend/panel.py): replaces the TPU kernel "
         "stencilflow_tpu/backend/panel.py _panel_kernel_body (K1)",
         "SF_DEV void sf_panel_block(const int by, const int bx, "
         "const int tid, const int nt, unsigned char* const sf_smem, "
         f"{params}) {{",
         "  (void)nt;",
         f"  const int j0 = by * {tj}, k0 = bx * {tk};",
         "  // every cell and read of the block inside the (j, k) domain",
         f"  const bool inner = j0 >= {Hj} && j0 + {tj + Hj} <= {J} && "
         f"k0 >= {Hk} && k0 + {tk + Hk} <= {K};",
         "  (void)inner;"]
    for f in plan.ring:
        ct = _slot_type(program, plan, f)
        L.append(f"  {ct}* const r_{f} = ({ct}*)(sf_smem + {offs[f]});")
    widths = sorted({plan.region(f)[1] for f in program.kernels}
                    | {_load_width(plan, f) for f in plan.inputs})
    counters = sorted({plan.slots(f) for f in plan.ring} - {1})
    L += [f"  int m{S} = 0;  // t mod {S}" for S in counters]
    L += _thread_origins(widths)
    prologue, ingest = _ingest(program, plan, plan.inputs, I)
    L += prologue
    L.append(f"  for (int t = 0; t < {plan.steps()}; ++t) {{")
    L += ingest
    for idx, s in enumerate(order):
        kspec = program.kernels[s]
        RJ, RK = plan.region(s)
        hj, hk = plan.halo[s]
        lo, hi = i_reach(program, s)
        ptrs: Dict[Tuple[str, int], str] = {}
        xs = set()
        onchip = _ring_reader(program, plan, s, RK, ptrs, xs, plan.ring)
        bodies = []
        for masked in (False, True):
            body = _stage_call(program, kspec, idx, ("q", "gj", "gk"),
                               onchip, slots, masked=masked)
            if s in plan.ring:
                body.append(f"w[p] = {_to_slot(program, plan, s, 'r')};")
            if s in program.outputs:
                cond = []
                if hj:
                    cond.append(f"jl >= {hj} && jl < {hj + tj}")
                if hk:
                    cond.append(f"kl >= {hk} && kl < {hk + tk}")
                if masked:
                    cond.append(f"gj < {J} && gk < {K}")
                write = (f"o_{s}[((long long)q * {J} + gj) * {K} + gk] = "
                         f"{store(kspec.dtype, 'r')};")
                body.append(f"if ({' && '.join(cond)}) {write}" if cond
                            else write)
            bodies.append(body)
        L += [f"    {{  // stage {s}: {RJ} x {RK}",
              f"      const int q = t - {plan.lag[s]};",
              f"      if (q >= 0 && q < {I}) {{"]
        if s in plan.ring:
            ct = _slot_type(program, plan, s)
            L.append(f"        {ct}* const w = r_{s} + "
                     f"{_slot(plan, s, plan.lag[s])} * {RJ * RK};")
        L += _ring_bases(program, plan, ptrs, "        ")
        L += _two_bodies(RJ, RK, _cell_pre(hj, hk, xs), bodies,
                         f"inner && q >= {lo} && q < {I - hi}", "        ")
        L += ["        SF_SYNC();", "      }", "    }"]
    L += [f"    m{S} = sf_wrap(m{S} + 1, {S});" for S in counters]
    L += ["  }", "}"]
    L += _entry_points(program, "sf_panel", params, args, (ntj, ntk),
                       plan.smem_bytes(program), slots,
                       min_blocks=plan.min_blocks(program),
                       threads=plan.threads)
    L += _occupancy(plan.smem_bytes(program), plan.threads)
    return "\n".join(L)


def _occupancy(smem: int, threads: int, kernel: str = "sf_panel"
               ) -> List[str]:
    return ["#ifdef __CUDACC__",
            "// resident blocks per SM at this shared memory",
            'extern "C" int sf_occupancy(int* blocks) {',
            f"  cudaError_t e = cudaFuncSetAttribute({kernel}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, "
            f"{smem});",
            "  if (e != cudaSuccess) return (int)e;",
            "  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor("
            f"blocks, {kernel}, {threads}, "
            f"{smem});",
            "}", "#endif"]


# -- stream streamer (backend/stream.py) ---------------------------------------

_STREAM_MACROS = """#ifdef __CUDACC__
#define SF_DEV __device__ __forceinline__
#define SF_SYNC() __syncthreads()
#define SF_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#define SF_DEV static inline
#define SF_SYNC()
#define SF_LDG(p) (*(p))
#endif
"""


# the spill rung's asynchronous copies (K3c): bulk stores of staging planes
# to the spill buffer, bulk loads completed on mbarriers; on the host the
# copies are memcpy at the point of issue and the waits do nothing
_SPILL_MACROS = """#ifdef __CUDACC__
SF_DEV unsigned sf_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p); }
#define SF_FENCE_ASYNC() asm volatile("fence.proxy.async.shared::cta;" ::: "memory")
#define SF_MBAR_INIT(b) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sf_saddr(b)) : "memory")
#define SF_MBAR_FENCE_INIT() asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory")
#define SF_BULK_COMMIT() asm volatile("cp.async.bulk.commit_group;" ::: "memory")
#define SF_BULK_WAIT_READ() asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory")
#define SF_BULK_WAIT() asm volatile("cp.async.bulk.wait_group 0;\\n\\tfence.proxy.async.global;" ::: "memory")
SF_DEV void sf_bulk_store(void* dst, const void* src, const unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(sf_saddr(src)), "r"(bytes) : "memory");
}
SF_DEV void sf_bulk_load(void* dst, const void* src, const unsigned bytes,
                         unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(sf_saddr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(sf_saddr(dst)), "l"(src), "r"(bytes), "r"(sf_saddr(bar))
               : "memory");
}
SF_DEV void sf_mbar_wait(unsigned long long* bar, const unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\\n\\t.reg .pred p;\\n\\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n\\t"
                 "selp.u32 %0, 1, 0, p;\\n\\t}"
                 : "=r"(done) : "r"(sf_saddr(bar)), "r"(parity) : "memory");
}
#else
#define SF_FENCE_ASYNC()
#define SF_MBAR_INIT(b)
#define SF_MBAR_FENCE_INIT()
#define SF_BULK_COMMIT()
#define SF_BULK_WAIT_READ()
#define SF_BULK_WAIT()
SF_DEV void sf_bulk_store(void* dst, const void* src, const unsigned bytes) {
  memcpy(dst, src, bytes);
}
SF_DEV void sf_bulk_load(void* dst, const void* src, const unsigned bytes,
                         unsigned long long* bar) {
  (void)bar;
  memcpy(dst, src, bytes);
}
SF_DEV void sf_mbar_wait(unsigned long long* bar, const unsigned parity) {
  (void)bar;
  (void)parity;
}
#endif
"""


# bf16 rings with f32 compute (ring_storage="bfloat16": K1, K3a, K3c, K5)
# and the single-pass bf16 band operands (mxu_precision="bf16": K3b):
# sf_f2bf rounds to nearest, ties to even, where a value is stored (and
# passes a bf16 value through); sf_bf2f reads it back as f32; sf_bfr is
# both (an f32 slot that holds a rounded value).  Programs typed bfloat16
# keep their values in bf16 (the typed emitter): sf_bf_add / sf_bf_sub /
# sf_bf_mul are add.rn.bf16 / sub.rn.bf16 / mul.rn.bf16 on the card
# (sm_90, inline PTX: no contraction into fma), equal to the float
# operation rounded once since float32 holds 24 >= 2 x 8 + 2 bits
# (Figueroa 1995), and that float operation on the host; sf_bfk is a
# constant by its bits, sf_bf_neg / sf_bf_abs / sf_bf_min / sf_bf_max
# pass an operand's bits through, and sf_bfq gives a value passed through
# as sf_f2bf gives its float (a NaN as the conversion makes it).  On the
# host a uint16_t carries the bits (NaN kept).  Emitted only into sources
# that use them.
_BF16_MACROS = """#ifdef __CUDACC__
#include <cuda_bf16.h>
typedef __nv_bfloat16 sf_bf16;
SF_DEV sf_bf16 sf_f2bf(const float v) { return __float2bfloat16_rn(v); }
SF_DEV float sf_bf2f(const sf_bf16 v) { return __bfloat162float(v); }
SF_DEV sf_bf16 sf_bfk(const unsigned short u) { return __ushort_as_bfloat16(u); }
SF_DEV unsigned short sf_bfu(const sf_bf16 v) { return __bfloat16_as_ushort(v); }
#define SF_BF_OP(name, op) \
  SF_DEV sf_bf16 name(const sf_bf16 a, const sf_bf16 b) { \
    unsigned short r; \
    asm(op " %0, %1, %2;" : "=h"(r) : "h"(sf_bfu(a)), "h"(sf_bfu(b))); \
    return sf_bfk(r); }
SF_BF_OP(sf_bf_add, "add.rn.bf16")
SF_BF_OP(sf_bf_sub, "sub.rn.bf16")
SF_BF_OP(sf_bf_mul, "mul.rn.bf16")
#else
typedef uint16_t sf_bf16;
SF_DEV sf_bf16 sf_f2bf(const float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (sf_bf16)((u >> 16) | 0x40u);
  return (sf_bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
SF_DEV float sf_bf2f(const sf_bf16 h) {
  const uint32_t u = (uint32_t)h << 16;
  float r;
  memcpy(&r, &u, 4);
  return r;
}
SF_DEV sf_bf16 sf_bfk(const unsigned short u) { return (sf_bf16)u; }
SF_DEV unsigned short sf_bfu(const sf_bf16 v) { return v; }
SF_DEV sf_bf16 sf_bf_add(const sf_bf16 a, const sf_bf16 b) {
  return sf_f2bf(sf_bf2f(a) + sf_bf2f(b)); }
SF_DEV sf_bf16 sf_bf_sub(const sf_bf16 a, const sf_bf16 b) {
  return sf_f2bf(sf_bf2f(a) - sf_bf2f(b)); }
SF_DEV sf_bf16 sf_bf_mul(const sf_bf16 a, const sf_bf16 b) {
  return sf_f2bf(sf_bf2f(a) * sf_bf2f(b)); }
#endif
SF_DEV float sf_bfr(const float v) { return sf_bf2f(sf_f2bf(v)); }
SF_DEV sf_bf16 sf_f2bf(const sf_bf16 v) { return v; }
SF_DEV sf_bf16 sf_bf_neg(const sf_bf16 a) {
  return sf_bfk((unsigned short)(sf_bfu(a) ^ 0x8000u)); }
SF_DEV sf_bf16 sf_bf_abs(const sf_bf16 a) {
  return sf_bfk((unsigned short)(sf_bfu(a) & 0x7fffu)); }
SF_DEV sf_bf16 sf_bf_min(const sf_bf16 a, const sf_bf16 b) {
  const float x = sf_bf2f(a), y = sf_bf2f(b);
  return x != x ? a : (y != y ? b : (y < x ? b : a)); }
SF_DEV sf_bf16 sf_bf_max(const sf_bf16 a, const sf_bf16 b) {
  const float x = sf_bf2f(a), y = sf_bf2f(b);
  return x != x ? a : (y != y ? b : (y > x ? b : a)); }
SF_DEV sf_bf16 sf_bfq(const sf_bf16 v) {
  const float x = sf_bf2f(v);
  return x != x ? sf_f2bf(x) : v; }
"""


def _bf16_macros(plan, program) -> List[str]:
    """``_BF16_MACROS`` for a plan that rounds a ring or a band operand
    (none where ``_common`` emitted them already: ``program`` has a
    narrow field)."""
    uses = (plan.rounds or getattr(plan, "rounds_out", ())
            or getattr(plan, "bf16_passes", False))
    return [_BF16_MACROS] if uses and not has_narrow(program) else []


def _ring_type(program, plan, f: str, rtype=None):
    """The type ring ``f``'s slots hold: ``rtype(f)`` where the caller
    gives it (the stream kernel's ``StreamPlan.ring_dtype``), else the
    plan's 2-byte ``slot_dtype`` where it keeps 2-byte slots and the
    field's type otherwise."""
    if rtype is not None:
        return rtype(f)
    return plan.slot_dtype if plan.narrow_slots(f) else \
        program.field_dtype(f)


def _slot_type(program, plan, f: str, rtype=None) -> str:
    """C type of ring ``f``'s slots (``_ring_type``)."""
    return stype(_ring_type(program, plan, f, rtype))


def _from_slot(program, plan, f: str, lv: str, rtype=None) -> str:
    """A read of ring ``f``'s slot ``lv`` as its compute type: the slot
    itself where it holds the field's own type and the plan has no
    compute type (the typed emitter's values), else widened."""
    rt = np.dtype(_ring_type(program, plan, f, rtype))
    if getattr(plan, "compute", None) is None and \
            rt == np.dtype(program.field_dtype(f)):
        return lv
    return load(rt, lv)


def _to_slot(program, plan, f: str, v: str, rtype=None) -> str:
    """Value ``v`` as ring ``f`` stores it: converted to the 2-byte
    ``slot_dtype``, rounded to it in an f32 slot (a rounded ring that
    keeps f32 slots), or as its type stores it."""
    if plan.narrow_slots(f):
        return store(plan.slot_dtype, v)
    return f"{_rnd(plan.slot_dtype)}({v})" if plan.rounded(f) else store(
        _ring_type(program, plan, f, rtype), v)


def _param_names(params: str) -> str:
    return ", ".join(p.split()[-1] for p in params.split(", "))


# the band passes' warp-level product on tensor cores (K3b under
# mxu_precision="split"): one 16 x 8 output tile of D = X . B, X read from
# shared memory with any strides (a k-pass's source rows, or a j-pass's
# source columns: the j-pass runs transposed), B the band (tap m - n of
# output n) from a weight vector (w_cs 0) or a table window (w_ts the
# window's width, w_cs 1); X and B zero outside their extents.  Both
# operands split into TF32 hi = cvt.rna(v) and lo = cvt.rna(v - hi), three
# products a k-step of 8 (lo.hi + hi.lo + hi.hi) with f32 accumulation.
# The host version computes the same three products per element (one
# thread runs every tile there).
_MMA_MACROS = """#ifdef __CUDACC__
SF_DEV unsigned sf_tf32(const float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
SF_DEV void sf_mma_tf32(float (&c)[4], const unsigned (&a)[4],
                        const unsigned (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                 "r"(b[0]), "r"(b[1]));
}
template <int KS>
SF_DEV void sf_mma_band(float* const d, const int d_rs, const int d_cs,
                        const int d_rows, const int d_cols,
                        const float* const x, const int x_rs, const int x_cs,
                        const int x_rows, const int x_cols,
                        const float* const w, const int w_ts, const int w_cs,
                        const int taps, const int lane) {
  const int g = lane >> 2, c = lane & 3;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int m0 = 8 * s + c, m1 = m0 + 4;
    const float av[4] = {
        (g < x_rows && m0 < x_cols) ? x[g * x_rs + m0 * x_cs] : 0.0f,
        (g + 8 < x_rows && m0 < x_cols) ? x[(g + 8) * x_rs + m0 * x_cs] : 0.0f,
        (g < x_rows && m1 < x_cols) ? x[g * x_rs + m1 * x_cs] : 0.0f,
        (g + 8 < x_rows && m1 < x_cols) ? x[(g + 8) * x_rs + m1 * x_cs]
                                        : 0.0f};
    const int t0 = m0 - g, t1 = m1 - g;
    const float bv[2] = {
        (t0 >= 0 && t0 < taps) ? w[t0 * w_ts + g * w_cs] : 0.0f,
        (t1 >= 0 && t1 < taps) ? w[t1 * w_ts + g * w_cs] : 0.0f};
    unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = sf_tf32(av[i]);
      al[i] = sf_tf32(av[i] - __uint_as_float(ah[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bh[i] = sf_tf32(bv[i]);
      bl[i] = sf_tf32(bv[i] - __uint_as_float(bh[i]));
    }
    sf_mma_tf32(acc, al, bh);
    sf_mma_tf32(acc, ah, bl);
    sf_mma_tf32(acc, ah, bh);
  }
  const int n0 = 2 * c, n1 = n0 + 1;
  if (g < d_rows && n0 < d_cols) d[g * d_rs + n0 * d_cs] = acc[0];
  if (g < d_rows && n1 < d_cols) d[g * d_rs + n1 * d_cs] = acc[1];
  if (g + 8 < d_rows && n0 < d_cols) d[(g + 8) * d_rs + n0 * d_cs] = acc[2];
  if (g + 8 < d_rows && n1 < d_cols) d[(g + 8) * d_rs + n1 * d_cs] = acc[3];
}
#else
// cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
SF_DEV float sf_tf32h(const float v) {
  unsigned u;
  memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  float r;
  memcpy(&r, &u, 4);
  return r;
}
template <int KS>
SF_DEV void sf_mma_band(float* const d, const int d_rs, const int d_cs,
                        const int d_rows, const int d_cols,
                        const float* const x, const int x_rs, const int x_cs,
                        const int x_rows, const int x_cols,
                        const float* const w, const int w_ts, const int w_cs,
                        const int taps, const int lane) {
  (void)lane;
  for (int r = 0; r < 16 && r < d_rows; ++r)
    for (int n = 0; n < 8 && n < d_cols; ++n) {
      float acc = 0.0f;
      for (int m = 0; m < 8 * KS; ++m) {
        const float a = (r < x_rows && m < x_cols) ? x[r * x_rs + m * x_cs]
                                                   : 0.0f;
        const int tp = m - n;
        const float b = (tp >= 0 && tp < taps) ? w[tp * w_ts + n * w_cs]
                                               : 0.0f;
        const float ah = sf_tf32h(a), al = sf_tf32h(a - ah);
        const float bh = sf_tf32h(b), bl = sf_tf32h(b - bh);
        acc = acc + al * bh;
        acc = acc + ah * bl;
        acc = acc + ah * bh;
      }
      d[r * d_rs + n * d_cs] = acc;
    }
}
#endif
"""


# the single-pass bf16 band pass on tensor cores (K3b under
# mxu_precision="bf16"): ``sf_mma_band``'s tile and operands, with both
# operands rounded to bf16 (to nearest, ties to even) and one
# mma.sync m16n8k16 bf16 product a k-step of 16 with f32 accumulation.
# Fragments: A (16 x 16, row) a[0] = row g cols 2c, 2c + 1; a[1] = row
# g + 8, the same cols; a[2], a[3] the same rows at cols 2c + 8, 2c + 9;
# B (16 x 8, col) b[0] = rows 2c, 2c + 1 of col g, b[1] = rows 2c + 8,
# 2c + 9; each register holds its lower column (row) in its low half.
# A product of two bf16 values is exact in f32, so the host version (the
# same rounded operands summed in f32 in tap order, as the CUDA-core pass
# sums them) differs from the card's only in the order of the sums.
_MMA_BF16_MACROS = """#ifdef __CUDACC__
SF_DEV unsigned sf_bf16x2(const float lo, const float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
SF_DEV void sf_mma_bf16(float (&c)[4], const unsigned (&a)[4],
                        const unsigned (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                 "r"(b[0]), "r"(b[1]));
}
template <int KS>
SF_DEV void sf_mma_band_bf16(float* const d, const int d_rs, const int d_cs,
                             const int d_rows, const int d_cols,
                             const float* const x, const int x_rs,
                             const int x_cs, const int x_rows,
                             const int x_cols, const float* const w,
                             const int w_ts, const int w_cs, const int taps,
                             const int lane) {
  const int g = lane >> 2, c = lane & 3;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    float av[8], bv[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 16 * s + 2 * c + 8 * h + e, t = m - g;
        av[4 * h + e] = (g < x_rows && m < x_cols) ? x[g * x_rs + m * x_cs]
                                                   : 0.0f;
        av[4 * h + 2 + e] = (g + 8 < x_rows && m < x_cols)
                                ? x[(g + 8) * x_rs + m * x_cs] : 0.0f;
        bv[2 * h + e] = (t >= 0 && t < taps) ? w[t * w_ts + g * w_cs] : 0.0f;
      }
    const unsigned a[4] = {sf_bf16x2(av[0], av[1]), sf_bf16x2(av[2], av[3]),
                           sf_bf16x2(av[4], av[5]), sf_bf16x2(av[6], av[7])};
    const unsigned b[2] = {sf_bf16x2(bv[0], bv[1]), sf_bf16x2(bv[2], bv[3])};
    sf_mma_bf16(acc, a, b);
  }
  const int n0 = 2 * c, n1 = n0 + 1;
  if (g < d_rows && n0 < d_cols) d[g * d_rs + n0 * d_cs] = acc[0];
  if (g < d_rows && n1 < d_cols) d[g * d_rs + n1 * d_cs] = acc[1];
  if (g + 8 < d_rows && n0 < d_cols) d[(g + 8) * d_rs + n0 * d_cs] = acc[2];
  if (g + 8 < d_rows && n1 < d_cols) d[(g + 8) * d_rs + n1 * d_cs] = acc[3];
}
#else
template <int KS>
SF_DEV void sf_mma_band_bf16(float* const d, const int d_rs, const int d_cs,
                             const int d_rows, const int d_cols,
                             const float* const x, const int x_rs,
                             const int x_cs, const int x_rows,
                             const int x_cols, const float* const w,
                             const int w_ts, const int w_cs, const int taps,
                             const int lane) {
  (void)lane;
  for (int r = 0; r < 16 && r < d_rows; ++r)
    for (int n = 0; n < 8 && n < d_cols; ++n) {
      float acc = 0.0f;
      for (int m = 0; m < 16 * KS; ++m) {
        const float a = (r < x_rows && m < x_cols) ? x[r * x_rs + m * x_cs]
                                                   : 0.0f;
        const int tp = m - n;
        const float b = (tp >= 0 && tp < taps) ? w[tp * w_ts + n * w_cs]
                                               : 0.0f;
        acc = acc + sf_bfr(a) * sf_bfr(b);
      }
      d[r * d_rs + n * d_cs] = acc;
    }
}
#endif
"""


def mma_probe_source(ksteps=(2, 5, 6), bf16: bool = False) -> str:
    """``sf_mma_band`` alone, for the tests: ``int sf_mma_probe(x, w, d,
    x_rs, x_cs, x_rows, x_cols, w_ts, w_cs, taps, ks, stream)`` runs one
    warp on the card over device arrays (one 16 x 8 tile, X of 16 x 8 ks
    and the band as ``sf_mma_band`` takes them); g++ builds
    ``sf_mma_probe_host`` with the same arguments (host arrays, no
    stream) around the host version.  ``bf16``: the same for
    ``sf_mma_band_bf16``, whose k-steps are 16 deep (X of 16 x 16 ks)."""
    cases = "".join(f"    case {k}: CALL({k}); break;\n" for k in ksteps)
    args = ("d, 8, 1, 16, 8, x, x_rs, x_cs, x_rows, x_cols, w, w_ts, "
            "w_cs, taps")
    macros = _BF16_MACROS + _MMA_BF16_MACROS if bf16 else _MMA_MACROS
    band = "sf_mma_band_bf16" if bf16 else "sf_mma_band"
    return (prelude() + _STREAM_MACROS + macros + f"""
#define SF_PROBE_ARGS const float* x, const float* w, float* d, \\
    int x_rs, int x_cs, int x_rows, int x_cols, int w_ts, int w_cs, \\
    int taps, int ks
#ifdef __CUDACC__
template <int KS>
__global__ void sf_mma_probe_kernel(const float* x, const float* w,
                                    float* d, int x_rs, int x_cs,
                                    int x_rows, int x_cols, int w_ts,
                                    int w_cs, int taps) {{
  {band}<KS>({args}, threadIdx.x);
}}
#define CALL(K) sf_mma_probe_kernel<K><<<1, 32, 0, (cudaStream_t)stream>>>(\\
    x, w, d, x_rs, x_cs, x_rows, x_cols, w_ts, w_cs, taps)
extern "C" int sf_mma_probe(SF_PROBE_ARGS, void* stream) {{
  switch (ks) {{
{cases}    default: return -1;
  }}
  return (int)cudaGetLastError();
}}
#else
#define CALL(K) {band}<K>({args}, 0)
extern "C" int sf_mma_probe_host(SF_PROBE_ARGS) {{
  switch (ks) {{
{cases}    default: return -1;
  }}
  return 0;
}}
#endif
""")


def _tile_loop(NR: int, NC: int, body: List[str]) -> List[str]:
    """The warps of a block over an NR x NC grid of tiles in row-major
    order, as ``_region_loop`` walks cells: a warp's first tile (tr, tc)
    from one division before the i-march, later ones by constant
    steps."""
    return ["{",
            f"  int tr = tr0_{NC}, tc = tc0_{NC};",
            "#pragma unroll 1",
            f"  for (int w = warp; w < {NR * NC}; w += SF_NW) {{"] \
        + ["    " + b for b in body] \
        + [f"    tc += SF_NW % {NC};", f"    tr += SF_NW / {NC};",
           f"    if (tc >= {NC}) {{ tc -= {NC}; ++tr; }}", "  }", "}"]


class _StreamEmitter:
    """The block body of the stream kernel for one StreamPlan."""

    def __init__(self, program, plan, slots):
        self.program, self.plan, self.slots = program, plan, slots
        self.dims = program.dimensions
        # the arrays' extents: a local kernel's slabs hold its planes, a
        # shard's its widened (j, k) plane, whose cell (0, 0) is global
        # (wj, wk)
        self.adims = (plan.extent(),) + tuple(plan.plane())
        self.sharded = bool(plan.shard[0])
        self.pidx = {k: i for i, (k, _) in enumerate(plan.kernel_pool())}
        self.tidx = {t: n for n, t in enumerate(plan.tkeys)}
        self.n_otf = 0
        self.widths = set()     # widths of the region loops
        self.tiles = set()      # column counts of the tile loops
        self.routes = set()     # the band passes' routes
        self.vectors = set()    # bands whose weight vector is written
        # single-pass bf16 band passes: both operands of every pass round
        # to bf16 (the pool's bands are bf16 already: linear.finalize_pool)
        self.bf = plan.mxu_precision == "bf16"
        # a compute type: the arrays hold it (``cd``; None: the program's
        # types); a narrow one (``cbf``: BFLOAT16 or FLOAT16) rounds every
        # stage's result
        self.cd = plan.compute
        self.cbf = plan.compute_narrow

    def gread(self, g: str, f: str) -> str:
        """A value of field ``f``'s global array read at ``g`` as its
        compute type."""
        return load(self.plan.dtype(f), g)

    def out(self, v: str, s: str) -> str:
        """Value ``v`` as stage ``s``'s output array stores it."""
        return store(self.plan.dtype(s), v)

    def opnd(self, x: str) -> str:
        """A band pass's source operand ``x`` (rounded to bf16 under
        mxu_precision="bf16")."""
        return f"sf_bfr({x})" if self.bf else x

    def glob(self, pexpr: str) -> str:
        """Global index of plane ``pexpr`` (a local kernel's plane 0 is
        global plane ``origin_i``)."""
        return f"(origin_i + {pexpr})" if self.plan.block else pexpr

    def at(self, jexpr: str, kexpr: str) -> Tuple[str, str]:
        """Indices into the arrays' (and the pool's) planes of global
        cell (``jexpr``, ``kexpr``)."""
        if self.sharded:
            return f"({jexpr} - wj)", f"({kexpr} - wk)"
        return jexpr, kexpr

    def tslot(self, tkey, d: int) -> str:
        """Slot of ``tkey``'s transform ring holding plane t - d at step
        t (its depth's counter)."""
        return _slot_of(self.plan.tring[tkey], d)

    def raw(self, f, pexpr) -> str:
        """Raw plane ``pexpr`` of a field without a ring (a lower-rank
        input) at the stage's cell."""
        if f in self.program.inputs and self.program.inputs[f].is_scalar:
            return f"sc.x{self.slots[f]}"
        mask = self.program.field_dim_mask(f)
        c = (pexpr,) + self.at("gj", "gk") if self.sharded else (
            pexpr, "(gj + 0)", "(gk + 0)")
        g = self.gread(f"g_{f}[{_flat(mask, c, self.adims)}]", f)
        return f"(({_inb(mask, c, self.adims)}) ? {g} : 0.0f)"

    def otf(self, tkey, pexpr, pre: List[str]) -> str:
        """Transformed plane ``pexpr`` of a field without a ring, summed
        on the fly from device memory (statements appended to ``pre``)."""
        plan = self.plan
        f, lkey, rkey = tkey
        _, J, K = self.dims
        PJ, PK = self.adims[1:]
        mask = self.program.field_dim_mask(f)
        v = f"tv{self.n_otf}"
        self.n_otf += 1
        g = self.gread(f"g_{f}[{_flat(mask, (pexpr,) + self.at('sj', 'sk'), self.adims)}]", f)
        lj, lk = self.at("gj", "gk")
        pre += [f"float {v} = 0.0f;",
                f"if (gj >= 0 && gj < {J} && gk >= 0 && gk < {K}) {{"]
        if self.bf and lkey is not None and rkey is not None:
            # single-pass bf16: the j-pass first, each of its sums rounded
            # before the k-pass, as the reference's (L @ P) @ R rounds
            dj0, dj1 = plan.band(lkey, "L")[0][0], plan.band(lkey, "L")[0][-1]
            dk0, dk1 = plan.band(rkey, "R")[0][0], plan.band(rkey, "R")[0][-1]
            pre += [f"  for (int dk = {dk0}; dk <= {dk1}; ++dk) {{",
                    "    const int sk = gk + dk;",
                    f"    if (sk < 0 || sk >= {K}) continue;",
                    "    float ls = 0.0f;",
                    f"    for (int dj = {dj0}; dj <= {dj1}; ++dj) {{",
                    "      const int sj = gj + dj;",
                    f"      if (sj < 0 || sj >= {J}) continue;",
                    f"      ls = ls + SF_LDG(pc{self.pidx[lkey]} + "
                    f"(dj - ({dj0})) * {PJ} + {lj}) * {self.opnd(g)};",
                    "    }",
                    f"    {v} = {v} + SF_LDG(pc{self.pidx[rkey]} + "
                    f"(dk - ({dk0})) * {PK} + {lk}) * {self.opnd('ls')};",
                    "  }", "}"]
            return v
        if lkey is not None:
            offs = plan.band(lkey, "L")[0]
            dj0, dj1 = offs[0], offs[-1]
            pre += [f"  for (int dj = {dj0}; dj <= {dj1}; ++dj) {{",
                    "    const int sj = gj + dj;",
                    f"    if (sj < 0 || sj >= {J}) continue;"]
        else:
            pre += ["  {", "    const int sj = gj;"]
        if rkey is not None:
            offs = plan.band(rkey, "R")[0]
            dk0, dk1 = offs[0], offs[-1]
            pre += ["    float rs = 0.0f;",
                    f"    for (int dk = {dk0}; dk <= {dk1}; ++dk) {{",
                    "      const int sk = gk + dk;",
                    f"      if (sk < 0 || sk >= {K}) continue;",
                    f"      rs = rs + SF_LDG(pc{self.pidx[rkey]} + "
                    f"(dk - ({dk0})) * {PK} + {lk}) * {self.opnd(g)};",
                    "    }"]
        else:
            pre += ["    const int sk = gk;", f"    const float rs = {g};"]
        if lkey is not None:
            pre.append(f"    {v} = {v} + SF_LDG(pc{self.pidx[lkey]} + "
                       f"(dj - ({dj0})) * {PJ} + {lj}) * {self.opnd('rs')};")
        else:
            pre.append(f"    {v} = rs;")
        pre += ["  }", "}"]
        return v

    def tread(self, tkey, s, d: int, RK: int, tptrs, xs, pre) -> str:
        """Transformed plane t - ``d`` of ``tkey`` at stage ``s``'s cell:
        its plane of the step, its ring's slot base (``tptrs``), or, for a
        ``fused`` transform, its j-pass summed here (statements appended
        to ``pre``)."""
        plan = self.plan
        n = self.tidx[tkey]
        TJ, TK = plan.region(tkey)
        dj = plan.thalo[tkey][0] - plan.halo[s][0]
        dk = plan.thalo[tkey][1] - plan.halo[s][1]
        x = "p" if TK == RK else f"x{TK}"
        if TK != RK:
            xs.add(TK)
        if plan.fused(tkey):
            # the j-pass at this cell: the j-band's taps of the scratch
            info = plan.band_info(tkey[1], "L")
            bj = plan.reach(tkey[1], "L")
            v = f"tj{self.n_otf}"
            self.n_otf += 1
            pre.append(f"float {v} = 0.0f;")
            pre += [f"{v} = fmaf({literal(np.float32(w), np.float32)}, "
                    + self.opnd(f"u{n}[{x} + {(dj + bj + d) * TK + dk}]")
                    + f", {v});"
                    for d, w in zip(info.offsets, info.w) if w != 0]
            return v
        if tkey in plan.instep:
            base = f"tp{n}"
        else:
            base = f"tb{n}_{d}"
            tptrs[base] = f"t{n} + {self.tslot(tkey, d)} * {TJ * TK}"
        return f"{base}[{x} + {dj * TK + dk}]"

    def banded(self, s, masked: bool, onchip, tptrs, xs) -> List[str]:
        """Statements computing ``const float r`` for banded stage ``s``,
        mask-free (every group's plane inside [0, I), the cell inside the
        (j, k) domain, a composed stage's interior i-weights as literals)
        or masked."""
        from .compose import ComposedPlan
        plan, mp = self.plan, self.plan.mxu_plans[s]
        I, J, K = self.dims
        RK = plan.region(s)[1]
        f32 = np.float32
        L = ["float acc = 0.0f;"]
        if isinstance(mp, ComposedPlan):
            tkey = (mp.field, mp.lkey, mp.rkey)
            D, rows = mp.D, mp.table_rows
            tab = plan.pool[mp.table_key]
            TJ, TK = plan.region(tkey)
            # the planes q + d, d ascending, sit in consecutive slots of
            # the mirrored ring from the first one's on
            first = self.tread(tkey, s, plan.lag[s] - mp.offsets[0], RK,
                               tptrs, xs, [])
            base, cell = first[:first.index("[")], first[
                first.index("[") + 1:-1].split(" + ")
            gq = self.glob("q")
            if masked:
                row = gq if mp.full_table else (
                    f"({gq} < {D} ? {gq} : ({gq} >= {I - D} ? {rows - I} + "
                    f"{gq} : {D}))")
                L.append(f"const int row = sf_clamp({row}, {rows});")
            w_in = tab[min(D, rows - 1)]
            for idx, d in enumerate(mp.offsets):
                v = f"{base}[{cell[0]} + {int(cell[1]) + idx * TJ * TK}]"
                if masked:
                    L.append(f"if ({gq} + {d} >= 0 && {gq} + {d} < {I}) acc = "
                             f"fmaf({v}, SF_LDG(pc{self.pidx[mp.table_key]}"
                             f" + row * {len(mp.offsets)} + {idx}), acc);")
                elif w_in[idx] != 0:
                    L.append(f"acc = fmaf({v}, "
                             f"{literal(f32(w_in[idx]), f32)}, acc);")
            L.append(f"const float r = {_rnd(self.cbf)}(acc);" if self.cbf
                     is not None else
                     "const float r = acc;")
            return L
        for grp in mp.groups:
            pexpr = "q" if grp.oi is None else "pi"
            L.append("{")
            if grp.oi is not None:
                L.append(f"  const int pi = q + {grp.oi};  (void)pi;")
            if grp.oi is not None and masked:
                gpi = self.glob("pi")
                L += ["  float part;",
                      f"  if ({gpi} < 0 || {gpi} >= {I}) part = "
                      f"{literal(f32(grp.bc_value * grp.weight_sum), f32)};",
                      "  else {"]
            else:
                L += ["  float part;", "  {"]
            for n_, term in enumerate(grp.terms):
                tkey = (grp.field, term.left_key, term.right_key)
                pre: List[str] = []
                ident = term.left_key is None and term.right_key is None
                if tkey in self.tidx:
                    val = self.tread(tkey, s, plan.lag[s] - (grp.oi or 0),
                                     RK, tptrs, xs, pre)
                elif ident and grp.field in plan.raw_ring:
                    val = onchip(grp.field)((grp.oi or 0, 0, 0))
                elif ident:
                    val = self.raw(grp.field, pexpr)
                else:
                    val = self.otf(tkey, pexpr, pre)
                L += ["    " + x for x in pre]
                scaled = ident or term.scale != 1.0
                sc = literal(f32(term.scale), f32)
                if n_ == 0:
                    L.append(f"    part = ({val}) * {sc};" if scaled else
                             f"    part = {val};")
                else:
                    L.append(f"    part = fmaf({val}, {sc}, part);" if scaled
                             else f"    part = part + {val};")
            if grp.correction_key is not None:
                c = f"pc{self.pidx[grp.correction_key]}"
                PK = self.adims[2]
                lj, lk = self.at("gj", "gk")
                if masked:
                    L.append(f"    part = part + ((gj >= 0 && gj < {J} && "
                             f"gk >= 0 && gk < {K}) ? SF_LDG({c} + {lj} * "
                             f"{PK} + {lk}) : 0.0f);")
                else:
                    L.append(f"    part = part + SF_LDG({c} + {lj} * {PK} + "
                             f"{lk});")
            L += ["  }", "  acc = acc + part;", "}"]
        if mp.bias:
            L.append(f"acc = acc + {literal(f32(mp.bias), f32)};")
        L.append(f"const float r = {_rnd(self.cbf)}(acc);" if self.cbf
                 is not None else
                 "const float r = acc;")
        return L

    # -- the band passes -----------------------------------------------------
    def band_setup(self, tkey, side: str, off) -> List[str]:
        """The block's copies of the band of ``tkey``'s ``side`` pass
        (``off``: the layout's offsets): its weight vector (written once
        per band) and its table window, and, for a band with
        non-Toeplitz columns, the block's flag ``tb<n><side>``: does the
        pass meet them?"""
        plan = self.plan
        n = self.tidx[tkey]
        key = tkey[2] if side == "R" else tkey[1]
        info = plan.band_info(key, side)
        vec, tab = plan.band_floats(tkey, side)
        name = f"{n}{side}"
        L = []
        if vec:
            L.append(f"  float* const bv{name} = (float*)(sf_smem + "
                     f"{off['bvec', key, side]});")
            if (key, side) not in self.vectors:
                self.vectors.add((key, side))
                L += ["  if (tid == 0) {"] + [
                    f"    bv{name}[{i}] = "
                    f"{literal(np.float32(w), np.float32)};"
                    for i, w in enumerate(info.w)] + ["  }"]
        if tab:
            htj, htk = plan.thalo[tkey]
            width = tab // info.taps
            base = f"k0 - {htk}" if side == "R" else f"j0 - {htj}"
            # the table's columns: global, or a shard plane's
            n, x0 = info.n, ""
            if self.sharded:
                n = self.adims[2 if side == "R" else 1]
                x0 = " - wk" if side == "R" else " - wj"
            inb = f"g >= 0 && g < {info.n}" + (
                f" && g{x0} < {n}" if x0 else "")
            L += [f"  float* const bt{name} = (float*)(sf_smem + "
                  f"{off['btab', tkey, side]});",
                  f"  for (int d = 0; d < {info.taps}; ++d)",
                  f"    for (int x = tid; x < {width}; x += SF_NT) {{",
                  f"      const int g = {base} + x;",
                  f"      bt{name}[d * {width} + x] = ({inb}) ? "
                  f"SF_LDG(pc{self.pidx[key]} + d * {n} + g{x0}) : 0.0f;",
                  "    }",
                  f"  const bool tb{name} = !({base} >= {info.lo} && "
                  f"{base} + {width} <= {info.hi}) && !({base} + {width} "
                  f"<= 0 || {base} >= {info.n});"]
        return L

    def mirror(self, tkey) -> List[str]:
        """The second copy of the step's plane of a ``mirrored`` ring that
        a tensor-core pass wrote."""
        plan = self.plan
        n = self.tidx[tkey]
        TJ, TK = plan.region(tkey)
        S = plan.tring[tkey]
        slot = self.tslot(tkey, plan.lag[tkey[0]])
        self.widths.add(TK)
        return ([f"if ({slot} < {S - 1}) {{  // mirror of transform {n}",
                 f"  float* const so = t{n} + {slot} * {TJ * TK};"]
                + ["  " + x for x in _region_loop(TJ, TK, [
                    f"so[p + {S * TJ * TK}] = so[p];"])] + ["}"])

    def fused_kpass(self, tkeys) -> List[str]:
        """The k-passes of ``fused`` transforms of one source plane and
        shape into their scratch tiles: one loop, each source value read
        once for every band (literal Toeplitz weights, CUDA cores)."""
        plan = self.plan
        f = tkeys[0][0]
        FJ, FK = plan.region(f)
        htj, htk = plan.thalo[tkeys[0]]
        oj, ok = plan.halo[f][0] - htj, plan.halo[f][1] - htk
        rows, cols = plan.scratch_shape(tkeys[0])
        roff = oj - plan.reach(tkeys[0][1], "L")
        raw = f"r_{f} + {_slot(plan, f, plan.instep[tkeys[0]])} * {FJ * FK}"
        self.widths.add(cols)
        self.routes.add("fma")
        names = [self.tidx[t] for t in tkeys]
        body = [f"const float* const sr = sx + (jl + {roff}) * {FK} + kl + "
                f"{ok};"] + [f"float s{n} = 0.0f;" for n in names]
        infos = [plan.band_info(t[2], "R") for t in tkeys]
        for d in sorted({d for i in infos for d in i.offsets}):
            for n, info in zip(names, infos):
                if d in info.offsets and info.w[d - info.offsets[0]] != 0:
                    w = info.w[d - info.offsets[0]]
                    body.append(f"s{n} = fmaf("
                                f"{literal(np.float32(w), np.float32)}, "
                                f"{self.opnd(f'sr[{d}]')}, s{n});")
        body += [f"u{n}[p] = s{n};" for n in names]
        return ([f"{{  // k-passes of transforms "
                 f"{', '.join(map(str, names))}: {f} (CUDA cores; their "
                 "j-passes run in their readers)",
                 f"  const float* const sx = {raw};"]
                + ["  " + x for x in _region_loop(rows, cols, body)] + ["}"])

    def tpass(self, tkey, side: str) -> List[str]:
        """``tkey``'s pass along ``side``'s axis ("R": the k-pass; "L":
        the j-pass; the first of a two-sided transform's, in
        ``plan.pass_order``, into its scratch) for the step's plane of
        the transform: one fmaf a tap on CUDA cores
        (literal Toeplitz weights, the block's table window where the
        band is not Toeplitz), or ``sf_mma_band`` tiles on tensor cores.
        The source planes hold 0 beyond the domain, so no read is
        masked."""
        plan = self.plan
        f, lkey, rkey = tkey
        n = self.tidx[tkey]
        FJ, FK = plan.region(f)
        TJ, TK = plan.region(tkey)
        htj, htk = plan.thalo[tkey]
        oj, ok = plan.halo[f][0] - htj, plan.halo[f][1] - htk
        key = rkey if side == "R" else lkey
        info = plan.band_info(key, side)
        d0, taps = info.offsets[0], info.taps
        order = plan.pass_order(tkey)
        two = len(order) == 2
        route = plan.route(key, side)
        self.routes.add(route)
        dsrc = plan.instep.get(tkey, plan.lag[f])
        raw = f"r_{f} + {_slot(plan, f, dsrc)} * {FJ * FK}"
        out = f"tp{n}" if tkey in plan.instep else \
            f"t{n} + {self.tslot(tkey, plan.lag[f])} * {TJ * TK}"
        name = f"{n}{side}"
        rows, cols = plan.pass_shape(tkey, side)
        # the first pass reads the raw plane (from the second's reach
        # before the region along the second's axis) into the scratch;
        # the second reads the scratch
        src, stride, roff, coff, srows = raw, FK, oj, ok, FJ
        if two and side == order[0]:
            out = f"u{n}"
            if side == "R":
                roff -= plan.reach(lkey, "L")
            else:
                coff -= plan.reach(rkey, "R")
        elif two:
            srows, stride = plan.scratch_shape(tkey)
            src, roff, coff = f"u{n}", plan.reach(lkey, "L"), 0
            if side == "R":
                roff, coff = 0, plan.reach(rkey, "R")
        L = [f"{{  // {'k' if side == 'R' else 'j'}-pass of transform {n}: "
             f"{f} ({taps} taps, {'tensor' if route == 'mma' else 'CUDA'} "
             "cores)",
             f"  const float* const sx = {src};",
             f"  float* const so = {out};"]
        # a mirrored ring's plane also goes to slot s + S (s < S - 1)
        mirror = (plan.mirrored(tkey) and route == "fma"
                  and side == order[-1])
        if mirror:
            S = plan.tring[tkey]
            L.append(f"  const bool mir = {self.tslot(tkey, plan.lag[f])} "
                     f"< {S - 1};")
        width = cols if side == "R" else TJ
        if route == "fma":
            self.widths.add(cols)

            def body(table: bool) -> List[str]:
                at = (f"sx + (jl + {roff}) * {stride} + kl + {coff}")
                b = [f"const float* const sr = {at};", "float s = 0.0f;"]
                for i, d in enumerate(info.offsets):
                    step = d if side == "R" else d * stride
                    src = self.opnd(f"sr[{step}]")
                    if table:
                        pos = "kl" if side == "R" else "jl"
                        b.append(f"s = fmaf(bt{name}[{i * width} + {pos}], "
                                 f"{src}, s);")
                    elif info.w[i] != 0:
                        b.append(f"s = fmaf({literal(np.float32(info.w[i]), np.float32)}, "
                                 f"{src}, s);")
                return b + ["so[p] = s;"] + (
                    [f"if (mir) so[p + {S * TJ * TK}] = s;"] if mirror
                    else [])
            lit = _region_loop(rows, cols, body(False))
            if info.toeplitz:
                L += ["  " + x for x in lit]
            else:
                L += [f"  if (tb{name}) {{"] + ["    " + x for x in
                                                _region_loop(rows, cols,
                                                             body(True))] \
                    + ["  } else {"] + ["    " + x for x in lit] + ["  }"]
            L.append("}")
            return L
        from .stream import mma_ksteps
        ks = mma_ksteps(taps, self.bf)
        fn = "sf_mma_band_bf16" if self.bf else "sf_mma_band"
        if info.toeplitz:
            band = f"bv{name}, 1, 0"
        else:
            band = (f"tb{name} ? bt{name} + {'c0' if side == 'R' else 'r0'}"
                    f" : bv{name}, tb{name} ? {width} : 1, tb{name} ? 1 : 0")
        if side == "R":
            NR, NC = -(-rows // 16), -(-cols // 8)
            body = ["const int r0 = tr * 16, c0 = tc * 8;",
                    f"{fn}<{ks}>(so + r0 * {cols} + c0, {cols}, 1, "
                    f"{rows} - r0, {cols} - c0,",
                    f"    sx + (r0 + {roff}) * {stride} + c0 + {coff + d0}, "
                    f"{stride}, 1, {rows} - r0, {stride - coff - d0} - c0,",
                    f"    {band}, {taps}, lane);"]
        else:   # transposed: 16 columns by 8 rows a tile
            NR, NC = -(-cols // 16), -(-rows // 8)
            body = ["const int c0 = tr * 16, r0 = tc * 8;",
                    f"{fn}<{ks}>(so + r0 * {cols} + c0, 1, {cols}, "
                    f"{cols} - c0, {rows} - r0,",
                    f"    sx + (r0 + {roff + d0}) * {stride} + c0 + {coff}, "
                    f"1, {stride}, {cols} - c0, {srows - roff - d0} - r0,",
                    f"    {band}, {taps}, lane);"]
        self.tiles.add(NC)
        L += ["  " + x for x in _tile_loop(NR, NC, body)]
        L.append("}")
        return L


def _onchip_stream_body(program, plan, em, order, slots, kernel: str,
                        params: str) -> List[str]:
    """The block body of an on-chip plan (K3a/K3b, K4): K1's skeleton —
    ring slots from per-step counters, a thread's cell from one division
    before the march, the mask-free or the masked stage body per block
    and step (in local mode mask-free only where the chunk's global
    planes lie inside [0, I)), ring inputs loaded a step ahead with
    cp.async — over the phases of ``plan.schedule``, each closed by a
    barrier, with shared memory as ``pack_layout`` places it."""
    from .panel import i_reach
    I, J, K = program.dimensions
    local = bool(plan.block)
    Ii, h, Ic = plan.extent(), plan.halo_i, plan.block
    tj, tk = plan.tile
    off = plan.spill_layout(ahead=False).offset
    ring_inputs = [f for f in plan.raw_ring if f in program.inputs]
    sources = {t[0] for t in plan.tkeys}
    Hj, Hk = plan.inner_reach()
    sharded = bool(plan.shard[0])
    L = ["// stream streamer (backend/stream.py): replaces the TPU kernel "
         "stencilflow_tpu/backend/stream.py _stream_kernel_body (K3a per-"
         "cell stages, K3b banded transforms)" + (
             "; local chunk kernel K4, as built by compile_local_stream "
             f"(chunk of {Ic} + 2 x {h} planes)" if local else ""),
         "#define SF_NW (SF_NT >= 32 ? SF_NT / 32 : 1)",
         f"SF_DEV void {kernel}_block(const int by, const int bx, "
         "const int tid, const int nt, unsigned char* const sf_smem, "
         f"{params}) {{",
         "  (void)nt;"] + _block_origin(plan) + [
         "  const int warp = tid >> 5, lane = tid & 31;",
         "  (void)warp; (void)lane;",
         "  // every cell and read of the block inside the (j, k) domain",
         f"  const bool inner = j0 >= {Hj} && j0 + {tj + Hj} <= {J} && "
         f"k0 >= {Hk} && k0 + {tk + Hk} <= {K};",
         "  (void)inner;"]
    for f in plan.raw_ring:
        ct = _slot_type(program, plan, f, plan.ring_dtype)
        at = off[f] if f in off else off["ring", f]
        L.append(f"  {ct}* const r_{f} = ({ct}*)(sf_smem + {at});")
    for t in plan.tkeys:
        n = em.tidx[t]
        for kind, name in (("tring", "t"), ("tplane", "tp"),
                           ("scratch", "u")):
            if (kind, t) in off:
                L.append(f"  float* const {name}{n} = (float*)(sf_smem + "
                         f"{off[kind, t]});")
    setup = []
    for e in plan.schedule:
        if e[0] == "pass":
            setup += em.band_setup(e[1], e[2], off)
    counters = sorted(({plan.slots(f) for f in plan.raw_ring}
                       | set(plan.tring.values())) - {1})
    L += [f"  int m{S} = 0;  // t mod {S}" for S in counters]

    def guard(q: str) -> List[str]:
        head = [f"      const int q = {q};"]
        if local:
            head.append("      const int gq = origin_i + q;  (void)gq;")
        return head + [f"      if (q >= 0 && q < {Ii}) {{"]

    step: List[str] = []
    pos = ("gq", "gj", "gk") if local else ("q", "gj", "gk")
    at_pos = ("q",) + em.at("gj", "gk") if local else None
    stage_idx = {s: i for i, s in enumerate(order)}
    for e in plan.schedule[1:]:
        if e[0] == "fused":
            c = next(c for c in order if c in plan.readers(e[1][0]))
            step += [f"    {{  // phase: k-passes of transforms "
                     f"{', '.join(str(em.tidx[t]) for t in e[1])}"] + guard(
                f"t - {plan.lag[c]}")
            step += ["        " + x for x in em.fused_kpass(e[1])]
            step += ["        SF_SYNC();", "      }", "    }"]
            continue
        if e[0] in ("pass", "mirror"):
            t = e[1]
            f = t[0]
            if t in plan.instep:
                c = next(c for c in order if c in plan.readers(t))
                q = f"t - {plan.lag[c]}"
            else:
                q = "t" if f in program.inputs else f"t - {plan.lag[f]}"
            step += [f"    {{  // phase: {' '.join(map(str, e[::2]))} of "
                     f"transform {em.tidx[t]}"] + guard(q)
            step += ["        " + x for x in (
                em.tpass(t, e[2]) if e[0] == "pass" else em.mirror(t))]
            step += ["        SF_SYNC();", "      }", "    }"]
            continue
        s = e[1]
        idx = stage_idx[s]
        kspec = program.kernels[s]
        RJ, RK = plan.region(s)
        hj, hk = plan.halo[s]
        lo, hi = i_reach(program, s)
        em.widths.add(RK)
        ptrs: Dict[Tuple[str, int], str] = {}
        tptrs: Dict[str, str] = {}
        xs = set()
        onchip = _ring_reader(program, plan, s, RK, ptrs, xs,
                              plan.raw_ring, plan.ring_dtype)
        bodies = []
        for masked in (False, True):
            if s in plan.mxu_plans:
                body = em.banded(s, masked, onchip, tptrs, xs)
            else:
                body = _stage_call(program, kspec, idx, pos, onchip, slots,
                                   at_pos, em.adims, masked, em.cd)
            if s in plan.raw_ring:
                rv = _to_slot(program, plan, s, "r", plan.ring_dtype)
                if masked and s in sources:   # the passes read 0 beyond
                    body.append(f"w[p] = (gj >= 0 && gj < {J} && gk >= 0 "
                                f"&& gk < {K}) ? {rv} : "
                                f"{zero(plan.ring_dtype(s))};")
                else:
                    body.append(f"w[p] = {rv};")
            if s in program.outputs:
                cond = [f"q >= {h} && q < {h + Ic}"] if local else []
                if hj:
                    cond.append(f"jl >= {hj} && jl < {hj + tj}")
                if hk:
                    cond.append(f"kl >= {hk} && kl < {hk + tk}")
                qo = f"(q - {h})" if local else "q"
                ro = em.out(f"{_rnd(plan.slot_dtype)}(r)"
                            if s in plan.rounds_out else "r", s)
                if sharded:   # the shard's core, every body
                    BJ, BK = plan.core()
                    cond.append(f"gj - origin_j < {BJ} && gk - origin_k < "
                                f"{BK}")
                    write = (f"o_{s}[((long long){qo} * {BJ} + gj - "
                             f"origin_j) * {BK} + gk - origin_k] = {ro};")
                else:
                    if masked:
                        cond.append(f"gj < {J} && gk < {K}")
                    write = (f"o_{s}[((long long){qo} * {J} + gj) * {K} + "
                             f"gk] = {ro};")
                body.append(f"if ({' && '.join(cond)}) {write}" if cond
                            else write)
            bodies.append(body)
        step += [f"    {{  // phase: stage {s}: {RJ} x {RK}"] + guard(
            f"t - {plan.lag[s]}")
        if s in plan.raw_ring:
            ct = _slot_type(program, plan, s, plan.ring_dtype)
            step.append(f"        {ct}* const w = r_{s} + "
                        f"{_slot(plan, s, plan.lag[s])} * {RJ * RK};")
        step += _ring_bases(program, plan, ptrs, "        ",
                            plan.ring_dtype)
        step += [f"        const float* const {b} = {v};"
                 for b, v in sorted(tptrs.items())]
        gplane = "gq" if local else "q"
        step += _two_bodies(RJ, RK, _cell_pre(hj, hk, xs), bodies,
                            f"inner && {gplane} >= {lo} && "
                            f"{gplane} < {I - hi}", "        ")
        step += ["        SF_SYNC();", "      }", "    }"]
    widths = sorted(em.widths | {_load_width(plan, f) for f in ring_inputs})
    L += _thread_origins(widths)
    L += [f"  const int tr0_{c} = warp / {c}, tc0_{c} = warp - tr0_{c} * "
          f"{c};" for c in sorted(em.tiles)]
    prologue, ingest = _ingest(program, plan, ring_inputs, Ii, plan.dtype)
    L += prologue
    if setup:
        L += ["  // the bands' copies, once a block"] + setup + \
            ["  SF_SYNC();"]
    L.append(f"  for (int t = 0; t < {plan.steps()}; ++t) {{")
    L += ingest + step
    L += [f"    m{S} = sf_wrap(m{S} + 1, {S});" for S in counters]
    L += ["  }", "}"]
    return L


def stream_source(program: ir.Program, analysis: ChainAnalysis,
                  plan) -> str:
    """The stream kernel for ``plan`` (backend/stream.py StreamPlan): an
    on-chip plan takes ``_onchip_stream_body`` (K3a per-cell stages and
    K3b banded transforms on the panel kernel's skeleton, the band passes
    on CUDA cores or, ``_MMA_MACROS``, on tensor cores).  The block body
    is a plain function of the block and thread index, so the same source
    also compiles with g++ into ``sf_host_launch``, which runs every
    block with one thread (the barriers separate phases, so that is a
    valid schedule) — the CPU tests run the generated kernel that way.

    A local plan (``plan.block`` > 0) gives K4, ``sf_local_stream``: the
    same streamer over one i-chunk's ``Ii = Ic + 2h`` planes, with the
    chunk's global origin ``origin_i`` a launch argument (``sf_local_
    launch``, and ``sf_host_launch`` takes it too).  Stage ``s`` at local
    plane q works on global plane ``origin_i + q``: i-offset reads and
    banded groups are masked against the global [0, I), array inputs are
    read from the local (Ii, ...) slabs, and only core planes q in [h, h
    + Ic) are written, to plane q - h of the (Ic, J, K) outputs.  A shard
    plan (``plan.shard``) adds ``origin_j`` and ``origin_k`` (the shard
    core's global origin; ``sf_shard_launch`` and ``sf_host_launch``
    take all three): blocks tile the core from there, inputs and the
    pool's planes are read at the cell's offset (wj, wk) from the
    widened plane's origin, and only the core is written, to (Ic, Bj,
    Bk) outputs.

    A plan of the spill rung (K3c, ``plan.packed``) takes
    ``_packed_stream_body``: shared memory packed by liveness, and
    spilled rings (``plan.spilled``) kept in the block's own region of
    the spill buffer ``sf_spill`` (one more kernel argument, the last
    pointer in ``in``), which only bulk asynchronous copies touch, with
    the macros of ``_SPILL_MACROS`` (memcpy on the host).  The g++ entry
    point mallocs that buffer filled with 0xff bytes (NaN), as it does
    shared memory."""
    I, J, K = dims = program.dimensions
    local = bool(plan.block)
    Ii, h, Ic = plan.extent(), plan.halo_i, plan.block
    kernel = "sf_local_stream" if local else "sf_stream"
    cd = plan.compute
    order, head, slots = _common(program, analysis, skip=set(plan.mxu_plans),
                                 compute=cd)
    tj, tk = plan.tile
    ntj, ntk = plan.grid()
    n_pool = len(plan.kernel_pool())
    spill = bool(plan.spilled)
    origin = 3 if plan.shard[0] else local
    params, args = _params(program, n_pool, origin=origin, spill=spill,
                           compute=cd)
    em = _StreamEmitter(program, plan, slots)
    # a compute type: _common put the stream and narrow macros before
    # the stage functions, which call them
    macros = [] if cd is not None else [_STREAM_MACROS] + _bf16_macros(
        plan, program)
    if plan.packed:
        L = [head] + macros[:1] + [_SPILL_MACROS] + macros[1:] + \
            _packed_stream_body(
            program, plan, em, order, slots, kernel, params)
        L += _entry_points(program, kernel, params, args, (ntj, ntk),
                           plan.smem_bytes(), slots, n_pool, origin=origin,
                           spill_bytes=plan.spill_bytes() if spill else 0,
                           compute=cd)
        return "\n".join(L)
    body = _onchip_stream_body(program, plan, em, order, slots, kernel,
                               params)
    mma = []
    if "mma" in em.routes:
        mma = [_MMA_BF16_MACROS if em.bf else _MMA_MACROS]
    L = [head] + macros + _skeleton_macros(plan.threads) + \
        _group_macros(plan) + mma + body
    L += _entry_points(program, kernel, params, args, (ntj, ntk),
                       plan.smem_bytes(), slots, n_pool, origin=origin,
                       min_blocks=plan.min_blocks(), threads=plan.threads,
                       compute=cd)
    L += _occupancy(plan.smem_bytes(), plan.threads, kernel)
    return "\n".join(L)


def _block_origin(plan) -> List[str]:
    """The block's core tile origin (j0, k0), global; a shard's tiles
    start at its core's origin (``origin_j``, ``origin_k``), whose
    widened plane's cell (0, 0) is global (wj, wk)."""
    tj, tk = plan.tile
    if not plan.shard[0]:
        return [f"  const int j0 = by * {tj}, k0 = bx * {tk};"]
    xj, xk = plan.xhalo
    return [f"  const int j0 = origin_j + by * {tj}, k0 = origin_k + bx * "
            f"{tk};",
            f"  const int wj = origin_j - {xj}, wk = origin_k - {xk};",
            "  (void)wj; (void)wk;"]


def _packed_stream_body(program, plan, em, order, slots, kernel: str,
                        params: str) -> List[str]:
    """The block body of a spill-rung plan (K3c; ``plan.packed``): shared
    memory as ``plan.spill_layout()`` places it, and per plane step t the
    phases of the layout, each closed by a barrier — phase 0 ingests the
    ring inputs, phase 1 + n runs the n-th stage.  Thread 0 opens each
    phase: it issues the bulk stores of the staging planes the phase
    before wrote (into slot q % depth of the ring's part of the block's
    region of ``sf_spill``), at the top of the step waits until every
    store of the earlier steps has landed, and issues the phase's bulk
    loads, each arriving on its own mbarrier; then every thread waits on
    the mbarrier of each load first read in the phase (parity t & 1:
    each completes once a step).  Before the barrier that closes a
    phase, every thread fences
    its shared-memory writes against the async proxy and thread 0 waits
    until its stores have read their staging planes.  A spilled ring's
    readers read its staging plane or a load buffer, never device
    memory."""
    I, J, K = program.dimensions
    local = bool(plan.block)
    Ii, h, Ic = plan.extent(), plan.halo_i, plan.block
    tj, tk = plan.tile
    ntj, ntk = plan.grid()
    lay = plan.spill_layout()
    soffs = plan.spill_offsets()
    n = plan.phases()
    bar = {key: i for i, key in enumerate(lay.loads)}
    L = ["// stream streamer (backend/stream.py): replaces the TPU kernel "
         "stencilflow_tpu/backend/stream.py _stream_kernel_body (K3a per-"
         "cell stages)" + (
             "; local chunk kernel K4, as built by compile_local_stream "
             f"(chunk of {Ic} + 2 x {h} planes)" if local else "")
         + "; the spill rung (K3c: choose_spill, spill_prefetch, spill_read, "
         "spill_write): shared memory packed by liveness"
         + (f", rings staged and spilled to device memory: "
            f"{', '.join(plan.spilled)}" if plan.spilled else ""),
         f"SF_DEV void {kernel}_block(const int by, const int bx, "
         "const int tid, const int nt, unsigned char* const sf_smem, "
         f"{params}) {{"] + _block_origin(plan)
    sharded = bool(plan.shard[0])
    PJ, PK = plan.plane()
    BJ, BK = plan.core()
    if lay.loads:
        L.append("  unsigned long long* const sf_bar = "
                 "(unsigned long long*)sf_smem;")
    if plan.spilled:
        L.append(f"  unsigned char* const sf_region = sf_spill + (long long)"
                 f"(by * {ntk} + bx) * {soffs['end']}LL;")
    for f in plan.raw_ring:
        ct = _slot_type(program, plan, f, plan.ring_dtype)
        if f in plan.spilled:
            L.append(f"  {ct}* const st_{f} = ({ct}*)(sf_smem + "
                     f"{lay.offset['stage', f]});")
        else:
            off = lay.offset[f] if f in lay.offset else lay.offset["ring", f]
            L.append(f"  {ct}* const r_{f} = ({ct}*)(sf_smem + {off});")
    for key, i in bar.items():
        ct = _slot_type(program, plan, key[0], plan.ring_dtype)
        L.append(f"  {ct}* const ld{i} = ({ct}*)(sf_smem + "
                 f"{lay.offset[('read',) + key]});")
    if lay.loads:
        L += ["  if (tid == 0) {",
              f"    for (int b = 0; b < {len(lay.loads)}; ++b) "
              "SF_MBAR_INIT(sf_bar + b);", "    SF_MBAR_FENCE_INIT();", "  }",
              "  SF_SYNC();"]
    L.append(f"  for (int t = 0; t < {plan.steps()}; ++t) {{")
    L.append("    const unsigned par = t & 1;  (void)par;")

    def q_of(f: str, step: str) -> Tuple[str, str]:
        """(plane, guard) of ``f``'s producer at step ``step``."""
        if f in program.inputs:
            return step, f"{step} < {Ii}"
        q = f"({step} - {plan.lag[f]})"
        return q, f"{q} >= 0 && {q} < {Ii}"

    def store(f: str, step: str) -> List[str]:
        q, guard = q_of(f, step)
        pb = plan.plane_bytes(f)
        return [f"      if ({guard}) sf_bulk_store(sf_region + {soffs[f]} + "
                f"({q} % {plan.raw_ring[f]}) * {pb}, st_{f}, {pb}u);"]

    def prologue(ph: int) -> List[str]:
        """Thread 0's stores and loads at the start of phase ``ph``."""
        body: List[str] = []
        prev = [f for f in plan.spilled if plan.phase(f) == (ph - 1) % n]
        for f in prev:
            body += store(f, "t" if ph else "(t - 1)")
        if prev:
            if not ph:
                body = ["      if (t > 0) {"] + ["  " + b for b in body] \
                    + ["      }"]
            body.append("      SF_BULK_COMMIT();")
        if not ph and lay.loads:
            body.append("      SF_BULK_WAIT();  // stores landed")
        for key in [k for k in lay.loads if lay.issue[k] == ph]:
            f, d = key
            D, pb = plan.raw_ring[f], plan.plane_bytes(f)
            body.append(f"      sf_bulk_load(ld{bar[key]}, sf_region + "
                        f"{soffs[f]} + (((t - {d}) % {D} + {D}) % {D}) * "
                        f"{pb}, {pb}u, sf_bar + {bar[key]});")
        out = ["    if (tid == 0) {"] + body + ["    }"] if body else []
        out += [f"    sf_mbar_wait(sf_bar + {bar[key]}, par);"
                for key in lay.loads if lay.readers[key][0] == ph]
        return out

    close = ["    SF_FENCE_ASYNC();", "    if (tid == 0) SF_BULK_WAIT_READ();",
             "    SF_SYNC();"]
    # phase 0: ingest the ring inputs
    L.append("    // phase 0")
    L += prologue(0)
    ring_inputs = [f for f in plan.raw_ring if f in program.inputs]
    if ring_inputs:
        L.append(f"    if (t < {Ii}) {{")
        for f in ring_inputs:
            RJ, RK = plan.region(f)
            hj, hk = plan.halo[f]
            dst = (f"st_{f}[p]" if f in plan.spilled else
                   f"r_{f}[(t % {plan.raw_ring[f]}) * {RJ * RK} + p]")
            inb = f"gj >= 0 && gj < {J} && gk >= 0 && gk < {K}"
            src = f"g_{f}[((long long)t * {J} + gj) * {K} + gk]"
            if sharded:
                inb += f" && gj - wj < {PJ} && gk - wk < {PK}"
                src = (f"g_{f}[((long long)t * {PJ} + gj - wj) * {PK} + "
                       "gk - wk]")
            src = em.gread(src, f)
            L += [f"      for (int p = tid; p < {RJ * RK}; p += nt) {{",
                  f"        const int jl = p / {RK}, kl = p - jl * {RK};",
                  f"        const int gj = j0 - {hj} + jl, "
                  f"gk = k0 - {hk} + kl;",
                  f"        {dst} = " + _to_slot(
                      program, plan, f, f"({inb}) ? {src} : "
                      f"{literal(0, plan.dtype(f))}", plan.ring_dtype) + ";",
                  "      }"]
        L.append("    }")
    L += close
    pos = ("gq", "gj", "gk") if local else ("q", "gj", "gk")
    at_pos = ("q",) + em.at("gj", "gk") if local else None
    for idx, s in enumerate(order):
        kspec = program.kernels[s]
        RJ, RK = plan.region(s)
        hj, hk = plan.halo[s]
        ph = plan.phase(s)

        def onchip(f, s=s):
            if f not in plan.raw_ring:
                return lambda o: None
            fj, fk = plan.region(f)
            dj = plan.halo[f][0] - plan.halo[s][0]
            dk = plan.halo[f][1] - plan.halo[s][1]
            if f not in plan.spilled:
                D = plan.raw_ring[f]
                return lambda o: _from_slot(
                    program, plan, f, f"r_{f}[((q + {o[0]} + {D}) % {D}) * "
                    f"{fj * fk} + (jl + {dj + o[1]}) * {fk} + "
                    f"kl + {dk + o[2]}]", plan.ring_dtype)

            def at(o):
                d = plan.lag[s] - o[0]
                buf = f"st_{f}" if d == plan.lag[f] else f"ld{bar[f, d]}"
                return _from_slot(program, plan, f, f"{buf}[(jl + "
                                  f"{dj + o[1]}) * {fk} + kl + {dk + o[2]}]",
                                  plan.ring_dtype)
            return at

        body = _stage_call(program, kspec, idx, pos, onchip, slots, at_pos,
                           em.adims, compute=em.cd)
        if s in plan.spilled:
            body.append(f"st_{s}[p] = "
                        f"{_to_slot(program, plan, s, 'r', plan.ring_dtype)};")
        elif s in plan.raw_ring:
            body.append(f"r_{s}[(q % {plan.raw_ring[s]}) * {RJ * RK} + p] "
                        f"= {_to_slot(program, plan, s, 'r', plan.ring_dtype)};")
        if s in program.outputs:
            core = f"q >= {h} && q < {h + Ic} && " if local else ""
            qo = f"(q - {h})" if local else "q"
            ro = em.out(f"{_rnd(plan.slot_dtype)}(r)"
                        if s in plan.rounds_out else "r", s)
            if sharded:
                body.append(f"if ({core}jl >= {hj} && jl < {hj + tj} && "
                            f"kl >= {hk} && kl < {hk + tk} && gj - origin_j"
                            f" < {BJ} && gk - origin_k < {BK}) o_{s}[("
                            f"(long long){qo} * {BJ} + gj - origin_j) * "
                            f"{BK} + gk - origin_k] = {ro};")
            else:
                body.append(f"if ({core}jl >= {hj} && jl < {hj + tj} && "
                            f"kl >= {hk} && kl < {hk + tk} && gj < {J} && "
                            f"gk < {K}) o_{s}[((long long)"
                            f"{qo} * {J} + gj) * "
                            f"{K} + gk] = {ro};")
        L.append(f"    // phase {ph}: stage {s}")
        L += prologue(ph)
        L += ["    {", f"      const int q = t - {plan.lag[s]};"]
        if local:
            L.append("      const int gq = origin_i + q;  (void)gq;")
        L += [f"      if (q >= 0 && q < {Ii}) {{",
              f"        for (int p = tid; p < {RJ * RK}; p += nt) {{",
              f"          const int jl = p / {RK}, kl = p - jl * {RK};",
              f"          const int gj = j0 - {hj} + jl, "
              f"gk = k0 - {hk} + kl;"]
        L += ["          " + b for b in body]
        L += ["        }", "      }", "    }"]
        L += close
    L += ["  }", "  if (tid == 0) SF_BULK_WAIT();", "}"]
    return L


def _entry_points(program, kernel: str, params: str, args: str, grid,
                  smem: int, slots, n_pool: int = 0,
                  origin: bool = False, spill_bytes: int = 0,
                  min_blocks: int = 0, threads: int = THREADS,
                  segments: int = 0, compute=None) -> List[str]:
    """The ``__global__`` kernel around the block body ``<kernel>_block``
    and its ``sf_launch`` (``sf_local_launch`` with ``origin``) for nvcc;
    for g++, ``sf_host_launch``, which runs every block with one thread
    (the barriers separate phases, so that is a valid schedule) over
    shared memory filled with NaN, and a spill buffer of ``spill_bytes``
    (when nonzero) filled the same way.  Blocks have ``threads`` threads;
    ``min_blocks`` > 1 asks nvcc for that many resident blocks per SM
    (``__launch_bounds__``: a register budget).  ``segments`` > 0 adds a
    grid dimension z of that many blocks, passed first to the block body
    (the group kernel's i-segments, the overlap kernel's blocks along i);
    the host then fills shared memory with NaN before every block, so a
    block reads nothing another left.  ``compute``: array inputs and
    outputs of that narrow type (a narrow compute)."""
    ntj, ntk = grid
    bounds = f"{threads}, {min_blocks}" if min_blocks > 1 else f"{threads}"
    copies = "".join(f"  memcpy(&sc.x{i}, scal + {8 * i}, sizeof(sc.x{i}));\n"
                     for i in slots.values())
    spill = [f"  unsigned char* const sf_spill = (unsigned char*)malloc("
             f"{spill_bytes}LL);",
             f"  memset(sf_spill, 0xff, {spill_bytes}LL);"] \
        if spill_bytes else []
    z, dim_z, host_z = ("", "", []) if not segments else (
        "blockIdx.z, ", f", {segments}",
        [f"  for (int bz = 0; bz < {segments}; ++bz)"])
    host_call = f"{kernel}_block({'bz, ' if segments else ''}by, bx, 0, 1, " \
        f"sf_smem, {args});"
    if segments:
        host_call = f"{{ memset(sf_smem, 0xff, {smem}); {host_call} }}"
    return ["#ifdef __CUDACC__",
            f"__global__ void __launch_bounds__({bounds}) "
            f"{kernel}({params}) {{",
            "  extern __shared__ __align__(16) unsigned char sf_smem[];",
            f"  {kernel}_block({z}blockIdx.y, blockIdx.x, threadIdx.x, "
            f"{threads}, sf_smem, {_param_names(params)});",
            "}",
            _launcher(program, kernel, f"dim3({ntk}, {ntj}{dim_z})", smem,
                      slots, n_pool, origin, bool(spill_bytes), threads,
                      compute),
            "#else",
            'extern "C" void sf_host_launch(const void* const* in, '
            "void* const* out, const unsigned char* scal"
            + (", const int origin_i" if origin else "")
            + (", const int origin_j, const int origin_k" if origin == 3
               else "") + ") {",
            "  SfScalars sc;", "  sc.unused_ = 0;",
            copies.rstrip("\n"),
            "  // uninitialised shared memory reads as NaN here",
            f"  unsigned char* const sf_smem = (unsigned char*)malloc("
            f"{max(smem, 1)});",
            f"  memset(sf_smem, 0xff, {smem});"] + spill + host_z + [
            f"  for (int by = 0; by < {ntj}; ++by)",
            f"    for (int bx = 0; bx < {ntk}; ++bx)",
            f"      {host_call}",
            "  free(sf_smem);"] + (["  free(sf_spill);"] if spill else []) + [
            "}", "#endif"]


def group_source(program: ir.Program, analysis: ChainAnalysis,
                 plan) -> str:
    """The group streamer for ``plan`` (backend/group.py GroupPlan), K5,
    on K1's skeleton.

    One block per (segment, j tile, k tile) marches panels of B planes.
    At step t every group whose panel q = t - lag(g) the block needs
    evaluates its live stages, each over its i-widened block, a barrier
    after each.  Panel t + 1 of every streamed input is issued by
    ``cp.async`` (zero-filled beyond the domain) right after the last
    stage that reads the panel it replaces (``plan.issue``), or, where
    that is the step's last stage, at the step's top into an extra panel
    slot; every thread waits for its copies before the step's last
    barrier, which so also lands panel t + 1 (8 barriers a step for 8
    stages).  A ring keeps its panels in slots that rotate by per-step
    counters (t mod slots), at a shift chosen so its readers' windows
    wrap the least, with the planes a window can wrap into mirrored past
    its end: each group sets one base per ring it reads once a step, and
    a ring read is one shared-memory load at a constant offset from it
    and the thread's cell.  A
    thread's first cell of each row shape comes from one division before
    the march, later ones from constant steps.  Each stage has a
    mask-free body, taken where the block's widest (j, k) reach and the
    stage's rows and i reads lie inside the domain, and a masked one
    (boundary conditions from global coordinates).  A segment's block
    starts early enough to fill its rings (``GroupPlan.warmup``),
    evaluates each group only on the panels its own panels need, and
    writes only its own panels.  Like ``panel_source``, the block body
    also compiles with g++ into ``sf_host_launch``."""
    I, J, K = dims = program.dimensions
    order, head, slots = _common(program, analysis)
    stage_fn = {k: i for i, k in enumerate(order)}
    B = plan.B
    n_panels = I // B
    tj, tk = plan.tile
    ring_off, temp_off, smem = plan.smem_layout(program)
    params, args = _params(program)
    Hj, Hk = plan.reach(program)
    warm = plan.warmup(program)
    S, Ps = plan.segments, plan.panels_per_segment(program)
    lag_max = plan.lag_max(program)
    ring_inputs = [f for f in plan.rings if f in program.inputs]
    L = [head, _STREAM_MACROS] + _bf16_macros(plan, program) + \
        _skeleton_macros(plan.threads) + [
         _CP_WAIT_ALL,
         "// group streamer (backend/group.py): replaces the TPU kernel "
         "stencilflow_tpu/backend/group.py _group_kernel_body (K5)",
         "SF_DEV void sf_group_block(const int bz, const int by, "
         "const int bx, const int tid, const int nt, "
         f"unsigned char* const sf_smem, {params}) {{",
         "  (void)nt;",
         f"  const int j0 = by * {tj}, k0 = bx * {tk};",
         "  // every cell and read of the block inside the (j, k) domain",
         f"  const bool inner = j0 >= {Hj} && j0 + {tj + Hj} <= {J} && "
         f"k0 >= {Hk} && k0 + {tk + Hk} <= {K};",
         "  (void)inner;",
         "  // the segment's panels [P0, P1), its first step T0 (the "
         "warm-up that fills its rings) and the last panel it loads",
         f"  const int P0 = bz * {Ps}, P1 = P0 + {Ps} < {n_panels} ? "
         f"P0 + {Ps} : {n_panels};",
         f"  const int T0 = P0 > {warm['steps']} ? P0 - {warm['steps']} : 0;",
         f"  const int Pin = P1 + {warm['in_hi']} < {n_panels} ? "
         f"P1 + {warm['in_hi']} : {n_panels};",
         "  (void)P1; (void)Pin;"]
    for f in plan.rings:
        ct = _slot_type(program, plan, f)
        L.append(f"  {ct}* const r_{f} = ({ct}*)(sf_smem + {ring_off[f]});")
    counters = sorted({plan.slots(f) for f in plan.rings} - {1})
    L += [f"  int m{D} = T0 % {D};  // t mod {D}" for D in counters]
    for g in range(len(plan.groups)):
        if plan.live(g):
            lo_w, hi_w = warm["group"][g]
            L.append(f"  const int qlo{g} = P0 > {lo_w} ? P0 - {lo_w} : 0, "
                     f"qhi{g} = P1 + {hi_w} < {n_panels} ? P1 + {hi_w} : "
                     f"{n_panels};")
    shapes = {plan.region(f) for f in plan.rings}
    shapes |= {plan.region(s) for g in range(len(plan.groups))
               for s in plan.live(g)}
    L += _thread_origins3(shapes)

    def loads(fields, t_expr: str, slot) -> List[str]:
        out = []
        for f in fields:
            RJ, RK = plan.region(f)
            hj, hk = plan.halo[f]
            n, M = plan.slots(f) * B, plan.mirror[f]
            mask = program.inputs[f].dim_mask
            inb = " && ".join(
                [f"gj >= 0 && gj < {J}"] * bool(mask[1])
                + [f"gk >= 0 && gk < {K}"] * bool(mask[2])) or "true"
            src = (f"g_{f} + (inb ? "
                   f"{_flat_at(mask, ('gi', 'gj', 'gk'), dims)} : 0LL)")
            ct = stype(program.field_dtype(f))
            body = [f"const int gi = ({t_expr}) * {B} + il, "
                    f"gj = j0 - {hj} + jl, gk = k0 - {hk} + kl;",
                    f"const bool inb = {inb};",
                    f"const int pr = sf_wrap(u + il, {n});",
                    f"{ct}* const d = r_{f} + p + (pr - il) * {RJ * RK};",
                    _async_copy(program, f, "d", src)]
            if M:
                body.append(f"if (pr < {M}) "
                            + _async_copy(program, f, f"d + {n * RJ * RK}",
                                          src))
            out += ["{", f"  const int u = {slot(f)} * {B} + "
                         f"{plan.shift[f]};"]
            out += ["  " + y for y in _region_loop3(B, RJ, RK, body)]
            out.append("}")
        return out

    top = [f for f in ring_inputs if plan.issue[f] in (None, -1)]
    if ring_inputs:
        L += ["  // prologue: panel T0 in flight", "  if (T0 < Pin) {"]
        L += ["    " + y for y in loads(
            ring_inputs, "T0", lambda f: _slot_of(plan.slots(f), 0))]
        L += ["  }", "  SF_CP_COMMIT();", "  SF_CP_WAIT_ALL();",
              "  SF_SYNC();"]
    L.append("  for (int t = T0; t < P1 + " f"{lag_max}; ++t) {{")
    if top:
        L += ["    // panel t + 1 in flight (its slot's last reader ran in "
              "step t - 1)", "    if (t + 1 < Pin) {"]
        L += ["      " + y for y in loads(
            top, "t + 1", lambda f: _slot_of(plan.slots(f), -1))]
        L += ["    }", "    SF_CP_COMMIT();"]
    phase, last = 0, len(plan.phases()) - 1
    for g, grp in enumerate(plan.groups):
        live = plan.live(g)
        if not live:
            continue
        nd, gset = plan.needs[g], set(grp)
        L += [f"    // group {g}: {' '.join(live)}",
              f"    const int q{g} = t - {plan.lag[g]};",
              f"    const bool run{g} = q{g} >= qlo{g} && q{g} < qhi{g};"]
        if any(s in program.outputs for s in live) and S > 1:
            L.append(f"    const bool own{g} = q{g} >= P0 && q{g} < P1;")
        for s, off in temp_off[g].items():
            ct = stype(program.field_dtype(s))
            L.append(f"    {ct}* const b_{s} = ({ct}*)(sf_smem + {off});")
        for f in nd:
            if f in gset or f not in plan.rings:
                continue
            ct = _slot_type(program, plan, f)
            D = plan.slots(f)
            e = (plan.shift[f] - nd[f][0]) % (D * B)
            L.append(f"    const {ct}* const rb{g}_{f} = r_{f} + "
                     f"sf_wrap({_slot_of(D, plan.lag[g])} * {B} + {e}, "
                     f"{D * B}) * {math.prod(plan.region(f))};")
        for s in live:
            R = plan.rows(g, s)
            RJ, RK = plan.region(s)
            hj, hk = plan.halo[s]
            lo_s = nd[s][0]
            xs = set()

            def onchip(f, s=s, lo_s=lo_s, xs=xs):
                if f not in gset and f not in plan.rings:
                    return lambda o: None   # read from device memory
                name = f"b_{f}" if f in gset else f"rb{g}_{f}"
                at = _block_reader(
                    name, plan.region(f), plan.region(s), nd[f][0] - lo_s,
                    plan.halo[f][0] - plan.halo[s][0],
                    plan.halo[f][1] - plan.halo[s][1], xs)
                if f in gset:   # in-group blocks hold exact values
                    return at
                if plan.rounded(f) and f in program.inputs:
                    return lambda o: f"sf_bfr({at(o)})"   # f32 slots,
                return lambda o: _from_slot(program, plan, f, at(o))

            bodies = []
            for masked in (False, True):
                body = _stage_call(program, program.kernels[s], stage_fn[s],
                                   ("gi", "gj", "gk"), onchip, slots,
                                   masked=masked)
                core = f"il >= {lo_s} && il < {lo_s + B}"
                if s in temp_off[g]:
                    body.append(f"b_{s}[p] = "
                                f"{store(program.field_dtype(s), 'r')};")
                if s in plan.rings:
                    n, M = plan.slots(s) * B, plan.mirror[s]
                    rv = _to_slot(program, plan, s, "r")
                    body += [f"if ({core}) {{",
                             f"  const int pr = sf_wrap(ub + il, {n});",
                             f"  w[p + (pr - il) * {RJ * RK}] = {rv};"]
                    if M:
                        body.append(f"  if (pr < {M}) w[p + (pr - il + {n})"
                                    f" * {RJ * RK}] = {rv};")
                    body.append("}")
                if s in program.outputs:
                    cond = [core]
                    if hj or RJ != tj:
                        cond.append(f"jl >= {hj} && jl < {hj + tj}")
                    if hk or RK != tk:
                        cond.append(f"kl >= {hk} && kl < {hk + tk}")
                    if masked:
                        cond.append(f"gj < {J} && gk < {K}")
                    if S > 1:
                        cond.append(f"own{g}")
                    body.append(f"if ({' && '.join(cond)}) o_{s}[((long long)"
                                f"gi * {J} + gj) * {K} + gk] = "
                                f"{store(program.field_dtype(s), 'r')};")
                bodies.append(body)
            pre = _cell_pre3(f"q{g} * {B} - {lo_s}", hj, hk, xs)
            qlo, qhi = plan.free_panels(program, g, s)
            L += [f"    if (run{g}) {{  // stage {s}: {R} x {RJ} x {RK}"]
            if s in plan.rings:
                ct = _slot_type(program, plan, s)
                L += [f"      {ct}* const w = r_{s};",
                      f"      const int ub = "
                      f"{_slot_of(plan.slots(s), plan.lag[g])} * {B} + "
                      f"{plan.shift[s] - lo_s};"]
            L += _two_bodies3(R, RJ, RK, (pre, pre), bodies,
                              f"inner && q{g} >= {qlo} && q{g} < {qhi}"
                              if qlo < qhi else None, "      ")
            if phase < last or not ring_inputs:
                L += ["      SF_SYNC();", "    }"]
            else:   # the step's last barrier also lands panel t + 1
                L += ["    }", "    SF_CP_WAIT_ALL();", "    SF_SYNC();"]
            late = [f for f in ring_inputs if plan.issue[f] == phase]
            if late:
                L += ["    // the last reader is done: panel t + 1 into "
                      "the slot it freed", "    if (t + 1 < Pin) {"]
                L += ["      " + y for y in loads(
                    late, "t + 1", lambda f: _slot_of(plan.slots(f), -1))]
                L += ["    }", "    SF_CP_COMMIT();"]
            phase += 1
    L += [f"    m{D} = sf_wrap(m{D} + 1, {D});" for D in counters]
    L += ["  }", "}"]
    L += _entry_points(program, "sf_group", params, args,
                       plan.grid(dims), smem, slots,
                       min_blocks=plan.min_blocks(program),
                       threads=plan.threads, segments=S)
    L += _occupancy(smem, plan.threads, "sf_group")
    return "\n".join(L)


def tile_source(program: ir.Program, analysis: ChainAnalysis,
                plan) -> str:
    """The overlapped-tile kernel for ``plan`` (backend/tile.py TilePlan),
    K6: one block per 3-D core tile (ti, tj, tk).  The full-rank inputs'
    tiles widened by the chain halo are loaded into shared memory by
    ``cp.async`` (zero-filled beyond the domain), then every stage is
    evaluated over its tile widened by its stage halo, in chain order,
    into a shared-memory buffer placed by liveness, and the core cells
    inside the domain are written out.  Region loops take a thread's first
    (il, jl, kl) from one division and advance by constant steps; a read
    is one load at a constant offset from the thread's cell.  ``plan.mode``
    "masked" applies boundary conditions at every read from global
    coordinates in every block; "fast" takes a mask-free body in blocks
    whose widened tile lies inside the domain and the masked body in the
    others, which so compute the border shell exactly: one launch, no
    fix-up.  Like ``panel_source``, the block body also compiles with g++
    into ``sf_host_launch``."""
    I, J, K = dims = program.dimensions
    order, head, slots = _common(program, analysis)
    ti, tj, tk = plan.tile
    nti, ntj, ntk = plan.grid(dims)
    offs = plan.smem_offsets()
    masked = plan.mode == "masked"
    params, args = _params(program)
    H = plan.halo
    L = [head, _STREAM_MACROS] + _skeleton_macros(THREADS) + [
         _CP_WAIT_ALL,
         "// overlapped-tile kernel (backend/tile.py): replaces the TPU "
         "kernel stencilflow_tpu/backend/pallas.py "
         + ("_kernel_body (K6, masked)" if masked else
            "_fast_kernel_body and _shell_fixup (K6, mask-free interior "
            "blocks, masked border blocks)"),
         "SF_DEV void sf_tile_block(const int by, const int bx, "
         "const int tid, const int nt, unsigned char* const sf_smem, "
         f"{params}) {{",
         "  (void)nt;",
         f"  const int bi = by / {ntj}, bj = by - bi * {ntj};",
         f"  const int i0 = bi * {ti}, j0 = bj * {tj}, k0 = bx * {tk};"]
    if not masked:
        L += ["  // the widened tile inside the domain: no read to mask",
              f"  const bool inner = i0 >= {H[0]} && i0 + {ti + H[0]} <= {I} "
              f"&& j0 >= {H[1]} && j0 + {tj + H[1]} <= {J} && k0 >= {H[2]} "
              f"&& k0 + {tk + H[2]} <= {K};"]
    for f in plan.onchip:
        ct = stype(program.field_dtype(f))
        L.append(f"  {ct}* const b_{f} = ({ct}*)(sf_smem + {offs[f]});")
    fields = list(plan.onchip) + list(order)
    L += _thread_origins3({plan.region(f)[1:] for f in fields})
    for f in plan.onchip:
        if f not in program.inputs:
            continue
        EI, EJ, EK = plan.region(f)
        mi, mj, mk = plan.margin[f]
        L += ["  " + y for y in _region_loop3(EI, EJ, EK, [
            f"const int gi = i0 - {mi} + il, gj = j0 - {mj} + jl, "
            f"gk = k0 - {mk} + kl;",
            f"const bool inb = gi >= 0 && gi < {I} && gj >= 0 && gj < {J} "
            f"&& gk >= 0 && gk < {K};",
            _async_copy(program, f, f"b_{f} + p", f"g_{f} + (inb ? "
                        f"{_flat_at((1, 1, 1), ('gi', 'gj', 'gk'), dims)} "
                        ": 0LL)")])]
    L += ["  SF_CP_COMMIT();", "  SF_CP_WAIT_ALL();", "  SF_SYNC();"]
    for idx, s in enumerate(order):
        EI, EJ, EK = plan.region(s)
        mi, mj, mk = plan.margin[s]
        xs = set()

        def onchip(f, s=s, xs=xs):
            if f not in plan.onchip:
                return lambda o: None
            d = [plan.margin[f][x] - plan.margin[s][x] for x in range(3)]
            return _block_reader(f"b_{f}", plan.region(f)[1:],
                                 plan.region(s)[1:], d[0], d[1], d[2], xs)

        bodies = []
        for m in (False, True):
            body = _stage_call(program, program.kernels[s], idx,
                               ("gi", "gj", "gk"), onchip, slots, masked=m)
            rv = store(program.field_dtype(s), "r")
            if s in plan.onchip:
                body.append(f"b_{s}[p] = {rv};")
            if s in program.outputs:
                cond = (f"il >= {mi} && il < {mi + ti} && jl >= {mj} && "
                        f"jl < {mj + tj} && kl >= {mk} && kl < {mk + tk}")
                if m:
                    cond += f" && gi < {I} && gj < {J} && gk < {K}"
                body.append(f"if ({cond}) "
                            f"o_{s}[((long long)gi * {J} + gj) * {K} + gk] "
                            f"= {rv};")
            bodies.append(body)
        pre = _cell_pre3(f"i0 - {mi}", mj, mk, xs)
        L.append(f"  // stage {s}: {EI} x {EJ} x {EK}")
        L += _two_bodies3(EI, EJ, EK, (pre, pre), bodies,
                          None if masked else "inner", "  ")
        if idx < len(order) - 1:
            L.append("  SF_SYNC();")
    L.append("}")
    L += _entry_points(program, "sf_tile", params, args, (nti * ntj, ntk),
                       plan.smem_bytes(), slots)
    L += _occupancy(plan.smem_bytes(), THREADS, "sf_tile")
    return "\n".join(L)


# 16-byte copies of the overlap streamer's input rows (K2), zero-filled
# where the source lies outside the domain; on the host a copy happens at
# the point of issue
_CP16_MACROS = """#ifdef __CUDACC__
SF_DEV void sf_cp16(void* dst, const void* src, const bool inb) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(inb ? 16 : 0) : "memory");
}
#else
SF_DEV void sf_cp16(void* dst, const void* src, const bool inb) {
  if (inb) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
#endif
"""


def _mangle(v: int) -> str:
    return f"m{-v}" if v < 0 else str(v)


def _walk_stage(program, kspec, idx: int, s: str, plan, slots,
                masked: bool, bases: Dict[str, str]) -> List[str]:
    """One stage of the overlap streamer over its region: each thread
    takes walk positions (a run of R adjacent j cells from (jl, kl)), the
    first from one division before the walk and the later ones by
    constant steps, and walks the region's planes il.  At a plane it loads
    the reads of its R cells (with ``plan.window``, only the newest plane
    of each (field, j, k) register window, the older planes kept from the
    planes before), evaluates the R cells, then stores them.  Every
    shared-memory read is one load at a constant offset from a
    per-position pointer advanced by a plane a step."""
    from .overlap import walk_keys
    I, J, K = program.dimensions
    B, tj, tk = plan.tile
    R = plan.R
    RI, RJ, RK = plan.region(s)
    (lo, _), (lj, _), (lk, _) = plan.needs[s]
    NPJ, NPK = plan.positions(s)
    cell = [(r, 0) for r in range(R)]
    keys = walk_keys(program, s, plan.onchip, R)
    fields = sorted({f for f, _dj, _dk in keys})
    ct = {f: stype(program.field_dtype(f)) for f in fields}

    def q(f, x):
        """Element ``x`` of ``f``'s buffer from the position's pointer, as
        its value (the stored cell)."""
        return f"q_{f}[{x}]"

    def off(f, di, dj, dk):
        (lf, _), (ljf, _), _ = plan.needs[f]
        return ((lf - lo + di) * plan.plane(f) + (ljf - lj + dj) * plan.row(f)
                + plan.korigin(f) - lk + dk)

    def reg(f, dj, dk, x):
        return f"w_{f}_{_mangle(dj)}_{_mangle(dk)}_{x}"

    def val(f, di, dj, dk):
        return f"v_{f}_{_mangle(di)}_{_mangle(dj)}_{_mangle(dk)}"

    pre, loads, shift = [], [], []
    if plan.window:
        for (f, dj, dk), (a, b) in sorted(keys.items()):
            for x in range(b - a):
                pre.append(f"{ct[f]} {reg(f, dj, dk, x)} = "
                           f"{q(f, off(f, a + x, dj, dk))};")
            if b > a:
                pre.append(f"{ct[f]} {reg(f, dj, dk, b - a)};")
                loads.append(f"{reg(f, dj, dk, b - a)} = "
                             f"{q(f, off(f, b, dj, dk))};")
                shift += [f"{reg(f, dj, dk, x)} = {reg(f, dj, dk, x + 1)};"
                          for x in range(b - a)]
            else:
                loads.append(f"const {ct[f]} {reg(f, dj, dk, 0)} = "
                             f"{q(f, off(f, a, dj, dk))};")
    else:
        seen = set()
        for f, alist in accesses_with_center(kspec).items():
            if f not in plan.onchip:
                continue
            for a in alist:
                oi, oj, ok = (x or 0 for x in a)
                for rj, rk in cell:
                    k = (f, oi, oj + rj, ok + rk)
                    if k not in seen:
                        seen.add(k)
                        loads.append(f"const {ct[f]} {val(*k)} = "
                                     f"{q(f, off(*k))};")

    def onchip_of(rj, rk):
        def onchip(f):
            if f not in plan.onchip:
                return lambda o: None
            if plan.window:
                return lambda o: reg(f, o[1] + rj, o[2] + rk,
                                     o[0] - keys[f, o[1] + rj, o[2] + rk][0])
            return lambda o: val(f, o[0], o[1] + rj, o[2] + rk)
        return onchip

    em = StageEmitter(program, kspec)
    kt = stype(kspec.dtype)
    cells = []
    def at(g, x):
        return g if not x else f"({g} + {x})"

    for r, (rj, rk) in enumerate(cell):
        pos = ("gi", at("gj", rj), at("gk", rk))
        args = ", ".join(read_expr(program, kspec, f, offs, pos,
                                   onchip_of(rj, rk)(f), slots,
                                   masked=masked)
                         for f, offs in em.accesses)
        cells.append(f"const {kt} x{r} = sf_stage_{idx}({args});")
    sdt = program.field_dtype(s)
    stores = []
    if s in plan.onchip:
        stores += [f"w[{rj * plan.row(s) + rk}] = {store(sdt, f'x{r}')};"
                   for r, (rj, rk) in enumerate(cell)]
    if s in program.outputs:
        cond = []
        if lo or RI != B:
            cond.append(f"il >= {lo} && il < {lo + B}")
        if masked:
            cond.append(f"gi < {I}")
        writes = []
        for r, (rj, rk) in enumerate(cell):
            c = []
            if lj or RJ != tj or rj:
                c.append(f"jl + {rj} >= {lj} && jl + {rj} < {lj + tj}")
            if lk or RK != tk or rk:
                c.append(f"kl + {rk} >= {lk} && kl + {rk} < {lk + tk}")
            if masked:
                c.append(f"{at('gj', rj)} < {J} && {at('gk', rk)} < {K}")
            w = (f"o_{s}[((long long)gi * {J} + {at('gj', rj)}) * {K} + "
                 f"{at('gk', rk)}] = {store(sdt, f'x{r}')};")
            writes.append(f"if ({' && '.join(c)}) {w}" if c else w)
        if cond:
            stores += [f"if ({' && '.join(cond)}) {{"] \
                + ["  " + w for w in writes] + ["}"]
        else:
            stores += writes
    body = ["{", f"  int pj = jl0_{NPK}, pk = kl0_{NPK};", "#pragma unroll 1",
            f"  for (int p = tid; p < {NPJ * NPK}; p += SF_NT) {{",
            f"    const int jl = pj{f' * {R}' if R > 1 else ''}, kl = pk;",
            f"    const int gj = j0 - {lj} + jl, gk = k0 - {lk} + kl;",
            "    (void)gj; (void)gk;"]
    body += [f"    const {stype(program.field_dtype(f))}* q_{f} = "
             f"{bases[f]} + jl * {plan.row(f)} + kl;" for f in fields]
    if s in plan.onchip:
        body.append(f"    {stype(sdt)}* w = b_{s} + jl * {plan.row(s)} + kl;")
    body += ["    " + y for y in pre]
    body += ["#pragma unroll 1", f"    for (int il = 0; il < {RI}; ++il) {{",
             f"      const int gi = t * {B} - {lo} + il;  (void)gi;"]
    body += ["      " + y for y in loads + cells + stores + shift]
    body += [f"      q_{f} += {plan.plane(f)};" for f in fields]
    if s in plan.onchip:
        body.append(f"      w += {plan.plane(s)};")
    body += ["    }",
             f"    pk += SF_NT % {NPK};", f"    pj += SF_NT / {NPK};",
             f"    if (pk >= {NPK}) {{ pk -= {NPK}; ++pj; }}", "  }", "}"]
    return body


def overlap_source(program: ir.Program, analysis: ChainAnalysis,
                   plan) -> str:
    """The overlap streamer for ``plan`` (backend/overlap.py OverlapPlan),
    K2, on K1's skeleton.

    One block per (i block of B output planes, j tile, k tile), the
    reference's i-walk spread over the grid: it loads the window of every
    streamed full-rank input (B + need_lo + need_hi planes, (j,
    k)-widened) by ``cp.async`` (zero-filled beyond the domain; 16-byte
    copies from an aligned column where K allows), waits for it, then
    evaluates every stage over its i-overlapped region into shared
    scratch placed by liveness, a barrier after each; no stage value
    leaves the block.  Each stage walks its region (``_walk_stage``: runs
    of R adjacent j cells a thread, i-neighbours from registers with
    ``plan.window``) in a mask-free body where the column's widest reach
    lies inside the (j, k) domain and the block's i reach inside [0, I),
    and a masked one elsewhere (boundary conditions from global
    coordinates).  Like ``panel_source``, the block body also compiles
    with g++ into ``sf_host_launch``."""
    I, J, K = dims = program.dimensions
    order, head, slots = _common(program, analysis)
    B, tj, tk = plan.tile
    n_blocks, ntj, ntk = plan.grid(dims)
    offs = plan.smem_offsets(program)
    params, args = _params(program)
    jlo, jhi, klo, khi = plan.reach(program)
    inputs = plan.window_inputs(program)
    L = [head, _STREAM_MACROS] + _skeleton_macros(plan.threads) + [
         _CP_WAIT_ALL, _CP16_MACROS,
         "// overlap streamer (backend/overlap.py): replaces the TPU kernel "
         "stencilflow_tpu/backend/overlap.py _overlap_kernel_body (K2)",
         "SF_DEV void sf_overlap_block(const int t, const int by, "
         "const int bx, const int tid, const int nt, "
         f"unsigned char* const sf_smem, {params}) {{",
         "  (void)nt;",
         f"  const int j0 = by * {tj}, k0 = bx * {tk};",
         "  // every cell and read of the column inside the (j, k) domain",
         f"  const bool inner = j0 >= {jlo} && j0 + {tj + jhi} <= {J} && "
         f"k0 >= {klo} && k0 + {tk + khi} <= {K};",
         "  (void)inner;"]
    for f in plan.onchip:
        ct = stype(program.field_dtype(f))
        L.append(f"  {ct}* const b_{f} = ({ct}*)(sf_smem + {offs[f]});")

    def chunks(f) -> Tuple[int, int]:
        """(rows, copies a row) of input f's loads: 16-byte copies of
        ``vec`` elements from its aligned ``korigin``, or one element a
        copy over its region's columns."""
        _, RJ, RK = plan.region(f)
        V = plan.vec.get(f, 1)
        if V == 1:
            return RJ, RK
        return RJ, -(-(plan.korigin(f) + tk + plan.needs[f][2][1]) // V)

    def loads(f) -> List[str]:
        """Input f's window: its region's planes from the block's first
        output plane less need_lo."""
        RI, _, _ = plan.region(f)
        RJ, NC = chunks(f)
        V = plan.vec.get(f, 1)
        (lo, _), (lj, _), _ = plan.needs[f]
        ct = stype(program.field_dtype(f))
        src = (f"g_{f} + (inb ? "
               f"{_flat_at((1, 1, 1), ('gi', 'gj', 'gk'), dims)} : 0LL)")
        body = [f"const int gi = t * {B} - {lo} + il, gj = j0 - {lj} + jl, "
                f"gk = k0 - {plan.korigin(f)} + kl"
                f"{f' * {V}' if V > 1 else ''};",
                f"const bool inb = gi >= 0 && gi < {I} && gj >= 0 && "
                f"gj < {J} && gk >= 0 && gk < {K};",
                f"{ct}* const d = b_{f} + il * {plan.plane(f)} + "
                f"jl * {plan.row(f)} + kl{f' * {V}' if V > 1 else ''};"]
        body.append(f"sf_cp16(d, {src}, inb);" if V > 1 else
                    _async_copy(program, f, "d", src))
        return _region_loop3(RI, RJ, NC, body)

    L += _thread_origins3({chunks(f) for f in inputs})
    L += _thread_origins(sorted({plan.positions(s)[1] for s in order}))
    if inputs:
        L.append("  // the block's input windows, need_lo planes before "
                 "its first output plane included")
        for f in inputs:
            L += ["  " + y for y in loads(f)]
        L += ["  SF_CP_COMMIT();", "  SF_CP_WAIT_ALL();", "  SF_SYNC();"]
    bases = {f: f"b_{f}" for f in plan.onchip}
    for idx, s in enumerate(order):
        kspec = program.kernels[s]
        RI, RJ, RK = plan.region(s)
        bodies = [_walk_stage(program, kspec, idx, s, plan, slots, m, bases)
                  for m in (False, True)]
        tlo, thi = plan.free_steps(program, s)
        L.append(f"  // stage {s}: {RI} x {RJ} x {RK}, runs of {plan.R} "
                 "along j")
        if tlo < thi:
            L += [f"  if (inner && t >= {tlo} && t < {thi}) {{  "
                  "// mask-free"] + ["    " + y for y in bodies[0]] + [
                  "  } else {  // masked"] + ["    " + y
                                              for y in bodies[1]] + ["  }"]
        else:
            L += ["  " + y for y in bodies[1]]
        if idx < len(order) - 1:
            L.append("  SF_SYNC();")
    L.append("}")
    L += _entry_points(program, "sf_overlap", params, args, (ntj, ntk),
                       offs[""], slots, min_blocks=plan.min_blocks(program),
                       threads=plan.threads, segments=n_blocks)
    L += _occupancy(offs[""], plan.threads, "sf_overlap")
    return "\n".join(L)


def host_source(program: ir.Program, analysis: ChainAnalysis) -> str:
    """A host loop nest over the whole domain evaluating the generated
    stage functions with global reads: ``void sf_host_run(const void*
    const* in, void* const* fields, const unsigned char* scal)``, where
    ``fields`` holds one (I, J, K) array per kernel in chain order."""
    I, J, K = program.dimensions
    order, head, slots = _common(program, analysis)
    arrays = [n for n, s in program.inputs.items() if not s.is_scalar]
    L = [head, 'extern "C" void sf_host_run(const void* const* in, '
               'void* const* fields, const unsigned char* scal) {',
         "  SfScalars sc;", "  sc.unused_ = 0;"]
    L += [f"  memcpy(&sc.x{i}, scal + {8 * i}, sizeof(sc.x{i}));"
          for i in slots.values()]
    for i, n in enumerate(arrays):
        ct = stype(program.inputs[n].dtype)
        L.append(f"  const {ct}* g_{n} = (const {ct}*)in[{i}];")
    for i, k in enumerate(order):
        ct = stype(program.kernels[k].dtype)
        L.append(f"  {ct}* g_{k} = ({ct}*)fields[{i}];")
    for idx, s in enumerate(order):
        body = _stage_call(program, program.kernels[s], idx,
                           ("gi", "gj", "gk"), lambda f: (lambda o: None),
                           slots)
        body.append(f"g_{s}[((long long)gi * {J} + gj) * {K} + gk] = "
                    f"{store(program.kernels[s].dtype, 'r')};")
        L += [f"  for (long long gi = 0; gi < {I}; ++gi)",
              f"  for (long long gj = 0; gj < {J}; ++gj)",
              f"  for (long long gk = 0; gk < {K}; ++gk) {{"]
        L += ["    " + b for b in body]
        L.append("  }")
    L.append("}")
    return "\n".join(L)

"""Matrix-free Krylov solvers over stencil-chain operators.

Port of ``stencilflow_tpu/solve.py``.  An affine chain ``fn(x) = A x +
c`` (constant coefficients, constant BCs; ``c`` collects bias terms,
boundary constants and the other inputs' contributions) is a matrix-free
linear operator: one application is one chain evaluation through
``compile_chain_best`` (a hand-written kernel on the card).  CG solves
an SPD operator; CGNR solves a general one by CG on the normal
equations, with the transpose from :func:`grad.adjoint_program`.

``c`` is measured once as ``fn(0)`` and moved to the right-hand side, so
the returned ``x`` satisfies the PROGRAM's equation ``fn(x) = rhs``.

On the device the CG vectors stay on the card and are updated in place;
``alpha`` and ``beta`` are 0-d device tensors used as factors
(``addcmul``), so the only host read per iteration is ``rs`` for the
stopping test, which keeps the reference's iteration count (stop at the
first ``k`` with ``rs <= tol**2 * |b|**2``).  ``host_chunks`` > 1 runs
each operator application out of core (``outofcore.py``) with the
vectors in host memory and dot products accumulated in f64.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import ir
from .backend.stacked_io import resolve_device
from .dtypes import (from_numpy, is_narrow, scalar, to_numpy,
                     to_numpy_dtype, to_torch, to_torch_dtype)


def _validate_affine(program: ir.Program, field: str, out: str):
    from .backend.linear import extract_linear
    for kname, kspec in program.kernels.items():
        if extract_linear(kspec) is None:
            raise ValueError(
                f"kernel {kname!r} is not affine with constant "
                "coefficients; Krylov solvers need a linear operator")
        for bc in kspec.boundary_conditions.values():
            if bc.kind != ir.BCKind.CONSTANT:
                raise ValueError(
                    f"kernel {kname!r} has a non-constant boundary "
                    "condition")
    if field not in program.inputs:
        raise ValueError(f"{field!r} is not a program input")
    spec = program.inputs[field]
    if spec.is_scalar or any(
            program.dimensions[d] > 1 and not spec.dim_mask[d]
            for d in range(3)):
        raise ValueError(f"solve field {field!r} must be a full-rank "
                         "array input")
    if out not in program.outputs:
        raise ValueError(f"{out!r} is not a program output")
    return spec


def _affine_op(program: ir.Program, field: str, out: str, device):
    """``(op, offset, lowering)`` for the chain's affine map restricted
    to ``field`` -> ``out`` on ``device``: ``op(x) = A x`` (a new tensor
    shaped like ``x``) and the offset ``c = fn(0)`` with every other
    input at its declared data.  Validates affinity, BCs and rank like
    adjoint_program."""
    from .backend import compile_chain_best
    from .data import load_input_arrays

    spec = _validate_affine(program, field, out)
    fn, name = compile_chain_best(program, device=device)
    shape = tuple(spec.shape(program.dimensions))
    # every other input pinned at its declared data: its contribution
    # lands in the affine offset and is subtracted with it
    rest = {n: (v if np.ndim(v) == 0 else to_torch(v, device))
            for n, v in load_input_arrays(program).items() if n != field}

    def full(x):
        return fn({field: x.reshape(shape), **rest})[out].reshape(x.shape)

    offset = full(torch.zeros(shape, dtype=to_torch_dtype(spec.dtype),
                              device=device))

    def op(x):
        return full(x).sub_(offset.reshape(x.shape))

    return op, offset, name


def _affine_op_chunked(program: ir.Program, field: str, out: str,
                       chunks: int, device):
    """Out-of-core variant of :func:`_affine_op`: one operator
    application = one i-chunked sweep (outofcore.py) over host numpy
    state.  CG vectors live in host memory; only one chunk (+halo) is
    ever device-resident."""
    from .data import load_input_arrays
    from .outofcore import compile_chunked_chain, run_chunked

    spec = _validate_affine(program, field, out)
    compiled = compile_chunked_chain(program, chunks, device=device)
    shape = tuple(spec.shape(program.dimensions))
    rest = {n: np.asarray(v)
            for n, v in load_input_arrays(program).items() if n != field}

    def full(x):
        got = run_chunked(program, {field: np.asarray(x).reshape(shape),
                                    **rest}, chunks, compiled=compiled)
        return got[out].reshape(np.shape(x))

    offset = full(np.zeros(shape, np.dtype(spec.dtype)))

    def op(x):
        return _sub(full(x), offset.reshape(np.shape(x)))

    name = f"outofcore[{compiled[1].backend} x{chunks} chunks]"
    return op, offset, name


def _sub(a, b) -> np.ndarray:
    """``a - b`` over host arrays of any of the program's types (numpy
    has no bfloat16 arithmetic), promoted as numpy promotes."""
    return to_numpy(from_numpy(np.ascontiguousarray(a))
                    - from_numpy(np.ascontiguousarray(b)))


def _flat(a) -> torch.Tensor:
    """A flat CPU tensor over host array ``a`` (no copy)."""
    return from_numpy(np.ascontiguousarray(a)).reshape(-1)


def _hdot(a, b) -> float:
    """f64-accumulated dot over host arrays, in slabs (no 2x f64 temp);
    torch's CPU kernels run it on every core."""
    a, b = _flat(a), _flat(b)
    total = 0.0
    step = 1 << 22
    for s in range(0, a.numel(), step):
        total += float(torch.dot(a[s:s + step].double(),
                                 b[s:s + step].double()))
    return total


def _make_cg_run_host(op: Callable, tol: float, maxiter: int) -> Callable:
    """Textbook CG with host-resident vectors (the out-of-core path);
    dot products accumulate in f64.  The vector updates run in place on
    every core (torch's CPU kernels over the numpy arrays), each product
    rounded before its sum as numpy rounds ``x + alpha * p``."""

    def run(x, b):
        x = np.array(x, copy=True)
        atol2 = float(tol) ** 2 * _hdot(b, b)
        r = _sub(b, op(x))
        p = np.array(r, copy=True)
        xt, rt, pt = _flat(x), _flat(r), _flat(p)
        tmp = torch.empty_like(pt)
        rs = _hdot(r, r)
        k = 0
        while rs > atol2 and k < maxiter:
            ap = _flat(op(p))
            # as numpy takes a Python float meeting the vectors' type
            alpha = float(scalar(rs / _hdot(p, ap), p.dtype))
            xt.add_(torch.mul(pt, alpha, out=tmp))
            rt.sub_(torch.mul(ap, alpha, out=tmp))
            rs_new = _hdot(r, r)
            pt.mul_(float(scalar(rs_new / rs, p.dtype))).add_(rt)
            rs = rs_new
            k += 1
        return x, rs, k

    return run


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _make_cg_run(op: Callable, tol: float, maxiter: int) -> Callable:
    """Textbook CG on ``op`` (must be SPD) with the vectors on the
    operator's device, updated in place; one host read a iteration (the
    stopping test).  Every scalar and vector keeps the vectors' type, as
    the JAX package's ``jnp`` CG does; on bfloat16 and float16 vectors
    the dots accumulate in float32 (as XLA's and torch's do) and each
    product ``alpha * p`` rounds before its sum, as ``x + alpha * p``
    rounds there."""

    def run(x, b):
        x = x.clone()
        narrow = is_narrow(to_numpy_dtype(b.dtype))
        atol2 = float(torch.tensor(tol, dtype=b.dtype, device=b.device)
                      ** 2 * _dot(b, b))
        r = b - op(x)
        p = r.clone()
        rs = _dot(r, r)
        k = 0
        while k < maxiter and float(rs) > atol2:
            ap = op(p)
            alpha = rs / _dot(p, ap)
            if narrow:
                x.add_(p * alpha)
                r.sub_(ap * alpha)
            else:
                x.addcmul_(p, alpha)
                r.addcmul_(ap, alpha, value=-1)
            rs_new = _dot(r, r)
            if narrow:
                torch.add(r, p * (rs_new / rs), out=p)
            else:
                torch.addcmul(r, p, rs_new / rs, out=p)
            rs = rs_new
            k += 1
        return x, rs, k

    return run


def make_solver(program: ir.Program,
                field: Optional[str] = None, out: Optional[str] = None,
                method: str = "cg",
                tol: float = 1e-6, maxiter: int = 1000,
                device="cuda",
                host_chunks: int = 0) -> Callable:
    """Compile a reusable solver ``solver(rhs, x0=None) -> (x, info)`` for
    the program's equation ``fn(x) = rhs`` (``fn`` restricted to input
    ``field`` and output ``out``; defaults: the first input/output).

    ``method="cg"`` needs the linear part symmetric positive definite
    (e.g. ``y = x - dt*laplacian(x)``); ``method="cgnr"`` handles general
    affine chains via CG on the normal equations, with the transposed
    chain from :func:`grad.adjoint_program`; both operators run through
    ``compile_chain_best`` on ``device``, and ``x`` is a tensor there.

    ``host_chunks`` > 1: implicit solves on domains larger than device
    memory: each operator application streams the domain in i-chunks
    (outofcore.py), CG vectors stay in host memory (``x`` is a numpy
    array), and dot products accumulate in f64.

    ``info["residual"]`` is always the true relative residual
    ``|fn(x) - rhs| / |rhs|`` (one extra operator application).
    ``solver.operator`` is the operator CG applies each iteration and
    ``solver.lowering`` the operators' lowerings.  Compilation happens
    once here: reuse the solver across time steps.
    """
    host = bool(host_chunks and host_chunks > 1)
    device = resolve_device(device)
    field = field or next(iter(program.inputs))
    out = out or program.outputs[0]
    if host:
        op, offset, name = _affine_op_chunked(program, field, out,
                                              host_chunks, device)
    else:
        op, offset, name = _affine_op(program, field, out, device)
    lowering = {"operator": name}

    if method == "cg":
        normal = op
        project = None
    elif method == "cgnr":
        from .grad import adjoint_program
        adj, cot = adjoint_program(program, wrt=[field])
        if host:
            op_t, _zero, name_t = _affine_op_chunked(
                adj, cot[out], f"adj_{field}", host_chunks, device)
        else:
            op_t, _zero, name_t = _affine_op(adj, cot[out], f"adj_{field}",
                                             device)
        lowering["transpose"] = name_t

        def normal(v):
            return op_t(op(v).reshape(v.shape)).reshape(v.shape)

        project = op_t
    else:
        raise ValueError(f"unknown method {method!r} (cg | cgnr)")

    if host:
        run = _make_cg_run_host(normal, tol, maxiter)

        def _residual(x, b, rhs):
            d = _sub(op(x), b)
            return (np.sqrt(_hdot(d, d))
                    / max(np.sqrt(_hdot(rhs, rhs)), 1e-30))

        def solver(rhs, x0=None):
            rhs = np.asarray(rhs)
            b = _sub(rhs, offset.reshape(rhs.shape))
            b_sys = (project(b).reshape(b.shape)
                     if project is not None else b)
            x = (np.zeros_like(b_sys) if x0 is None
                 else np.array(x0, copy=True))
            x, _rs, k = run(x, b_sys)
            return x, {"iterations": int(k),
                       "residual": float(_residual(x, b, rhs))}
    else:
        run = _make_cg_run(normal, tol, maxiter)

        def _residual(x, b, rhs):
            # |op(x) - b| == |fn(x) - rhs| (b = rhs - offset), but
            # normalize by the ORIGINAL rhs: with a nonzero affine offset
            # |b| can differ from |rhs| by an unbounded factor and
            # misreport convergence
            return (torch.linalg.norm(op(x) - b) /
                    torch.linalg.norm(rhs).clamp_min(1e-30))

        def solver(rhs, x0=None):
            rhs = to_torch(rhs).to(device, offset.dtype)
            b = rhs - offset.reshape(rhs.shape)
            b_sys = (project(b).reshape(b.shape)
                     if project is not None else b)
            x = (torch.zeros_like(b_sys) if x0 is None
                 else to_torch(x0).to(device, b_sys.dtype))
            x, _rs, k = run(x, b_sys)
            return x, {"iterations": int(k),
                       "residual": float(_residual(x, b, rhs))}

    solver.operator = normal
    solver.lowering = lowering
    return solver


def solve_cg(program: ir.Program, rhs: Any, **kw) -> Tuple[Any, Dict]:
    """One-shot :func:`make_solver`(method="cg"); see there.  For
    repeated solves (implicit time-stepping) build the solver once."""
    kw.setdefault("method", "cg")
    if kw["method"] != "cg":
        raise ValueError("solve_cg is CG; call solve_cgnr or "
                         "make_solver(method=...) instead")
    return make_solver(program, **kw)(rhs)


def solve_cgnr(program: ir.Program, rhs: Any, **kw) -> Tuple[Any, Dict]:
    """One-shot :func:`make_solver`(method="cgnr"); see there."""
    kw.setdefault("method", "cgnr")
    if kw["method"] != "cgnr":
        raise ValueError("solve_cgnr is CGNR; call solve_cg or "
                         "make_solver(method=...) instead")
    return make_solver(program, **kw)(rhs)

"""Differentiable chain evaluation: adjoints of stencil programs.

Port of ``stencilflow_tpu/grad.py``:

* ``value_and_grad`` / ``grad``: ``torch.autograd`` through the dense
  lowering (``backend/dense.py``), the general path, as the reference
  differentiates its fused-XLA tile evaluator.  Non-affine programs
  differentiate as subgradients with the reference's conventions (a
  ``min``/``max`` tie splits the gradient in halves, ``abs`` has
  gradient 1 at 0, a ternary sends it down the branch it took), and the
  result is itself differentiable.
* ``adjoint_program``: an affine chain transposed into another stencil
  program (a copy: it maps IR to IR).
* ``fast_value_and_grad``: the chain forward and its adjoint program
  backward, both through ``compile_chain_best`` (the hand-written
  kernels on the card), joined by a ``torch.autograd.Function``; the
  loss cotangent is autograd over the outputs only.  ``host_chunks`` > 1
  runs both passes out of core (``outofcore.py``).

Multi-device: ``mesh`` + ``dim_axes`` run the chain through the sharded
engine (``parallel/domain.py compile_sharded_chain``).  ``value_and_grad``
takes its dense tile body (as the reference takes ``local_backend="xla"``)
and torch autograd differentiates the halo exchange's slab copies, so
the gradient of a sharded forward needs no adjoint exchange of its own;
``fast_value_and_grad`` runs the forward and the adjoint program both
sharded (K4 per shard on CUDA shards).  Outputs are gathered for the
loss on the mesh's first device; the gradients are global tensors
there.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir
from .backend.stacked_io import resolve_device
from .dtypes import from_numpy, is_floating, to_numpy, to_torch
from .frontend.analysis import ChainAnalysis
from .iterate import MESH_NEEDS_AXES


def _default_wrt(program: ir.Program):
    return [n for n, s in program.inputs.items()
            if not s.is_scalar and is_floating(s.dtype)]


def _sum_loss(outputs):
    return sum(v.sum() for v in outputs.values())


def _on_device(v, device):
    """An input as a tensor on ``device`` (scalars stay on the host, as
    the lowerings take them)."""
    t = to_torch(v)
    return t if t.ndim == 0 else t.to(device)


def value_and_grad(program: ir.Program,
                   loss: Optional[Callable[[Dict[str, Any]], Any]] = None,
                   wrt: Optional[Sequence[str]] = None,
                   analysis: Optional[ChainAnalysis] = None,
                   mesh=None, dim_axes: Optional[Sequence] = None,
                   device="cuda") -> Callable:
    """Build ``f(inputs) -> (value, grads)`` for a scalar loss of the
    chain's outputs, on ``device``.

    ``loss``: callable mapping the outputs dict (tensors) to a scalar
    tensor (default: sum of every output).  ``wrt``: input names to
    differentiate with respect to (default: every non-scalar
    floating-point input).  ``grads`` is a dict of tensors over ``wrt``.
    Where an input requires grad, the value and the grads keep their
    graph (``create_graph``): the returned function differentiates again.

    ``mesh`` + ``dim_axes``: the forward is the sharded engine's dense
    tile body on the mesh (``device`` unused); the decomposition plan is
    ``f.plan``.
    """
    plan = None
    if mesh is not None:
        if dim_axes is None:
            raise ValueError(MESH_NEEDS_AXES)
        fn, plan = _sharded(program, mesh, dim_axes, analysis, "xla")
        device = _gather_device(mesh)
    else:
        from .backend.dense import compile_chain
        device = resolve_device(device)
        fn = compile_chain(program, analysis)
    wrt = list(_default_wrt(program) if wrt is None else wrt)
    unknown = [n for n in wrt if n not in program.inputs]
    if unknown:
        raise ValueError(f"wrt names {unknown} are not program inputs "
                         f"(inputs: {list(program.inputs)})")
    loss = loss or _sum_loss

    def f(inputs: Dict[str, Any]):
        args = {n: _on_device(v, device) for n, v in inputs.items()}
        higher = any(args[n].requires_grad for n in wrt)
        with torch.enable_grad():
            diff = {n: args[n] if args[n].requires_grad else
                    args[n].detach().requires_grad_() for n in wrt}
            val = loss(fn({**args, **diff}))
            grads = torch.autograd.grad(val, [diff[n] for n in wrt],
                                        create_graph=higher,
                                        allow_unused=True)
        grads = {n: (torch.zeros_like(diff[n]) if g is None else g)
                 for n, g in zip(wrt, grads)}
        return (val if higher else val.detach()), grads

    f.plan = plan
    return f


def _gather_device(mesh) -> torch.device:
    """Where sharded outputs are gathered for the loss: the mesh's first
    device."""
    return mesh.devices.flat[0]


def _sharded(program, mesh, dim_axes, analysis=None, local_backend="auto"):
    """``(fn, plan)``: the sharded chain with its outputs gathered to
    global tensors on the mesh's first device (differentiable: the
    gathers and the exchange are copies autograd follows)."""
    from .parallel.domain import compile_sharded_chain
    sfn, plan = compile_sharded_chain(program, mesh, dim_axes, analysis,
                                      local_backend=local_backend)
    device = _gather_device(mesh)

    def fn(inputs):
        return {o: v.gather(device) for o, v in sfn(inputs).items()}

    fn.last_config = sfn.last_config
    return fn, plan


def grad(program: ir.Program, **kw) -> Callable:
    """``f(inputs) -> grads`` (see :func:`value_and_grad`)."""
    vg = value_and_grad(program, **kw)

    def f(inputs):
        return vg(inputs)[1]

    f.plan = vg.plan
    return f


def _adjoint_extras(adj: ir.Program, cot: Dict[str, str]):
    """The adjoint program's inputs other than the cotangents (copy-BC
    OOB indicators): compile-time constants, loaded once."""
    from .data import load_input_arrays
    names = set(cot.values())
    return {n: v for n, v in load_input_arrays(adj).items()
            if n not in names}


def fast_value_and_grad(program: ir.Program,
                        loss: Optional[Callable] = None,
                        wrt: Optional[Sequence[str]] = None,
                        mesh=None, dim_axes: Optional[Sequence] = None,
                        device="cuda",
                        host_chunks: int = 0) -> Callable:
    """``f(inputs) -> (value, grads)`` with BOTH passes on the kernels
    (affine chains only: see :func:`adjoint_program` for the
    requirements; :func:`value_and_grad` is the general path).

    The chain runs forward through ``compile_chain_best``, the loss
    cotangent ``dL/dy`` is autograd of ``loss`` over the outputs, and
    the gradient is the adjoint program, also through
    ``compile_chain_best``, applied to that cotangent.  The two passes
    are one ``torch.autograd.Function`` (``f.function``: forward the
    chain, backward its adjoint), so the chain also composes into larger
    autograd graphs.  ``f.lowering`` records the forward and adjoint
    lowerings.

    ``host_chunks`` > 1: gradients over domains larger than device
    memory: forward chain, loss cotangent and adjoint chain all run in
    i-chunked sweeps (outofcore.py) over host arrays.  The loss must be
    ADDITIVE over elements (sum, MSE, any per-element reduction): it is
    evaluated per i-chunk and summed.

    ``mesh`` + ``dim_axes``: the forward and the adjoint both run through
    the sharded engine on the mesh (``device`` unused); ``f.plan`` is the
    forward's decomposition and ``f.lowering`` names
    ``sharded[<local body>]`` for each pass.
    """
    wrt = list(_default_wrt(program) if wrt is None else wrt)
    loss = loss or _sum_loss
    adj, cot = adjoint_program(program, wrt)
    plan = None
    if host_chunks and host_chunks > 1:
        if mesh is not None:
            raise ValueError("host_chunks is incompatible with mesh")
        return _fast_vag_chunked(program, adj, cot, loss, wrt,
                                 host_chunks, resolve_device(device))
    if mesh is not None:
        if dim_axes is None:
            raise ValueError(MESH_NEEDS_AXES)
        fwd, plan = _sharded(program, mesh, dim_axes)
        bwd, _bplan = _sharded(adj, mesh, dim_axes)
        fwd_name = f"sharded[{fwd.last_config['backend']}]"
        bwd_name = f"sharded[{bwd.last_config['backend']}]"
        device = _gather_device(mesh)
    else:
        from .backend import compile_chain_best
        device = resolve_device(device)
        fwd, fwd_name = compile_chain_best(program, device=device)
        bwd, bwd_name = compile_chain_best(adj, device=device)
    extra = {n: _on_device(v, device)
             for n, v in _adjoint_extras(adj, cot).items()}
    adj_raw = tuple(adj.raw_dimensions)

    class Chain(torch.autograd.Function):
        """The compiled chain; its backward is the compiled adjoint."""

        @staticmethod
        def forward(ctx, rest, *xs):
            ctx.shapes = [x.shape for x in xs]
            outs = fwd({**rest, **dict(zip(wrt, xs))})
            return tuple(outs[o] for o in program.outputs)

        @staticmethod
        def backward(ctx, *cts):
            adj_in = {cot[o]: ct.reshape(adj_raw).contiguous()
                      for o, ct in zip(program.outputs, cts)}
            adj_out = bwd({**adj_in, **extra})
            return (None,) + tuple(adj_out[f"adj_{n}"].reshape(shape)
                                   for n, shape in zip(wrt, ctx.shapes))

    def f(inputs: Dict[str, Any]):
        args = {n: _on_device(v, device) for n, v in inputs.items()}
        rest = {n: v for n, v in args.items() if n not in wrt}
        with torch.enable_grad():
            xs = [args[n].detach().requires_grad_() for n in wrt]
            outs = Chain.apply(rest, *xs)
            val = loss(dict(zip(program.outputs, outs)))
            grads = torch.autograd.grad(val, xs, allow_unused=True)
        grads = {n: (torch.zeros_like(x) if g is None else g)
                 for n, x, g in zip(wrt, xs, grads)}
        return val.detach(), grads

    f.plan = plan
    f.function = Chain
    f.lowering = {"forward": fwd_name, "adjoint": bwd_name}
    return f


def _fast_vag_chunked(program: ir.Program, adj: ir.Program,
                      cot: Dict[str, str], loss: Callable,
                      wrt: Sequence[str], chunks: int, device):
    """Out-of-core fast_value_and_grad: chunked forward sweep, per-chunk
    loss cotangent (additive losses), chunked adjoint sweep."""
    from .outofcore import compile_chunked_chain, run_chunked

    fwd_c = compile_chunked_chain(program, chunks, device=device)
    bwd_c = compile_chunked_chain(adj, chunks, device=device)
    extra = {n: np.asarray(v) for n, v in _adjoint_extras(adj, cot).items()}
    Ic = fwd_c[1].block

    def f(inputs: Dict[str, Any]):
        outputs = run_chunked(program, inputs, chunks, compiled=fwd_c)
        val = 0.0
        ct = {o: np.empty_like(outputs[o]) for o in program.outputs}
        for c in range(chunks):
            sl = slice(c * Ic, (c + 1) * Ic)
            with torch.enable_grad():
                chunk_out = {o: from_numpy(outputs[o][sl]).to(device)
                             .requires_grad_() for o in program.outputs}
                v = loss(chunk_out)
                g = torch.autograd.grad(v, list(chunk_out.values()),
                                        allow_unused=True)
            val += float(v.detach())
            for o, go in zip(program.outputs, g):
                ct[o][sl] = 0 if go is None else to_numpy(go)
        adj_in = {cot[o]: ct[o] for o in program.outputs}
        adj_out = run_chunked(adj, {**adj_in, **extra}, chunks,
                              compiled=bwd_c)
        grads = {n: adj_out[f"adj_{n}"].reshape(np.shape(inputs[n]))
                 for n in wrt}
        return val, grads

    f.plan = None
    f.lowering = {"forward": f"outofcore[{fwd_c[1].backend} x{chunks} "
                             "chunks]",
                  "adjoint": f"outofcore[{bwd_c[1].backend} x{chunks} "
                             "chunks]"}
    return f


def adjoint_program(program: ir.Program,
                    wrt: Optional[Sequence[str]] = None
                    ) -> Tuple[ir.Program, Dict[str, str]]:
    """Transpose an affine chain into another stencil *program*.

    The adjoint of a linear stencil chain is itself a chain of transposed
    stencils: if ``y = sum_o c_o * x[t+o]`` then ``xbar = sum_o c_o *
    ybar[t-o]``.  This builds that chain in the same dialect, so the
    backward pass runs through ``compile_chain_best`` like any forward
    chain; :func:`value_and_grad` remains the fully general path
    (non-affine programs, custom losses fused with the forward).

    Returns ``(adjoint, cotangents)`` where ``adjoint`` is a Program
    whose inputs are one cotangent field per primal output (named by the
    ``cotangents`` dict, default data ``constant:1.0`` = the adjoint of
    a sum loss) and whose outputs are ``adj_<name>`` for every ``wrt``
    input.  Requirements (raises ``ValueError`` otherwise): every live
    kernel affine with constant coefficients, no shrink boundary
    condition (a constant-BC read transposes to a zero-BC read, a
    copy-BC read adds 1-D out-of-bounds indicator inputs), and every
    ``wrt`` input full-rank.
    """
    from .backend.linear import extract_linear
    from .dtypes import dtype_to_str

    if wrt is None:
        wrt = _default_wrt(program)
    for n in wrt:
        if n not in program.inputs:
            raise ValueError(f"wrt name {n!r} is not a program input")
        mask = program.inputs[n].dim_mask
        if any(program.dimensions[d] > 1 and not mask[d]
               for d in range(3)):
            raise ValueError(f"wrt input {n!r} must span every non-unit "
                             "dim (broadcast adjoints need a reduction, "
                             "not a stencil)")

    analysis = ChainAnalysis.run(program)
    order = analysis.graph.kernel_order

    def adj_name(f: str) -> str:
        return f"adj_{f}"

    cot = {o: f"ct_{o}" for o in program.outputs}

    # kernels whose value transitively reaches a program output; a dead
    # kernel's cotangent is identically zero, so its consumers' terms (and
    # its own adjoint kernel) are skipped rather than referencing an
    # undefined adj_<dead> field
    live = set(program.outputs)
    for kname in reversed(order):
        if any(c in live for c in analysis.graph.consumers(kname)):
            live.add(kname)

    # only LIVE kernels must be affine/shrink-free: a dead diagnostic
    # kernel (e.g. a min/max monitor feeding no output) never enters the
    # transposed chain, so it cannot block the fast adjoint
    coeffs: Dict[str, Dict] = {}
    for kname, kspec in program.kernels.items():
        if kname not in live:
            continue
        c = extract_linear(kspec)
        if c is None:
            raise ValueError(
                f"kernel {kname!r} is not affine with constant "
                "coefficients; use value_and_grad for the general path")
        for bc in kspec.boundary_conditions.values():
            if bc.kind == ir.BCKind.SHRINK:
                raise ValueError(
                    f"kernel {kname!r} has a shrink boundary condition; "
                    "its junk halo has no meaningful adjoint")
        coeffs[kname] = c

    def idx(offsets) -> str:
        its = ("i", "j", "k")
        parts = []
        for it, o in zip(its, offsets):
            o = -(o or 0)   # transposed read
            parts.append(it if o == 0 else
                         (f"{it}+{o}" if o > 0 else f"{it}-{-o}"))
        return "[" + ", ".join(parts) + "]"

    # 1-D out-of-bounds indicator inputs for copy-BC boundary terms,
    # registered on demand: ind[x_d] = 1 iff x_d + o leaves dim d.  The
    # union over dims factorizes through these per-dim masks, so the
    # position-dependent transpose of an edge-clamp read stays inside the
    # dialect (lower-rank inputs with input_dims).
    mask_inputs: Dict[str, Dict] = {}
    mask_dtype = dtype_to_str(max(
        (np.dtype(k.dtype) for k in program.kernels.values()),
        key=lambda d: d.itemsize))

    def oob_mask_name(d: int, o: int) -> str:
        name = f"oob_{'ijk'[d]}_{'m' if o < 0 else 'p'}{abs(o)}"
        if name not in mask_inputs:
            D = program.dimensions[d]
            data = [1.0 if (x + o < 0 or x + o >= D) else 0.0
                    for x in range(D)]
            mask_inputs[name] = {"data": data, "data_type": mask_dtype,
                                 "input_dims": ["ijk"[d]]}
        return name

    def oob_expr(offsets) -> str:
        """Indicator that the forward read at +offsets left the domain."""
        factors = [f"{oob_mask_name(d, o)}[{'ijk'[d]}]"
                   for d, o in enumerate(offsets) if o]
        if len(factors) == 1:
            return factors[0]
        return "(1.0 - " + " * ".join(f"(1.0 - {m})"
                                      for m in factors) + ")"

    # per field: terms contributed by each consumer's adjoint
    def consumer_terms(f: str):
        terms = []
        reads = set()
        for c in analysis.graph.consumers(f):
            if c not in program.kernels or c not in live:
                continue
            src = (cot[c] if (c in cot and
                              not any(k in program.kernels and k in live
                                      for k in
                                      analysis.graph.consumers(c)))
                   else adj_name(c))
            bc = program.kernels[c].boundary_conditions.get(f)
            for key, w in coeffs[c].items():
                if key == ("const",) or key[0] != f or w == 0.0:
                    continue
                terms.append(f"{w!r} * {src}{idx(key[1])}")
                reads.add(src)
                # transpose of a copy-BC (edge-clamp-to-center) read: the
                # OOB positions scattered their weight onto their own
                # center, so the adjoint adds w * oob_o(x) * cot[x]
                if bc is not None and bc.kind == ir.BCKind.COPY and \
                        any(o for o in key[1] if o):
                    offs = tuple(o or 0 for o in key[1])
                    terms.append(
                        f"{w!r} * {oob_expr(offs)} * {src}[i, j, k]")
        return terms, reads

    kernels: Dict[str, Dict] = {}
    # adjoints of intermediate kernels (reverse topological order)
    for kname in reversed(order):
        if kname not in live:
            continue   # dead kernel: cotangent identically zero
        consumed = any(c in program.kernels and c in live
                       for c in analysis.graph.consumers(kname))
        if not consumed:
            continue   # pure output: its adjoint IS the cotangent input
        terms, reads = consumer_terms(kname)
        if kname in cot:   # output consumed by later kernels too
            terms = [f"{cot[kname]}[i, j, k]"] + terms
            reads.add(cot[kname])
        dtype = program.kernels[kname].dtype
        kernels[adj_name(kname)] = {
            "computation_string":
                # all-zero coefficients leave no terms: the adjoint is 0
                f"{adj_name(kname)} = " + (" + ".join(terms) or "0.0"),
            "boundary_conditions": {
                r: {"type": "constant", "value": 0.0} for r in reads},
            "data_type": dtype_to_str(dtype),
        }
    # adjoints of the wrt inputs
    for n in wrt:
        terms, reads = consumer_terms(n)
        dtype = program.inputs[n].dtype
        kernels[adj_name(n)] = {
            "computation_string":
                # unread or zero-coefficient input: the gradient is 0
                f"{adj_name(n)} = " + (" + ".join(terms) or "0.0"),
            "boundary_conditions": {
                r: {"type": "constant", "value": 0.0} for r in reads},
            "data_type": dtype_to_str(np.dtype(dtype)),
        }

    spec = {
        "inputs": {
            **{cot[o]: {"data": "constant:1.0",
                        "data_type": dtype_to_str(
                            program.kernels[o].dtype)}
               for o in program.outputs},
            **mask_inputs,
        },
        "outputs": [adj_name(n) for n in wrt],
        # padded 3-D dims: the adjoint strings use full [i, j, k] indices
        "dimensions": list(program.dimensions),
        "program": kernels,
    }
    if program.vectorization > 1:
        spec["vectorization"] = program.vectorization
    from .frontend.parser import parse_program
    return (parse_program(spec, name=f"{program.name}_adjoint"),
            dict(cot))

"""Lowerings of a stencil chain to torch tensors on one device.

``compile_chain_best`` keeps the JAX package's order
(``stencilflow_tpu/backend/__init__.py``): a chain with no wide affine
stage goes to the overlap kernel when its cumulative i-extent is at most
2, else to the panel kernel; for a chain with one, the stream lowering is
planned, and taken when it has a banded stage — when its planner declines
every such stage, the chain goes to overlap or panel as before.  The
whole-domain ``dense`` lowering comes last: for programs every planner
refuses, and on a CPU device.
"""
import torch

from .. import ir
from ..frontend.analysis import ChainAnalysis
from .dense import chain_halo, compile_chain
from .linear import extract_linear
from .overlap import OverlapPlan, compile_chain_overlap, shallow_extent
from .panel import PanelPlan, compile_chain_panel
from .stream import (MXU_MIN_FOOTPRINT, check_options,
                     compile_chain_stream, compile_stream_plan, plan_stream)


def _any_mxu_candidate(program, min_footprint: int = MXU_MIN_FOOTPRINT
                       ) -> bool:
    """Is any stage affine with a footprint wide enough for the banded
    lowering, and no copy BC?"""
    for kspec in program.kernels.values():
        coeffs = extract_linear(kspec)
        if coeffs is None:
            continue
        if any(bc.kind == ir.BCKind.COPY
               for bc in kspec.boundary_conditions.values()):
            continue
        if sum(1 for key in coeffs if key != ("const",)) >= min_footprint:
            return True
    return False


def choose_stacked(program, analysis):
    """``"overlap"`` (shallow) or ``"panel"`` (deep) for an untiled chain
    whose planner accepts it, or None.  Planning only: nothing is built."""
    try:
        if shallow_extent(program, analysis) <= 2:
            OverlapPlan.build(analysis)
            return "overlap"
    except (ValueError, NotImplementedError):
        pass
    try:
        PanelPlan.build(analysis)
        return "panel"
    except (ValueError, NotImplementedError):
        return None


def _route(program, analysis, device, mxu="auto", mxu_precision="split"):
    """(lowering name, stream plan or None) for ``device``; planning
    only."""
    check_options(mxu, mxu_precision)   # raised, never re-routed
    if torch.device(device).type != "cuda":
        return "dense", None
    if mxu != "off" and _any_mxu_candidate(program):
        try:
            plan = plan_stream(program, analysis, mxu=mxu,
                               mxu_precision=mxu_precision)
            if plan.mxu_plans:
                return "stream", plan
        except (ValueError, NotImplementedError):
            pass   # a planner refusal: the per-cell kernels below
    return choose_stacked(program, analysis) or "dense", None


def choose_backend(program, analysis, device, mxu="auto",
                   mxu_precision="split") -> str:
    """The lowering compile_chain_best takes for ``device``."""
    return _route(program, analysis, device, mxu, mxu_precision)[0]


def compile_chain_best(program, analysis=None, device="cuda", mxu="auto",
                       mxu_precision="split"):
    """Pick the lowering for ``device``; returns ``(fn, backend_name)``.
    ``mxu``/``mxu_precision`` forward to the stream lowering."""
    analysis = analysis or ChainAnalysis.run(program)
    name, plan = _route(program, analysis, device, mxu, mxu_precision)
    if name == "stream":
        return compile_stream_plan(plan, device), name
    if name == "overlap":
        return compile_chain_overlap(program, analysis, device=device), name
    if name == "panel":
        return compile_chain_panel(program, analysis, device=device), name
    return compile_chain(program, analysis), name


__all__ = ["chain_halo", "choose_backend", "compile_chain",
           "compile_chain_best", "compile_chain_stream"]

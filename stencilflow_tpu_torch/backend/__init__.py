"""Lowerings of a stencil chain to torch tensors on one device.

``compile_chain_best`` keeps the JAX package's ladder
(``stencilflow_tpu/backend/__init__.py``), for a CUDA device:

1. a chain whose stream plan has a banded stage (a wide affine stage) →
   ``stream``;
2. a 2-D chain of at least 4 stages → ``rows+group_g8``: rotated to rows
   and streamed by the group kernel, g = 8, B = 64, when its planner
   accepts it.  The reference takes this rung for deep 2-D chains that
   its plane streamer must j-tile; on the H100 every plane larger than
   one block's tile is tiled, so the rung applies at every size (it
   differs from the reference for small planes that fit a TPU's VMEM
   whole);
3. ``overlap`` when the chain's cumulative i-extent is at most 2, else
   ``panel``;
4. the stream kernel with every stage per cell, and last its spill rung
   (K3c: rings spilled to device memory, ``spill="auto"``) — the rung
   that takes deep 3-D chains whose rings exceed shared memory at every
   tile; rung 1 takes a spilled plan too, as the reference takes the
   spilled plan its streamer returns for a chain with a wide affine
   stage that fits no tile;
5. a 2-D chain → ``rows+<lowering>``: rotated, then this ladder again
   (where the rotated chain lands on a kernel);
6. ``tile``, the overlapped-tile kernel (K6, the reference's ``pallas``
   rung), when a tile's live buffers fit shared memory;
7. ``dense``, the whole-domain lowering — also the lowering on a CPU
   device.

``route_source`` gives the CUDA C++ that rung's build compiles, by
planning only (the ``compile`` subcommand's artifact).
"""
import torch

from .. import ir
from ..frontend.analysis import ChainAnalysis
from ..frontend.canonicalize import rotate_2d_to_rows
from . import codegen
from .dense import chain_halo, compile_chain
from .group import compile_chain_group, plan_group
from .linear import banded_types, extract_linear
from .overlap import OverlapPlan, compile_chain_overlap, shallow_extent
from .panel import PanelPlan, compile_chain_panel
from .stream import (MXU_MIN_FOOTPRINT, check_options, check_spill,
                     compile_chain_stream, compile_stream_plan, plan_stream,
                     stream_source)
from .tile import AUTO_MODE, compile_chain_tile, plan_tile, tile_source

# rung 2: the reference's rows+group configuration for deep 2-D chains
ROWS_GROUP = 8
ROWS_PANEL = 64


def _any_mxu_candidate(program, min_footprint: int = MXU_MIN_FOOTPRINT
                       ) -> bool:
    """Is any stage affine with a footprint wide enough for the banded
    lowering, of float32 types, and no copy BC?"""
    for kspec in program.kernels.values():
        coeffs = extract_linear(kspec) if banded_types(program, kspec) \
            else None
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


def _is_2d(program) -> bool:
    return len(program.raw_dimensions) == 2


def _route(program, analysis, device, mxu="auto", mxu_precision="split",
           spill="auto"):
    """(lowering name, stream plan or None) for ``device``; planning
    only."""
    check_options(mxu, mxu_precision)   # raised, never re-routed
    check_spill(spill)
    if torch.device(device).type != "cuda":
        return "dense", None
    if mxu != "off" and _any_mxu_candidate(program):
        try:
            plan = plan_stream(program, analysis, mxu=mxu,
                               mxu_precision=mxu_precision, spill=spill)
            if plan.mxu_plans or plan.packed:
                return "stream", plan
        except (ValueError, NotImplementedError):
            pass   # a planner refusal: the per-cell kernels below
    if _is_2d(program) and len(program.kernels) >= 4:
        try:
            plan_group(rotate_2d_to_rows(program), panel=ROWS_PANEL,
                       group=ROWS_GROUP)
            return f"rows+group_g{ROWS_GROUP}", None
        except (ValueError, NotImplementedError):
            pass
    stacked = choose_stacked(program, analysis)
    if stacked:
        return stacked, None
    try:
        return "stream", plan_stream(program, analysis, mxu="off",
                                     spill=spill)
    except (ValueError, NotImplementedError):
        pass
    if _is_2d(program):
        rot = rotate_2d_to_rows(program)
        inner = _route(rot, ChainAnalysis.run(rot), device, mxu,
                       mxu_precision, spill)[0]
        if inner != "dense":
            return "rows+" + inner, None
    try:
        plan_tile(program, analysis)
        return "tile", None
    except (ValueError, NotImplementedError):
        pass
    return "dense", None


def choose_backend(program, analysis, device, mxu="auto",
                   mxu_precision="split", spill="auto") -> str:
    """The lowering compile_chain_best takes for ``device``."""
    return _route(program, analysis, device, mxu, mxu_precision, spill)[0]


def compile_chain_best(program, analysis=None, device="cuda", mxu="auto",
                       mxu_precision="split", spill="auto"):
    """Pick the lowering for ``device``; returns ``(fn, backend_name)``.
    ``mxu``/``mxu_precision``/``spill`` forward to the stream lowering."""
    analysis = analysis or ChainAnalysis.run(program)
    name, plan = _route(program, analysis, device, mxu, mxu_precision,
                        spill)
    if name == f"rows+group_g{ROWS_GROUP}":
        return compile_chain_rows(program, "group", group=ROWS_GROUP,
                                  panel=ROWS_PANEL, device=device)
    if name.startswith("rows+"):
        return compile_chain_rows(program, device=device, mxu=mxu,
                                  mxu_precision=mxu_precision, spill=spill)
    if name == "stream":
        return compile_stream_plan(plan, device), name
    if name == "tile":
        return compile_chain_tile(program, analysis, device=device), name
    if name == "overlap":
        return compile_chain_overlap(program, analysis, device=device), name
    if name == "panel":
        return compile_chain_panel(program, analysis, device=device), name
    return compile_chain(program, analysis), name


def route_source(program, analysis=None, mxu="auto", mxu_precision="split",
                 spill="auto"):
    """``(backend name, CUDA C++ source, library name)`` of the kernel that
    ``compile_chain_best(program, device="cuda")`` builds, by planning
    only: each rung plans as its compile entry point does and generates
    the source through the function its build compiles (a ``rows+`` rung:
    the rotated program's, as ``compile_chain_rows`` builds it).  Raises
    ValueError where the route is ``dense``, which has no generated
    kernel."""
    analysis = analysis or ChainAnalysis.run(program)
    name, plan = _route(program, analysis, "cuda", mxu, mxu_precision,
                        spill)
    if name == f"rows+group_g{ROWS_GROUP}":
        rot = rotate_2d_to_rows(program)
        an = ChainAnalysis.run(rot)
        plan = plan_group(rot, an, ROWS_PANEL, ROWS_GROUP)
        return name, codegen.group_source(rot, an, plan), "group"
    if name.startswith("rows+"):
        inner, source, lib = route_source(rotate_2d_to_rows(program),
                                          mxu=mxu,
                                          mxu_precision=mxu_precision,
                                          spill=spill)
        return "rows+" + inner, source, lib
    if name == "stream":
        return name, stream_source(plan), "stream"
    if name == "tile":
        return name, tile_source(plan_tile(program, analysis,
                                           mode=AUTO_MODE)), "tile"
    if name == "overlap":
        return name, codegen.overlap_source(
            program, analysis, OverlapPlan.build(analysis)), "overlap"
    if name == "panel":
        return name, codegen.panel_source(
            program, analysis, PanelPlan.build(analysis)), "panel"
    raise ValueError(f"{program.name} routes to dense, the whole-domain "
                     "torch lowering, which has no generated kernel")


def compile_chain_rows(program, backend: str = "auto", group: int = 2,
                       panel: int = 0, device="cuda", mxu: str = "auto",
                       mxu_precision: str = "split", spill: str = "auto",
                       ring_storage: str = "off"):
    """Row-streaming lowering of a 2-D program: rotate the padded domain
    ``(1, J, K) -> (J, 1, K)`` (``frontend.canonicalize.rotate_2d_to_rows``)
    and stream rows through a 3-D lowering — ``backend`` "group" (groups
    of ``group`` stages, panel size ``panel``, 0 = auto), "panel",
    "overlap", "stream", or "auto" (``compile_chain_best`` of the rotated
    program).  Returns ``(fn, "rows+<lowering>")``, ``fn`` giving outputs
    at the program's raw (J, K); raises ValueError when the program is
    not 2-D or the lowering refuses it.  ``panel`` is the group kernel's
    B only; ``mxu``/``mxu_precision``/``spill`` forward to the stream
    lowering.  ``ring_storage="bfloat16"`` (bf16 rings, f32 compute)
    takes the stream, panel or group lowering and is refused with any
    other, as the JAX package refuses it."""
    rot = rotate_2d_to_rows(program)
    if panel and backend != "group":
        raise ValueError("panel= sets the group kernel's B "
                         "(backend='group')")
    if ring_storage != "off" and backend not in ("stream", "panel",
                                                 "group"):
        raise ValueError(
            "ring_storage requires the stream, panel or group rows "
            "lowering (pass backend='stream'/'panel'/'group'); refusing to "
            "silently measure an f32 kernel")
    if backend == "group":
        fn, name = (compile_chain_group(rot, panel=panel, group=group,
                                        device=device,
                                        ring_storage=ring_storage),
                    f"group_g{group}")
    elif backend == "panel":
        fn, name = (compile_chain_panel(rot, device=device,
                                        ring_storage=ring_storage), "panel")
    elif backend == "overlap":
        fn, name = compile_chain_overlap(rot, device=device), "overlap"
    elif backend == "stream":
        fn, name = (compile_chain_stream(rot, mxu=mxu,
                                         mxu_precision=mxu_precision,
                                         device=device, spill=spill,
                                         ring_storage=ring_storage),
                    "stream")
    elif backend == "auto":
        fn, name = compile_chain_best(rot, device=device, mxu=mxu,
                                      mxu_precision=mxu_precision,
                                      spill=spill)
    else:
        raise ValueError(f"unknown rows backend {backend!r} (choose from "
                         "auto, group, panel, overlap, stream)")
    raw = program.raw_dimensions

    def forward(inputs):
        return {o: v.reshape(raw) for o, v in fn(inputs).items()}

    forward.last_config = getattr(fn, "last_config", {})
    return forward, "rows+" + name


__all__ = ["chain_halo", "choose_backend", "compile_chain",
           "compile_chain_best", "compile_chain_group", "compile_chain_rows",
           "compile_chain_stream", "compile_chain_tile", "route_source"]

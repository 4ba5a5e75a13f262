"""Per-block planning of a decomposed domain: the single-block part.

Port of the pieces of ``stencilflow_tpu/parallel/domain.py`` that a block
with no mesh needs — the ``DomainDecomposition`` carrier and the per-block
stream chooser ``plan_local_stream`` — which the out-of-core chunks
(``outofcore.py``) run.  The mesh, the halo exchange and the sharded
chain (``compile_sharded_chain``) are not ported yet; they extend this
module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .. import ir
from ..frontend.analysis import ChainAnalysis

Vec3 = Tuple[int, int, int]


@dataclasses.dataclass
class DomainDecomposition:
    """Static plan of one program's domain in blocks.

    ``dim_axes[d]`` is the mesh axis dim ``d`` is split over (None: the
    block spans it whole).  ``halo`` is the effective i/j/k halo each
    block carries, ``block`` a block's core extents.  Without a mesh
    (``mesh=None``, all axes None) it describes the one block of an
    out-of-core chunk, whose i-halo arrives with the host slab."""
    program: ir.Program
    mesh: object
    dim_axes: Tuple[Optional[str], Optional[str], Optional[str]]
    halo: Vec3
    block: Vec3


def plan_local_stream(program: ir.Program, analysis: ChainAnalysis,
                      plan: DomainDecomposition, mxu: str = "auto",
                      mxu_precision: str = "split", spill: str = "auto",
                      smem_budget: Optional[int] = None):
    """Choose the per-block streaming kernel (K4) for a local block of
    ``plan.block`` with i-halo ``plan.halo[0]``.

    Candidate order, as the reference's rescue: the block with banded
    stages (uncomposed), then every stage per cell, then (``spill="auto"``)
    every stage per cell with rings spilled to device memory (K3c).
    Outputs may spill here: the kernel writes core planes directly, not
    through their ring.  The (j, k) tile is the port's own choice within
    each candidate (the reference's j-tiles); ``smem_budget`` is the
    shared memory a block may take (``H100_SMEM_PER_BLOCK`` by default).
    Returns ``(stream_plan, config)``, ``config`` with the reference's
    keys (``backend``, ``jtiles``, ``mxu_stages``, ``spilled``), or None
    when the program is out of the kernel's scope or no candidate fits
    (the caller then takes the dense tile body, as the reference takes
    its fused-XLA one)."""
    from ..config import H100_SMEM_PER_BLOCK
    from ..backend.stream import check_options, check_spill, plan_local
    check_options(mxu, mxu_precision)   # raised, never re-routed
    check_spill(spill)
    budget = H100_SMEM_PER_BLOCK if smem_budget is None else smem_budget
    legs = [("auto", "off")] if mxu != "off" else []
    legs += [("off", "off")] + ([("off", spill)] if spill != "off" else [])
    for leg, leg_spill in legs:
        try:
            splan = plan_local(program, analysis, plan.block[0],
                               plan.halo[0], mxu=leg,
                               mxu_precision=mxu_precision,
                               smem_budget=budget, spill=leg_spill)
        except (ValueError, NotImplementedError):
            continue
        if leg == "auto" and not splan.mxu_plans:
            continue   # no banded stage: the same as the per-cell leg
        return splan, {"backend": "stream", "jtiles": 1,
                       "mxu_stages": sorted(splan.mxu_plans),
                       "spilled": sorted(splan.spilled)}
    return None

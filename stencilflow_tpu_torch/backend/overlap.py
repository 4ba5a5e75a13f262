"""Overlap streamer: a stateless whole-chain kernel for shallow chains.

Hopper counterpart of ``stencilflow_tpu/backend/overlap.py``
(``_overlap_kernel_body``, built by ``compile_chain_overlap``).  The TPU
kernel keeps a ring only for each streamed input and recomputes every
stage per grid step over an i-overlapped block.  Here nothing is carried
at all: each thread block owns one 3-D core tile (ti, tj, tk), loads the
streamed inputs' halo-widened tile into shared memory, evaluates the
stages over shrinking regions (each intermediate in shared memory) and
writes the core.  The regions come from the reference's ``_chain_needs``
algebra applied in all three dims (``chain_needs3``); boundary
conditions follow the same rules as the panel kernel.

What bounds it on the H100: device-memory bytes, inflated by the halo —
the input tile is read with it, (t + lo + hi) / t per dim, which only
shallow chains keep small (jacobi3d 512^3 x 2 runs at about a quarter of
its HBM bound) — and shared memory per block, which holds every widened
intermediate and so caps the tile.  The planner picks the tile that
minimizes waves x per-block work under the 227 KB cap, and raises
ValueError when none fits.

``overlap_plain`` runs the same tiles from the same plan in torch ops,
all tiles at once; the wrapper ``run_overlap`` uses it for CPU tensors
only and launches the CUDA kernel (codegen.py) for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import H100_SMEM_PER_BLOCK
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .stacked_io import (accesses_with_center, bc_select,
                         check_scope, gather_global, or_mask,
                         resolve_device, run_kernel,
                         spanned_arrays, wave_cost)
from .tile_eval import eval_kernel_statements

# number of kernel launches (CUDA tensors only)
launches = 0

Extent = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _chain_needs(program: ir.Program, analysis: ChainAnalysis
                 ) -> Dict[str, Tuple[int, int]]:
    """Per-field i-extents (need_lo, need_hi) of the reference's overlap
    kernel, j offsets adding one plane of slack (its folded-row reads).
    Copied unchanged: compile_chain_best's shallow-chain policy reads it,
    so the port picks overlap exactly where the reference does."""
    needs: Dict[str, Tuple[int, int]] = {}
    for o in program.outputs:
        needs[o] = (0, 0)
    for kname in reversed(list(analysis.graph.kernel_order)):
        lo_c, hi_c = needs.get(kname, (0, 0))
        needs.setdefault(kname, (lo_c, hi_c))
        kspec = program.kernels[kname]
        accs = dict(kspec.accesses())
        for f, bc in kspec.boundary_conditions.items():
            if bc.kind == ir.BCKind.COPY:
                accs.setdefault(f, ())
                accs[f] = tuple(accs[f]) + ((0, 0, 0),)
        for f, alist in accs.items():
            lo_f, hi_f = needs.get(f, (0, 0))
            for a in alist:
                oi = a[0] or 0
                oj = a[1] or 0
                lo_f = max(lo_f, lo_c - oi + (1 if oj < 0 else 0))
                hi_f = max(hi_f, hi_c + oi + (1 if oj > 0 else 0))
            needs[f] = (lo_f, hi_f)
    return needs


def shallow_extent(program: ir.Program, analysis: ChainAnalysis) -> int:
    """H of the reference's policy: the largest cumulative i-extent of an
    i-spanning (ring-backed) input."""
    needs = _chain_needs(program, analysis)
    return max((max(lo, hi) for f, (lo, hi) in needs.items()
                if f in program.inputs
                and not program.inputs[f].is_scalar
                and program.inputs[f].dim_mask[0]), default=0)


def chain_needs3(program: ir.Program, analysis: ChainAnalysis
                 ) -> Dict[str, Extent]:
    """Per-field ((lo, hi) per dim): the cells of field f around a core
    tile that every transitive consumer's core needs — the reverse
    topological transpose of the lag algebra, in all three dims."""
    zero = ((0, 0), (0, 0), (0, 0))
    needs: Dict[str, list] = {}
    for kname in reversed(list(analysis.graph.kernel_order)):
        nc = needs.setdefault(kname, [list(e) for e in zero])
        for f, alist in accesses_with_center(program.kernels[kname]).items():
            nf = needs.setdefault(f, [list(e) for e in zero])
            for a in alist:
                for d in range(3):
                    o = a[d] or 0
                    nf[d][0] = max(nf[d][0], nc[d][0] - o)
                    nf[d][1] = max(nf[d][1], nc[d][1] + o)
    return {f: tuple(tuple(e) for e in v) for f, v in needs.items()}


@dataclasses.dataclass
class OverlapPlan:
    needs: Dict[str, Extent]         # per field: (lo, hi) per dim
    onchip: Tuple[str, ...]          # fields held in shared memory
    tile: Tuple[int, int, int]       # core (ti, tj, tk)

    @classmethod
    def build(cls, analysis: ChainAnalysis,
              tile: Optional[Tuple[int, int, int]] = None) -> "OverlapPlan":
        program = analysis.program
        check_scope(program)
        needs = chain_needs3(program, analysis)
        read = {f for k in program.kernels
                for f in program.kernels[k].accesses()}
        onchip = tuple(
            [n for n, s in program.inputs.items()
             if all(s.dim_mask) and n in read]
            + [k for k in analysis.graph.kernel_order if k in read])
        plan = cls(needs, onchip, (0, 0, 0))
        if tile is not None:
            plan.tile = tuple(tile)
            if plan.smem_bytes(program) > H100_SMEM_PER_BLOCK:
                raise ValueError(f"overlap tile {tile} exceeds shared "
                                 "memory")
            return plan
        dims = program.dimensions
        caps = [max(1, 1 << math.ceil(math.log2(max(1, n)))) for n in dims]
        best = None
        for cand in [(ti, tj, tk) for ti in (1, 2, 4, 8, 16, 32)
                     for tj in (1, 2, 4, 8, 16, 32)
                     for tk in (8, 16, 32, 64, 128)
                     if ti <= caps[0] and tj <= caps[1]
                     and tk <= max(8, caps[2])]:
            plan.tile = cand
            smem = plan.smem_bytes(program)
            if smem > H100_SMEM_PER_BLOCK:
                continue
            work = sum(math.prod(plan.region(f)) for f in
                       list(program.kernels) + [f for f in onchip
                                                if f in program.inputs])
            n_blocks = math.prod(plan.grid(dims))
            cost = (wave_cost(n_blocks, smem, work), -math.prod(cand))
            if best is None or cost < best[0]:
                best = (cost, cand)
        if best is None:
            raise ValueError("overlap tiles exceed shared memory at every "
                             "tile size")
        plan.tile = best[1]
        return plan

    def region(self, f: str) -> Tuple[int, int, int]:
        return tuple(t + lo + hi for t, (lo, hi)
                     in zip(self.tile, self.needs[f]))

    def smem_offsets(self, program: ir.Program) -> Dict[str, int]:
        """Byte offset of each on-chip field in the block's shared memory."""
        off, out = 0, {}
        for f in self.onchip:
            out[f] = off
            size = math.prod(self.region(f)) * np.dtype(
                program.field_dtype(f)).itemsize
            off += -(-size // 16) * 16
        out[""] = off
        return out

    def smem_bytes(self, program: ir.Program) -> int:
        return self.smem_offsets(program)[""]

    def grid(self, dims) -> Tuple[int, int, int]:
        return tuple(-(-n // t) for n, t in zip(dims, self.tile))


def overlap_plain(program: ir.Program, analysis: ChainAnalysis,
                  plan: OverlapPlan, arrays: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The kernel's tiles in torch ops, all at once: each field's region
    is a (nti, ntj, ntk, Ei, Ej, Ek) tensor.  ``arrays`` holds every input
    at its spanned shape (0-d for scalars); returns (I, J, K) outputs."""
    dims = program.dimensions
    grid = plan.grid(dims)
    device = next(a for n, a in arrays.items()
                  if not program.inputs[n].is_scalar).device
    order = analysis.graph.kernel_order
    last = {f: idx for idx, k in enumerate(order)
            for f in program.kernels[k].accesses()}

    def coords(f):
        out = []
        for d in range(3):
            lo = plan.needs[f][d][0]
            E = plan.region(f)[d]
            g = (torch.arange(grid[d], device=device)[:, None]
                 * plan.tile[d] - lo
                 + torch.arange(E, device=device)[None, :])
            shape = [1] * 6
            shape[d], shape[3 + d] = grid[d], E
            out.append(g.reshape(shape))
        return out

    vals: Dict[str, torch.Tensor] = {}
    for f in plan.onchip:
        if f in program.inputs:
            vals[f] = gather_global(arrays[f], (True, True, True),
                                    coords(f), dims)
    outs = {}
    for idx, s in enumerate(order):
        kspec = program.kernels[s]
        gs = coords(s)
        E = plan.region(s)

        def read(field, offsets, kspec=kspec, s=s, gs=gs, E=E):
            dt = np.dtype(program.field_dtype(field))
            bc = kspec.boundary_conditions.get(field)
            if field in program.inputs and program.inputs[field].is_scalar:
                return arrays[field].to(device), dt
            offs = [o or 0 for o in offsets]
            mask = None
            for d in range(3):
                if offs[d]:
                    t = gs[d] + offs[d]
                    mask = or_mask(mask, (t < 0) | (t >= dims[d]))
            if field in plan.onchip:
                def at(o, field=field):
                    sl = tuple(
                        slice(plan.needs[field][d][0] - plan.needs[s][d][0]
                              + o[d], plan.needs[field][d][0]
                              - plan.needs[s][d][0] + o[d] + E[d])
                        for d in range(3))
                    return vals[field][(Ellipsis,) + sl]
                return bc_select(bc, dt, mask, at(offs),
                                 lambda: at((0, 0, 0))), dt
            spec = program.inputs[field]
            val = gather_global(arrays[field], spec.dim_mask,
                                [g + o for g, o in zip(gs, offs)], dims)
            return bc_select(bc, dt, mask, val, lambda: gather_global(
                arrays[field], spec.dim_mask, gs, dims)), dt

        val = eval_kernel_statements(kspec, read, tuple(grid) + E, device)
        if s in plan.onchip:
            vals[s] = val
        if s in program.outputs:
            sl = tuple(slice(plan.needs[s][d][0],
                             plan.needs[s][d][0] + plan.tile[d])
                       for d in range(3))
            core = val[(Ellipsis,) + sl].permute(0, 3, 1, 4, 2, 5)
            outs[s] = core.reshape(tuple(
                n * t for n, t in zip(grid, plan.tile)))[
                :dims[0], :dims[1], :dims[2]].contiguous()
        for f in [f for f in vals if last.get(f, -1) <= idx]:
            del vals[f]   # no later stage reads it
    return {o: outs[o] for o in program.outputs}


def build_overlap(program: ir.Program, analysis: ChainAnalysis,
                  plan: OverlapPlan):
    """Generate and compile the overlap kernel for ``plan``."""
    return build.load_library(
        codegen.overlap_source(program, analysis, plan), "overlap")


def run_overlap(program: ir.Program, analysis: ChainAnalysis,
                plan: OverlapPlan, arrays: Dict[str, torch.Tensor],
                lib=None):
    """The overlap kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_overlap``); it is built on demand
    when omitted."""
    global launches
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_overlap(program, analysis,
                                                          plan),
        lambda: overlap_plain(program, analysis, plan, arrays))
    launches += launched
    return outs


def compile_chain_overlap(program: ir.Program,
                          analysis: Optional[ChainAnalysis] = None,
                          tile: Optional[Tuple[int, int, int]] = None,
                          device="cuda"):
    """Plan the overlap kernel (ValueError / NotImplementedError when the
    program is out of its scope) and, for a CUDA ``device``, build it.
    Returns ``fn(inputs) -> outputs`` at the program's raw dims on
    ``device`` (inputs are moved there), with the plan as ``fn.plan``."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = OverlapPlan.build(analysis, tile)
    device = resolve_device(device)
    lib = build_overlap(program, analysis, plan) if device.type == "cuda" \
        else None

    def forward(inputs):
        arrays = spanned_arrays(program, inputs, device=device)
        outs = run_overlap(program, analysis, plan, arrays, lib)
        return {o: v.reshape(program.raw_dimensions)
                for o, v in outs.items()}

    forward.plan = plan
    return forward

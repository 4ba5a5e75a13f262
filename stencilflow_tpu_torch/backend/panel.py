"""Panel streamer: the whole chain in one launch, streamed along i.

Hopper counterpart of ``stencilflow_tpu/backend/panel.py``
(``_panel_kernel_body``, built by ``compile_chain_panel``): every stage of
the chain is evaluated in one kernel and intermediates never touch
device memory.  The TPU kernel walks i on a sequential grid with whole
(J, K) planes in VMEM; an SM has 227 KB of shared memory, so here each
thread block owns one (tj, tk) core tile of the (j, k) plane, widened by
each field's cumulative j/k halo, and marches i itself:

* step t loads plane t of every streamed input into its ring, then
  evaluates every live stage s for its lagged plane q = t - lag(s);
* each field keeps a ring of its own tile's planes in shared memory;
  lags and ring depths are the reference's lag algebra
  (``PanelPlan.build``) at panel size B = 1, where each read touches one
  plane, so a ring is ``lag(c) - lag(f) - oi + 1`` planes deep;
* a stage's tile shrinks by its downstream halo, so the ring reads of a
  tile never leave it, and boundary conditions come from global
  coordinates (constant fill / shrink JUNK_VAL / copy centre under one
  union mask — the rule of tile_eval.py);
* lower-rank inputs are read from device memory, scalars are kernel
  arguments.

What bounds it on the H100: not device-memory bytes yet (jacobi3d 512^3
x 8 runs at about a twentieth of its HBM bound) but issue and latency
inside the block: a __syncthreads() after every stage of every plane
step, index and boundary arithmetic on every read, the halo recompute of
the widened tiles, and only 1-2 resident blocks per SM, because the
rings take most of the 227 KB of shared memory a block may use.  Shared
memory is the design's hard limit: the planner reckons the ring bytes
per tile, picks the tile that minimizes waves x per-block work under the
cap, and raises ValueError when none fits.  Making it fast (more warps
per SM, TMA loads, i-segments to fill 132 SMs, register blocking) is
later work.

``panel_plain`` runs the same schedule from the same plan in torch ops,
all tiles at once; the wrapper ``run_panel`` uses it for CPU tensors
only, and launches the CUDA kernel (codegen.py) for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import H100_SMEM_PER_BLOCK
from ..dtypes import to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .stacked_io import (accesses_with_center, bc_select,
                         check_scope, gather_global, or_mask,
                         resolve_device, run_kernel,
                         spanned_arrays, wave_cost)
from .tile_eval import eval_kernel_statements

# number of kernel launches (CUDA tensors only)
launches = 0


def ring_fields(program: ir.Program, analysis: ChainAnalysis):
    """Fields kept on chip: full-rank inputs and kernels that some kernel
    reads, inputs first (program order), then kernels (chain order)."""
    graph = analysis.graph
    read = {f for k in program.kernels for f in program.kernels[k].accesses()}
    ins = [n for n, s in program.inputs.items()
           if all(s.dim_mask) and n in read]
    return ins + [k for k in graph.kernel_order if k in read]


def tile_candidates(dims):
    """(tj, tk) core tiles to try, capped near the plane size."""
    cap_j = 1 << max(0, math.ceil(math.log2(max(1, dims[1]))))
    cap_k = 1 << max(0, math.ceil(math.log2(max(1, dims[2]))))
    return [(tj, tk) for tj in (1, 2, 4, 8, 16, 32, 64)
            for tk in (8, 16, 32, 64, 128, 256)
            if tj <= max(1, cap_j) and tk <= max(8, cap_k)]


@dataclasses.dataclass
class PanelPlan:
    lag: Dict[str, int]                # per field: plane lag
    ring: Dict[str, int]               # per on-chip field: ring depth
    lag_max: int
    halo: Dict[str, Tuple[int, int]]   # per field: (j, k) tile widening
    tile: Tuple[int, int]              # core (tj, tk)

    @staticmethod
    def lags(analysis: ChainAnalysis):
        """The reference's panel lag algebra at B = 1."""
        program = analysis.program
        lag = {n: 0 for n, sp in program.inputs.items()
               if not sp.is_scalar and sp.dim_mask[0]}
        for kname in analysis.graph.kernel_order:
            accs = accesses_with_center(program.kernels[kname])
            lk = 0
            for f in analysis.graph.producers(kname):
                if f not in lag:
                    continue   # static / scalar input
                hi = max(0, max(a[0] or 0 for a in accs[f]))
                lk = max(lk, lag[f] + hi)
            lag[kname] = lk
        return lag, max(lag[o] for o in program.outputs)

    @classmethod
    def build(cls, analysis: ChainAnalysis,
              tile: Optional[Tuple[int, int]] = None) -> "PanelPlan":
        program = analysis.program
        check_scope(program)
        lag, lag_max = cls.lags(analysis)
        ring: Dict[str, int] = {}
        for f in ring_fields(program, analysis):
            depth = 1
            for c in analysis.graph.consumers(f):
                if c not in program.kernels:
                    continue
                for a in accesses_with_center(program.kernels[c])[f]:
                    depth = max(depth, lag[c] - lag[f] - (a[0] or 0) + 1)
            ring[f] = depth
        stage = analysis.stage_halo()
        inp = analysis.input_halo()
        halo = {f: tuple((stage.get(f) or inp.get(f))[1:])
                for f in list(ring) + list(program.kernels)}
        plan = cls(lag, ring, lag_max, halo, (0, 0))
        ring_inputs = [f for f in ring if f in program.inputs]
        if tile is not None:
            plan.tile = tuple(tile)
            if plan.smem_bytes(program) > H100_SMEM_PER_BLOCK:
                raise ValueError(f"panel tile {tile} exceeds shared memory")
            return plan
        best = None
        dims = program.dimensions
        for cand in tile_candidates(dims):
            plan.tile = cand
            smem = plan.smem_bytes(program)
            if smem > H100_SMEM_PER_BLOCK:
                continue
            ntj, ntk = plan.grid(dims)
            work = sum(plan.region(f)[0] * plan.region(f)[1]
                       for f in list(program.kernels) + ring_inputs)
            cost = (wave_cost(ntj * ntk, smem, work), -cand[0] * cand[1])
            if best is None or cost < best[0]:
                best = (cost, cand)
        if best is None:
            raise ValueError("panel rings exceed shared memory at every "
                             "tile")
        plan.tile = best[1]
        return plan

    def region(self, f: str) -> Tuple[int, int]:
        hj, hk = self.halo[f]
        return self.tile[0] + 2 * hj, self.tile[1] + 2 * hk

    def ring_offsets(self, program: ir.Program) -> Dict[str, int]:
        """Byte offset of each ring in the block's shared memory."""
        off, out = 0, {}
        for f, depth in self.ring.items():
            out[f] = off
            tj, tk = self.region(f)
            size = depth * tj * tk * np.dtype(program.field_dtype(f)).itemsize
            off += -(-size // 16) * 16
        out[""] = off
        return out

    def smem_bytes(self, program: ir.Program) -> int:
        return self.ring_offsets(program)[""]

    def grid(self, dims) -> Tuple[int, int]:
        return -(-dims[1] // self.tile[0]), -(-dims[2] // self.tile[1])


# -- plain version ----------------------------------------------------------

def panel_plain(program: ir.Program, analysis: ChainAnalysis,
                plan: PanelPlan, arrays: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The kernel's schedule in torch ops, every tile of the plane at
    once: rings are (depth, ntj, ntk, TJ, TK) tensors.  ``arrays`` holds
    every input at its spanned shape (0-d for scalars); returns (I, J, K)
    outputs."""
    I, J, K = dims = program.dimensions
    tj, tk = plan.tile
    ntj, ntk = plan.grid(dims)
    device = next(iter(arrays.values())).device

    def coords(f):
        hj, hk = plan.halo[f]
        TJ, TK = plan.region(f)
        gj = (torch.arange(ntj, device=device)[:, None] * tj - hj
              + torch.arange(TJ, device=device)[None, :])
        gk = (torch.arange(ntk, device=device)[:, None] * tk - hk
              + torch.arange(TK, device=device)[None, :])
        return gj.reshape(ntj, 1, TJ, 1), gk.reshape(1, ntk, 1, TK)

    rings = {f: torch.zeros((d, ntj, ntk) + plan.region(f),
                            dtype=to_torch_dtype(program.field_dtype(f)),
                            device=device)
             for f, d in plan.ring.items()}
    outs = {o: torch.empty((I, J, K), device=device,
                           dtype=to_torch_dtype(program.kernels[o].dtype))
            for o in program.outputs}
    ring_inputs = [f for f in plan.ring if f in program.inputs]
    for t in range(I + plan.lag_max):
        if t < I:
            for f in ring_inputs:
                gj, gk = coords(f)
                rings[f][t % plan.ring[f]] = gather_global(
                    arrays[f], (True, True, True), (t, gj, gk), dims)
        for s in analysis.graph.kernel_order:
            q = t - plan.lag[s]
            if not 0 <= q < I:
                continue
            kspec = program.kernels[s]
            gj_s, gk_s = coords(s)
            TJ, TK = plan.region(s)

            def read(field, offsets, kspec=kspec, q=q, s=s,
                     gj_s=gj_s, gk_s=gk_s, TJ=TJ, TK=TK):
                dt = np.dtype(program.field_dtype(field))
                bc = kspec.boundary_conditions.get(field)
                if field in program.inputs and \
                        program.inputs[field].is_scalar:
                    return arrays[field].to(device), dt
                oi, oj, ok = (o or 0 for o in offsets)
                mask = None
                if oi and not 0 <= q + oi < I:
                    mask = True
                if oj:
                    mask = or_mask(mask, (gj_s + oj < 0) | (gj_s + oj >= J))
                if ok:
                    mask = or_mask(mask, (gk_s + ok < 0) | (gk_s + ok >= K))
                if field in plan.ring:
                    hj, hk = plan.halo[field]
                    dj, dk = hj - plan.halo[s][0], hk - plan.halo[s][1]

                    def at(p, oj, ok, field=field, dj=dj, dk=dk):
                        return rings[field][p % plan.ring[field], :, :,
                                            dj + oj:dj + oj + TJ,
                                            dk + ok:dk + ok + TK]
                    val = at(q + oi, oj, ok) if mask is not True else \
                        at(q, 0, 0)
                    return bc_select(bc, dt, mask, val,
                                     lambda: at(q, 0, 0)), dt
                spec = program.inputs[field]
                val = gather_global(arrays[field], spec.dim_mask,
                                    (q + oi, gj_s + oj, gk_s + ok), dims)
                return bc_select(
                    bc, dt, mask, val, lambda: gather_global(
                        arrays[field], spec.dim_mask, (q, gj_s, gk_s),
                        dims)), dt

            val = eval_kernel_statements(kspec, read, (ntj, ntk, TJ, TK),
                                         device)
            if s in plan.ring:
                rings[s][q % plan.ring[s]] = val
            if s in outs:
                hj, hk = plan.halo[s]
                core = val[:, :, hj:hj + tj, hk:hk + tk]
                outs[s][q] = core.permute(0, 2, 1, 3).reshape(
                    ntj * tj, ntk * tk)[:J, :K]
    return outs


# -- wrapper -----------------------------------------------------------------

def build_panel(program: ir.Program, analysis: ChainAnalysis,
                plan: PanelPlan):
    """Generate and compile the panel kernel for ``plan``."""
    return build.load_library(codegen.panel_source(program, analysis, plan),
                              "panel")


def run_panel(program: ir.Program, analysis: ChainAnalysis, plan: PanelPlan,
              arrays: Dict[str, torch.Tensor], lib=None):
    """The panel kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_panel``); it is built on demand
    when omitted."""
    global launches
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_panel(program, analysis,
                                                        plan),
        lambda: panel_plain(program, analysis, plan, arrays))
    launches += launched
    return outs


def compile_chain_panel(program: ir.Program,
                        analysis: Optional[ChainAnalysis] = None,
                        tile: Optional[Tuple[int, int]] = None,
                        device="cuda"):
    """Plan the panel kernel (ValueError / NotImplementedError when the
    program is out of its scope) and, for a CUDA ``device``, build it.
    Returns ``fn(inputs) -> outputs`` at the program's raw dims on
    ``device`` (inputs are moved there), with the plan as ``fn.plan``."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = PanelPlan.build(analysis, tile)
    device = resolve_device(device)
    lib = build_panel(program, analysis, plan) if device.type == "cuda" \
        else None

    def forward(inputs):
        arrays = spanned_arrays(program, inputs, device=device)
        outs = run_panel(program, analysis, plan, arrays, lib)
        return {o: v.reshape(program.raw_dimensions)
                for o, v in outs.items()}

    forward.plan = plan
    return forward

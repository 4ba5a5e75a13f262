"""Overlapped-tile lowering: the whole chain on one 3-D tile per block.

Hopper counterpart of ``stencilflow_tpu/backend/pallas.py`` (K6:
``_kernel_body``, ``_fast_kernel_body`` and ``_shell_fixup``, built by
``compile_chain_pallas``, tiles by ``plan_tiles``), the last kernel rung
of the ladder before ``dense`` and ``run --backend tile``.  Each thread
block owns one core tile (ti, tj, tk) of the domain: the full-rank
inputs' tiles widened by the chain halo H are loaded into shared memory
(zero beyond the domain), every stage is evaluated over its tile widened
by its stage halo (``fast_tile.field_margins``), in chain order, and the
core cells inside the domain are written out.  Nothing streams and
nothing is carried between blocks.

* Boundary conditions.  ``mode="masked"`` (the reference's ``"auto"``)
  applies each read's boundary condition from global coordinates in
  every block, as every other kernel of the port does.  ``mode="fast"``
  (the port's ``"auto"``, ``AUTO_MODE``: faster on both measured cells)
  reads mask-free in the blocks whose widened tile
  lies inside the domain (no read there leaves it) and masked in the
  others, which so compute the H-wide border shell exactly: one launch,
  with no fix-up after it.  The reference reads mask-free everywhere and
  overwrites the shell with an exact evaluation in XLA (``_shell_fixup``);
  the plain version of fast mode (``tile_plain``) keeps that form
  (``shell_fixup``, ``tile_eval.evaluate_chain_tile`` on the shell's
  slabs), so the kernel's one launch is held to it.
* Edge tiles.  A tile that overhangs the domain is masked (its loads
  read zero, its writes are dropped); the reference pads the domain to a
  multiple of the tile instead.
* Shared memory.  Stage buffers are placed by liveness: a buffer is
  allocated (first fit) when its stage runs and freed after its last
  reader, so the footprint is the peak of live widened tiles (the
  reference's peak live-field count).  ``plan_tile`` is the H100's own
  tile choice — every (ti, tj, tk) whose footprint fits ``smem_budget``
  (227 KB by default), priced in seconds by ``TilePlan.seconds`` (the
  panel kernel's rule: its sweep of K6's candidates found the older
  cell-count rule's hdiff3d 256^3 x 8 pick 38 % slower than the fastest
  tile, this rule's pick the fastest on both swept cells) — not the
  TPU's (8, 128) lane shapes; it raises ValueError when no tile fits
  (deep chains such as hdiff3d x 16 widen beyond a block: those belong
  to the stream kernel's spill rung).

What bounds it on the H100: device-memory bytes, inflated by the halo —
each input tile is read with (t + 2H) / t per dim — and the halo
recompute of every stage over its widened tile, which only shallow
chains keep small.  It streams nothing along i; even so, in fast mode
it ran jacobi3d 512^3 x 2 in 0.895 ms against the overlap kernel's 1.201
and hdiff3d 256^3 x 8 in 2.816 against the panel kernel's 4.123 on an
NVIDIA H100 80GB HBM3 (700 W, ``chip_smoke.py``'s routes), which the
ladder, the reference's, does not yet use (PERF.md); the overlap
kernel's redesign since runs the jacobi cell in 0.495 ms against this
kernel's 0.864 (an H100 80GB HBM3 at 700 W).  The kernel's
design (the panel kernel's skeleton): inputs loaded by ``cp.async``
zero-filled beyond the domain, a thread's first cell of each region from
one division and constant steps after it, every read one shared-memory
load at a constant offset from the thread's cell.

``tile_plain`` is the plain version: all tiles at once in torch ops under
the same plan, masked (``overlap_plain``'s tile evaluator on these
symmetric margins) or mask-free (``fast_tile.evaluate_chain_fast``) with
the same shell fix-up.  The wrapper ``run_tile`` takes it for CPU tensors
only, and launches the CUDA kernel (codegen.py ``tile_source``) for CUDA
tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import (H100_ASYNC_COPY_SHARE, H100_COPY_FLOOR,
                      H100_PANEL_CELL_RATE, H100_SM_COUNT,
                      H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM)
from ..dtypes import to_numpy
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .dense import chain_halo
from .fast_tile import evaluate_chain_fast, field_margins
from .overlap import overlap_plain
from .panel import PANEL_LANE_COST
from .stacked_io import (THREADS, check_scope, gather_global, launch_mode,
                         resolve_device, run_kernel, spanned_arrays)
from .tile_eval import evaluate_chain_tile

# kernel launches (CUDA tensors only) by mode (stacked_io.launch_mode):
# "exact", or "narrow" for a program typed bfloat16 or float16
launches_by = collections.Counter()

Vec3 = Tuple[int, int, int]

# a CUDA grid's y extent: the kernel runs nti * ntj blocks along y
_MAX_GRID_Y = 65535
# the mode ``mode="auto"`` takes: on an NVIDIA H100 80GB HBM3 (700 W),
# deep_time.py --cells tile in turns with the masked kernel ran fast mode
# (one launch, mask-free interior blocks) in 0.922-0.925 ms against
# 1.217-1.219 on jacobi3d 512^3 x 2 and 3.938-3.943 against 4.136 on
# hdiff3d 256^3 x 8, both bit-equal to dense
AUTO_MODE = "fast"


@dataclasses.dataclass
class TilePlan:
    program: ir.Program
    analysis: ChainAnalysis
    halo: Vec3                       # the chain halo H
    margin: Dict[str, Vec3]          # per field: widening each side
    onchip: Tuple[str, ...]          # fields held in shared memory
    tile: Vec3 = (0, 0, 0)           # core (ti, tj, tk)
    mode: str = "masked"             # "masked" or "fast"

    @property
    def needs(self) -> Dict[str, tuple]:
        """Per field ((lo, hi) per dim), the form ``overlap_plain``
        reads."""
        return {f: tuple((m, m) for m in v) for f, v in self.margin.items()}

    def region(self, f: str) -> Vec3:
        return tuple(t + 2 * m for t, m in zip(self.tile, self.margin[f]))

    def grid(self, dims=None) -> Vec3:
        dims = dims or self.program.dimensions
        return tuple(-(-n // t) for n, t in zip(dims, self.tile))

    def smem_offsets(self) -> Dict[str, int]:
        """Byte offset of each on-chip field's buffer, placed by liveness
        (first fit; a stage's buffer is allocated before the buffers its
        last reads free); "" = total."""
        program = self.program
        order = self.analysis.graph.kernel_order
        last = {f: idx for idx, k in enumerate(order)
                for f in program.kernels[k].accesses()}
        live, out = [], {}

        def alloc(f):
            size = math.prod(self.region(f)) * np.dtype(
                program.field_dtype(f)).itemsize
            size = -(-size // 16) * 16
            pos = 0
            for off, sz, _ in sorted(live):
                if off - pos >= size:
                    break
                pos = max(pos, off + sz)
            live.append((pos, size, f))
            out[f] = pos

        for f in self.onchip:
            if f in program.inputs:
                alloc(f)
        end = max((off + sz for off, sz, _ in live), default=0)
        for idx, k in enumerate(order):
            if k in self.onchip:
                alloc(k)
                end = max(end, out[k] + live[-1][1])
            live[:] = [x for x in live if last[x[2]] > idx]
        out[""] = end
        return out

    def smem_bytes(self) -> int:
        return self.smem_offsets()[""]

    def lanes(self) -> int:
        """Thread-evaluations of a block: every stage's region and the
        on-chip input tiles' loads, in passes of THREADS cells (idle lanes
        of a last pass included)."""
        fields = list(self.program.kernels) + [
            f for f in self.onchip if f in self.program.inputs]
        return sum(-(-math.prod(self.region(f)) // THREADS) * THREADS
                   for f in fields)

    def residency(self) -> int:
        """Blocks resident per SM: the threads', the shared memory's and
        the grid's limit."""
        return max(1, min(2048 // THREADS,
                          H100_SMEM_PER_SM // (self.smem_bytes() + 1024),
                          -(-math.prod(self.grid()) // H100_SM_COUNT)))

    def seconds(self) -> float:
        """The tile rule, a model in seconds (``PanelPlan.seconds``'s, one
        step): every SM issues the lanes of its share of the blocks at
        ``H100_PANEL_CELL_RATE``, scaled by ``PANEL_LANE_COST`` at the
        plan's residency; the input tiles (halo included) stream at
        ``H100_ASYNC_COPY_SHARE`` of the copy floor beside the outputs;
        the larger term counts."""
        program, per_sm = self.program, self.residency()
        blocks = math.prod(self.grid())
        compute = self.lanes() * blocks / H100_SM_COUNT * PANEL_LANE_COST[
            min(per_sm, 4), THREADS] / H100_PANEL_CELL_RATE
        moved = blocks * sum(
            math.prod(self.region(f)) * np.dtype(
                program.field_dtype(f)).itemsize
            for f in self.onchip if f in program.inputs) + sum(
            math.prod(program.dimensions) * np.dtype(
                program.kernels[o].dtype).itemsize for o in program.outputs)
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return max(compute, moved / (H100_COPY_FLOOR * share))


def tile_candidates(dims) -> list:
    """(ti, tj, tk) core tiles to try, capped near the domain's size."""
    caps = [max(1, 1 << math.ceil(math.log2(max(1, n)))) for n in dims]
    return [(ti, tj, tk) for ti in (1, 2, 4, 8, 16, 32)
            for tj in (1, 2, 4, 8, 16, 32)
            for tk in (8, 16, 32, 64, 128)
            if ti <= caps[0] and tj <= caps[1] and tk <= max(8, caps[2])]


def plan_tile(program: ir.Program, analysis: Optional[ChainAnalysis] = None,
              tile: Optional[Vec3] = None, mode: str = "masked",
              smem_budget: int = H100_SMEM_PER_BLOCK) -> TilePlan:
    """The overlapped-tile plan: ``tile`` or the tile of least modelled
    time (``TilePlan.seconds``) whose live buffers fit ``smem_budget``.
    Raises ValueError / NotImplementedError when the program is out of
    scope or no tile fits."""
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    if mode not in ("masked", "fast"):
        raise ValueError(f"tile mode must be 'masked' or 'fast', got "
                         f"{mode!r}")
    halo = chain_halo(analysis)
    read = {f for k in program.kernels.values() for f in k.accesses()}
    onchip = tuple(
        [n for n, s in program.inputs.items() if all(s.dim_mask) and n in read]
        + [k for k in analysis.graph.kernel_order if k in read])
    plan = TilePlan(program, analysis, halo, field_margins(analysis, halo),
                    onchip, mode=mode)
    dims = program.dimensions

    def fits(cand) -> bool:
        plan.tile = tuple(cand)
        nti, ntj, _ = plan.grid()
        return (plan.smem_bytes() <= smem_budget
                and nti * ntj <= _MAX_GRID_Y)

    if tile is not None:
        if not fits(tile):
            raise ValueError(f"overlapped tile {tuple(tile)} exceeds shared "
                             "memory")
        return plan
    best = None
    for cand in tile_candidates(dims):
        if not fits(cand):
            continue
        cost = (plan.seconds(), -math.prod(cand))
        if best is None or cost < best[0]:
            best = (cost, cand)
    if best is None:
        raise ValueError("overlapped tiles exceed shared memory at every "
                         "tile size")
    plan.tile = best[1]
    return plan


# -- plain version ---------------------------------------------------------------

def _windows(plan: TilePlan, arrays: Dict[str, torch.Tensor], grid, device):
    """Every array input's widened tiles, (nti, ntj, ntk, Ei, Ej, Ek)
    (lower-rank inputs broadcast), zero beyond the domain."""
    dims = plan.program.dimensions
    out = {}
    for n, spec in plan.program.inputs.items():
        if spec.is_scalar:
            out[n] = arrays[n]
            continue
        E = plan.region(n)
        coords = []
        for d in range(3):
            g = (torch.arange(grid[d], device=device)[:, None] * plan.tile[d]
                 - plan.margin[n][d]
                 + torch.arange(E[d], device=device)[None, :])
            shape = [1] * 6
            shape[d], shape[3 + d] = grid[d], E[d]
            coords.append(g.reshape(shape))
        out[n] = gather_global(arrays[n], spec.dim_mask, coords, dims).expand(
            tuple(grid) + E)
    return out


def shell_fixup(plan: TilePlan, arrays: Dict[str, torch.Tensor],
                outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Overwrite the H-wide border shell of each (I, J, K) output in
    ``outs`` with the exact (BC-masked) evaluation of the shell's slabs
    (the reference's ``_shell_fixup``)."""
    program, halo = plan.program, plan.halo
    dims = program.dimensions
    graph = plan.analysis.graph
    device = next(iter(outs.values())).device
    for d in range(3):
        if halo[d] == 0:
            continue
        thick = min(halo[d], dims[d])
        for side in (0, 1):
            start = [0, 0, 0]
            size = list(dims)
            start[d] = 0 if side == 0 else dims[d] - thick
            size[d] = thick
            coords = []
            for e in range(3):
                shape = [1, 1, 1]
                shape[e] = size[e] + 2 * halo[e]
                coords.append((torch.arange(shape[e], device=device)
                               + start[e] - halo[e]).reshape(shape))
            windows = {}
            for n, spec in program.inputs.items():
                if spec.is_scalar:
                    windows[n] = arrays[n]
                    continue
                win = gather_global(arrays[n], spec.dim_mask, coords, dims)
                windows[n] = win.reshape(tuple(
                    size[e] + 2 * halo[e] for e in range(3)
                    if spec.dim_mask[e]))
            exact = evaluate_chain_tile(program, graph, windows,
                                        tuple(start), halo)
            core = tuple(slice(halo[e], halo[e] + size[e]) for e in range(3))
            dst = tuple(slice(start[e], start[e] + size[e]) for e in range(3))
            for o in program.outputs:
                outs[o][dst] = exact[o][core]
    return outs


def tile_plain(plan: TilePlan, arrays: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The overlapped-tile lowering's function in torch ops, all tiles at
    once under ``plan``: masked, or mask-free plus the shell fix-up.
    ``arrays`` holds every input at its spanned shape (0-d for scalars);
    returns (I, J, K) outputs."""
    program = plan.program
    if plan.mode == "masked":
        return overlap_plain(program, plan.analysis, plan, arrays)
    dims = program.dimensions
    grid = plan.grid()
    device = next(a for n, a in arrays.items()
                  if not program.inputs[n].is_scalar).device
    res = evaluate_chain_fast(plan.analysis, _windows(plan, arrays, grid,
                                                      device),
                              plan.tile, plan.margin)
    outs = {}
    for o in program.outputs:
        core = res[o].permute(0, 3, 1, 4, 2, 5).reshape(tuple(
            n * t for n, t in zip(grid, plan.tile)))
        outs[o] = core[:dims[0], :dims[1], :dims[2]].contiguous()
    return shell_fixup(plan, arrays, outs)


# -- wrapper -----------------------------------------------------------------------

def tile_source(plan: TilePlan) -> str:
    return codegen.tile_source(plan.program, plan.analysis, plan)


def build_tile(plan: TilePlan):
    """Generate and compile the overlapped-tile kernel for ``plan``."""
    return build.load_library(tile_source(plan), "tile")


def run_tile(plan: TilePlan, arrays: Dict[str, torch.Tensor], lib=None):
    """The overlapped-tile kernel on ``arrays`` (spanned shapes, scalars
    0-d): one launch in either mode.  ``lib`` is the built kernel
    (``build_tile``); it is built on demand when omitted."""
    outs, launched = run_kernel(
        plan.program, arrays,
        lambda: lib if lib is not None else build_tile(plan),
        lambda: tile_plain(plan, arrays))
    launches_by[launch_mode(plan.program)] += launched
    return outs


def compile_chain_tile(program: ir.Program,
                       analysis: Optional[ChainAnalysis] = None,
                       tile: Optional[Vec3] = None, mode: str = "auto",
                       device="cuda"):
    """Plan the overlapped-tile lowering (ValueError / NotImplementedError
    when the program is out of its scope) and, for a CUDA ``device``,
    build its kernel.  ``mode``: "masked", "fast", or "auto"
    (``AUTO_MODE``).  Returns ``fn(inputs) -> outputs`` at the program's
    raw dims on ``device``, with the plan as ``fn.plan``."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = plan_tile(program, analysis, tile,
                     AUTO_MODE if mode == "auto" else mode)
    device = resolve_device(device)
    lib = build_tile(plan) if device.type == "cuda" else None

    def forward(inputs):
        arrays = spanned_arrays(program, inputs, device=device)
        outs = run_tile(plan, arrays, lib)
        return {o: v.reshape(program.raw_dimensions)
                for o, v in outs.items()}

    forward.plan = plan
    return forward


def run_chain_tile(program: ir.Program, inputs, tile: Optional[Vec3] = None,
                   mode: str = "auto", device="cuda") -> Dict[str, np.ndarray]:
    """``compile_chain_tile`` once on ``inputs``; numpy outputs."""
    out = compile_chain_tile(program, tile=tile, mode=mode,
                             device=device)(inputs)
    return {k: to_numpy(v) for k, v in out.items()}

"""Panel streamer: the whole chain in one launch, streamed along i.

Hopper counterpart of ``stencilflow_tpu/backend/panel.py``
(``_panel_kernel_body``, built by ``compile_chain_panel``): every stage of
the chain is evaluated in one kernel and intermediates never touch
device memory.  The TPU kernel walks i on a sequential grid with whole
(J, K) planes in VMEM; an SM has 227 KB of shared memory, so here each
thread block owns one (tj, tk) core tile of the (j, k) plane, widened by
each field's cumulative j/k halo, and marches i itself:

* step t issues the ``cp.async`` loads of plane t + AHEAD of every
  streamed input (zero-filled beyond the domain) into the ring's extra
  slot, waits for plane t, then evaluates every live stage s for its
  lagged plane q = t - lag(s), a barrier after each;
* each field keeps a ring of its own tile's planes in shared memory;
  lags and ring depths are the reference's lag algebra
  (``PanelPlan.build``) at panel size B = 1, where each read touches one
  plane, so a ring is ``lag(c) - lag(f) - oi + 1`` planes deep; a ring of
  one plane whose readers all run in the step that writes it lives only
  from its producer's phase to its last reader's, and such rings share
  shared memory by liveness (``PanelPlan.ring_offsets``, first fit over
  the step's phases, as the spill rung packs its arena);
* ring slots rotate by per-step counters (t mod S), so each stage sets
  one base pointer per ring and read delta once a step, and a read is
  one shared-memory load at a constant offset from it and the thread's
  cell; a thread's first cell of a region comes from one division by a
  constant, its later ones from constant strides;
* a stage's tile shrinks by its downstream halo, so the ring reads of a
  tile never leave it, and boundary conditions come from global
  coordinates (constant fill / shrink JUNK_VAL / copy centre under one
  union mask — the rule of tile_eval.py) in a masked body of each
  stage; a block whose widest reach lies inside the (j, k) domain takes
  the mask-free body on the planes whose i reach stays inside [0, I);
* lower-rank inputs are read from device memory, scalars are kernel
  arguments.

What bounds it on the H100: issue and latency inside the block, not
device-memory bytes (jacobi3d 512^3 x 8 runs at 0.071 of its HBM bound).
Each stage ends in a barrier, so an SM's resident warps hide each
other's latency only while they are many; the shared memory of the
rings sets how many blocks fit, and the halo recompute of a tile grows
as it shrinks.  The design's answers: no index or modulo arithmetic in
a read and no boundary mask in interior blocks, input planes in flight
a step ahead, rings
of one step packed by liveness (hdiff3d 256^3 x 8 fits (16, 32) in
137 840 bytes where its rings take 366 240 unpacked), pass loops kept
rolled under ``__launch_bounds__`` (59-64 registers, where unrolled
passes took 184-240 and one block per SM), and blocks of 512 threads
where one block fills an SM.  The planner (``PanelPlan.build``) prices
each (tile, threads) in seconds (``seconds``) and raises ValueError when
no tile fits.  On an NVIDIA H100 80GB HBM3 (700 W; ``deep_time.py
--cells panel`` and ``chip_smoke.py``) jacobi3d 512^3 x 8 takes 4.53 ms
(6.17 before this design), hdiff3d 256^3 x 8 4.10 (15.9) and hotspot3d
256^3 x 8 1.12 (1.81): about 1.85 thread-evaluations per SM-cycle on
jacobi, where the shared-memory path allows some 4.6.

``ring_storage="bfloat16"`` (the reference's bf16 panel-stack storage,
f32 compute): every f32 ring rounds to bf16 (to nearest, ties to even)
where it is stored and is read back as f32; a stage's ring keeps bf16
slots, so ``plane_bytes`` and the tile rule see half its bytes (jacobi3d
512^3 x 8 then fits (32, 32) where f32 fits (16, 32)), while a ring input
keeps f32 slots: ``cp.async`` copies bytes, so each thread rounds the
cells it copied in place once the plane has landed.  Outputs are written
unrounded.  Launches count in ``launches_by["bf16"]``.

Programs typed bfloat16 or float16 (``launches_by["narrow"]``) keep
2-byte rings, and a ring input of 2-byte cells moves by ``cp.async`` in
groups, a step ahead like a float32 one: 8 cells (16 bytes) where its
k-halo is a multiple of 8, else 2 cells, its k-halo widened to a
multiple of 2 so that every group's global and shared addresses are
aligned (``copy_groups``, ``stacked_io.copy_group``; an odd K keeps the
synchronous stores).  Their stages compute in 2 bytes on the card's
bf16 / f16 instructions (codegen.py's typed emitter).  On an NVIDIA H100
80GB HBM3 (700 W; ``deep_time.py --cells narrow``) jacobi3d 512^3 x 8
typed bf16 takes 3.61 ms (6.01 with synchronous loads and a float
conversion per operation), below its float32 4.52.

``panel_plain`` runs the same schedule from the same plan in torch ops,
all tiles at once; the wrapper ``run_panel`` uses it for CPU tensors
only, and launches the CUDA kernel (codegen.py) for CUDA tensors.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import (H100_ASYNC_COPY_SHARE, H100_COPY_FLOOR,
                      H100_PANEL_CELL_RATE, H100_SM_COUNT,
                      H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM)
from ..dtypes import BFLOAT16, to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .stacked_io import (THREADS, accesses_with_center, bc_select, check_scope,
                         copy_group, gather_global, launch_mode, or_mask,
                         place_by_phase, resolve_device, round_bf16,
                         rounded_rings, run_kernel, spanned_arrays)
from .tile_eval import eval_kernel_statements

# kernel launches (CUDA tensors only) by mode (stacked_io.launch_mode):
# "exact", "bf16" (ring_storage="bfloat16") and "narrow" (a program typed
# bfloat16 or float16)
launches_by = collections.Counter()
# input planes are loaded this many plane steps ahead of the step that
# first reads them, into as many more slots of their rings
AHEAD = 1
# the thread counts a block may have, and the tile rule's cost of a lane
# at (resident blocks per SM, threads a block), relative to two blocks of
# 256 (more warps hide more of each stage's barrier and shared-memory
# latency, and one block's warps all wait at its barriers): on an NVIDIA
# H100 80GB HBM3 (700 W), python -m stencilflow_tpu_torch.sweep over the
# tiles of jacobi3d 512^3 x 8, hdiff3d and hotspot3d 256^3 x 8 ran a lane
# 1.30-1.41x as long at one block of 256 as at two, 0.855x at three,
# 0.898x at four; one block of 512 1.05x (hdiff), 1.07x (hotspot) and
# 1.28x (jacobi), two 0.98x.  For one block of 512 the rule takes 1.15,
# which ranks each sweep's fastest or second-fastest tile first.
PANEL_THREADS = (256, 512)
PANEL_LANE_COST = {(1, 256): 1.4, (2, 256): 1.0, (3, 256): 0.87,
                   (4, 256): 0.9, (1, 512): 1.15, (2, 512): 0.98}

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
    # ring inputs (loaded AHEAD planes ahead, into AHEAD more slots)
    inputs: Tuple[str, ...] = ()
    # rings of one step: (producer's phase, last reader's phase), where
    # phase 0 ingests the inputs and phase 1 + n runs the n-th stage
    span: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    planes: int = 0                    # I: planes the inputs stream
    threads: int = THREADS             # threads of a block
    # ring_storage="bfloat16": the rings that round to bf16 at their store
    # (the f32 fields of ``ring``); a stage's ring keeps bf16 slots, a
    # ring input keeps f32 slots (cp.async copies bytes), rounded in place
    # once its plane lands
    rounds: frozenset = frozenset()
    # ring inputs of 2-byte cells loaded by cp.async: cells a copy (8 or
    # 2, ``stacked_io.copy_group``; their k-halo widened to a multiple of
    # it); the other ring inputs are absent (a cell a copy)
    copy_groups: Dict[str, int] = dataclasses.field(default_factory=dict)

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
              tile: Optional[Tuple[int, int]] = None,
              threads: Optional[int] = None,
              ring_storage: str = "off") -> "PanelPlan":
        """The plan of least modelled time (``seconds``) whose packed
        shared memory fits a block, over the tiles (or at ``tile``) and
        the thread counts of ``PANEL_THREADS`` (or ``threads``), with the
        rings' ``ring_storage`` ("off" or "bfloat16")."""
        program = analysis.program
        check_scope(program)
        lag, lag_max = cls.lags(analysis)
        phase = {k: 1 + n for n, k in enumerate(analysis.graph.kernel_order)}
        ring: Dict[str, int] = {}
        span: Dict[str, Tuple[int, int]] = {}
        for f in ring_fields(program, analysis):
            depth, readers = 1, []
            for c in analysis.graph.consumers(f):
                if c not in program.kernels:
                    continue
                readers.append(phase[c])
                for a in accesses_with_center(program.kernels[c])[f]:
                    depth = max(depth, lag[c] - lag[f] - (a[0] or 0) + 1)
            ring[f] = depth
            # depth 1: every read is of the plane written in this step
            if f in program.kernels and depth == 1:
                span[f] = (phase[f], max(readers))
        stage = analysis.stage_halo()
        inp = analysis.input_halo()
        halo = {f: tuple((stage.get(f) or inp.get(f))[1:])
                for f in list(ring) + list(program.kernels)}
        groups = {}
        for f in ring:
            if f in program.inputs:
                g, hk = copy_group(np.dtype(program.field_dtype(f)).itemsize,
                                   halo[f][1], program.dimensions[2])
                if g > 1:
                    groups[f], halo[f] = g, (halo[f][0], hk)
        plan = cls(lag, ring, lag_max, halo, (0, 0),
                   tuple(f for f in ring if f in program.inputs), span,
                   program.dimensions[0],
                   rounds=rounded_rings(program, ring, ring_storage),
                   copy_groups=groups)
        tiles = [tuple(tile)] if tile is not None else \
            tile_candidates(program.dimensions)
        best = None
        for cand in tiles:
            plan.tile = cand
            if plan.smem_bytes(program) > H100_SMEM_PER_BLOCK:
                continue
            for n in (threads,) if threads else PANEL_THREADS:
                plan.threads = n
                cost = (plan.seconds(program), -cand[0] * cand[1], n)
                if best is None or cost < best[0]:
                    best = (cost, cand, n)
        if best is None:
            raise ValueError(f"panel tile {tile} exceeds shared memory"
                             if tile is not None else "panel rings exceed "
                             "shared memory at every tile")
        plan.tile, plan.threads = best[1], best[2]
        return plan

    def region(self, f: str) -> Tuple[int, int]:
        hj, hk = self.halo[f]
        return self.tile[0] + 2 * hj, self.tile[1] + 2 * hk

    def slots(self, f: str) -> int:
        """Planes of ``f``'s ring in shared memory: its depth, and AHEAD
        more for a ring input (the planes in flight)."""
        return self.ring[f] + (AHEAD if f in self.inputs else 0)

    def rounded(self, f: str) -> bool:
        return f in self.rounds

    def narrow_slots(self, f: str) -> bool:
        """Does ring ``f`` keep 2-byte slots of ``slot_dtype``?"""
        return f in self.rounds and f not in self.inputs

    # the type of the 2-byte slots and of the rounding of rounded rings
    slot_dtype = BFLOAT16

    def plane_bytes(self, f: str, program: ir.Program) -> int:
        return math.prod(self.region(f)) * (2 if self.narrow_slots(f) else
                                            np.dtype(program.field_dtype(
                                                f)).itemsize)

    def live_mask(self, f: str) -> int:
        """Phases of a step in which ring ``f`` of one step is live."""
        a, b = self.span[f]
        return sum(1 << x for x in range(a, b + 1))

    def ring_offsets(self, program: ir.Program,
                     packed: bool = True) -> Dict[str, int]:
        """Byte offset of each ring in the block's shared memory, each at
        a multiple of 16; "" = the end.  Rings read across steps (every
        ring input, every stage ring deeper than one plane) have regions
        of their own; with ``packed``, the rings of one step follow,
        placed first-fit by the phases they are live in (so two rings
        live in one phase never overlap)."""
        off, out, items = 0, {}, []
        for f in self.ring:
            size = -(-self.slots(f) * self.plane_bytes(f, program) // 16) * 16
            if packed and f in self.span:
                mask = self.live_mask(f)
                items.append((self.span[f][0], f, size, mask, mask))
            else:
                out[f] = off
                off += size
        placed, _live, _size, end = place_by_phase(items, off)
        out.update(placed)
        out[""] = end
        return out

    def smem_bytes(self, program: ir.Program) -> int:
        """Shared memory of a block: the packed layout."""
        return self.ring_offsets(program)[""]

    def unpacked_bytes(self, program: ir.Program) -> int:
        """Shared memory with every ring in a region of its own."""
        return self.ring_offsets(program, packed=False)[""]

    def grid(self, dims) -> Tuple[int, int]:
        return -(-dims[1] // self.tile[0]), -(-dims[2] // self.tile[1])

    def steps(self) -> int:
        return self.planes + self.lag_max

    def lanes(self, program: ir.Program) -> int:
        """Thread-evaluations one block issues per plane step: every
        stage's region in passes of ``threads`` cells (halo recompute and
        the idle lanes of a last pass included)."""
        n = self.threads
        return sum(-(-math.prod(self.region(s)) // n) * n
                   for s in program.kernels)

    def min_blocks(self, program: ir.Program) -> int:
        """Blocks per SM the packed shared memory leaves room for (at
        most 4): the kernel's ``__launch_bounds__`` asks for them, which
        caps its registers at 65536 / (threads x that)."""
        return max(1, min(4, 2048 // self.threads, H100_SMEM_PER_SM
                          // (self.smem_bytes(program) + 1024)))

    def residency(self, program: ir.Program) -> int:
        """Blocks resident per SM: the threads', the packed shared
        memory's and the grid's limit."""
        ntj, ntk = self.grid(program.dimensions)
        return max(1, min(2048 // self.threads,
                          H100_SMEM_PER_SM // (self.smem_bytes(program)
                                               + 1024),
                          -(-ntj * ntk // H100_SM_COUNT)))

    def seconds(self, program: ir.Program) -> float:
        """The tile rule, a model in seconds: per wave of resident
        blocks, every SM issues its blocks' lanes of every plane step at
        ``H100_PANEL_CELL_RATE``, scaled by ``PANEL_LANE_COST`` at the
        plan's resident blocks and threads (fewer warps hide less latency
        around each stage's barrier); the input planes (halo included) stream
        asynchronously at the share of the copy floor that
        ``H100_ASYNC_COPY_SHARE`` gives the plan's residency, beside the
        outputs, overlapped with the evaluations: the larger term
        counts."""
        ntj, ntk = self.grid(program.dimensions)
        per_sm = self.residency(program)
        waves = math.ceil(ntj * ntk / (H100_SM_COUNT * per_sm))
        latency = PANEL_LANE_COST[
            min(per_sm, 4 if self.threads == 256 else 2), self.threads]
        compute = self.steps() * waves * per_sm * self.lanes(program) \
            * latency / H100_PANEL_CELL_RATE
        I, J, K = program.dimensions
        moved = ntj * ntk * I * sum(self.plane_bytes(f, program)
                                    for f in self.inputs) \
            + sum(I * J * K * np.dtype(program.kernels[o].dtype).itemsize
                  for o in program.outputs)
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return max(compute, moved / (H100_COPY_FLOOR * share))

    def inner_blocks(self, program: ir.Program) -> int:
        """Blocks whose widest reach lies inside the (j, k) domain: they
        take the mask-free stage bodies on steps away from the i ends."""
        (Hj, Hk), (tj, tk) = reach(program, self), self.tile
        _, J, K = program.dimensions
        ntj, ntk = self.grid(program.dimensions)
        nj = sum(1 for b in range(ntj)
                 if b * tj - Hj >= 0 and b * tj + tj + Hj <= J)
        nk = sum(1 for b in range(ntk)
                 if b * tk - Hk >= 0 and b * tk + tk + Hk <= K)
        return nj * nk

    def masked_share(self, program: ir.Program) -> float:
        """Share of a launch's stage evaluations (block, stage, step) that
        take the masked body."""
        I = program.dimensions[0]
        ntj, ntk = self.grid(program.dimensions)
        inner = self.inner_blocks(program)
        total = masked = 0
        for s in program.kernels:
            lo, hi = i_reach(program, s)
            free = max(0, I - lo - hi)
            total += ntj * ntk * I
            masked += ntj * ntk * I - inner * free
        return masked / total


def i_reach(program: ir.Program, s: str) -> Tuple[int, int]:
    """How far stage ``s``'s offset reads reach below and above its
    plane: on planes q in [lo, I - hi) no read leaves [0, I)."""
    offs = [a[0] or 0 for f, lst in program.kernels[s].accesses().items()
            for a in lst
            if not (f in program.inputs and program.inputs[f].is_scalar)]
    return max([0] + [-o for o in offs]), max([0] + offs)


def reach(program: ir.Program, plan: PanelPlan) -> Tuple[int, int]:
    """(Hj, Hk): how far beyond the core tile any stage's cell or read
    reaches; a block whose core widened by it lies inside the (j, k)
    domain has no read to mask."""
    Hj = Hk = 0
    for s, kspec in program.kernels.items():
        hj, hk = plan.halo[s]
        Hj, Hk = max(Hj, hj), max(Hk, hk)
        for f, lst in kspec.accesses().items():
            for a in lst:
                Hj = max(Hj, hj + abs(a[1] or 0))
                Hk = max(Hk, hk + abs(a[2] or 0))
    return Hj, Hk


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
                val = gather_global(arrays[f], (True, True, True),
                                    (t, gj, gk), dims)
                rings[f][t % plan.ring[f]] = round_bf16(val) \
                    if plan.rounded(f) else val
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
                rings[s][q % plan.ring[s]] = round_bf16(val) \
                    if plan.rounded(s) else val
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


def occupancy(lib) -> int:
    """Blocks of a built panel kernel resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its shared
    memory and THREADS); raises on a CUDA error."""
    blocks = ctypes.c_int(0)
    rc = lib.sf_occupancy(ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return blocks.value


def run_panel(program: ir.Program, analysis: ChainAnalysis, plan: PanelPlan,
              arrays: Dict[str, torch.Tensor], lib=None):
    """The panel kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_panel``); it is built on demand
    when omitted."""
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_panel(program, analysis,
                                                        plan),
        lambda: panel_plain(program, analysis, plan, arrays),
        groups=plan.copy_groups)
    launches_by[launch_mode(program, bool(plan.rounds))] += launched
    return outs


def compile_chain_panel(program: ir.Program,
                        analysis: Optional[ChainAnalysis] = None,
                        tile: Optional[Tuple[int, int]] = None,
                        device="cuda", ring_storage: str = "off"):
    """Plan the panel kernel (ValueError / NotImplementedError when the
    program is out of its scope) and, for a CUDA ``device``, build it.
    Returns ``fn(inputs) -> outputs`` at the program's raw dims on
    ``device`` (inputs are moved there), with the plan as ``fn.plan``.
    ``ring_storage="bfloat16"`` rounds every f32 ring to bf16 at its
    store (f32 compute, outputs written unrounded); "off" keeps them
    exact; anything else raises ValueError."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = PanelPlan.build(analysis, tile, ring_storage=ring_storage)
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

"""Overlap streamer: a whole-chain kernel for shallow chains (K2).

Hopper counterpart of ``stencilflow_tpu/backend/overlap.py``
(``_overlap_kernel_body``, built by ``compile_chain_overlap``).  The TPU
kernel walks i on a sequential grid (``grid=(n_panels + 1,)``), keeps a
ring only for each streamed input (``VMEM((3, B*J, K))``: panels q - 1,
q, q + 1) and recomputes every stage per grid step over an i-overlapped
block; no stage value is carried from one step to the next.  The port
keeps the recompute and spreads the reference's steps over the grid, on
the panel kernel's (K1's) skeleton, with the (j, k) plane cut into
columns (an SM has 227 KB of shared memory, not a whole plane):

* one thread block per (i block of B output planes, j tile, k tile)
  loads the window of every streamed full-rank input (B + need_lo +
  need_hi planes, ``chain_needs3``, widened in j and k) by ``cp.async``,
  zero-filled beyond the domain (16-byte copies from an aligned column
  where K allows, ``vec``), and waits for it; the blocks resident on an
  SM overlap one's loads with another's stages;
* it then evaluates every stage over its i-overlapped, (j, k)-widened
  region into shared scratch placed by liveness, a barrier after each;
* each stage has a mask-free body, taken where the column's widest reach
  lies inside the (j, k) domain and the block's i reach inside [0, I)
  (``reach``, ``free_steps``), and a masked one (boundary conditions
  from global coordinates, as in the panel kernel);
* a thread walks the region's planes at a position (a run of R adjacent
  j cells, so a warp's reads stay on consecutive k): it loads the
  distinct reads of its R cells once (neighbours along the run shared),
  and with ``window`` holds the i-neighbours of each (field, j, k) read
  in registers, loading one plane of each a step (``walk_keys``): a
  6-point stage at R = 4 loads 3.5 values a cell, not 6;
* inputs that do not span all three dims, and scalars, are read from
  device memory and kernel arguments.

``OverlapPlan.build`` prices tile (B, tj, tk) x threads x runs (R,
window) in seconds (``seconds``, constants fitted by
``sweep.fit_overlap``) and takes the least, within the scope the
kernel's first port had (``scope_bytes``), so that the ladder routes as
before.  What bounds it on the H100: issue and latency inside the block,
then device-memory bytes: jacobi3d 512^3 x 2 moves 1 GiB (0.3205 ms at
3.35 TB/s).  On an NVIDIA H100 80GB HBM3 (700 W; ``deep_time.py --cells
overlap`` in turns with the kernel before this design, which loaded a
3-D tile synchronously and evaluated every cell masked) it ran jacobi3d
512^3 x 2 in 0.499-0.501 ms (1.192-1.194 before), hotspot3d 512^3 x 2 in
0.874-0.875 (2.122-2.124) and jacobi2d 8192^2 x 2 (I = 1) in
0.358-0.359 (0.627-0.629), each faster than the overlapped-tile
kernel's fast mode on the same program (0.867-0.869, 1.419-1.421,
0.566-0.571), all with runs of 4 j cells and the register window.  A
block that walks several steps of its column with its inputs in a ring
(the reference's i-walk inside one block) and runs along k were tried
and lost on all three cells: the ring's slots took shared memory and
forced a small B, and runs along k put a warp's reads R words apart
(bank conflicts).

``overlap_plain`` runs the same blocks' regions from the same plan in
torch ops, all at once; the wrapper ``run_overlap`` uses it for CPU
tensors only and launches the CUDA kernel (codegen.py ``overlap_source``)
for CUDA tensors.
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
                      H100_OVERLAP_CELL_RATE, H100_SM_COUNT,
                      H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM)
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .panel import PANEL_THREADS, i_reach
from .stacked_io import (THREADS, accesses_with_center, bc_select, check_scope,
                         gather_global, launch_mode, or_mask, resolve_device,
                         run_kernel, spanned_arrays)
from .tile_eval import eval_kernel_statements

# kernel launches (CUDA tensors only) by mode (stacked_io.launch_mode):
# "exact" and "narrow" (a program typed bfloat16 or float16)
launches_by = collections.Counter()
# the (R, window) runs a plan may take: R adjacent j cells a thread
# evaluates, the i-neighbours of its walk from registers or not; (1,
# False) is the skeleton alone
RUNS = ((1, False), (1, True), (2, True), (4, True))
# the plan rule's constants (``OverlapPlan.terms``): the cost of a lane
# at (resident blocks per SM, threads a block) relative to two blocks of
# 256, and a cost per run relative to the skeleton's (what the loads do
# not carry).  Fitted (``sweep.fit_overlap``) to the times of 576 plans
# of jacobi3d and hotspot3d 512^3 x 2 and jacobi2d 8192^2 x 2 on an
# NVIDIA H100 80GB HBM3 (700 W), RMS error 26.8 % in log time; the
# rule's picks ran within 5, 5 and 1 % of each sweep's fastest plan.
OVERLAP_LANE_COST = {(1, 256): 1.683, (2, 256): 1.0, (3, 256): 0.839,
                     (4, 256): 2.422, (1, 512): 1.131, (2, 512): 1.773}
OVERLAP_RUN_COST = {(1, False): 1.0, (1, True): 1.112, (2, True): 0.942,
                    (4, True): 0.736}
# a CUDA grid's y and z extents
_MAX_GRID_Y = 65535

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


def walk_keys(program: ir.Program, s: str, onchip, R: int
              ) -> Dict[Tuple[str, int, int], Tuple[int, int]]:
    """The register windows of stage ``s`` walking runs of R adjacent j
    cells: per (on-chip field f, j and k offset from the run's first
    cell), the least and greatest i offset read there (the copy-BC centre
    read included).  A thread walking i holds planes [lo, hi] of each in
    registers and loads one plane of it a step."""
    keys: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
    for f, alist in accesses_with_center(program.kernels[s]).items():
        if f not in onchip:
            continue
        for a in alist:
            oi, oj, ok = (x or 0 for x in a)
            for r in range(R):
                key = (f, oj + r, ok)
                lo, hi = keys.get(key, (oi, oi))
                keys[key] = (min(lo, oi), max(hi, oi))
    return keys


def plane_loads(program: ir.Program, s: str, onchip, R: int,
                window: bool) -> int:
    """Loads of one walk position at one plane of stage ``s``: a register
    window's newest plane per key, or every distinct on-chip read of the
    R cells without the window; reads of fields in device memory count
    once per distinct (field, offset) of the run's cells."""
    keys = walk_keys(program, s, onchip, R)
    distinct = {(f in onchip, f, a[0] or 0, (a[1] or 0) + r, a[2] or 0)
                for f, alist in accesses_with_center(
                    program.kernels[s]).items()
                if not (f in program.inputs and program.inputs[f].is_scalar)
                for a in alist for r in range(R)}
    n = len(keys) if window else sum(1 for d in distinct if d[0])
    return n + sum(1 for d in distinct if not d[0])


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass
class OverlapPlan:
    needs: Dict[str, Extent]         # per field: (lo, hi) per dim
    onchip: Tuple[str, ...]          # fields held in shared memory
    # (B, tj, tk): B output planes a block over a (tj, tk) core column
    tile: Tuple[int, int, int]
    threads: int = THREADS           # threads of a block
    R: int = 1                       # adjacent j cells a thread evaluates
    window: bool = False             # i-neighbours from a register window
    order: Tuple[str, ...] = ()      # the stages in chain order
    # per on-chip input: elements of one 16-byte copy (1: one element a
    # copy)
    vec: Dict[str, int] = dataclasses.field(default_factory=dict)
    _memo: Dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @classmethod
    def build(cls, analysis: ChainAnalysis,
              tile: Optional[Tuple[int, int, int]] = None,
              threads: Optional[int] = None, R: Optional[int] = None,
              window: Optional[bool] = None) -> "OverlapPlan":
        """The plan of least modelled time (``seconds``) over tile (B,
        tj, tk) x threads x runs (R, window) whose shared memory fits a
        block, each fixed where given; ValueError when nothing fits or
        the chain is out of the kernel's scope (``scope_bytes``)."""
        plan = cls.empty(analysis)
        best = min(plan.candidates(analysis.program, tile, threads, R,
                                   window), default=None)
        if best is None:
            where = f"overlap tile {tuple(tile)}" if tile is not None else \
                "overlap blocks at every tile size"
            raise ValueError(f"{where} exceed shared memory")
        _cost, plan.tile, plan.threads, plan.R, plan.window = best
        return plan

    @classmethod
    def empty(cls, analysis: ChainAnalysis) -> "OverlapPlan":
        """The plan's fields with no tile chosen; ValueError or
        NotImplementedError when the chain is out of scope."""
        program = analysis.program
        check_scope(program)
        needs = chain_needs3(program, analysis)
        read = {f for k in program.kernels
                for f in program.kernels[k].accesses()}
        onchip = tuple(
            [n for n, s in program.inputs.items()
             if all(s.dim_mask) and n in read]
            + [k for k in analysis.graph.kernel_order if k in read])
        K = program.dimensions[2]
        vec = {}
        for f in onchip:
            size = np.dtype(program.field_dtype(f)).itemsize
            if f in program.inputs and size in (4, 8) and K % (16 // size) \
                    == 0:
                vec[f] = 16 // size
        plan = cls(needs, onchip, (0, 0, 0),
                   order=tuple(analysis.graph.kernel_order), vec=vec)
        if plan.scope_bytes(program) > H100_SMEM_PER_BLOCK:
            raise ValueError("overlap blocks exceed shared memory at every "
                             "tile size")
        return plan

    def candidates(self, program: ir.Program, tile=None, threads=None,
                   R=None, window=None):
        """Every plan that fits, as ((modelled seconds, its issue term,
        -cells of the tile), tile, threads, R, window), each parameter
        fixed where given (this plan's fields are moved through them):
        among plans the copies bound alike, the least issue wins."""
        dims = program.dimensions
        runs = [(r, w) for r, w in RUNS
                if (R is None or r == R) and (window is None or w == window)]
        if not runs:
            runs = [(R or 1, bool(window))]
        for cand in ([tuple(tile)] if tile is not None
                     else tile_candidates(dims)):
            for r, w in runs:
                self.tile, self.R, self.window = cand, r, w
                if self.smem_bytes(program) > H100_SMEM_PER_BLOCK or \
                        max(self.grid(dims)[:2]) > _MAX_GRID_Y:
                    continue
                for n in (threads,) if threads else PANEL_THREADS:
                    self.threads = n
                    issue, copies = self.terms(program)
                    yield ((max(issue, copies), issue, -math.prod(cand)),
                           cand, n, r, w)

    def scope_bytes(self, program: ir.Program) -> int:
        """The kernel's scope, kept from its first port so that the
        ladder routes as it did (``choose_stacked``): every on-chip
        field's region at the smallest tile (1, 1, 8), unpacked, must fit
        a block."""
        return sum(_align16(math.prod(
            t + lo + hi for t, (lo, hi) in zip((1, 1, 8), self.needs[f]))
            * np.dtype(program.field_dtype(f)).itemsize)
            for f in self.onchip)

    # -- geometry -------------------------------------------------------------
    def region(self, f: str) -> Tuple[int, int, int]:
        """(planes, rows, columns) of field f's i-overlapped, (j,
        k)-widened region: for an input, the block's window."""
        return tuple(t + lo + hi for t, (lo, hi)
                     in zip(self.tile, self.needs[f]))

    def grid(self, dims) -> Tuple[int, int, int]:
        """(blocks along i, column tiles along j, along k)."""
        return tuple(-(-n // t) for n, t in zip(dims, self.tile))

    def blocks(self, dims) -> int:
        return math.prod(self.grid(dims))

    def korigin(self, f: str) -> int:
        """Columns of f's buffer rows before the core column's first: its
        need_lo in k, rounded up to whole 16-byte copies for an input
        loaded by them (``vec``), so that every copy is aligned."""
        V = self.vec.get(f, 1)
        return -(-self.needs[f][2][0] // V) * V

    def row(self, f: str) -> int:
        """Row stride of f's buffer: its columns from ``korigin`` on, in
        whole 16-byte copies for an input loaded by them."""
        V = self.vec.get(f, 1)
        n = self.korigin(f) + self.tile[2] + self.needs[f][2][1]
        return -(-n // V) * V

    def plane(self, f: str) -> int:
        """Elements of one plane of f's buffer: its region's rows and the
        R - 1 rows the last run computes and reads into."""
        return (self.region(f)[1] + self.R - 1) * self.row(f)

    def window_inputs(self, program: ir.Program) -> Tuple[str, ...]:
        return tuple(f for f in self.onchip if f in program.inputs)

    def smem_offsets(self, program: ir.Program) -> Dict[str, int]:
        """Byte offset of each on-chip field's buffer: the input windows
        first, then the stages' regions placed by liveness (first fit; a
        stage's buffer is allocated before the buffers its last reads
        free); "" = total."""
        key = ("smem", self.tile, self.R)
        if key in self._memo:
            return self._memo[key]
        last: Dict[str, int] = {}
        for idx, k in enumerate(self.order):
            for f in program.kernels[k].accesses():
                last[f] = idx
        pos = {k: idx for idx, k in enumerate(self.order)}
        out, base = {}, 0
        for f in self.window_inputs(program):
            out[f] = base
            base += _align16(self.region(f)[0] * self.plane(f)
                             * np.dtype(program.field_dtype(f)).itemsize)
        live: list = []
        end = base
        for k in [k for k in self.order if k in self.onchip]:
            live = [x for x in live if last[x[2]] >= pos[k]]
            size = _align16(self.region(k)[0] * self.plane(k) * np.dtype(
                program.field_dtype(k)).itemsize)
            at = base
            for off, sz, _ in sorted(live):
                if off - at >= size:
                    break
                at = max(at, off + sz)
            live.append((at, size, k))
            out[k] = at
            end = max(end, at + size)
        out[""] = end
        self._memo[key] = out
        return out

    def smem_bytes(self, program: ir.Program) -> int:
        return self.smem_offsets(program)[""]

    # -- the schedule's bodies ------------------------------------------------
    def reach(self, program: ir.Program) -> Tuple[int, int, int, int]:
        """(below j, above j, below k, above k): how far beyond the core
        column any stage's cell or read reaches; a block whose column
        widened by it lies inside the (j, k) domain has no read to mask
        there."""
        out = [0, 0, 0, 0]
        for s, kspec in program.kernels.items():
            _, (lj, hj), (lk, hk) = self.needs[s]
            offs = [a for alist in kspec.accesses().values() for a in alist]
            oj = [a[1] or 0 for a in offs] + [0]
            ok = [a[2] or 0 for a in offs] + [0]
            out = [max(out[0], lj + max(-o for o in oj)),
                   max(out[1], hj + max(oj)),
                   max(out[2], lk + max(-o for o in ok)),
                   max(out[3], hk + max(ok))]
        return tuple(out)

    def free_steps(self, program: ir.Program, s: str) -> Tuple[int, int]:
        """Blocks [tlo, thi) along i in which every plane of stage
        ``s``'s region and every i read of it lies inside [0, I): there
        (in a column inside the (j, k) domain) the stage takes its
        mask-free body."""
        B, I = self.tile[0], program.dimensions[0]
        (lo, hi), _, _ = self.needs[s]
        rlo, rhi = i_reach(program, s)
        return -(-(lo + rlo) // B), (I - B - hi - rhi) // B + 1

    def inner_blocks(self, program: ir.Program) -> int:
        """Columns whose widest reach lies inside the (j, k) domain."""
        jl, jh, kl, kh = self.reach(program)
        _, J, K = program.dimensions
        _, tj, tk = self.tile
        _, ntj, ntk = self.grid(program.dimensions)
        return sum(1 for b in range(ntj) if b * tj - jl >= 0
                   and b * tj + tj + jh <= J) \
            * sum(1 for b in range(ntk) if b * tk - kl >= 0
                  and b * tk + tk + kh <= K)

    def positions(self, s: str) -> Tuple[int, int]:
        """(rows, columns) of stage ``s``'s walk positions: a run of R
        j cells at each."""
        _, RJ, RK = self.region(s)
        return -(-RJ // self.R), RK

    def loads(self, program: ir.Program, s: str) -> int:
        key = ("loads", s, self.R, self.window)
        if key not in self._memo:
            self._memo[key] = plane_loads(program, s, self.onchip, self.R,
                                          self.window)
        return self._memo[key]

    def work_terms(self, program: ir.Program) -> Tuple[int, int]:
        """(cell evaluations, loads) of one block: every stage's walk
        positions in passes of ``threads`` (idle lanes of a last pass
        included), each walking its region's planes and evaluating R
        cells a plane; a load of a walk, or an input copy of the window,
        is one load."""
        n = self.threads
        key = ("work", self.tile, self.R, self.window, n)
        if key not in self._memo:
            evals = loads = 0
            for s in program.kernels:
                NPJ, NPK = self.positions(s)
                lanes = -(-(NPJ * NPK) // n) * n * self.region(s)[0]
                evals += lanes * self.R
                loads += lanes * self.loads(program, s)
            for f in self.window_inputs(program):
                loads += -(-math.prod(self.region(f)) // n) * n
            self._memo[key] = (evals, loads)
        return self._memo[key]

    def work(self, program: ir.Program) -> int:
        """One block's cell evaluations and loads (``work_terms``): the
        sweeps cannot tell a load's cost from an evaluation's on these
        kernels (``sweep.fit_overlap``), so each counts one."""
        return sum(self.work_terms(program))

    def min_blocks(self, program: ir.Program) -> int:
        """Blocks per SM the shared memory leaves room for (at most 4),
        asked of nvcc by ``__launch_bounds__``."""
        return max(1, min(4, 2048 // self.threads, H100_SMEM_PER_SM
                          // (self.smem_bytes(program) + 1024)))

    def residency(self, program: ir.Program) -> int:
        """Blocks resident per SM: the threads', the shared memory's and
        the grid's limit."""
        return max(1, min(2048 // self.threads,
                          H100_SMEM_PER_SM // (self.smem_bytes(program)
                                               + 1024),
                          -(-self.blocks(program.dimensions)
                            // H100_SM_COUNT)))

    def waves(self, program: ir.Program) -> float:
        """Blocks a resident slot of an SM runs: ``blocks / (132 x
        resident blocks)``, and the last, partial wave counted whole."""
        return self.blocks(program.dimensions) / (
            H100_SM_COUNT * self.residency(program)) + 1

    def terms(self, program: ir.Program) -> Tuple[float, float]:
        """(issue, copies) in seconds, the plan rule's two terms: every SM
        issues the evaluations and loads (``work``) of its share of the
        blocks (``waves``) at ``H100_OVERLAP_CELL_RATE``,
        scaled by ``OVERLAP_LANE_COST`` at the plan's residency and
        threads and by the run's ``OVERLAP_RUN_COST``; the input windows
        (need_lo + need_hi planes beyond a block's B) stream
        asynchronously at ``H100_ASYNC_COPY_SHARE`` of the copy floor
        beside the outputs."""
        dims = program.dimensions
        per_sm = self.residency(program)
        blocks = self.blocks(dims)
        latency = OVERLAP_LANE_COST[
            min(per_sm, 4 if self.threads == 256 else 2), self.threads] \
            * OVERLAP_RUN_COST.get((self.R, self.window), 1.0)
        issue = self.waves(program) * per_sm * self.work(program) \
            * latency / H100_OVERLAP_CELL_RATE
        moved = blocks * sum(
            math.prod(self.region(f))
            * np.dtype(program.field_dtype(f)).itemsize
            for f in self.window_inputs(program)) + sum(
            math.prod(dims) * np.dtype(program.kernels[o].dtype).itemsize
            for o in program.outputs)
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return issue, moved / (H100_COPY_FLOOR * share)

    def seconds(self, program: ir.Program) -> float:
        """The plan rule, a model in seconds: the larger of ``terms``."""
        return max(self.terms(program))


def tile_candidates(dims) -> list:
    """(B, tj, tk) plans to try, capped near the domain's size."""
    caps = [max(1, 1 << math.ceil(math.log2(max(1, n)))) for n in dims]
    return [(B, tj, tk) for B in (1, 2, 4, 8, 16, 32)
            for tj in (1, 2, 4, 8, 16, 32, 64)
            for tk in (8, 16, 32, 64, 128)
            if B <= caps[0] and tj <= caps[1] and tk <= max(8, caps[2])]


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
    arrays = dict(arrays)
    for f in plan.vec:
        # 16-byte copies need a 16-byte aligned row start: a view that
        # starts off one (a storage offset) is copied into fresh storage
        if arrays[f].device.type == "cuda" and arrays[f].data_ptr() % 16:
            arrays[f] = arrays[f].clone()
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_overlap(program, analysis,
                                                          plan),
        lambda: overlap_plain(program, analysis, plan, arrays))
    launches_by[launch_mode(program)] += launched
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

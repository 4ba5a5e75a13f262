"""Stage-grouped streamer: rings every g stages, recompute within (K5).

Hopper counterpart of ``stencilflow_tpu/backend/group.py``
(``_group_kernel_body``, built by ``compile_chain_group``).  The stage
order is cut into GROUPS of at most g consecutive stages; only fields
that cross a group boundary (streamed inputs, and stage outputs read
outside their own group) get rings, and the stages inside a group are
evaluated over i-widened blocks of ``lo + B + hi`` planes.  Ring stores
drop by about g against the panel kernel, for a recompute of about
``(B + 2(g-1)h) / B`` on a group's deepest stage.  ``GroupPlan.build``
is the reference's lag / depth / needs / ring-field algebra, copied
exactly.

The schedule here is the port's own, on the panel kernel's (K1's)
skeleton.  One thread block owns a halo-widened (tj, tk) core tile of
the (j, k) plane (after the rows rotation J = 1, so the blocks tile k)
and one i-segment of its panels, and marches i in panels of B planes:

* step t issues the ``cp.async`` loads of panel t + 1 of every streamed
  input (zero-filled beyond the domain) into the slot of the panel it
  replaces, right after the last stage that reads that panel
  (``GroupPlan.issue``), or, where that stage is the step's last, at the
  step's top into an extra panel slot (``GroupPlan.slots``); it waits for
  panel t, and after a barrier every
  group whose panel ``q = t - lag[g]`` the block needs evaluates its live
  stages in order, each over its widened block (rows x its (j, k)
  halo-widened region), a barrier after each; stages read by a later
  stage of the same group keep their block in shared scratch, placed by
  liveness; ring fields store their B core planes into their ring,
  program outputs write them to device memory;
* a ring's panels sit in slots that rotate by per-step counters (t mod
  slots), its planes at a shift (``shift``) chosen so that its readers'
  windows wrap the ring's end the least, and the planes a window can
  wrap into are kept twice, past the end (``mirror``): each group sets
  one base per ring it reads once a step, and a read is one shared-memory
  load at a constant offset from it and the thread's cell; a thread's
  first cell of each row shape comes from one division before the march;
* each stage has a mask-free body, taken where the block's widest (j, k)
  reach lies inside the domain and the stage's rows and i reads lie in
  [0, I) (the reference's ``interior_split``), and a masked one:
  boundary conditions from global coordinates (constant fill, shrink
  JUNK_VAL, copy centre) as in the panel kernel, so rows whose plane lies
  outside [0, I) hold stale ring data or junk that no read carries into
  an in-range plane;
* i-segments (``segments``): the grid has one block per (segment, tile);
  a segment's block starts ``warmup`` panels early, so that its rings
  hold what its first panels read, evaluates each group only on the
  panels its own panels need, and writes only its own panels;
* inputs that do not span i, and scalars, are read from device memory
  and kernel arguments.

What bounds it on the H100: as the panel kernel, instruction rate and
latency inside the block rather than device-memory bytes (jacobi2d
8192^2 x 8 moves 512 MiB, 0.160 ms at 3.35 TB/s): a barrier after every
stage of every panel and the recompute of the widened blocks.  The rings
and the widest group's live blocks must fit 227 KB, which caps B and the
tile, and with J = 1 a row of 8192 cells gives 256 blocks of (1, 32) to
spread over 132 SMs; i-segments multiply the blocks for a few panels of
warm-up each.  ``GroupPlan.seconds`` prices (tile, threads, segments) in
seconds, as ``PanelPlan.seconds`` prices the panel kernel's tiles.  On an
NVIDIA H100 80GB HBM3 (700 W; ``deep_time.py --cells group`` in turns
with the kernel before this design) jacobi2d 8192^2 x 8 takes 0.83-0.86
ms (2.10-2.12 before) at (1, 64) x 256 with 8 segments, and hotspot2d
1.49-1.52 (2.82-2.83) at (1, 32) x 256 with 4; one barrier fewer a step
moved neither.

Not ported (TPU-only, ROADMAP ground rules): direct input windows, the
bool wire and narrow stores, VMEM limits, and the auto-B preference for
sublane multiples of 8.

``ring_storage="bfloat16"`` (the reference's bf16 ring storage, f32
compute): every f32 field of ``ring_fields`` rounds to bf16 (to nearest,
ties to even) where its ring stores it and every ring read sees it as
f32; a stage's ring keeps bf16 slots (``smem_layout`` counts 2 bytes a
cell), a ring input keeps f32 slots, which ``cp.async`` fills, and
rounds at each read; in-group blocks hold exact values, as the
reference's in-group reads do.  Outputs are written unrounded.  Launches
count in ``launches_by["bf16"]``.

``group_plain`` runs the reference's schedule from the same plan in
torch ops, all tiles at once, one segment; the wrapper ``run_group``
takes it for CPU tensors only and launches the CUDA kernel (codegen.py
``group_source``) for CUDA tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import (H100_ASYNC_COPY_SHARE, H100_COPY_FLOOR,
                      H100_GROUP_CELL_RATE, H100_SM_COUNT,
                      H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM)
from ..dtypes import BFLOAT16, to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .panel import AHEAD, PANEL_THREADS, reach, tile_candidates
from .stacked_io import (THREADS, accesses_with_center, bc_select, check_scope,
                         gather_global, launch_mode, or_mask, resolve_device,
                         round_bf16, rounded_rings, run_kernel, spanned_arrays)
from .tile_eval import eval_kernel_statements

# kernel launches (CUDA tensors only) by mode (stacked_io.launch_mode):
# "exact", "bf16" (ring_storage="bfloat16") and "narrow" (a program typed
# bfloat16 or float16)
launches_by = collections.Counter()
# the i-segments a plan may cut I into (one block per segment and tile)
SEGMENTS = (1, 2, 3, 4, 6, 8)
# the plan rule's cost of a lane at (resident blocks per SM, threads a
# block), relative to two blocks of 256, and its tail: a launch lasts its
# blocks' waves over the SMs and GROUP_TAIL of one block more (the last
# blocks finish alone).  Fitted (``sweep.fit_group``) to the times of 108
# plans of jacobi2d and hotspot2d 8192^2 x 8 on an NVIDIA H100 80GB HBM3
# (700 W), RMS error 8 % in log time: one block of 256 runs a lane 1.52x
# as long as two, one of 512 1.13x; more segments (shorter blocks) win by
# up to 1.6x over one, which the tail and the fractional waves carry.
GROUP_LANE_COST = {(1, 256): 1.52, (2, 256): 1.0, (3, 256): 1.01,
                   (4, 256): 1.02, (1, 512): 1.13, (2, 512): 1.02}
GROUP_TAIL = 0.45


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass
class GroupPlan:
    B: int                                   # planes per panel
    groups: List[List[str]]                  # stage names per group
    group_of: Dict[str, int]
    ring_fields: List[str]                   # ring-backed fields, stable order
    needs: List[Dict[str, Tuple[int, int]]]  # per group: (lo, hi) extents
    lag: List[int]                           # per group: panel lag
    depth: Dict[str, int]                    # ring depth (panels)
    src_lag: Dict[str, int]                  # ring field -> producer lag
    # the port's placement (``place``): per field (j, k) tile widening,
    # the rings the kernel keeps, and the core (tj, tk) tile
    halo: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    rings: List[str] = dataclasses.field(default_factory=list)
    tile: Tuple[int, int] = (0, 0)
    # per ring: the shift of its planes in its slots, and the planes kept
    # twice past its end (a reader's window wraps into them)
    shift: Dict[str, int] = dataclasses.field(default_factory=dict)
    mirror: Dict[str, int] = dataclasses.field(default_factory=dict)
    inputs: Tuple[str, ...] = ()             # ring inputs (loaded ahead)
    # per ring input: the phase (``phases``) after which panel t + 1 is
    # issued into the slot of the panel its last reader freed (-1: at the
    # step's top, no stage reads that panel), or None: at the step's top,
    # into an extra slot
    issue: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)
    threads: int = THREADS                   # threads of a block
    segments: int = 1                        # i-segments of the grid
    # ring_storage="bfloat16": the rings that round to bf16 at their store
    # (the f32 fields of ``ring_fields``); a stage's ring keeps bf16
    # slots, a ring input f32 slots (cp.async copies bytes) rounded where
    # they are read; in-group blocks keep exact values, as the reference's
    # in-group reads do
    rounds: frozenset = frozenset()

    @classmethod
    def build(cls, program: ir.Program, analysis: ChainAnalysis,
              B: int, group: int) -> "GroupPlan":
        """The JAX package's ``GroupPlan.build``, copied exactly."""
        order = list(analysis.graph.kernel_order)
        groups = [order[i:i + group] for i in range(0, len(order), group)]
        group_of = {k: gi for gi, grp in enumerate(groups) for k in grp}

        streamed = [n for n, sp in program.inputs.items()
                    if not sp.is_scalar and sp.dim_mask[0]]
        ring_kernels: List[str] = []
        for kname in order:
            consumers = [c for c in analysis.graph.consumers(kname)
                         if c in program.kernels]
            if any(group_of[c] != group_of[kname] for c in consumers):
                ring_kernels.append(kname)
        ring_fields = streamed + ring_kernels
        ring_set = set(ring_fields)

        # within-group widened extents (the overlap kernel's reverse
        # transpose, seeded at the group's ring-stored / output stages)
        needs: List[Dict[str, Tuple[int, int]]] = []
        for gi, grp in enumerate(groups):
            nd: Dict[str, Tuple[int, int]] = {}
            for k in grp:
                if k in ring_set or k in program.outputs:
                    nd[k] = (0, 0)
            for k in reversed(grp):
                if k not in nd:
                    continue   # dead within this group (no consumer)
                lo_c, hi_c = nd[k]
                kspec = program.kernels[k]
                for f, alist in accesses_with_center(kspec).items():
                    if f in program.inputs and program.inputs[f].is_scalar:
                        continue
                    lo_f, hi_f = nd.get(f, (0, 0))
                    for a in alist:
                        oi = a[0] or 0
                        oj = a[1] or 0
                        if abs(oj) > program.dimensions[1]:
                            raise ValueError(
                                f"j-offset {oj} exceeds J="
                                f"{program.dimensions[1]} (group scope)")
                        lo_f = max(lo_f, lo_c - oi + (1 if oj < 0 else 0))
                        hi_f = max(hi_f, hi_c + oi + (1 if oj > 0 else 0))
                    nd[f] = (lo_f, hi_f)
            needs.append(nd)

        # group lags (the panel alignment algebra at group granularity)
        lag: List[int] = []
        src_lag: Dict[str, int] = {f: 0 for f in streamed}
        for gi, grp in enumerate(groups):
            gset = set(grp)
            lg = 0
            for f, (_lo, hi) in needs[gi].items():
                if f in gset or f not in ring_set:
                    continue   # in-group temporary or static/scalar
                lg = max(lg, src_lag[f] + _ceil_div(hi, B))
            lag.append(lg)
            for k in grp:
                if k in ring_set:
                    src_lag[k] = lg

        depth: Dict[str, int] = {}
        for gi in range(len(groups)):
            gset = set(groups[gi])
            for f, (lo, _hi) in needs[gi].items():
                if f in gset or f not in ring_set:
                    continue
                d = lag[gi] - src_lag[f] + _ceil_div(lo, B) + 1
                depth[f] = max(depth.get(f, 1), d)
        # a ring field no group reads (e.g. an unused streamed input)
        # still needs a slot for its ingest store
        for f in ring_fields:
            depth.setdefault(f, 1)
        return cls(B, groups, group_of, ring_fields, needs, lag, depth,
                   src_lag)

    # -- the port's placement ---------------------------------------------
    def place(self, program: ir.Program, analysis: ChainAnalysis) -> None:
        """Per-field (j, k) halos and the rings the kernel keeps: every
        ring field some stage reads (an unread streamed input gets
        none)."""
        stage = analysis.stage_halo()
        inp = analysis.input_halo()
        read = {f for k in program.kernels
                for f in program.kernels[k].accesses()}
        self.rings = [f for f in self.ring_fields
                      if f in program.kernels or f in read]
        self.halo = {f: tuple((stage.get(f) or inp.get(f))[1:])
                     for f in self.rings + list(program.kernels)}
        self.inputs = tuple(f for f in self.rings if f in program.inputs)
        B = self.B
        phases = self.phases()
        for f in self.inputs:
            # panel t + 1 takes the slot of panel t + 1 - depth: issue it
            # after the last stage that reads that panel, unless that is
            # the step's last (-1: no stage reads it, issue at the top)
            last = -1
            for n, (g, s) in enumerate(phases):
                offs = [a[0] or 0 for a in accesses_with_center(
                    program.kernels[s]).get(f, [])]
                if offs and (min(offs) - self.needs[g][s][0]) // B <= \
                        self.lag[g] + 1 - self.depth[f]:
                    last = n
            self.issue[f] = last if last < len(phases) - 1 else None
        for f in self.rings:
            # a window of lo + B + hi planes starting at a shift e0 into a
            # slot reaches e0 + lo + hi planes past the ring's end; the
            # shift that zeroes e0 for some reader minimises the worst
            readers = [self.needs[g][f] for g in range(len(self.groups))
                       if f in self.needs[g] and f not in self.groups[g]]
            self.mirror[f], self.shift[f] = min(
                (max([(c - lo) % B + lo + hi for lo, hi in readers],
                     default=0), c)
                for c in sorted({lo % B for lo, _ in readers} | {0}))

    def lag_max(self, program: ir.Program) -> int:
        return max(self.lag[self.group_of[o]] for o in program.outputs)

    def live(self, gi: int) -> List[str]:
        """Group ``gi``'s stages with a consumer, in chain order."""
        return [s for s in self.groups[gi] if s in self.needs[gi]]

    def rows(self, gi: int, f: str) -> int:
        lo, hi = self.needs[gi][f]
        return lo + self.B + hi

    def region(self, f: str) -> Tuple[int, int]:
        hj, hk = self.halo[f]
        return self.tile[0] + 2 * hj, self.tile[1] + 2 * hk

    def grid(self, dims) -> Tuple[int, int]:
        return -(-dims[1] // self.tile[0]), -(-dims[2] // self.tile[1])

    def temps(self, program: ir.Program, gi: int) -> Dict[str, Tuple[int,
                                                                  int]]:
        """(byte offset, bytes) in the scratch of each stage of group
        ``gi`` that a later stage of the group reads, first-fit by
        liveness: a block is free once its last reader has run."""
        live = self.live(gi)
        pos = {s: n for n, s in enumerate(live)}
        last: Dict[str, int] = {}
        for n, c in enumerate(live):
            for f in accesses_with_center(program.kernels[c]):
                if f in pos:
                    last[f] = max(last.get(f, -1), n)
        out: Dict[str, Tuple[int, int]] = {}
        active: List[Tuple[int, int, int]] = []   # (offset, bytes, last)
        for n, s in enumerate(live):
            active = [a for a in active if a[2] >= n]
            if s not in last:
                continue
            RJ, RK = self.region(s)
            size = _align16(self.rows(gi, s) * RJ * RK * np.dtype(
                program.field_dtype(s)).itemsize)
            off = 0
            for a_off, a_size, _ in sorted(active):
                if a_off - off >= size:
                    break
                off = max(off, a_off + a_size)
            out[s] = (off, size)
            active.append((off, size, last[s]))
        return out

    def phases(self) -> List[Tuple[int, str]]:
        """(group, stage) of each stage a step evaluates, in order."""
        return [(g, s) for g in range(len(self.groups)) for s in self.live(g)]

    def slots(self, f: str) -> int:
        """Panel slots of ring ``f``: its depth, and AHEAD more for a ring
        input whose next panel is issued at the step's top (the panel in
        flight beside every panel the step reads)."""
        return self.depth[f] + (AHEAD if f in self.issue
                                and self.issue[f] is None else 0)

    def rounded(self, f: str) -> bool:
        return f in self.rounds

    def narrow_slots(self, f: str) -> bool:
        """Does ring ``f`` keep 2-byte slots of ``slot_dtype``?"""
        return f in self.rounds and f not in self.inputs

    # the type of the 2-byte slots and of the rounding of rounded rings
    slot_dtype = BFLOAT16

    def ring_planes(self, f: str) -> int:
        """Planes of ring ``f`` in shared memory: its slots' and the
        mirrored ones."""
        return self.slots(f) * self.B + self.mirror[f]

    def smem_layout(self, program: ir.Program):
        """(byte offset of each ring, per group {stage: byte offset of its
        block}, total bytes) of the block's shared memory."""
        off, rings = 0, {}
        for f in self.rings:
            rings[f] = off
            RJ, RK = self.region(f)
            off += _align16(self.ring_planes(f) * RJ * RK * (
                2 if self.narrow_slots(f) else np.dtype(
                    program.field_dtype(f)).itemsize))
        temps, peak = [], 0
        for gi in range(len(self.groups)):
            t = self.temps(program, gi)
            temps.append({s: off + o for s, (o, _) in t.items()})
            peak = max([peak] + [o + n for o, n in t.values()])
        return rings, temps, off + peak

    def smem_bytes(self, program: ir.Program) -> int:
        return self.smem_layout(program)[2]

    # -- the kernel's schedule ---------------------------------------------
    def panels_per_segment(self, program: ir.Program) -> int:
        return -(-(program.dimensions[0] // self.B) // self.segments)

    def warmup(self, program: ir.Program) -> Dict[str, object]:
        """What a segment of panels [P0, P1) evaluates beyond its own:
        ``group`` gives per live group (panels before P0, panels after
        P1) it evaluates, so that its readers in later groups find every
        panel they read (a group with an output reads from P0 on); the
        ring inputs are loaded from ``steps`` panels before P0 up to
        ``in_hi`` panels past P1, and the block's first step is P0 -
        ``steps`` (the earliest step any of it runs)."""
        B = self.B
        lo_w: Dict[int, int] = {}
        hi_w: Dict[int, int] = {}

        def readers(f):
            return [(g, self.needs[g][f]) for g in lo_w
                    if f in self.needs[g] and f not in self.groups[g]]
        for g in reversed(range(len(self.groups))):
            if not self.live(g):
                continue
            lw = hw = 0
            for f in self.groups[g]:
                if f in self.rings:
                    for g2, (lo, hi) in readers(f):
                        lw = max(lw, lo_w[g2] + _ceil_div(lo, B))
                        hw = max(hw, hi_w[g2] + _ceil_div(hi, B))
            lo_w[g], hi_w[g] = lw, hw
        in_lo = in_hi = 0
        for f in self.inputs:
            for g2, (lo, hi) in readers(f):
                in_lo = max(in_lo, lo_w[g2] + _ceil_div(lo, B))
                in_hi = max(in_hi, hi_w[g2] + _ceil_div(hi, B))
        steps = max([in_lo] + [lo_w[g] - self.lag[g] for g in lo_w])
        return {"group": {g: (lo_w[g], hi_w[g]) for g in lo_w},
                "steps": max(0, steps), "in_hi": in_hi}

    def steps(self, program: ir.Program) -> int:
        """Panel steps of the longest segment's block, warm-up included."""
        n = program.dimensions[0] // self.B
        Ps, W = self.panels_per_segment(program), \
            self.warmup(program)["steps"]
        return max(min(P0 + Ps, n) - max(0, P0 - W)
                   for P0 in range(0, n, Ps)) + self.lag_max(program)

    def reach(self, program: ir.Program) -> Tuple[int, int]:
        """(Hj, Hk): how far beyond the core tile any stage's cell or read
        reaches (``panel.reach``); a block whose core widened by it lies
        inside the (j, k) domain has no read to mask there."""
        return reach(program, self)

    def free_panels(self, program: ir.Program, gi: int,
                    s: str) -> Tuple[int, int]:
        """Panels [qlo, qhi) on which stage ``s`` of group ``gi`` has every
        row and every i read inside [0, I): there (in a block inside the
        (j, k) domain) it takes its mask-free body."""
        lo, hi = self.needs[gi][s]
        offs = [a[0] or 0
                for f, lst in program.kernels[s].accesses().items()
                for a in lst
                if not (f in program.inputs and program.inputs[f].is_scalar)]
        lo += max([0] + [-o for o in offs])
        hi += max([0] + offs)
        return _ceil_div(lo, self.B), \
            (program.dimensions[0] - self.B - hi) // self.B + 1

    def inner_blocks(self, program: ir.Program) -> int:
        """Tiles whose widest reach lies inside the (j, k) domain."""
        (Hj, Hk), (tj, tk) = self.reach(program), self.tile
        _, J, K = program.dimensions
        ntj, ntk = self.grid(program.dimensions)
        return sum(1 for b in range(ntj)
                   if b * tj - Hj >= 0 and b * tj + tj + Hj <= J) \
            * sum(1 for b in range(ntk)
                  if b * tk - Hk >= 0 and b * tk + tk + Hk <= K)

    def lanes(self, program: ir.Program) -> int:
        """Thread-evaluations one block issues per panel step: the input
        panels' loads and every live stage's widened block, in passes of
        ``threads`` cells (idle lanes of a last pass included)."""
        n = self.threads
        cells = [self.B * math.prod(self.region(f)) for f in self.inputs]
        cells += [self.rows(g, s) * math.prod(self.region(s))
                  for g in range(len(self.groups)) for s in self.live(g)]
        return sum(-(-c // n) * n for c in cells)

    def blocks(self, program: ir.Program) -> int:
        ntj, ntk = self.grid(program.dimensions)
        return ntj * ntk * self.segments

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
                          -(-self.blocks(program) // H100_SM_COUNT)))

    def seconds(self, program: ir.Program) -> float:
        """The plan rule, a model in seconds: every SM issues the lanes of
        every panel step (warm-up included) of its share of the blocks,
        ``blocks / (132 x resident blocks)`` waves and ``GROUP_TAIL`` of a
        block more, at ``H100_GROUP_CELL_RATE``, scaled by
        ``GROUP_LANE_COST`` at the plan's residency and threads; the input
        panels (halo and warm-up included) stream asynchronously at
        ``H100_ASYNC_COPY_SHARE`` of the copy floor beside the outputs;
        the larger term counts."""
        per_sm = self.residency(program)
        blocks = self.blocks(program)
        waves = blocks / (H100_SM_COUNT * per_sm) + GROUP_TAIL
        latency = GROUP_LANE_COST[
            min(per_sm, 4 if self.threads == 256 else 2), self.threads]
        steps = self.steps(program)
        compute = steps * waves * per_sm * self.lanes(program) * latency \
            / H100_GROUP_CELL_RATE
        I, J, K = program.dimensions
        moved = blocks * steps * self.B * sum(
            math.prod(self.region(f)) * np.dtype(
                program.field_dtype(f)).itemsize for f in self.inputs) \
            + sum(I * J * K * np.dtype(program.kernels[o].dtype).itemsize
                  for o in program.outputs)
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return max(compute, moved / (H100_COPY_FLOOR * share))


# -- planner ---------------------------------------------------------------

def _fit(program: ir.Program, analysis: ChainAnalysis, B: int, group: int,
         tile: Optional[Tuple[int, int]], threads: Optional[int] = None,
         segments: Optional[int] = None,
         ring_storage: str = "off") -> Optional[GroupPlan]:
    """The plan at panel size B of least modelled time
    (``GroupPlan.seconds``) over the tiles (or ``tile``), the thread
    counts of ``PANEL_THREADS`` (or ``threads``) and the i-segments of
    ``SEGMENTS`` (or ``segments``) whose shared memory fits a block; None
    when nothing fits."""
    plan = GroupPlan.build(program, analysis, B, group)
    plan.place(program, analysis)
    plan.rounds = rounded_rings(program, plan.rings, ring_storage)
    n_panels = program.dimensions[0] // B
    segs = [segments] if segments else [
        S for S in SEGMENTS if S <= n_panels
        and -(-n_panels // -(-n_panels // S)) == S]
    best = None
    for cand in ([tuple(tile)] if tile is not None
                 else tile_candidates(program.dimensions)):
        plan.tile = cand
        if plan.smem_bytes(program) > H100_SMEM_PER_BLOCK:
            continue
        for n in (threads,) if threads else PANEL_THREADS:
            for S in segs:
                plan.threads, plan.segments = n, S
                cost = (plan.seconds(program), -cand[0] * cand[1], n, S)
                if best is None or cost < best[0]:
                    best = (cost, cand, n, S)
    if best is None:
        return None
    plan.tile, plan.threads, plan.segments = best[1:]
    return plan


def plan_group(program: ir.Program, analysis: Optional[ChainAnalysis] = None,
               panel: int = 0, group: int = 2,
               tile: Optional[Tuple[int, int]] = None,
               threads: Optional[int] = None,
               segments: Optional[int] = None,
               ring_storage: str = "off") -> GroupPlan:
    """The group kernel's plan: panel size B (``panel``, 0 = the JAX
    package's auto rule), groups of at most ``group`` stages, and the
    (tj, tk) tile, threads and i-segments of least modelled time whose
    shared memory fits (each fixed where given).  An auto B steps down by
    divisors of I until some tile fits; an explicit B that fits nowhere,
    or does not divide I, raises ValueError (nothing is built).
    ``ring_storage`` ("off" or "bfloat16") is the rings' storage."""
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    if group < 1:
        raise ValueError(f"group size must be >= 1, got {group}")
    I, J, _K = program.dimensions
    auto = panel <= 0
    if auto:
        # auto panels want B >= 4*(g-1)*h so the deepest stage's
        # recompute halo stays <= ~50% (the JAX package's rule)
        hmax = max((abs(a[0] or 0)
                    for kspec in program.kernels.values()
                    for alist in accesses_with_center(kspec).values()
                    for a in alist), default=0)
        target = max(1, 4 * (group - 1) * hmax,
                     (1024 // J) if J < 512 else 1)
        cands = [d for d in range(1, I + 1)
                 if I % d == 0 and d >= min(target, I)]
        panel = min(cands) if cands else I
    B = panel
    if I % B or B < 1:
        raise ValueError(f"panel {B} must divide I={I}")
    if segments is not None:
        if not 1 <= segments <= I // B:
            raise ValueError(f"segments {segments} must lie in "
                             f"[1, {I // B}]")
        # as many segments as runs of ceil(panels / segments) panels
        segments = -(-(I // B) // -(-(I // B) // segments))
    plan = _fit(program, analysis, B, group, tile, threads, segments,
                ring_storage)
    while auto and plan is None and B > 1:
        B = max(d for d in range(1, B // 2 + 1) if I % d == 0)
        plan = _fit(program, analysis, B, group, tile, threads,
                    min(segments, I // B) if segments else None,
                    ring_storage)
    if plan is None:
        where = f"tile {tuple(tile)}" if tile else "every tile"
        raise ValueError(f"group rings and blocks exceed shared memory at "
                         f"{where} (B={B}, g={group})")
    return plan


# -- plain version ---------------------------------------------------------

def group_plain(program: ir.Program, analysis: ChainAnalysis,
                plan: GroupPlan, arrays: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The kernel's schedule in torch ops, every tile of the plane at
    once: a ring is a (depth * B, ntj, ntk, RJ, RK) tensor, a group's
    block a (rows, ntj, ntk, RJ, RK) one.  Ring slots never written hold
    NaN (floats), as uninitialised shared memory may.  ``arrays`` holds
    every input at its spanned shape (0-d for scalars); returns (I, J, K)
    outputs."""
    I, J, K = dims = program.dimensions
    B = plan.B
    n_panels = I // B
    tj, tk = plan.tile
    ntj, ntk = plan.grid(dims)
    device = next(a for n, a in arrays.items()
                  if not program.inputs[n].is_scalar).device

    def jk(f):
        hj, hk = plan.halo[f]
        RJ, RK = plan.region(f)
        gj = (torch.arange(ntj, device=device)[:, None] * tj - hj
              + torch.arange(RJ, device=device)[None, :])
        gk = (torch.arange(ntk, device=device)[:, None] * tk - hk
              + torch.arange(RK, device=device)[None, :])
        return gj.reshape(1, ntj, 1, RJ, 1), gk.reshape(1, 1, ntk, 1, RK)

    def planes(first, n):
        return torch.arange(first, first + n,
                            device=device).reshape(n, 1, 1, 1, 1)

    rings = {}
    for f in plan.rings:
        tdt = to_torch_dtype(program.field_dtype(f))
        rings[f] = torch.full(
            (plan.depth[f] * B, ntj, ntk) + plan.region(f),
            float("nan") if tdt.is_floating_point else 0, dtype=tdt,
            device=device)
    outs = {o: torch.empty(dims, device=device,
                           dtype=to_torch_dtype(program.kernels[o].dtype))
            for o in program.outputs}
    ring_inputs = [f for f in plan.rings if f in program.inputs]
    for t in range(n_panels + plan.lag_max(program)):
        if t < n_panels:
            for f in ring_inputs:
                gj, gk = jk(f)
                val = gather_global(
                    arrays[f], program.inputs[f].dim_mask,
                    (planes(t * B, B), gj, gk), dims).expand(
                        (B, ntj, ntk) + plan.region(f))
                rings[f][t * B % rings[f].shape[0]:][:B] = round_bf16(
                    val) if plan.rounded(f) else val
        for gi, grp in enumerate(plan.groups):
            q = t - plan.lag[gi]
            if not 0 <= q < n_panels:
                continue
            nd, gset = plan.needs[gi], set(grp)
            vals: Dict[str, torch.Tensor] = {}
            for s in plan.live(gi):
                kspec = program.kernels[s]
                lo_s = nd[s][0]
                R = plan.rows(gi, s)
                RJ, RK = plan.region(s)
                gi_s = planes(q * B - lo_s, R)
                gj_s, gk_s = jk(s)

                def read(field, offsets, kspec=kspec, s=s, lo_s=lo_s, R=R,
                         RJ=RJ, RK=RK, gi_s=gi_s, gj_s=gj_s, gk_s=gk_s):
                    dt = np.dtype(program.field_dtype(field))
                    if field in program.inputs and \
                            program.inputs[field].is_scalar:
                        return arrays[field].to(device), dt
                    bc = kspec.boundary_conditions.get(field)
                    oi, oj, ok = (o or 0 for o in offsets)
                    mask = None
                    if oi:
                        mask = (gi_s + oi < 0) | (gi_s + oi >= I)
                    if oj:
                        mask = or_mask(mask, (gj_s + oj < 0)
                                       | (gj_s + oj >= J))
                    if ok:
                        mask = or_mask(mask, (gk_s + ok < 0)
                                       | (gk_s + ok >= K))
                    if field in gset or field in rings:
                        dj = plan.halo[field][0] - plan.halo[s][0]
                        dk = plan.halo[field][1] - plan.halo[s][1]

                        def at(oi, oj, ok, field=field, dj=dj, dk=dk):
                            if field in gset:
                                r0 = nd[field][0] - lo_s + oi
                                blk = vals[field][r0:r0 + R]
                            else:
                                ring = rings[field]
                                blk = ring[(gi_s.reshape(-1) + oi)
                                           % ring.shape[0]]
                            return blk[:, :, :, dj + oj:dj + oj + RJ,
                                       dk + ok:dk + ok + RK]
                        return bc_select(bc, dt, mask, at(oi, oj, ok),
                                         lambda: at(0, 0, 0)), dt
                    spec = program.inputs[field]
                    val = gather_global(arrays[field], spec.dim_mask,
                                        (gi_s + oi, gj_s + oj, gk_s + ok),
                                        dims)
                    return bc_select(bc, dt, mask, val, lambda: gather_global(
                        arrays[field], spec.dim_mask, (gi_s, gj_s, gk_s),
                        dims)), dt

                val = eval_kernel_statements(kspec, read, (R, ntj, ntk, RJ,
                                                           RK), device)
                vals[s] = val
                core = val[lo_s:lo_s + B]
                if s in rings:
                    rings[s][q * B % rings[s].shape[0]:][:B] = round_bf16(
                        core) if plan.rounded(s) else core
                if s in outs:
                    hj, hk = plan.halo[s]
                    c = core[:, :, :, hj:hj + tj, hk:hk + tk]
                    outs[s][q * B:q * B + B] = c.permute(0, 1, 3, 2, 4) \
                        .reshape(B, ntj * tj, ntk * tk)[:, :J, :K]
    return outs


# -- wrapper ---------------------------------------------------------------

def build_group(program: ir.Program, analysis: ChainAnalysis,
                plan: GroupPlan):
    """Generate and compile the group kernel for ``plan``."""
    return build.load_library(codegen.group_source(program, analysis, plan),
                              "group")


def run_group(program: ir.Program, analysis: ChainAnalysis, plan: GroupPlan,
              arrays: Dict[str, torch.Tensor], lib=None):
    """The group kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_group``); it is built on demand
    when omitted."""
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_group(program, analysis,
                                                        plan),
        lambda: group_plain(program, analysis, plan, arrays))
    launches_by[launch_mode(program, bool(plan.rounds))] += launched
    return outs


def compile_chain_group(program: ir.Program,
                        analysis: Optional[ChainAnalysis] = None,
                        panel: int = 0, group: int = 2,
                        tile: Optional[Tuple[int, int]] = None,
                        device="cuda", ring_storage: str = "off"):
    """Plan the group kernel (``plan_group``: ValueError /
    NotImplementedError when the program is out of its scope) and, for a
    CUDA ``device``, build it.  Returns ``fn(inputs) -> outputs`` at the
    program's raw dims on ``device`` (inputs are moved there), with the
    plan as ``fn.plan``.  ``ring_storage="bfloat16"`` rounds every f32
    ring to bf16 at its store (f32 compute; in-group reads and outputs
    exact)."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = plan_group(program, analysis, panel, group, tile,
                      ring_storage=ring_storage)
    device = resolve_device(device)
    lib = build_group(program, analysis, plan) if device.type == "cuda" \
        else None

    def forward(inputs):
        arrays = spanned_arrays(program, inputs, device=device)
        outs = run_group(program, analysis, plan, arrays, lib)
        return {o: v.reshape(program.raw_dimensions)
                for o, v in outs.items()}

    forward.plan = plan
    return forward

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

The schedule here is the port's own.  One thread block owns a
halo-widened (tj, tk) core tile of the (j, k) plane (after the rows
rotation J = 1, so the blocks tile k) and marches i in panels of B
planes:

* step t ingests panel t of every streamed input into its ring;
* then every group whose panel ``q = t - lag[g]`` lies in [0, I/B)
  evaluates its live stages in order, each over its widened block
  (rows x its (j, k) halo-widened region), one cell per thread;
  stages read by a later stage of the same group keep their block in
  shared scratch, placed by liveness (a block's bytes are reused once
  its last reader in the group has run); ring fields store their B core
  planes into their ring, program outputs write them to device memory;
* a ring is a circular buffer of ``depth * B`` planes, indexed by the
  global plane modulo its length (panel p sits in slot p mod depth, as
  on the TPU); reads of other groups' fields take the plane they need
  from it directly, so no window is ever assembled;
* boundary conditions come from global coordinates (constant fill,
  shrink JUNK_VAL, copy centre), as in the panel kernel: rows whose
  plane lies outside [0, I) hold stale ring data or junk, and every read
  with an i-offset that could carry such a row into an in-range plane
  is masked, the invariant of the TPU kernel;
* inputs that do not span i, and scalars, are read from device memory
  and kernel arguments.

What bounds it on the H100: as the panel kernel, instruction rate and
latency inside the block rather than device-memory bytes (jacobi2d
8192^2 x 8 moves 512 MiB, 0.160 ms at 3.35 TB/s): a __syncthreads() after every
stage of every panel, index and boundary arithmetic on every read, and
shared memory.  The rings and the widest group's live blocks must fit
227 KB, which caps B and the tile, and with J = 1 a row of 8192 cells
gives few blocks to spread over 132 SMs; the planner weighs that
(``stacked_io.tile_cost``).  Tensor cores, TMA loads, i-segments and
register blocking are later work.

Not ported (TPU-only, ROADMAP ground rules): the interior split, direct
input windows, the bool wire and narrow stores, VMEM limits, bf16 ring
storage, and the auto-B preference for sublane multiples of 8.

``group_plain`` runs the same schedule from the same plan in torch ops,
all tiles at once; the wrapper ``run_group`` takes it for CPU tensors
only and launches the CUDA kernel (codegen.py ``group_source``) for CUDA
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import H100_SMEM_PER_BLOCK
from ..dtypes import to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .panel import tile_candidates
from .stacked_io import (accesses_with_center, bc_select,
                         check_scope, gather_global, or_mask,
                         resolve_device, run_kernel, spanned_arrays,
                         tile_cost)
from .tile_eval import eval_kernel_statements

# number of kernel launches (CUDA tensors only)
launches = 0


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

    def smem_layout(self, program: ir.Program):
        """(byte offset of each ring, per group {stage: byte offset of its
        block}, total bytes) of the block's shared memory."""
        off, rings = 0, {}
        for f in self.rings:
            rings[f] = off
            RJ, RK = self.region(f)
            off += _align16(self.depth[f] * self.B * RJ * RK * np.dtype(
                program.field_dtype(f)).itemsize)
        temps, peak = [], 0
        for gi in range(len(self.groups)):
            t = self.temps(program, gi)
            temps.append({s: off + o for s, (o, _) in t.items()})
            peak = max([peak] + [o + n for o, n in t.values()])
        return rings, temps, off + peak

    def smem_bytes(self, program: ir.Program) -> int:
        return self.smem_layout(program)[2]

    def work(self, program: ir.Program) -> int:
        """Cells one block evaluates per step: ingested planes plus every
        live stage's widened block."""
        cells = sum(self.B * self.region(f)[0] * self.region(f)[1]
                    for f in self.rings if f in program.inputs)
        for gi in range(len(self.groups)):
            for s in self.live(gi):
                RJ, RK = self.region(s)
                cells += self.rows(gi, s) * RJ * RK
        return cells


# -- planner ---------------------------------------------------------------

def _fit(program: ir.Program, analysis: ChainAnalysis, B: int, group: int,
         tile: Optional[Tuple[int, int]]) -> Optional[GroupPlan]:
    """The plan at panel size B on ``tile``, or on the tile of least
    modelled cost; None when nothing fits shared memory."""
    plan = GroupPlan.build(program, analysis, B, group)
    plan.place(program, analysis)
    if tile is not None:
        plan.tile = tuple(tile)
        return (plan if plan.smem_bytes(program) <= H100_SMEM_PER_BLOCK
                else None)
    best = None
    for cand in tile_candidates(program.dimensions):
        plan.tile = cand
        smem = plan.smem_bytes(program)
        if smem > H100_SMEM_PER_BLOCK:
            continue
        ntj, ntk = plan.grid(program.dimensions)
        cost = (tile_cost(ntj * ntk, smem, plan.work(program)),
                -cand[0] * cand[1])
        if best is None or cost < best[0]:
            best = (cost, cand)
    if best is None:
        return None
    plan.tile = best[1]
    return plan


def plan_group(program: ir.Program, analysis: Optional[ChainAnalysis] = None,
               panel: int = 0, group: int = 2,
               tile: Optional[Tuple[int, int]] = None) -> GroupPlan:
    """The group kernel's plan: panel size B (``panel``, 0 = the JAX
    package's auto rule), groups of at most ``group`` stages, and a (tj,
    tk) tile that fits shared memory.  An auto B steps down by divisors
    of I until some tile fits; an explicit B that fits nowhere, or does
    not divide I, raises ValueError (nothing is built)."""
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
    plan = _fit(program, analysis, B, group, tile)
    while auto and plan is None and B > 1:
        B = max(d for d in range(1, B // 2 + 1) if I % d == 0)
        plan = _fit(program, analysis, B, group, tile)
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
                rings[f][t * B % rings[f].shape[0]:][:B] = gather_global(
                    arrays[f], program.inputs[f].dim_mask,
                    (planes(t * B, B), gj, gk), dims).expand(
                        (B, ntj, ntk) + plan.region(f))
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
                    rings[s][q * B % rings[s].shape[0]:][:B] = core
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
    global launches
    outs, launched = run_kernel(
        program, arrays,
        lambda: lib if lib is not None else build_group(program, analysis,
                                                        plan),
        lambda: group_plain(program, analysis, plan, arrays))
    launches += launched
    return outs


def compile_chain_group(program: ir.Program,
                        analysis: Optional[ChainAnalysis] = None,
                        panel: int = 0, group: int = 2,
                        tile: Optional[Tuple[int, int]] = None,
                        device="cuda"):
    """Plan the group kernel (``plan_group``: ValueError /
    NotImplementedError when the program is out of its scope) and, for a
    CUDA ``device``, build it.  Returns ``fn(inputs) -> outputs`` at the
    program's raw dims on ``device`` (inputs are moved there), with the
    plan as ``fn.plan``."""
    analysis = analysis or ChainAnalysis.run(program)
    plan = plan_group(program, analysis, panel, group, tile)
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

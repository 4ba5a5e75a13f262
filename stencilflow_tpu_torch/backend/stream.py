"""Plane streamer with banded transforms: the wide-affine-stage lowering.

Hopper counterpart of ``stencilflow_tpu/backend/stream.py``
(``_stream_kernel_body``, built by ``compile_chain_stream``): K3a, the
per-cell (VPU) stages on plane rings, and K3b, the wide affine stages as
banded transforms ``L @ P @ R`` (``_band_dot``, ``apply_transform_block``,
``mxu_eval``), composed runs and constant-BC correction planes, and K4,
the same streamer over one out-of-core i-chunk (``compile_local_stream``,
local mode below), and K3c, the ring spill (``choose_spill`` and the
spill rung, spill below).  Not ported here: j-tiling (the port tiles
(j, k) itself), bf16 compute / ring storage, micro-step blocks,
stage-major order and BC padding (pipeline workarounds for the TPU), and
the opt-in single-pass ``mxu_precision="bf16"`` mode
(NotImplementedError).

Planning follows the JAX package's choices per stage, untiled: compose
runs of separable stages (``compose.py``, ``compose="auto"``), then plan
every other stage with a footprint of at least 12 as banded transforms
(``linear.py``), the rest per cell.  ``StreamPlan.lags`` is the
reference's lag / ring algebra at one plane per step.

The kernel: one thread block owns a (tj, tk) core tile of the (j, k)
plane and marches i, as the panel kernel does, with

* a ring of raw planes per on-chip field, widened by the field's
  cumulative j/k halo, only as deep as its per-cell reads need (a field
  read only through transforms keeps one staging plane);
* a ring of transformed planes per transform key ``(field, L, R)``,
  filled when a plane of the field is produced: ``P @ R`` along k into a
  scratch tile, then ``L @ .`` along j, as direct f32 sums over the
  band's diagonals.  The diagonals are vectors over the global index
  (``BandMat``'s form, rows of composed bands vary near the domain
  edges), and reads outside [0, J) or [0, K) contribute 0 — exactly the
  truncated band matrix;
* banded stages sum their groups' transformed planes with the terms'
  scales, add the correction plane (a global (J, K) array), take
  ``bc_value * weight_sum`` for an i-out-of-domain group, and a composed
  stage weights its transformed planes by the i-table row of its global
  output plane.

``mxu_precision`` "split" and "exact" both run the transforms in f32,
which is at least as accurate as the TPU's bf16 hi/lo split (results
agree with the oracle within ``MXU_VERIFY_RTOL``).  No library matmul or
convolution is called on the card.

What bounds it on the H100: the bound of the work is the larger of the
HBM bytes (each input read once, each output written once) and the f32
FMA count of the plan's executed transforms (``mxu_flops_per_cell``,
2 flops per diagonal per side per cell) over the 67 TFLOP/s f32 rate;
for box-r2 256^3 x 8 composed those are about 0.04 ms and 0.03 ms.  This
first kernel is far from either: every tap is a shared-memory read plus
a coefficient load, the widened tiles recompute the halo, and the
transform rings (33 planes deep for the composed box) cap the tile; a
deep per-stage chain (cross-r2 x 8, halo 16) only fits 4 x 8 tiles.  The design does the one thing that matters most for the bound
— each transform is computed once per source plane and shared by every
i-offset and group that reads it — and leaves tensor cores (wgmma), TMA
loads and register blocking to a later PR.

``stream_plain`` runs the same function under the same plan in torch
ops on whole planes (band transforms through ``torch.matmul``, the
i-combine, per-cell stages through ``tile_eval``); the wrapper
``run_stream`` takes it for CPU tensors only, and launches the CUDA
kernel (codegen.py ``stream_source``) for CUDA tensors.

Local mode (K4, the counterpart of ``compile_local_stream``): a plan
built with ``block = Ic`` and ``halo_i = h`` streams one i-chunk of
``Ii = Ic + 2h`` planes, the core widened by the chain's cumulative
i-halo (``plan_local``).  The kernel, ``sf_local_stream``, takes the
chunk's global ``origin_i`` (the global index of local plane 0) as a
launch argument: a stage at local plane q works on global plane
``origin_i + q``, every i-offset read and every banded group's
``bc_value * weight_sum`` is masked against the global [0, I), inputs
come from the local (Ii, J, K) slabs, and only the core planes [h, h +
Ic) are written, to (Ic, J, K) outputs.  Reads that leave the chunk
reach only planes outside the core (h covers the chain's reach), so
whatever they find there never lands in an output.  Per-cell and
uncomposed banded stages only, as the reference's chunk path builds it.
``run_local_stream`` is its wrapper (count ``local_launches``) and
``local_stream_plain`` its plain version.  Its bound is its chunk's
bytes (slabs in, core planes out); it recomputes the chunk's 2h halo
planes (1.125x the core at h = 8, Ic = 128) so that chunks need nothing
from each other, and an out-of-core call is bound by the host copies
around it, not by the kernel (PERF.md).

Spill (K3c, the counterpart of ``choose_spill`` and the last rung of the
reference's ``compile_chain_stream``): when no tile fits the shared-memory
budget (``smem_budget``) with every ring on chip, a per-cell plan (no
banded or composed stage, as the reference's rung) moves rings to a
buffer in device memory, in ``choose_spill``'s order — each ring's read
deltas collected as the reference does (``lag[c] - oi`` per read, plus
the copy-BC centre read), candidates sorted by ``ring / (1 + |deltas|)``
descending — until the rest fits.  One thing differs, because device
memory here is read in place through L1/L2 rather than copied in by DMA:
a spilled ring keeps no plane on chip (the TPU keeps a staging plane and
one read buffer per delta), so it frees its whole ring and a depth-1
ring can spill too; the traffic it adds per step is still the
reference's, one plane written and |deltas| planes read.  Each tile is
costed by ``tile_cost`` with that traffic added, and a tile whose spill
buffer (blocks x spilled bytes per block) exceeds ``SPILL_BYTES_CAP`` is
refused.  The kernel's spilled ring pointers point into the block's own
region of that buffer (``sf_spill``, allocated once per plan and device
beside ``device_pool``), with the same slot arithmetic as shared memory;
the plain version does not change (spilling moves storage, not
arithmetic).  Launches of a spilled plan count in ``spill_launches``.
Bound: the same bytes as the unspilled kernel; it pays the halo
recompute of small tiles and the spilled rings' traffic through L2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import H100_SMEM_PER_BLOCK
from ..dtypes import to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .compose import ComposedPlan, compose_program, plan_composed
from .linear import (MatrixPool, band_diagonals, finalize_pool,
                     mxu_flops_per_cell, plan_all_stages)
from .panel import ring_fields, tile_candidates
from .stacked_io import (SPILL_BYTES_CAP,
                         accesses_with_center, bc_select, check_scope,
                         or_mask, resolve_device, run_kernel,
                         spanned_arrays, tile_cost)
from .tile_eval import eval_kernel_statements

# number of kernel launches (CUDA tensors only): the whole-domain stream
# kernel (K3), the local chunk kernel (K4), and either with spilled rings
# (K3c)
launches = 0
local_launches = 0
spill_launches = 0

# the JAX package's gate for banded stages (compile_chain_stream's
# mxu_min_footprint default)
MXU_MIN_FOOTPRINT = 12

TKey = Tuple[str, Optional[str], Optional[str]]


@dataclasses.dataclass
class StreamPlan:
    program: ir.Program            # the program the kernel runs (composed)
    analysis: ChainAnalysis
    lag: Dict[str, int]            # per field: newest plane at step t is
    #                                t - lag (the reference's algebra)
    ring: Dict[str, int]           # the reference's ring depths (B = 1)
    lag_max: int
    mxu_plans: Dict[str, object]   # banded stages: LinearStagePlan or
    #                                ComposedPlan
    composed: Dict[str, List[str]]  # composed stage -> replaced stages
    pool: Dict[str, np.ndarray]    # referenced pool matrices / planes
    tkeys: List[TKey]              # transform rings (on-chip fields)
    raw_ring: Dict[str, int]       # per on-chip field: raw ring depth
    tring: Dict[TKey, int]         # per transform key: ring depth
    halo: Dict[str, Tuple[int, int]]   # per field: (j, k) tile widening
    thalo: Dict[TKey, Tuple[int, int]]
    tile: Tuple[int, int] = (0, 0)
    block: int = 0                 # local mode: core i-planes of a chunk
    #                                (0: the whole domain)
    halo_i: int = 0                # local mode: i-halo each side of it
    # K3c: spilled raw rings -> their sorted read deltas (choose_spill's)
    spilled: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # kernel_pool() arrays (then the spill buffer) on each device the
    # kernel ran on
    device_pool: Dict[object, List[torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    bands: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                repr=False)

    @staticmethod
    def lags(analysis: ChainAnalysis, min_lag_max: int = 0,
             direct_emit: bool = True):
        """(lag, ring, lag_max) of ``stencilflow_tpu/backend/stream.py``
        ``StreamPlan.build`` at block 1 (a local plan passes the
        reference's ``min_lag_max=h, direct_emit=h == 0``)."""
        program = analysis.program

        def i_range(kname, field):
            accs = program.kernels[kname].accesses()[field]
            offs = [a[0] for a in accs if a[0] is not None]
            if not offs:
                return (0, 0)
            return (min(0, min(offs)), max(0, max(offs)))

        lag: Dict[str, int] = {n: 0 for n in program.inputs}
        for kname in analysis.graph.kernel_order:
            lag[kname] = max((lag[f] + i_range(kname, f)[1]
                              for f in analysis.graph.producers(kname)),
                             default=0)
        lag_max = max(max(lag[o] for o in program.outputs), min_lag_max)
        streamed = [n for n, sp in program.inputs.items()
                    if not sp.is_scalar and sp.dim_mask[0]]
        ring: Dict[str, int] = {}
        for f in streamed + list(program.kernels):
            depth = 1
            consumed = f in program.inputs
            for c in analysis.graph.consumers(f):
                if c not in program.kernels:
                    continue
                consumed = True
                depth = max(depth, 1 + lag[c] - i_range(c, f)[0] - lag[f])
            if f in program.outputs:
                if not direct_emit:
                    depth = max(depth, 1 + lag_max - lag[f])
                elif not consumed:
                    continue   # pure output: emitted directly, no ring
            ring[f] = depth
        return lag, ring, lag_max

    # -- the streamed extent -------------------------------------------------
    def extent(self) -> int:
        """Planes streamed: the chunk's Ic + 2h in local mode, else I."""
        if self.block:
            return self.block + 2 * self.halo_i
        return self.program.dimensions[0]

    def steps(self) -> int:
        """Plane steps of the kernel's i loop, the reference's grid
        ``Bi + halo_i + lag_max`` (I + lag_max for the whole domain)."""
        return self.extent() + self.lag_max - self.halo_i

    # -- geometry ------------------------------------------------------------
    def band(self, key: str, side: str):
        """(offsets, coef) of pool matrix ``key`` (linear.band_diagonals)."""
        if key not in self.bands:
            self.bands[key] = band_diagonals(self.pool[key], side)
        return self.bands[key]

    def reach(self, key: Optional[str], side: str) -> int:
        if key is None:
            return 0
        offs = self.band(key, side)[0]
        return max(abs(offs[0]), abs(offs[-1]))

    def region(self, f) -> Tuple[int, int]:
        hj, hk = self.thalo[f] if isinstance(f, tuple) else self.halo[f]
        return self.tile[0] + 2 * hj, self.tile[1] + 2 * hk

    def scratch_shape(self, tkey: TKey) -> Tuple[int, int]:
        """(rows, cols) of the k-pass scratch of a two-sided transform."""
        TJ, TK = self.region(tkey)
        return TJ + 2 * self.reach(tkey[1], "L"), TK

    def ring_bytes(self, f: str) -> int:
        """Bytes of field ``f``'s raw ring, rounded up to 16."""
        tj, tk = self.region(f)
        size = self.raw_ring[f] * tj * tk * np.dtype(
            self.program.field_dtype(f)).itemsize
        return -(-size // 16) * 16

    def smem_offsets(self) -> Dict[object, int]:
        """Byte offset of every on-chip raw ring (spilled ones excepted),
        transform ring and the k-pass scratch (key "") in the block's
        shared memory; "end" = total."""
        off, out = 0, {}
        for f in self.raw_ring:
            if f not in self.spilled:
                out[f] = off
                off += self.ring_bytes(f)
        for tkey, depth in self.tring.items():
            out[tkey] = off
            tj, tk = self.region(tkey)
            off += -(-(depth * tj * tk * 4) // 16) * 16
        out[""] = off
        two = [math.prod(self.scratch_shape(t)) for t in self.tkeys
               if t[1] is not None and t[2] is not None]
        off += -(-(max(two, default=0) * 4) // 16) * 16
        out["end"] = off
        return out

    def smem_bytes(self) -> int:
        return self.smem_offsets()["end"]

    def spill_offsets(self) -> Dict[str, int]:
        """Byte offset of every spilled ring in one block's region of the
        spill buffer; "end" = the region's size (a multiple of 128)."""
        off, out = 0, {}
        for f in self.raw_ring:
            if f in self.spilled:
                out[f] = off
                off += self.ring_bytes(f)
        out["end"] = -(-off // 128) * 128
        return out

    def spill_bytes(self) -> int:
        """Bytes of the spill buffer: every block's region."""
        ntj, ntk = self.grid()
        return ntj * ntk * self.spill_offsets()["end"]

    def grid(self) -> Tuple[int, int]:
        dims = self.program.dimensions
        return -(-dims[1] // self.tile[0]), -(-dims[2] // self.tile[1])

    def work(self) -> int:
        """Modelled per-block work of one plane step: cells of every stage
        and ring input region, plus transform taps / 8, plus each spilled
        ring's device-memory traffic (one plane written, one read per
        delta)."""
        program = self.program
        cells = sum(math.prod(self.region(f)) for f in program.kernels)
        cells += sum(math.prod(self.region(f)) for f in self.raw_ring
                     if f in program.inputs)
        cells += sum(math.prod(self.region(f)) * (1 + len(d))
                     for f, d in self.spilled.items())
        taps = 0
        for t in self.tkeys:
            TJ, TK = self.region(t)
            nl = len(self.band(t[1], "L")[0]) if t[1] else 0
            nr = len(self.band(t[2], "R")[0]) if t[2] else 0
            rows = self.scratch_shape(t)[0] if t[1] and t[2] else TJ
            taps += rows * TK * nr + TJ * TK * nl
        return cells + taps // 8

    def kernel_pool(self) -> List[Tuple[str, np.ndarray]]:
        """The device arrays the kernel reads, in argument order: the
        diagonal table of every band it applies, correction planes and
        composed i-tables."""
        keys: Dict[str, str] = {}
        for mp in self.mxu_plans.values():
            if isinstance(mp, ComposedPlan):
                for k, side in ((mp.lkey, "L"), (mp.rkey, "R")):
                    if k:
                        keys[k] = side
                keys[mp.table_key] = ""
                continue
            for grp in mp.groups:
                if grp.correction_key:
                    keys[grp.correction_key] = ""
                for t in grp.terms:
                    for k, side in ((t.left_key, "L"), (t.right_key, "R")):
                        if k:
                            keys[k] = side
        out = []
        for k in sorted(keys):
            arr = (self.band(k, keys[k])[1] if keys[k] else
                   np.ascontiguousarray(self.pool[k], np.float32))
            out.append((k, arr))
        return out

    def flops_per_cell(self) -> float:
        """Executed f32 flops per cell of the plan's transforms."""
        return mxu_flops_per_cell(self.pool, self.tkeys)

    def last_config(self) -> dict:
        """The JAX package's ``compile_chain_stream.last_config`` keys."""
        return {"mxu_stages": sorted(self.mxu_plans),
                "composed": {k: list(v) for k, v in self.composed.items()},
                "jtiles": 1, "spilled": sorted(self.spilled),
                "tile": self.tile}


# -- planner -------------------------------------------------------------------

def spill_deltas(plan: StreamPlan) -> Dict[str, set]:
    """``choose_spill``'s read deltas of every raw ring: ``lag[c] - oi``
    for each read of the field by stage ``c``, plus ``lag[c]`` for a
    copy-BC centre read."""
    program = plan.program
    deltas: Dict[str, set] = {f: set() for f in plan.raw_ring}
    for kname in plan.analysis.graph.kernel_order:
        kspec = program.kernels[kname]
        for f, accs in kspec.accesses().items():
            if f not in deltas:
                continue
            for a in accs:
                deltas[f].add(plan.lag[kname] - (a[0] or 0))
            bc = kspec.boundary_conditions.get(f)
            if bc is not None and bc.kind == ir.BCKind.COPY:
                deltas[f].add(plan.lag[kname])
    return deltas


def spill_order(plan: StreamPlan, deltas: Dict[str, set]) -> List[str]:
    """The raw rings in ``choose_spill``'s order: the reference's ring
    depth per read delta, descending (a stable sort of the ring order)."""
    return sorted([f for f in plan.ring if f in plan.raw_ring],
                  key=lambda f: -(plan.ring[f] / (1 + len(deltas[f]))))


def _spill_to_fit(plan: StreamPlan, order: List[str], deltas, budget: int
                  ) -> bool:
    """Spill rings of ``plan`` at its tile in ``order`` until the rest
    fits ``budget`` bytes of shared memory; False when nothing does or
    the spill buffer exceeds ``SPILL_BYTES_CAP``."""
    plan.spilled = {}
    for f in order:
        if plan.smem_bytes() <= budget:
            break
        if deltas[f]:
            plan.spilled[f] = tuple(sorted(deltas[f]))
    return (plan.smem_bytes() <= budget
            and plan.spill_bytes() <= SPILL_BYTES_CAP)


def _build_plan(program: ir.Program, analysis: ChainAnalysis, mxu: str,
                mxu_precision: str, builds, tile, block: int = 0,
                halo_i: int = 0, smem_budget: int = H100_SMEM_PER_BLOCK,
                spill: str = "off") -> StreamPlan:
    dims = program.dimensions
    I, J, K = dims
    pool = MatrixPool()
    plans: Dict[str, object] = {}
    if mxu != "off":
        plans = plan_all_stages(program, (J, K), dims, pool,
                                MXU_MIN_FOOTPRINT, exclude=tuple(builds))
    for cname, b in builds.items():
        cp = plan_composed(b, (J, K), dims, pool)
        if cp is None:
            raise ValueError(f"composed segment {cname} not plannable")
        plans[cname] = cp
    pkeys, parrs, tkeys_all = finalize_pool(plans, pool, program,
                                            mxu_precision)
    # a local plan takes the reference's chunk algebra (lag_max at least
    # h, rings for outputs when h > 0: the TPU emits outputs through them
    # once the top halo is ingested); the kernel here writes each core
    # plane to device memory when it is computed, so the rings it
    # allocates (raw_ring, tring below) hold no output plane for that
    lag, ring, lag_max = StreamPlan.lags(analysis, min_lag_max=halo_i,
                                         direct_emit=halo_i == 0)
    onchip = ring_fields(program, analysis)
    tkeys = [t for t in tkeys_all if t[0] in onchip]

    # ring depths from the reads each ring serves: per-cell reads of raw
    # planes, and transformed-plane reads of the transform rings
    raw: Dict[str, int] = {f: 1 for f in onchip}
    tdepth: Dict[TKey, int] = {}
    readers: Dict[TKey, List[str]] = {t: [] for t in tkeys}

    def need(c, f, oi):
        return lag[c] - lag[f] - (oi or 0) + 1

    for c in analysis.graph.kernel_order:
        mp = plans.get(c)
        if mp is None:
            for f, alist in accesses_with_center(program.kernels[c]).items():
                if f in raw:
                    for a in alist:
                        raw[f] = max(raw[f], need(c, f, a[0]))
            continue
        if isinstance(mp, ComposedPlan):
            reads = [((mp.field, mp.lkey, mp.rkey), d) for d in mp.offsets]
        else:
            reads = [((g.field, t.left_key, t.right_key), g.oi)
                     for g in mp.groups for t in g.terms]
        for tkey, oi in reads:
            f = tkey[0]
            if tkey in readers:
                tdepth[tkey] = max(tdepth.get(tkey, 1), need(c, f, oi))
                if c not in readers[tkey]:
                    readers[tkey].append(c)
            elif f in raw and tkey[1] is None and tkey[2] is None:
                raw[f] = max(raw[f], need(c, f, oi))

    stage = analysis.stage_halo()
    inp = analysis.input_halo()
    halo = {f: tuple((stage.get(f) or inp.get(f))[1:])
            for f in list(onchip) + list(program.kernels)}
    plan = StreamPlan(program, analysis, lag, ring, lag_max, plans,
                      {n: list(b.stages) for n, b in builds.items()},
                      dict(zip(pkeys, parrs)), tkeys, raw, tdepth, halo,
                      {}, block=block, halo_i=halo_i)
    for t in tkeys:
        plan.thalo[t] = tuple(max(halo[c][d] for c in readers[t])
                              for d in range(2))
        need_j = plan.thalo[t][0] + plan.reach(t[1], "L")
        need_k = plan.thalo[t][1] + plan.reach(t[2], "R")
        if halo[t[0]][0] < need_j or halo[t[0]][1] < need_k:
            raise ValueError(f"field {t[0]} halo {halo[t[0]]} is narrower "
                             f"than its transform's reach ({need_j}, "
                             f"{need_k})")
    # the spill rung: per-cell plans only, as the reference's
    spillable = spill != "off" and not plans
    if spillable:
        deltas = spill_deltas(plan)
        order = spill_order(plan, deltas)
    if tile is not None:
        plan.tile = tuple(tile)
        if plan.smem_bytes() <= smem_budget or (
                spillable and _spill_to_fit(plan, order, deltas,
                                            smem_budget)):
            return plan
        raise ValueError(f"stream tile {tile} exceeds shared memory")
    best = None
    for leg in ("on chip", "spill") if spillable else ("on chip",):
        for cand in tile_candidates(dims):
            plan.tile = cand
            if leg == "spill":
                if not _spill_to_fit(plan, order, deltas, smem_budget):
                    continue
            elif plan.smem_bytes() > smem_budget:
                continue
            ntj, ntk = plan.grid()
            cost = (tile_cost(ntj * ntk, plan.smem_bytes(), plan.work()),
                    -cand[0] * cand[1])
            if best is None or cost < best[0]:
                best = (cost, cand, plan.spilled)
        if best is not None:
            break
    if best is None:
        raise ValueError("stream rings exceed shared memory at every tile"
                         + (" (spilled: over the device-memory cap)"
                            if spillable else ""))
    plan.tile, plan.spilled = best[1], best[2]
    return plan


def check_spill(spill: str) -> None:
    if spill not in ("auto", "off"):
        raise ValueError(f"spill must be 'auto' or 'off', got {spill!r}")


def check_options(mxu: str, mxu_precision: str) -> None:
    """Raise on options the stream lowering does not take."""
    if mxu not in ("auto", "off"):
        raise ValueError(f"mxu must be 'auto' or 'off', got {mxu!r}")
    if mxu_precision == "bf16":
        raise NotImplementedError(
            "mxu_precision='bf16' (single-pass bf16 transforms) is not "
            "ported yet")
    if mxu_precision not in ("split", "exact"):
        raise ValueError(f"unknown mxu_precision {mxu_precision!r} "
                         "(expected split, bf16, or exact)")


def plan_stream(program: ir.Program, analysis: Optional[ChainAnalysis] = None,
                mxu: str = "auto", mxu_precision: str = "split",
                compose: str = "auto",
                tile: Optional[Tuple[int, int]] = None,
                smem_budget: int = H100_SMEM_PER_BLOCK,
                spill: str = "auto") -> StreamPlan:
    """The stream lowering's plan, making the JAX package's per-stage
    choice between composed, per-stage banded and per-cell, in the
    reference's order: composed, banded, every stage per cell, and last
    the spill rung (``spill="auto"``: per cell, rings spilled to device
    memory).  ``smem_budget`` is the shared memory one block may take
    (the reference's ``vmem_budget``).  Raises ValueError /
    NotImplementedError when the program is out of scope (nothing is
    built)."""
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    check_options(mxu, mxu_precision)
    check_spill(spill)
    if compose != "off" and mxu != "off":
        max_t = 0 if compose == "auto" else int(compose)
        got = compose_program(program, analysis, max_t) if max_t >= 0 \
            else None
        if got is not None:
            program2, builds = got
            try:
                return _build_plan(program2, ChainAnalysis.run(program2),
                                   mxu, mxu_precision, builds, tile,
                                   smem_budget=smem_budget)
            except ValueError:
                pass   # the uncomposed program below
    if mxu != "off":
        try:
            return _build_plan(program, analysis, mxu, mxu_precision, {},
                               tile, smem_budget=smem_budget, spill=spill)
        except ValueError:
            pass   # every stage per cell below
    return _build_plan(program, analysis, "off", mxu_precision, {}, tile,
                       smem_budget=smem_budget, spill=spill)


def plan_local(program: ir.Program, analysis: Optional[ChainAnalysis],
               block: int, halo_i: int, mxu: str = "auto",
               mxu_precision: str = "split",
               tile: Optional[Tuple[int, int]] = None,
               smem_budget: int = H100_SMEM_PER_BLOCK,
               spill: str = "auto") -> StreamPlan:
    """The local (chunk) plan of K4: ``block`` core i-planes widened by
    ``halo_i`` planes each side; stages banded where ``mxu`` is "auto"
    and the banded planner takes them (never composed), the rest per
    cell; a per-cell plan spills rings (``spill="auto"``) when no tile
    fits ``smem_budget`` otherwise.  Raises ValueError /
    NotImplementedError when the program is out of scope or no tile
    fits."""
    if block < 1 or halo_i < 0:
        raise ValueError(f"bad local block {block} / i-halo {halo_i}")
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    check_options(mxu, mxu_precision)
    check_spill(spill)
    return _build_plan(program, analysis, mxu, mxu_precision, {}, tile,
                       block=block, halo_i=halo_i, smem_budget=smem_budget,
                       spill=spill)


# -- plain version --------------------------------------------------------------

def _junk(dtype: torch.dtype, shape, device) -> torch.Tensor:
    """A plane standing for one outside the chunk: NaN (largest negative
    integer, True) — any of it reaching a core plane shows."""
    if dtype.is_floating_point:
        fill = float("nan")
    elif dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(dtype).min
    return torch.full(shape, fill, dtype=dtype, device=device)


def stream_plain(plan: StreamPlan, arrays: Dict[str, torch.Tensor],
                 origin_i: int = 0) -> Dict[str, torch.Tensor]:
    """The plan's function in torch ops on whole (J, K) planes, streamed
    along i: per-cell stages through tile_eval with the boundary rules of
    the kernels, banded stages as ``L @ P @ R`` matmuls, the correction
    planes and the composed i-combine.  ``arrays`` holds every input at
    its spanned shape (0-d for scalars), i-spanning inputs at the plan's
    extent; returns the core planes, (I, J, K) for a whole-domain plan
    and (block, J, K) for a local one, whose local plane 0 is global
    plane ``origin_i``.  A read of a plane outside the chunk gets a junk
    plane (``_junk``)."""
    program = plan.program
    I, J, K = program.dimensions
    Ii, h = plan.extent(), plan.halo_i
    Ic = Ii - 2 * h
    device = next(a for n, a in arrays.items()
                  if not program.inputs[n].is_scalar).device
    f32 = torch.float32
    mats = {k: torch.as_tensor(v).to(device) for k, v in plan.pool.items()}
    planes: Dict[str, Dict[int, torch.Tensor]] = {}
    tcache: Dict[Tuple[TKey, Optional[int]], torch.Tensor] = {}
    outs = {o: torch.empty((Ic, J, K), device=device,
                           dtype=to_torch_dtype(program.kernels[o].dtype))
            for o in program.outputs}
    jj = torch.arange(J, device=device)[:, None]
    kk = torch.arange(K, device=device)[None, :]

    def inside(p):
        """Is global plane ``p`` in the domain?"""
        return 0 <= origin_i + p < I

    def plane(f, p):
        """Raw (J, K) plane ``p`` of field ``f`` (broadcast for lower-rank
        inputs and scalars)."""
        dt = to_torch_dtype(program.field_dtype(f))
        if f in program.kernels:
            got = planes.get(f, {}).get(p)
            return got if got is not None else _junk(dt, (J, K), device)
        spec = program.inputs[f]
        a = arrays[f].to(device)
        if spec.is_scalar:
            return a.expand(J, K)
        if spec.dim_mask[0]:
            if not 0 <= p < Ii:
                return _junk(dt, (J, K), device)
            a = a[p]
        return a.reshape(J if spec.dim_mask[1] else 1,
                         K if spec.dim_mask[2] else 1).expand(J, K)

    def transformed(f, p, lkey, rkey):
        key = ((f, lkey, rkey), p)
        if key not in tcache:
            v = plane(f, p).to(f32)
            if lkey is not None:
                v = torch.matmul(mats[lkey], v)
            if rkey is not None:
                v = torch.matmul(v, mats[rkey])
            tcache[key] = v
        return tcache[key]

    def f32c(x):
        return torch.tensor(np.float32(x), device=device)

    def banded(mp, q):
        if isinstance(mp, ComposedPlan):
            tab = plan.pool[mp.table_key]
            row = q if mp.full_table else (
                q if q < mp.D else
                mp.table_rows + q - I if q >= I - mp.D else mp.D)
            row = min(max(row, 0), mp.table_rows - 1)
            acc = torch.zeros((J, K), dtype=f32, device=device)
            for idx, d in enumerate(mp.offsets):
                if 0 <= q + d < I:
                    acc = acc + transformed(mp.field, q + d, mp.lkey,
                                            mp.rkey) * f32c(tab[row, idx])
            return acc
        acc = None
        for grp in mp.groups:
            p = None if grp.oi is None else q + grp.oi
            if p is not None and not inside(p):
                parts = f32c(grp.bc_value * grp.weight_sum).expand(J, K)
            else:
                parts = None
                for term in grp.terms:
                    val = transformed(grp.field, p, term.left_key,
                                      term.right_key)
                    if (term.left_key is None and term.right_key is None
                            or term.scale != 1.0):
                        val = val * f32c(term.scale)
                    parts = val if parts is None else parts + val
                if grp.correction_key is not None:
                    parts = parts + mats[grp.correction_key]
            acc = parts if acc is None else acc + parts
        if mp.bias:
            acc = acc + f32c(mp.bias)
        return acc

    def per_cell(kspec, q):
        def read(field, offsets):
            dt = np.dtype(program.field_dtype(field))
            if field in program.inputs and program.inputs[field].is_scalar:
                return arrays[field].to(device), dt
            bc = kspec.boundary_conditions.get(field)
            oi, oj, ok = (o or 0 for o in offsets)
            mask = True if oi and not inside(q + oi) else None
            if mask is True:
                val = plane(field, q)
            else:
                if oj:
                    mask = or_mask(mask, (jj + oj < 0) | (jj + oj >= J))
                if ok:
                    mask = or_mask(mask, (kk + ok < 0) | (kk + ok >= K))
                val = torch.roll(plane(field, q + oi), (-oj, -ok), (0, 1))
            return bc_select(bc, dt, mask, val, lambda: plane(field, q)), dt
        return eval_kernel_statements(kspec, read, (J, K), device)

    for t in range(plan.steps()):
        for s in plan.analysis.graph.kernel_order:
            q = t - plan.lag[s]
            if not 0 <= q < Ii:
                continue
            mp = plan.mxu_plans.get(s)
            val = banded(mp, q) if mp is not None else \
                per_cell(program.kernels[s], q)
            if s in plan.ring:
                planes.setdefault(s, {})[q] = val.contiguous()
                planes[s].pop(q - plan.ring[s], None)
            if s in outs and h <= q < h + Ic:
                outs[s][q - h] = val
        # drop transformed planes no reader can reach any more
        for key in [k for k in tcache if k[1] is not None
                    and k[1] < t - plan.lag[k[0][0]]
                    - plan.ring.get(k[0][0], 1)]:
            del tcache[key]
    return outs


# -- wrapper ---------------------------------------------------------------------

def stream_source(plan: StreamPlan) -> str:
    return codegen.stream_source(plan.program, plan.analysis, plan)


def build_stream(plan: StreamPlan):
    """Generate and compile the stream kernel for ``plan`` (the local
    kernel K4 for a local plan)."""
    return build.load_library(stream_source(plan),
                              "local_stream" if plan.block else "stream")


def _pool_tensors(plan: StreamPlan, device) -> List[torch.Tensor]:
    """The kernel's device tables, then its spill buffer (one per plan
    and device: launches on one stream reuse it in turn)."""
    if device not in plan.device_pool:
        plan.device_pool[device] = [
            torch.as_tensor(a).to(device).contiguous()
            for _k, a in plan.kernel_pool()]
        if plan.spilled:
            plan.device_pool[device].append(torch.empty(
                plan.spill_bytes(), dtype=torch.uint8, device=device))
    return plan.device_pool[device]


def _count(plan: StreamPlan, launched: int) -> None:
    global launches, local_launches, spill_launches
    if plan.spilled:
        spill_launches += launched
    elif plan.block:
        local_launches += launched
    else:
        launches += launched


def run_stream(plan: StreamPlan, arrays: Dict[str, torch.Tensor], lib=None):
    """The stream kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_stream``); it is built on demand
    when omitted."""
    if plan.block:
        raise ValueError("a local plan runs through run_local_stream")
    outs, launched = run_kernel(
        plan.program, arrays,
        lambda: lib if lib is not None else build_stream(plan),
        lambda: stream_plain(plan, arrays),
        extra=lambda device: _pool_tensors(plan, device))
    _count(plan, launched)
    return outs


def local_stream_plain(plan: StreamPlan, origin_i: int,
                       slabs: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """K4's plain version: ``stream_plain`` of a local plan on one
    chunk's slabs, local plane 0 at global plane ``origin_i``."""
    return stream_plain(plan, slabs, origin_i)


def _local_dims(plan: StreamPlan):
    _, J, K = plan.program.dimensions
    return (plan.extent(), J, K), (plan.block, J, K)


def run_local_stream(plan: StreamPlan, origin_i: int,
                     slabs: Dict[str, torch.Tensor], lib=None):
    """K4 on one chunk: ``slabs`` holds the i-spanning inputs at the
    plan's extent (Ic + 2h planes, zero outside the domain), the other
    inputs whole, scalars 0-d; ``origin_i`` is the global index of the
    slabs' first plane.  Returns the (Ic, J, K) core planes of every
    output.  ``lib`` is the built kernel (``build_stream``)."""
    if not plan.block:
        raise ValueError("run_local_stream takes a local plan (plan_local)")
    in_dims, out_dims = _local_dims(plan)
    outs, launched = run_kernel(
        plan.program, slabs,
        lambda: lib if lib is not None else build_stream(plan),
        lambda: stream_plain(plan, slabs, origin_i),
        extra=lambda device: _pool_tensors(plan, device),
        in_dims=in_dims, out_dims=out_dims, origin_i=origin_i)
    _count(plan, launched)
    return outs


def compile_local_stream(plan: StreamPlan, device="cuda"):
    """``chunk_fn(origin_i, slabs) -> outputs`` running the local plan
    ``plan`` on ``device`` (K4 built now for a CUDA device, the plain
    version on the CPU); ``slabs`` as ``run_local_stream`` takes them."""
    device = resolve_device(device)
    lib = build_stream(plan) if device.type == "cuda" else None

    def chunk_fn(origin_i, slabs):
        return run_local_stream(plan, int(origin_i), slabs, lib)

    chunk_fn.plan = plan
    chunk_fn.device = device
    return chunk_fn


def compile_stream_plan(plan: StreamPlan, device="cuda"):
    """``fn(inputs) -> outputs`` at the program's raw dims running
    ``plan`` on ``device`` (built now for a CUDA device)."""
    device = resolve_device(device)
    program = plan.program
    lib = build_stream(plan) if device.type == "cuda" else None

    def forward(inputs):
        arrays = spanned_arrays(program, inputs, device=device)
        outs = run_stream(plan, arrays, lib)
        return {o: v.reshape(program.raw_dimensions)
                for o, v in outs.items()}

    forward.plan = plan
    forward.last_config = plan.last_config()
    return forward


def compile_chain_stream(program: ir.Program,
                         analysis: Optional[ChainAnalysis] = None,
                         mxu: str = "auto", mxu_precision: str = "split",
                         compose: str = "auto",
                         tile: Optional[Tuple[int, int]] = None,
                         device="cuda",
                         smem_budget: int = H100_SMEM_PER_BLOCK,
                         spill: str = "auto"):
    """Plan the stream lowering (ValueError / NotImplementedError when the
    program is out of its scope) and, for a CUDA ``device``, build its
    kernel.  Returns ``fn(inputs) -> outputs`` at the program's raw dims,
    with the plan as ``fn.plan`` and the JAX package's configuration keys
    as ``fn.last_config``.  ``smem_budget`` and ``spill`` go to
    ``plan_stream``."""
    plan = plan_stream(program, analysis, mxu=mxu,
                       mxu_precision=mxu_precision, compose=compose,
                       tile=tile, smem_budget=smem_budget, spill=spill)
    return compile_stream_plan(plan, device)

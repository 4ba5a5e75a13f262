"""Plane streamer with banded transforms: the wide-affine-stage lowering.

Hopper counterpart of ``stencilflow_tpu/backend/stream.py``
(``_stream_kernel_body``, built by ``compile_chain_stream``): K3a, the
per-cell (VPU) stages on plane rings, and K3b, the wide affine stages as
banded transforms ``L @ P @ R`` (``_band_dot``, ``apply_transform_block``,
``mxu_eval``), composed runs and constant-BC correction planes, and K4,
the same streamer over one out-of-core i-chunk (``compile_local_stream``,
local mode below), and K3c, the ring spill (``choose_spill`` and the
spill rung, spill below), with the reference's opt-in reduced
precisions (bf16 below) and its reduced-precision compute (bf16 compute
below).  Not ported here: j-tiling (the port tiles (j, k) itself),
micro-step blocks, stage-major order and BC padding (pipeline workarounds
for the TPU).

Planning follows the JAX package's choices per stage, untiled: compose
runs of separable stages (``compose.py``, ``compose="auto"``), then plan
every other stage with a footprint of at least 12 as banded transforms
(``linear.py``), the rest per cell.  ``StreamPlan.lags`` is the
reference's lag / ring algebra at one plane per step.

The kernel's on-chip body (K3a, K3b, and K4 below): one thread block owns
a (tj, tk) core tile of the (j, k) plane and marches i on the panel
kernel's (K1's) skeleton, shared with it in codegen.py — ring slots from
per-step counters (no ``%`` in a read), a thread's cell from one
division before the march, a mask-free and a masked body per stage taken
per block and step, ring inputs loaded a step ahead with ``cp.async``
into a slot of their own, ``__launch_bounds__`` with the blocks per SM
the shared memory leaves room for — over the phases of
``StreamPlan.schedule``, each closed by a barrier:

* a ring of raw planes per on-chip field, widened by the field's
  cumulative j/k halo, as deep as its per-cell reads and its
  transforms' source planes need;
* a transform ``(field, L, R)`` read at one plane delta (every per-stage
  plan whose groups read it at one i-offset, as cross does) is computed
  in the phases right before its first reader's stage, from the raw
  ring the reader reads anyway, and lives within the step
  (``StreamPlan.instep``); one read at several deltas (a composed
  stage's 33-plane i-table, a per-stage box's five groups) keeps a ring
  filled right after its field's producer;
* a transform is ``P @ R`` along k into a scratch tile, then ``L @ .``
  along j (single-pass bf16 passes run the j-pass first, as the JAX
  package's ``(L @ P) @ R`` does: the rounded intermediate differs with
  the order, ``StreamPlan.pass_order``).  Sources hold 0 beyond the domain (inputs are loaded so, a
  transform's source stage writes 0 there), so a band whose columns are
  Toeplitz applies literal weights with no mask; a composed band's edge
  columns (``BandInfo``) read a window of its coefficient table that
  the block copies to shared memory once.  A pass runs on CUDA cores (one
  ``fmaf`` a tap) or, under ``mxu_precision="split"`` for bands of at
  least ``MMA_MIN_TAPS`` taps (``StreamPlan.route``), on tensor cores:
  ``sf_mma_band``, 16 x 8 tiles of ``mma.sync`` m16n8k8 TF32 with each
  operand split hi/lo and three products a k-step (the TPU's bf16 hi/lo
  split's counterpart); "exact" sums on CUDA cores;
* banded stages sum their groups' transformed planes with the terms'
  scales, add the correction plane (a global (J, K) array), take
  ``bc_value * weight_sum`` for an i-out-of-domain group, and a composed
  stage weights its transformed planes by the i-table row of its global
  output plane (the interior row's weights as literals in the mask-free
  body);
* shared memory is ``pack_layout``'s, the spill rung's placer run with
  nothing spilled: rings read across steps, transform rings and band
  copies have regions of their own; rings of one step, transform planes
  and scratch tiles share the rest first-fit by the phases they live in.
  A per-cell plan takes the on-chip body only where its rings fit
  unpacked, as before (packing those alone is the spill rung's).

The tile and the threads of a block (256 or 512) are the pair of least
modelled time (``StreamPlan.seconds``, the panel kernel's rule with the
band passes priced per route).  Both precisions agree with the oracle
within ``MXU_VERIFY_RTOL``.  No library matmul or convolution is called
on the card.

What bounds it on the H100: the bound of the work is the larger of the
HBM bytes (each input read once, each output written once) and the f32
FMA count of the plan's executed transforms (``mxu_flops_per_cell``,
2 flops per diagonal per side per cell) over the FP32 rate; for box-r2
256^3 x 8 composed those are about 0.04 ms and 0.03 ms.  The kernel is
bound by issue and latency inside the block: the halo recompute of the
widened tiles (cross-r2 x 8 at (16, 16): 30.75 stage evaluations a
cell), the passes' shared-memory reads, and a barrier a phase.  On an
NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py``, ``deep_time.py --cells
banded|local``) cross-r2 256^3 x 8 takes 3.68 ms (64.9 before this
design), box-r2 256^3 x 8 0.767 (2.55) and K4 on a jacobi3d 1024^3 x 8
chunk 4.46 (6.85).

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
``run_local_stream`` is its wrapper (count ``launches_by["local"]``) and
``local_stream_plain`` its plain version.  Its bound is its chunk's
bytes (slabs in, core planes out); it recomputes the chunk's 2h halo
planes (1.125x the core at h = 8, Ic = 128) so that chunks need nothing
from each other, and an out-of-core call is bound by the host copies
around it, not by the kernel (PERF.md).

The on-chip body (K3a, K4 in every mode) loads a ring input of 2-byte
cells held in slots of its own type by ``cp.async`` groups of 8 or 2
cells, its k-halo widened to a multiple of the group
(``copy_groups``, ``stacked_io.copy_group``): a chunk's plane is J x K
cells, so an even K keeps every group aligned at any i origin; a shard
needs an even core Bk and exchanged halo Xk too (its origins are
multiples of Bk), and ``run_local_stream`` refuses a k origin that is
not a multiple of the group.  The spill rung (K3c) keeps its own loads.

Shard mode (K4 on one shard of a mesh, the counterpart of
``compile_local_stream``'s ``pallas_call`` with a 3-element origin,
``mxu_assets`` and ``pool_locals``; ``parallel/domain.py`` plans and
drives it): a local plan with ``shard`` = (Bj, Bk), the shard's core,
and ``xhalo``, the (j, k) halo its inputs arrive widened by.  The
kernel's entry ``sf_shard_launch`` takes the shard's origin
(``origin_i`` as in local mode, ``origin_j``, ``origin_k``: the core's
global (j, k)); its blocks tile the core from there, so every cell keeps
its global (j, k) and every BC mask, Toeplitz range and i-table row is
taken at the global coordinate, as a (j, k) tile of the whole plane
takes them; inputs are read from the widened (Bj + 2Xj, Bk + 2Xk)
planes at their offset from the plane's origin, and only the core is
written, to (block, Bj, Bk) outputs.  Banded stages read this shard's
slice of the origin-aware band matrices and correction planes
(``linear.plan_linear_stage``'s j/k contexts: stacked keys hold a slice
per shard instance, ``kernel_pool(inst)``), passed per launch; the
source is one for every shard: a band's literal weights and its
Toeplitz range are global (``StreamPlan._shard_band_info``), only its
table (the columns where a composed band's products differ near an
edge) and the correction planes are read per shard.  Composed runs and
the spill rung take the same origin.  Launches count in
``launches_by["shard"]``.

Spill (K3c, the counterpart of ``choose_spill``, ``spill_prefetch``,
``spill_read`` and ``spill_write``, the last rung of the reference's
``compile_chain_stream``): when no tile fits the shared-memory budget
(``smem_budget``) with every ring on chip, a per-cell plan (no banded or
composed stage, as the reference's rung) takes the spill rung's layout
(``packed``, ``spill_layout``).  Shared memory is packed by liveness over
the phases of one plane step (phase 0 ingests the ring inputs, phase
1 + n runs the n-th stage): a ring read only in the step that writes it
(every read delta equals the producer's lag) shares space first-fit with
the other short-lived items, as the group kernel places its in-group
blocks.  Then, while the rest does not fit, rings move to a buffer in
device memory in ``choose_spill``'s order (each ring's read deltas
collected as the reference does, ``lag[c] - oi`` per read plus the
copy-BC centre read; candidates sorted by ``ring / (1 + |deltas|)``
descending), rings of one step excepted.  A spilled ring keeps two kinds
of short-lived planes on chip, as the TPU keeps a staging plane and a
read buffer per delta: its producer writes a staging plane, which the
stage's readers later in the same step read (delta equal to the
producer's lag) and one thread sends to the block's region of the spill
buffer with a bulk asynchronous store (``spill_write``); every plane
read at a larger delta was written at an earlier step and is fetched
once per step by a bulk asynchronous load into a buffer of its own,
completed on an ``mbarrier`` the readers wait on (``spill_prefetch`` and
``spill_read``'s cache), issued as many phases ahead of its first reader
as the layout leaves room for.  A spilled plan's device-memory traffic
per block and step is one plane written per spilled ring and one read
per earlier-step delta.  The tile of the rung is the one of least
modelled time (``spill_seconds``): the cells of every stage at the
per-SM cell rate of the streaming kernels, per wave of blocks (idle SMs
counted), plus the spill traffic at the share of the copy floor that
blocks streaming planes asynchronously reach at the plan's residency
(``config.H100_*``); a tile whose spill buffer exceeds
``SPILL_BYTES_CAP`` is refused.  ``spill="all"`` spills every ring read at an earlier step
whatever the budget (the CPU tests and the card tests use it on small
programs).  The plain version does not change (spilling moves storage,
not arithmetic).  Launches of a spill-rung plan count in
``launches_by["spill"]``.  Bound: the same bytes as the unspilled kernel; it
pays the halo recompute of small tiles and the spilled rings' traffic.

bf16 (the reference's opt-in modes, in every mode: whole-domain, chunk,
shard and segment plans): under
``ring_storage="bfloat16"`` every f32 ring of the reference's ring set
rounds to bf16 (to nearest, ties to even) where it is stored and is read
back as f32 (``StreamPlan.rounded``).  A stage's ring keeps bf16 slots
(``narrow_slots``: 2 bytes a cell, so ``ring_bytes``, ``plane_bytes``,
``pack_layout``, the spill choice and the spill buffer see half-size
rings, and a spilled ring's bulk copies move half the bytes), except a
band pass's source, whose slots stay f32 holding rounded values; a ring
input keeps f32 slots on chip, where ``cp.async`` lands its planes and
each thread rounds its own cells in place, and bf16 slots on the spill
rung, whose loads round.  Outputs are written unrounded, except by a
local plan with an i-halo (a shard of an i-sharded mesh), which emits
them through their rounded rings as the reference's kernel does there
(``rounds_out``).  Under
``mxu_precision="bf16"`` the pool's band matrices round to bf16
(``linear.finalize_pool``) and every band pass rounds its operand plane:
on CUDA cores one ``fmaf`` a tap of two bf16 values, exact products
summed in f32, and on tensor cores, from ``MMA_MIN_TAPS`` taps,
``sf_mma_band_bf16`` (mma.sync m16n8k16 bf16, one product a k-step of
16, priced at ``MMA_BF16_KSTEP_LANES``).  A two-sided transform runs its
j-pass first, into a scratch tile widened along k, and its k-pass reads
the rounded scratch, so the intermediate rounds where the JAX package's
``(L @ P) @ R`` rounds it; no pass is ``fused`` into its readers.
``stream_plain`` rounds at the same points and applies each band pass
as the kernel sums it (j-pass, then k-pass, taps in order), so the host
build equals it up to the order of the band groups' sums.  In shard mode
the rounded bands are each shard instance's slices of the origin-aware
stacked bands; correction planes and composed i-tables stay f32, as the
reference's ``finalize_pool`` keeps them.  Launches of these plans count
apart (``reduced``), under the ``launches_by`` keys "bf16", "spill_bf16"
on the spill rung, "local_bf16" for K4 on a chunk or a segment and
"shard_bf16" for K4 on a shard.

A compute type (``compile_chain_stream(compute_dtype=T)``, the
reference's ``compute_dtype``; T float32, bfloat16, float16, int32 or
bool, float64 and int64 as their 32-bit types): the wrapper casts the
array inputs to T before the kernel (scalars keep their own type) and
its outputs of T to their kernel types after it, as the reference's
``astype`` does, with XLA's conversions (``tile_eval.xla_convert``: float
to int32 truncated and saturated, NaN to 0; anything to bool ``!= 0``).
Every ring keeps slots of T (a band pass's source under a narrow T: f32
slots holding its values) and the plan sizes rings, staging planes,
spill slots and ``pack_layout`` at T's bytes (``StreamPlan.compute``,
``dtype``, ``itemsize``).  A per-cell stage types each site as jnp does
in the reference's 32-bit mode (``promotion.compute_join``: a float
constant is pinned to its kernel's type, an int32 scalar meeting bf16
gives bf16, bf16 meeting f16 float32, integer true division float32); a
narrow float site computes in f32 and rounds its result (``sf_bfr``,
``sf_hr``) after every operation, with no FMA contraction, which equals
jnp when XLA rounds each operation; an int32 site wraps, a bool ``+``
and ``*`` are or and and; the stage's result is converted to T at its
store.  Where jnp rejects a site (bool minus) the plan raises TypeError.
A banded stage reads its bf16 or f16 operands through the split route's
f32 band passes (a narrow operand's TF32 lo part is 0: the three
products are the reference's hi and lo band products to f32 rounding)
and rounds its result; under int32 and bool every stage stays per cell
(ROADMAP Queue 3).  ``ring_storage`` is dropped under a T narrower than
4 bytes; under float32 compute of a program typed otherwise its f32
rings round as on a float32 program, under int32 none does.  Launches
count under ``compute_key``: "compute_bf16", "compute_f16",
"compute_i32" and "compute_bool" on float32 programs, with "_typed"
(and "compute_f32_typed") on programs with an array or a stage of
another type, each with "spill_" before it on the spill rung (K3c).  On
the H100 bf16 compute is slower than f32 (every operation carries a
rounding, and bf16 inputs load synchronously, not by ``cp.async``):
PERF.md.

Programs typed bfloat16 or float16 run in every mode, K4's included:
2-byte arrays, rings and staging planes (``codegen.stype``), every op in
float rounded once to the narrow type, inputs loaded synchronously, the
launches counted under "narrow", "spill_narrow", "local_narrow" and
"shard_narrow"; narrow stages are never banded (``linear.banded_types``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import (H100_ASYNC_COPY_SHARE, H100_COPY_FLOOR,
                      H100_PANEL_CELL_RATE, H100_SM_COUNT,
                      H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM,
                      H100_STREAM_CELL_RATE)
from ..dtypes import BFLOAT16, FLOAT16, is_floating, to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from . import build, codegen
from .compose import ComposedPlan, compose_program, plan_composed
from .linear import (MatrixPool, band_diagonals, finalize_pool,
                     is_stacked_key, mxu_flops_per_cell, plan_all_stages,
                     stacked_axes)
from .panel import (AHEAD, PANEL_LANE_COST, PANEL_THREADS, ring_fields,
                    tile_candidates)
from .stacked_io import (SPILL_BYTES_CAP, THREADS, accesses_with_center,
                         bc_select, check_ring_storage, check_scope,
                         copy_group, launch_mode, or_mask, place_by_phase,
                         resolve_device, round_bf16, rounded_rings,
                         run_kernel, spanned_arrays)
from .promotion import compute_fill, static_input
from .tile_eval import (carrier, device_const, eval_kernel_statements,
                        from_compute, round_to, to_compute)

# kernel launches (CUDA tensors only) by mode (``_mode``,
# stacked_io.launch_mode): "exact" (the whole-domain stream kernel, K3),
# "local" (the local chunk kernel, K4), "spill" (either with spilled
# rings, K3c), "shard" (K4 on one shard of a mesh: any plan in shard
# mode); each with "_bf16" under a reduced precision (bf16 rings,
# single-pass bf16 passes: "bf16", "spill_bf16", "local_bf16",
# "shard_bf16"); "compute_" and the type's short name for every launch of
# a plan under a compute type (``compute_key``: "compute_bf16",
# "compute_f16", "compute_i32", "compute_bool", with "_typed" on a
# program of other types, "compute_f32_typed" too, and "spill_" before
# each on the spill rung: "spill_compute_bf16", ...); "narrow",
# "spill_narrow", "local_narrow" and "shard_narrow" for a program typed
# bfloat16 or float16
launches_by = collections.Counter()

# the JAX package's gate for banded stages (compile_chain_stream's
# mxu_min_footprint default)
MXU_MIN_FOOTPRINT = 12

# band passes under mxu_precision="split" run on tensor cores (mma.sync
# TF32, hi/lo split, three products) for bands of at least this many
# taps, on CUDA cores (one fmaf a tap) below it.  On an NVIDIA H100 80GB
# HBM3 (700 W; python -m stencilflow_tpu_torch.sweep box_fma box_mma
# cross_fma cross_mma) the 33-tap bands of box-r2 256^3 x 8 ran 0.819 ms
# on tensor cores against 0.863 on CUDA cores at each route's fastest
# tile, the 5-tap bands of cross-r2 256^3 x 8 9.408 against 3.784: widths
# between are not measured and stay on CUDA cores
MMA_MIN_TAPS = 33
# the on-chip tile rule's price of a band pass, in stage lanes (the
# panel kernel's ``H100_PANEL_CELL_RATE`` unit): a CUDA-core pass cell
# costs one lane per this many taps (at least one lane), a tensor-core
# 16 x 8 tile this many lanes per k-step of 8
FMA_TAPS_PER_LANE = 7
MMA_KSTEP_LANES = 48
# a single-pass bf16 16 x 8 tile per k-step of 16: the same operand reads
# as two split k-steps of 8 (96 lanes), a third of their conversions and
# one product where they issue six; a model, not a measurement
MMA_BF16_KSTEP_LANES = 32
# a stage cell costs one lane per this many shared-memory reads (at least
# one lane: the 7-point jacobi stage the lane rate was measured on)
STAGE_READS_PER_LANE = 7
# the on-chip rule's cost of a lane at (resident blocks per SM, threads):
# the panel kernel's, with one resident block refitted to the same sweep
# (box, cross and K4's chunk): a step's phases each end in a barrier, so
# a lone block's warps wait longer than K1's (1.4 and 1.15 there)
STREAM_LANE_COST = {**PANEL_LANE_COST, (1, 256): 1.75, (1, 512): 1.6}

TKey = Tuple[str, Optional[str], Optional[str]]


@dataclasses.dataclass(frozen=True)
class BandInfo:
    """A pooled band as the on-chip passes apply it: ``offsets`` d0..d1,
    the Toeplitz weights ``w`` of its interior columns (``w[d - d0]``),
    and the global columns [lo, hi) whose coefficients are ``w`` wherever
    ``p + d`` lies inside [0, n) (outside, the source planes hold 0, so
    the literal weights give the truncated band exactly).  Columns outside
    [lo, hi) read the coefficient table."""
    offsets: Tuple[int, ...]
    w: Tuple[float, ...]
    lo: int
    hi: int
    n: int

    @property
    def taps(self) -> int:
        return len(self.offsets)

    @property
    def toeplitz(self) -> bool:
        return self.lo == 0 and self.hi == self.n


def band_info(offsets, coef: np.ndarray) -> BandInfo:
    """``BandInfo`` of a ``band_diagonals`` table."""
    n = coef.shape[1]
    d = np.asarray(offsets)[:, None]
    p = np.arange(n)[None, :]
    inside = (p + d >= 0) & (p + d < n)
    w = coef[:, n // 2]
    ok = np.all(~inside | (coef == w[:, None]), axis=0)
    lo = n // 2
    while lo > 0 and ok[lo - 1]:
        lo -= 1
    hi = n // 2
    while hi < n and ok[hi]:
        hi += 1
    return BandInfo(tuple(offsets), tuple(float(x) for x in w), lo, hi, n)


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
    # the spill rung's layout (shared memory packed by liveness, spilled
    # rings staged and prefetched): set for every plan of the rung
    packed: bool = False
    layouts: Dict[tuple, "SpillLayout"] = dataclasses.field(
        default_factory=dict, repr=False)   # spill_layout's cache
    # kernel_pool() arrays (then the spill buffer) on each device the
    # kernel ran on
    device_pool: Dict[object, List[torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    # band(): key -> (offsets, coef); band_info(): (key, side) -> BandInfo
    bands: Dict[object, object] = dataclasses.field(default_factory=dict,
                                                    repr=False)
    # the on-chip body (K3a/K3b/K4): threads of a block; transforms
    # computed at their reader's step (every read one plane delta back:
    # transform key -> that delta); the band passes' precision and
    # route ("auto": tensor cores from MMA_MIN_TAPS taps under "split")
    threads: int = THREADS
    instep: Dict[TKey, int] = dataclasses.field(default_factory=dict)
    mxu_precision: str = "split"
    passes: str = "auto"
    # shard mode (K4 on one shard of a mesh): the shard's core (Bj, Bk)
    # and the exchanged (j, k) halo its inputs arrive widened by; (0, 0):
    # the whole (J, K) plane.  ``contexts``: the global coordinate of
    # the widened plane's row 0 of every j instance and col 0 of every k
    # instance the pool was built for (stacked keys hold one slice per
    # instance, corrections j-major over both)
    shard: Tuple[int, int] = (0, 0)
    xhalo: Tuple[int, int] = (0, 0)
    contexts: Optional[Tuple[List[int], List[int]]] = None
    # ring_storage="bfloat16": the f32 fields of the reference's ring set
    # round to bf16 at their store (``rounded``); a stage ring keeps bf16
    # slots (and bf16 planes in the spill buffer), except a band pass's
    # source, whose passes read f32 slots that hold the rounded values; a
    # ring input keeps f32 slots rounded in place once cp.async lands them
    # on chip, and bf16 slots on the spill rung, which loads it itself
    ring_storage: str = "off"
    # compute_dtype: the reference's compute type, by its canonical name
    # ("float32" where none was given); ``compute``: the numpy type every
    # stage computes in where that is not the program's own
    # (``promotion.check_compute_program``; None otherwise).  Under it
    # inputs arrive cast to it, every ring and staging plane holds it (a
    # band pass's source: f32 slots holding its values), a float stage
    # rounds after every operation (a banded one its result), and
    # outputs leave in it, for the wrapper to cast to their kernel types
    compute_dtype: str = "float32"
    compute: Optional[np.dtype] = None
    # the on-chip body's ring inputs of 2-byte cells loaded by cp.async:
    # cells a copy (8 or 2, ``stacked_io.copy_group``; their k-halo
    # widened to a multiple of it); the others load a cell a copy
    copy_groups: Dict[str, int] = dataclasses.field(default_factory=dict)

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
    def core(self) -> Tuple[int, int]:
        """The (j, k) extents the kernel writes: a shard's core, else the
        whole plane."""
        return self.shard if self.shard[0] else tuple(
            self.program.dimensions[1:])

    def plane(self) -> Tuple[int, int]:
        """The (j, k) extents of the input arrays and the pool's planes: a
        shard's core widened by the exchanged halo, else the whole
        plane."""
        (bj, bk), (xj, xk) = self.core(), self.xhalo
        return bj + 2 * xj, bk + 2 * xk

    def instances(self) -> Tuple[int, int]:
        """(j, k) shard instances the pool holds slices for."""
        if self.contexts is None:
            return 1, 1
        return len(self.contexts[0]), len(self.contexts[1])

    def matrix(self, key: str, inst: Tuple[int, int] = (0, 0)) -> np.ndarray:
        """Pool entry ``key`` as shard instance ``inst`` = (j, k) reads it:
        its slice of a stacked key (``linear.stacked_axes``)."""
        a = self.pool[key]
        axes = stacked_axes(key)
        if not axes:
            return a
        n = self.instances()
        idx = 0
        for ax in axes:
            idx = idx * n[ax] + inst[ax]
        return a[idx]

    def band(self, key: str, side: str, inst: Tuple[int, int] = (0, 0)):
        """(offsets, coef) of pool matrix ``key`` (linear.band_diagonals)
        as shard instance ``inst`` reads it; a stacked key's tables of
        every instance span the offsets of all of them."""
        if (key, inst) not in self.bands:
            span = None
            if is_stacked_key(key):
                offs = {d for m in self.pool[key]
                        for d in band_diagonals(m, side)[0]}
                span = (min(offs), max(offs))
            self.bands[key, inst] = band_diagonals(self.matrix(key, inst),
                                                   side, span)
        return self.bands[key, inst]

    def reach(self, key: Optional[str], side: str) -> int:
        if key is None:
            return 0
        offs = self.band(key, side)[0]
        return max(abs(offs[0]), abs(offs[-1]))

    def region(self, f) -> Tuple[int, int]:
        hj, hk = self.thalo[f] if isinstance(f, tuple) else self.halo[f]
        return self.tile[0] + 2 * hj, self.tile[1] + 2 * hk

    def pass_order(self, tkey: TKey) -> Tuple[str, ...]:
        """The sides of ``tkey``'s passes in the order they run: the
        k-pass ("R") into the scratch of a two-sided transform, then the
        j-pass ("L"); single-pass bf16 passes the other way round, as the
        JAX package's ``(L @ P) @ R`` rounds its intermediate."""
        sides = ("L", "R") if self.mxu_precision == "bf16" else ("R", "L")
        return tuple(x for x in sides
                     if tkey[1 if x == "L" else 2] is not None)

    def scratch_shape(self, tkey: TKey) -> Tuple[int, int]:
        """(rows, cols) of the first pass's scratch of a two-sided
        transform: widened along the second pass's axis by its reach."""
        TJ, TK = self.region(tkey)
        if self.pass_order(tkey)[0] == "L":
            return TJ, TK + 2 * self.reach(tkey[2], "R")
        return TJ + 2 * self.reach(tkey[1], "L"), TK

    def slots(self, f: str) -> int:
        """Planes of raw ring ``f`` in shared memory: its depth, and (on
        chip) AHEAD more for a ring input, the planes in flight."""
        ahead = AHEAD if not self.packed and f in self.program.inputs else 0
        return self.raw_ring[f] + ahead

    @property
    def compute_narrow(self):
        """The narrow type every stage computes in (``compute`` bfloat16
        or float16), or None."""
        cd = self.compute
        return cd if cd is not None and cd in (BFLOAT16, FLOAT16) else None

    def dtype(self, f: str) -> np.dtype:
        """The type of field ``f``'s planes in the kernel: the compute type
        for an array or a stage under one, else the field's own."""
        spec = self.program.inputs.get(f)
        if self.compute is not None and (spec is None or not spec.is_scalar):
            return self.compute
        return np.dtype(self.program.field_dtype(f))

    @property
    def slot_dtype(self):
        """The type of the 2-byte slots and of the rounding of rounded
        rings: the compute type under a narrow compute, else bfloat16
        (``ring_storage``)."""
        cd = self.compute_narrow
        return BFLOAT16 if cd is None else cd

    @functools.cached_property
    def rounds(self) -> frozenset:
        if self.compute_narrow is not None:   # every ring, inputs too
            return frozenset(self.raw_ring)
        if self.compute is not None:   # the rings whose planes are f32
            return frozenset(f for f in self.raw_ring if f in self.ring
                             and self.ring_storage != "off"
                             and self.dtype(f) == np.float32)
        return rounded_rings(self.program, [f for f in self.raw_ring
                                            if f in self.ring],
                             self.ring_storage)

    def rounded(self, f: str) -> bool:
        """Does ring ``f`` round to bf16 at its store?"""
        return f in self.rounds

    @property
    def bf16_passes(self) -> bool:
        """Does the plan apply band matrices as single-pass bf16 passes
        (``mxu_precision="bf16"`` and a band in its pool)?"""
        return self.mxu_precision == "bf16" and any(
            k.startswith(("L", "R")) for k in self.pool)

    @functools.cached_property
    def rounds_out(self) -> frozenset:
        """The outputs written rounded to bf16: under ring storage a local
        plan with an i-halo emits every output through its (rounded)
        ring, as the JAX package's ``compile_local_stream`` does once
        ``halo_i`` > 0 (no direct emit there); other plans write outputs
        unrounded.  Under a narrow compute every output leaves in it."""
        if self.compute_narrow is not None:
            return frozenset(self.program.outputs)
        if not self.halo_i or self.compute is not None:
            return frozenset()
        return rounded_rings(self.program, self.program.outputs,
                             self.ring_storage)

    def narrow_slots(self, f: str) -> bool:
        """Does ring ``f`` keep 2-byte slots of ``slot_dtype``?"""
        return (f in self.rounds
                and (self.packed or self.compute_narrow is not None
                     or f not in self.program.inputs)
                and all(t[0] != f for t in self.tkeys))

    def ring_dtype(self, f: str) -> np.dtype:
        """The type ring ``f``'s slots hold: ``slot_dtype`` where it keeps
        2-byte slots, float32 for the other rings under a narrow compute
        (a band pass's source, holding its values), else its planes'
        type (``dtype``)."""
        if self.narrow_slots(f):
            return self.slot_dtype
        if self.compute_narrow is not None:
            return np.dtype(np.float32)
        return self.dtype(f)

    def itemsize(self, f: str) -> int:
        """Bytes of a cell of ring ``f``'s slots (``ring_dtype``)."""
        return self.ring_dtype(f).itemsize

    def io_itemsize(self, f: str) -> int:
        """Bytes of a cell of input or output ``f`` in device memory (the
        compute type's under a compute type)."""
        return self.dtype(f).itemsize

    def ring_bytes(self, f: str) -> int:
        """Bytes of field ``f``'s raw ring, rounded up to 16."""
        tj, tk = self.region(f)
        size = self.slots(f) * tj * tk * self.itemsize(f)
        return -(-size // 16) * 16

    def smem_bytes(self) -> int:
        """Shared memory of a block: ``spill_layout``'s (the spill rung's
        packing, or the on-chip body's with nothing spilled)."""
        return self.spill_layout(ahead=False).end

    def unpacked_bytes(self) -> int:
        """Shared memory of an on-chip plan with every ring, transform
        plane and scratch in a region of its own."""
        return (sum(_align(self.ring_bytes(f), 128) for f in self.raw_ring)
                + sum(_align(n, 128) for _k, n in self.onchip_regions())
                + sum(_align(it[2], 128) for it in self.onchip_items()))

    # -- the on-chip body: band passes and the step's phases -----------------
    def band_info(self, key: str, side: str) -> BandInfo:
        if (key, side) not in self.bands:
            self.bands[key, side] = band_info(*self.band(key, side)) \
                if self.contexts is None else self._shard_band_info(key, side)
        return self.bands[key, side]

    def _shard_band_info(self, key: str, side: str) -> BandInfo:
        """``BandInfo`` of a band over shard planes, in global columns: the
        weights of the interior column nearest the domain's middle, and
        the global range [lo, hi) around it in which every instance's
        slice applies those weights wherever the source lies inside its
        window and the domain (beyond the domain the source planes hold
        0, so literal weights are exact there too)."""
        d = 0 if side == "L" else 1
        N = self.program.dimensions[1 + d]
        per = []
        for i, g0 in enumerate(self.contexts[d]):
            offsets, coef = self.band(key, side, (i, 0) if d == 0 else (0, i))
            dd = np.asarray(offsets)[:, None]
            p = np.arange(coef.shape[1])[None, :]
            g = g0 + np.arange(coef.shape[1])
            window = (p + dd >= 0) & (p + dd < coef.shape[1])
            inside = window & (g0 + p + dd >= 0) & (g0 + p + dd < N)
            per.append((coef, g, inside, np.all(window, axis=0)
                        & (g >= 0) & (g < N)))
        w = min(((abs(int(g[c]) - N // 2), i, c)
                 for i, (_coef, g, _in, full) in enumerate(per)
                 for c in np.nonzero(full)[0]))
        w = per[w[1]][0][:, w[2]]
        odd = set()
        for coef, g, inside, _full in per:
            bad = ~np.all(~inside | (coef == w[:, None]), axis=0)
            odd.update(int(x) for x in g[bad & (g >= 0) & (g < N)])
        lo = max([x + 1 for x in odd if x < N // 2], default=0)
        hi = min([x for x in odd if x >= N // 2], default=N)
        return BandInfo(tuple(self.band(key, side)[0]),
                        tuple(float(x) for x in w), lo, hi, N)

    def route(self, key: str, side: str) -> str:
        """"mma" (tensor cores) or "fma" (CUDA cores) for the pass that
        applies band ``key``."""
        if self.passes != "auto":
            return self.passes
        return "mma" if (self.mxu_precision in ("split", "bf16")
                         and self.band_info(key, side).taps
                         >= MMA_MIN_TAPS) else "fma"

    def pass_shape(self, tkey: TKey, side: str):
        """(rows, cols, source field's region) of ``tkey``'s pass along
        ``side``'s axis: the first pass of a two-sided transform covers
        its scratch, widened for the second."""
        order = self.pass_order(tkey)
        if len(order) == 2 and side == order[0]:
            return self.scratch_shape(tkey)
        return self.region(tkey)

    def fused(self, tkey: TKey) -> bool:
        """Is ``tkey`` a two-sided transform of ``instep`` whose j-pass
        runs inside its readers' stage (CUDA-core passes, Toeplitz
        bands): its k-pass fills a scratch tile, and each reader sums the
        j-band's taps of it at its own cell, with no transformed plane?
        Never under single-pass bf16 passes, whose j-pass runs first."""
        f, lkey, rkey = tkey
        return (tkey in self.instep and lkey is not None
                and self.mxu_precision != "bf16"
                and rkey is not None
                and self.route(lkey, "L") == self.route(rkey, "R") == "fma"
                and self.band_info(lkey, "L").toeplitz
                and self.band_info(rkey, "R").toeplitz)

    def mirrored(self, tkey: TKey) -> bool:
        """Does ``tkey``'s transform ring (S planes) keep its first S - 1
        slots twice, slot s also at s + S?  A composed stage reads its S
        consecutive planes from one base then, at constant offsets: its
        readers' planes sit in slots s0 .. s0 + S - 1 of the 2S - 1."""
        return tkey in self.tring and any(
            isinstance(self.mxu_plans[c], ComposedPlan)
            for c in self.readers(tkey))

    @functools.cached_property
    def schedule(self) -> List[tuple]:
        """The phases of one plane step of the on-chip body, each closed
        by a barrier: ("ingest",) the ring inputs, ("stage", s), ("pass",
        tkey, side) a transform pass — the first of a two-sided transform
        into its scratch, then the second into the transformed plane, in
        ``pass_order`` — ("fused", tkeys) the k-passes of ``fused``
        transforms of one source plane and shape, one loop over their
        shared source reads, and ("mirror", tkey) the copy of a
        ``mirrored`` ring's new plane that a tensor-core pass wrote (a
        CUDA-core pass writes both copies itself).  A transform of ``instep`` runs right before
        its first reader's stage; a transform ring is filled right after
        its field's producer (the ingest for a ring input)."""
        def passes(t):
            order = self.pass_order(t)
            out = [("pass", t, side) for side in order]
            last = order[-1]
            if self.mirrored(t) and self.route(
                    t[1 if last == "L" else 2], last) == "mma":
                out.append(("mirror", t))
            return out
        first = {t: next(c for c in self.analysis.graph.kernel_order
                         if c in self.readers(t)) for t in self.instep}
        out = [("ingest",)]
        for f in self.raw_ring:
            if f in self.program.inputs:
                out += [x for t in self.tring if t[0] == f
                        for x in passes(t)]
        for s in self.analysis.graph.kernel_order:
            mine = [t for t in self.instep if first[t] == s]
            groups: Dict[tuple, List[TKey]] = {}
            for t in mine:
                if self.fused(t):
                    groups.setdefault((t[0], self.instep[t], self.thalo[t],
                                       self.scratch_shape(t)), []).append(t)
            out += [("fused", tuple(g)) for g in groups.values()]
            out += [x for t in mine if not self.fused(t)
                    for x in passes(t)]
            out.append(("stage", s))
            out += [x for t in self.tring if t[0] == s for x in passes(t)]
        return out

    def readers(self, tkey: TKey) -> List[str]:
        """The banded stages that read transform ``tkey``."""
        out = []
        for c, mp in self.mxu_plans.items():
            if isinstance(mp, ComposedPlan):
                keys = [(mp.field, mp.lkey, mp.rkey)]
            else:
                keys = [(g.field, t.left_key, t.right_key)
                        for g in mp.groups for t in g.terms]
            if tkey in keys:
                out.append(c)
        return out

    @functools.cached_property
    def _stage_phase(self) -> Dict[str, int]:
        return {e[1]: n for n, e in enumerate(self.schedule)
                if e[0] == "stage"}

    def phase(self, f: str) -> int:
        """The phase of a plane step that writes field ``f``: 0 for a ring
        input (ingested at the top of the step), the stage's own for a
        kernel (1 + n for the n-th stage in chain order in a plan without
        transforms)."""
        return self._stage_phase.get(f, 0)

    def phases(self) -> int:
        return len(self.schedule)

    def pass_phase(self, tkey: TKey, side: str) -> int:
        """The phase of ``tkey``'s pass along ``side`` (a fused k-pass:
        its group's)."""
        if side == "R" and self.fused(tkey):
            return next(n for n, e in enumerate(self.schedule)
                        if e[0] == "fused" and tkey in e[1])
        return self.schedule.index(("pass", tkey, side))

    def stage_reads(self, s: str) -> int:
        """Shared-memory reads of one cell of stage ``s``: its accesses
        per cell; a banded stage's transformed planes (the j-band's taps
        of a ``fused`` transform's scratch), raw terms and correction
        planes; a composed stage's i-offsets."""
        mp = self.mxu_plans.get(s)
        if mp is None:
            return sum(len(v) for v in accesses_with_center(
                self.program.kernels[s]).values())
        if isinstance(mp, ComposedPlan):
            return len(mp.offsets)
        n = 0
        for g in mp.groups:
            n += bool(g.correction_key)
            for t in g.terms:
                tkey = (g.field, t.left_key, t.right_key)
                n += self.band_info(t.left_key, "L").taps \
                    if self.fused(tkey) else 1
        return n

    def band_floats(self, tkey: TKey, side: str) -> Tuple[int, int]:
        """Floats of the block's shared-memory copies of the band that
        ``tkey``'s ``side`` pass applies: (weight vector, table window).
        A tensor-core pass reads its Toeplitz weights from the band's
        vector (one per band, shared by its passes); a band with columns
        outside its Toeplitz range keeps a window of its coefficient table
        over the pass's columns (rows for "L")."""
        key = tkey[2] if side == "R" else tkey[1]
        info = self.band_info(key, side)
        width = self.region(tkey)[1 if side == "R" else 0]
        vec = info.taps if self.route(key, side) == "mma" else 0
        return vec, 0 if info.toeplitz else info.taps * width

    def onchip_regions(self) -> List[Tuple[object, int]]:
        """(key, bytes) of the on-chip body's regions beside the rings:
        every transform ring, every band's weight vector ("bvec") and
        every pass's table window ("btab")."""
        if self.packed:
            return []
        out = []
        for t, depth in self.tring.items():
            TJ, TK = self.region(t)
            depth = 2 * depth - 1 if self.mirrored(t) else depth
            out.append((("tring", t), depth * TJ * TK * 4))
        for e in self.schedule:
            if e[0] == "pass":
                t, side = e[1], e[2]
                key = t[2] if side == "R" else t[1]
                vec, tab = self.band_floats(t, side)
                if vec and ("bvec", key, side) not in dict(out):
                    out.append((("bvec", key, side), 4 * vec))
                if tab:
                    out.append((("btab", t, side), 4 * tab))
        return out

    def onchip_items(self) -> List[tuple]:
        """The on-chip body's short-lived items (``place_by_phase``'s
        form, masks over the step's phases): the scratch of every
        two-sided transform (its two passes) and the plane of every
        transform of ``instep`` (its last pass to its last reader)."""
        if self.packed:
            return []
        n = self.phases()
        out = []
        for t in self.tkeys:
            if self.fused(t):
                a = self.pass_phase(t, "R")
                b = max(self.phase(c) for c in self.readers(t))
                m = sum(1 << (x % n) for x in range(a, b + 1))
                out.append((a, ("scratch", t),
                            4 * math.prod(self.scratch_shape(t)), m, m))
                continue
            order = self.pass_order(t)
            if len(order) == 2:
                a, b = (self.pass_phase(t, x) for x in order)
                m = sum(1 << x for x in range(a, b + 1))
                out.append((a, ("scratch", t),
                            4 * math.prod(self.scratch_shape(t)), m, m))
            if t in self.instep:
                a = self.pass_phase(t, order[-1])
                b = max(self.phase(c) for c in self.readers(t))
                m = sum(1 << (x % n) for x in range(a, b + 1))
                out.append((a, ("tplane", t),
                            4 * math.prod(self.region(t)), m, m))
        return out

    def min_blocks(self) -> int:
        """Blocks per SM an on-chip plan's shared memory leaves room for
        (at most 4): ``__launch_bounds__`` asks nvcc for them."""
        return max(1, min(4, 2048 // self.threads, H100_SMEM_PER_SM
                          // (self.smem_bytes() + 1024)))

    def lanes(self) -> float:
        """Stage lanes one block issues per plane step: every stage's
        region in passes of ``threads`` cells (idle lanes of a last pass
        included), and every band pass at its route's price."""
        nt = self.threads

        def fill(cells):
            return -(-cells // nt) * nt
        total = float(sum(fill(math.prod(self.region(s))) * max(
            1.0, self.stage_reads(s) / STAGE_READS_PER_LANE)
            for s in self.program.kernels))
        for e in self.schedule:
            if e[0] == "fused":
                taps = sum(self.band_info(t[2], "R").taps for t in e[1])
                total += fill(math.prod(self.scratch_shape(e[1][0]))) * max(
                    1.0, taps / FMA_TAPS_PER_LANE)
            if e[0] != "pass":
                continue
            t, side = e[1], e[2]
            key = t[2] if side == "R" else t[1]
            info = self.band_info(key, side)
            rows, cols = self.pass_shape(t, side)
            if self.route(key, side) == "fma":
                total += fill(rows * cols) * max(1.0, info.taps
                                                 / FMA_TAPS_PER_LANE)
                continue
            # the j-pass runs transposed: 16 columns by 8 rows a tile
            m, n = (rows, cols) if side == "R" else (cols, rows)
            tiles = -(-m // 16) * -(-n // 8)
            warps = nt // 32
            bf = self.mxu_precision == "bf16"
            total += (-(-tiles // warps) * warps * mma_ksteps(info.taps, bf)
                      * (MMA_BF16_KSTEP_LANES if bf else MMA_KSTEP_LANES))
        return total

    def seconds(self) -> float:
        """The on-chip tile rule, a model in seconds (as the panel
        kernel's ``PanelPlan.seconds``): per wave of resident blocks,
        every SM issues its blocks' ``lanes`` of every plane step at
        ``H100_PANEL_CELL_RATE``, scaled by ``STREAM_LANE_COST`` at the
        plan's residency and threads; the ring inputs' planes (halo
        included) and the outputs move at the share of the copy floor
        that the residency reaches, overlapped: the larger term counts."""
        ntj, ntk = self.grid()
        per_sm = self.residency()
        waves = math.ceil(ntj * ntk / (H100_SM_COUNT * per_sm))
        latency = STREAM_LANE_COST[min(per_sm, 4 if self.threads == 256
                                       else 2), self.threads]
        compute = self.steps() * waves * per_sm * self.lanes() * latency \
            / H100_PANEL_CELL_RATE
        J, K = self.core()
        moved = ntj * ntk * self.extent() * sum(
            math.prod(self.region(f)) * self.io_itemsize(f)
            for f in self.raw_ring if f in self.program.inputs)
        moved += sum(self.extent() * J * K * self.io_itemsize(o)
                     for o in self.program.outputs)
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return max(compute, moved / (H100_COPY_FLOOR * share))

    def inner_reach(self) -> Tuple[int, int]:
        """(Hj, Hk): how far beyond the core tile any region, stage read
        or transform reaches; a block whose core widened by it lies
        inside the (j, k) domain runs mask-free bodies."""
        from .panel import reach
        Hj, Hk = reach(self.program, self)
        return (max([Hj] + [self.halo[f][0] for f in self.raw_ring]),
                max([Hk] + [self.halo[f][1] for f in self.raw_ring]))

    def inner_blocks(self) -> int:
        """Blocks that take the mask-free bodies (on steps whose planes
        lie away from the i ends)."""
        (Hj, Hk), (tj, tk) = self.inner_reach(), self.tile
        _, J, K = self.program.dimensions
        ntj, ntk = self.grid()
        return sum(1 for b in range(ntj)
                   if b * tj >= Hj and b * tj + tj + Hj <= J) * sum(
            1 for b in range(ntk) if b * tk >= Hk and b * tk + tk + Hk <= K)

    def kpass_cells(self) -> int:
        """Cells of a step's k-passes: the tile rule's tie-break.  Tiles
        of one area can price alike on tensor cores, whose passes round to
        whole 16 x 8 tiles; on box-r2 256^3 x 8 (32, 8) ran 0.819 ms and
        (16, 16), with 1.5x the k-pass cells, 0.912 (``sweep``, NVIDIA
        H100 80GB HBM3, 700 W)."""
        return sum(math.prod(self.pass_shape(e[1][0] if e[0] == "fused"
                                             else e[1], "R"))
                   * (len(e[1]) if e[0] == "fused" else 1)
                   for e in self.schedule
                   if e[0] == "fused" or e[0] == "pass" and e[2] == "R")

    def evaluations(self) -> float:
        """Stage evaluations per output cell of a block: every stage's
        region over the core tile (1.0 per stage without halo recompute)."""
        return sum(math.prod(self.region(s)) for s in self.program.kernels) \
            / math.prod(self.tile)

    # -- the spill rung ------------------------------------------------------

    def plane_bytes(self, f: str) -> int:
        """Bytes of one plane of ``f``'s region, rounded up to 16 (the
        stride of its slots in the spill buffer and of its on-chip
        copies; bulk copies move multiples of 16 bytes)."""
        tj, tk = self.region(f)
        size = tj * tk * self.itemsize(f)
        return -(-size // 16) * 16

    def read_phases(self) -> Dict[str, Dict[int, List[int]]]:
        """Per raw ring, per read delta (``spill_deltas``'s), the phases of
        the stages that read it at that delta."""
        return self._read_phases

    @functools.cached_property
    def _read_phases(self) -> Dict[str, Dict[int, List[int]]]:
        out: Dict[str, Dict[int, List[int]]] = {f: {} for f in self.raw_ring}
        for c in self.analysis.graph.kernel_order:
            for f, accs in accesses_with_center(
                    self.program.kernels[c]).items():
                if f in out:
                    for a in accs:
                        ph = out[f].setdefault(self.lag[c] - (a[0] or 0), [])
                        if self.phase(c) not in ph:
                            ph.append(self.phase(c))
        return out

    def in_step(self, f: str) -> bool:
        """Is every read of ring ``f`` in the step that writes it?"""
        return all(d == self.lag[f] for d in self.read_phases()[f])

    def spill_layout(self, ahead: bool = True) -> "SpillLayout":
        """The spill rung's shared-memory layout at the plan's tile and
        spilled rings (``pack_layout``, cached; ``ahead=False`` leaves
        every load at its first reader's phase, the same bytes)."""
        key = (self.tile, tuple(self.spilled), ahead, self.packed)
        if key not in self.layouts:
            self.layouts[key] = pack_layout(self, ahead)
        return self.layouts[key]

    def spill_offsets(self) -> Dict[str, int]:
        """Byte offset of every spilled ring in one block's region of the
        spill buffer, each at a multiple of 128 with its planes
        ``plane_bytes`` apart; "end" = the region's size (a multiple of
        128)."""
        off, out = 0, {}
        for f in self.raw_ring:
            if f in self.spilled:
                out[f] = off
                off += -(-self.raw_ring[f] * self.plane_bytes(f) // 128) * 128
        out["end"] = off
        return out

    def spill_bytes(self) -> int:
        """Bytes of the spill buffer: every block's region."""
        ntj, ntk = self.grid()
        return ntj * ntk * self.spill_offsets()["end"]

    def spill_traffic(self) -> int:
        """Device-memory bytes one block moves per plane step for its
        spilled rings: each writes one plane and loads one per delta
        beyond its producer's lag (planes of an earlier step)."""
        return sum(self.plane_bytes(f) * (1 + sum(d > self.lag[f]
                                                  for d in dl))
                   for f, dl in self.spilled.items())

    def residency(self) -> int:
        """Blocks of the plan resident per SM: the threads', the shared
        memory's and the grid's limit."""
        ntj, ntk = self.grid()
        return max(1, min(2048 // self.threads,
                          H100_SMEM_PER_SM // (self.smem_bytes() + 1024),
                          -(-ntj * ntk // H100_SM_COUNT)))

    def spill_seconds(self) -> float:
        """The spill rung's tile rule, a model in seconds: per wave of
        resident blocks, every SM evaluates its blocks' cells of every
        plane step at ``H100_STREAM_CELL_RATE`` (a wave of fewer blocks
        than SMs takes as long as a full one: its idle SMs count); then
        the grid's spill traffic moves at ``H100_ASYNC_COPY_SHARE`` (at
        the plan's residency) of the copy floor.  On an NVIDIA H100 80GB
        HBM3 (700 W), ``python -m stencilflow_tpu_torch.sweep`` over every
        tile of jacobi3d 512^3 x 32, hdiff3d 256^3 x 16 and hotspot3d
        256^3 x 32 ran this rule's pick fastest on each; pricing the
        traffic per SM instead (idle SMs moving none) picked hotspot's
        (16, 32), 8.7 % slower than its (32, 32) of 64 blocks."""
        ntj, ntk = self.grid()
        per_sm = self.residency()
        waves = math.ceil(ntj * ntk / (H100_SM_COUNT * per_sm))
        share = H100_ASYNC_COPY_SHARE[min(per_sm, 3) - 1]
        return self.steps() * (
            waves * per_sm * self.cells() / H100_STREAM_CELL_RATE
            + ntj * ntk * self.spill_traffic() / (H100_COPY_FLOOR * share))

    def grid(self) -> Tuple[int, int]:
        bj, bk = self.core()
        return -(-bj // self.tile[0]), -(-bk // self.tile[1])

    def cells(self) -> int:
        """Cells one block evaluates per plane step: every stage's region
        and every ring input's."""
        program = self.program
        return (sum(math.prod(self.region(f)) for f in program.kernels)
                + sum(math.prod(self.region(f)) for f in self.raw_ring
                      if f in program.inputs))

    def kernel_pool(self, inst: Tuple[int, int] = (0, 0)
                    ) -> List[Tuple[str, np.ndarray]]:
        """The device arrays the kernel reads, in argument order: the
        diagonal table of every band it applies, correction planes and
        composed i-tables; of shard instance ``inst`` (its slices of the
        stacked keys) in shard mode."""
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
            arr = (self.band(k, keys[k], inst)[1] if keys[k] else
                   np.ascontiguousarray(self.matrix(k, inst), np.float32))
            out.append((k, arr))
        return out

    def flops_per_cell(self) -> float:
        """Executed f32 flops per cell of the plan's transforms."""
        return mxu_flops_per_cell({k: self.matrix(k) for k in self.pool},
                                  self.tkeys)

    def last_config(self) -> dict:
        """The JAX package's ``compile_chain_stream.last_config`` keys."""
        return {"mxu_stages": sorted(self.mxu_plans),
                "composed": {k: list(v) for k, v in self.composed.items()},
                "jtiles": 1, "spilled": sorted(self.spilled),
                "tile": self.tile, "packed": self.packed,
                "compute_dtype": self.compute_dtype}


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def mma_ksteps(taps: int, bf16: bool = False) -> int:
    """k-steps of a tensor-core band pass, 8 deep (16 for the single-pass
    bf16 pass): 8 outputs along the band's axis read 8 + taps - 1 source
    values."""
    return -(-(7 + taps) // (16 if bf16 else 8))


@dataclasses.dataclass
class SpillLayout:
    """The spill rung's shared memory for one tile and set of spilled
    rings.  One ``mbarrier`` per load comes first (8 bytes each), then the
    rings read across steps that stay on chip, each in its own region,
    then the arena of the short-lived items, placed first-fit by the
    phases they are live in: rings read only in the step that writes them
    (``("ring", f)``), the staging plane of every spilled ring
    (``("stage", f)``: live from its producer to its last reader in the
    step, and at least the phase after its producer, while its bulk store
    reads it) and the buffer of every load (``("read", f, d)``: the plane
    of spilled ring ``f`` its readers take at delta ``d`` beyond the
    producer's lag, written at an earlier step and loaded once a step;
    live from the phase at whose start the load is issued to its last
    reader).  Every region starts at a multiple of 128 bytes."""
    loads: List[Tuple[str, int]]        # (field, delta): barrier order
    issue: Dict[Tuple[str, int], int]   # phase the load is issued in
    readers: Dict[Tuple[str, int], List[int]]   # its readers' phases
    offset: Dict[object, int]           # ring name or arena item -> bytes
    live: Dict[object, int]             # arena item -> mask of its phases
    end: int


def pack_layout(plan: StreamPlan, ahead: bool = True) -> SpillLayout:
    """Place ``plan``'s shared memory for the spill rung (``SpillLayout``):
    the short-lived items first-fit in order of their first phase, every
    load issued at the start of its first reader's phase.  With
    ``ahead``, loads then run ahead of their readers where the layout
    has room, in the same bytes: placed again, each load is issued a
    phase before its first reader where that still ends below the first
    placement's end; then each moves earlier, one phase at a time, while
    its buffer is free there and the phase is in its step."""
    n = plan.phases()
    rp = plan.read_phases()

    def span(a: int, b: int) -> int:
        """Phases a..b of a step; b = n is phase 0 of the next."""
        return sum(1 << (x % n) for x in range(a, b + 1))

    ring_order = list(plan.raw_ring)
    loads = sorted((min(ph), ring_order.index(f), f, d)
                   for f in plan.spilled for d, ph in rp[f].items()
                   if d > plan.lag[f])
    offset: Dict[object, int] = {}
    off = _align(8 * len(loads), 128)
    # on chip, a ring input has a plane in flight: a region of its own
    inflight = set() if plan.packed else set(plan.program.inputs)
    for f in plan.raw_ring:
        if f not in plan.spilled and (not plan.in_step(f) or f in inflight):
            offset[f] = off
            off += _align(plan.ring_bytes(f), 128)
    for key, nbytes in plan.onchip_regions():
        offset[key] = off
        off += _align(nbytes, 128)
    base = off
    items = []   # (first phase, key, bytes, mask)
    for f in plan.raw_ring:
        p = plan.phase(f)
        if f in plan.spilled:
            last = max([p + 1] + rp[f].get(plan.lag[f], []))
            items.append((p, ("stage", f), _align(plan.plane_bytes(f), 128),
                          span(p, last)))
        elif plan.in_step(f) and f not in inflight:
            items.append((p, ("ring", f), _align(plan.ring_bytes(f), 128),
                          span(p, max(rp[f][plan.lag[f]]))))
    readers = {(f, d): sorted(rp[f][d]) for _ph, _i, f, d in loads}
    items = [it + (it[3],) for it in items]
    items += [(p, key, _align(nbytes, 128), mask, early)
              for p, key, nbytes, mask, early in plan.onchip_items()]
    for ph, _i, f, d in loads:
        items.append((ph, ("read", f, d), _align(plan.plane_bytes(f), 128),
                      span(ph, readers[f, d][-1]),
                      span(max(ph - 1, 0), readers[f, d][-1])))
    got = place_by_phase(items, base)
    if ahead and loads:
        tried = place_by_phase(items, base, got[3])
        if tried[3] <= got[3]:
            got = tried
    placed, live, size, end = got
    offset.update(placed)
    issue = {(f, d): (ph - 1 if live["read", f, d] >> (ph - 1) & 1 else ph)
             for ph, _i, f, d in loads}
    # loads run ahead where their buffer is free one phase earlier
    for _ph, _i, f, d in loads if ahead else ():
        key = ("read", f, d)
        lo, hi = offset[key], offset[key] + size[key]
        while issue[f, d] > 0:
            bit = 1 << (issue[f, d] - 1)
            if any(live[k] & bit and offset[k] < hi
                   and offset[k] + size[k] > lo for k in live if k != key):
                break
            issue[f, d] -= 1
            live[key] |= bit
    return SpillLayout([(f, d) for _p, _i, f, d in loads], issue, readers,
                       offset, live, end)


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


def _spill_to_fit(plan: StreamPlan, order: List[str], deltas, budget: int,
                  every: bool = False) -> bool:
    """Take the spill rung's layout at ``plan``'s tile and spill rings in
    ``order`` until it fits ``budget`` bytes of shared memory (``every``:
    spill every candidate); rings of one step are packed, never spilled.
    False when nothing fits or the spill buffer exceeds
    ``SPILL_BYTES_CAP``."""
    plan.packed, plan.spilled = True, {}
    for f in order:
        if not every and plan.smem_bytes() <= budget:
            break
        if deltas[f] and not plan.in_step(f):
            plan.spilled[f] = tuple(sorted(deltas[f]))
    return (plan.smem_bytes() <= budget
            and plan.spill_bytes() <= SPILL_BYTES_CAP)


def _build_plan(program: ir.Program, analysis: ChainAnalysis, mxu: str,
                mxu_precision: str, builds, tile, block: int = 0,
                halo_i: int = 0, smem_budget: int = H100_SMEM_PER_BLOCK,
                spill: str = "off", passes: str = "auto",
                threads: Optional[int] = None,
                shard: Tuple[int, int] = (0, 0),
                xhalo: Tuple[int, int] = (0, 0),
                contexts=None, ring_storage: str = "off",
                compute_dtype: str = "float32", compute=None) -> StreamPlan:
    dims = program.dimensions
    I, J, K = dims
    # the plane the pool's matrices span: a shard's widened core, or the
    # whole (J, K) plane
    plane = (shard[0] + 2 * xhalo[0], shard[1] + 2 * xhalo[1]) \
        if shard[0] else (J, K)
    ctx = contexts or (None, None)
    pool = MatrixPool()
    plans: Dict[str, object] = {}
    if mxu != "off":
        plans = plan_all_stages(program, plane, dims, pool,
                                MXU_MIN_FOOTPRINT, ctx[0], ctx[1],
                                exclude=tuple(builds))
    for cname, b in builds.items():
        cp = plan_composed(b, plane, dims, pool, ctx[0], ctx[1])
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
    # each transform's plane deltas (lag[c] - oi) and raw depth needs
    tdeltas: Dict[TKey, set] = {t: set() for t in tkeys}
    src_need: Dict[TKey, int] = {}

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
                tdeltas[tkey].add(lag[c] - (oi or 0))
                src_need[tkey] = max(src_need.get(tkey, 1),
                                     need(c, f, oi))
                if c not in readers[tkey]:
                    readers[tkey].append(c)
            elif f in raw and tkey[1] is None and tkey[2] is None:
                raw[f] = max(raw[f], need(c, f, oi))

    # a transform read at one plane delta is computed at its readers'
    # step from the raw ring they read (deep enough for that plane), and
    # lives within the step; the others keep a ring filled at their
    # field's producer's step
    instep = {t: min(d) for t, d in tdeltas.items() if len(d) == 1}
    for t in instep:
        raw[t[0]] = max(raw[t[0]], src_need[t])
    stage = analysis.stage_halo()
    inp = analysis.input_halo()
    halo = {f: tuple((stage.get(f) or inp.get(f))[1:])
            for f in list(onchip) + list(program.kernels)}
    plan = StreamPlan(program, analysis, lag, ring, lag_max, plans,
                      {n: list(b.stages) for n, b in builds.items()},
                      dict(zip(pkeys, parrs)), tkeys, raw,
                      {t: d for t, d in tdepth.items() if t not in instep},
                      halo, {}, block=block, halo_i=halo_i, instep=instep,
                      mxu_precision=mxu_precision, passes=passes,
                      shard=tuple(shard), xhalo=tuple(xhalo),
                      contexts=contexts, ring_storage=ring_storage,
                      compute_dtype=compute_dtype, compute=compute)
    for f in onchip:   # a sharded dim's reads stay in the exchanged halo
        if any(halo[f][d] > xhalo[d] for d in range(2)
               if shard[0] and shard[d] < dims[1 + d]):
            raise ValueError(f"field {f} halo {halo[f]} exceeds the "
                             f"exchanged halo {tuple(xhalo)}")
    for t in tkeys:
        plan.thalo[t] = tuple(max(halo[c][d] for c in readers[t])
                              for d in range(2))
        need_j = plan.thalo[t][0] + plan.reach(t[1], "L")
        need_k = plan.thalo[t][1] + plan.reach(t[2], "R")
        if halo[t[0]][0] < need_j or halo[t[0]][1] < need_k:
            raise ValueError(f"field {t[0]} halo {halo[t[0]]} is narrower "
                             f"than its transform's reach ({need_j}, "
                             f"{need_k})")
    # the on-chip body's loader moves a ring input of 2-byte cells held in
    # slots of its own type by cp.async groups (``copy_group``: its k-halo
    # widened); the spill rung loads its inputs its own way
    wide, groups = dict(halo), {}
    for f in onchip:
        if f in program.inputs and plan.ring_dtype(f) == plan.dtype(f) \
                and all(t[0] != f for t in tkeys):
            g, hk = copy_group(plan.dtype(f).itemsize, halo[f][1], K,
                               (shard[1], xhalo[1]) if shard[0] else None)
            if g > 1:
                groups[f], wide[f] = g, (halo[f][0], hk)

    def use_groups(on: bool) -> None:
        plan.halo, plan.copy_groups = (wide, groups) if on else (halo, {})

    # the spill rung: per-cell plans only, as the reference's
    spillable = spill != "off" and not plans
    every = spill == "all"
    if spillable:
        deltas = spill_deltas(plan)
        order = spill_order(plan, deltas)

    def on_chip() -> bool:
        """Does the on-chip body fit?  A per-cell plan only where its
        rings fit unpacked, as before the body packed them: packing those
        alone is the spill rung's (K3c)."""
        plan.packed, plan.spilled = False, {}
        use_groups(True)
        size = plan.smem_bytes() if plans else plan.unpacked_bytes()
        return not every and size <= smem_budget

    def best_threads() -> tuple:
        """(modelled seconds, threads) of the on-chip plan's best thread
        count (``threads`` when given)."""
        got = []
        for n in (threads,) if threads else PANEL_THREADS:
            plan.threads = n
            got.append((plan.seconds(), n))
        return min(got)

    if tile is not None:
        plan.tile = tuple(tile)
        if on_chip():
            plan.threads = best_threads()[1]
            return plan
        plan.threads = THREADS
        use_groups(False)
        if spillable and _spill_to_fit(plan, order, deltas, smem_budget,
                                       every):
            return plan
        raise ValueError(f"stream tile {tile} exceeds shared memory")
    best = None
    legs = ("spill",) if every else ("on chip", "spill") if spillable \
        else ("on chip",)
    for leg in legs:
        for cand in tile_candidates((I,) + plan.core()):
            plan.tile = cand
            if leg == "spill":
                plan.threads = THREADS
                use_groups(False)
                if not _spill_to_fit(plan, order, deltas, smem_budget,
                                     every):
                    continue
                cost = (plan.spill_seconds(), -cand[0] * cand[1])
                n = THREADS
            elif not on_chip():
                continue
            else:
                secs, n = best_threads()
                cost = (secs, -cand[0] * cand[1], plan.kpass_cells(), n)
            if best is None or cost < best[0]:
                best = (cost, cand, plan.spilled, n)
        if best is not None:
            break
    if best is None:
        raise ValueError("stream rings exceed shared memory at every tile"
                         + (" (spilled: over the device-memory cap)"
                            if spillable else ""))
    plan.tile, plan.spilled, plan.threads = best[1], best[2], best[3]
    plan.packed = leg == "spill"
    use_groups(not plan.packed)
    return plan


def check_spill(spill: str) -> None:
    if spill not in ("auto", "off", "all"):
        raise ValueError(f"spill must be 'auto', 'off' or 'all', got "
                         f"{spill!r}")


def check_passes(passes: str, mxu_precision: str) -> None:
    if passes not in ("auto", "mma", "fma"):
        raise ValueError(f"passes must be 'auto', 'mma' or 'fma', got "
                         f"{passes!r}")
    if passes == "mma" and mxu_precision == "exact":
        raise ValueError("tensor-core passes (passes='mma') take "
                         "mxu_precision='split' or 'bf16'")


def check_compute_dtype(program: ir.Program, compute_dtype,
                        ring_storage: str
                        ) -> Tuple[str, str, Optional[np.dtype]]:
    """(compute dtype, ring storage, compute type) as the plan takes them:
    the name canonicalised as the JAX package's default 32-bit mode does
    (float64 computes in float32, int64 in int32); the type every stage
    computes in where it is not the program's own, None otherwise
    (``promotion.check_compute_program``: None computes in the program's
    types, and so does float32 on a program of float32 arrays).
    ``ring_storage`` is dropped under a type narrower than 4 bytes, as the
    JAX package drops it; under int32 it rounds nothing."""
    if compute_dtype is None:
        return "float32", ring_storage, None
    name = (str(compute_dtype).replace("torch.", "")
            if isinstance(compute_dtype, (str, torch.dtype))
            else np.dtype(compute_dtype).name)
    from .promotion import canonical_name, check_compute_program
    name = canonical_name(name)
    compute = check_compute_program(program, name)
    if compute is not None and compute.itemsize < 4:
        ring_storage = "off"
    return name, ring_storage, compute


def compute_key(plan: "StreamPlan") -> str:
    """The ``launches_by`` key of a plan under a compute type: its place
    as ``launch_mode`` names it ("spill" for the spill rung, K3c; nothing
    for K3a and K3b), then "compute_" and the type's short name ("bf16",
    "f16", "f32", "i32", "bool"), then "_typed" where the program has an
    array or a stage that is not float32 (the JAX package casts it)."""
    short = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
             "int32": "i32", "bool": "bool"}[plan.compute_dtype]
    program = plan.program
    typed = any(np.dtype(program.field_dtype(f)) != np.float32
                for f in list(program.kernels) + [
                    n for n, s in program.inputs.items() if not s.is_scalar])
    return "_".join(k for k in (_place(plan), "compute_" + short) if k) \
        + ("_typed" if typed else "")


def check_options(mxu: str, mxu_precision: str) -> None:
    """Raise on options the stream lowering does not take."""
    if mxu not in ("auto", "off"):
        raise ValueError(f"mxu must be 'auto' or 'off', got {mxu!r}")
    if mxu_precision not in ("split", "bf16", "exact"):
        raise ValueError(f"unknown mxu_precision {mxu_precision!r} "
                         "(expected split, bf16, or exact)")


def bf16_passes_agree(plain, got, split) -> Tuple[bool, Dict[str, float]]:
    """(ok, figures) of ``got``, a kernel's output under single-pass bf16
    band passes, against ``plain``, its plain version's, and ``split``,
    the split route's on the same inputs (arrays of one shape): finite,
    at least ``BF16_PASS_SHARE`` of the cells within ``BF16_PASS_RTOL``
    of the largest output from ``plain`` (an f32 sum order), every cell
    within ``BF16_VERIFY_RTOL`` of it (``arrays_are_equal``: a rounding
    tie taken the other way, and its cone), and ``split`` farther at that
    share by ``BF16_PASS_SEPARATION``.  Figures: ``max_abs_err`` against
    ``plain``, ``share`` within ``BF16_PASS_RTOL`` of it, and the
    share-quantiles of both distances over the largest output
    (``plain_q``, ``split_q``)."""
    from ..config import (BF16_PASS_RTOL, BF16_PASS_SEPARATION,
                          BF16_PASS_SHARE, BF16_VERIFY_RTOL)
    from ..data import arrays_are_equal
    got = np.asarray(got, np.float64)
    plain = np.asarray(plain, np.float64).reshape(got.shape)
    split = np.asarray(split, np.float64).reshape(got.shape)
    scale = float(np.max(np.abs(plain))) or 1.0
    d = np.abs(got - plain)
    figures = {
        "max_abs_err": float(np.max(d)),
        "share": float(np.mean(d <= BF16_PASS_RTOL * scale)),
        "plain_q": float(np.quantile(d, BF16_PASS_SHARE)) / scale,
        "split_q": float(np.quantile(np.abs(got - split),
                                     BF16_PASS_SHARE)) / scale}
    ok = (bool(np.isfinite(got).all())
          and figures["share"] >= BF16_PASS_SHARE
          and arrays_are_equal(plain, got, BF16_VERIFY_RTOL)
          and figures["split_q"] > BF16_PASS_SEPARATION * max(
              figures["plain_q"], BF16_PASS_RTOL))
    return ok, figures


# bf16 compute (compute_dtype="bfloat16"): the share of a banded chain's
# cells that must equal the plain version's (the rest: a bf16 rounding tie
# taken the other way after an f32 sum in another order, and the cells
# downstream of it)
BF16_COMPUTE_SHARE = 0.99


def bf16_compute_agree(plain, got, banded: bool
                       ) -> Tuple[bool, Dict[str, float]]:
    """(ok, figures) of ``got``, a kernel's output under bf16 compute,
    against ``plain``, its plain version's (arrays of one shape): finite
    and bit for bit on per-cell chains; on banded ones at least
    ``BF16_COMPUTE_SHARE`` of the cells equal and every cell within
    ``BF16_VERIFY_RTOL`` of the largest output.  Figures: ``max_abs_err``,
    ``share`` (cells equal) and ``rel`` (largest difference over the
    largest output)."""
    from ..config import BF16_VERIFY_RTOL
    got = np.asarray(got, np.float64)
    plain = np.asarray(plain, np.float64).reshape(got.shape)
    scale = float(np.max(np.abs(plain))) or 1.0
    d = np.abs(got - plain)
    figures = {"max_abs_err": float(np.max(d)),
               "share": float(np.mean(d == 0)),
               "rel": float(np.max(d)) / scale}
    ok = bool(np.isfinite(got).all()) and (
        figures["share"] >= BF16_COMPUTE_SHARE
        and figures["rel"] <= BF16_VERIFY_RTOL if banded
        else figures["share"] == 1.0)
    return ok, figures


def _composed(program: ir.Program, analysis: ChainAnalysis, max_t: int):
    """``compose_program``'s (composed program, builds) and the composed
    program's analysis, or None; kept on ``program`` (planning it at many
    tiles, as the sweep does, composes and analyses it once)."""
    memo = program.__dict__.setdefault("_composed", {})
    if max_t not in memo:
        got = compose_program(program, analysis, max_t)
        memo[max_t] = None if got is None else (
            got[0], got[1], ChainAnalysis.run(got[0]))
    return memo[max_t]


def plan_stream(program: ir.Program, analysis: Optional[ChainAnalysis] = None,
                mxu: str = "auto", mxu_precision: str = "split",
                compose: str = "auto",
                tile: Optional[Tuple[int, int]] = None,
                smem_budget: int = H100_SMEM_PER_BLOCK,
                spill: str = "auto", passes: str = "auto",
                threads: Optional[int] = None,
                ring_storage: str = "off",
                compute_dtype=None) -> StreamPlan:
    """The stream lowering's plan, making the JAX package's per-stage
    choice between composed, per-stage banded and per-cell, in the
    reference's order: composed, banded, every stage per cell, and last
    the spill rung (``spill="auto"``: per cell, rings spilled to device
    memory).  ``smem_budget`` is the shared memory one block may take
    (the reference's ``vmem_budget``).  ``passes`` forces the band
    passes' route ("mma": tensor cores, "fma": CUDA cores; "auto" by band
    width, ``StreamPlan.route``) and ``threads`` a block's threads (256
    or 512; by default the tile rule's pick).  ``ring_storage``
    ("bfloat16") rounds the f32 rings to bf16 at their store, so that
    they take half the bytes.  ``compute_dtype`` computes every stage in
    that type on inputs, rings and outputs of it (``check_compute_dtype``;
    int32 and bool with every stage per cell).  Raises ValueError /
    NotImplementedError when the program is out of scope, TypeError where
    jnp rejects a site under the compute type (nothing is built)."""
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    check_options(mxu, mxu_precision)
    check_spill(spill)
    check_passes(passes, mxu_precision)
    check_ring_storage(ring_storage)
    compute_dtype, ring_storage, compute = check_compute_dtype(
        program, compute_dtype, ring_storage)
    if compute is not None:   # where jnp rejects a site: TypeError now
        codegen.check_compute_types(program, compute)
    if compute is not None and not is_floating(compute):
        # integer and bool compute keep every stage per cell: a band pass
        # sums in float, where these types wrap (int32) or or (bool);
        # ROADMAP Queue 3 names the JAX package's banded figures
        mxu = "off"
    kw = dict(smem_budget=smem_budget, passes=passes, threads=threads,
              ring_storage=ring_storage, compute_dtype=compute_dtype,
              compute=compute)
    if spill == "all":   # the spill rung alone
        return _build_plan(program, analysis, "off", mxu_precision, {},
                           tile, spill=spill, **kw)
    if compose != "off" and mxu != "off":
        max_t = 0 if compose == "auto" else int(compose)
        got = _composed(program, analysis, max_t) if max_t >= 0 else None
        if got is not None:
            program2, builds, analysis2 = got
            try:
                return _build_plan(program2, analysis2, mxu, mxu_precision,
                                   builds, tile, **kw)
            except ValueError:
                pass   # the uncomposed program below
    if mxu != "off":
        try:
            return _build_plan(program, analysis, mxu, mxu_precision, {},
                               tile, spill=spill, **kw)
        except ValueError:
            pass   # every stage per cell below
    return _build_plan(program, analysis, "off", mxu_precision, {}, tile,
                       spill=spill, **kw)


def plan_local(program: ir.Program, analysis: Optional[ChainAnalysis],
               block: int, halo_i: int, mxu: str = "auto",
               mxu_precision: str = "split",
               tile: Optional[Tuple[int, int]] = None,
               smem_budget: int = H100_SMEM_PER_BLOCK,
               spill: str = "auto", passes: str = "auto",
               threads: Optional[int] = None,
               shard: Tuple[int, int] = (0, 0),
               xhalo: Tuple[int, int] = (0, 0), contexts=None,
               builds=None, ring_storage: str = "off") -> StreamPlan:
    """The local (chunk) plan of K4: ``block`` core i-planes widened by
    ``halo_i`` planes each side; stages banded where ``mxu`` is "auto"
    and the banded planner takes them, the rest per cell; a per-cell
    plan spills rings (``spill="auto"``) when no tile fits
    ``smem_budget`` otherwise; ``passes``, ``threads``, ``mxu_precision``
    and ``ring_storage`` as ``plan_stream`` takes them.  Raises
    ValueError /
    NotImplementedError when the program is out of scope or no tile
    fits.

    Shard mode (a mesh's shard, ``parallel/domain.py``): ``shard`` =
    (Bj, Bk) is the shard's core in (j, k), ``xhalo`` the (j, k) halo its
    inputs arrive widened by, ``contexts`` the global (j, k) origin of
    every shard instance's widened plane (``linear.plan_linear_stage``'s
    j/k contexts: the pool then holds origin-aware bands and correction
    planes, stacked per instance).  ``builds``: a composed program's
    segments (``compose.compose_program``), planned exactly or
    refused."""
    if block < 1 or halo_i < 0:
        raise ValueError(f"bad local block {block} / i-halo {halo_i}")
    analysis = analysis or ChainAnalysis.run(program)
    check_scope(program)
    check_options(mxu, mxu_precision)
    check_spill(spill)
    check_passes(passes, mxu_precision)
    check_ring_storage(ring_storage)
    return _build_plan(program, analysis, "off" if spill == "all" else mxu,
                       mxu_precision, builds or {}, tile, block=block,
                       halo_i=halo_i, smem_budget=smem_budget, spill=spill,
                       passes=passes, threads=threads, shard=shard,
                       xhalo=xhalo, contexts=contexts,
                       ring_storage=ring_storage)


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
                 origin_i: int = 0, origin_j: int = 0, origin_k: int = 0,
                 inst: Tuple[int, int] = (0, 0)
                 ) -> Dict[str, torch.Tensor]:
    """The plan's function in torch ops on whole (J, K) planes, streamed
    along i: per-cell stages through tile_eval with the boundary rules of
    the kernels, banded stages as ``L @ P @ R`` matmuls, the correction
    planes and the composed i-combine.  ``arrays`` holds every input at
    its spanned shape (0-d for scalars), i-spanning inputs at the plan's
    extent; returns the core planes, (I, J, K) for a whole-domain plan
    and (block, J, K) for a local one, whose local plane 0 is global
    plane ``origin_i``.  A read of a plane outside the chunk gets a junk
    plane (``_junk``).  In shard mode the planes are the shard's widened
    (j, k) plane, whose core starts at global (``origin_j``,
    ``origin_k``), the pool is shard instance ``inst``'s and the outputs
    are the (block, Bj, Bk) core."""
    program = plan.program
    I, J, K = program.dimensions
    Ii, h = plan.extent(), plan.halo_i
    Ic = Ii - 2 * h
    PJ, PK = plan.plane()
    # rounded rings and a narrow compute round to the plan's slot type;
    # under a compute type every array arrives cast to it
    cd = plan.compute
    slot = to_torch_dtype(plan.slot_dtype)
    if cd is not None:
        arrays = {n: a if program.inputs[n].is_scalar else to_compute(
            a, program.inputs[n].dtype, cd) for n, a in arrays.items()}

    def rnd(x):
        return x.to(slot).to(x.dtype)

    (BJ, BK), (XJ, XK) = plan.core(), plan.xhalo
    device = next(a for n, a in arrays.items()
                  if not program.inputs[n].is_scalar).device
    f32 = torch.float32
    mats = {k: torch.as_tensor(plan.matrix(k, inst)).to(device)
            for k in plan.pool}
    planes: Dict[str, Dict[int, torch.Tensor]] = {}
    tcache: Dict[Tuple[TKey, Optional[int]], torch.Tensor] = {}
    outs = {o: torch.empty((Ic, BJ, BK), device=device,
                           dtype=to_torch_dtype(program.kernels[o].dtype))
            for o in program.outputs}
    # global (j, k) of the plane's cells
    jj = torch.arange(PJ, device=device)[:, None] + (origin_j - XJ)
    kk = torch.arange(PK, device=device)[None, :] + (origin_k - XK)

    def inside(p):
        """Is global plane ``p`` in the domain?"""
        return 0 <= origin_i + p < I

    def plane(f, p):
        """Raw (J, K) plane ``p`` of field ``f`` (broadcast for lower-rank
        inputs and scalars)."""
        dt = to_torch_dtype(program.field_dtype(f)) if cd is None or (
            f in program.inputs and program.inputs[f].is_scalar) \
            else carrier(cd)
        if f in program.kernels:
            got = planes.get(f, {}).get(p)
            return got if got is not None else _junk(dt, (PJ, PK), device)
        spec = program.inputs[f]
        a = arrays[f].to(device)
        if spec.is_scalar:
            return a.expand(PJ, PK)
        if spec.dim_mask[0]:
            if not 0 <= p < Ii:
                return _junk(dt, (PJ, PK), device)
            a = a[p]
            if plan.rounded(f):
                a = rnd(a)
        return a.reshape(PJ if spec.dim_mask[1] else 1,
                         PK if spec.dim_mask[2] else 1).expand(PJ, PK)

    def band_pass(v, key, side):
        """The single-pass bf16 pass of band ``key`` along ``side``'s
        axis, as the kernel sums it: operand and band rounded to bf16,
        the exact products summed in f32 in tap order."""
        offsets, coef = plan.band(key, side, inst)
        v = round_bf16(v)
        n = v.shape[0 if side == "L" else 1]
        acc = torch.zeros_like(v)
        for i, d in enumerate(offsets):
            lo, hi = max(0, -d), min(n, n - d)
            src = torch.zeros_like(v)   # 0 beyond the plane
            w = torch.as_tensor(coef[i]).to(device)
            if side == "L":
                src[lo:hi] = v[lo + d:hi + d]
                acc = acc + w[:, None] * src
            else:
                src[:, lo:hi] = v[:, lo + d:hi + d]
                acc = acc + w[None, :] * src
        return acc

    def transformed(f, p, lkey, rkey):
        key = ((f, lkey, rkey), p)
        if key not in tcache:
            v = plane(f, p).to(f32)
            if plan.mxu_precision == "bf16":   # in the kernel's order
                for side in plan.pass_order((f, lkey, rkey)):
                    v = band_pass(v, lkey if side == "L" else rkey, side)
            else:
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
            gq = origin_i + q
            row = gq if mp.full_table else (
                gq if gq < mp.D else
                mp.table_rows + gq - I if gq >= I - mp.D else mp.D)
            row = min(max(row, 0), mp.table_rows - 1)
            acc = torch.zeros((PJ, PK), dtype=f32, device=device)
            for idx, d in enumerate(mp.offsets):
                if 0 <= gq + d < I:
                    acc = acc + transformed(mp.field, q + d, mp.lkey,
                                            mp.rkey) * f32c(tab[row, idx])
            return acc
        acc = None
        for grp in mp.groups:
            p = None if grp.oi is None else q + grp.oi
            if p is not None and not inside(p):
                parts = f32c(grp.bc_value * grp.weight_sum).expand(PJ, PK)
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
            if cd is None or (bc is not None
                               and bc.kind == ir.BCKind.COPY):
                val = bc_select(bc, dt, mask, val, lambda: plane(field, q))
            elif mask is not None and mask is not False:
                # under a compute type a fill is converted to it
                fill = device_const(compute_fill(
                    bc, cd, static_input(program, field)).item(),
                    carrier(cd), val.device)
                val = fill.expand(val.shape) if mask is True else \
                    torch.where(mask, fill, val)
            return val, dt
        return eval_kernel_statements(kspec, read, (PJ, PK), device,
                                      compute=cd)

    for t in range(plan.steps()):
        for s in plan.analysis.graph.kernel_order:
            q = t - plan.lag[s]
            if not 0 <= q < Ii:
                continue
            mp = plan.mxu_plans.get(s)
            if mp is None:
                val = per_cell(program.kernels[s], q)
            else:   # under a compute type the stage's result rounds
                val = banded(mp, q)
                val = val if cd is None else round_to(val, cd)
            if s in plan.ring:
                planes.setdefault(s, {})[q] = rnd(val).contiguous() \
                    if plan.rounded(s) else val.contiguous()
                planes[s].pop(q - plan.ring[s], None)
            if s in outs and h <= q < h + Ic:
                core = val[XJ:XJ + BJ, XK:XK + BK]
                outs[s][q - h] = from_compute(
                    core, cd, program.kernels[s].dtype) if cd is not None \
                    else rnd(core) if s in plan.rounds_out else core
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


def _pool_tensors(plan: StreamPlan, device, inst: Tuple[int, int] = (0, 0)
                  ) -> List[torch.Tensor]:
    """The kernel's device tables, then its spill buffer (one per plan,
    device and shard instance: launches on one stream reuse it in turn).
    The compile entry points fill it for their device, so that no launch
    copies from the host (a copy a CUDA graph capture refuses)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = device if plan.contexts is None else (device, inst)
    if key not in plan.device_pool:
        plan.device_pool[key] = [
            torch.as_tensor(a).to(device).contiguous()
            for _k, a in plan.kernel_pool(inst)]
        if plan.spilled:
            plan.device_pool[key].append(torch.empty(
                plan.spill_bytes(), dtype=torch.uint8, device=device))
    return plan.device_pool[key]


def reduced(plan: StreamPlan) -> bool:
    """Does ``plan`` round anything to bf16: a ring, an output, or the
    operands of its band passes?"""
    return bool(plan.rounds or plan.rounds_out) or plan.bf16_passes


def _place(plan: StreamPlan) -> str:
    """Where ``plan``'s kernel runs, as its launch key names it: "shard",
    "spill", "local", or "" for the whole domain on chip."""
    return ("shard" if plan.shard[0] else "spill" if plan.packed
            else "local" if plan.block else "")


def _mode(plan: StreamPlan) -> str:
    """The key of ``plan``'s launches in ``launches_by``."""
    if plan.compute is not None:
        return compute_key(plan)
    return launch_mode(plan.program, reduced(plan), _place(plan))


def run_stream(plan: StreamPlan, arrays: Dict[str, torch.Tensor], lib=None):
    """The stream kernel on ``arrays`` (spanned shapes, scalars 0-d).
    ``lib`` is the built kernel (``build_stream``); it is built on demand
    when omitted."""
    if plan.block:
        raise ValueError("a local plan runs through run_local_stream")
    program, cd = plan.program, plan.compute
    io = None if cd is None else to_torch_dtype(cd)
    if io is not None:   # a compute type: the kernel reads and writes it
        arrays = {n: a if program.inputs[n].is_scalar
                  or a.device.type == "cpu" else to_compute(
                      a, program.inputs[n].dtype, cd).to(io)
                  for n, a in arrays.items()}
    outs, launched = run_kernel(
        plan.program, arrays,
        lambda: lib if lib is not None else build_stream(plan),
        lambda: stream_plain(plan, arrays),
        extra=lambda device: _pool_tensors(plan, device), io_dtype=io,
        groups=plan.copy_groups)
    launches_by[_mode(plan)] += launched
    if launched and io is not None:   # each output to its kernel type
        outs = {o: from_compute(v, cd, program.kernels[o].dtype)
                for o, v in outs.items()}
    return outs


def local_stream_plain(plan: StreamPlan, origin_i: int,
                       slabs: Dict[str, torch.Tensor], origin_j: int = 0,
                       origin_k: int = 0, inst: Tuple[int, int] = (0, 0)
                       ) -> Dict[str, torch.Tensor]:
    """K4's plain version: ``stream_plain`` of a local plan on one
    chunk's slabs, local plane 0 at global plane ``origin_i`` (in shard
    mode: the shard's core at global (``origin_j``, ``origin_k``), pool
    instance ``inst``)."""
    return stream_plain(plan, slabs, origin_i, origin_j, origin_k, inst)


def _local_dims(plan: StreamPlan):
    return (plan.extent(),) + plan.plane(), (plan.block,) + plan.core()


def run_local_stream(plan: StreamPlan, origin_i: int,
                     slabs: Dict[str, torch.Tensor], lib=None,
                     origin_j: int = 0, origin_k: int = 0,
                     inst: Tuple[int, int] = (0, 0), out=None):
    """K4 on one chunk: ``slabs`` holds the i-spanning inputs at the
    plan's extent (Ic + 2h planes, zero outside the domain), the other
    inputs whole, scalars 0-d; ``origin_i`` is the global index of the
    slabs' first plane.  Returns the (Ic, J, K) core planes of every
    output.  ``lib`` is the built kernel (``build_stream``).  In shard
    mode the slabs span the shard's widened (j, k) plane (zero outside
    the domain), the shard's core starts at global (``origin_j``,
    ``origin_k``), ``inst`` is its pool instance, and the outputs are
    the (Ic, Bj, Bk) core (``sf_shard_launch``).  ``out``: the output
    tensors to write (slices of a shard's whole output, say)."""
    if not plan.block:
        raise ValueError("run_local_stream takes a local plan (plan_local)")
    if plan.shard[0] and plan.copy_groups and origin_k % max(
            plan.copy_groups.values()):
        raise ValueError(f"shard k origin {origin_k} breaks the alignment "
                         "of the plan's cp.async groups")
    in_dims, out_dims = _local_dims(plan)
    outs, launched = run_kernel(
        plan.program, slabs,
        lambda: lib if lib is not None else build_stream(plan),
        lambda: stream_plain(plan, slabs, origin_i, origin_j, origin_k,
                             inst),
        extra=lambda device: _pool_tensors(plan, device, inst),
        in_dims=in_dims, out_dims=out_dims, origin_i=origin_i,
        origin_jk=(origin_j, origin_k) if plan.shard[0] else None, out=out,
        groups=plan.copy_groups)
    launches_by[_mode(plan)] += launched
    return outs


def compile_local_stream(plan: StreamPlan, device="cuda"):
    """``chunk_fn(origin_i, slabs) -> outputs`` running the local plan
    ``plan`` on ``device`` (K4 built now for a CUDA device, the plain
    version on the CPU); ``slabs`` as ``run_local_stream`` takes them."""
    device = resolve_device(device)
    lib = build_stream(plan) if device.type == "cuda" else None
    if lib is not None:
        _pool_tensors(plan, device)

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
    if lib is not None:
        _pool_tensors(plan, device)

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
                         spill: str = "auto", ring_storage: str = "off",
                         compute_dtype=None):
    """Plan the stream lowering (ValueError / NotImplementedError when the
    program is out of its scope) and, for a CUDA ``device``, build its
    kernel.  Returns ``fn(inputs) -> outputs`` at the program's raw dims,
    with the plan as ``fn.plan`` and the JAX package's configuration keys
    as ``fn.last_config``.  ``smem_budget``, ``spill``,
    ``ring_storage`` and ``compute_dtype`` go to ``plan_stream``; under a
    compute type the inputs are cast to it before the kernel and its
    outputs to their kernel types after it."""
    plan = plan_stream(program, analysis, mxu=mxu,
                       mxu_precision=mxu_precision, compose=compose,
                       tile=tile, smem_budget=smem_budget, spill=spill,
                       ring_storage=ring_storage,
                       compute_dtype=compute_dtype)
    return compile_stream_plan(plan, device)

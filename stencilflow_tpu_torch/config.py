"""Framework-wide configuration constants.

The op-latency table mirrors StencilFlow's per-op pipeline-latency model
(stencilflow/compute_graph.config:1-21) and is used for delay alignment
analysis.  The verification tolerances are the JAX package's own
(stencilflow_tpu/config.py), so both packages verify to the same contract.
The H100 hardware model at the end (report.py's ``HardwareModel``) holds
data-sheet constants and the probes' readings (``probes/``), each beside
the card it was measured on.
"""
from __future__ import annotations

# Per-op pipeline latency (cycles) used by the dataflow scheduling analysis.
# Same shape as the reference's compute_graph.config.
OP_LATENCY = {
    "add": 16,
    "sub": 16,
    "mult": 16,
    "div": 128,
    "neg": 16,
    "min": 16,
    "max": 16,
    "comp": 16,   # comparisons
    "cond": 16,   # ternary select
    "bool": 16,   # and/or
    "sin": 128,
    "cos": 128,
    "tan": 128,
    "sinh": 128,
    "cosh": 128,
    "tanh": 128,
    "sqrt": 128,
    "exp": 128,
    "log": 128,
    "abs": 16,
    "name": 0,
    "num": 0,
    "subscript": 0,
    "output": 0,
}

# Relative tolerance for result verification
# (reference: stencil_chain.config eps=1e-10; comparisons use 1e-5 relative,
#  stencilflow/helper.py:261-276).
EPS = 1e-10
VERIFY_RTOL = 1e-5
# the MXU banded-matmul lowering re-associates f32 sums (split-precision
# bf16 hi/lo passes); its guaranteed envelope is 3e-5 relative (enforced
# by tests/test_fuzz.py) — the JAX package's driver verifies MXU-lowered
# runs at this
MXU_VERIFY_RTOL = 3e-5
# opt-in single-pass bf16 band transforms (mxu_precision="bf16") round
# matrices and operand planes to 8-bit mantissas: per-stage error ~2^-9
# relative, compounding over the chain — the JAX package's driver
# verifies such runs at this envelope
# (tests/test_mxu.py::test_box_chain_bf16_single_pass)
BF16_VERIFY_RTOL = 2e-2
# a kernel's single-pass bf16 band passes against their plain version
# (``backend.stream.bf16_passes_agree``): the same roundings, f32 sums
# in another order (the tensor cores' own, a banded stage's fmaf), which
# moves a cell by an f32 ulp or so; where such a sum lands on a bf16 tie,
# a later pass rounds its operand the other way, and a cone of cells
# differs by bf16 ulps (2.1e-3 of the largest output on cross-r2 40 x 48
# x 72 x 4 of the g++ build, 0.18 % of its cells).  So at least
# BF16_PASS_SHARE of the cells lie within BF16_PASS_RTOL of the largest
# output from the plain version, every cell within BF16_VERIFY_RTOL, and
# at that share the split route's output lies BF16_PASS_SEPARATION times
# farther: passes run unrounded or split fail
BF16_PASS_RTOL = 1e-6
BF16_PASS_SHARE = 0.99
BF16_PASS_SEPARATION = 4

# Junk value written into shrink-boundary halo cells
# (reference: stencilflow/stencil/_common.py:8).
JUNK_VAL = -100000.0

# Canonical iterator names (reference: helper.py:27).
ITERATORS = ("i", "j", "k")

# --- H100 hardware model (report.py) ----------------------------------------
# NVIDIA H100 SXM data sheet: HBM3 rate and size, FP32 rate outside the
# tensor cores (an FMA counts two flops), shared memory per block and per
# SM, SM count, L2.
H100_HBM_BANDWIDTH = 3.35e12          # bytes/s
H100_HBM_BYTES = 80 * 10**9
H100_F32_FLOPS = 67e12
# One FP32 instruction per lane per cycle: 132 SMs x 128 lanes x ~1.98
# GHz.  The port builds every kernel with -fmad=false, where each IR add,
# multiply (and each flop of a band transform's multiply-add) is one
# instruction: P1 measures ``a * c + d`` at 2.00 add-times, two
# instructions (probes/alu_ceiling.py on an NVIDIA H100 80GB HBM3,
# 700.00 W).  The report divides counted ops by this rate.
H100_ALU_OPS = H100_F32_FLOPS / 2
# The data sheet's bf16 and fp16 rate outside the tensor cores (133.8e12
# flop/s, an FMA counting two) is twice the FP32 rate: packed HADD2 /
# HMUL2 and their bf16 forms do two ops a lane a cycle.  A native narrow
# + - * / or sqrt rounds as "compute in f32, round once" does (24 >=
# 2p + 2), so an op of a stage typed bfloat16 or float16 is priced here.
H100_NARROW_ALU_OPS = 2 * H100_ALU_OPS
# the data sheet's dense bf16 tensor-core rate (flops/s): the price of the
# single-pass bf16 band passes (mxu_precision="bf16", report.py)
H100_BF16_TENSOR_FLOPS = 989e12
# NVLink 4 between two H100 SXM5 cards: the data sheet's 900 GB/s counts
# both directions, so one direction carries 450e9 B/s.  A data-sheet
# figure, not a measurement: the port's mesh-scaling model
# (report.mesh_scaling) prices the halo exchange with it.
H100_NVLINK_BANDWIDTH = 450e9         # bytes/s, per direction
H100_SMEM_PER_BLOCK = 232448          # 227 KB of dynamic shared memory
H100_SMEM_PER_SM = 233472
H100_SM_COUNT = 132
H100_L2_BYTES = 50 * 10**6
# Measured on an NVIDIA H100 80GB HBM3, 700.00 W:
# P4 (probes/copy_floor.py): the best device-memory copy rate beyond the
# L2, bytes read plus bytes written per second.
H100_COPY_FLOOR = 3.0372e12
# P1 (probes/alu_ceiling.py): the best register-resident FP32 issue rate
# (instructions/s, single-kind ops), and the pass rate of an add whose
# accumulator goes through shared memory and a __syncthreads every op.
H100_ALU_ISSUE_RATE = 33.098e12
H100_SMEM_PASS_RATE = 2.926e12
# The share of H100_COPY_FLOOR that the blocks of a streaming kernel reach
# with 1, 2 and more blocks resident per SM when they move planes
# asynchronously: P3 (probes/async_ring.py, 512^3 f32, a 4-slot cp.async
# ring, no ALU work) took 0.4580 and 0.3761 ms at 1 and 2 blocks per SM,
# P6's passthrough (probes/dma_overlap.py) 0.3720 ms with every block
# resident, against the floor's 0.3535 ms.  The spill rung of the stream
# kernel prices its device-memory traffic with it.
H100_ASYNC_COPY_SHARE = (0.772, 0.940, 0.950)
# Cell evaluations per second per SM of a per-cell stage in the streaming
# kernels at 2 blocks per SM: the panel kernel on jacobi3d 512^3 x 8
# (bench.py --workload jacobi, 6.168 ms an application) evaluates
# 2.364e9 stage and input cells (8880 a block and plane step at the
# (16, 32) tile, 520 steps, 512 blocks) over 132 SMs.
H100_STREAM_CELL_RATE = 2.904e9
# Thread-evaluations per second per SM of the redesigned panel kernel
# (K1: per-step ring bases, mask-free interior bodies, cp.async input
# planes) at 2 blocks of 256 threads per SM, lanes of idle last passes
# included; its tile rule (``PanelPlan.seconds``) prices a tile with it.
# On an NVIDIA H100 80GB HBM3 (700 W), python -m
# stencilflow_tpu_torch.sweep ran jacobi3d 512^3 x 8 at (16, 32) in
# 4.649 ms: 520 steps x 2 waves x 2 blocks x 8192 lanes a block and step.
H100_PANEL_CELL_RATE = 3.665e9
# Thread-evaluations per second per SM of the group kernel (K5) at 2
# blocks of 256 threads per SM on jacobi2d 8192^2 x 8's stages, its plan
# rule's rate (``GroupPlan.seconds``): python -m stencilflow_tpu_torch.sweep
# jacobi2d hotspot2d on an NVIDIA H100 80GB HBM3 (700 W) timed 108 plans
# (tile x threads x i-segments), and ``sweep.fit_group`` fitted the rule's
# constants to them.
H100_GROUP_CELL_RATE = 8.416e9
# Cell evaluations and shared-memory loads (an input copy counts as a
# load) per second per SM of the overlap streamer (K2) at 2 blocks of 256
# threads per SM, its plan rule's rate (``OverlapPlan.terms``; loads
# outnumber evaluations 3.5-10x on every swept plan, so the unit is
# mostly loads): python -m stencilflow_tpu_torch.sweep overlap_jacobi3d2
# overlap_hotspot3d2 overlap_jacobi2d2 on an NVIDIA H100 80GB HBM3
# (700 W) timed 576 plans (tile x threads x runs), and
# ``sweep.fit_overlap`` fitted the rule's constants to them.
H100_OVERLAP_CELL_RATE = 2.796e+10
# P1: cost of each op in add-equivalents (its time over an add's, less
# the IR ops the probe adds around it); sinh and cosh are not measured
# and keep the JAX package's rule, exp's cost scaled by 4 / 1.5.
H100_OP_COST = {
    "div": 17.12, "sqrt": 11.55, "exp": 9.67, "sin": 30.97, "cos": 32.01,
    "tan": 29.89, "tanh": 18.19, "log": 25.89, "cond": 2.88,
    "sinh": 25.79, "cosh": 25.79,
}

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
# P1: cost of each op in add-equivalents (its time over an add's, less
# the IR ops the probe adds around it); sinh and cosh are not measured
# and keep the JAX package's rule, exp's cost scaled by 4 / 1.5.
H100_OP_COST = {
    "div": 17.12, "sqrt": 11.55, "exp": 9.67, "sin": 30.97, "cos": 32.01,
    "tan": 29.89, "tanh": 18.19, "log": 25.89, "cond": 2.88,
    "sinh": 25.79, "cosh": 25.79,
}

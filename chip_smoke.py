#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (stencilflow_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card, < 20 minutes

Phases, one line each (any failure raises and exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every kernel of phases 3 to 7 generated and compiled at once,
   one nvcc per source, all started together (kernels are built from the
   checkout's sources; phase 7's through the entry points' own compile
   calls, on threads beside);
3. kernel vs plain version on the card: the panel and overlap kernels,
   each forced through its own plan, against their plain torch versions
   on three example programs and five random chains (constant / copy /
   shrink BCs, scalar and lower-rank inputs, float32 / float64 / int32
   fields), bit-exact or within VERIFY_RTOL where a transcendental
   appears, and the overlap kernel alone on hotspot3d 24 x 40 x 72 x 2 (on
   its rule's plan, at B = 4 with runs of 4 j cells and the register
   window, and as the skeleton alone) and jacobi2d 96 x 200 x 2 (I = 1);
   the stream kernel against its plain version on box chains of
   extent 1 and 2 (composed), a box with constant BC 0.7 (per-stage plans
   with correction planes), a shrink box, a radius-2 cross (rank 2, per
   stage) and a per-cell stage feeding a wide affine stage that reads two
   fields, each banded case also with its band passes on the other route
   (tensor cores against CUDA cores), within MXU_VERIFY_RTOL (the plain
   version applies the bands with torch.matmul, another summation order);
   the group kernel against
   its plain version, bit-exact, on jacobi2d 256 x 192 x 8 through rows
   (constant / copy / shrink BCs), hotspot2d 256 x 192 x 8 (both at the
   main path's g = 8, B = 64), the 2-D fuzz chain through rows, a 3-D
   jacobi with i-offsets of 3 at g = 2, B = 2, and the 3-D fuzz chain with
   a scalar and lower-rank inputs, and the shrink jacobi2d and the 3-D
   jacobi again cut into 4 i-segments; the local chunk kernel K4 against its
   plain version, chunk by chunk, on jacobi3d 64^3 x 3 at 4 chunks
   (constant / copy / shrink BCs), the hdiff DAG at 4 chunks (i-halo 0),
   a box chain of extent 2 banded per stage at 2 chunks and the 3-D fuzz
   chain (bit-exact per cell, MXU_VERIFY_RTOL banded); the stream kernel
   of the spill rung (K3c: shared memory packed by liveness, spilled
   rings staged and moved by bulk asynchronous copies) against its plain
   version, bit-exact, on the reconvergent 16-stage chain (a
   shared-memory budget that forces the spill), jacobi3d 64^3 x 3 with
   every ring spilled (constant / copy / shrink BCs), the hdiff DAG and a
   32-stage hotspot chain (``spill="all"``) and K4 with every ring
   spilled at 4 chunks; the overlapped-tile kernel
   (K6), masked and fast (one launch: mask-free interior blocks, masked
   border blocks), against its plain version (fast: mask-free plus the
   torch fix-up of the border shell) on the example programs and fuzz
   chains above (bit-exact or within VERIFY_RTOL where a transcendental
   appears);
4. the ``run`` main path at full size through ``run_program(...,
   device="cuda")``: jacobi3d 512^3 x 8 (panel), jacobi3d 512^3 x 2
   (overlap), hdiff3d and hotspot3d 256^3 x 8 (panel), box3d 256^3 x 8 of
   extent 2 (stream, all 8 stages composed) and cross3d 256^3 x 8 of
   extent 2 (stream, per stage), jacobi2d and hotspot2d 8192^2 x 8
   (rows+group_g8), hdiff2d 8192^2 x 16 (panel: its rings of one plane
   packed by liveness; the stream kernel's packed plan timed beside), the
   deep 3-D chains jacobi3d
   512^3 x 32, hdiff3d 256^3 x 16 and hotspot3d 256^3 x 32 (the spill
   rung, K3c, 3 repetitions), and K6 forced
   through ``backend="tile"`` (its fast mode) on jacobi3d 512^3 x 2 and
   hdiff3d 256^3 x 8, each verified against the dense lowering on the
   card and, up to 256^3 and for the two 8192^2 x 8 cells, against the
   numpy oracle
   (bit-exact for the per-cell kernels, MXU_VERIFY_RTOL for the banded
   stream ones); kernel launch counts are reset just before and read
   just after, and each kernel must have been launched.  The stream cells
   also print the forced-panel time where the panel planner accepts the
   program; before the main path, box and cross on the stream kernel
   against its plain version with their tile, threads, packed and
   unpacked shared memory, resident blocks per SM, stage evaluations a
   cell and the band passes' route, each timed in turns with its plan on
   the other route (route, other, other, route); the 2-D cells the forced
   overlap kernel on the unrotated
   plane (the port's route before the rows path) and forced rows+panel,
   the forced K6 cells the route's time; before the main path, K1 on
   each panel cell (jacobi3d 512^3 x 8, hdiff3d and hotspot3d 256^3 x 8)
   against its plain version bit for bit, with its tile, packed and
   unpacked shared memory, resident blocks per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), masked share,
   time and bound, K2 on jacobi3d 512^3 x 2 with its plan ((B, tj, tk),
   R, register window, blocks along i, threads, resident blocks per SM,
   shared memory), and K3c on
   each deep cell against its plain version bit for bit, with its time,
   share of the bound, spill traffic a call against the copy floor,
   spilled rings, loads a step and resident blocks per SM, and the dense
   lowering's time beside it, and K5 on jacobi2d and hotspot2d 8192^2 x 8
   and K6 on jacobi3d 512^3 x 2 (masked, then fast) against their plain
   versions bit for bit, with tile, threads, i-segments, shared memory,
   resident blocks per SM, time and bound; after the main path, one
   ``F.conv3d`` (``F.conv2d`` for jacobi2d) per stage, chained (TF32
   off), is timed for the linear chains as a library yardstick the port
   never calls;
5. the out-of-core path (``run --host-chunks N``) through
   ``run_program(..., host_chunks=N, device="cuda")``: jacobi3d 1024^3 x
   8 at 8 chunks and hotspot3d 512^3 x 8 at 4 chunks, each bit-equal to
   the in-core route (panel) on the same inputs, K4 launched N times per
   call (counts reset just before, read just after), the device memory
   peak (jacobi: below a third of the in-core input and output), the time
   per call with transfers, the bytes over the host link and the link
   bound from the pinned copy rates measured with 1 GiB ``copy_``s; K4
   alone on one jacobi chunk beside its plain version and 8 chained
   ``F.conv3d`` over the widened chunk, with its tile, threads, packed
   and unpacked shared memory, resident blocks and evaluations a cell;
6. the measurement path: the probes' kernels against their plain
   versions on the card (P4's copy of 512 x 512^2 bit-equal to its input
   and timed beside ``copy_``; P1's every op at 8 steps, bit-exact or
   within ``alu_ceiling.TOLERANCE``), then, each with its launch count
   reset just before and read just after, P4's flat and tiled copies, one
   differenced P1 timing of add, fma, fma_fused and the shared-memory
   add, P7 at U = 1 and 2, eager and graph, at 512 and 8 planes (both
   ping-pong buffers bit-equal to the input after every case; its
   launches are P4's count over P7's run), and one session of ``python
   -m stencilflow_tpu_torch.bench --workload jacobi`` (its JSON line
   printed), each of whose bound fractions must be at most 1; then P7's
   loop at 512 planes, U = 2, with its plain version and with ``copy_``
   as the body.  The graph-timed probes (P4, P7) count eager launches
   and graph captures: a replay re-runs the captured launches without
   passing through the wrapper.  Then the design probes: P6 (dep and
   indep, out and acc) and P3 (direct and the cp.async ring, every S) at
   1, 2 and all blocks per SM, P2 in every variant and P5 in every walk,
   each against its plain version bit for bit at ragged shapes and at
   the main shape (512^3; P2 33 x 33 over 256 steps of 256^2), P5
   against K2 (the overlap kernel) on the same chain written as a
   StencilFlow program; one timed case per probe (P6 dep N = 16, P3 ring
   S = 4 N = 16 at 1 block per SM, P2's four variants, P5 B = 8 (16, 64)
   beside K2 and two chained ``F.conv3d``), each count reset just before
   and read just after.

7. the solver entry points at full width, each wrapper's count reset
   just before and read just after (K1, K2 and K4 must launch, and K5
   where Gray-Scott routes there; a graph replay re-runs its captured
   launches without the wrappers, so the counts see warm-ups and
   captures): ``iterate`` on jacobi3d 512^3 (one stage), 64 steps, fused
   by 8 (K1) and one stage a step (K2), the two bit-equal and equal to
   the dense lowering stepped 64 times eagerly, each with its ms a step
   from a CUDA-graph replay beside K1's one-shot 8-stage time; Gray-Scott
   8192^2 (the two fields of ``examples/gray_scott.py`` fed back, copy
   BCs) fused by 4 and not fused, bit-equal to each other and to dense
   stepping, 16 steps; ``iterate --host-chunks 8`` on jacobi3d 1024^3
   fused by 8 (K4), 16 steps, bit-equal to in-core ``iterate`` (K1);
   ``fast_value_and_grad`` on jacobi3d 512^3 x 8 and on the same chain
   at 256^3 with copy BCs (the adjoint's 1-D indicator inputs on a
   kernel), each gradient equal to the dense lowering of the adjoint
   program on the same cotangent bit for bit, with routes, ms and the
   device's peak memory, and ``value_and_grad`` (dense autodiff) beside
   each within VERIFY_RTOL, with its time and peak; ``solve_cg`` on backward-Euler
   diffusion 512^3 and ``solve_cgnr`` on an upwind operator at 512^3,
   their iterations, true relative residuals (at most 100 tol) and ms an
   iteration split into operator and vector passes, and CG at 4 host
   chunks within 10 tol of the in-core x.

8. the simulator: ``run --run-simulation`` through ``run_program(...,
   device="cuda", run_simulation=True, compare_to_reference=True)`` on
   jacobi3d 512^3 x 8 (K1), jacobi3d 256^3 x 2 (K2), hotspot2d 4096^2 x 8
   (K5, rows+group_g8), box3d 128^3 x 8 of extent 2 (K3b, banded stages,
   MXU_VERIFY_RTOL) and a mixed-dtype chain (int32 / bool / float stages)
   at 48^3, each leg's native simulator core (g++) and kernel (nvcc)
   built first, all at once; the 512^3 leg on one thread, the others in
   turn on another (the simulator and the oracle run on the host); each
   verified against the simulator and the oracle, the per-cell ones
   bit-equal to the simulator, with the kernels' counts reset just
   before the legs and read just after (each leg's kernel must launch)
   and the simulator's cycles, host seconds, Mcycles/s and g++ seconds
   printed; beside the legs, ``python -m stencilflow_tpu_torch.cli
   simulate`` with ``--trace-chrome`` on a 16^3 program in a subprocess
   (exit 0, a non-empty trace with activity spans).

Every bound comes from the port's report (report.py): the larger of the
minimum bytes over the data sheet's 3.35e12 B/s and the faster compute
strategy's operations over the single-instruction FP32 rate.  The last
lines are the card line, a JSON object of the kernels (launches from
phase 4, K4's from phase 5 and the probes' from phase 6; error, kernel,
plain-version and library times measured in this run at the main path's
shapes, bounds computed from its inputs; 15 entries: the stream
kernel's on box and on cross) and ``{"ok": true,
"device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def _routes(plan) -> str:
    """The band passes of an on-chip stream plan by width: "33-tap mma"
    (tensor cores) or "5-tap fma" (CUDA cores)."""
    return ", ".join(sorted({
        f"{plan.band_info(k, side).taps}-tap {plan.route(k, side)}"
        for t in plan.tkeys for k, side in ((t[1], "L"), (t[2], "R"))
        if k is not None}))


def _has_transcendental(program) -> bool:
    from stencilflow_tpu_torch import ir
    return any(isinstance(n, ir.Call) and n.fn not in ("min", "max", "abs")
               for k in program.kernels.values() for s in k.statements
               for n in ir.walk(s.rhs))


def _compare(a: np.ndarray, b: np.ndarray, rtol: float):
    """(ok, max abs diff): bit-exact (NaN == NaN) when rtol is 0."""
    from stencilflow_tpu_torch.data import arrays_are_equal
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    with np.errstate(invalid="ignore"):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    both_nan = np.isnan(a.astype(np.float64)) & np.isnan(b.astype(np.float64))
    err = float(np.max(np.where(both_nan, 0.0, d))) if d.size else 0.0
    if rtol == 0:
        ok = np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    else:
        ok = arrays_are_equal(a, b, rtol)
    return ok, err


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _fuzz_programs():
    """Five random chains covering BC kinds, input ranks and dtypes: the
    first draw (from a fixed seed sequence) that reads the scalar and
    the lower-rank input(s)."""
    from stencilflow_tpu_torch import parse_program
    from stencilflow_tpu_torch.synthesize import random_program
    variants = [
        ("f32", dict(), 3),
        ("f64-shrink", dict(data_type="float64",
                            bc_kinds=("constant", "copy", "shrink")), 3),
        ("i32", dict(data_type="int32", data="random:-20,20"), 3),
        ("f32-shrink", dict(bc_kinds=("shrink", "copy")), 3),
        ("f32-2d", dict(bc_kinds=("constant", "copy", "shrink")), 2),
    ]
    progs = []
    for label, kw, ndim in variants:
        for seed in range(1000, 2000):
            spec = random_program(np.random.default_rng(seed), ndim=ndim,
                                  **kw)
            src = " ".join(k["computation_string"]
                           for k in spec["program"].values())
            need = ["sc", "row"]
            if ndim == 3:
                need.append("ik")
            if all(n in src for n in need):
                progs.append((f"fuzz-{label}-{seed}",
                              parse_program(spec, name=f"fuzz_{label}")))
                break
        else:
            raise RuntimeError(f"no fuzz draw for {label}")
    return progs


def _mixed_spec(dims):
    """A per-cell stage feeding a wide affine stage that reads two fields
    (a rank-1 box of s0 with a constant-0.2 BC, a rank-2 cross of b), an
    (i, k) input, a scalar and a bias; then a narrow per-cell stage."""
    box = " + ".join(f"s0[i{di:+d},j{dj:+d},k{dk:+d}]"
                     for di in (-1, 0, 1) for dj in (-1, 0, 1)
                     for dk in (-1, 0, 1))
    cross = " + ".join(f"b[i{o[0]:+d},j{o[1]:+d},k{o[2]:+d}]" for o in
                       [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                        (0, -1, 0), (0, 0, 1), (0, 0, -1)])

    def bc(v):
        return {"type": "constant", "value": v}
    return {
        "inputs": {
            "a": {"data": "random:0.0,1.0", "data_type": "float32"},
            "b": {"data": "random:0.0,1.0", "data_type": "float32"},
            "ik": {"data": "random:0.0,1.0", "data_type": "float32",
                   "input_dims": ["i", "k"]},
            "sc": {"data": 0.5, "data_type": "float32", "input_dims": []}},
        "outputs": ["s2"], "dimensions": list(dims),
        "program": {
            "s0": {"computation_string":
                   "s0 = a[i,j,k] * a[i,j,k] + 0.1 * a[i,j+1,k]",
                   "boundary_conditions": {"a": bc(0.0)},
                   "data_type": "float32"},
            "s1": {"computation_string":
                   f"s1 = 0.04 * ({box}) + 0.1 * ({cross}) "
                   "+ 0.3 * ik[i,k+1] + sc + 1.0",
                   "boundary_conditions": {"s0": bc(0.2), "b": bc(0.0),
                                           "ik": bc(0.0)},
                   "data_type": "float32"},
            "s2": {"computation_string": "s2 = s1[i,j,k] * 0.5 + "
                   "s1[i-1,j+1,k]",
                   "boundary_conditions": {"s1": bc(0.0)},
                   "data_type": "float32"}}}


def _reconvergent_spec(stages=16, dims=(12, 24, 32)):
    """A deep chain whose last stage reads the first again: one ring far
    deeper than its read count."""
    prog, prev = {}, "a"
    for s in range(stages):
        expr = (f"s{s} = 0.16 * ({prev}[i-1,j,k] + {prev}[i+1,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k-1] + "
                f"{prev}[i,j,k+1])")
        fields = {prev}
        if s == stages - 1:
            expr += " + 0.1 * s0[i,j,k]"
            fields.add("s0")
        prog[f"s{s}"] = {"computation_string": expr,
                         "boundary_conditions": {
                             f: {"type": "constant", "value": 0.2}
                             for f in fields},
                         "data_type": "float32"}
        prev = f"s{s}"
    return {"inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims), "program": prog}


def _bound(program):
    """(bound ms, "bytes" or "operations") of one chain evaluation: the
    port's report (report.py, the H100 model of config.py), the memory
    floor against the faster compute strategy — one yardstick for this
    script, ``cli report`` and the bench."""
    from stencilflow_tpu_torch.report import Report
    rep = Report.build(program)
    return (rep.roofline_time_s() * 1e3,
            "bytes" if rep.bound() == "hbm" else "operations")


def _conv_chain_ms(program, radius: int, shape=None) -> float:
    """One ``F.conv3d`` (``F.conv2d`` for a 2-D program) per stage,
    chained, computing the same constant-0 linear chain with TF32 off over
    the program's domain (or ``shape``): the library yardstick (timed
    only; the port never calls it).  The stages of these chains are
    identical, so the first stage's coefficients give the filter."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    from stencilflow_tpu_torch.backend.linear import extract_linear
    stages = list(program.kernels.values())
    nd = len(program.raw_dimensions)
    w = np.zeros((1, 1) + (2 * radius + 1,) * nd, np.float32)
    for key, c in extract_linear(stages[0]).items():
        if key != ("const",):
            w[(0, 0) + tuple((o or 0) + radius
                             for o in key[1][3 - nd:])] = c
    weight = torch.as_tensor(w, device="cuda")
    x = torch.rand((1, 1) + tuple(shape or program.raw_dimensions),
                   device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    conv = F.conv3d if nd == 3 else F.conv2d

    def run():
        y = x
        for _ in stages:
            y = conv(y, weight, padding=radius)
        return y
    return _time_ms(run, 3)


def _link_rates():
    """(host-to-device, device-to-host) bytes/s of 1 GiB ``copy_``s
    between pinned host memory and the card."""
    import torch
    n = 1 << 28
    host = torch.empty(n, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    up = _time_ms(lambda: dev.copy_(host, non_blocking=True), 3)
    down = _time_ms(lambda: host.copy_(dev, non_blocking=True), 3)
    del host, dev
    torch.cuda.empty_cache()
    return 4 * n / up * 1e3, 4 * n / down * 1e3


def _chunk_slabs(program, inputs, lo: int, Ii: int):
    """One chunk's inputs on the card: i-spanning ones as host slabs of
    ``Ii`` planes from global plane ``lo`` (zero outside the domain)."""
    import torch
    from stencilflow_tpu_torch.outofcore import _host_slab
    I = program.dimensions[0]
    slabs = {}
    for n, spec in program.inputs.items():
        a = np.asarray(inputs[n])
        if spec.is_scalar:
            slabs[n] = torch.as_tensor(a)
        elif spec.dim_mask[0]:
            slabs[n] = _host_slab(a, lo, lo + Ii, I).cuda()
        else:
            slabs[n] = torch.as_tensor(a).cuda()
    return slabs


def _local_plan(program, chunks: int):
    """K4's plan of ``program`` at ``chunks`` chunks, as the out-of-core
    path chooses it (``plan_local_stream``)."""
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.parallel.domain import (DomainDecomposition,
                                                       plan_local_stream)
    an = sft.ChainAnalysis.run(program)
    I, J, K = program.dimensions
    h = chain_halo(an)[0] if chunks > 1 else 0
    got = plan_local_stream(program, an, DomainDecomposition(
        program, None, (None, None, None), (h, 0, 0), (I // chunks, J, K)))
    if got is None:
        raise RuntimeError(f"{program.name}: K4's planner refused")
    return got[0]


def _wide_i_spec(dims, stages: int):
    """A 3-D jacobi whose stages read i-offsets of 3: windows wider than a
    panel of B = 2."""
    program, prev = {}, "a"
    for n in range(stages):
        program[f"s{n}"] = {
            "computation_string":
                f"s{n} = 0.2 * ({prev}[i-3,j,k] + {prev}[i+3,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k+1])",
            "boundary_conditions": {prev: {"type": "constant",
                                           "value": 0.5}},
            "data_type": "float32"}
        prev = f"s{n}"
    return {"inputs": {"a": {"data": "random:0.0,1.0",
                             "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims),
            "program": program}


def _fuzz_chunked(cases):
    """(label, program, chunks): the 3-D fuzz chain of phase 3 drawn again
    at (48, 20, 24), with the most chunks (of 4, 3, 2) its i-halo allows."""
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.synthesize import random_program
    label = next(lb for lb, _p in cases
                 if lb.rsplit("-", 1)[0] == "fuzz-f32")
    spec = random_program(np.random.default_rng(int(label.rsplit("-", 1)[1])),
                          ndim=3)
    spec["dimensions"] = [48, 20, 24]
    p = sft.parse_program(spec, name="fuzz_f32_chunked")
    h = chain_halo(sft.ChainAnalysis.run(p))[0]
    chunks = next(c for c in (4, 3, 2) if h < 48 // c)
    return f"{label.rsplit('-', 1)[0]}-48", p, chunks


def _outofcore(sft, st, pn, ov, gp, oc_cells, oc_plans, lib_of, smi,
               run_program):
    """Phase 5: K4 alone on one jacobi chunk, then each out-of-core cell
    against the in-core route.  Returns K4's entry of the kernels line."""
    import torch
    from stencilflow_tpu_torch import outofcore
    from stencilflow_tpu_torch.report import Report
    up_rate, down_rate = _link_rates()
    print(f"link: pinned host-to-device {up_rate / 1e9:.2f} GB/s, "
          f"device-to-host {down_rate / 1e9:.2f} GB/s (1 GiB copy_) | {smi}",
          flush=True)

    # K4 alone at the main path's shapes: the middle chunk of jacobi 1024^3
    p, chunks = oc_cells[0]
    plan = oc_plans[p.name]
    lib = lib_of[st.stream_source(plan)]
    _, J, K = p.dimensions
    c = chunks // 2
    lo = c * plan.block - plan.halo_i
    inputs = sft.load_input_arrays(p, seed=0)
    slabs = _chunk_slabs(p, inputs, lo, plan.extent())
    del inputs
    got = st.run_local_stream(plan, lo, slabs, lib)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    want = st.local_stream_plain(plan, lo, slabs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                       want[p.outputs[0]].cpu().numpy(), 0.0)
    del got, want
    ms = _time_ms(lambda: st.run_local_stream(plan, lo, slabs, lib), 10)
    chunk_bytes = sum(t.numel() * t.element_size() for n, t in slabs.items()
                      if not p.inputs[n].is_scalar)
    chunk_bytes += sum(plan.block * J * K * np.dtype(p.kernels[o].dtype)
                       .itemsize for o in p.outputs)
    rep = Report.build(p)
    t_bytes = chunk_bytes / rep.hw.hbm_bandwidth * 1e3
    t_ops = rep.alu_time_s() * plan.block / p.dimensions[0] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    del slabs
    torch.cuda.empty_cache()
    lib_ms = _conv_chain_ms(p, 1, shape=(plan.extent(), J, K))
    torch.cuda.empty_cache()
    print(f"kernel: local_stream {p.name} chunk {c} of {chunks} "
          f"({plan.extent()} planes in, {plan.block} out) tile {plan.tile} "
          f"x {plan.threads} threads, smem {plan.smem_bytes()} B packed "
          f"(unpacked {plan.unpacked_bytes()}), {pn.occupancy(lib)} blocks "
          f"per SM, {plan.evaluations():.2f} evaluations a cell, passes "
          f"{_routes(plan) or 'none (per cell)'}: {ms:.3f} ms per chunk, plain "
          f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}),"
          f" {len(p.kernels)} chained F.conv3d over the widened chunk "
          f"{lib_ms:.3f} ms, max_abs_err {err:.3g} "
          f"{'OK' if ok else 'MISMATCH'} | {smi}", flush=True)
    if not ok:
        raise RuntimeError("local stream kernel disagrees with its plain "
                           f"version on {p.name}")
    entry = {"name": "local_stream", "route": "cuda",
             "source": "stencilflow_tpu_torch/backend/codegen.py",
             "replaces": "stencilflow_tpu/backend/stream.py:1735",
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}

    reps = 2
    for p, chunks in oc_cells:
        res = run_program(p, device="cuda", repetitions=reps,
                          save_results=False, log_level=0)
        if res.backend != "panel":
            raise RuntimeError(f"{p.name}: in-core backend {res.backend}, "
                               "expected panel")
        in_core, in_ms = res.outputs, res.wall_time_s * 1e3
        del res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pn.launches = ov.launches = st.launches = gp.launches = 0
        st.local_launches = 0
        oc = run_program(p, device="cuda", host_chunks=chunks,
                         repetitions=reps, save_results=False, log_level=0)
        n = st.local_launches
        other = pn.launches + ov.launches + st.launches + gp.launches
        peak = torch.cuda.max_memory_allocated()
        stats = oc.host_staging
        label = f"outofcore[stream x{chunks} chunks]"
        if oc.backend != label:
            raise RuntimeError(f"{p.name}: backend {oc.backend}, expected "
                               f"{label}")
        if n != chunks * (reps + 1) or other:
            raise RuntimeError(f"{p.name}: K4 launched {n} times over "
                               f"{reps + 1} calls of {chunks} chunks "
                               f"(other kernels {other})")
        for o in p.outputs:
            if not np.array_equal(oc.outputs[o], in_core[o]):
                raise RuntimeError(f"{p.name}: out-of-core output {o} "
                                   "differs from the in-core route")
        up, down = outofcore.link_bytes(p, outofcore.ChunkPlan(
            chunks, oc_plans[p.name].block, oc_plans[p.name].halo_i,
            "stream", {}))
        duplex = max(up / up_rate, down / down_rate) * 1e3
        serial = (up / up_rate + down / down_rate) * 1e3
        io = Report.build(p).hbm_footprint_bytes()
        cells = p.total_elements
        print(f"outofcore: {p.name} {oc.backend} {oc.wall_time_s * 1e3:.3f} "
              f"ms per call (CUDA events over {reps} calls, transfers "
              f"included; {cells / oc.wall_time_s / 1e9:.2f} GCell/s) | "
              f"in-core panel {in_ms:.3f} ms (transfers excluded) | equal "
              f"to in-core | K4 launches {n} over {reps + 1} calls | link "
              f"{up / 2 ** 30:.3f} GiB up + {down / 2 ** 30:.3f} GiB down, "
              f"bound {duplex:.3f} ms both ways at once, {serial:.3f} ms "
              f"one after the other | host slab fill "
              f"{stats['fill_s'] * 1e3:.1f} ms, drain "
              f"{stats['drain_s'] * 1e3:.1f} ms (last call) | device peak "
              f"{peak / 2 ** 30:.3f} GiB, in-core in+out "
              f"{io / 2 ** 30:.3f} GiB | {smi}", flush=True)
        if p is oc_cells[0][0] and peak >= io / 3:
            raise RuntimeError(f"{p.name}: device peak {peak} B is not "
                               f"below a third of {io} B")
        entry["launches"] += n
        del oc, in_core
        torch.cuda.empty_cache()
    return entry


def _measurement(pn, smi):
    """Phase 6: the probes P4, P1 and P7 against their plain versions,
    then the measurement path with the counts reset (the probes' entry
    points, and one bench session whose fractions of every bound must be
    at most 1).  Returns the probes' entries of the kernels line."""
    import contextlib
    import io
    import torch
    from stencilflow_tpu_torch import bench
    from stencilflow_tpu_torch.probes import alu_ceiling as pa
    from stencilflow_tpu_torch.probes import copy_floor as pc
    from stencilflow_tpu_torch.probes import differenced_ms
    from stencilflow_tpu_torch.probes import loop_copy as pl
    from stencilflow_tpu_torch.report import HardwareModel
    hw = HardwareModel()
    entry = dict(route="cuda", launches=0, library_ms=None)

    # P4 at 512 x 512^2 (512 MiB each way), beside copy_
    x = torch.rand(pc.BIG, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    y = pc.copy(x, torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    if not torch.equal(x, y):
        raise RuntimeError("the copy kernel's output differs from its input")
    p4 = dict(entry, name="copy_floor",
              source="stencilflow_tpu_torch/csrc/probes/copy.cu",
              replaces="scripts/dma_matrix_probe.py:36",
              max_abs_err=float((y - x).abs().max()),
              ms=_time_ms(lambda: pc.copy(x, y), 10),
              plain_ms=_time_ms(lambda: pc.copy_plain(x), 3),
              library_ms=_time_ms(lambda: y.copy_(x), 10),
              bound_ms=8 * x.numel() / hw.hbm_bandwidth * 1e3,
              bound_by="bytes")
    print(f"kernel: copy_floor {tuple(x.shape)} {pc.DEFAULT}: "
          f"{p4['ms']:.4f} ms ({8 * x.numel() / p4['ms'] / 1e6:.1f} GB/s), "
          f"plain version {p4['plain_ms']:.4f} ms, copy_ "
          f"{p4['library_ms']:.4f} ms, bound {p4['bound_ms']:.4f} ms "
          f"(bytes), bit-equal OK | {smi}", flush=True)
    del x, y
    torch.cuda.empty_cache()

    # P1: every op at 8 steps against its plain version on the card
    xa = pa.inputs(pa.elements(), "cuda")
    worst = 0.0
    for op, smem in [(op, False) for op in pa.OPS] + [("add", True)]:
        got = pa.alu(op, xa, 8, smem=smem)
        torch.cuda.synchronize()
        ok, err = pa.compare(op, got, pa.alu_plain(op, xa, 8))
        if not ok:
            raise RuntimeError(f"alu kernel ({op}{', smem' if smem else ''})"
                               f" disagrees with its plain version: max "
                               f"abs diff {err:.3g}")
        worst = max(worst, err)
    steps = 64
    t_plain = time.perf_counter()
    pa.alu_plain("add", xa, steps)
    torch.cuda.synchronize()
    p1 = dict(entry, name="alu_ceiling",
              source="stencilflow_tpu_torch/csrc/probes/alu.cu",
              replaces="scripts/vpu_ceiling.py:240", max_abs_err=worst,
              ms=_time_ms(lambda: pa.alu("add", xa, steps), 10),
              plain_ms=(time.perf_counter() - t_plain) * 1e3,
              bound_ms=xa.numel() * pa.UNROLL * steps / hw.alu_ops * 1e3,
              bound_by="operations")
    print(f"compare: alu {len(pa.OPS)} ops and the shared-memory add at 8 "
          f"steps: max_abs_err {worst:.3g} OK | kernel: alu_ceiling add "
          f"{xa.numel()} x {pa.UNROLL} x {steps}: {p1['ms']:.4f} ms, plain "
          f"version {p1['plain_ms']:.1f} ms, bound {p1['bound_ms']:.4f} ms "
          f"(operations) | {smi}", flush=True)

    # the measurement path, each probe with its count reset just before it
    # and read just after; P7 launches P4's kernel, so its launches are
    # P4's count over P7's run.  Graph-timed probes count the warm-up and
    # each capture's recorded launches; the replays re-run those without
    # passing through a wrapper and are not counted.
    counted = "eager launches and graph captures; replays not counted"
    pc.launches = 0
    copy_rows = pc.measure([c for c in pc.CASES if c[1] == pc.BIG
                            and c[0] in ("flat f4 256t 8/SM",
                                         "tile f4 256t 4 rows")], trials=3)
    p4.update(launches=pc.launches, launches_counted=counted)
    pa.launches = 0
    alu_rows = pa.measure(("add", "fma", "fma_fused"), trials=3)
    p1["launches"] = pa.launches
    pc.launches = 0
    loops = pl.measure(unrolls=(1, 2), trials=3)
    p7_launches = pc.launches
    pn.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--workload", "jacobi", "--sessions", "1"])
    bench_launches = pn.launches
    line = out.getvalue().strip().splitlines()[-1]
    print(f"bench: {line}", flush=True)
    rec = json.loads(line)
    fractions = dict(rec["bounds"], vs_baseline=rec["vs_baseline"])
    if not all(0 < v <= 1.0 for v in fractions.values()):
        raise RuntimeError(f"a bound fraction outside (0, 1]: {fractions}")
    counts = {"copy_floor": p4["launches"], "alu_ceiling": p1["launches"],
              "loop_copy": p7_launches, "panel (bench)": bench_launches}
    if min(counts.values()) < 1:
        raise RuntimeError(f"the measurement path skipped a kernel: "
                           f"{counts}")
    for r in copy_rows:
        print(f"probe: P4 {r['case']} {r['ms']:.4f} ms {r['gb_s']:.1f} GB/s "
              f"| {smi}", flush=True)
    for r in alu_rows:
        print(f"probe: P1 {r['op']} {r['ops_per_s'] / 1e12:.3f} Top/s "
              f"({r['vs_add']:.2f} x add) | {smi}", flush=True)
    for r in loops["cases"]:
        print(f"probe: P7 planes {r['planes']} U={r['unroll']} {r['mode']} "
              f"{r['ms'] * 1e3:.3f} us per application, max_abs_err "
              f"{r['max_abs_err']:.3g} | {smi}", flush=True)
    print(f"probe: P7 host cost of one eager launch "
          f"{loops['host_us_per_launch']:.2f} us | launches {counts} "
          f"({counted})", flush=True)

    # P7 at its main shape: 512 planes, two applications per iteration,
    # eager; its plain version (a new tensor per application) and copy_
    # between the same ping-pong buffers, timed the same way
    eager = next(r for r in loops["cases"] if r["planes"] == 512
                 and r["unroll"] == 2 and r["mode"] == "eager")
    a = torch.rand(pc.BIG, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    b = torch.empty_like(a)
    plain_ms = differenced_ms(lambda n: pl.loop_plain(a, n, 2), 2, 10,
                              3) / 2
    library_ms = differenced_ms(
        lambda n: pl.loop(a, b, n, 2, body=lambda s, d: d.copy_(s)), 2, 10,
        3) / 2
    p7 = dict(entry, name="loop_copy",
              source="stencilflow_tpu_torch/probes/loop_copy.py",
              replaces="scripts/loop_copy_probe.py:37",
              launches=p7_launches, launches_counted=counted,
              max_abs_err=max(r["max_abs_err"] for r in loops["cases"]),
              ms=eager["ms"], plain_ms=plain_ms, library_ms=library_ms,
              bound_ms=8 * a.numel() / hw.hbm_bandwidth * 1e3,
              bound_by="bytes")
    print(f"kernel: loop_copy {tuple(a.shape)} U=2 eager: {p7['ms']:.4f} "
          f"ms per application, plain version {plain_ms:.4f} ms, copy_ "
          f"{library_ms:.4f} ms, bound {p7['bound_ms']:.4f} ms (bytes), "
          f"max_abs_err {p7['max_abs_err']:.3g} | {smi}", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return {"copy_floor": p4, "alu_ceiling": p1, "loop_copy": p7}


def _solver_setup(sft, jacobi8):
    """The solvers phase's programs (phase 7), and one thunk per lowering
    it compiles: phase 2 runs them beside its other builds, so that every
    composed and adjoint program's kernel is built in parallel."""
    from stencilflow_tpu_torch import solver_cells as sc
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.grad import adjoint_program
    from stencilflow_tpu_torch.iterate import compose_iterations
    from stencilflow_tpu_torch.outofcore import compile_chunked_chain
    from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
    progs = {
        "jacobi512": sft.parse_program(jacobi(3, 512, 1),
                                       name="jacobi3d_512"),
        "jacobi1024": sft.parse_program(jacobi(3, 1024, 1),
                                        name="jacobi3d_1024"),
        "gray_scott": sc.gray_scott(8192),
        "grad": jacobi8,
        "grad_copy": sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape="diffusion",
            boundary="copy", seed_data="random:0.0,1.0"),
            name="jacobi3d_256_8itr_copy"),
        "diffusion": sc.implicit_diffusion(512),
        "upwind": sc.upwind(512),
    }
    fused1024 = compose_iterations(progs["jacobi1024"], 8)
    in_core = [compose_iterations(progs["jacobi512"], 8),
               progs["jacobi512"], fused1024,
               compose_iterations(progs["gray_scott"], 4,
                                  sc.GRAY_SCOTT_FEED),
               progs["gray_scott"], adjoint_program(jacobi8)[0],
               progs["grad_copy"], adjoint_program(progs["grad_copy"])[0],
               progs["diffusion"], progs["upwind"],
               adjoint_program(progs["upwind"], wrt=["x"])[0]]
    thunks = [lambda p=p: compile_chain_best(p, device="cuda")
              for p in in_core]
    thunks += [lambda: compile_chunked_chain(fused1024, 8, device="cuda"),
               lambda: compile_chunked_chain(progs["diffusion"], 4,
                                             device="cuda")]
    return progs, thunks


def _device_random(shape, seed: int) -> np.ndarray:
    """Uniform [0, 1) float32 host data drawn on the card (fast at 1024^3)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda").cpu().numpy()


def _eager(step, inputs, n: int):
    """``n`` eager steps of ``step`` from host ``inputs``; host arrays."""
    import torch
    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in inputs.items()}
    for _ in range(n):
        state = step(state)
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in state.items()}


def _replay_ms(program, inputs, fuse: int, n: int, feed=None) -> float:
    """ms per original step of one replay of the graph of ``n`` fused
    steps, as ``iterate`` captures it (CUDA events, after the capturing
    replay)."""
    import torch
    from stencilflow_tpu_torch.iterate import (GraphLoop, compose_iterations,
                                               make_step)
    if fuse > 1:
        program = compose_iterations(program, fuse, feed)
    step, feed = make_step(program, feed, device="cuda")
    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in inputs.items()}
    loop = GraphLoop(step, state, feed, torch.device("cuda"))
    ms = _time_ms(lambda: loop.run(n), 1)
    del loop, state
    torch.cuda.empty_cache()
    return ms / (n * fuse)


def _solvers(sft, progs, smi, k1_ms: float):
    """Phase 7: the solver entry points at full width, each against its
    reference (module docstring), with the kernels' counts reset just
    before and read just after.  Returns the counts."""
    import torch
    from stencilflow_tpu_torch import solver_cells as sc
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    from stencilflow_tpu_torch.iterate import make_step
    pn.launches = ov.launches = gp.launches = 0
    st.launches = st.local_launches = st.spill_launches = 0

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"solvers: {what}")

    # iterate on jacobi3d 512^3, 64 steps: fused by 8 (K1) and one step a
    # stage (K2), bit for bit with each other and with dense stepping
    j = progs["jacobi512"]
    inputs = {"a": _device_random((512,) * 3, 0)}
    got, ms, route = {}, {}, {}
    for fuse in (8, 1):
        stats = {}
        got[fuse] = sft.iterate(j, inputs, 64, fuse=fuse, stats=stats)["a"]
        route[fuse] = stats["backend"]
        ms[fuse] = _replay_ms(j, inputs, fuse, 64 // fuse)
    dense = _eager(make_step(j, backend="dense")[0], inputs, 64)["a"]
    equal = (np.array_equal(got[8], got[1]),
             np.array_equal(got[1], dense))
    print(f"solvers: iterate {j.name} x 64 steps: fuse 8 {route[8]} "
          f"{ms[8]:.4f} ms a step, fuse 1 {route[1]} {ms[1]:.4f} ms a step "
          f"(graph replays; K1's one-shot 8 stages {k1_ms / 8:.4f} ms a "
          f"stage); fuse 8 == fuse 1: {equal[0]}, == dense x 64: "
          f"{equal[1]} | {smi}", flush=True)
    check(all(equal), "iterate fuse 8 / fuse 1 / dense differ")
    del got, dense, inputs
    torch.cuda.empty_cache()

    # Gray-Scott 8192^2, two fields fed, copy BCs: fused by 4 against one
    # step a chain and dense stepping, 16 steps
    gs, feed = progs["gray_scott"], sc.GRAY_SCOTT_FEED
    inputs = sft.load_input_arrays(gs)
    stats = {}
    fused = sft.iterate(gs, inputs, 16, feed=feed, fuse=4, stats=stats)
    one_stats = {}
    one = sft.iterate(gs, inputs, 16, feed=feed, fuse=1, stats=one_stats)
    dense = _eager(make_step(gs, feed, backend="dense")[0], inputs, 16)
    equal = all(np.array_equal(fused[k], one[k]) and
                np.array_equal(one[k], dense[k]) for k in feed)
    finite = all(np.isfinite(fused[k]).all() for k in feed)
    ms4 = _replay_ms(gs, inputs, 4, 4, feed)
    ms1 = _replay_ms(gs, inputs, 1, 16, feed)
    print(f"solvers: iterate gray_scott 8192^2 x 16 steps: fuse 4 "
          f"{stats['backend']} {ms4:.4f} ms a step, fuse 1 "
          f"{one_stats['backend']} {ms1:.4f} ms a step; bit-equal across "
          f"fuse and to dense: {equal}, finite: {finite} | {smi}",
          flush=True)
    check(equal and finite, "gray-scott fuse 4 / fuse 1 / dense differ")
    gs_route = stats["backend"]
    del fused, one, dense, inputs
    torch.cuda.empty_cache()

    # out of core: jacobi3d 1024^3 fused by 8, 16 steps at 8 chunks (K4)
    # against in-core iterate (K1)
    j = progs["jacobi1024"]
    inputs = {"a": _device_random((1024,) * 3, 1)}
    oc_stats, ic_stats = {}, {}
    t0 = time.perf_counter()
    oc = sft.iterate(j, inputs, 16, fuse=8, host_chunks=8,
                     stats=oc_stats)["a"]
    oc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ic = sft.iterate(j, inputs, 16, fuse=8, stats=ic_stats)["a"]
    ic_s = time.perf_counter() - t0
    equal = np.array_equal(oc, ic)
    print(f"solvers: iterate {j.name} x 16 steps, fuse 8: "
          f"{oc_stats['backend']} {oc_s:.2f} s against in-core "
          f"{ic_stats['backend']} {ic_s:.2f} s (host clock, transfers and "
          f"set-up included); bit-equal: {equal} | {smi}", flush=True)
    check(equal, "out-of-core iterate differs from in-core")
    del oc, ic, inputs
    torch.cuda.empty_cache()

    # gradients: the bench's chain (512^3 x 8) through the kernels, the
    # gradient against dense of the adjoint program on the same cotangent
    for key in ("grad", "grad_copy"):
        p = progs[key]
        inputs = {n: torch.as_tensor(v).cuda() for n, v in
                  sft.load_input_arrays(p, seed=0).items()}
        torch.cuda.reset_peak_memory_stats()
        f = sft.fast_value_and_grad(p)
        val, grads = f(inputs)
        fast_ms = _time_ms(lambda: f(inputs), 3)
        fast_peak = torch.cuda.max_memory_allocated()
        adj, cot = sft.adjoint_program(p)
        adj_in = {n: torch.as_tensor(np.asarray(v)).cuda()
                  for n, v in sft.load_input_arrays(adj).items()}
        want = compile_chain(adj)(adj_in)["adj_a"].reshape(grads["a"].shape)
        equal = torch.equal(grads["a"], want)
        del adj_in, want
        line = (f"solvers: fast_value_and_grad {p.name}: forward "
                f"{f.lowering['forward']}, adjoint {f.lowering['adjoint']} "
                f"({len(adj.inputs) - 1} 1-D indicator inputs), "
                f"{fast_ms:.3f} ms a call, peak {fast_peak / 2 ** 30:.2f} "
                f"GiB; gradient == dense of the adjoint: {equal}")
        check(equal, f"{p.name}: fast gradient differs from dense of the "
                     "adjoint")
        # dense autodiff (value_and_grad) beside, with its peak memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = sft.value_and_grad(p)
        dval, dgrads = g(inputs)
        dense_ms = _time_ms(lambda: g(inputs), 1)
        dense_peak = torch.cuda.max_memory_allocated()
        close = sft.arrays_are_equal(dgrads["a"].cpu().numpy(),
                                     grads["a"].cpu().numpy(),
                                     VERIFY_RTOL) and \
            abs(float(dval) - float(val)) <= \
            VERIFY_RTOL * abs(float(dval))
        line += (f" | value_and_grad (dense autodiff) {dense_ms:.3f} ms "
                 f"a call ({dense_ms / fast_ms:.1f}x), peak "
                 f"{dense_peak / 2 ** 30:.2f} GiB; within VERIFY_RTOL: "
                 f"{close}")
        check(close, f"{p.name}: value_and_grad differs from the fast "
                     "gradient")
        del dgrads, g
        print(line + f" | {smi}", flush=True)
        del f, grads, inputs
        torch.cuda.empty_cache()

    # CG and CGNR at 512^3: iterations, true residual, ms an iteration
    # split into the operator and the vector passes; then CG out of core
    rhs = _device_random((512,) * 3, 2)
    rhs_dev = torch.as_tensor(rhs).cuda()
    tol = 1e-6
    x_in = None
    for key, method in (("diffusion", "cg"), ("upwind", "cgnr")):
        solver = sft.make_solver(progs[key], method=method, tol=tol,
                                 maxiter=3000)
        solver(rhs_dev)   # first use (cuBLAS, the caching allocator)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        x, info = solver(rhs_dev)
        stop.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(stop)
        op_ms = _time_ms(lambda: solver.operator(x), 5)
        per = total / max(info["iterations"], 1)
        print(f"solvers: {method} {progs[key].name}: "
              f"{solver.lowering}, {info['iterations']} iterations, true "
              f"relative residual {info['residual']:.3e} (tol {tol}), "
              f"{per:.3f} ms an iteration: operator {op_ms:.3f}, vector "
              f"passes {per - op_ms:.3f} | {smi}", flush=True)
        check(info["residual"] <= tol * 100,
              f"{method} residual {info['residual']} above tol * 100")
        if key == "diffusion":
            x_in = x.cpu().numpy()
        del solver, x
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x_oc, info = sft.make_solver(progs["diffusion"], tol=tol,
                                 host_chunks=4)(rhs)
    oc_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(x_oc - x_in) / np.linalg.norm(x_in))
    print(f"solvers: cg {progs['diffusion'].name} at 4 host chunks: "
          f"{info['iterations']} iterations, residual "
          f"{info['residual']:.3e}, {oc_s:.2f} s (host clock); relative "
          f"distance to the in-core x {rel:.3e} (limit {10 * tol}) | {smi}",
          flush=True)
    check(rel <= 10 * tol, "out-of-core CG differs from in-core")

    counts = {"panel": pn.launches, "overlap": ov.launches,
              "group": gp.launches, "local_stream": st.local_launches,
              "stream": st.launches, "stream_spill": st.spill_launches}
    print(f"solvers: launches {counts} (warm-up and capture launches; a "
          f"graph replay re-runs its captured launches without the "
          f"wrappers) | {smi}", flush=True)
    need = ["panel", "overlap", "local_stream"]
    if gs_route == "rows+group_g8":
        need.append("group")
    for name in need:
        check(counts[name] > 0, f"the solver paths never launched {name}")
    return counts


def _mixed_dtype_spec(dims):
    """A chain with a dtype per kernel (float32 / float64 / int32 / int16
    / bool; edges carry the producer's dtype), drawn as
    ``tests/test_fuzz.py::make_mixed_dtype_program`` draws (the port's
    ``random_program`` types every field alike): the first draw from
    seed 0 up with an int32, a bool and a floating stage whose C++
    simulator core is generated, at ``dims``."""
    from stencilflow_tpu_torch import ChainAnalysis, parse_program
    from stencilflow_tpu_torch.sim.native import (NativeBuildError,
                                                  generate_cpp)
    from stencilflow_tpu_torch.synthesize import _offset_str
    for seed in range(200):
        rng = np.random.default_rng(seed)
        for _ in range(3):   # the generator's dims, replaced by ``dims``
            rng.integers(4, 8)

        def acc(field):
            offs = [int(rng.integers(-1, 2)) for _ in range(3)]
            return field + _offset_str(["i", "j", "k"], offs)

        def fconst():
            return f"{float(rng.uniform(-2, 2))!r}"
        avail = [("a", "float32"), ("n", "int32")]
        prog = {}
        for s in range(int(rng.integers(3, 6))):
            name = f"s{s}"
            dt = str(rng.choice(["float32", "float64", "int32", "int16",
                                 "bool"]))
            (x, xdt), (y, ydt) = picks = [
                avail[-1], avail[int(rng.integers(0, len(avail)))]]

            def term(f, fdt):
                a = acc(f)
                if fdt == "bool":
                    return f"({a} * {int(rng.integers(1, 4))})"
                return a
            if dt == "bool":
                expr = f"({term(x, xdt)} > {term(y, ydt)})"
            elif dt.startswith("int"):
                expr = (f"({term(x, xdt)} * {int(rng.integers(1, 4))} "
                        f"- {term(y, ydt)} + {int(rng.integers(-5, 8))})")
                if rng.random() < 0.4:
                    expr = f"min({expr}, {term(x, xdt)})"
                if rng.random() < 0.3:
                    expr = f"abs({expr})"
            else:
                expr = f"({term(x, xdt)} * {fconst()} + {term(y, ydt)})"
                if rng.random() < 0.4:
                    expr = (f"({expr} if {term(x, xdt)} > {fconst()} "
                            f"else {term(y, ydt)})")
            bcs = {}
            for f, fdt in dict(picks).items():
                if fdt == "bool":
                    bcs[f] = {"type": "constant", "value": 0}
                elif fdt.startswith("int"):
                    bcs[f] = {"type": "constant",
                              "value": int(rng.integers(0, 5))}
                else:
                    bcs[f] = {"type": str(rng.choice(["constant", "copy"])),
                              "value": float(round(rng.uniform(-1, 1) * 64)
                                             / 64)}
            prog[name] = {"computation_string": f"{name} = {expr}",
                          "boundary_conditions": bcs, "data_type": dt}
            avail.append((name, dt))
        kinds = {dt for _, dt in avail[2:]}
        if not ({"int32", "bool"} <= kinds
                and kinds & {"float32", "float64"}):
            continue
        spec = {"inputs": {"a": {"data": "random:-1,1",
                                 "data_type": "float32"},
                           "n": {"data": "random:1,40",
                                 "data_type": "int32"}},
                "outputs": [avail[-1][0]], "dimensions": list(dims),
                "program": prog}
        p = parse_program(spec, name=f"mixed_dtype_{seed}")
        try:
            generate_cpp(p, ChainAnalysis.run(p))
        except NativeBuildError:
            continue
        return p
    raise RuntimeError("no mixed-dtype draw the simulator core runs")


def _simulator(sft, run_program, jacobi8, smi):
    """Phase 8: ``run --run-simulation`` through the main-path kernels.
    ``cli simulate --trace-chrome`` on a 16^3 program starts first, in a
    subprocess; each leg's native simulator core and kernel are built
    (g++ and nvcc, all at once, on threads); then each leg runs
    ``run_program(..., run_simulation=True, compare_to_reference=True)``:
    the jacobi3d 512^3 leg on one thread, the others in turn on another
    (the simulator and the oracle run on the host and release the GIL),
    with the kernels' counts reset just before the legs and read just
    after."""
    import tempfile

    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    t_phase = time.perf_counter()

    # cli simulate --trace-chrome on 16^3 (the host), beside the legs
    with tempfile.TemporaryDirectory() as tmp:
        prog = os.path.join(tmp, "prog.json")
        trace = os.path.join(tmp, "trace.json")
        with open(prog, "w") as f:
            json.dump(synthesize_stencil(
                num_stages=2, dimensions=(16,) * 3, shape="diffusion",
                seed_data="random:0.0,1.0"), f)
        cli = subprocess.Popen(
            [sys.executable, "-m", "stencilflow_tpu_torch.cli", "simulate",
             prog, "--trace-chrome", trace], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _simulator_legs(sft, run_program, jacobi8, smi, t_phase)
            out, err = cli.communicate(timeout=300)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
        if cli.returncode != 0 or not os.path.isfile(trace) \
                or os.path.getsize(trace) == 0:
            raise RuntimeError(f"simulator: cli simulate exited "
                               f"{cli.returncode}: {err[-2000:]}")
        events = json.load(open(trace))["traceEvents"]
    if not any(e["ph"] == "X" for e in events):
        raise RuntimeError("simulator: the chrome trace has no spans")
    cycles = next(ln for ln in out.splitlines() if ln.startswith("cycles: "))
    print(f"simulate: cli simulate 16^3 --trace-chrome: {cycles}, "
          f"{len(events)} events (a subprocess beside the legs)",
          flush=True)
    print(f"simulate: phase 8 took {time.perf_counter() - t_phase:.1f} s "
          f"| {smi}", flush=True)


def _simulator_legs(sft, run_program, jacobi8, smi, t_phase):
    """Phase 8's legs (``_simulator``)."""
    from concurrent.futures import ThreadPoolExecutor

    import stencilflow_tpu_torch.sim as simmod
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend import tile as tl
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    from stencilflow_tpu_torch.sim.native import NativeSimulator
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    def synth(shape, dims, stages, extent=1):
        return sft.parse_program(synthesize_stencil(
            num_stages=stages, dimensions=dims, shape=shape, extent=extent,
            seed_data="random:0.0,1.0"),
            name=f"{shape}{len(dims)}d_{dims[0]}_{stages}itr")
    # (program, the route it must take; None: any, printed)
    legs = [(jacobi8, "panel"),
            (synth("diffusion", (256,) * 3, 2), "overlap"),
            (synth("hotspot", (4096, 4096), 8), "rows+group_g8"),
            (synth("box", (128,) * 3, 8, extent=2), "stream"),
            (_mixed_dtype_spec((48, 48, 48)), None)]

    def build_core(p):
        t0 = time.perf_counter()
        NativeSimulator(p)   # a NativeBuildError fails the phase
        return time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=2 * len(legs)) as ex:
        cores = [ex.submit(build_core, p) for p, _ in legs]
        kernels = [ex.submit(compile_chain_best, p, device="cuda")
                   for p, _ in legs]
        gxx_s = {p.name: f.result() for (p, _), f in zip(legs, cores)}
        for f in kernels:
            f.result()
    print(f"simulate: {len(legs)} native cores (g++) and kernels (nvcc) "
          f"built at once in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # time each simulation inside run_program and keep its result
    real, seen = simmod.simulate, {}

    def timed(program, inputs, **kw):
        t0 = time.perf_counter()
        res = real(program, inputs, **kw)
        seen[program.name] = (time.perf_counter() - t0, res)
        return res

    def leg(p, want):
        t0 = time.perf_counter()
        res = run_program(p, device="cuda", run_simulation=True,
                          compare_to_reference=True, save_results=False,
                          log_level=0)
        leg_s = time.perf_counter() - t0
        if want is not None and res.backend != want:
            raise RuntimeError(f"simulator: {p.name} took {res.backend}, "
                               f"expected {want}")
        if not (res.verified_against_simulation is True
                and res.verified_against_reference is True):
            raise RuntimeError(f"simulator: {p.name} not verified")
        sim_s, sim = seen.pop(p.name)
        banded = res.backend == "stream" and bool(st.plan_stream(p).tkeys)
        for o in p.outputs:
            if banded:
                ok = sft.arrays_are_equal(sim.outputs[o], res.outputs[o],
                                          MXU_VERIFY_RTOL)
            else:   # per-cell kernels and the mixed chain: bit-equal
                ok = np.array_equal(res.outputs[o], sim.outputs[o])
            if not ok or res.outputs[o].shape != tuple(p.raw_dimensions):
                raise RuntimeError(f"simulator: {p.name} {o} disagrees with "
                                   "the simulator")
        print(f"simulate: {p.name} route {res.backend} cycles "
              f"{res.simulation_cycles} elements {p.total_elements} | "
              f"simulator {sim_s:.2f} s on the host "
              f"({res.simulation_cycles / sim_s / 1e6:.2f} Mcycles/s), "
              f"g++ {gxx_s[p.name]:.2f} s (in parallel) | kernel "
              f"{res.wall_time_s * 1e3:.3f} ms | "
              f"{'within MXU_VERIFY_RTOL of' if banded else 'equal to'} "
              f"the simulator, oracle OK | leg {leg_s:.1f} s | {smi}",
              flush=True)
        return res.backend

    simmod.simulate = timed
    pn.launches = ov.launches = gp.launches = tl.launches = 0
    st.launches = st.local_launches = st.spill_launches = 0
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            big = ex.submit(leg, *legs[0])
            rest = ex.submit(lambda: [leg(*lg) for lg in legs[1:]])
            routes = [big.result()] + rest.result()
    finally:
        simmod.simulate = real
    counts = {"panel": pn.launches, "overlap": ov.launches,
              "stream": st.launches, "rows+group_g8": gp.launches,
              "tile": tl.launches}
    print(f"simulate: launches {counts} over the legs", flush=True)
    for route in routes:
        if counts.get(route, 0) < 1:
            raise RuntimeError(f"simulator: the legs never launched the "
                               f"{route} kernel ({counts})")


def _design_probes(ov, smi):
    """Phase 6, continued: P6, P3, P2 and P5 against their plain versions
    at a ragged and at the main shape (bit-exact; P6's out and acc, P3's
    ring == direct == plain for every S, P2 in every variant, P5 in every
    walk), P5 beside K2 on the shared program, then one timed case per
    probe, each with its count reset just before and read just after.
    Returns their entries of the kernels line."""
    import torch
    from stencilflow_tpu_torch.probes import async_ring as ar
    from stencilflow_tpu_torch.probes import dma_overlap as do
    from stencilflow_tpu_torch.probes import pingpong_ms, roofline
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    from stencilflow_tpu_torch.probes import table_read as tr
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(shape):
        return torch.rand(shape, device="cuda", generator=gen) * 0.5 + 0.5

    worst = {}

    def same(probe, label, got, want):
        err = float((got - want).abs().max())
        worst[probe] = max(worst.get(probe, 0.0), err)
        if not torch.equal(got, want):
            raise RuntimeError(f"{label} disagrees with its plain version: "
                               f"max abs diff {err:.3g}")

    # P6 and P3: ragged (float4 and scalar units) and main shapes
    for shape in ((45, 37, 200), (13, 19, 37), do.MAIN):
        x = rand(shape)
        for mode in do.MODES:
            want, want_acc = do.overlap_plain(x, mode, 16)
            for bps in (1, 2, 0):
                out, acc = do.overlap(x, mode, 16, blocks_per_sm=bps)
                torch.cuda.synchronize()
                same("dma_overlap", f"dma_overlap {mode}-16 {shape} "
                     f"{bps}/SM", out, want)
                if mode == "indep":
                    same("dma_overlap", f"dma_overlap indep acc {shape}",
                         acc, want_acc)
        want = ar.ring_plain(x, 16)
        for mode, slots in ar.cases():
            for bps in (1, 2, 0):
                got = ar.ring(x, 16, mode, slots, blocks_per_sm=bps)
                torch.cuda.synchronize()
                same("async_ring", f"async_ring {mode} S={slots} {shape} "
                     f"{bps}/SM", got, want)
        del x, want, want_acc, out, acc, got
    # P2: the TPU's shape, a ragged one, the timed one
    for shape in (tr.PARITY, dict(ntab=33, noff=33, rows=5, cols=37,
                                  steps=41), tr.TIMED):
        tab, x = tr.inputs(shape["ntab"], shape["noff"], shape["rows"],
                           shape["cols"], device="cuda")
        want = tr.table_read_plain(tab, x, shape["steps"])
        for v in tr.VARIANTS:
            got = tr.table_read(tab, x, shape["steps"], v)
            torch.cuda.synchronize()
            same("table_read", f"table_read {v} {shape}", got, want)
    # P5: every walk, ragged and main; K2 on the shared program
    for shape in ((37, 45, 70), sp.MAIN):
        x = rand(shape)
        want = sp.panel_plain(x)
        for walk in sp.WALKS:
            for _ in range(1 if walk == "box" else sp.PERSIST_CHECKS):
                got = sp.panel(x, torch.full_like(x, float("nan")),
                               walk=walk)
                torch.cuda.synchronize()
                same("stateless_panel", f"stateless_panel {walk} {shape}",
                     got, want)
    k2 = sp.overlap_k2(sp.MAIN)
    k2_out = k2(x)
    torch.cuda.synchronize()
    same("stateless_panel", "K2 on P5's program", k2_out, want)
    del k2_out, got, want
    print(f"compare: P6 dep/indep, P3 direct and ring S={ar.SLOTS} at 1, 2 "
          f"and all blocks per SM, P2 {tr.VARIANTS}, P5 {sp.WALKS}: ragged "
          f"and main shapes bit-exact; K2 equal to P5 on "
          f"{sp.MAIN} | {smi}", flush=True)

    entry = dict(route="cuda", library_ms=None,
                 launches_counted="eager launches and graph captures; "
                 "replays not counted")
    out = {}
    # one timed case per probe at its main shape
    a, b = x, torch.empty_like(x)
    do.launches = 0
    ms = pingpong_ms(lambda s, d: do.overlap(s, "dep", 16, d), a, b, 3)
    n = do.launches
    out["dma_overlap"] = dict(
        entry, name="dma_overlap",
        source="stencilflow_tpu_torch/csrc/probes/dma_overlap.cu",
        replaces="scripts/dma_overlap_probe.py:56", launches=n, ms=ms,
        max_abs_err=worst["dma_overlap"],
        case="dep N=16, all blocks per SM",
        plain_ms=_time_ms(lambda: do.overlap_plain(a, "dep", 16), 3),
        **{k: v for k, v in roofline(*do.work(do.MAIN, "dep", 16), ms)
           .items() if k in ("bound_ms", "bound_by")})
    ar.launches = 0
    ms = pingpong_ms(lambda s, d: ar.ring(s, 16, "ring", 4, d,
                                          blocks_per_sm=1), a, b, 3)
    n = ar.launches
    out["async_ring"] = dict(
        entry, name="async_ring",
        source="stencilflow_tpu_torch/csrc/probes/dma_overlap.cu",
        replaces="scripts/dma_manual_probe.py:96", launches=n, ms=ms,
        max_abs_err=worst["async_ring"],
        case="ring S=4 N=16, 1 block per SM",
        plain_ms=_time_ms(lambda: ar.ring_plain(a, 16), 3),
        **{k: v for k, v in roofline(*do.work(do.MAIN, "dep", 16), ms)
           .items() if k in ("bound_ms", "bound_by")})
    tr.launches = 0
    rows = tr.measure(trials=3)
    n = tr.launches
    tab, x2 = tr.inputs(*(tr.TIMED[k] for k in ("ntab", "noff", "rows",
                                                "cols")), device="cuda")
    out["table_read"] = dict(
        entry, name="table_read",
        source="stencilflow_tpu_torch/csrc/probes/table_read.cu",
        replaces="scripts/smem_table_probe.py:39", launches=n,
        max_abs_err=worst["table_read"],
        ms=rows[0]["ms"], case="ldg, 33 x 33 table, 256 steps of 256^2",
        variants_ms={r["variant"]: r["ms"] for r in rows},
        plain_ms=_time_ms(lambda: tr.table_read_plain(
            tab, x2, tr.TIMED["steps"]), 3),
        bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"])
    sp.launches = 0
    ms = pingpong_ms(lambda s, d: sp.panel(s, d), a, b, 3)
    n = sp.launches
    ov_before = ov.launches
    k2_ms = sp.k2_ms(k2, a, 3)      # timed as P5 is: graphs, fed back
    k2_n = ov.launches - ov_before
    out["stateless_panel"] = dict(
        entry, name="stateless_panel",
        source="stencilflow_tpu_torch/csrc/probes/stateless_panel.cu",
        replaces="scripts/stateless_panel_probe.py:82", launches=n, ms=ms,
        max_abs_err=worst["stateless_panel"],
        case=f"B={sp.DEFAULT['B']} tile {sp.DEFAULT['tile']} "
             f"{sp.DEFAULT['walk']}",
        plain_ms=_time_ms(lambda: sp.panel_plain(a), 3),
        library_ms=sp.library_ms(a), k2_ms=k2_ms,
        **{k: v for k, v in roofline(8.0 * a.numel(), 14.0 * a.numel(), ms)
           .items() if k in ("bound_ms", "bound_by")})
    for e in out.values():
        print(f"kernel: {e['name']} ({e['case']}): {e['ms']:.4f} ms, plain "
              f"version {e['plain_ms']:.4f} ms, library "
              f"{'none' if e['library_ms'] is None else '%.4f ms' % e['library_ms']}"
              f", bound {e['bound_ms']:.4f} ms ({e['bound_by']}), launches "
              f"{e['launches']} | {smi}", flush=True)
    print(f"probe: P2 variants {out['table_read']['variants_ms']} ms | P5 "
          f"beside K2 (tile {k2.plan.tile}, {k2_n} launches) "
          f"{k2_ms:.4f} ms | {smi}", flush=True)
    del a, b, x, x2, tab
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "stencilflow_tpu_torch")):
        print("error: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import (build, codegen,
                                               compile_chain_rows)
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend import tile as tl
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
    from stencilflow_tpu_torch.driver import run_program
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.frontend.canonicalize import \
        rotate_2d_to_rows as rows
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    # -- 1. device -----------------------------------------------------------
    t_run = time.perf_counter()
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- programs of phases 3 and 4 -----------------------------------------
    def synth(shape, n, iters, extent=1, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n, n, n) if isinstance(n, int)
            else n, shape=shape, extent=extent,
            seed_data="random:0.0,1.0", **kw),
            name=f"{shape}3d_{n if isinstance(n, int) else n[0]}_"
                 f"{iters}itr")

    examples = [(n, sft.parse_program(os.path.join(HERE, "examples",
                                                   n + ".json")))
                for n in ("jacobi3d_32x32x32_8itr", "hdiff_64x64x64",
                          "forked_box_chain")]
    cases = examples + _fuzz_programs()
    small = (40, 48, 72)
    stream_cases = [
        ("box-r1", synth("box", small, 4, 1)),
        ("box-r2", synth("box", small, 4, 2)),
        ("box-r2-bc0.7", synth("box", small, 3, 2, boundary_value=0.7)),
        ("box-r1-shrink", synth("box", small, 3, 1, boundary="shrink")),
        ("cross-r2", synth("cross", small, 4, 2)),
        ("mixed", sft.parse_program(_mixed_spec(small), name="mixed")),
    ]
    jacobi8 = sft.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(512,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_512_8itr")
    jacobi2 = sft.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(512,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_512_2itr")
    box256 = synth("box", 256, 8, 2)
    cross256 = synth("cross", 256, 8, 2)
    hdiff8 = synth("hdiff", 256, 8)
    hotspot8 = synth("hotspot", 256, 8)
    mains = [(jacobi8, "panel"), (jacobi2, "overlap"), (hdiff8, "panel"),
             (hotspot8, "panel"),
             (box256, "stream"), (cross256, "stream")]

    def synth2d(shape, n, iters, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=n, shape=shape,
            seed_data="random:0.0,1.0", **kw),
            name=f"{shape}2d_{n[0]}_{iters}itr"
                 f"{'_' + kw['boundary'] if 'boundary' in kw else ''}")

    fuzz = {label.rsplit("-", 1)[0]: p for label, p in cases
            if label.startswith("fuzz-")}
    # (label, program the kernel runs, B, g)
    group_cases = [(f"jacobi2d-{bc}", rows(synth2d(
        "diffusion", (256, 192), 8, boundary=bc)), 64, 8)
        for bc in ("constant", "copy", "shrink")]
    group_cases += [
        ("hotspot2d", rows(synth2d("hotspot", (256, 192), 8)), 64, 8),
        ("fuzz-f32-2d", rows(fuzz["fuzz-f32-2d"]), 0, 2),
        ("jacobi3d-i3", sft.parse_program(_wide_i_spec((24, 40, 72), 4),
                                          name="jacobi3d_i3"), 2, 2),
        ("fuzz-f32", fuzz["fuzz-f32"], 0, 2)]
    # K4, the local chunk kernel (phase 3): (label, program, chunks)
    local_cases = [(f"jacobi3d-64-{bc}", sft.parse_program(
        synthesize_stencil(num_stages=3, dimensions=(64,) * 3,
                           shape="diffusion", boundary=bc,
                           seed_data="random:0.0,1.0"),
        name=f"jacobi3d_64_3itr_{bc}"), 4)
        for bc in ("constant", "copy", "shrink")]
    local_cases += [
        ("hdiff-dag", sft.parse_program(synthesize_stencil(
            num_stages=2, dimensions=(8, 12, 16), shape="hdiff"),
            name="hdiff_dag"), 4),
        ("box-r2-banded", synth("box", small, 2, 2), 2),
        _fuzz_chunked(cases)]
    # the out-of-core cells (phase 5): (program, chunks)
    jacobi1024 = sft.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(1024,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_1024_8itr")
    oc_cells = [(jacobi1024, 8), (synth("hotspot", 512, 8), 4)]
    jacobi2d = synth2d("diffusion", (8192, 8192), 8)
    hotspot2d = synth2d("hotspot", (8192, 8192), 8)
    hdiff2d = synth2d("hdiff", (8192, 8192), 16)
    mains2d = [(jacobi2d, "rows+group_g8"), (hotspot2d, "rows+group_g8"),
               (hdiff2d, "panel")]
    mains += mains2d
    # K3c (phase 3): (label, program, planner options; spill="all" spills
    # every ring read at an earlier step)
    spill_cases = [("reconvergent", sft.parse_program(
        _reconvergent_spec(), name="reconvergent_16"),
        {"smem_budget": 40000})]
    spill_cases += [(label, p, {"spill": "all"})
                    for label, p, _c in local_cases[:3]]
    spill_cases.append(("hdiff-dag", local_cases[3][1], {"spill": "all"}))
    spill_cases.append(("hotspot-deep", synth("hotspot", (40, 40, 72), 32),
                        {"spill": "all"}))
    # the deep 3-D cells (phase 4): the stream kernel's spill rung
    jacobi32 = synth("diffusion", 512, 32)
    deep = [jacobi32, synth("hdiff", 256, 16), synth("hotspot", 256, 32)]
    deep_names = {p.name for p in deep}

    # -- 2. build: every kernel, one nvcc each, all at once ------------------
    t0 = time.perf_counter()
    # name: (module, plan, build, wrapper, plain version)
    kernels = {"panel": (pn, pn.PanelPlan, pn.build_panel, pn.run_panel,
                         pn.panel_plain),
               "overlap": (ov, ov.OverlapPlan, ov.build_overlap,
                           ov.run_overlap, ov.overlap_plain)}
    sources = []
    plain_cases = []
    for label, p in cases:
        an = sft.ChainAnalysis.run(p)
        for kname, (_, plan_cls, _, _, _) in kernels.items():
            plan = plan_cls.build(an)
            plain_cases.append((label, kname, p, an, plan))
            src = (codegen.panel_source if kname == "panel" else
                   codegen.overlap_source)(p, an, plan)
            sources.append((src, kname))
    # K2 alone: hotspot3d (two streamed inputs, scalars) on the rule's
    # plan, with runs of 4 j cells and as the skeleton alone, and a 2-D
    # chain of 2 stages (I = 1)
    for label, p, kw in (
            ("hotspot3d-2", synth("hotspot", (24, 40, 72), 2), {}),
            ("hotspot3d-2-R4", synth("hotspot", (24, 40, 72), 2),
             dict(tile=(4, 8, 32), R=4, window=True)),
            ("hotspot3d-2-skeleton", synth("hotspot", (24, 40, 72), 2),
             dict(tile=(4, 8, 32), R=1, window=False)),
            ("jacobi2d-2", sft.parse_program(synthesize_stencil(
                num_stages=2, dimensions=(96, 200), shape="diffusion",
                seed_data="random:0.0,1.0"), name="jacobi2d_96_2itr"), {})):
        an = sft.ChainAnalysis.run(p)
        plan = ov.OverlapPlan.build(an, **kw)
        plain_cases.append((label, "overlap", p, an, plan))
        sources.append((codegen.overlap_source(p, an, plan), "overlap"))
    stream_plans = []
    for label, p in stream_cases + [("box3d_256_8itr", box256),
                                    ("cross3d_256_8itr", cross256)]:
        plan = st.plan_stream(p)
        stream_plans.append((label, p, plan))
        sources.append((st.stream_source(plan), "stream"))
    # the band passes on their other route (tensor cores against CUDA
    # cores): phase 3's banded cases, and box and cross 256^3 x 8, timed
    # in turns with their routes' plans in phase 4
    other_route = {}
    for label, p, plan in stream_plans:
        if plan.tkeys:
            other = "fma" if "mma" in _routes(plan) else "mma"
            other_route[label] = (p, st.plan_stream(p, passes=other))
            sources.append((st.stream_source(other_route[label][1]),
                            "stream"))
    main_panel = {}
    for p, _ in mains[:4]:
        an = sft.ChainAnalysis.run(p)
        plan = (ov.OverlapPlan if p is jacobi2 else pn.PanelPlan).build(an)
        sources.append(((codegen.overlap_source if p is jacobi2 else
                         codegen.panel_source)(p, an, plan),
                        "overlap" if p is jacobi2 else "panel"))
    for p in (box256, cross256):   # forced panel, where its planner fits
        an = sft.ChainAnalysis.run(p)
        try:
            plan = pn.PanelPlan.build(an)
        except ValueError as exc:
            main_panel[p.name] = str(exc)
            continue
        main_panel[p.name] = (an, plan)
        sources.append((codegen.panel_source(p, an, plan), "panel"))
    # the group kernel: phase 3's cases (then two of them cut into
    # i-segments), then the 2-D main path's plans
    group_plans = []
    for label, p, B, g, segments in [c + (None,) for c in group_cases] + [
            (label + f"-S{S}", p, B, g, S) for label, p, B, g in group_cases
            for want, S in (("jacobi2d-shrink", 4), ("jacobi3d-i3", 4))
            if label == want] + [
            (q.name, rows(q), 64, 8, None) for q, want in mains2d
            if want == "rows+group_g8"]:
        an = sft.ChainAnalysis.run(p)
        plan = gp.plan_group(p, an, B, g, segments=segments)
        src = codegen.group_source(p, an, plan)
        group_plans.append((label, p, an, plan, src))
        sources.append((src, "group"))
    n_group3 = len(group_plans) - sum(w == "rows+group_g8"
                                      for _, w in mains2d)
    # beside the 2-D cells: forced overlap on the unrotated plane (the
    # route before the rows path), forced rows+panel; a panel route's
    # kernel, and beside it the stream kernel's packed plan (its route
    # before the panel kernel packed its rings)
    forced2d, stream2d = {}, {}
    for p, want in mains2d:
        an = sft.ChainAnalysis.run(p)
        if want == "panel":
            sources.append((codegen.panel_source(p, an, pn.PanelPlan.build(
                an)), "panel"))
            stream2d[p.name] = st.plan_stream(p, an, mxu="off")
            sources.append((st.stream_source(stream2d[p.name]), "stream"))
        try:
            oplan = ov.OverlapPlan.build(an)
            sources.append((codegen.overlap_source(p, an, oplan), "overlap"))
        except ValueError as exc:
            oplan = str(exc)
        rot = rows(p)
        ran = sft.ChainAnalysis.run(rot)
        pplan = pn.PanelPlan.build(ran)
        sources.append((codegen.panel_source(rot, ran, pplan), "panel"))
        forced2d[p.name] = (an, oplan, pplan)
    # K4: phase 3's chunk plans, then the out-of-core cells' chunk plans
    # and their in-core (panel) plans
    local_plans = []
    for label, p, chunks in local_cases:
        plan = _local_plan(p, chunks)
        local_plans.append((label, p, chunks, plan))
        sources.append((st.stream_source(plan), "local_stream"))
    oc_plans = {}
    for p, chunks in oc_cells:
        oc_plans[p.name] = _local_plan(p, chunks)
        sources.append((st.stream_source(oc_plans[p.name]), "local_stream"))
        an = sft.ChainAnalysis.run(p)
        sources.append((codegen.panel_source(p, an, pn.PanelPlan.build(an)),
                        "panel"))
    # K3c: phase 3's spilled plans, K4 spilled at 4 chunks, the deep
    # cells' route plans (rung 4: every stage per cell, spilled)
    spill_plans = []
    for label, p, kw in spill_cases:
        plan = st.plan_stream(p, **kw)
        spill_plans.append((label, p, plan))
        sources.append((st.stream_source(plan), "stream"))
    lp = local_cases[1][1]   # jacobi3d 64^3 x 3, copy BCs
    lan = sft.ChainAnalysis.run(lp)
    local_spill = st.plan_local(lp, lan, lp.dimensions[0] // 4,
                                chain_halo(lan)[0], spill="all")
    sources.append((st.stream_source(local_spill), "local_stream"))
    deep_plans = {}
    for p in deep:
        deep_plans[p.name] = st.plan_stream(p, mxu="off")
        sources.append((st.stream_source(deep_plans[p.name]), "stream"))
    # K6: phase 3's programs in both modes, then the forced cells
    tile_plans = []
    for label, p in cases:
        for mode in ("masked", "fast"):
            plan = tl.plan_tile(p, mode=mode)
            tile_plans.append((label, p, plan))
            sources.append((tl.tile_source(plan), "tile"))
    tile_main = {}
    for p, mode in ((jacobi2, "masked"), (jacobi2, "fast"),
                    (hdiff8, tl.AUTO_MODE)):
        tile_main[p.name, mode] = tl.plan_tile(p, mode=mode)
        sources.append((tl.tile_source(tile_main[p.name, mode]), "tile"))
    # the probes of phase 6, built from csrc/probes/ (the names and text
    # probes.load builds them with, so phase 6 finds them built)
    from stencilflow_tpu_torch import probes
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    sources += [(probes.source(n), f"probe_{n}") for n in (
        "copy", "alu", "dma_overlap", "table_read", "stateless_panel")]
    # K2 on P5's program at its main shape (phase 6)
    p5 = sp.program(sp.MAIN)
    an5 = sft.ChainAnalysis.run(p5)
    sources.append((codegen.overlap_source(p5, an5, ov.OverlapPlan.build(
        an5)), "overlap"))
    # the solvers phase's lowerings (composed and adjoint programs among
    # them) compile on threads beside, each through its entry point
    solver_progs, solver_thunks = _solver_setup(sft, jacobi8)
    with ThreadPoolExecutor(max_workers=4) as pool:
        solver_built = [pool.submit(t) for t in solver_thunks]
        libs = build.load_libraries(sources)
        for fut in solver_built:
            fut.result()
    lib_of = {src: lib for (src, _), lib in zip(sources, libs)}
    slow = max(build.build_log, key=lambda x: x[1]) if build.build_log \
        else ("-", 0.0)
    print(f"build: {len(build.build_log)} programs, one nvcc each in "
          f"parallel, in {time.perf_counter() - t0:.1f}s (slowest "
          f"{slow[0]} {slow[1]:.1f}s)", flush=True)

    # the numpy oracles of phase 4's cells, computed on host threads while
    # the card works through phases 3 and 4 (the same inputs as
    # run_program's: seed 0)
    oracle_pool = ThreadPoolExecutor(max_workers=3)
    oracle_of = {p.name: oracle_pool.submit(
        lambda p=p: sft.run_interpreter(p, sft.load_input_arrays(p, seed=0)))
        for p in [q for q, _w in mains] + deep
        if max(p.dimensions) <= 256 or p is jacobi2d or p is hotspot2d}

    # -- 3. kernel vs plain on the card --------------------------------------
    print(f"phase: 3 at {time.perf_counter() - t_run:.1f} s", flush=True)
    for (label, kname, p, an, plan), (src, _) in zip(plain_cases, sources):
        module, _, _, run, plain = kernels[kname]
        lib = lib_of[src]
        inputs = sft.load_input_arrays(p, seed=7)
        arrays = spanned_arrays(p, inputs, device="cuda")
        before = module.launches
        got = run(p, an, plan, arrays, lib)
        torch.cuda.synchronize()
        want = plain(p, an, plan, arrays)
        rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               rtol)
            n = module.launches - before
            print(f"compare: {kname:7s} {label:28s} tile {plan.tile} "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"{kname} kernel disagrees with its "
                                   f"plain version on {label}")
    for label, p, plan in stream_plans[:len(stream_cases)] + [
            (label + " (" + _routes(q) + ")", p, q)
            for label, (p, q) in other_route.items()
            if label in dict(stream_cases)]:
        lib = lib_of[st.stream_source(plan)]
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = st.launches
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        want = st.stream_plain(plan, arrays)
        for o in p.outputs:
            g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
            ok, err = _compare(g, w, MXU_VERIFY_RTOL)
            ok = ok and bool(np.isfinite(g).all())
            n = st.launches - before
            cfg = plan.last_config()
            print(f"compare: stream  {label:28s} tile {plan.tile} x "
                  f"{plan.threads} passes {_routes(plan) or '-'} banded "
                  f"{cfg['mxu_stages']} composed {cfg['composed']} "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'} (MXU_VERIFY_RTOL)",
                  flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"stream kernel disagrees with its plain "
                                   f"version on {label}")

    for label, p, an, plan, src in group_plans[:n_group3]:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = gp.launches
        got = gp.run_group(p, an, plan, arrays, lib_of[src])
        torch.cuda.synchronize()
        want = gp.group_plain(p, an, plan, arrays)
        rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               rtol)
            n = gp.launches - before
            print(f"compare: group   {label:28s} B {plan.B} groups "
                  f"{len(plan.groups)} tile {plan.tile} x {plan.threads} "
                  f"segments {plan.segments} max_abs_err "
                  f"{err:.3g} launches {n} {'OK' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"group kernel disagrees with its plain "
                                   f"version on {label}")

    for label, p, chunks, plan in local_plans:
        lib = lib_of[st.stream_source(plan)]
        inputs = sft.load_input_arrays(p, seed=7)
        banded = bool(plan.mxu_plans)
        rtol = MXU_VERIFY_RTOL if banded else (
            VERIFY_RTOL if _has_transcendental(p) else 0.0)
        if label == "box-r2-banded" and sorted(plan.mxu_plans) != sorted(
                p.kernels):
            raise RuntimeError(f"{label}: not banded per stage "
                               f"({sorted(plan.mxu_plans)})")
        worst, launched = 0.0, 0
        for c in range(chunks):
            lo = c * plan.block - plan.halo_i
            slabs = _chunk_slabs(p, inputs, lo, plan.extent())
            before = st.local_launches
            got = st.run_local_stream(plan, lo, slabs, lib)
            torch.cuda.synchronize()
            launched += st.local_launches - before
            want = st.local_stream_plain(plan, lo, slabs)
            for o in p.outputs:
                g = got[o].cpu().numpy()
                ok, err = _compare(g, want[o].cpu().numpy(), rtol)
                if banded:
                    ok = ok and bool(np.isfinite(g).all())
                worst = max(worst, err)
                if not ok:
                    raise RuntimeError(f"local stream kernel disagrees with "
                                       f"its plain version on {label}, "
                                       f"chunk {c} (max abs diff {err:.3g})")
        print(f"compare: local   {label:28s} chunks {chunks} Ic "
              f"{plan.block} h {plan.halo_i} tile {plan.tile} banded "
              f"{sorted(plan.mxu_plans)} max_abs_err {worst:.3g} launches "
              f"{launched} OK ({'MXU_VERIFY_RTOL' if banded else 'rtol %g' % rtol})",
              flush=True)
        if launched != chunks:
            raise RuntimeError(f"local stream kernel launched {launched} "
                               f"times over {chunks} chunks of {label}")

    # K3c: spilled rings, whole domain, then K4 spilled chunk by chunk
    for label, p, plan in spill_plans:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = st.spill_launches
        got = st.run_stream(plan, arrays, lib_of[st.stream_source(plan)])
        torch.cuda.synchronize()
        want = st.stream_plain(plan, arrays)
        n = st.spill_launches - before
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               0.0)
            print(f"compare: spill   {label:28s} tile {plan.tile} spilled "
                  f"{len(plan.spilled)} of {len(plan.raw_ring)} rings "
                  f"({plan.spill_bytes()} B) smem {plan.smem_bytes()} B "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"spilled stream kernel disagrees with "
                                   f"its plain version on {label}")
    inputs = sft.load_input_arrays(lp, seed=7)
    launched, worst = 0, 0.0
    for c in range(4):
        lo = c * local_spill.block - local_spill.halo_i
        slabs = _chunk_slabs(lp, inputs, lo, local_spill.extent())
        before = st.spill_launches
        got = st.run_local_stream(local_spill, lo, slabs,
                                  lib_of[st.stream_source(local_spill)])
        torch.cuda.synchronize()
        launched += st.spill_launches - before
        want = st.local_stream_plain(local_spill, lo, slabs)
        for o in lp.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               0.0)
            worst = max(worst, err)
            if not ok:
                raise RuntimeError(f"spilled local stream kernel disagrees "
                                   f"with its plain version, chunk {c}")
    print(f"compare: spill   {lp.name + ' local':28s} chunks 4 tile "
          f"{local_spill.tile} spilled {len(local_spill.spilled)} rings "
          f"max_abs_err {worst:.3g} launches {launched} OK", flush=True)
    if launched != 4:
        raise RuntimeError(f"spilled K4 launched {launched} times over 4 "
                           "chunks")

    # K6, masked and fast
    for label, p, plan in tile_plans:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = tl.launches
        got = tl.run_tile(plan, arrays, lib_of[tl.tile_source(plan)])
        torch.cuda.synchronize()
        want = tl.tile_plain(plan, arrays)
        rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
        n = tl.launches - before
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               rtol)
            print(f"compare: tile    {label:28s} {plan.mode:6s} tile "
                  f"{plan.tile} smem {plan.smem_bytes()} B max_abs_err "
                  f"{err:.3g} launches {n} {'OK' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"tile kernel ({plan.mode}) disagrees "
                                   f"with its plain version on {label}")

    # -- 4. the main path at full size ---------------------------------------
    print(f"phase: 4 at {time.perf_counter() - t_run:.1f} s", flush=True)
    # kernel vs plain version at the main path's shapes (counted out)
    report = {}
    library = []     # (report key or cell, program, filter radius)
    for p, kname in ((jacobi8, "panel"), (hdiff8, "panel"),
                     (hotspot8, "panel"), (jacobi2, "overlap")):
        _, plan_cls, build_fn, run, plain = kernels[kname]
        an = sft.ChainAnalysis.run(p)
        plan = plan_cls.build(an)
        lib = build_fn(p, an, plan)
        # K1: packed and unpacked shared memory, resident blocks per SM;
        # K2: B, run, register window, blocks along i, threads
        smem = (f"smem {plan.smem_bytes(p)} B (unpacked "
                f"{plan.unpacked_bytes(p)}), {pn.occupancy(lib)} blocks "
                f"per SM, masked share {plan.masked_share(p):.3f}"
                if kname == "panel" else
                f"(B {plan.tile[0]}), R {plan.R} along j, window "
                f"{plan.window}, {plan.grid(p.dimensions)[0]} blocks along "
                f"i, {plan.threads} threads, "
                f"{pn.occupancy(lib)} blocks per SM, smem "
                f"{plan.smem_bytes(p)} B")
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        got = run(p, an, plan, arrays, lib)
        want = plain(p, an, plan, arrays)
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           want[p.outputs[0]].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: run(p, an, plan, arrays, lib), 10)
        plain_ms = _time_ms(lambda: plain(p, an, plan, arrays), 1)
        del got, want, arrays
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        print(f"kernel: {kname} {p.name} tile {plan.tile} {smem}: "
              f"{ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3g} "
              f"{'bit-equal to the plain version' if ok else 'MISMATCH'} "
              f"| {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"{kname} kernel disagrees with its plain "
                               f"version on {p.name}")
        if kname in report:
            continue
        report[kname] = {
            "name": kname, "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": ("stencilflow_tpu/backend/panel.py:167"
                         if kname == "panel" else
                         "stencilflow_tpu/backend/overlap.py:99"),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        library.append((kname, p, 1))
    stream_extra = {}
    for label, p, plan in stream_plans[len(stream_cases):]:
        lib = lib_of[st.stream_source(plan)]
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           want[p.outputs[0]].cpu().numpy(), MXU_VERIFY_RTOL)
        # the other route of the band passes, checked, then both timed in
        # turns (route, other, other, route)
        oplan = other_route[label][1]
        olib = lib_of[st.stream_source(oplan)]
        oout = st.run_stream(oplan, arrays, olib)
        ook, oerr = _compare(oout[p.outputs[0]].cpu().numpy(),
                             want[p.outputs[0]].cpu().numpy(),
                             MXU_VERIFY_RTOL)
        del oout
        turns = [_time_ms(lambda q=q, lb=lb: st.run_stream(q, arrays, lb), 5)
                 for q, lb in ((plan, lib), (oplan, olib), (oplan, olib),
                               (plan, lib))]
        ms = (turns[0] + turns[3]) / 2
        oms = (turns[1] + turns[2]) / 2
        # forced panel on the same inputs, where its planner fits
        forced = main_panel[p.name]
        if isinstance(forced, str):
            stream_extra[label] = f" | forced panel: refused ({forced})"
        else:
            an, pplan = forced
            plib = pn.build_panel(p, an, pplan)
            pout = pn.run_panel(p, an, pplan, arrays, plib)
            pok, _ = _compare(pout[p.outputs[0]].cpu().numpy(),
                              want[p.outputs[0]].cpu().numpy(),
                              MXU_VERIFY_RTOL)
            pms = _time_ms(lambda: pn.run_panel(p, an, pplan, arrays,
                                                plib), 2)
            stream_extra[label] = (
                f" | forced panel tile {pplan.tile} {pms:.3f} ms (within "
                f"MXU_VERIFY_RTOL: {'yes' if pok else 'NO'})")
            del pout
        del got, want, arrays
        torch.cuda.empty_cache()
        flops = plan.flops_per_cell() * p.total_elements
        bound_ms, bound_by = _bound(p)
        print(f"kernel: stream {label} tile {plan.tile} x {plan.threads} "
              f"threads, {_routes(plan)} passes, smem {plan.smem_bytes()} B "
              f"packed (unpacked {plan.unpacked_bytes()}), "
              f"{pn.occupancy(lib)} blocks per SM, "
              f"{plan.evaluations():.2f} evaluations a cell: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s; in turns "
              f"{turns[0]:.3f} / {turns[3]:.3f}), plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"transforms {flops / 1e9:.2f} GFLOP), max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | {_routes(oplan)} passes "
              f"beside: tile {oplan.tile} x {oplan.threads}, smem "
              f"{oplan.smem_bytes()} B, {oms:.3f} ms (in turns "
              f"{turns[1]:.3f} / {turns[2]:.3f}), max_abs_err {oerr:.3g} "
              f"{'OK' if ook else 'MISMATCH'} | {smi}", flush=True)
        if not ok or not ook:
            raise RuntimeError(f"stream kernel disagrees with its plain "
                               f"version on {label}")
        key = "stream" if label == "box3d_256_8itr" else "stream_cross"
        report[key] = {
            "name": key, "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": "stencilflow_tpu/backend/stream.py:297",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        library.append((key, p, 2))

    # K3c on the deep cells (the route's spill-rung plans): kernel and
    # plain version bit for bit, the dense lowering's time beside, spill
    # traffic against the copy floor, the layout's loads and residency
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.config import H100_COPY_FLOOR
    for p in deep:
        plan = deep_plans[p.name]
        lib = lib_of[st.stream_source(plan)]
        inputs = sft.load_input_arrays(p, seed=0)
        arrays = spanned_arrays(p, inputs, device="cuda")
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        o = p.outputs[0]
        ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(), 0.0)
        del got, want
        ms = _time_ms(lambda: st.run_stream(plan, arrays, lib), 2)
        dense_fn = compile_chain(p)
        tensors = {k: torch.as_tensor(np.asarray(v)).cuda()
                   for k, v in inputs.items()}
        dense_ms = _time_ms(lambda: dense_fn(tensors), 1)
        del arrays, tensors
        plan.device_pool.clear()
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        ntj, ntk = plan.grid()
        moved = plan.spill_traffic() * plan.steps() * ntj * ntk
        print(f"kernel: stream_spill {p.name} tile {plan.tile} smem "
              f"{plan.smem_bytes()} B, {plan.residency()} blocks per SM, "
              f"spilled {len(plan.spilled)} of {len(plan.raw_ring)} rings, "
              f"{len(plan.spill_layout().loads)} loads a step "
              f"({plan.spill_bytes() / 2 ** 30:.3f} GiB): {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s, "
              f"{bound_ms / ms:.4f} of the bound {bound_ms:.4f} ms, "
              f"{bound_by}), spill traffic {moved / 1e9:.2f} GB a call at "
              f"{moved / ms / 1e6:.1f} GB/s ({moved / ms * 1e3 / H100_COPY_FLOOR:.3f} "
              f"of the copy floor), modelled {plan.spill_seconds() * 1e3:.1f} "
              f"ms | plain version {plain_ms:.1f} ms, max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | dense {dense_ms:.3f} ms | {smi}",
              flush=True)
        if not ok:
            raise RuntimeError("spilled stream kernel disagrees with its "
                               f"plain version on {p.name}")
        if p is jacobi32:
            report["stream_spill"] = {
                "name": "stream_spill", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/stream.py:658",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("stream_spill", jacobi32, 1))
    # K6 on jacobi3d 512^3 x 2: masked, then fast (the route's mode,
    # tl.AUTO_MODE, whose entry the kernels line carries)
    arrays = spanned_arrays(jacobi2, sft.load_input_arrays(jacobi2, seed=0),
                            device="cuda")
    for mode in ("masked", "fast"):
        plan = tile_main[jacobi2.name, mode]
        lib = lib_of[tl.tile_source(plan)]
        got = tl.run_tile(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = tl.tile_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        o = jacobi2.outputs[0]
        ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: tl.run_tile(plan, arrays, lib), 10)
        del got, want
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(jacobi2)
        print(f"kernel: tile {jacobi2.name} {mode} tile {plan.tile} smem "
              f"{plan.smem_bytes()} B, {pn.occupancy(lib)} blocks per SM: "
              f"{ms:.3f} ms, "
              f"plain version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"tile kernel ({mode}) disagrees with its "
                               f"plain version on {jacobi2.name}")
        if mode == tl.AUTO_MODE:
            report["tile"] = {
                "name": "tile", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/pallas.py:"
                            + ("123" if mode == "fast" else "104"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("tile", jacobi2, 1))
    del arrays
    torch.cuda.empty_cache()

    for label, p, an, plan, src in group_plans[n_group3:]:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        lib = lib_of[src]
        got = gp.run_group(p, an, plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = gp.group_plain(p, an, plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           want[p.outputs[0]].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: gp.run_group(p, an, plan, arrays, lib), 10)
        del got, want, arrays
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        print(f"kernel: group {label} (rows) B {plan.B} g 8 tile {plan.tile} "
              f"x {plan.threads} segments {plan.segments} smem "
              f"{plan.smem_bytes(p)} B, {pn.occupancy(lib)} blocks per SM, "
              f"modelled {plan.seconds(p) * 1e3:.3f} ms: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s), plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} | {smi}",
              flush=True)
        if not ok:
            raise RuntimeError(f"group kernel disagrees with its plain "
                               f"version on {label}")
        if "group" not in report:   # jacobi2d's, the first 2-D cell
            report["group"] = {
                "name": "group", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/group.py:195",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("group", jacobi2d, 1))
    for p, _ in mains2d:   # forced kernels beside the 2-D cells
        an, oplan, pplan = forced2d[p.name]
        inputs = {k: torch.as_tensor(np.asarray(v)).cuda()
                  if not p.inputs[k].is_scalar else v
                  for k, v in sft.load_input_arrays(p, seed=0).items()}
        fr = compile_chain_rows(p, "panel", device="cuda")[0]
        rms = _time_ms(lambda: fr(inputs), 5)
        rout = fr(inputs)[p.outputs[0]].cpu().numpy()
        if isinstance(oplan, str):
            stream_extra[p.name] = f" | forced overlap: refused ({oplan})"
        else:
            fo = ov.compile_chain_overlap(p, an, device="cuda")
            oms = _time_ms(lambda: fo(inputs), 5)
            oeq, _ = _compare(fo(inputs)[p.outputs[0]].cpu().numpy(), rout,
                              0.0)
            if not oeq:
                raise RuntimeError(f"{p.name}: forced overlap and forced "
                                   "rows+panel disagree")
            stream_extra[p.name] = (
                f" | forced overlap (unrotated) tile {oplan.tile} "
                f"{oms:.3f} ms")
        stream_extra[p.name] += (f" | forced rows+panel tile {pplan.tile} "
                                 f"{rms:.3f} ms")
        if p.name in stream2d:
            splan = stream2d[p.name]
            slib = lib_of[st.stream_source(splan)]
            sarr = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                  device="cuda")
            sout = st.run_stream(splan, sarr, slib)[p.outputs[0]]
            if not _compare(sout.cpu().numpy().reshape(rout.shape), rout,
                            0.0)[0]:
                raise RuntimeError(f"{p.name}: the stream kernel and "
                                   "forced rows+panel disagree")
            sms = _time_ms(lambda: st.run_stream(splan, sarr, slib), 5)
            stream_extra[p.name] += (f" | stream kernel (packed) tile "
                                     f"{splan.tile} {sms:.3f} ms")
            del sarr, sout
        forced2d[p.name] = rout
        del inputs, fr
        torch.cuda.empty_cache()

    route_ms = {}
    pn.launches = 0
    ov.launches = 0
    st.launches = 0
    st.local_launches = 0
    st.spill_launches = 0
    gp.launches = 0
    tl.launches = 0
    for p, want_backend, backend in (
            [(p, w, "auto") for p, w in mains]
            + [(p, "stream", "auto") for p in deep]
            + [(jacobi2, "tile", "tile"), (hdiff8, "tile", "tile")]):
        spilled_before = st.spill_launches
        res = run_program(p, device="cuda", backend=backend,
                          repetitions=3 if p.name in deep_names else 20,
                          save_results=False, log_level=0)
        if res.backend != want_backend:
            raise RuntimeError(f"{p.name}: backend {res.backend}, expected "
                               f"{want_backend}")
        if p.name in deep_names and (not deep_plans[p.name].packed
                          or st.spill_launches - spilled_before != 4):
            raise RuntimeError(f"{p.name}: the spilled stream kernel ran "
                               f"{st.spill_launches - spilled_before} "
                               "times over 4 calls")
        dense = run_program(p, device="cuda", backend="dense",
                            repetitions=2, save_results=False, log_level=0)
        rtol = MXU_VERIFY_RTOL if p is box256 or p is cross256 else 0.0
        for o in p.outputs:
            ok, err = _compare(res.outputs[o], dense.outputs[o], rtol)
            if not ok or not np.isfinite(res.outputs[o]).all():
                raise RuntimeError(f"{p.name}: {res.backend} disagrees "
                                   f"with dense (max abs diff {err:.3g})")
        oracle = p.name in oracle_of
        if oracle:   # run_program's own check (VERIFY_RTOL, banded: MXU)
            want = oracle_of[p.name].result()
            for o in p.outputs:
                if not _compare(res.outputs[o], np.asarray(want[o]),
                                rtol or VERIFY_RTOL)[0]:
                    raise RuntimeError(f"{p.name}: {res.backend} disagrees "
                                       "with the numpy oracle")
            del want
        if p.name in forced2d and not _compare(
                res.outputs[p.outputs[0]], forced2d[p.name], 0.0)[0]:
            raise RuntimeError(f"{p.name}: {res.backend} disagrees with "
                               "forced rows+panel")
        cells = p.total_elements
        extra = stream_extra.get(p.name, "")
        if p.name in deep_names:
            plan = deep_plans[p.name]
            extra = (f" | tile {plan.tile}, spilled {len(plan.spilled)} of "
                     f"{len(plan.raw_ring)} rings, smem "
                     f"{plan.smem_bytes()} B, spill buffer "
                     f"{plan.spill_bytes() / 2 ** 30:.3f} GiB")
        if backend == "tile":
            plan = tile_main[p.name, tl.AUTO_MODE]
            extra = (f" | {plan.mode}, tile {plan.tile}, smem "
                     f"{plan.smem_bytes()} B | "
                     f"route {route_ms[p.name][0]} "
                     f"{route_ms[p.name][1]:.3f} ms")
        else:
            route_ms[p.name] = (res.backend, res.wall_time_s * 1e3)
        print(f"main: {p.name} backend {res.backend} "
              f"{res.wall_time_s * 1e3:.3f} ms "
              f"({cells / res.wall_time_s / 1e9:.2f} GCell/s) | dense "
              f"{dense.wall_time_s * 1e3:.3f} ms "
              f"({cells / dense.wall_time_s / 1e9:.2f} GCell/s) | "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} "
              f"dense, oracle {'OK' if oracle else 'skipped'}"
              f"{extra} | {smi}", flush=True)
        del res, dense
        torch.cuda.empty_cache()
    oracle_pool.shutdown()
    # the library yardstick, after the main path (cuDNN state stays out
    # of the kernels' timings)
    for key, p, radius in library:
        lib_ms = _conv_chain_ms(p, radius)
        if key in report:
            report[key]["library_ms"] = lib_ms
        nd = len(p.raw_dimensions)
        print(f"library: {p.name} {len(p.kernels)} chained F.conv{nd}d "
              f"(filter {2 * radius + 1}^{nd}, TF32 off) {lib_ms:.3f} ms "
              f"| {smi}", flush=True)
        torch.cuda.empty_cache()
    report["panel"]["launches"] = pn.launches
    report["overlap"]["launches"] = ov.launches
    report["stream"]["launches"] = st.launches
    report["stream_cross"]["launches"] = st.launches
    report["group"]["launches"] = gp.launches
    report["stream_spill"]["launches"] = st.spill_launches
    report["tile"]["launches"] = tl.launches
    if st.local_launches:
        raise RuntimeError("the in-core main path launched the local "
                           "stream kernel")

    # -- 5. the out-of-core path ---------------------------------------------
    print(f"phase: 5 at {time.perf_counter() - t_run:.1f} s", flush=True)
    report["local_stream"] = _outofcore(sft, st, pn, ov, gp, oc_cells,
                                        oc_plans, lib_of, smi, run_program)

    # -- 6. the measurement path ---------------------------------------------
    print(f"phase: 6 at {time.perf_counter() - t_run:.1f} s", flush=True)
    report.update(_measurement(pn, smi))
    report.update(_design_probes(ov, smi))
    for name, entry in report.items():
        if entry["launches"] < 1:
            raise RuntimeError(f"the main path never launched {name}")

    # -- 7. the solver entry points ------------------------------------------
    print(f"phase: 7 at {time.perf_counter() - t_run:.1f} s", flush=True)
    _solvers(sft, solver_progs, smi, report["panel"]["ms"])

    # -- 8. the simulator ------------------------------------------------------
    print(f"phase: 8 at {time.perf_counter() - t_run:.1f} s", flush=True)
    _simulator(sft, run_program, jacobi8, smi)

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith(("jax.", "stencilflow_tpu."))
           or m == "stencilflow_tpu"]
    if bad:
        raise RuntimeError(f"imported the JAX side: {bad[:5]}")
    print(f"phase: end at {time.perf_counter() - t_run:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

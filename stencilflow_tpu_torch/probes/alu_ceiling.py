"""P1, the FP32 ceiling: elementwise ops on register-resident values.

    python -m stencilflow_tpu_torch.probes.alu_ceiling [--trials 3]

Port of ``scripts/vpu_ceiling.py`` (``build`` :238, ``pallas_call`` :240,
body :46-235) as the CUDA kernel ``csrc/probes/alu.cu``: every thread
applies ``UNROLL`` unrolled ops per step to one accumulator (and the
operands c, d) held in registers, for ``steps`` steps, one thread per
element of ``elements()`` (every SM filled to 2048 resident threads).
Two step counts are differenced, best of trials.  The ops are the TPU
script's default list, its K-chain and expression variants (``mul4``,
``expr_jac2d``, the flux limiter's three formulations ``expr_lim_*``,
the hoisted mask's ``selc`` and ``maskmul``, and ``expr_jac2d_shift``,
whose blocks own a 16 x 16 plane in shared memory and read four shifted
neighbours an application), and ``fma_fused`` (explicit ``fmaf``): the kernel is built with the port's
``-fmad=false``, under which ``a * c + d`` is two instructions.  The
shared-memory variant of ``add`` loads and stores the accumulator around
every op behind a ``__syncthreads``: the pass rate of kernels that store
every stage to shared memory.

Output per op: applications/s, flop/s, instructions/s where the
instruction count is known, and the cost in add-equivalents (the time of
one application over the time of one ``add``).  Their summary sets
``config.H100_ALU_ISSUE_RATE``, ``config.H100_SMEM_PASS_RATE`` and
``config.H100_OP_COST`` (``op_costs``).  The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from . import (ClockSampler, card, check_cuda, differenced_ms, load,
               require_cuda, sm_count)

launches = 0

UNROLL = 64                       # SF_ALU_UNROLL in alu.cu
# op ids in the order of alu.cu's enum
OPS = ("add", "add2", "mul", "fma", "fma_fused", "mixed", "div", "divc",
       "sqrt", "exp", "select", "min", "sin", "cos", "tan", "tanh", "log",
       "abs", "add4", "fma4", "add8", "expr_jac", "expr_hs", "mul4",
       "expr_jac2d", "expr_jac2d_shift", "expr_lim_sel", "expr_lim_mask",
       "expr_lim_minmax", "selc", "maskmul")
# counted ops per unrolled application, as the TPU script counts them: K
# chains, or an expression's ops (expr_jac2d_shift: the 4-term sum; its
# shifted reads and store are what its time adds to expr_jac2d's; the
# limiter: 2 sub, mul, cmp, select and the carry's mul and add)
APPLICATIONS = {"add4": 4, "fma4": 4, "add8": 8, "mul4": 4, "expr_jac": 8,
                "expr_hs": 20, "expr_jac2d": 4, "expr_jac2d_shift": 4,
                "expr_lim_sel": 7, "expr_lim_mask": 7,
                "expr_lim_minmax": 7}
# expr_jac2d_shift's plane: a block's 16 x 16 cells
SHIFT_SIDE = 16
FLOPS = {"fma": 2, "fma_fused": 2, "fma4": 2}     # per op; else 1
# FP32 instructions per op under -fmad=false, where the op is one kind
INSTRUCTIONS = {"add": 1, "add2": 1, "mul": 1, "fma": 2, "fma_fused": 1,
                "mixed": 1, "add4": 1, "fma4": 2, "add8": 1, "mul4": 1}
TRANSCENDENTAL = ("exp", "sin", "cos", "tan", "tanh", "log")
# plain versions: bit-exact but for these (stated tolerance, relative)
TOLERANCE = {**{op: 1e-5 for op in TRANSCENDENTAL},
             # the plain fma rounds a float64 product-sum to float32:
             # a double rounding, off by one ulp in rare cases
             "fma_fused": 1e-6}

_vp, _int = ctypes.c_void_p, ctypes.c_int
_ARGS = (_vp, _vp, _int, _int, _int, _int, _vp)


def elements() -> int:
    """One element per thread, 2048 resident threads on every SM."""
    return 2048 * sm_count()


def alu(op: str, x: torch.Tensor, steps: int, smem: bool = False,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``steps`` steps of ``UNROLL`` ops ``op`` from each element of the
    1-D float32 ``x``.  ``smem``: the shared-memory variant (``add``
    only).  ``expr_jac2d_shift`` takes a multiple of 256 elements: one
    16 x 16 plane a block.  On a CUDA tensor the kernel runs; on a CPU
    tensor the plain version."""
    if op not in OPS or (smem and op != "add"):
        raise ValueError(f"unknown probe op {op!r}"
                         f"{' (shared memory: add only)' if smem else ''}")
    if x.dim() != 1 or steps < 0:
        raise ValueError("alu takes a 1-D tensor and steps >= 0")
    if op == "expr_jac2d_shift" and x.numel() % SHIFT_SIDE ** 2:
        raise ValueError("expr_jac2d_shift takes a multiple of "
                         f"{SHIFT_SIDE ** 2} elements")
    if x.device.type == "cpu":
        return alu_plain(op, x, steps)
    check_cuda(x)
    if out is None:
        out = torch.empty_like(x)
    lib = load("alu", "sf_alu_launch", _ARGS)
    with torch.cuda.device(x.device):
        rc = lib.sf_alu_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                               OPS.index(op), steps, int(smem),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"alu kernel launch failed: error {rc}")
    global launches
    launches += 1
    return out


def alu_plain(op: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """The kernel's op sequence in torch, op for op in the same order and
    float32 rounding (the shared-memory variant computes ``add``)."""
    def f(v):
        return torch.tensor(np.float32(v), device=x.device)
    c = x * f(0.999993)
    d = x * f(1e-7)
    n = steps * UNROLL
    if op in ("add4", "fma4", "add8", "mul4"):
        K = APPLICATIONS[op]
        ch = [x * f(np.float32(1.0) + np.float32(1e-6) * np.float32(k))
              for k in range(K)]
        for i in range(n):
            u = i % UNROLL
            for k in range(K):
                if op == "fma4":
                    ch[k] = ch[k] * c + d
                elif op == "mul4":
                    ch[k] = ch[k] * (d if (u + k) & 1 else c)
                else:
                    ch[k] = ch[k] + (d if (u + k) & 1 else c)
        a = ch[0]
        for k in range(1, K):
            a = a + ch[k]
        return a
    a = x
    if op.startswith("expr_lim"):
        zero, one = f(0.0), f(1.0)
        for i in range(n):
            flx = (c if (i % UNROLL) & 1 else a) - a * f(0.999)
            dq = c - a * f(1.001)
            p = flx * dq
            if op == "expr_lim_sel":
                flx = torch.where(p > zero, zero, flx)
            elif op == "expr_lim_mask":
                flx = flx * torch.where(p <= zero, one, zero)
            else:
                flx = torch.where(dq > zero, torch.minimum(flx, zero),
                                  torch.maximum(flx, zero))
            a = a * f(0.5) + flx
        return a
    if op in ("selc", "maskmul"):
        m = c > d
        mf = m.float()
        nf = f(1.0) - mf
        for i in range(n):
            odd = (i % UNROLL) & 1
            if op == "selc":
                a = torch.where(m, a, c) if odd else torch.where(m, d, a)
            else:
                a = a * (nf if odd else mf)
        return a
    if op == "expr_jac2d_shift":
        a = x.reshape(-1, SHIFT_SIDE, SHIFT_SIDE)
        for _ in range(n):   # each edge reads itself (concat fill)
            jm = torch.cat([a[:, 1:], a[:, -1:]], 1)
            jp = torch.cat([a[:, :1], a[:, :-1]], 1)
            km = torch.cat([a[:, :, 1:], a[:, :, -1:]], 2)
            kp = torch.cat([a[:, :, :1], a[:, :, :-1]], 2)
            a = f(0.25) * (jm + jp + km + kp)
        return a.reshape(-1)
    if op == "expr_jac2d":
        b0, b1, b2 = c * f(0.9), c * f(0.91), c * f(0.92)
        for _ in range(n):
            a = f(0.25) * (a + b0 + b1 + b2)
        return a
    if op in ("expr_jac", "expr_hs"):
        b0, b1, b2, b3, b4 = c * f(0.9), c * f(0.91), c * f(0.92), \
            c * f(0.93), d
        for _ in range(n):
            if op == "expr_jac":
                a = f(0.142857) * (a + b0 + b1 + b2 + b3 + b4
                                   + a * f(1e-7))
            else:
                a = a + f(0.01) * (b0 + f(0.1) * (b1 + b2 - f(2.0) * a)
                                   + f(0.1) * (b3 + b4 - f(2.0) * a)
                                   + f(0.1) * (b1 + b3 - f(2.0) * a)
                                   + f(0.0001) * (f(80.0) - a))
        return a
    for i in range(n):
        odd = (i % UNROLL) & 1
        if op == "add":
            a = a + (d if odd else c)
        elif op == "add2":
            a = a + a
        elif op == "mul":
            a = a * (d if odd else c)
        elif op == "fma":
            a = a * c + d
        elif op == "fma_fused":
            a = (a.double() * c.double() + d.double()).float()
        elif op == "mixed":
            a = a * c if odd else a + d
        elif op == "div":
            a = c / a
        elif op == "divc":
            a = a / (f(0.9999999) if odd else f(1.0000001))
        elif op == "sqrt":
            a = torch.sqrt(a)
        elif op == "exp":
            a = torch.exp(-a)
        elif op == "select":
            a = torch.where(a > c, d, a)
        elif op == "min":
            a = torch.minimum(a, d if odd else c)
        elif op == "sin":
            a = torch.sin(a)
        elif op == "cos":
            a = torch.cos(a)
        elif op == "tan":
            a = torch.tan(a * f(1e-3))
        elif op == "tanh":
            a = torch.tanh(a)
        elif op == "log":
            a = torch.log(a + f(1.0))
        else:
            a = torch.abs(a - (d if odd else c))
    return a


def inputs(n: int, device) -> torch.Tensor:
    """The probe's input: uniform [0.5, 1) float32 from numpy seed 0."""
    x = np.random.default_rng(0).uniform(0.5, 1.0, n).astype(np.float32)
    return torch.as_tensor(x, device=device)


def compare(op: str, got: torch.Tensor, want: torch.Tensor):
    """(ok, max abs diff): bit-exact, or within ``TOLERANCE[op]``
    relative."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = torch.where(got == want, 0.0, (got - want).abs())
    err = float(diff.max()) if got.numel() else 0.0
    rtol = TOLERANCE.get(op, 0.0)
    if rtol == 0.0:
        return bool(torch.equal(got, want)), err
    return bool(torch.all(diff <= rtol * want.abs())), err


def measure(ops=OPS, trials: int = 3,
            smem: bool = True) -> List[Dict[str, object]]:
    """Each op and (``smem``) the shared-memory add on the card: ms per
    step (4096 and 512 steps differenced, best of ``trials``) and the
    rates that follow."""
    x = inputs(elements(), "cuda")
    out = torch.empty_like(x)
    rows = []
    for op, sm in [(op, False) for op in ops] + ([("add", True)]
                                                 if smem else []):
        ms = differenced_ms(lambda n: alu(op, x, n, sm, out), 512, 4096,
                            trials)
        apps = x.numel() * UNROLL * APPLICATIONS.get(op, 1) / (ms / 1e3)
        instr = INSTRUCTIONS.get(op) if not sm else None
        rows.append({"op": op + ("_smem" if sm else ""),
                     "ms_per_step": ms, "ops_per_s": apps,
                     "flop_per_s": apps * FLOPS.get(op, 1),
                     "issues_per_s": apps * instr if instr else None})
    add = next((r["ops_per_s"] for r in rows if r["op"] == "add"), None)
    for r in rows:
        r["vs_add"] = add / r["ops_per_s"] if add else None
    return rows


def summary(rows) -> Dict[str, object]:
    """The hardware model's readings: the best register-resident issue
    rate, the shared-memory pass rate, the instructions one ``a * c + d``
    takes under -fmad=false, and the per-op costs of ``report._OP_COST``
    in add-equivalents (each op's measured ratio less the counted IR ops
    the probe adds around it: tan's multiply, log's add and select's
    compare; exp's negation is a source modifier, not an instruction).
    abs (measured on a difference, since a chain of abs folds to one) and
    min are reported but, as in the reference, cost 1.
    sinh and cosh are not measured: they keep the reference's rule,
    ``exp`` scaled by its 4 / 1.5."""
    by = {r["op"]: r for r in rows}
    out: Dict[str, object] = {
        "issue_rate": max(r["issues_per_s"] for r in rows
                          if r["issues_per_s"]),
        "smem_pass_rate": by["add_smem"]["ops_per_s"]
        if "add_smem" in by else None,
        "fma_instructions": by["add"]["ops_per_s"] / by["fma"]["ops_per_s"]
        if "fma" in by else None,
    }
    extra = {"tan": 1, "log": 1, "select": 1}
    cost = {}
    for op, key in (("div", "div"), ("sqrt", "sqrt"), ("exp", "exp"),
                    ("sin", "sin"), ("cos", "cos"), ("tan", "tan"),
                    ("tanh", "tanh"), ("log", "log"), ("select", "cond")):
        if op in by:
            cost[key] = round(max(0.0, by[op]["vs_add"] - extra.get(op, 0)),
                              2)
    if "exp" in cost:
        cost["sinh"] = cost["cosh"] = round(cost["exp"] * 4 / 1.5, 2)
    out["op_costs"] = cost
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alu_ceiling", description=__doc__)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--ops", default=None,
                    help="comma-separated subset of OPS (default: all)")
    args = ap.parse_args(argv)
    if not require_cuda("the FP32 ceiling"):
        return 1
    dev = card()
    ops = tuple(args.ops.split(",")) if args.ops else OPS
    with ClockSampler() as clocks:
        rows = measure(ops, trials=args.trials)
    for r in rows:
        issue = (f"{r['issues_per_s'] / 1e12:7.3f} Tissue/s"
                 if r["issues_per_s"] else " " * 16)
        print(f"{r['op']:10s} {r['ops_per_s'] / 1e12:7.3f} Top/s "
              f"{r['flop_per_s'] / 1e12:7.3f} Tflop/s {issue} "
              f"{r['vs_add']:7.2f} x add", flush=True)
    s = summary(rows) if "add" in ops else {}
    if s.get("fma_instructions"):
        print(f"a * c + d under -fmad=false: "
              f"{s['fma_instructions']:.2f} add-times (instructions) | "
              f"issue ceiling {s['issue_rate'] / 1e12:.3f} Tissue/s | "
              f"{dev['name']}, {dev['power_limit_w']} W | "
              f"{clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "elements": elements(),
                      "unroll": UNROLL, "ops": rows, **s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

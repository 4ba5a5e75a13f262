"""The typed emitter's native bf16 / f16 operations, checked over every
operand pair.

    python -m stencilflow_tpu_torch.probes.narrow_ops

Programs typed bfloat16 or float16 keep their values in 2 bytes on the
card (``backend/codegen.py``, ``StageEmitter``): a same-type ``+ - *`` is
``add.rn.bf16`` / ``sub.rn.bf16`` / ``mul.rn.bf16`` (``sf_bf_add``, ...) or
``add.rn.f16`` / ``sub.rn.f16`` / ``mul.rn.f16`` (``sf_h_add``, ...),
where the float path computed in float32 and rounded once.  The two are
one function: a float32 result rounded again to a format of p bits is the
correctly rounded result whenever 24 >= 2p + 2 (Figueroa, "When is double
rounding innocuous?", 1995), and bf16 has p = 8, f16 p = 11.  The kernel
``csrc/probes/narrow_ops.cu`` (behind the generated sources' own narrow
macros) holds each instruction to that float path over all 2^32 operand
pairs of each of the six operations, as bit patterns, NaNs included, and
counts the mismatches (``mismatches``; ``launches`` counts its launches).

Its plain version (``narrow_ops_plain``, numpy, any rows of first
operands) checks the theorem's other side on the host: the float path
against the correctly rounded result (the float64 operation, exact or
innocuously rounded at 53 bits, rounded once to the narrow type: to
float32 by round-to-odd then to bf16, or numpy's float64 -> float16),
NaN results by their NaN-ness (the host's NaN bits are the host's).
It replaces no TPU kernel.  Bound by the float path's conversions: 2^32
x 6 of them at 16 a clock per SM (``bound_ms``).  The last line is a
JSON object with the counts, the first mismatches found, the ms of the
sweep, its bound and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..dtypes import _bf16_bits
from . import card, require_cuda

OPS = ("bf16 add", "bf16 sub", "bf16 mul", "f16 add", "f16 sub", "f16 mul")
ROWS = 1 << 16
launches = 0

_ARGS = (ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p)


def source() -> str:
    """The kernel's translation unit: the generated sources' prelude and
    narrow macros, then ``csrc/probes/narrow_ops.cu``."""
    from ..backend import codegen
    from . import source as probe_source
    return (codegen.prelude() + codegen._STREAM_MACROS
            + codegen._BF16_MACROS + codegen._HALF_MACROS
            + probe_source("narrow_ops"))


def _lib() -> ctypes.CDLL:
    from ..backend import build
    lib = build.load_library(source(), "probe_narrow_ops")
    lib.sf_narrow_ops.argtypes = list(_ARGS)
    lib.sf_narrow_ops.restype = ctypes.c_int
    return lib


def mismatches(a0: int = 0, rows: int = ROWS, device="cuda"
               ) -> Tuple[Dict[str, int], List[tuple]]:
    """({operation: mismatches}, first mismatches as (operation, a, b or
    None, native bits, float path bits)) over the first operands a0 ..
    a0 + rows - 1 and every second operand: the kernel on a CUDA
    ``device`` (b not recorded), the plain version on the CPU."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return narrow_ops_plain(a0, rows)
    if not (0 <= a0 and a0 + rows <= ROWS):
        raise ValueError(f"rows {a0} .. {a0 + rows} exceed 2^16")
    lib = _lib()
    mism = torch.zeros(len(OPS), dtype=torch.int64, device=device)
    ex = torch.zeros(33, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.sf_narrow_ops(a0, rows, mism.data_ptr(), ex.data_ptr(),
                               stream)
    if rc != 0:
        raise RuntimeError(f"narrow_ops launch failed: CUDA error {rc}")
    launches += 1
    counts = {op: int(n) for op, n in zip(OPS, mism.tolist())}
    e = ex.cpu().numpy().view(np.uint32)
    first = [(OPS[int(e[1 + 2 * n]) >> 16], int(e[1 + 2 * n]) & 0xffff,
              None, int(e[2 + 2 * n]) >> 16, int(e[2 + 2 * n]) & 0xffff)
             for n in range(min(int(e[0]), 16))]
    return counts, first


def _bf16_correct(x64: np.ndarray) -> np.ndarray:
    """uint16 bits of float64 values rounded once to bf16 (to nearest,
    ties to even): round to odd at float32, then to nearest."""
    with np.errstate(over="ignore", invalid="ignore"):
        x32 = x64.astype(np.float32)
        u = x32.view(np.uint32).copy()
        inexact = np.isfinite(x64) & (x32.astype(np.float64) != x64)
        u -= (inexact & (np.abs(x32.astype(np.float64)) > np.abs(x64))
              ).astype(np.uint32)
        u |= inexact.astype(np.uint32)
    return _bf16_bits(u.view(np.float32))


def narrow_ops_plain(a0: int = 0, rows: int = ROWS
                     ) -> Tuple[Dict[str, int], List[tuple]]:
    """``mismatches`` on the host: the float path (the float32 operation
    rounded once) against the correctly rounded result, bits for numbers
    and NaN-ness for NaNs, over first operands a0 .. a0 + rows - 1."""
    b = np.arange(ROWS, dtype=np.uint32)
    counts = {op: 0 for op in OPS}
    first: List[tuple] = []
    for a in range(a0, a0 + rows):
        for half, name in ((False, "bf16"), (True, "f16")):
            if half:
                x = np.full(ROWS, a, np.uint16).view(np.float16)
                y = b.astype(np.uint16).view(np.float16)
            else:
                x = (np.full(ROWS, a, np.uint32) << 16).view(np.float32)
                y = (b << 16).view(np.float32)
            with np.errstate(invalid="ignore"):
                x32, y32 = x.astype(np.float32), y.astype(np.float32)
                x64, y64 = x32.astype(np.float64), y32.astype(np.float64)
            for sym, fn in (("add", np.add), ("sub", np.subtract),
                            ("mul", np.multiply)):
                with np.errstate(all="ignore"):
                    f32, f64 = fn(x32, y32), fn(x64, y64)
                    if half:
                        path = f32.astype(np.float16).view(np.uint16)
                        right = f64.astype(np.float16).view(np.uint16)
                        nan = np.isnan(f32)
                    else:
                        path, right = _bf16_bits(f32), _bf16_correct(f64)
                        nan = np.isnan(f32)
                bad = np.where(nan, ~np.isnan(f64), path != right)
                n = int(bad.sum())
                counts[f"{name} {sym}"] += n
                for i in np.flatnonzero(bad)[:16 - len(first)]:
                    first.append((f"{name} {sym}", a, int(i),
                                  int(right[i]), int(path[i])))
    return counts, first


def bound_ms(rows: int = ROWS) -> float:
    """The sweep's least time: its float path's conversions, 6 a pair,
    at 16 a clock per SM (the CUDA guide's rate for conversions from
    32-bit floats on compute capability 9.0), an eighth of the FP32 rate
    (``config.H100_ALU_OPS``: 128 a clock per SM)."""
    from ..config import H100_ALU_OPS
    return rows * ROWS * len(OPS) / (H100_ALU_OPS / 8) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="narrow_ops", description=__doc__)
    ap.parse_args(argv)
    if not require_cuda("narrow_ops"):
        return 1
    mismatches(0, 1)   # the build and a first launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, first = mismatches()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    total = sum(counts.values())
    print(f"narrow_ops: {ROWS * ROWS} pairs x {len(OPS)} operations in "
          f"{ms:.1f} ms (bound {bound_ms():.1f} ms, conversions), "
          f"mismatches {counts} | {card()}", flush=True)
    print(json.dumps({"mismatches": counts, "first": first, "ms": ms,
                      "bound_ms": bound_ms(), "card": card()}))
    return int(total != 0)


if __name__ == "__main__":
    sys.exit(main())

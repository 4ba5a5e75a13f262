"""P6, memory/compute overlap: does device-memory traffic hide behind ALU
work at the residency the port's kernels run at?

    python -m stencilflow_tpu_torch.probes.dma_overlap [--trials 3]

Port of ``scripts/dma_overlap_probe.py`` (``build`` :55, ``pallas_call``
:56, body ``_kernel`` :35) as the CUDA kernel ``csrc/probes/dma_overlap.cu``
(which also holds P3's ring).  Over a (P, J, K) float32 array:

* ``dep``-N: ``out = x`` multiplied N times in order, by float32(0.9999)
  at even op index and float32(1.0001) at odd; N = 0 is the passthrough;
* ``indep``-N: ``out = x``, and a plane accumulator ``acc = x[p0] * 0.5``
  per chunk of planes (p0 its first plane) that every plane step of the
  chunk multiplies N more times with the same alternation.  The TPU probe
  kept ``acc`` in scratch and wrote it nowhere; on the card a block keeps
  it in registers and writes it to an extra (chunks, J, K) output, so
  nvcc cannot drop the work.  With one chunk it is the TPU's ``acc``.

A block owns a tile of 8 rows x 32 units (float4 units where K % 4 == 0)
and loops over the planes of its chunk (``CHUNK``); ``blocks_per_sm`` 1
or 2 requests shared memory the kernel does not use, to hold residency
at what the spilled stream kernel (1) and the panel kernel (2) run at; 0
lets as many blocks reside as fit.  The sweep: both modes x N in
``NOPS`` x blocks per SM in ``OCCUPANCY`` at 512^3; each case prints ms
(differenced graph replays, output fed back as input), GB/s, its bound
(bytes against N operations per cell), the fractions of P4's copy floor
and P1's issue ceiling, and ``hide`` = ms / ms of the passthrough at the
same residency.  The last line is a JSON object of every case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import (ClockSampler, card, check_cuda, load, occupancy_smem,
               pingpong_ms, require_cuda, roofline, vec_of)

launches = 0

MAIN = (512, 512, 512)
CHUNK = 32
A, B = np.float32(0.9999), np.float32(1.0001)
MODES = ("dep", "indep")
NOPS = (0, 4, 8, 16, 32, 64, 128, 256)
OCCUPANCY = (1, 2, 0)          # blocks per SM; 0: as many as fit

_vp, _int, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_vp,) * 3 + (_int,) * 7 + (_f, _f, _int, _vp)
_OCC_ARGS = (_int,) * 4


def chain_plain(v: torch.Tensor, nops: int) -> torch.Tensor:
    """``v`` multiplied ``nops`` times in order by A (even op index) and B
    (odd), each a float32 multiply."""
    a = torch.tensor(A, device=v.device)
    b = torch.tensor(B, device=v.device)
    for i in range(nops):
        v = v * (a if i % 2 == 0 else b)
    return v


def chunks_of(P: int, chunk: int) -> List[int]:
    """The plane count of each chunk of ``chunk`` planes (the last ragged)."""
    return [min(chunk, P - p0) for p0 in range(0, P, chunk)]


def overlap_plain(x: torch.Tensor, mode: str, nops: int,
                  chunk: int = CHUNK
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain torch version: ``(out, acc)``; ``acc`` is None for
    ``dep``."""
    if mode == "dep":
        return chain_plain(x, nops), None
    counts = chunks_of(x.shape[0], chunk)
    acc = x[::chunk] * torch.tensor(np.float32(0.5), device=x.device)
    full = sum(1 for n in counts if n == chunk)   # all but a ragged last
    parts = []
    for sl, steps in ((slice(0, full), chunk),
                      (slice(full, len(counts)), counts[-1])):
        part = acc[sl]
        for _ in range(steps):
            part = chain_plain(part, nops)
        parts.append(part)
    return x.clone(), torch.cat(parts)


def check_shape(x: torch.Tensor) -> None:
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"the plane probes take a (P, J, K) tensor, got "
                         f"shape {tuple(x.shape)}")


def overlap(x: torch.Tensor, mode: str, nops: int,
            out: Optional[torch.Tensor] = None,
            acc: Optional[torch.Tensor] = None, blocks_per_sm: int = 0
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out, acc)`` of ``mode`` at ``nops`` over a (P, J, K) float32
    tensor, in chunks of ``CHUNK`` planes.  On a CUDA tensor the kernel
    runs with ``blocks_per_sm`` resident blocks (0: as many as fit); on a
    CPU tensor the plain version runs."""
    if mode not in MODES or nops < 0:
        raise ValueError(f"bad overlap case: mode {mode!r}, nops {nops}")
    check_shape(x)
    chunk = CHUNK
    P, J, K = x.shape
    if out is None:
        out = torch.empty_like(x)
    if mode == "indep" and acc is None:
        acc = torch.empty((len(chunks_of(P, chunk)), J, K),
                          dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        got, got_acc = overlap_plain(x, mode, nops, chunk)
        out.copy_(got)
        if got_acc is not None:
            acc.copy_(got_acc)
        return out, (acc if mode == "indep" else None)
    check_cuda(x)
    check_cuda(out)
    if mode == "indep":
        check_cuda(acc)
        if acc.shape != (len(chunks_of(P, chunk)), J, K):
            raise ValueError(f"acc must be (chunks, J, K), got "
                             f"{tuple(acc.shape)}")
    if out.shape != x.shape:
        raise ValueError("out must match x in shape")
    vec = vec_of(K, x, out, *([acc] if mode == "indep" else []))
    lib = load("dma_overlap", "sf_dma_overlap_launch", _ARGS)
    with torch.cuda.device(x.device):
        rc = lib.sf_dma_overlap_launch(
            x.data_ptr(), out.data_ptr(),
            acc.data_ptr() if mode == "indep" else None, P, J, K, chunk,
            MODES.index(mode), vec, nops, float(A), float(B),
            occupancy_smem(blocks_per_sm),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dma_overlap kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return out, (acc if mode == "indep" else None)


def occupancy(kind: int, vec: int, slots: int, smem: int) -> int:
    """Resident blocks per SM of the kernel ``kind`` (0 dep, 1 indep, 2
    P3's ring of ``slots``) with ``smem`` bytes of dynamic shared memory,
    from the CUDA occupancy calculator."""
    lib = load("dma_overlap", "sf_dma_overlap_occupancy", _OCC_ARGS)
    n = lib.sf_dma_overlap_occupancy(kind, vec, slots, smem)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def work(shape, mode: str, nops: int, chunk: int = CHUNK
         ) -> Tuple[float, float]:
    """(bytes, operations) of one application: x read and out written
    once (and acc written, for indep); N multiplies per cell."""
    P, J, K = shape
    cells = P * J * K
    extra = len(chunks_of(P, chunk)) * J * K if mode == "indep" else 0
    return 8.0 * cells + 4.0 * extra, float(nops) * cells


def measure(trials: int = 3) -> List[Dict[str, object]]:
    """Every (mode, N, blocks per SM) case at ``MAIN`` on the card: the
    kernel first checked against its plain version (bit-exact at N = 16),
    then timed from graphs, output fed back as input."""
    shape = MAIN
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.rand(shape, device="cuda", generator=gen) * 0.5 + 0.5
    b = torch.empty_like(a)
    acc = torch.empty((len(chunks_of(shape[0], CHUNK)),) + shape[1:],
                      device="cuda")
    for mode in MODES:
        got = overlap(a, mode, 16, b, acc)
        want = overlap_plain(a, mode, 16)
        if not torch.equal(got[0], want[0]) or (
                mode == "indep" and not torch.equal(got[1], want[1])):
            raise RuntimeError(f"dma_overlap {mode}-16 differs from its "
                               f"plain version")
    rows = []
    vec = vec_of(shape[2], a, b, acc)
    for bps in OCCUPANCY:
        for mode in MODES:
            for n in NOPS:
                ms = pingpong_ms(
                    lambda s, d: overlap(s, mode, n, d, acc,
                                         blocks_per_sm=bps), a, b, trials)
                nbytes, ops = work(shape, mode, n)
                rows.append({
                    "mode": mode, "nops": n, "blocks_per_sm": bps,
                    "resident": occupancy(MODES.index(mode), vec, 0,
                                          occupancy_smem(bps)),
                    "ms": ms, "gb_s": nbytes / ms / 1e6,
                    **roofline(nbytes, ops, ms)})
    base = {r["blocks_per_sm"]: r["ms"] for r in rows
            if r["mode"] == "dep" and r["nops"] == 0}
    for r in rows:
        r["hide"] = r["ms"] / base[r["blocks_per_sm"]] if base else None
    del a, b, acc
    torch.cuda.empty_cache()
    return rows


def leave_points(rows, tol: float = 0.05) -> Dict[str, Optional[int]]:
    """Per mode and residency, the least N whose time exceeds the
    passthrough's (dep-0 at that residency) by more than ``tol``."""
    out = {}
    for r in rows:
        key = f"{r['mode']} {r['blocks_per_sm'] or 'full'}/SM"
        out.setdefault(key, None)
        if r.get("hide") is not None and r["hide"] > 1 + tol and (
                out[key] is None or r["nops"] < out[key]):
            out[key] = r["nops"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dma_overlap", description=__doc__)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    if not require_cuda("the overlap probe"):
        return 1
    dev = card()
    with ClockSampler() as clocks:
        rows = measure(trials=args.trials)
    for r in rows:
        print(f"{r['mode']:5s} N={r['nops']:3d} {r['blocks_per_sm'] or 'full'}"
              f"/SM (resident {r['resident']}): {r['ms']:.4f} ms "
              f"{r['gb_s']:7.1f} GB/s hide {r['hide']:.3f} bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) vs_bound "
              f"{r['vs_bound']:.3f} vs_copy_floor {r['vs_copy_floor']:.3f} "
              f"vs_alu_issue {r['vs_alu_issue']:.3f}", flush=True)
    leave = leave_points(rows)
    print(f"first N more than 5 % above the passthrough: {leave} | "
          f"{dev['name']}, {dev['power_limit_w']} W | {clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "shape": list(MAIN), "chunk": CHUNK, "cases": rows,
                      "leave_passthrough": leave}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

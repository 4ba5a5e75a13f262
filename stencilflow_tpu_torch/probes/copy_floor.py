"""P4, the copy floor: ``out = in`` over (planes, J, K) float32 on the card.

    python -m stencilflow_tpu_torch.probes.copy_floor [--trials 5]
    python -m stencilflow_tpu_torch.probes.copy_floor --versus-copy 3

Port of ``scripts/dma_matrix_probe.py`` (``build`` :29, ``pallas_call``
:36) as the CUDA kernel ``csrc/probes/copy.cu``.  The TPU swept block
planes per grid step, grid semantics, the VMEM limit and the plane shape;
on the H100 the sweep (``CASES``) is bytes per thread per access (4 B or
16 B), threads per block, blocks per SM in a grid-stride loop against one
(plane, row tile) per block, the plane shape at equal bytes (512² and
256²), and a size beyond the 50 MB L2 against one that fits.  Each case
prints GB/s moved (bytes read plus bytes written over the kernel's time:
two launch counts, each captured in a CUDA graph, differenced, best of
trials, so the host's cost per launch drops out); the best sustained rate
beyond L2 is ``config.H100_COPY_FLOOR``, the report's ``vs_copy_floor``.
The last line is a JSON object of every case.  ``--versus-copy N`` times
the configuration the port launches against ``copy_`` instead, in turns
within each of N sessions (``versus_copy``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Optional

import torch

from ..config import H100_L2_BYTES
from . import (ClockSampler, card, check_cuda, differenced_ms, load,
               require_cuda, sm_count)

launches = 0

# (label, shape, mode, vec, threads, blocks per SM (flat) or rows (tile))
BIG, WIDE, FITS = (512, 512, 512), (2048, 256, 256), (16, 512, 512)
CASES = [
    ("flat f32 256t 8/SM", BIG, "flat", 1, 256, 8),
    ("flat f4 256t 8/SM", BIG, "flat", 4, 256, 8),
    ("flat f4 128t 16/SM", BIG, "flat", 4, 128, 16),
    ("flat f4 512t 4/SM", BIG, "flat", 4, 512, 4),
    ("flat f4 1024t 2/SM", BIG, "flat", 4, 1024, 2),
    ("flat f4 256t 1/SM", BIG, "flat", 4, 256, 1),
    ("flat f4 256t 2/SM", BIG, "flat", 4, 256, 2),
    ("flat f4 256t 32/SM", BIG, "flat", 4, 256, 32),
    ("tile f32 256t 1 row", BIG, "tile", 1, 256, 1),
    ("tile f4 128t 1 row", BIG, "tile", 4, 128, 1),
    ("tile f4 256t 4 rows", BIG, "tile", 4, 256, 4),
    ("tile f4 64t 1 row 256^2", WIDE, "tile", 4, 64, 1),
    ("tile f4 256t 4 rows 256^2", WIDE, "tile", 4, 256, 4),
    ("flat f4 256t 8/SM 256^2", WIDE, "flat", 4, 256, 8),
    ("flat f4 256t 8/SM in L2", FITS, "flat", 4, 256, 8),
    ("tile f4 256t 4 rows in L2", FITS, "tile", 4, 256, 4),
]
# the configuration that P7 and phase 6 of chip_smoke.py launch: the
# fastest beyond L2 at 512^2 and 256^2 planes alike on an NVIDIA H100 80GB
# HBM3, 700.00 W (3015 and 3031 GB/s; the flat grid-stride loop 2844)
DEFAULT = dict(mode="tile", vec=4, threads=256, grid=4)

_vp, _int = ctypes.c_void_p, ctypes.c_int
_ARGS = (_vp, _vp) + (_int,) * 7 + (_vp,)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain torch version: a copy of ``x``."""
    return x.clone()


def copy(x: torch.Tensor, out: Optional[torch.Tensor] = None,
         mode: str = DEFAULT["mode"], vec: int = DEFAULT["vec"],
         threads: int = DEFAULT["threads"],
         grid: int = DEFAULT["grid"]) -> torch.Tensor:
    """``out = x`` for a (planes, J, K) float32 tensor.  On a CUDA tensor
    the kernel runs with ``threads`` per block: ``mode`` "flat" in a
    grid-stride loop of ``grid`` blocks per SM, "tile" with ``grid`` rows
    per block; ``vec`` 4 moves float4s.  On a CPU tensor the plain
    version runs."""
    if x.dim() != 3:
        raise ValueError(f"copy takes a (planes, J, K) tensor, got "
                         f"shape {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.device != x.device:
        raise ValueError("out must match x in shape and device")
    if x.device.type == "cpu":
        out.copy_(copy_plain(x))
        return out
    check_cuda(x)
    check_cuda(out)
    if mode not in ("flat", "tile") or vec not in (1, 4) or grid < 1:
        raise ValueError(f"bad copy configuration: mode {mode!r}, vec "
                         f"{vec}, grid {grid}")
    P, J, K = x.shape
    if vec == 4 and ((mode == "tile" and K % 4) or x.data_ptr() % 16
                     or out.data_ptr() % 16):
        raise ValueError("float4 copies need 16-byte aligned rows")
    lib = load("copy", "sf_copy_launch", _ARGS)
    with torch.cuda.device(x.device):
        blocks = grid * sm_count() if mode == "flat" else grid
        rc = lib.sf_copy_launch(
            x.data_ptr(), out.data_ptr(), P, J, K, int(mode == "tile"), vec,
            threads, blocks, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def gbs(shape, ms: float) -> float:
    """GB/s moved by one copy of ``shape`` in ``ms``: read plus write."""
    P, J, K = shape
    return 8.0 * P * J * K / ms / 1e6


def measure(cases=CASES, trials: int = 5) -> List[Dict[str, object]]:
    """Every case on the card: ms per copy (graphs of 2 and 10 launches
    differenced, best of ``trials``) and GB/s moved."""
    rows, bufs = [], {}
    for label, shape, mode, vec, threads, grid in cases:
        if shape not in bufs:
            bufs.clear()
            torch.cuda.empty_cache()
            gen = torch.Generator("cuda").manual_seed(0)
            x = torch.rand(shape, device="cuda", generator=gen)
            bufs[shape] = (x, torch.empty_like(x))
        x, y = bufs[shape]

        def run(n):
            for _ in range(n):
                copy(x, y, mode, vec, threads, grid)
        ms = differenced_ms(run, 2, 10, trials, graph=True)
        if not torch.equal(x, y):
            raise RuntimeError(f"copy case {label!r}: out differs from in")
        rows.append({"case": label, "shape": list(shape), "mode": mode,
                     "vec": vec, "threads": threads, "grid": grid,
                     "ms": ms, "gb_s": gbs(shape, ms),
                     "fits_l2": 8 * x.numel() <= H100_L2_BYTES})
    bufs.clear()
    torch.cuda.empty_cache()
    return rows


def versus_copy(sessions: int = 3,
                trials: int = 5) -> List[Dict[str, object]]:
    """P4's ``DEFAULT`` configuration against ``copy_`` on the same 512^3
    float32 buffers, in turns (P4, ``copy_``, ``copy_``, P4) in each of
    ``sessions`` sessions; each reading is ``differenced_ms`` of graphs of
    2 and 10 copies, best of ``trials``.  Per session: both readings of
    each and P4's mean over ``copy_``'s."""
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.rand(BIG, device="cuda", generator=gen)
    y = torch.empty_like(x)

    def p4(n):
        for _ in range(n):
            copy(x, y)

    def lib(n):
        for _ in range(n):
            y.copy_(x)
    rows = []
    for s in range(sessions):
        got = [differenced_ms(fn, 2, 10, trials, graph=True)
               for fn in (p4, lib, lib, p4)]
        if not torch.equal(x, y):
            raise RuntimeError("copy: out differs from in")
        p4_ms, lib_ms = (got[0] + got[3]) / 2, (got[1] + got[2]) / 2
        rows.append({"session": s, "p4_ms": [got[0], got[3]],
                     "copy_ms": [got[1], got[2]], "ratio": p4_ms / lib_ms})
    return rows


def floor(rows) -> Dict[str, object]:
    """The best sustained case that does not fit the L2."""
    return max((r for r in rows if not r["fits_l2"]),
               key=lambda r: r["gb_s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="copy_floor", description=__doc__)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--versus-copy", type=int, default=0, metavar="N",
                    help="time P4 against copy_ in turns over N sessions "
                         "instead of the sweep")
    args = ap.parse_args(argv)
    if not require_cuda("the copy floor"):
        return 1
    dev = card()
    if args.versus_copy:
        with ClockSampler() as clocks:
            rows = versus_copy(args.versus_copy, args.trials)
        for r in rows:
            print(f"session {r['session']}: P4 {r['p4_ms'][0]:.4f} "
                  f"{r['p4_ms'][1]:.4f} ms, copy_ {r['copy_ms'][0]:.4f} "
                  f"{r['copy_ms'][1]:.4f} ms, P4 / copy_ {r['ratio']:.4f}",
                  flush=True)
        print(f"{dev['name']}, {dev['power_limit_w']} W | "
              f"{clocks.summary()}")
        print(json.dumps({"device": dev, "clocks": clocks.summary(),
                          "versus_copy": rows}))
        return 0
    with ClockSampler() as clocks:
        rows = measure(trials=args.trials)
    for r in rows:
        print(f"{r['case']:28s} {str(tuple(r['shape'])):18s} "
              f"{r['ms']:.4f} ms {r['gb_s']:8.1f} GB/s"
              f"{' (fits L2)' if r['fits_l2'] else ''}", flush=True)
    best = floor(rows)
    print(f"copy floor: {best['gb_s']:.1f} GB/s ({best['case']}) | "
          f"{dev['name']}, {dev['power_limit_w']} W | {clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "cases": rows,
                      "copy_floor_bytes_per_s": best["gb_s"] * 1e9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

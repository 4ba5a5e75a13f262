"""P5, the stateless overlapped panel, beside the port's overlap kernel.

    python -m stencilflow_tpu_torch.probes.stateless_panel [--trials 3]

Port of ``scripts/stateless_panel_probe.py`` (``build`` :73,
``pallas_call`` :82, body ``_kernel`` :63, stage ``_stage`` :42) as the
CUDA kernel ``csrc/probes/stateless_panel.cu``: two stages of the 7-point
jacobi ``(c + i+ + i- + j+ + j- + k+ + k-) * float32(1/7)``, in that order,
constant-0 boundary on all six faces (the script's ``reference``).  A
block owns an output box of B planes x (TJ, TK), reads its input window
straight from global memory (no staging copy, the TPU probe's "no ingest
copy"), keeps stage 1 in shared memory and writes stage 2.  ``walk``:
``box`` is one box per block; ``persist1`` / ``persist2`` are 1 or 2
blocks per SM striding over the boxes, the counterpart of the TPU's
``parallel`` / ``arbitrary`` grid.

The same chain, written as a StencilFlow program (``program_spec``: two
stages, the same expression in the same order, constant 0.0 boundaries),
runs through the port's overlap lowering (K2, ``compile_chain_overlap``)
on the same inputs; the two agree bit for bit (the literal
0.14285714285714285 rounds to float32(1/7)).  The sweep: B in ``BLOCKS``
x (TJ, TK) in ``TILES`` x ``WALKS`` at 512^3, each case ms (differenced
graph replays, output fed back as input), its bound (8 B per cell) and
its time over K2's; then K2, timed the same way (``k2_ms``), and two
chained ``F.conv3d`` with the 7-point star (TF32 off) as the library
yardstick.  The last line is a
JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import (ClockSampler, card, check_cuda, differenced_ms, load,
               pingpong_ms, require_cuda, roofline, sm_count)

launches = 0

C7 = np.float32(1 / 7)
MAIN = (512, 512, 512)
BLOCKS = (4, 8, 16)
TILES = ((8, 32), (16, 32), (16, 64), (32, 32))
TKS = (16, 32, 64)                # the TK the source builds
WALKS = ("box", "persist1", "persist2")
PERSIST_CHECKS = 3                # checks of each persistent walk
# the fastest case of the sweep on an NVIDIA H100 80GB HBM3 at 700 W
# (1.037 ms, K2 1.222 ms, both from graph replays): the case chip_smoke.py
# times
DEFAULT = dict(B=8, tile=(16, 64), walk="box")
STAR = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
        (0, 0, -1))
TERMS = ("[i,j,k]", "[i+1,j,k]", "[i-1,j,k]", "[i,j+1,k]", "[i,j-1,k]",
         "[i,j,k+1]", "[i,j,k-1]")   # STAR as the program reads it

_vp, _int, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_vp, _vp) + (_int,) * 7 + (_f, _vp)
_OCC_ARGS = (_int,) * 3


def stage_plain(a: torch.Tensor) -> torch.Tensor:
    """One stage over the whole domain, 0 outside it, in the kernel's
    order of adds."""
    z = F.pad(a, (1, 1, 1, 1, 1, 1))
    c = a
    ip, im = z[2:, 1:-1, 1:-1], z[:-2, 1:-1, 1:-1]
    jp, jm = z[1:-1, 2:, 1:-1], z[1:-1, :-2, 1:-1]
    kp, km = z[1:-1, 1:-1, 2:], z[1:-1, 1:-1, :-2]
    return (c + ip + im + jp + jm + kp + km) * torch.tensor(C7,
                                                            device=a.device)


def panel_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain torch version: both stages."""
    return stage_plain(stage_plain(x))


def smem_bytes(B: int, tile: Tuple[int, int]) -> int:
    """Shared memory of a block: stage 1 over (B+2, TJ+2, TK+2)."""
    return 4 * (B + 2) * (tile[0] + 2) * (tile[1] + 2)


def grid_of(walk: str) -> int:
    """Blocks of a launch: 0 (one per box) or 1-2 per SM."""
    if walk not in WALKS:
        raise ValueError(f"walk must be one of {WALKS}, got {walk!r}")
    return 0 if walk == "box" else int(walk[-1]) * sm_count()


def panel(x: torch.Tensor, out: Optional[torch.Tensor] = None,
          B: int = DEFAULT["B"], tile: Tuple[int, int] = DEFAULT["tile"],
          walk: str = DEFAULT["walk"]) -> torch.Tensor:
    """Both stages over an (I, J, K) float32 tensor.  On a CUDA tensor the
    kernel runs with boxes of B planes x ``tile`` and ``walk``; on a CPU
    tensor the plain version runs."""
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"the panel takes an (I, J, K) tensor, got shape "
                         f"{tuple(x.shape)}")
    if B < 1 or tile[0] < 1 or tile[1] not in TKS or walk not in WALKS:
        raise ValueError(f"bad panel case: B {B}, tile {tile}, walk "
                         f"{walk!r} (TK in {TKS})")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError("out must match x in shape")
    if x.device.type == "cpu":
        out.copy_(panel_plain(x))
        return out
    check_cuda(x)
    check_cuda(out)
    I, J, K = x.shape
    lib = load("stateless_panel", "sf_stateless_panel_launch", _ARGS)
    with torch.cuda.device(x.device):
        rc = lib.sf_stateless_panel_launch(
            x.data_ptr(), out.data_ptr(), I, J, K, B, tile[0], tile[1],
            grid_of(walk), float(C7), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stateless_panel kernel launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def occupancy(B: int, tile: Tuple[int, int]) -> int:
    """Resident blocks per SM at boxes of B x ``tile``."""
    lib = load("stateless_panel", "sf_stateless_panel_occupancy", _OCC_ARGS)
    n = lib.sf_stateless_panel_occupancy(B, tile[0], tile[1])
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def program_spec(shape=MAIN) -> Dict[str, object]:
    """The chain as a StencilFlow program: two stages of the 7-point
    jacobi in the kernel's order, constant 0.0 boundaries."""
    def stage(name, src):
        terms = " + ".join(src + t for t in TERMS)
        return {"computation_string":
                f"{name} = ({terms}) * {float(1 / 7)!r}",
                "boundary_conditions": {src: {"type": "constant",
                                              "value": 0.0}},
                "data_type": "float32"}
    return {"inputs": {"a": {"data": "random:0.5,1.0",
                             "data_type": "float32"}},
            "outputs": ["s2"], "dimensions": list(shape),
            "program": {"s1": stage("s1", "a"), "s2": stage("s2", "s1")}}


def program(shape=MAIN):
    """``program_spec(shape)`` parsed."""
    from ..frontend.parser import parse_program
    return parse_program(program_spec(shape), name="jacobi3d_7pt_2")


def overlap_k2(shape=MAIN, device="cuda"):
    """The port's overlap lowering (K2) of ``program(shape)``: ``fn(x) ->
    out`` on ``device``, with its plan as ``fn.plan``."""
    from ..backend.overlap import compile_chain_overlap
    fwd = compile_chain_overlap(program(shape), device=device)

    def fn(x):
        return fwd({"a": x})["s2"]
    fn.plan = fwd.plan
    return fn


def k2_ms(k2, x: torch.Tensor, trials: int = 3) -> float:
    """Milliseconds per call of ``k2`` (``overlap_k2``) timed as the panel
    is: differenced graph replays of 2 and 10 calls, each fed the last
    one's output."""
    def run(n):
        y = x
        for _ in range(n):
            y = k2(y)
    return differenced_ms(run, 2, 10, trials, graph=True)


def library_ms(x: torch.Tensor, trials: int = 3) -> float:
    """Two chained ``F.conv3d`` with the 7-point star of weight 1/7 (TF32
    off): the library yardstick, timed only."""
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 3, 3, 3), device=x.device)
    for o in STAR:
        w[(0, 0) + tuple(d + 1 for d in o)] = float(C7)
    v = x[None, None]

    def run(n):
        for _ in range(n):
            F.conv3d(F.conv3d(v, w, padding=1), w, padding=1)
    return differenced_ms(run, 1, 3, trials)


def measure(trials: int = 3) -> Dict[str, object]:
    """Every (B, tile, walk) case at ``MAIN`` on the card: all checked bit
    for bit against the plain version, and K2 on the same input, before
    any is timed (the timing feeds outputs back as inputs); then the
    times, K2's and the library yardstick's."""
    shape = MAIN
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.rand(shape, device="cuda", generator=gen) * 0.5 + 0.5
    want = panel_plain(x)
    sweep = [(B, t, w) for B in BLOCKS for t in TILES for w in WALKS]
    for B, tile, walk in sweep:
        # a persistent block reuses its shared memory box after box, where
        # a race would show only now and then: those walks run thrice
        for _ in range(1 if walk == "box" else PERSIST_CHECKS):
            if not torch.equal(panel(x, None, B, tile, walk), want):
                raise RuntimeError(f"stateless_panel B={B} {tile} {walk} "
                                   f"differs from its plain version")
    k2 = overlap_k2(shape)
    k2_equal = bool(torch.equal(k2(x), want))
    if not k2_equal:
        raise RuntimeError("K2 on the shared program differs from the "
                           "stateless panel's plain version")
    del want
    a, b = x.clone(), torch.empty_like(x)
    nbytes, ops = 8.0 * x.numel(), 14.0 * x.numel()
    rows = []
    for B, tile, walk in sweep:
        ms = pingpong_ms(lambda s, d: panel(s, d, B, tile, walk), a, b,
                         trials)
        rows.append({"B": B, "tile": list(tile), "walk": walk,
                     "smem": smem_bytes(B, tile),
                     "resident": occupancy(B, tile), "ms": ms,
                     **roofline(nbytes, ops, ms)})

    k2_t = k2_ms(k2, x, trials)
    for r in rows:
        r["vs_k2"] = r["ms"] / k2_t
    lib = library_ms(x, trials)
    del a, b, x
    torch.cuda.empty_cache()
    return {"cases": rows, "k2": {"ms": k2_t, "tile": list(k2.plan.tile),
                                  "equal": k2_equal,
                                  **roofline(nbytes, ops, k2_t)},
            "library_ms": lib}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stateless_panel", description=__doc__)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    if not require_cuda("the stateless panel probe"):
        return 1
    dev = card()
    with ClockSampler() as clocks:
        res = measure(trials=args.trials)
    for r in res["cases"]:
        print(f"B={r['B']:2d} tile {tuple(r['tile'])} {r['walk']:8s} "
              f"(smem {r['smem']} B, resident {r['resident']}): "
              f"{r['ms']:.4f} ms vs_bound {r['vs_bound']:.3f} vs_k2 "
              f"{r['vs_k2']:.3f}", flush=True)
    best = min(res["cases"], key=lambda r: r["ms"])
    k2 = res["k2"]
    print(f"best B={best['B']} {tuple(best['tile'])} {best['walk']} "
          f"{best['ms']:.4f} ms | K2 tile {tuple(k2['tile'])} "
          f"{k2['ms']:.4f} ms (vs_bound {k2['vs_bound']:.3f}, equal "
          f"{k2['equal']}) | 2 x F.conv3d {res['library_ms']:.4f} ms | "
          f"{dev['name']}, {dev['power_limit_w']} W | {clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(),
                      "shape": list(MAIN), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

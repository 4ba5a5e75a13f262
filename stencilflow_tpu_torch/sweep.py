"""Tile sweep of the stream kernel on the card.

    python -m stencilflow_tpu_torch.sweep            # box-r2 and cross-r2, 256^3 x 8

Builds the stream kernel at every (tj, tk) tile whose shared memory fits
(one nvcc per tile, all started together), times each on the same random
inputs with CUDA events (one warm-up, then 2 launches), and prints the
tiles fastest first beside the planner's pick, its modelled cost inputs
and the card's ``nvidia-smi`` name and power limit.  It is how the stream
planner's tile cost (``stream._tile_cost``) was checked; it needs a CUDA
device.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from . import ChainAnalysis, load_input_arrays, parse_program
from .backend import build, panel, stream
from .backend.stacked_io import spanned_arrays
from .synthesize import synthesize_stencil


def _time_ms(fn, reps: int) -> float:
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


def sweep(program, reps: int = 2):
    """[(ms, plan)] for every tile that fits, fastest first, and the
    planner's own plan."""
    analysis = ChainAnalysis.run(program)
    pick = stream.plan_stream(program, analysis)
    plans = []
    for tile in panel.tile_candidates(program.dimensions):
        try:
            plans.append(stream.plan_stream(program, analysis, tile=tile))
        except ValueError:
            continue    # shared memory
    libs = build.load_libraries([(stream.stream_source(p), "stream")
                                 for p in plans])
    arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                            device="cuda")
    rows = [(_time_ms(lambda: stream.run_stream(p, arrays, lib), reps), p)
            for p, lib in zip(plans, libs)]
    return sorted(rows, key=lambda r: r[0]), pick


def main() -> int:
    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for shape in ("box", "cross"):
        program = parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape=shape, extent=2,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_256_8itr")
        t0 = time.perf_counter()
        rows, pick = sweep(program)
        print(f"{program.name}: {len(rows)} tiles fit, built and timed in "
              f"{time.perf_counter() - t0:.1f}s; planner pick {pick.tile} "
              f"| {smi}", flush=True)
        for ms, p in rows:
            mark = " <- planner" if p.tile == pick.tile else ""
            print(f"  tile {p.tile}: {ms:.3f} ms, smem {p.smem_bytes()} B, "
                  f"grid {p.grid()}, modelled work {p.work()}{mark}",
                  flush=True)
        del rows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

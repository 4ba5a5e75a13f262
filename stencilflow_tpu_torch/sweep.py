"""Tile sweep of the stream, group, overlap, tile and panel kernels on
the card.

    python -m stencilflow_tpu_torch.sweep            # every cell below
    python -m stencilflow_tpu_torch.sweep jacobi2d   # named cells only
    python -m stencilflow_tpu_torch.sweep --reps 5 jacobi2d   # 5 launches each

Cells: box-r2 and cross-r2 256^3 x 8 (the stream kernel's on-chip body,
K3a/K3b: every tile at 256 and at 512 threads a block, each printing the
tile rule's modelled time, ``StreamPlan.seconds``, its resident blocks
per SM, packed and unpacked shared memory and stage evaluations a cell;
``box_fma``, ``box_mma``, ``cross_fma``, ``cross_mma``: the same with
every band pass on CUDA cores or on tensor cores),
``chunk``: K4 on the middle chunk of jacobi3d 1024^3 x 8 at 8 chunks (the
same, on random slabs), jacobi2d and hotspot2d 8192^2 x 8 rotated to
rows (group, K5, g = 8, B = 64: every tile at 256 and 512 threads and
each i-segment count of ``group.SEGMENTS``, printing the plan rule's
modelled time, ``GroupPlan.seconds``, and the resident blocks per SM the
card reports; after them, the rule's constants fitted to their times,
``fit_group``), ``overlap_jacobi3d2``, ``overlap_hotspot3d2`` and
``overlap_jacobi2d2``: the overlap kernel (K2) on jacobi3d and hotspot3d
512^3 x 2 and jacobi2d 8192^2 x 2 at the plans of ``overlap_sample``
(tile (B, tj, tk) x threads x runs (R, window); after them, the
rule's constants fitted to their times, ``fit_overlap``),
``tile_jacobi3d2`` and ``tile_hdiff3d8``: the
overlapped-tile kernel (K6, the route's mode) on jacobi3d 512^3 x 2 and
hdiff3d 256^3 x 8 at every tile whose buffers fit, the panel cells
jacobi3d 512^3 x 8, hdiff3d and hotspot3d 256^3 x 8 (K1, ``sweep_panel``: every tile at 256 and at
512 threads a block, the rings of one step packed by liveness; each also
prints the tile rule's modelled time, ``PanelPlan.seconds``, the
resident blocks per SM the card reports and the masked share of the
stage evaluations), and the deep 3-D chains jacobi3d 512^3 x 32, hdiff3d
256^3 x 16 and hotspot3d 256^3 x 32 (the stream kernel's spill rung,
K3c: at each tile the planner packs shared memory by liveness and spills
rings until the rest fits; each such tile also prints the rung's
modelled time, ``spill_seconds``, and its resident blocks per SM).
Builds the kernel at every tile whose shared memory fits (one nvcc per
plan, all started together), times each on the same random inputs with
CUDA events (one warm-up, then ``--reps`` launches, 2 by default), and
prints the plans fastest first beside the planner's pick and the card's
``nvidia-smi`` name and power limit.  It is how the planners' tile rules
were checked; it needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from . import ChainAnalysis, load_input_arrays, parse_program
from .backend import (ROWS_GROUP, ROWS_PANEL, build, codegen, group,
                      overlap, panel, stream, tile)
from .backend.stacked_io import spanned_arrays
from .frontend.canonicalize import rotate_2d_to_rows
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


def sweep(program, reps: int = 2, chunk=None, passes: str = "auto"):
    """[(ms, plan)] of the stream kernel for every (tile, threads) that
    fits (the spill rung's tiles at its 256 threads), fastest first, and
    the planner's own plan; plans of another kind than the pick (per-cell
    where the pick is banded) are left out.  ``chunk`` = (block, i-halo)
    sweeps K4, the local plan, on one chunk of random slabs; ``passes``
    forces the band passes' route ("fma" CUDA cores, "mma" tensor
    cores)."""
    analysis = ChainAnalysis.run(program)

    def plan(**kw):
        if chunk:
            return stream.plan_local(program, analysis, *chunk,
                                     passes=passes, **kw)
        return stream.plan_stream(program, analysis, passes=passes, **kw)
    pick = plan()
    plans, seen = [], set()
    for tile in panel.tile_candidates(program.dimensions):
        for threads in panel.PANEL_THREADS:
            try:
                p = plan(tile=tile, threads=threads)
            except ValueError:
                continue    # shared memory
            key = (p.tile, p.threads, p.packed)
            if key in seen or bool(p.mxu_plans) != bool(pick.mxu_plans):
                continue
            seen.add(key)
            plans.append(p)
    libs = build.load_libraries([(stream.stream_source(p), "stream")
                                 for p in plans])
    if chunk:
        gen = torch.Generator(device="cuda").manual_seed(0)
        arrays = {n: torch.rand((pick.extent(),) + program.dimensions[1:],
                                generator=gen, device="cuda")
                  for n in program.inputs}
        origin = program.dimensions[0] // 2 - chunk[1]
    else:
        arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                                device="cuda")
    rows = []
    for p, lib in zip(plans, libs):
        if chunk:
            def run(p=p, lib=lib):
                return stream.run_local_stream(p, origin, arrays, lib)
        else:
            def run(p=p, lib=lib):
                return stream.run_stream(p, arrays, lib)
        p.blocks_per_sm = panel.occupancy(lib) if not p.packed else \
            p.residency()
        rows.append((_time_ms(run, reps), p))
        p.device_pool.clear()   # a spilled plan's buffer
    return sorted(rows, key=lambda r: r[0]), pick


def sweep_group(program, reps: int = 2):
    """``sweep`` for the group kernel (K5) at the rows route's g and B:
    every tile that fits at each thread count of ``panel.PANEL_THREADS``
    and each i-segment count of ``group.SEGMENTS``, fastest first, and
    the planner's own plan."""
    analysis = ChainAnalysis.run(program)
    pick = group.plan_group(program, analysis, ROWS_PANEL, ROWS_GROUP)
    plans, seen = [], set()
    for tile in panel.tile_candidates(program.dimensions):
        for threads in panel.PANEL_THREADS:
            for segments in group.SEGMENTS:
                try:
                    p = group.plan_group(program, analysis, ROWS_PANEL,
                                         ROWS_GROUP, tile, threads, segments)
                except ValueError:
                    continue    # shared memory, or more segments than panels
                if (p.tile, p.threads, p.segments) not in seen:
                    seen.add((p.tile, p.threads, p.segments))
                    plans.append(p)
    libs = build.load_libraries([(codegen.group_source(program, analysis, p),
                                  "group") for p in plans])
    arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                            device="cuda")
    rows = []
    for p, lib in zip(plans, libs):
        p.blocks_per_sm = panel.occupancy(lib)
        rows.append((_time_ms(lambda: group.run_group(
            program, analysis, p, arrays, lib), reps), p))
    return sorted(rows, key=lambda r: r[0]), pick


def fit_group(swept):
    """The group rule's constants fitted to group sweeps: ``swept`` is
    [(program, [(ms, plan)])].  Least squares on log(ms) of ``steps x
    lanes x r x (blocks / (132 r) + tail)`` (r the resident blocks per SM,
    ``GroupPlan.residency``) times one cost per (r, threads) key of
    ``group.GROUP_LANE_COST`` and one factor per program beyond the first,
    over a grid of tails.  Returns (tail, {key: cost relative to two
    blocks of 256}, lane-steps per second per SM of the first program at
    that key): the values of ``group.GROUP_TAIL``, ``GROUP_LANE_COST``
    and ``config.H100_GROUP_CELL_RATE``."""
    import numpy as np
    obs = []
    for n, (program, rows) in enumerate(swept):
        for ms, p in rows:
            r = p.residency(program)
            key = (min(r, 4 if p.threads == 256 else 2), p.threads)
            obs.append((ms, n, key, p.steps(program) * p.lanes(program) * r,
                        p.blocks(program) / (group.H100_SM_COUNT * r)))
    keys = sorted({o[2] for o in obs})
    best = None
    for tail in np.arange(0.0, 1.51, 0.05):
        X = np.array([[float(k == key) for key in keys]
                      + [float(n == m) for m in range(1, len(swept))]
                      for _ms, n, k, _w, _v in obs])
        y = np.array([np.log(ms * 1e-3 / (w * (waves + tail)))
                      for ms, _n, _k, w, waves in obs])
        coef = np.linalg.lstsq(X, y, rcond=None)[0]
        sse = float(((y - X @ coef) ** 2).sum())
        if best is None or sse < best[0]:
            best = (sse, float(tail), dict(zip(keys, np.exp(coef))))
    _sse, tail, cost = best
    ref = cost[(2, 256)]
    return tail, {k: float(v / ref) for k, v in cost.items()}, 1.0 / ref


def overlap_sample(program, analysis, top: int = 24):
    """The overlap plans a sweep times: for each run (R, window) of
    ``overlap.RUNS`` and thread count, the ``top`` plans of least
    modelled time, and the rule's pick."""
    plan = overlap.OverlapPlan.empty(analysis)
    rows = sorted(plan.candidates(program))
    chosen = []
    for run in overlap.RUNS:
        for n in overlap.PANEL_THREADS:
            chosen += [c for c in rows if c[2:5] == (n,) + run][:top]
    chosen.append(rows[0])
    plans, seen = [], set()
    for _cost, t, n, r, w in chosen:
        if (t, n, r, w) not in seen:
            seen.add((t, n, r, w))
            plans.append(overlap.OverlapPlan.build(analysis, t, n, r, w))
    return plans


def sweep_overlap(program, reps: int = 2):
    """``sweep`` for the overlap kernel (K2): the plans of
    ``overlap_sample`` (tile (B, tj, tk) x threads x runs (R, window)),
    fastest first, and the planner's own plan."""
    analysis = ChainAnalysis.run(program)
    pick = overlap.OverlapPlan.build(analysis)
    plans = overlap_sample(program, analysis)
    libs = build.load_libraries([
        (codegen.overlap_source(program, analysis, p), "overlap")
        for p in plans])
    arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                            device="cuda")
    rows = []
    for p, lib in zip(plans, libs):
        p.blocks_per_sm = panel.occupancy(lib)
        rows.append((_time_ms(lambda: overlap.run_overlap(
            program, analysis, p, arrays, lib), reps), p))
    return sorted(rows, key=lambda r: r[0]), pick


def fit_overlap(swept):
    """The overlap rule's constants fitted to overlap sweeps: ``swept``
    is [(program, [(ms, plan)])].  Least squares on log(ms) of ``r x
    (blocks / (132 r) + 1) x (evaluations + loads)`` (r the resident
    blocks per SM, ``OverlapPlan.residency``; the terms of
    ``OverlapPlan.work_terms``) times one cost per (r, threads) key of
    ``overlap.OVERLAP_LANE_COST`` and one per run of ``overlap.RUNS``
    beyond the first (``OVERLAP_RUN_COST``).  Returns ({key: cost
    relative to two blocks of 256}, {run: cost relative to the first},
    evaluations and loads per second per SM at that key, RMS error in log
    time): the values of ``OVERLAP_LANE_COST``, ``OVERLAP_RUN_COST`` and
    ``config.H100_OVERLAP_CELL_RATE``."""
    import numpy as np
    obs = []
    for program, rows in swept:
        for ms, p in rows:
            r = p.residency(program)
            obs.append((ms, (min(r, 4 if p.threads == 256 else 2),
                             p.threads), r * p.waves(program)
                        * sum(p.work_terms(program)), (p.R, p.window)))
    keys = sorted({o[1] for o in obs})
    runs = [run for run in overlap.RUNS[1:] if any(o[-1] == run
                                                    for o in obs)]
    X = np.array([[float(o[1] == key) for key in keys]
                  + [float(o[-1] == run) for run in runs] for o in obs])
    y = np.array([np.log(ms * 1e-3 / work) for ms, _k, work, _run in obs])
    coef = np.linalg.lstsq(X, y, rcond=None)[0]
    sse = float(((y - X @ coef) ** 2).sum())
    cost = dict(zip(keys, np.exp(coef[:len(keys)])))
    run_cost = dict(zip(runs, np.exp(coef[len(keys):])))
    ref = cost.get((2, 256), min(cost.values()))
    run_cost[overlap.RUNS[0]] = 1.0
    return ({k: float(v / ref) for k, v in cost.items()},
            {k: float(v) for k, v in run_cost.items()}, 1.0 / ref,
            (sse / len(obs)) ** 0.5)


def sweep_tile(program, reps: int = 2):
    """``sweep`` for the overlapped-tile kernel (K6) in the route's mode
    (``tile.AUTO_MODE``): every tile of ``tile.tile_candidates`` whose
    buffers fit, fastest first, and the planner's own pick."""
    analysis = ChainAnalysis.run(program)
    mode = tile.AUTO_MODE
    pick = tile.plan_tile(program, analysis, mode=mode)
    plans = []
    for cand in tile.tile_candidates(program.dimensions):
        try:
            plans.append(tile.plan_tile(program, analysis, cand, mode))
        except ValueError:
            continue    # shared memory
    libs = build.load_libraries([(tile.tile_source(p), "tile")
                                 for p in plans])
    arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                            device="cuda")
    rows = []
    for p, lib in zip(plans, libs):
        p.blocks_per_sm = panel.occupancy(lib)
        rows.append((_time_ms(lambda: tile.run_tile(p, arrays, lib), reps),
                     p))
    return sorted(rows, key=lambda r: r[0]), pick


def sweep_panel(program, reps: int = 2):
    """``sweep`` for the panel kernel (K1): every tile whose packed shared
    memory fits, at each thread count of ``panel.PANEL_THREADS``, fastest
    first, and the planner's own plan."""
    analysis = ChainAnalysis.run(program)
    pick = panel.PanelPlan.build(analysis)
    plans = []
    for tile in panel.tile_candidates(program.dimensions):
        for threads in panel.PANEL_THREADS:
            try:
                plans.append(panel.PanelPlan.build(analysis, tile, threads))
            except ValueError:
                continue    # shared memory
    libs = build.load_libraries([(codegen.panel_source(program, analysis, p),
                                  "panel") for p in plans])
    arrays = spanned_arrays(program, load_input_arrays(program, seed=0),
                            device="cuda")
    rows = []
    for p, lib in zip(plans, libs):
        p.blocks_per_sm = panel.occupancy(lib)
        rows.append((_time_ms(lambda: panel.run_panel(
            program, analysis, p, arrays, lib), reps), p))
    return sorted(rows, key=lambda r: r[0]), pick


def sweep_fma(program, reps: int = 2):
    """``sweep`` with every band pass on CUDA cores."""
    return sweep(program, reps, passes="fma")


def sweep_mma(program, reps: int = 2):
    """``sweep`` with every band pass on tensor cores."""
    return sweep(program, reps, passes="mma")


def sweep_chunk(program, reps: int = 2):
    """``sweep`` of K4 on the middle chunk of ``program`` at 8 chunks
    (the out-of-core cell's)."""
    from .backend.dense import chain_halo
    h = chain_halo(ChainAnalysis.run(program))[0]
    return sweep(program, reps, (program.dimensions[0] // 8, h))


def _cells():
    """name: (program, sweep function)."""
    def synth(shape, dims, **kw):
        return synthesize_stencil(num_stages=8, dimensions=dims, shape=shape,
                                  seed_data="random:0.0,1.0", **kw)
    cells = {}
    for shape in ("box", "cross"):
        for route, fn in (("", sweep), ("_fma", sweep_fma),
                          ("_mma", sweep_mma)):
            cells[shape + route] = (parse_program(
                synth(shape, (256,) * 3, extent=2),
                name=f"{shape}3d_256_8itr{route}"), fn)
    cells["chunk"] = (parse_program(synth("diffusion", (1024,) * 3),
                                    name="jacobi3d_1024_8itr"), sweep_chunk)
    for name, shape in (("jacobi2d", "diffusion"), ("hotspot2d", "hotspot")):
        cells[name] = (rotate_2d_to_rows(parse_program(
            synth(shape, (8192, 8192)), name=f"{name}_8192_8itr")),
            sweep_group)
    for name, shape, n in (("jacobi3d8", "diffusion", 512),
                           ("hdiff3d8", "hdiff", 256),
                           ("hotspot3d8", "hotspot", 256)):
        cells[name] = (parse_program(synth(shape, (n,) * 3),
                                     name=f"{name}_{n}"), sweep_panel)
    for name, shape, dims in (("overlap_jacobi3d2", "diffusion", (512,) * 3),
                              ("overlap_hotspot3d2", "hotspot", (512,) * 3),
                              ("overlap_jacobi2d2", "diffusion",
                               (8192, 8192))):
        cells[name] = (parse_program(synthesize_stencil(
            num_stages=2, dimensions=dims, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{name}_{dims[0]}"),
            sweep_overlap)
    for name, shape, n, iters in (("tile_jacobi3d2", "diffusion", 512, 2),
                                  ("tile_hdiff3d8", "hdiff", 256, 8)):
        cells[name] = (parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{name}_{n}"), sweep_tile)
    for name, shape, n, iters in (("jacobi3d32", "diffusion", 512, 32),
                                  ("hdiff3d16", "hdiff", 256, 16),
                                  ("hotspot3d32", "hotspot", 256, 32)):
        cells[name] = (parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{name}_{n}"), sweep)
    return cells


def main() -> int:
    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    args = sys.argv[1:]
    reps = 2
    if "--reps" in args:
        at = args.index("--reps")
        reps = int(args[at + 1])
        del args[at:at + 2]
    cells = _cells()
    names = args or list(cells)
    unknown = [n for n in names if n not in cells]
    if unknown:
        print(f"error: unknown cells {unknown} (choose from {list(cells)})",
              file=sys.stderr)
        return 1
    swept = []
    for name in names:
        program, fn = cells[name]
        t0 = time.perf_counter()
        rows, pick = fn(program, reps)
        if fn in (sweep_group, sweep_overlap):
            swept.append((fn, program, rows))
        print(f"{program.name}: {len(rows)} tiles fit, built and timed in "
              f"{time.perf_counter() - t0:.1f}s; planner pick {pick.tile} "
              f"| {smi}", flush=True)
        for ms, p in rows:
            mark = " <- planner" if p.tile == pick.tile and all(
                getattr(p, k, 0) == getattr(pick, k, 0)
                for k in ("threads", "segments", "R", "window")) \
                else ""
            if fn in (sweep, sweep_fma, sweep_mma, sweep_chunk):
                smem, grid, work = p.smem_bytes(), p.grid(), p.cells()
                if p.packed:
                    mark = (f", modelled {p.spill_seconds() * 1e3:.1f} ms, "
                            f"{p.residency()} blocks per SM, spilled "
                            f"{len(p.spilled)} of {len(p.raw_ring)} rings "
                            f"({p.spill_bytes() / 2 ** 20:.0f} MiB){mark}")
                else:
                    mark = (f", {p.threads} threads, modelled "
                            f"{p.seconds() * 1e3:.2f} ms, {p.blocks_per_sm} "
                            f"blocks per SM, unpacked {p.unpacked_bytes()} "
                            f"B, {p.evaluations():.2f} evaluations a "
                            f"cell{mark}")
            elif fn is sweep_panel:
                smem, grid, work = (p.smem_bytes(program),
                                    p.grid(program.dimensions),
                                    p.lanes(program))
                mark = (f", {p.threads} threads, modelled "
                        f"{p.seconds(program) * 1e3:.2f} ms, "
                        f"{p.blocks_per_sm} blocks per SM, unpacked "
                        f"{p.unpacked_bytes(program)} B, masked share "
                        f"{p.masked_share(program):.3f}{mark}")
            elif fn is sweep_overlap:
                smem, grid, work = (p.smem_bytes(program),
                                    p.grid(program.dimensions),
                                    p.work(program))
                mark = (f", {p.threads} threads, R {p.R}, window "
                        f"{p.window}, modelled "
                        f"{p.seconds(program) * 1e3:.3f} ms, "
                        f"{p.blocks_per_sm} blocks per SM{mark}")
            elif fn is sweep_group:
                smem, grid, work = (p.smem_bytes(program),
                                    p.grid(program.dimensions),
                                    p.lanes(program))
                mark = (f", {p.threads} threads, {p.segments} segments, "
                        f"modelled {p.seconds(program) * 1e3:.3f} ms, "
                        f"{p.blocks_per_sm} blocks per SM{mark}"
                        if hasattr(p, "segments") else mark)
            else:
                smem, grid, work = p.smem_bytes(), p.grid(), p.lanes()
                mark = (f", modelled {p.seconds() * 1e3:.3f} ms, "
                        f"{p.blocks_per_sm} blocks per SM{mark}")
            print(f"  tile {p.tile}: {ms:.3f} ms, smem {smem} B, grid "
                  f"{grid}, modelled work {work}{mark}", flush=True)
        del rows
        torch.cuda.empty_cache()
    groups = [(p, rows) for fn, p, rows in swept if fn is sweep_group]
    if groups:
        tail, cost, rate = fit_group(groups)
        print(f"group rule fitted to {[p.name for p, _ in groups]}: tail "
              f"{tail:.2f}, lane costs "
              f"{ {k: round(v, 3) for k, v in cost.items()} }, rate "
              f"{rate:.4g} lane-steps/s per SM | {smi}", flush=True)
    overlaps = [(p, rows) for fn, p, rows in swept if fn is sweep_overlap]
    if overlaps:
        cost, run_cost, rate, rms = fit_overlap(overlaps)
        print(f"overlap rule fitted to {[p.name for p, _ in overlaps]}: "
              f"lane "
              f"costs { {k: round(v, 3) for k, v in cost.items()} }, run "
              f"costs { {k: round(v, 3) for k, v in run_cost.items()} }, "
              f"rate "
              f"{rate:.4g} evaluations and loads/s per SM, RMS error "
              f"{rms:.3f} in "
              f"log time | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

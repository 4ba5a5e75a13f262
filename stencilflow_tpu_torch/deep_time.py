"""Time the route plans of the stream kernel's deep cells (K3c), of the
panel kernel's cells (K1), of the stream kernel's banded cells (K3b), of
K4's out-of-core chunk, of the group kernel's cells (K5), of the
overlapped-tile kernel's cells (K6), of the overlap kernel's cells (K2),
of the pipeline split (K4 a segment), of autotune's winners or of the
reduced-precision modes beside their f32 routes, for one checkout.

    python stencilflow_tpu_torch/deep_time.py [--root DIR] [--reps N]
        [--cells deep|panel|banded|local|group|tile|overlap|solvers|
                 pipeline|autotune|bf16|narrow]
        [--ptxas]

Imports ``stencilflow_tpu_torch`` from the checkout at ``--root`` (this
file's own checkout by default), so the same file times another commit
of the port on the same card: run it for one commit, then the other,
then the second again and the first again, and compare only within one
such sequence.  ``--cells deep`` (the default): jacobi3d 512^3 x 32,
hdiff3d 256^3 x 16 and hotspot3d 256^3 x 32 on their stream plans
(``plan_stream(..., mxu="off")``).  ``--cells panel``: jacobi3d 512^3 x
8, hdiff3d 256^3 x 8 and hotspot3d 256^3 x 8 on the panel kernel's own
plan (``PanelPlan.build``, their route), then panel forced on cross-r2
256^3 x 8 and on hdiff2d 8192^2 x 16 where the checkout's planner
accepts them.  ``--cells banded``: box-r2 and cross-r2 256^3 x 8 on
their stream plans (``plan_stream``), then, where the checkout's planner
takes ``passes``, each on the other route of its band passes (tensor
cores against CUDA cores).  ``--cells local``: K4 on the middle chunk of
jacobi3d 1024^3 x 8 at 8 chunks (``plan_local``, random slabs).
``--cells group``: jacobi2d and hotspot2d 8192^2 x 8 rotated to rows on
the group kernel's plan at the rows route's B = 64, g = 8
(``plan_group``).  ``--cells tile``: jacobi3d 512^3 x 2 and hdiff3d
256^3 x 8 on the overlapped-tile kernel's plans (``plan_tile``), masked
and fast (the call the checkout makes: a parent's fast mode includes its
torch fix-up of the border shell).  ``--cells solvers``: the time-step
loop eager against its CUDA-graph replay and fused by 1, 2, 4 and 8, and
CG's iteration split into the operator and the vector passes
(``_solvers``).  ``--cells pipeline``: the pipeline split over a mesh
repeating the card in turns with the single-device route
(``_pipeline``).  ``--cells autotune``: ``autotune`` (sweep, 3 trials)
on cross-r2 256^3 x 8, hdiff3d 256^3 x 8 and jacobi2d 8192^2 x 8, each
winner in turns with the route (``_autotune``).  ``--cells bf16``: each
reduced-precision leg of ``chip_smoke.py`` in turns with its cell's f32
plan over three sessions (``_bf16``).  ``--cells narrow``: K1 on
jacobi3d 512^3 x 8 typed bf16 and f16 and K4 on a chunk of jacobi3d
1024^3 x 8 typed bf16, each in turns with the program in f32 over three
sessions, with each kernel's SASS conversions (``_narrow``).
``--cells overlap``:
jacobi3d and
hotspot3d 512^3 x 2 and jacobi2d 8192^2 x 2 (I = 1) on the overlap
kernel's plan (``OverlapPlan.build``, their route), each followed by
the overlapped-tile kernel's fast mode on the same program.  Random
inputs from seed 0.  It builds every kernel at once (one nvcc each),
checks one launch against the dense lowering on the card (bit for bit;
within MXU_VERIFY_RTOL for banded plans; K4 against its plain version),
then times ``--reps`` launches with CUDA events after a warm-up.
``--ptxas`` prints nvcc's ``-Xptxas -v`` report (registers, spills) of
every kernel first.  The last line is one JSON object: the card
(``nvidia-smi`` name and power limit), and per cell the kernel's ms,
tile and shared memory per block (panel and the on-chip stream plans:
packed and unpacked, and the resident blocks per SM the card reports,
where the checkout has them).  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run as a file, this directory comes first on the path: its modules
# (config, data, ...) must not shadow anything
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)


def _deep(sft, synthesize_stencil):
    """[(program, stream plan, source)] of the deep cells."""
    from stencilflow_tpu_torch.backend import stream as st
    out = []
    for shape, n, iters in (("diffusion", 512, 32), ("hdiff", 256, 16),
                            ("hotspot", 256, 32)):
        p = sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_{n}_{iters}itr")
        plan = st.plan_stream(p, mxu="off")
        out.append((p, plan, st.stream_source(plan)))
    return out


def _panel(sft, synthesize_stencil):
    """[(program, panel plan or refusal, source)] of the panel cells."""
    from stencilflow_tpu_torch.backend import codegen
    from stencilflow_tpu_torch.backend import panel as pn
    out = []
    for shape, dims, iters, extent in (
            ("diffusion", (512,) * 3, 8, 1), ("hdiff", (256,) * 3, 8, 1),
            ("hotspot", (256,) * 3, 8, 1), ("cross", (256,) * 3, 8, 2),
            ("hdiff", (8192, 8192), 16, 1)):
        p = sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape, extent=extent,
            seed_data="random:0.0,1.0"),
            name=f"{shape}{len(dims)}d_{dims[0]}_{iters}itr")
        an = sft.ChainAnalysis.run(p)
        try:
            plan = pn.PanelPlan.build(an)
        except ValueError as exc:
            out.append((p, str(exc), None))
            continue
        out.append((p, plan, codegen.panel_source(p, an, plan)))
    return out


def _banded(sft, synthesize_stencil):
    """[(program, stream plan, source)] of the banded cells, and each on
    the other route of its band passes where the checkout has routes."""
    from stencilflow_tpu_torch.backend import stream as st
    out = []
    for shape in ("box", "cross"):
        p = sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape=shape, extent=2,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_256_8itr")
        plan = st.plan_stream(p)
        out.append((p, plan, st.stream_source(plan)))
        if not hasattr(plan, "route"):
            continue   # a checkout without tensor-core passes
        t = plan.tkeys[0]
        other = "fma" if plan.route(t[2] or t[1], "R" if t[2] else "L") \
            == "mma" else "mma"
        q = sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape=shape, extent=2,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_256_8itr_{other}")
        oplan = st.plan_stream(q, passes=other)
        out.append((q, oplan, st.stream_source(oplan)))
    return out


def _local(sft, synthesize_stencil):
    """[(program, K4's plan, source)] of jacobi3d 1024^3 x 8's chunk."""
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import chain_halo
    p = sft.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(1024,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_1024_8itr_chunk")
    an = sft.ChainAnalysis.run(p)
    plan = st.plan_local(p, an, 128, chain_halo(an)[0])
    return [(p, plan, st.stream_source(plan))]


def _group(sft, synthesize_stencil):
    """[(rotated program, group plan, source)] of the 2-D cells."""
    from stencilflow_tpu_torch.backend import codegen
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.frontend.canonicalize import \
        rotate_2d_to_rows
    out = []
    for shape in ("diffusion", "hotspot"):
        p = rotate_2d_to_rows(sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(8192, 8192), shape=shape,
            seed_data="random:0.0,1.0"), name=f"{shape}2d_8192_8itr"))
        an = sft.ChainAnalysis.run(p)
        plan = gp.plan_group(p, an, 64, 8)
        out.append((p, plan, codegen.group_source(p, an, plan)))
    return out


def _tile(sft, synthesize_stencil):
    """[(program, tile plan, source)] of the forced-K6 cells, masked and
    fast."""
    from stencilflow_tpu_torch.backend import tile as tl
    out = []
    for shape, n, iters in (("diffusion", 512, 2), ("hdiff", 256, 8)):
        for mode in ("masked", "fast"):
            p = sft.parse_program(synthesize_stencil(
                num_stages=iters, dimensions=(n,) * 3, shape=shape,
                seed_data="random:0.0,1.0"),
                name=f"{shape}3d_{n}_{iters}itr_{mode}")
            plan = tl.plan_tile(p, mode=mode)
            out.append((p, plan, tl.tile_source(plan)))
    return out


def _overlap(sft, synthesize_stencil):
    """[(program, plan, source)] of the overlap kernel's cells (K2) on the
    checkout's own plan (``OverlapPlan.build``), each followed by the
    overlapped-tile kernel in fast mode (K6) on the same program."""
    from stencilflow_tpu_torch.backend import codegen
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import tile as tl
    out = []
    for shape, dims in (("diffusion", (512,) * 3), ("hotspot", (512,) * 3),
                        ("diffusion", (8192, 8192))):
        for kernel in ("overlap", "tile"):
            p = sft.parse_program(synthesize_stencil(
                num_stages=2, dimensions=dims, shape=shape,
                seed_data="random:0.0,1.0"),
                name=f"{shape}{len(dims)}d_{dims[0]}_2itr_{kernel}")
            if kernel == "overlap":
                an = sft.ChainAnalysis.run(p)
                plan = ov.OverlapPlan.build(an)
                out.append((p, plan, codegen.overlap_source(p, an, plan)))
            else:
                plan = tl.plan_tile(p, mode="fast")
                out.append((p, plan, tl.tile_source(plan)))
    return out


def _solvers(smi: str, reps: int) -> dict:
    """``--cells solvers``: the time-step loop and CG at full width.

    For jacobi3d (one stage) at 512^3 fused by 1, 2, 4 and 8, and at
    64^3 unfused (a step short enough for launches to show): ms a step
    eager (``make_step`` in a Python loop, 64 steps) and replayed from
    the CUDA graph ``iterate`` captures (``GraphLoop``), bit for bit
    equal, beside the step's bound.  For CG on backward-Euler diffusion
    512^3: ms an iteration, the operator's ms, and the vector passes
    (the offset subtraction, two dots, three ``addcmul``s) timed alone
    on the same vectors, beside their bytes over the copy floor."""
    import numpy as np
    import torch
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch import solver_cells as sc
    from stencilflow_tpu_torch.iterate import (GraphLoop,
                                               compose_iterations,
                                               make_step)
    from stencilflow_tpu_torch.report import HardwareModel, Report
    from stencilflow_tpu_torch.synthesize import jacobi

    out = {}
    for size, fuses in ((512, (1, 2, 4, 8)), (64, (1,))):
        base = sft.parse_program(jacobi(3, size, 1),
                                 name=f"jacobi3d_{size}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = torch.rand((size,) * 3, generator=gen, device="cuda")
        for fuse in fuses:
            p = compose_iterations(base, fuse) if fuse > 1 else base
            step, feed = make_step(p, device="cuda")
            n = 64 // fuse
            state = {"a": a}

            def eager():
                s = state
                for _ in range(n):
                    s = step(s)
                return s

            want = eager()["a"]
            loop = GraphLoop(step, {"a": a.clone()}, feed,
                             torch.device("cuda"))
            loop.run(n)
            equal = torch.equal(loop.buffers["a"], want)
            eager_ms = _events(eager, reps) / (n * fuse)
            graph_ms = _events(lambda: loop.run(n), reps) / (n * fuse)
            bound_ms = Report.build(p).roofline_time_s() * 1e3 / fuse
            key = f"{base.name} fuse {fuse}"
            out[key] = {"route": step.backend, "eager_ms": eager_ms,
                        "graph_ms": graph_ms, "bound_ms": bound_ms,
                        "equal": bool(equal)}
            print(f"solvers: {key} ({step.backend}): eager {eager_ms:.4f} "
                  f"ms a step, graph replay {graph_ms:.4f}, bound "
                  f"{bound_ms:.4f}; replay == eager: {equal} | {smi}",
                  flush=True)
            if not equal:
                raise RuntimeError(f"{key}: replay differs from eager")
            del loop, want
            torch.cuda.empty_cache()

    p = sc.implicit_diffusion(512)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rhs = torch.rand((512,) * 3, generator=gen, device="cuda")
    solver = sft.make_solver(p, tol=1e-6)
    solver(rhs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    x, info = solver(rhs)
    stop.record()
    torch.cuda.synchronize()
    iter_ms = start.elapsed_time(stop) / info["iterations"]
    op = solver.operator
    op_ms = _events(lambda: op(x), reps)
    # one iteration's vector passes on the same vectors (solve.py
    # _make_cg_run less the operator's launch)
    r, q, ap, off = rhs.clone(), x.clone(), op(x), rhs.clone()
    rs = torch.dot(r.reshape(-1), r.reshape(-1))

    def passes():
        ap.sub_(off)
        alpha = rs / torch.dot(q.reshape(-1), ap.reshape(-1))
        x.addcmul_(q, alpha)
        r.addcmul_(ap, alpha, value=-1)
        rs_new = torch.dot(r.reshape(-1), r.reshape(-1))
        torch.addcmul(r, q, rs_new / rs, out=q)

    vec_ms = _events(passes, reps)
    # bytes each input read once, each output written once: the offset
    # subtraction 3 vectors, the dots 2 and 1, each addcmul 3
    floor = HardwareModel().copy_floor
    vec_bytes = 15 * rhs.numel() * 4
    row = {"route": solver.lowering["operator"],
           "iterations": info["iterations"],
           "residual": info["residual"], "iteration_ms": iter_ms,
           "operator_ms": op_ms, "vector_ms": vec_ms,
           "vector_bytes": vec_bytes,
           "vector_floor_ms": vec_bytes / floor * 1e3,
           "operator_bound_ms": Report.build(p).roofline_time_s() * 1e3}
    out[p.name + " cg"] = row
    print(f"solvers: cg {p.name} ({row['route']}): {info['iterations']} "
          f"iterations, residual {info['residual']:.3e}, {iter_ms:.3f} ms "
          f"an iteration: operator {op_ms:.3f} (bound "
          f"{row['operator_bound_ms']:.4f}), vector passes {vec_ms:.3f} "
          f"({vec_bytes / 1e9:.2f} GB: {row['vector_floor_ms']:.3f} ms at "
          f"the copy floor), the rest (the host read of rs, launches) "
          f"{iter_ms - op_ms - vec_ms:.3f} | {smi}", flush=True)
    return out


def _events(fn, n: int) -> float:
    """ms a call of ``fn``: ``n`` calls on CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _pipeline(smi: str, reps: int) -> dict:
    """``--cells pipeline``: the pipeline split over a ``("p",)`` mesh
    repeating the card (``compile_pipeline_split``, sharded io, K4 a
    segment in chunk mode), in turns with the single-device route
    (``compile_chain_best``): pipeline, route, route, pipeline, each
    ``reps`` calls after a warm-up.  Cells: jacobi3d 512^3 x 8 over 4
    (route K1), jacobi3d 512^3 x 32 over 4 (route K3c, the spill rung),
    hdiff3d 256^3 x 16 over 2 and over 4 (route K3c).  One call of each
    is checked against the route bit for bit, and K4's launches over it
    must be segments x chunks.  Positions share the one card: no
    multi-GPU figure."""
    import numpy as np
    import torch
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.parallel import compile_pipeline_split
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    cuda = torch.device("cuda", 0)
    out = {}
    for shape, n, iters, S in (("diffusion", 512, 8, 4),
                               ("diffusion", 512, 32, 4),
                               ("hdiff", 256, 16, 2), ("hdiff", 256, 16, 4)):
        p = sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_{n}_{iters}itr")
        fn, plan = compile_pipeline_split(
            p, make_mesh([cuda], (S,), ("p",)), "p")
        single, route = compile_chain_best(p, device="cuda")
        inputs = sft.load_input_arrays(p, seed=0)
        dev_in = {k: torch.as_tensor(np.asarray(v)).to(cuda)
                  for k, v in inputs.items()}
        del inputs
        placed = fn.place(dev_in)
        torch.cuda.synchronize()
        st.launches_by["local"] = st.launches_by["spill"] = 0
        got = fn(placed)
        torch.cuda.synchronize()
        launches = st.launches_by["local"] + st.launches_by["spill"]
        want = single(dev_in)
        o = p.outputs[0]
        equal = torch.equal(got[o].gather(cuda),
                            want[o].reshape(p.raw_dimensions))
        del got, want
        pipe_a = _events(lambda: fn(placed), reps)
        route_a = _events(lambda: single(dev_in), reps)
        route_b = _events(lambda: single(dev_in), reps)
        pipe_b = _events(lambda: fn(placed), reps)
        label = f"{p.name} over {S}"
        row = {"pipeline_ms": [pipe_a, pipe_b], "route": route,
               "route_ms": [route_a, route_b], "equal_route": bool(equal),
               "backend": fn.last_config["backend"],
               "segments": [len(x) for x in plan.segments],
               "widen": [list(w) for w in plan.widen],
               "k4_launches": launches,
               "k4": [{"tile": list(sp.tile), "threads": sp.threads,
                       "spilled": sorted(sp.spilled),
                       "banded": sorted(sp.mxu_plans)}
                      for sp in (fn.stream_plans or [])]}
        out[label] = row
        print(f"{label}: pipeline {pipe_a:.3f} / {pipe_b:.3f} ms, route "
              f"{route} {route_a:.3f} / {route_b:.3f} ms, equal {equal}, K4 "
              f"launches {launches}, widen {plan.widen} | {smi}",
              flush=True)
        if not equal or launches != S * plan.num_chunks:
            raise RuntimeError(f"{label}: equal {equal}, K4 launches "
                               f"{launches}")
        del dev_in, placed
        torch.cuda.empty_cache()
    return out


def _autotune(smi: str, reps: int) -> dict:
    """``--cells autotune``: ``autotune`` with the sweep and 3 trials on
    cross-r2 256^3 x 8, hdiff3d 256^3 x 8 and jacobi2d 8192^2 x 8 (every
    label's ms, the skipped labels, the build seconds and the winner),
    then the route (``compile_chain_best``) and the winner in turns:
    route, winner, winner, route, each ``reps`` calls after a warm-up.
    The winner's output is checked against the route's (bit for bit per
    cell, within MXU_VERIFY_RTOL where either has banded stages)."""
    import time

    import numpy as np
    import torch
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.autotune import autotune
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    from stencilflow_tpu_torch.data import arrays_are_equal
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    out = {}
    for shape, dims, iters, extent in (("cross", (256,) * 3, 8, 2),
                                       ("hdiff", (256,) * 3, 8, 1),
                                       ("diffusion", (8192, 8192), 8, 1)):
        p = sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape, extent=extent,
            seed_data="random:0.0,1.0"),
            name=f"{shape}{len(dims)}d_{dims[0]}_{iters}itr")
        t0 = time.perf_counter()
        res = autotune(p, sweep=True, trials=3, device="cuda")
        tune_s = time.perf_counter() - t0
        single, route = compile_chain_best(p, device="cuda")
        dev_in = {k: v if p.inputs[k].is_scalar else
                  torch.as_tensor(np.asarray(v)).cuda()
                  for k, v in sft.load_input_arrays(p, seed=0).items()}
        banded = any(getattr(f, "last_config", {}).get("mxu_stages")
                     for f in (single, res.fn))
        o = p.outputs[0]
        got, want = res.fn(dev_in)[o].cpu().numpy(), \
            single(dev_in)[o].cpu().numpy()
        equal = (arrays_are_equal(want, got, MXU_VERIFY_RTOL) if banded
                 else np.array_equal(got, want))
        route_a = _events(lambda: single(dev_in), reps)
        win_a = _events(lambda: res.fn(dev_in), reps)
        win_b = _events(lambda: res.fn(dev_in), reps)
        route_b = _events(lambda: single(dev_in), reps)
        row = {"winner": res.label,
               "label_ms": {l: t * 1e3 for l, t in res.timings.items()},
               "skipped": {l: why.splitlines()[0][:80]
                           for l, why in res.skipped.items()},
               "build_s": res.build_seconds, "tune_s": tune_s,
               "route": route, "route_ms": [route_a, route_b],
               "winner_ms": [win_a, win_b], "equal_route": bool(equal)}
        out[p.name] = row
        print(f"{p.name}: winner {res.label} {res.seconds * 1e3:.3f} ms | "
              + ", ".join(f"{l} {t:.3f}" for l, t in
                          row["label_ms"].items())
              + f" | skipped {sorted(res.skipped)} | tuned in "
              f"{tune_s:.1f} s (builds "
              f"{max(res.build_seconds.values()):.1f} s at most) | in "
              f"turns: route {route} {route_a:.3f} / {route_b:.3f} ms, "
              f"winner {win_a:.3f} / {win_b:.3f} ms, equal {equal} | {smi}",
              flush=True)
        if not equal:
            raise RuntimeError(f"{p.name}: the winner {res.label} disagrees "
                               f"with the route {route}")
        del dev_in, res, single
        torch.cuda.empty_cache()
    return out


def _bf16(smi: str, reps: int) -> dict:
    """``--cells bf16``: the reduced-precision legs beside their cells' f32
    plans, on the same kernels as the routes take them: jacobi3d 512^3 x
    8 on K1 with bf16 rings, jacobi3d 512^3 x 32 on K3c with bf16 rings,
    jacobi2d 8192^2 x 8 rotated to rows on K5 (B = 64, g = 8) with bf16
    rings, box3d 256^3 x 8 of extent 2 on K3b with single-pass bf16
    passes, and jacobi3d 256^3 x 8 on K3a (``plan_stream(mxu="off")``, on
    chip) with bf16 rings.  Every kernel is built at once; each mode's
    largest difference from its f32 plan's output is printed, with
    whether it lies within BF16_VERIFY_RTOL (``chip_smoke.py`` holds each
    mode to its plain version; here its plain version is timed once on
    the host clock, with the kernel's largest difference from it); then
    three sessions of f32, bf16, bf16, f32, ``reps`` launches each after a
    warm-up, and the reduced-precision kernel's launches over them (its
    wrapper's count)."""
    import time
    import numpy as np
    import torch
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import build, codegen
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL
    from stencilflow_tpu_torch.data import arrays_are_equal
    from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    def synth(shape, dims, iters, extent=1):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape, extent=extent,
            seed_data="random:0.0,1.0"),
            name=f"{shape}{len(dims)}d_{dims[0]}_{iters}itr")

    def panel_cell(p, an, **kw):
        plan = pn.PanelPlan.build(an, **kw)
        evals = sum(np.prod(plan.region(s)) for s in p.kernels) / np.prod(
            plan.tile)
        return (plan, codegen.panel_source(p, an, plan), "panel",
                lambda a, lib: pn.run_panel(p, an, plan, a, lib),
                f"tile {plan.tile} x {plan.threads}, smem "
                f"{plan.smem_bytes(p)} B, {plan.residency(p)} blocks/SM, "
                f"{evals:.2f} evaluations a cell, modelled "
                f"{plan.seconds(p) * 1e3:.3f} ms",
                lambda a: pn.panel_plain(p, an, plan, a))

    def group_cell(p, an, **kw):
        plan = gp.plan_group(p, an, 64, 8, **kw)
        return (plan, codegen.group_source(p, an, plan), "group",
                lambda a, lib: gp.run_group(p, an, plan, a, lib),
                f"tile {plan.tile} x {plan.threads}, segments "
                f"{plan.segments}, smem {plan.smem_bytes(p)} B, modelled "
                f"{plan.seconds(p) * 1e3:.3f} ms",
                lambda a: gp.group_plain(p, an, plan, a))

    def stream_cell(p, an, **kw):
        plan = st.plan_stream(p, an, **kw)
        text = f"tile {plan.tile} x {plan.threads}, smem {plan.smem_bytes()} B"
        if plan.packed:
            ntj, ntk = plan.grid()
            moved = plan.spill_traffic() * plan.steps() * ntj * ntk
            text += (f", spilled {len(plan.spilled)} of "
                     f"{len(plan.raw_ring)} rings, spill traffic "
                     f"{moved / 1e9:.2f} GB a call, modelled "
                     f"{plan.spill_seconds() * 1e3:.3f} ms")
        else:
            text += f", modelled {plan.seconds() * 1e3:.3f} ms"
        if plan.tkeys:
            text += ", passes " + ", ".join(sorted({
                f"{plan.band_info(k, s).taps}-tap {plan.route(k, s)}"
                for t in plan.tkeys for k, s in ((t[1], "L"), (t[2], "R"))
                if k is not None}))
        return (plan, st.stream_source(plan), "stream",
                lambda a, lib: st.run_stream(plan, a, lib), text,
                lambda a: st.stream_plain(plan, a))

    rings = {"ring_storage": "bfloat16"}
    cells = []
    for p, make, f32_kw, bf16_kw in (
            (synth("diffusion", (512,) * 3, 8), panel_cell, {}, rings),
            (synth("diffusion", (512,) * 3, 32), stream_cell, {"mxu": "off"},
             dict(rings, mxu="off")),
            (rotate_2d_to_rows(synth("diffusion", (8192, 8192), 8)),
             group_cell, {}, rings),
            (synth("box", (256,) * 3, 8, 2), stream_cell, {},
             {"mxu_precision": "bf16"}),
            (synth("diffusion", (256,) * 3, 8), stream_cell, {"mxu": "off"},
             dict(rings, mxu="off"))):
        an = sft.ChainAnalysis.run(p)
        cells.append((p, make(p, an, **f32_kw), make(p, an, **bf16_kw)))
    sources = [(c[1], c[2]) for _p, *pair in cells for c in pair]
    libs = iter(build.load_libraries(sources))
    out = {}
    for p, f32, bf16 in cells:
        lib32, lib16 = next(libs), next(libs)
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        o = p.outputs[0]
        want = f32[3](arrays, lib32)[o].cpu().numpy()
        got = bf16[3](arrays, lib16)[o].cpu().numpy()
        # the reduced-precision kernel's plain version, once, host clock
        t_plain = time.perf_counter()
        plain = bf16[5](arrays)[o]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        plain = plain.cpu().numpy().reshape(got.shape)
        plain_err = float(np.max(np.abs(got.astype(np.float64) - plain)))
        del plain
        within = bool(arrays_are_equal(want, got, BF16_VERIFY_RTOL))
        rel = float(np.max(np.abs(got.astype(np.float64) - want))
                    / np.max(np.abs(want)))
        del want, got

        def counted():
            return {"panel": pn.launches_by["bf16"],
                    "group": gp.launches_by["bf16"],
                    "stream": (st.launches_by["bf16"]
                               + st.launches_by["spill_bf16"])}[bf16[2]]
        before = counted()
        sessions = []
        for _ in range(3):
            sessions.append([_events(lambda c=c, lib=lib: c[3](arrays, lib),
                                     reps)
                             for c, lib in ((f32, lib32), (bf16, lib16),
                                            (bf16, lib16), (f32, lib32))])
        row = {"f32_ms": [x for s in sessions for x in (s[0], s[3])],
               "bf16_ms": [x for s in sessions for x in (s[1], s[2])],
               "f32_plan": f32[4], "bf16_plan": bf16[4],
               "max_rel_diff": rel, "within_bf16_rtol": within,
               "bf16_launches": counted() - before,
               "bf16_plain_ms": plain_ms, "max_abs_err": plain_err}
        out[p.name] = row
        print(f"{p.name}: f32 {', '.join(f'{x:.3f}' for x in row['f32_ms'])}"
              f" ms ({f32[4]}) | bf16 "
              f"{', '.join(f'{x:.3f}' for x in row['bf16_ms'])} ms "
              f"({bf16[4]}), {row['bf16_launches']} launches, plain version "
              f"{plain_ms:.1f} ms, max_abs_err {plain_err:.3g} | max rel diff "
              f"{rel:.3g} within BF16_VERIFY_RTOL: {within} | {smi}",
              flush=True)
        for c in (f32, bf16):
            if hasattr(c[0], "device_pool"):
                c[0].device_pool.clear()
        del arrays
        torch.cuda.empty_cache()
    return out


def _converts(lib_path: str) -> int:
    """F2F / F2FP instructions (float conversions) in the SASS of a built
    kernel library (``cuobjdump -sass``): every stage body is inlined
    into its one kernel, whose loads convert nothing."""
    import re
    from stencilflow_tpu_torch.backend import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    return len(re.findall(r"\bF2FP?\b", sass))


def _narrow(smi: str, reps: int) -> dict:
    """``--cells narrow``: programs typed bfloat16 and float16 on the
    kernels that stream them, each in turns with the same program in
    float32 on its own plan: jacobi3d 512^3 x 8 typed bf16 and typed f16
    on K1 (``PanelPlan.build``, the route), and the middle chunk (4 of 8:
    144 planes in, 128 out) of jacobi3d 1024^3 x 8 typed bf16 on K4
    (``plan_local``, random slabs made on the card).  A cell's two
    kernels are built at once; each is held to its plain version on the
    card bit for bit (2-byte patterns), then three sessions
    of f32, narrow, narrow, f32, ``reps`` launches each after a warm-up;
    the narrow kernel's launches over them (its wrapper's count).  Each
    cell prints the plans' tiles, shared memory, resident blocks per SM
    (the card's occupancy query), 2-byte inputs moved by cp.async groups
    (``copy_groups``, where the checkout has them) and the F2F / F2FP
    instructions in each kernel's SASS (``_converts``)."""
    import torch
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import build, codegen
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    def synth(n, dt):
        return sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(n,) * 3, shape="diffusion",
            data_type=dt, seed_data="random:0.0,1.0"),
            name=f"jacobi3d_{n}_8itr_{dt}")

    def panel_cell(p):
        an = sft.ChainAnalysis.run(p)
        plan = pn.PanelPlan.build(an)
        src = codegen.panel_source(p, an, plan)
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        return (plan, src, "panel", plan.smem_bytes(p),
                lambda lib: pn.run_panel(p, an, plan, arrays, lib),
                lambda: pn.panel_plain(p, an, plan, arrays),
                lambda: pn.launches_by["narrow"])

    def local_cell(p):
        an = sft.ChainAnalysis.run(p)
        plan = st.plan_local(p, an, 128, chain_halo(an)[0])
        origin = 4 * 128 - plan.halo_i
        gen = torch.Generator(device="cuda").manual_seed(0)
        dt = torch.bfloat16 if "bfloat16" in p.name else torch.float32
        slabs = {n: torch.rand((plan.extent(),) + p.dimensions[1:],
                               generator=gen, device="cuda").to(dt)
                 for n in p.inputs}
        return (plan, st.stream_source(plan), "stream", plan.smem_bytes(),
                lambda lib: st.run_local_stream(plan, origin, slabs, lib),
                lambda: st.local_stream_plain(plan, origin, slabs),
                lambda: st.launches_by["local_narrow"])

    cells = {"K1 bf16": (panel_cell, 512, "bfloat16"),
             "K1 f16": (panel_cell, 512, "float16"),
             "K4 chunk bf16": (local_cell, 1024, "bfloat16")}
    out = {}
    for name, (make, n, dt) in cells.items():
        f32, narrow = make(synth(n, "float32")), make(synth(n, dt))
        libs = build.load_libraries([(f32[1], f32[2]),
                                     (narrow[1], narrow[2])])
        row = {}
        for key, c, lib in (("f32", f32, libs[0]), ("narrow", narrow,
                                                    libs[1])):
            got = c[4](lib)
            want = c[5]()
            torch.cuda.synchronize()
            same = all(torch.equal(got[o].view(torch.int16)
                                   if got[o].element_size() == 2
                                   else got[o],
                                   want[o].view(torch.int16)
                                   if want[o].element_size() == 2
                                   else want[o]) for o in want)
            del got, want
            row[key + "_plan"] = {
                "tile": list(c[0].tile), "threads": c[0].threads,
                "smem": c[3], "blocks_per_sm": pn.occupancy(lib),
                "copy_groups": dict(getattr(c[0], "copy_groups", {})),
                "converts": _converts(build.library_path(c[1], c[2])),
                "equal_plain": bool(same)}
        before = narrow[6]()
        sessions = [[_events(lambda c=c, lib=lib: c[4](lib), reps)
                     for c, lib in ((f32, libs[0]), (narrow, libs[1]),
                                    (narrow, libs[1]), (f32, libs[0]))]
                    for _ in range(3)]
        row.update(f32_ms=[x for s in sessions for x in (s[0], s[3])],
                   narrow_ms=[x for s in sessions for x in (s[1], s[2])],
                   narrow_launches=narrow[6]() - before)
        out[name] = row
        print(f"{name}: f32 {', '.join(f'{x:.3f}' for x in row['f32_ms'])}"
              f" ms ({row['f32_plan']}) | {dt} "
              f"{', '.join(f'{x:.3f}' for x in row['narrow_ms'])} ms "
              f"({row['narrow_plan']}), {row['narrow_launches']} launches "
              f"| {smi}", flush=True)
        del f32, narrow
        torch.cuda.empty_cache()
    return out


def _ptxas(sources) -> None:
    """nvcc's register and spill report of every source."""
    import tempfile
    from stencilflow_tpu_torch.backend import build
    with tempfile.TemporaryDirectory() as tmp:
        for n, src in enumerate(sources):
            cu = os.path.join(tmp, f"k{n}.cu")
            with open(cu, "w") as f:
                f.write(src)
            proc = subprocess.run(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-o", os.path.join(tmp, f"k{n}.so"), cu],
                capture_output=True, text=True)
            lines = [x for x in proc.stderr.splitlines()
                     if "registers" in x or "spill" in x
                     or "Compiling entry" in x]
            print(f"ptxas: source {n}: " + " | ".join(
                x.strip() for x in lines[-6:]), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deep_time", description=__doc__)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", choices=("deep", "panel", "banded", "local",
                                        "group", "tile", "overlap",
                                        "solvers", "pipeline", "autotune",
                                        "bf16", "narrow"),
                    default="deep")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: deep_time needs a CUDA device", file=sys.stderr)
        return 1
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import build
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.cells in ("solvers", "pipeline", "autotune", "bf16", "narrow"):
        cells = {"solvers": _solvers, "pipeline": _pipeline,
                 "autotune": _autotune, "bf16": _bf16,
                 "narrow": _narrow}[args.cells]
        got = cells(smi, args.reps)
        print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                          "cells": got}))
        # a narrow kernel that differs from its plain version fails the run
        return int(any(not row[k]["equal_plain"] for row in got.values()
                       for k in ("f32_plan", "narrow_plan")
                       if isinstance(row, dict) and k in row))
    cells = {"deep": _deep, "panel": _panel, "banded": _banded,
             "local": _local, "group": _group, "tile": _tile,
             "overlap": _overlap}[args.cells](sft, synthesize_stencil)
    built = [c for c in cells if c[2] is not None]
    if args.ptxas:
        _ptxas([src for _p, _plan, src in built])
    kind = args.cells if args.cells in ("panel", "group", "tile",
                                        "overlap") else "stream"
    libs = dict(zip([id(c) for c in built], build.load_libraries(
        [(src, kind) for _p, _plan, src in built])))
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    out = {}
    for cell in cells:
        p, plan, _src = cell
        if isinstance(plan, str):
            out[p.name] = {"refused": plan}
            print(f"{p.name}: refused ({plan}) | {smi}", flush=True)
            continue
        lib = libs[id(cell)]
        if args.cells == "local":
            origin = p.dimensions[0] // 2 - plan.halo_i

            def run(arrays, plan=plan, lib=lib, origin=origin):
                return st.run_local_stream(plan, origin, arrays, lib)
        elif args.cells == "group":
            from stencilflow_tpu_torch.backend import group as gp
            an = sft.ChainAnalysis.run(p)

            def run(arrays, p=p, an=an, plan=plan, lib=lib):
                return gp.run_group(p, an, plan, arrays, lib)
        elif args.cells == "tile" or (args.cells == "overlap"
                                      and p.name.endswith("_tile")):
            from stencilflow_tpu_torch.backend import tile as tl

            def run(arrays, plan=plan, lib=lib):
                return tl.run_tile(plan, arrays, lib)
        elif args.cells == "overlap":
            from stencilflow_tpu_torch.backend import overlap as ov
            an = sft.ChainAnalysis.run(p)

            def run(arrays, p=p, an=an, plan=plan, lib=lib):
                return ov.run_overlap(p, an, plan, arrays, lib)
        elif args.cells != "panel":
            def run(arrays, plan=plan, lib=lib):
                return st.run_stream(plan, arrays, lib)
        else:
            an = sft.ChainAnalysis.run(p)

            def run(arrays, p=p, an=an, plan=plan, lib=lib):
                return pn.run_panel(p, an, plan, arrays, lib)
        if args.cells == "local":
            gen = torch.Generator(device="cuda").manual_seed(0)
            arrays = {n: torch.rand((plan.extent(),) + p.dimensions[1:],
                                    generator=gen, device="cuda")
                      for n in p.inputs}
            got = run(arrays)[p.outputs[0]]
            want = st.local_stream_plain(plan, origin, arrays)[p.outputs[0]]
            equal = torch.equal(got, want)
        else:
            inputs = sft.load_input_arrays(p, seed=0)
            arrays = spanned_arrays(p, inputs, device="cuda")
            got = run(arrays)[p.outputs[0]]
            want = compile_chain(p)({k: torch.as_tensor(np.asarray(v)).cuda()
                                     for k, v in inputs.items()})[
                p.outputs[0]]
            got = got.reshape(want.shape)
            equal = torch.equal(got, want) if args.cells != "banded" else \
                sft.arrays_are_equal(want.cpu().numpy(), got.cpu().numpy(),
                                     MXU_VERIFY_RTOL)
        del got, want
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run(arrays)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / args.reps
        if args.cells in ("banded", "local"):
            row = {"ms": ms, "tile": list(plan.tile),
                   "smem": plan.smem_bytes(), "equal": bool(equal)}
            if hasattr(plan, "unpacked_bytes"):
                t = plan.tkeys[0] if plan.tkeys else None
                row.update(threads=plan.threads,
                           unpacked=plan.unpacked_bytes(),
                           blocks_per_sm=pn.occupancy(lib),
                           evaluations=plan.evaluations(),
                           passes=sorted({plan.route(k, side)
                                          for t in plan.tkeys
                                          for k, side in ((t[1], "L"),
                                                          (t[2], "R"))
                                          if k is not None}))
            text = ", ".join(f"{k} {v}" for k, v in row.items()
                             if k not in ("ms", "tile", "equal"))
            plan.device_pool.clear()
        elif args.cells in ("group", "tile", "overlap"):
            row = {"ms": ms, "tile": list(plan.tile),
                   "smem": plan.smem_bytes() if hasattr(plan, "mode")
                   else plan.smem_bytes(p), "equal_dense": equal}
            for key in ("threads", "segments", "mode", "R", "window"):
                if hasattr(plan, key):
                    row[key] = getattr(plan, key)
            if hasattr(lib, "sf_occupancy"):
                row["blocks_per_sm"] = pn.occupancy(lib)
            text = ", ".join(f"{k} {v}" for k, v in row.items()
                             if k not in ("ms", "tile", "equal_dense"))
        elif args.cells == "deep":
            row = {"ms": ms, "tile": list(plan.tile),
                   "spilled": len(plan.spilled),
                   "rings": len(plan.raw_ring),
                   "smem": plan.smem_bytes(), "equal_dense": equal}
            text = (f"spilled {len(plan.spilled)} of {len(plan.raw_ring)} "
                    f"rings, smem {plan.smem_bytes()} B")
            plan.device_pool.clear()
        else:
            row = {"ms": ms, "tile": list(plan.tile),
                   "smem": plan.smem_bytes(p), "equal_dense": equal}
            if hasattr(plan, "unpacked_bytes"):
                row.update(unpacked=plan.unpacked_bytes(p),
                           blocks_per_sm=pn.occupancy(lib),
                           masked_share=plan.masked_share(p))
            text = ", ".join(f"{k} {v}" for k, v in row.items()
                             if k not in ("ms", "tile", "equal_dense"))
        out[p.name] = row
        print(f"{p.name}: {ms:.3f} ms, tile {plan.tile}, {text}, equal to "
              f"{'its plain version' if args.cells == 'local' else 'dense'}"
              f"{' within MXU_VERIFY_RTOL' if args.cells == 'banded' else ''}"
              f": {equal} | {smi}", flush=True)
        del arrays
        torch.cuda.empty_cache()
        if not equal:
            print(f"error: {p.name} differs from dense", file=sys.stderr)
            return 1
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                      "cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

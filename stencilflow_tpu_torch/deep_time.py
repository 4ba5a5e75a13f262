"""Time the stream kernel's route plans on the deep 3-D cells (K3c).

    python stencilflow_tpu_torch/deep_time.py [--root DIR] [--reps N]

Imports ``stencilflow_tpu_torch`` from the checkout at ``--root`` (this
file's own checkout by default), so the same file times another commit
of the port on the same card: run it for one commit, then the other,
then the second again and the first again, and compare only within one
such sequence.  For each deep cell (jacobi3d 512^3 x 32, hdiff3d 256^3 x
16, hotspot3d 256^3 x 32; random inputs from seed 0) it plans the route's
stream kernel (``plan_stream(..., mxu="off")``), builds every kernel at
once (one nvcc each), checks one launch against the dense lowering on the
card bit for bit, then times ``--reps`` launches with CUDA events after a
warm-up.  The last line is one JSON object: the card (``nvidia-smi``
name and power limit), and per cell the kernel's ms, tile, spilled rings
and shared memory per block.  It needs a CUDA device.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deep_time", description=__doc__)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: deep_time needs a CUDA device", file=sys.stderr)
        return 1
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import build
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cells = []
    for shape, n, iters in (("diffusion", 512, 32), ("hdiff", 256, 16),
                            ("hotspot", 256, 32)):
        p = sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0"), name=f"{shape}3d_{n}_{iters}itr")
        cells.append((p, st.plan_stream(p, mxu="off")))
    libs = build.load_libraries([(st.stream_source(plan), "stream")
                                 for _p, plan in cells])
    out = {}
    for (p, plan), lib in zip(cells, libs):
        inputs = sft.load_input_arrays(p, seed=0)
        arrays = spanned_arrays(p, inputs, device="cuda")
        got = st.run_stream(plan, arrays, lib)[p.outputs[0]]
        want = compile_chain(p)({k: torch.as_tensor(np.asarray(v)).cuda()
                                 for k, v in inputs.items()})[p.outputs[0]]
        equal = torch.equal(got.reshape(want.shape), want)
        del got, want
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            st.run_stream(plan, arrays, lib)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / args.reps
        out[p.name] = {"ms": ms, "tile": list(plan.tile),
                       "spilled": len(plan.spilled),
                       "rings": len(plan.raw_ring),
                       "smem": plan.smem_bytes(), "equal_dense": equal}
        print(f"{p.name}: {ms:.3f} ms, tile {plan.tile}, spilled "
              f"{len(plan.spilled)} of {len(plan.raw_ring)} rings, smem "
              f"{plan.smem_bytes()} B, equal to dense: {equal} | {smi}",
              flush=True)
        del arrays
        plan.device_pool.clear()
        torch.cuda.empty_cache()
        if not equal:
            print(f"error: {p.name} differs from dense", file=sys.stderr)
            return 1
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                      "cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

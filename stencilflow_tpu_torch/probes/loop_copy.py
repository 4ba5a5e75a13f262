"""P7, the launch and loop harness: P4's copy applied U times per loop
iteration, launched eagerly from Python or replayed from a CUDA graph.

    python -m stencilflow_tpu_torch.probes.loop_copy [--trials 3]

Port of ``scripts/loop_copy_probe.py`` (``build`` :33, ``pallas_call``
:37), which asked whether XLA's loop carry adds a copy per iteration: the
TPU harness applied the kernel U = 1/2/4/8 times per ``fori_loop``
iteration and found the carry copy at U = 1 (the reason ``bench.py``
applies a chain twice per iteration).  Eager PyTorch has no pinned loop
carry; the question here is the cost of each launch.  Each iteration
applies P4's copy kernel (``copy_floor.copy``, the same function as the
TPU probe's passthrough) U times between two ping-pong buffers; two loop
lengths are differenced (best of trials), for

* ``eager``: every launch from Python, as the bench and ``run`` launch;
* ``graph``: the loop captured once per length in a CUDA graph and
  replayed;

at 512 planes of 512², where a launch's host cost hides behind the
kernel, and at 8 planes, where it shows.  Output per case: ms per
application and GB/s moved; then the host cost of one eager launch (the
host clock around the enqueue of an 8-plane eager loop).  Every case
ends with both buffers equal to the input, bit for bit.  The launches
count in ``copy_floor.launches``: each eager launch, and each launch
recorded into a graph's capture; a replay re-runs the recorded launches
without passing through the wrapper and adds nothing.  The last line is
a JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List

import torch

from . import ClockSampler, card, differenced_ms
from .copy_floor import copy, copy_plain, gbs

PLANES = (512, 8)
UNROLLS = (1, 2, 4, 8)
MODES = ("eager", "graph")


def loop(a: torch.Tensor, b: torch.Tensor, iters: int, unroll: int,
         body: Callable[[torch.Tensor, torch.Tensor], object] = copy
         ) -> torch.Tensor:
    """``iters`` iterations of ``unroll`` applications of ``body(src,
    dst)``, which writes ``dst``, ping-ponging between ``a`` and ``b``;
    returns the buffer holding the result.  The default body is P4's copy
    (its kernel on a CUDA tensor, its plain version on a CPU one), which
    counts its launches in ``copy_floor.launches``."""
    src, dst = a, b
    for _ in range(iters * unroll):
        body(src, dst)
        src, dst = dst, src
    return src


def loop_plain(a: torch.Tensor, iters: int, unroll: int) -> torch.Tensor:
    """The plain torch version of the loop: ``iters * unroll`` applications
    of P4's plain version, each a new tensor carried to the next."""
    x = a
    for _ in range(iters * unroll):
        x = copy_plain(x)
    return x


def measure(unrolls=UNROLLS, trials: int = 3) -> Dict[str, object]:
    """Every (planes, U, mode) case: ms per application (two loop lengths
    differenced) and the largest difference of either ping-pong buffer
    from the input after the case (raises unless 0); and the host
    microseconds of one eager launch."""
    rows: List[Dict[str, object]] = []
    host_us = None
    for P in PLANES:
        shape = (P, 512, 512)
        gen = torch.Generator("cuda").manual_seed(0)
        a = torch.rand(shape, device="cuda", generator=gen)
        keep = a.clone()
        b = torch.empty_like(a)
        n1, n2 = (2, 10) if P >= 64 else (20, 100)
        for unroll in unrolls:
            for mode in MODES:
                ms = differenced_ms(
                    lambda n: loop(a, b, n, unroll), n1, n2, trials,
                    graph=mode == "graph") / unroll
                err = max(float((a - keep).abs().max()),
                          float((b - keep).abs().max()))
                if err != 0.0:
                    raise RuntimeError(
                        f"loop {P} planes, U={unroll}, {mode}: a buffer "
                        f"differs from the input by {err:.3g}")
                rows.append({"planes": P, "unroll": unroll, "mode": mode,
                             "ms": ms, "gb_s": gbs(shape, ms),
                             "max_abs_err": err})
        if P == min(PLANES):
            # the enqueue alone: the launches return before the card runs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop(a, b, n2, 1)
            host_us = (time.perf_counter() - t0) / n2 * 1e6
            torch.cuda.synchronize()
        del a, b, keep
        torch.cuda.empty_cache()
    return {"cases": rows, "host_us_per_launch": host_us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="loop_copy", description=__doc__)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the loop harness is measured on a CUDA device; torch "
              "sees none", file=sys.stderr)
        return 1
    dev = card()
    with ClockSampler() as clocks:
        res = measure(trials=args.trials)
    for r in res["cases"]:
        print(f"planes {r['planes']:4d} U={r['unroll']} {r['mode']:5s}: "
              f"{r['ms'] * 1e3:9.3f} us per application "
              f"{r['gb_s']:8.1f} GB/s", flush=True)
    print(f"host cost of one eager launch: {res['host_us_per_launch']:.2f} "
          f"us | {dev['name']}, {dev['power_limit_w']} W | "
          f"{clocks.summary()}")
    print(json.dumps({"device": dev, "clocks": clocks.summary(), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

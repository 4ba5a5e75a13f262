"""Benchmark of the port: a stencil chain's GCell/s on one H100.

    python -m stencilflow_tpu_torch.bench [--workload jacobi] [--sessions 3]
    python -m stencilflow_tpu_torch.bench --workload hdiff --device cpu

Port of the JAX package's ``bench.py``.  Prints ONE JSON line:
``{"metric", "value" (GCell/s), "unit", "vs_baseline", "bounds",
"device", ...}``.

Workloads (``bench.py``'s, built with the port's ``synthesize`` and
``parse_program``; inputs ``load_input_arrays(program, seed=0)``):
jacobi (jacobi3d), jacobi2d, box (radius 2: the banded stream path),
hotspot and hdiff, 8 stages each by default, at PERF.md's H100 sizes
(512³, 8192², 256³, 256³, 256³) on the card and the tests' sizes on the
CPU.  ``--backend`` takes the port's lowerings and the JAX package's
names for them (``pallas`` = ``tile``, ``xla`` = ``dense``).

Timing: the chain's output feeds its input, two applications per loop
iteration, as ``bench.py`` does (P7, ``probes/loop_copy.py``, measures
no per-iteration carry copy on the card, so the count changes nothing
there but keeps the two benchmarks alike); two loop lengths are
differenced, best of trials, on CUDA events (the host clock on the CPU).
``--sessions`` repeats the whole protocol and reports the median with
the spread; every session samples the card's SM and memory clocks and
power draw with ``nvidia-smi`` while it runs.

``vs_baseline`` is the report's ``roofline_time_s`` (data-sheet bounds,
``report.py``) over the measured time per application; ``bounds`` holds
every candidate's fraction (``Report.bound_fractions``).  A CPU run
prints ``vs_baseline: null`` and no bounds: a CPU time is not a device
metric.  ``--device cuda`` without a card raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import load_input_arrays
from .driver import BACKEND_ALIASES, _compile
from .frontend.analysis import ChainAnalysis
from .frontend.parser import parse_program
from .probes import (ClockSampler, card, differenced_ms,
                     host_differenced_ms)
from .report import Report
from .synthesize import jacobi, synthesize_stencil

WORKLOADS = ("jacobi", "jacobi2d", "box", "hotspot", "hdiff")
CARD_SIZE = {"jacobi": 512, "jacobi2d": 8192, "box": 256, "hotspot": 256,
             "hdiff": 256}
CPU_SIZE = {"jacobi": 32, "jacobi2d": 64, "box": 16, "hotspot": 16,
            "hdiff": 16}
BACKENDS = ("auto", "stream", "panel", "overlap", "rows", "tile", "dense")


def build_program(workload: str, size: int, iters: int):
    """The workload's program, as ``bench.py`` builds it."""
    if workload == "jacobi2d":
        return parse_program(jacobi(2, size, iterations=iters),
                             name=f"jacobi2d_{size}_{iters}itr")
    if workload == "jacobi":
        return parse_program(jacobi(3, size, iterations=iters),
                             name=f"jacobi3d_{size}_{iters}itr")
    return parse_program(
        synthesize_stencil(num_stages=iters, dimensions=(size,) * 3,
                           shape=workload,
                           extent=2 if workload == "box" else 1),
        name=f"{workload}3d_{size}_{iters}itr")


def loop_lengths(cells: int, cuda: bool):
    """(small, big, trials): ``bench.py``'s loop lengths, scaled so that
    the differenced device time stays well above the timer's noise."""
    if not cuda:
        return 1, 5, 3
    big = int(min(1920, max(15, round(15 * (512 ** 3 / cells)))))
    return max(3, big // 5), big, 5


def feed_loop(fn, inputs: Dict[str, object], in_name: str, out_name: str):
    """``run(n)``: ``n`` loop iterations that each apply ``fn`` twice,
    output ``out_name`` into input ``in_name``."""
    rest = {k: v for k, v in inputs.items() if k != in_name}

    def run(n):
        x = inputs[in_name]
        for _ in range(n):
            y = fn({in_name: x, **rest})[out_name]
            x = fn({in_name: y, **rest})[out_name]
        return x
    return run


def time_per_application(fn, inputs: Dict[str, object], in_name: str,
                         out_name: str, cells: int, device) -> float:
    """Seconds per application of ``fn``: a loop whose iterations apply
    it twice, output into input, at two lengths, differenced."""
    cuda = device.type == "cuda"
    small, big, trials = loop_lengths(cells, cuda)
    diff = differenced_ms if cuda else host_differenced_ms
    return diff(feed_loop(fn, inputs, in_name, out_name), small, big,
                trials) / 2 / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stencilflow_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="jacobi", choices=WORKLOADS)
    ap.add_argument("--size", type=int, default=None,
                    help="domain edge (default: PERF.md's H100 size on "
                         "the card, the tests' size on the CPU)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--backend", default="auto",
                    choices=BACKENDS + tuple(BACKEND_ALIASES))
    ap.add_argument("--sessions", type=int, default=0,
                    help="repeat the differenced protocol N times and "
                         "report the median with the spread (0: 3 on the "
                         "card, 1 on the CPU)")
    ap.add_argument("--session-gap", type=float, default=0.0,
                    help="seconds to sleep between sessions")
    ap.add_argument("--append-log", default=None,
                    help="append the JSON record (with a timestamp) to "
                         "this file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch sees no GPU")
    size = args.size or (CARD_SIZE if cuda else CPU_SIZE)[args.workload]
    program = build_program(args.workload, size, args.iters)
    analysis = ChainAnalysis.run(program)
    fn, backend = _compile(program, analysis,
                           BACKEND_ALIASES.get(args.backend, args.backend),
                           device, "auto", "split", "auto")
    inputs = {k: (v if program.inputs[k].is_scalar
                  else torch.as_tensor(np.asarray(v)).to(device))
              for k, v in load_input_arrays(program, seed=0).items()}
    in_name, out_name = next(iter(program.inputs)), program.outputs[0]
    cells = program.total_elements

    sessions = args.sessions or (3 if cuda else 1)
    dts: List[float] = []
    clocks: List[Dict[str, Optional[float]]] = []
    for s in range(sessions):
        if s and args.session_gap:
            time.sleep(args.session_gap)
        if cuda:
            with ClockSampler() as sampler:
                dts.append(time_per_application(fn, inputs, in_name,
                                                out_name, cells, device))
            clocks.append(sampler.summary())
        else:
            dts.append(time_per_application(fn, inputs, in_name, out_name,
                                            cells, device))
    dt = float(np.median(dts))
    gcell_s = cells / dt / 1e9

    report = Report.build(program, analysis)
    tag = (args.workload if args.workload.endswith("2d")
           else f"{args.workload}3d")
    rank = len(program.raw_dimensions)
    record = {
        "metric": f"{tag}_{size}^{rank}_{args.iters}itr_{backend}_"
                  f"{device.type}" + (f"_vs_{report.bound()}" if cuda
                                      else ""),
        "value": round(gcell_s, 3),
        "unit": "GCell/s",
        "vs_baseline": round(report.roofline_time_s() / dt, 4)
        if cuda else None,
    }
    if cuda:
        record["bounds"] = report.bound_fractions(dt)
        record["device"] = card()
        record["session_clocks"] = clocks
    else:
        record["device"] = {"name": "cpu", "power_limit_w": None}
    if sessions > 1:
        vals = sorted(cells / d / 1e9 for d in dts)
        record["sessions"] = sessions
        record["session_values"] = [round(v, 3) for v in vals]
        record["spread_pct"] = round(
            100.0 * (vals[-1] - vals[0]) / gcell_s, 1)
    print(json.dumps(record))
    if args.append_log:
        record["ts"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(args.append_log, "a") as f:
            f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""H100 probes: the hardware model's measured constants.

Ports of the TPU probes under ``scripts/`` as hand-written CUDA kernels
(``csrc/probes/*.cu``), each with a plain torch version and a launch
count, run on the card as

    python -m stencilflow_tpu_torch.probes.copy_floor    # P4, copy floor
    python -m stencilflow_tpu_torch.probes.alu_ceiling   # P1, FP32 ceiling
    python -m stencilflow_tpu_torch.probes.loop_copy     # P7, launch/loop

Their readings are ``config.H100_*`` and ``config.H100_OP_COST``, which
``report.py`` divides by.  This module holds what the three share: the
build of a probe source with the port's nvcc flags, differenced CUDA-event
timing, and the card's name, power limit and clocks from ``nvidia-smi``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Callable, Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "probes")


def source(name: str) -> str:
    """The text of ``csrc/probes/<name>.cu``."""
    with open(os.path.join(CSRC, name + ".cu")) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """Build ``csrc/probes/<name>.cu`` with nvcc (backend/build.py, cached
    by content) and declare its entry point ``entry`` (``argtypes`` a
    tuple); loaded once per process, so a launch pays no build lookup."""
    from ..backend import build
    lib = build.load_library(source(name), f"probe_{name}")
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib


def check_cuda(t: torch.Tensor) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor."""
    if t.device.type != "cuda":
        raise RuntimeError(
            f"the probe kernels take CUDA tensors, got one on {t.device}"
            + ("" if torch.cuda.is_available() else
               " (torch sees no GPU)"))
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError("the probes take contiguous float32 tensors, got "
                         f"{t.dtype} (contiguous: {t.is_contiguous()})")


def sm_count() -> int:
    """Streaming multiprocessors of the current CUDA device."""
    return _props(torch.cuda.current_device()).multi_processor_count


@functools.lru_cache(maxsize=None)
def _props(index: int):
    return torch.cuda.get_device_properties(index)


def smi_id() -> str:
    """The current CUDA device as ``nvidia-smi -i`` takes it: its UUID, so
    the card queried is the card timed whatever CUDA_VISIBLE_DEVICES
    maps."""
    uuid = str(_props(torch.cuda.current_device()).uuid)
    return uuid if uuid.startswith("GPU-") else "GPU-" + uuid


def differenced_ms(run: Callable[[int], None], n1: int, n2: int,
                   trials: int, graph: bool = False) -> float:
    """Milliseconds per unit of work: ``run(n)`` enqueues ``n`` units on
    the current stream; the best of ``trials`` CUDA-event times of
    ``run(n1)`` is subtracted from that of ``run(n2)``, so costs that do
    not grow with ``n`` cancel.  ``graph``: ``run(n1)`` and ``run(n2)``
    are captured once each in a CUDA graph and the replays are timed, so
    the host's cost per launch drops out too; a launch counter then sees
    the warm-up and the captures, not the replays."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    run(n1)                      # warm-up, outside any capture
    torch.cuda.synchronize()
    enqueue = {n: functools.partial(run, n) for n in (n1, n2)}
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for n in (n1, n2):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=side):
                    run(n)
                enqueue[n] = g.replay
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
    best = {}
    for n in (n1, n2):
        for _ in range(trials):
            start.record()
            enqueue[n]()
            stop.record()
            stop.synchronize()
            best[n] = min(best.get(n, float("inf")),
                          start.elapsed_time(stop))
    return (best[n2] - best[n1]) / (n2 - n1)


def card() -> Dict[str, object]:
    """``{"name", "power_limit_w"}`` of the current CUDA device from
    ``nvidia-smi``, as ``--query-gpu=name,power.limit --format=csv,noheader``
    gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits", "-i", smi_id()],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name, limit = [x.strip() for x in line.split(",")]
    return {"name": name, "power_limit_w": float(limit)}


class ClockSampler:
    """SM and memory clocks and power draw of the current CUDA device,
    sampled by ``nvidia-smi --loop-ms`` every ``PERIOD_MS`` while the
    ``with`` block runs; ``summary()`` gives their medians and the sample
    count."""

    QUERY = "clocks.sm,clocks.mem,power.draw"
    PERIOD_MS = 100

    def __init__(self):
        self.samples: List[List[float]] = []
        self._proc: Optional[subprocess.Popen] = None

    def __enter__(self) -> "ClockSampler":
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", "-i", smi_id(),
             f"--loop-ms={self.PERIOD_MS}"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=30)
        for line in out.splitlines():
            try:
                self.samples.append([float(x) for x in line.split(",")])
            except ValueError:
                continue          # "[N/A]" or a line cut by terminate

    def summary(self) -> Dict[str, Optional[float]]:
        def median(col):
            vals = sorted(s[col] for s in self.samples)
            return vals[len(vals) // 2] if vals else None
        return {"sm_mhz": median(0), "mem_mhz": median(1),
                "power_w": median(2), "samples": len(self.samples)}

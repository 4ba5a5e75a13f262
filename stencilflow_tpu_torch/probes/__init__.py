"""H100 probes: the hardware model's measured constants.

Ports of the TPU probes under ``scripts/`` as hand-written CUDA kernels
(``csrc/probes/*.cu``), each with a plain torch version and a launch
count, run on the card as

    python -m stencilflow_tpu_torch.probes.copy_floor    # P4, copy floor
    python -m stencilflow_tpu_torch.probes.alu_ceiling   # P1, FP32 ceiling
    python -m stencilflow_tpu_torch.probes.loop_copy     # P7, launch/loop
    python -m stencilflow_tpu_torch.probes.dma_overlap   # P6, overlap
    python -m stencilflow_tpu_torch.probes.async_ring    # P3, cp.async ring
    python -m stencilflow_tpu_torch.probes.table_read    # P2, weight table
    python -m stencilflow_tpu_torch.probes.stateless_panel  # P5, vs K2

The readings of the first three are ``config.H100_*`` and
``config.H100_OP_COST``, which ``report.py`` divides by; the last four
answer design questions of the kernels (PERF.md).  This module holds what
they share: the build of a probe source with the port's nvcc flags, the
shared memory that caps a kernel's residency, differenced CUDA-event
timing, the bound of a case, and the card's name, power limit and clocks
from ``nvidia-smi``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ..config import H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM

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


def vec_of(K: int, *tensors: torch.Tensor) -> int:
    """4 (float4 units) when rows of ``K`` floats and every tensor's base
    are 16-byte aligned, else 1."""
    return 4 if K % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in tensors) else 1


def occupancy_smem(blocks_per_sm: int, least: int = 0) -> int:
    """Dynamic shared memory bytes per block that let exactly
    ``blocks_per_sm`` blocks reside on an SM (0: no cap, ``least``): the
    midpoint between what ``blocks_per_sm`` and one more block would need,
    less the 1 KB the runtime reserves per block.  Raises when the cap is
    below ``least``, the bytes the kernel itself uses."""
    if blocks_per_sm == 0:
        return least
    cap = min(H100_SMEM_PER_BLOCK,
              int(H100_SMEM_PER_SM / (blocks_per_sm + 0.5)) - 1024)
    if blocks_per_sm < 0 or cap < least:
        raise ValueError(f"{blocks_per_sm} blocks per SM leave {cap} B of "
                         f"shared memory a block; the kernel needs {least}")
    return cap


def roofline(bytes_moved: float, ops: float, ms: float) -> Dict[str, object]:
    """The bound of a case (report.HardwareModel: bytes over the data
    sheet's rate against operations over the single-instruction rate) and
    the fractions of it, of P4's copy floor and of P1's issue ceiling
    that ``ms`` reaches."""
    from ..report import HardwareModel
    hw = HardwareModel()
    t_bytes = bytes_moved / hw.hbm_bandwidth * 1e3
    t_ops = ops / hw.alu_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "vs_bound": max(t_bytes, t_ops) / ms,
            "vs_copy_floor": bytes_moved / hw.copy_floor * 1e3 / ms,
            "vs_alu_issue": ops / hw.alu_issue_rate * 1e3 / ms}


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


def host_differenced_ms(run: Callable[[int], None], n1: int, n2: int,
                        trials: int) -> float:
    """``differenced_ms`` on the host clock, for work that runs on the
    CPU: ``run(n)`` returns when its ``n`` units are done."""
    run(n1)                      # warm-up
    best = {}
    for n in (n1, n2):
        for _ in range(trials):
            t0 = time.perf_counter()
            run(n)
            best[n] = min(best.get(n, float("inf")),
                          (time.perf_counter() - t0) * 1e3)
    return (best[n2] - best[n1]) / (n2 - n1)


def pingpong_ms(apply: Callable[[torch.Tensor, torch.Tensor], object],
                a: torch.Tensor, b: torch.Tensor, trials: int,
                graph: bool = True, n1: int = 2, n2: int = 10) -> float:
    """Milliseconds per ``apply(src, dst)``, which writes ``dst`` from
    ``src``, fed output to input between ``a`` and ``b`` (as P7 runs P4's
    copy): ``differenced_ms`` of ``n1`` and ``n2`` applications."""
    def run(n):
        src, dst = a, b
        for _ in range(n):
            apply(src, dst)
            src, dst = dst, src
    return differenced_ms(run, n1, n2, trials, graph=graph)


def require_cuda(what: str) -> bool:
    """The probes' entry points measure the card only: False, with an
    ``error:`` line, when torch sees none."""
    if torch.cuda.is_available():
        return True
    print(f"error: {what} is measured on a CUDA device; torch sees none",
          file=sys.stderr)
    return False


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

"""Cycle-accurate dataflow simulator, on the host.

Copy of the JAX package's ``sim`` (``stencilflow_tpu/sim/``), which
imports no JAX: a software model of the streaming schedule, one element
per cycle through every kernel of the chain, skew absorbed by per-edge
bounded FIFOs sized by the delay/line-buffer analysis.  Overflowing a
FIFO raises, so running the simulator proves the statically computed
buffer bounds (the reference StencilFlow's BoundedQueue discipline).
``run --run-simulation`` holds the H100 kernels' outputs against it.

Two engines with identical semantics: a pure-Python machine (machine.py,
the readable spec) and a C++ core generated per program, built with g++
into ``stencilflow_tpu_torch/_build/sim/`` and driven through ctypes
(native.py).  One intended difference from the original: a scalar input
given as a shape-(1,) array is read as the 0-d scalar it stands for.
"""
from .bounded_queue import BoundedQueue, QueueOverflow, QueueUnderflow
from .machine import SimResult, SimulationError, Simulator


def simulate(program, inputs, native: bool = True, trace=None,
             **kw) -> SimResult:
    """Run the dataflow simulation, preferring the C++ core (falls back to
    the Python machine if the toolchain is unavailable).  ``trace`` (a
    path or file) streams a per-cycle CSV of every kernel's program
    counter and every FIFO's occupancy — tracing always uses the Python
    machine (the engines are semantically identical)."""
    if trace is not None:
        return Simulator(program, **kw).run(inputs, trace=trace)
    if native:
        from .native import NativeBuildError, NativeSimulator
        try:
            sim = NativeSimulator(program, **kw)
        except (OSError, NativeBuildError) as exc:   # toolchain only
            # not silent: missing toolchains (and the rare codegen gap,
            # e.g. bool-subtract programs numpy itself rejects) land on
            # the 100-1000x slower Python machine
            import sys
            print(f"[sim] native core unavailable "
                  f"({type(exc).__name__}: {exc}); falling back to the "
                  f"Python machine (orders of magnitude slower)",
                  file=sys.stderr)
        else:
            return sim.run(inputs)
    return Simulator(program, **kw).run(inputs)


__all__ = ["BoundedQueue", "QueueOverflow", "QueueUnderflow",
           "SimResult", "SimulationError", "Simulator", "simulate"]

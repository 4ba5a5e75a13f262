"""Greedy fast/slow memory placement for stream buffers.

Reference: StencilFlow's stencilflow/optimizer.py:30-356.  Every delay and
line buffer of the streaming schedule starts in fast memory (VMEM); the
optimizer spills chosen buffers to slow memory (HBM circular buffers with
double-buffered async copies) under capacity / bandwidth bounds.  Metric and
update rule mirror the reference: a buffer's spill "price" is the extra
slow-memory streaming traffic it introduces — ``C`` bytes per fast↔slow
boundary it creates, where ``C`` is the full-array stream volume — and the
greedy loop always spills the buffer with the best bytes-freed-per-traffic
ratio, updating its chain neighbors' prices ((fast,fast)=2C, (fast,slow)=C,
(slow,slow)=0; optimizer.py:209-248,301-307).

The result is a set of ``swap_out`` marks consumed by the report
(``report --verbose`` and ``--optimize-ratio``).

Copied from ``stencilflow_tpu/optimizer.py`` with no change of meaning
(pure numpy; the port cannot import the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .frontend.analysis import ChainAnalysis
from .ir import Program


class OptimizerError(RuntimeError):
    pass


@dataclasses.dataclass
class Buffer:
    """One spillable buffer: an edge's delay or line buffer."""
    edge: Tuple[str, str]
    kind: str                # "delay" | "internal"
    bytes: int
    stream_volume: int       # C: full-array traffic if this buffer streams
    swap_out: bool = False
    prev: Optional["Buffer"] = None   # chain neighbor (upstream)
    next: Optional["Buffer"] = None   # chain neighbor (downstream)

    @property
    def name(self) -> str:
        return f"{self.edge[0]}->{self.edge[1]}:{self.kind}"

    def comm_cost(self) -> int:
        """Extra slow-memory traffic of spilling this buffer now."""
        boundaries = 2
        for nb in (self.prev, self.next):
            if nb is not None and nb.swap_out:
                boundaries -= 1
        return boundaries * self.stream_volume


class Optimizer:
    def __init__(self, program: Program,
                 analysis: Optional[ChainAnalysis] = None):
        self.program = program
        self.analysis = analysis or ChainAnalysis.run(program)
        self.buffers: List[Buffer] = []
        n = program.total_elements
        for key, eb in self.analysis.edges.items():
            itemsize = np.dtype(eb.dtype).itemsize
            c = n * itemsize
            chain = []
            if eb.delay_size > 0:
                chain.append(Buffer(key, "delay", eb.delay_size * itemsize,
                                    c))
            if eb.internal_size > 0:
                chain.append(Buffer(key, "internal",
                                    eb.internal_size * itemsize, c))
            for a, b in zip(chain, chain[1:]):
                a.next, b.prev = b, a
            self.buffers.extend(chain)

    # -- state ----------------------------------------------------------------
    def fast_bytes(self) -> int:
        return sum(b.bytes for b in self.buffers if not b.swap_out)

    def slow_bytes(self) -> int:
        return sum(b.bytes for b in self.buffers if b.swap_out)

    def comm_volume(self) -> int:
        """Total slow-memory streaming traffic of the current placement."""
        total = 0
        for b in self.buffers:
            if not b.swap_out:
                continue
            for nb, weight in ((b.prev, 1), (b.next, 1)):
                if nb is None or not nb.swap_out:
                    total += weight * b.stream_volume
        return total

    def reset(self) -> None:
        for b in self.buffers:
            b.swap_out = False

    # -- greedy core ----------------------------------------------------------
    def _best_candidate(self) -> Optional[Buffer]:
        best, best_ratio = None, -1.0
        for b in self.buffers:
            if b.swap_out or b.bytes == 0:
                continue
            cost = b.comm_cost()
            ratio = b.bytes / cost if cost > 0 else float("inf")
            if ratio > best_ratio:
                best, best_ratio = b, ratio
        return best

    # -- strategies (reference: optimizer.py:73-150) ---------------------------
    def minimize_fast_mem(self, comm_volume_bound: int) -> None:
        """Spill as much as possible while staying under the slow-memory
        traffic bound."""
        self.reset()
        while True:
            cand = self._best_candidate()
            if cand is None:
                return
            cand.swap_out = True
            if self.comm_volume() > comm_volume_bound:
                cand.swap_out = False
                return

    def minimize_comm_vol(self, fast_memory_bound: int,
                          slow_memory_bound: int) -> None:
        """Spill the cheapest set that brings fast memory under its bound."""
        self.reset()
        while self.fast_bytes() > fast_memory_bound:
            cand = self._best_candidate()
            if cand is None:
                raise OptimizerError(
                    f"cannot reach fast-memory bound {fast_memory_bound}; "
                    f"irreducible {self.fast_bytes()} bytes")
            cand.swap_out = True
            if self.slow_bytes() > slow_memory_bound:
                raise OptimizerError(
                    f"slow-memory bound {slow_memory_bound} exceeded "
                    f"({self.slow_bytes()} bytes)")

    def _remaining_comm_volume(self) -> int:
        """Sum of spill-traffic costs over the still-fast candidates (the
        reference's denominator: remaining metric_data comm_vol)."""
        return sum(b.comm_cost() for b in self.buffers
                   if not b.swap_out and b.bytes > 0)

    def optimize_to_ratio(self, ratio: float) -> None:
        """Spill while ``fast_bytes / remaining-candidate comm volume``
        exceeds ``ratio`` — the reference's metric verbatim
        (StencilFlow's stencilflow/optimizer.py:130-168: ratio() =
        fast_memory_use / sum(remaining comm_vol) + eps)."""
        from .config import EPS
        self.reset()
        while (self.fast_bytes()
               / (self._remaining_comm_volume() + EPS)) > ratio:
            cand = self._best_candidate()
            if cand is None:
                return
            cand.swap_out = True

    # -- reporting -------------------------------------------------------------
    def placement(self) -> Dict[str, Dict]:
        return {
            b.name: {"bytes": b.bytes, "memory":
                     "slow" if b.swap_out else "fast"}
            for b in self.buffers
        }

    def summary(self) -> str:
        lines = [f"fast memory: {self.fast_bytes()} B, slow memory: "
                 f"{self.slow_bytes()} B, comm volume: "
                 f"{self.comm_volume()} B"]
        for b in self.buffers:
            lines.append(f"  {b.name}: {b.bytes} B -> "
                         f"{'slow' if b.swap_out else 'fast'}")
        return "\n".join(lines)

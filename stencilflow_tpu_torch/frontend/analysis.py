"""Static analyses of a stencil chain: access extents, internal (line) buffer
sizes, inter-kernel delay alignment, pipeline latencies, critical path, op
counts, communication volume and the cumulative halos.

These reproduce the semantics of the reference's analyses —
``ComputeGraph.setup_internal_buffers`` (compute_graph.py:112-171),
``KernelChainGraph.compute_delay_buffer`` (kernel_chain_graph.py:476-559),
``calculate_latency`` (compute_graph.py:461-474), critical path
(kernel_chain_graph.py:576-601), ``operation_count`` / communication volume /
runtime lower bound (kernel_chain_graph.py:721-774) — but as pure functions
over the typed IR instead of mutating queue objects.

One deliberate deviation: per-edge delay buffers are computed from a single
per-node arrival time (max over *all* paths), rather than the reference's
per-source-array bookkeeping whose per-edge results depend on dict iteration
order when multiple source arrays share a predecessor.  For well-formed
programs the results coincide.

In the port these numbers drive the kernel planners (``stage_halo`` and
``input_halo`` size the halo-widened tiles of backend/panel.py and
backend/overlap.py) and the analytic report (report.py).

Copied from ``stencilflow_tpu/frontend/analysis.py`` with no change of
meaning: the port cannot import the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from ..config import OP_LATENCY
from .chain import ChainGraph

Vec3 = Tuple[int, int, int]


def flatten_index(index: Sequence[Optional[int]],
                  dimensions: Sequence[int]) -> int:
    """Row-major flattening of a (possibly None-masked) 3-D index
    (reference: helper.dim_to_abs_val / convert_3d_to_1d)."""
    dims = list(dimensions)
    total = 0
    for off, stride_dims in zip(index, range(len(dims))):
        if off is None:
            continue
        stride = reduce(lambda a, b: a * b, dims[stride_dims + 1:], 1)
        total += off * stride
    return total


def _lex_max(vectors: List[Vec3]) -> Vec3:
    """Componentwise max (a safe over-approximation of the reference's
    per-path bookkeeping: flatten(cw-max) >= flatten(v) for every v, so
    delay buffers sized from it always absorb the true skew — lexicographic
    max can undershoot for asymmetric access sets)."""
    if not vectors:
        return (0, 0, 0)
    return tuple(max(v[d] for v in vectors) for d in range(3))


def _vec_add(a: Sequence[int], b: Sequence[int]) -> Vec3:
    return tuple(x + y for x, y in zip(a, b))


def _vec_sub(a: Sequence[int], b: Sequence[int]) -> Vec3:
    return tuple(x - y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Per-kernel access analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FieldAccessInfo:
    """Access footprint of one kernel on one upstream field."""
    field: str
    accesses: List[ir.Offsets]
    min_offsets: Vec3              # dense (None -> 0)
    max_offsets: Vec3
    buffer_extent: Vec3            # max - min, +W-1 in fastest dim
    buffer_size: int               # flattened element count


def analyze_kernel_accesses(kspec: ir.KernelSpec, dimensions: Vec3,
                            vectorization: int
                            ) -> Dict[str, FieldAccessInfo]:
    """Internal (line-)buffer extents per accessed field
    (reference: compute_graph.py:112-171)."""
    out: Dict[str, FieldAccessInfo] = {}
    for field, accesses in kspec.accesses().items():
        dense = [tuple(0 if o is None else o for o in a) for a in accesses]
        mins = tuple(min(v[d] for v in dense) for d in range(3))
        maxs = tuple(max(v[d] for v in dense) for d in range(3))
        extent = list(_vec_sub(maxs, mins))
        extent[-1] += vectorization - 1
        extent = tuple(extent)
        out[field] = FieldAccessInfo(
            field=field,
            accesses=list(accesses),
            min_offsets=mins,
            max_offsets=maxs,
            buffer_extent=extent,
            buffer_size=flatten_index(extent, dimensions),
        )
    return out


# ---------------------------------------------------------------------------
# Per-kernel compute latency and op counts
# ---------------------------------------------------------------------------

_CALL_LATENCY_KEYS = {
    "min": "min", "max": "max", "abs": "abs",
}


def _op_latency_of(node: ir.Expr) -> int:
    if isinstance(node, ir.BinOp):
        return OP_LATENCY[node.op]
    if isinstance(node, ir.UnaryOp):
        return OP_LATENCY["neg"]
    if isinstance(node, ir.Compare):
        return OP_LATENCY["comp"]
    if isinstance(node, ir.BoolOp):
        return OP_LATENCY["bool"]
    if isinstance(node, ir.Select):
        return OP_LATENCY["cond"]
    if isinstance(node, ir.Call):
        key = _CALL_LATENCY_KEYS.get(node.fn, node.fn)
        return OP_LATENCY.get(key, 128)
    return 0  # Const / Ref / Access


def kernel_latency(kspec: ir.KernelSpec, vectorization: int) -> int:
    """Longest op-latency path through the kernel's compute DAG, divided by
    the vector width (reference: compute_graph.py:461-474)."""
    temp_latency: Dict[str, int] = {}

    def depth(node: ir.Expr) -> int:
        children: Tuple[ir.Expr, ...]
        if isinstance(node, ir.BinOp):
            children = (node.left, node.right)
        elif isinstance(node, ir.UnaryOp):
            children = (node.operand,)
        elif isinstance(node, ir.Compare):
            children = (node.left, node.right)
        elif isinstance(node, ir.BoolOp):
            children = node.operands
        elif isinstance(node, ir.Select):
            children = (node.cond, node.if_true, node.if_false)
        elif isinstance(node, ir.Call):
            children = node.args
        elif isinstance(node, ir.Ref):
            return temp_latency.get(node.name, 0)
        else:
            children = ()
        base = max((depth(c) for c in children), default=0)
        return base + _op_latency_of(node)

    for stmt in kspec.statements:
        temp_latency[stmt.lhs] = depth(stmt.rhs)
    # +1 for the output node, as in the reference's latency tree walk
    total = temp_latency[kspec.output_statement.lhs] + 1
    return max(1, math.ceil(total / vectorization))


def operation_count(kspec: ir.KernelSpec) -> Dict[str, int]:
    """Count arithmetic ops per output element (reference: helper.OpCounter +
    kernel_chain_graph.operation_count)."""
    counts: Dict[str, int] = {}

    def bump(key: str):
        counts[key] = counts.get(key, 0) + 1

    for stmt in kspec.statements:
        for node in ir.walk(stmt.rhs):
            if isinstance(node, ir.BinOp):
                bump(node.op)
            elif isinstance(node, ir.UnaryOp):
                bump("neg")
            elif isinstance(node, ir.Compare):
                bump("comp")
            elif isinstance(node, ir.BoolOp):
                bump("bool")
            elif isinstance(node, ir.Select):
                bump("cond")
            elif isinstance(node, ir.Call):
                bump(node.fn)
    return counts


# ---------------------------------------------------------------------------
# Chain-level analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EdgeBuffers:
    """Buffering on one producer->kernel edge of the chain."""
    src: str
    dst: str
    delay_extent: Vec3        # alignment skew (k-units folded with latency)
    delay_size: int           # flattened element count
    internal_size: int        # line-buffer span the consumer keeps for src
    dtype: np.dtype

    @property
    def total_elements(self) -> int:
        return self.delay_size + self.internal_size

    def total_bytes(self) -> int:
        return self.total_elements * np.dtype(self.dtype).itemsize


@dataclasses.dataclass
class ChainAnalysis:
    """All static analysis results for one program."""
    program: ir.Program
    graph: ChainGraph
    kernel_accesses: Dict[str, Dict[str, FieldAccessInfo]]
    kernel_latencies: Dict[str, int]
    arrival: Dict[str, Vec3]          # per-node max-over-preds contribution
    contribution: Dict[str, Vec3]     # per-node path-length vector
    edges: Dict[Tuple[str, str], EdgeBuffers]
    critical_path_cycles: int

    # -- factory ------------------------------------------------------------
    @classmethod
    def run(cls, program: ir.Program,
            graph: Optional[ChainGraph] = None) -> "ChainAnalysis":
        graph = graph or ChainGraph.build(program)
        dims = program.dimensions
        W = program.vectorization

        accesses = {
            k: analyze_kernel_accesses(spec, dims, W)
            for k, spec in program.kernels.items()
        }
        latencies = {
            k: kernel_latency(spec, W) for k, spec in program.kernels.items()
        }

        # Arrival/contribution propagation (reference:
        # kernel_chain_graph.py:476-559).  contribution(u) = the path-length
        # vector a successor of u sees: for inputs 0, for kernels
        # arrival(u) + max access extent + (0,0,latency).
        arrival: Dict[str, Vec3] = {}
        contribution: Dict[str, Vec3] = {}
        for node in graph.order:
            if node in program.inputs:
                arrival[node] = (0, 0, 0)
                contribution[node] = (0, 0, 0)
                continue
            preds = graph.producers(node)
            arrival[node] = _lex_max([contribution[p] for p in preds])
            max_access = _lex_max([
                _lex_max([tuple(0 if o is None else o for o in a)
                          for a in info.accesses])
                for info in accesses[node].values()
            ])
            contrib = _vec_add(arrival[node], max_access)
            contribution[node] = (contrib[0], contrib[1],
                                  contrib[2] + latencies[node])

        # Per-edge delay buffers: align every in-edge to the slowest one,
        # +1 cycle for kernel-internal processing
        # (reference: kernel_chain_graph.py:495-512).
        edges: Dict[Tuple[str, str], EdgeBuffers] = {}
        for kname in graph.kernel_order:
            preds = graph.producers(kname)
            max_contrib = _lex_max([contribution[p] for p in preds])
            max_contrib = (max_contrib[0], max_contrib[1], max_contrib[2] + 1)
            for p in preds:
                skew = _vec_sub(max_contrib, contribution[p])
                delay_size = max(0, flatten_index(skew, dims))
                info = accesses[kname][p]
                edges[(p, kname)] = EdgeBuffers(
                    src=p,
                    dst=kname,
                    delay_extent=skew,
                    delay_size=delay_size,
                    internal_size=info.buffer_size,
                    dtype=program.field_dtype(p),
                )

        # Critical path (reference: kernel_chain_graph.py:576-601): the
        # contribution vector of the slowest output, flattened to cycles.
        cp_vec = _lex_max([contribution[o] for o in program.outputs])
        critical_path = max(0, flatten_index(cp_vec, dims))

        return cls(program, graph, accesses, latencies, arrival,
                   contribution, edges, critical_path)

    # -- analytic models ------------------------------------------------------
    def operation_counts(self) -> Dict[str, Tuple[int, int]]:
        """{op: (per cycle, total)} over all kernels
        (reference: kernel_chain_graph.py:721-747)."""
        n = self.program.total_elements
        totals: Dict[str, Tuple[int, int]] = {}
        for kspec in self.program.kernels.values():
            for op, cnt in operation_count(kspec).items():
                per_cycle, total = totals.get(op, (0, 0))
                totals[op] = (per_cycle + cnt, total + cnt * n)
        return totals

    def minimum_communication_volume(self) -> int:
        """Bytes: every input + output array moved exactly once
        (reference: kernel_chain_graph.py:749-768)."""
        vol = 0
        dims = self.program.dimensions
        for spec in self.program.inputs.values():
            n = reduce(lambda a, b: a * b, spec.shape(dims), 1)
            vol += np.dtype(spec.dtype).itemsize * n
        n = self.program.total_elements
        for out in self.program.outputs:
            vol += np.dtype(self.program.kernels[out].dtype).itemsize * n
        return vol

    def runtime_lower_bound(self) -> int:
        """Cycles (reference: kernel_chain_graph.py:770-774)."""
        return ((self.program.total_elements + self.critical_path_cycles)
                // self.program.vectorization)

    def fast_memory_elements(self) -> int:
        """Total on-chip buffer elements (delay + internal across all edges)."""
        return sum(e.total_elements for e in self.edges.values())

    def fast_memory_bytes(self) -> int:
        return sum(e.total_bytes() for e in self.edges.values())

    def stage_halo(self) -> Dict[str, Vec3]:
        """Cumulative halo each kernel's *output tile* must carry so that a
        fused evaluation of the whole chain over one tile produces an exact
        core region.  halo(k) = max over consumers c of
        halo(c) + radius(c reads k), where radius is the max |offset| per dim.

        This is the tiled-TPU equivalent of the reference's delay/line buffer
        sizing: instead of skewing streams in time, we widen tiles in space.
        """
        halo: Dict[str, Vec3] = {}
        for kname in reversed(self.graph.kernel_order):
            h = [0, 0, 0]
            for succ in self.graph.consumers(kname):
                if succ not in self.program.kernels:
                    continue
                info = self.kernel_accesses[succ][kname]
                radius = tuple(
                    max(abs(info.min_offsets[d]), abs(info.max_offsets[d]))
                    for d in range(3))
                succ_halo = halo.get(succ, (0, 0, 0))
                for d in range(3):
                    h[d] = max(h[d], succ_halo[d] + radius[d])
            halo[kname] = tuple(h)
        return halo

    def input_halo(self) -> Dict[str, Vec3]:
        """Halo needed on each program *input* for a fused tile evaluation."""
        khalo = self.stage_halo()
        out: Dict[str, Vec3] = {}
        for iname in self.program.inputs:
            h = [0, 0, 0]
            for succ in self.graph.consumers(iname):
                info = self.kernel_accesses[succ][iname]
                radius = tuple(
                    max(abs(info.min_offsets[d]), abs(info.max_offsets[d]))
                    for d in range(3))
                succ_halo = khalo.get(succ, (0, 0, 0))
                for d in range(3):
                    h[d] = max(h[d], succ_halo[d] + radius[d])
            out[iname] = tuple(h)
        return out

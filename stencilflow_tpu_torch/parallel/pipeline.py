"""Operator-pipeline split across the positions of a mesh axis.

Port of ``stencilflow_tpu/parallel/pipeline.py`` (the reference's
``split_sdfg``: the FPGA pipeline cut at a stream, the halves bridged by
remote FIFOs).  The domain is chunked along i; position ``s`` of the
pipeline axis owns the ``s``-th segment of the kernel DAG and at step
``t`` runs it on chunk ``t - s``, after which the fields that cross its
cut hop to position ``s + 1``: ``S + C - 1`` steps take C chunks through
S segments, every position busy on a different chunk.  The cut search
(``split_kernels`` ... ``optimize_split``) is the reference's, unchanged
in meaning, with the port's H100 op costs (``report._OP_COST``).

Single controller within a process, as ``domain.py``: one process
drives the mesh positions it holds (``mesh.Mesh``), a segment runs on
its position's device, and a hop hands each tensor to the next
position's device (``Tensor.to``: a copy between distinct devices, none
on a mesh that repeats a device), or, where another process holds the
next position, sends it there (``_Hops``, a round of
``transport.Transfers`` a step).
Every step's results are new tensors, so a hop never overwrites a tile
that another position still reads in the same step (the reference's
``ppermute`` is simultaneous; an in-place copy on a repeated device
would not be).  The replicated-io body takes the outputs from the last
position directly; the sharded-io body keeps the reference's three rings
(feed, cut carry, output return), each a shift of references between
positions.

Segment geometry.  The reference widens every segment's chunk tile by
the whole chain's halo in every dim and launches each segment's stream
kernel at the origin (c * chunk - h0, -h1, -h2).  A pipeline position
holds the whole (j, k) plane, where every j/k read past the domain is
decided by its BC mask at global coordinates, so here a segment runs K4
in chunk mode instead (``stream.plan_local`` with no shard: the whole
plane, an origin in i only, the kernel the out-of-core path runs), and
no launch takes a negative j/k origin.  Segment ``s`` reads its inputs
over ``chunk + 2 E_s`` planes and writes its outputs over ``chunk + 2
W_s``: ``W_s`` is the widest ``E`` of the later segments that read them,
``E_s = W_s + h_s`` with ``h_s`` the segment's own i-halo
(``PipelineSplit.widen`` / ``emit``).  That recomputes less: jacobi3d
512^3 x 8 over 4 segments reads 144, 140, 136 and 132 planes of 512^2 a
chunk, against 4 x 144 planes of 528^2.  The dense tile body (the
reference's "xla" body) takes the same geometry; with ``domain_axes``
the sharded j/k dims are widened the same way, with data gathered from
domain neighbours (``_gather_axis_halo``, multi-hop).  The planes of a
carried tile past the domain hold whatever the segment computed there;
every read of them is masked by a BC, so only final outputs are
comparable with the reference's, whose margins differ.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import ir
from ..backend.dense import chain_halo
from ..backend.tile_eval import evaluate_chain_tile
from ..dtypes import to_torch, to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from ..frontend.chain import ChainGraph
from .mesh import Mesh, ShardedArray

Vec3 = Tuple[int, int, int]
Coord = Tuple[int, ...]


def split_kernels(graph: ChainGraph, num_segments: int) -> List[List[str]]:
    """Cut the topologically ordered kernel list into contiguous segments
    (each prefix is downward-closed, so every cut is valid — the analogue of
    choosing a cut from enumerate_cuts)."""
    order = graph.kernel_order
    n = len(order)
    if num_segments > n:
        raise ValueError(f"cannot split {n} kernels into {num_segments} "
                         "segments")
    bounds = [round(i * n / num_segments) for i in range(num_segments + 1)]
    segments = [order[bounds[i]:bounds[i + 1]] for i in range(num_segments)]
    if any(not s for s in segments):
        raise ValueError("empty pipeline segment; use fewer segments")
    return segments


def split_kernels_at(graph: ChainGraph,
                     cut_after: Sequence[str]) -> List[List[str]]:
    """Cut the pipeline at named kernels: each segment ends just after a
    named kernel (its output is the inter-device stream — the analogue of
    the reference's split at a named stream, sdfg_generator.py:782).  The
    resulting ``len(cut_after)+1`` segments stay in topological order."""
    order = graph.kernel_order
    pos = {k: i for i, k in enumerate(order)}
    missing = [k for k in cut_after if k not in pos]
    if missing:
        raise ValueError(f"unknown cut kernel(s): {missing}; "
                         f"kernels are {order}")
    idxs = sorted(pos[k] for k in cut_after)
    if len(set(idxs)) != len(cut_after):
        raise ValueError("duplicate cut kernels")
    if idxs and idxs[-1] == len(order) - 1:
        raise ValueError(f"cannot cut after the last kernel "
                         f"{order[-1]!r}: the tail segment would be empty")
    bounds = [0] + [i + 1 for i in idxs] + [len(order)]
    return [order[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]


def split_kernels_at_cut(graph: ChainGraph,
                         before: Sequence[str]) -> List[List[str]]:
    """Segments ``[before, after]`` for an ARBITRARY downward-closed cut
    set — any member of ``graph.enumerate_cuts()``, including cuts that
    are not a prefix of the global topological order (forks with
    interleaved branches).  Each segment is the topological order
    restricted to its side, which is a valid order of the induced
    subgraph, so the wavefront executor runs it unchanged (the
    reference's cut-at-any-stream, sdfg_generator.py:782)."""
    order = graph.kernel_order
    bset = set(before)
    unknown = sorted(bset - set(order))
    if unknown:
        raise ValueError(f"unknown cut kernel(s): {unknown}; "
                         f"kernels are {order}")
    if not bset or len(bset) == len(order):
        raise ValueError("cut must be a non-trivial kernel subset")
    for k in sorted(bset):
        for p in graph.producers(k):
            if p in graph.program.kernels and p not in bset:
                raise ValueError(
                    f"cut is not downward-closed: {k!r} (inside) reads "
                    f"{p!r} (outside); valid cuts are "
                    "graph.enumerate_cuts() members")
    return [[k for k in order if k in bset],
            [k for k in order if k not in bset]]


def validate_segments(graph: ChainGraph,
                      segments: Sequence[Sequence[str]]
                      ) -> List[List[str]]:
    """Check an explicit segment partition: every kernel exactly once and
    no dependency from a later segment back into an earlier one.  Returns
    the segments re-ordered internally by the global topological order
    (any such subsequence is a valid order of the induced subgraph)."""
    order = graph.kernel_order
    seg_of: Dict[str, int] = {}
    for si, seg in enumerate(segments):
        for k in seg:
            if k in seg_of:
                raise ValueError(f"kernel {k!r} appears in segments "
                                 f"{seg_of[k]} and {si}")
            seg_of[k] = si
    missing = [k for k in order if k not in seg_of]
    extra = sorted(set(seg_of) - set(order))
    if missing or extra:
        raise ValueError(f"segments must partition the kernels; "
                         f"missing={missing} unknown={extra}")
    if any(not s for s in segments):
        raise ValueError("empty pipeline segment")
    for k in order:
        for p in graph.producers(k):
            if p in seg_of and seg_of[p] > seg_of[k]:
                raise ValueError(
                    f"segment {seg_of[k]} kernel {k!r} reads {p!r} from "
                    f"later segment {seg_of[p]}: each segment's producers "
                    "must live in the same or an earlier segment")
    return [[k for k in order if seg_of[k] == si]
            for si in range(len(segments))]


def optimize_split(program: ir.Program, graph: ChainGraph,
                   num_segments: int) -> Tuple[List[List[str]], Dict]:
    """Search contiguous cuts for the best pipeline partition: minimize
    the bottleneck segment's compute load (weighted ops/cell), breaking
    ties on inter-device stream traffic (bytes/cell crossing the cuts).
    This is the role the reference's ``enumerate_cuts`` search serves for
    its multi-FPGA partitioning (kernel_chain_graph.py:116-160); for the
    wavefront pipeline only contiguous topological cuts are valid, so the
    search is two exact O(n²·S) DPs (minimal bottleneck, then minimal
    crossing among bottleneck-optimal partitions) rather than an
    enumeration.  Ops are weighted by the H100 costs of
    ``report._OP_COST``.

    Returns ``(segments, stats)`` with per-segment loads and per-cut
    crossing bytes.
    """
    from ..frontend.analysis import operation_count
    from ..report import _OP_COST
    order = graph.kernel_order
    n = len(order)
    if num_segments > n:
        raise ValueError(f"cannot split {n} kernels into {num_segments} "
                         "segments")
    load = []
    for k in order:
        ops = operation_count(program.kernels[k])
        load.append(sum(c * _OP_COST.get(op, 1) for op, c in ops.items()))
    prefix = [0]
    for v in load:
        prefix.append(prefix[-1] + v)

    idx = {k: i for i, k in enumerate(order)}
    # crossing bytes per cell for a cut after position i: kernel fields
    # produced at <= i and read later (program inputs are replicated);
    # program outputs produced early ride the carry across every later
    # cut until emission, so they always cross
    cross = [0] * n
    for i in range(n - 1):
        total = 0
        for j, k in enumerate(order):
            if j > i:
                continue
            reads_later = any(idx.get(c, -1) > i
                              for c in graph.consumers(k)
                              if c in program.kernels)
            if reads_later or k in program.outputs:
                total += np.dtype(program.kernels[k].dtype).itemsize
        cross[i] = total

    INF = float("inf")
    # phase 1 — exact minimal bottleneck: dp1[s][j] = min over cuts of
    # the max segment load splitting order[:j] into s segments
    dp1 = [[INF] * (n + 1) for _ in range(num_segments + 1)]
    dp1[0][0] = 0.0
    for s in range(1, num_segments + 1):
        for j in range(s, n + 1):
            dp1[s][j] = min(
                (max(dp1[s - 1][i], prefix[j] - prefix[i])
                 for i in range(s - 1, j)), default=INF)
    bstar = dp1[num_segments][n]
    # phase 2 — among partitions whose every segment load <= bstar,
    # exactly minimize total crossing bytes
    dp2 = [[INF] * (n + 1) for _ in range(num_segments + 1)]
    cut_at = [[-1] * (n + 1) for _ in range(num_segments + 1)]
    dp2[0][0] = 0.0
    for s in range(1, num_segments + 1):
        for j in range(s, n + 1):
            for i in range(s - 1, j):
                if dp2[s - 1][i] == INF or \
                        prefix[j] - prefix[i] > bstar:
                    continue
                c = dp2[s - 1][i] + (cross[i - 1] if i > 0 else 0)
                if c < dp2[s][j]:
                    dp2[s][j] = c
                    cut_at[s][j] = i
    # reconstruct
    bounds = [n]
    j = n
    for s in range(num_segments, 0, -1):
        j = cut_at[s][j]
        bounds.append(j)
    bounds.reverse()
    segments = [order[bounds[i]:bounds[i + 1]]
                for i in range(num_segments)]
    stats = {
        "segment_loads": [prefix[bounds[i + 1]] - prefix[bounds[i]]
                          for i in range(num_segments)],
        "cut_bytes_per_cell": [cross[bounds[i + 1] - 1]
                               for i in range(num_segments - 1)],
        "bottleneck_load": bstar,
    }
    return segments, stats


@dataclasses.dataclass
class PipelineSplit:
    program: ir.Program
    mesh: Mesh
    axis: str                      # mesh axis carrying pipeline stages
    segments: List[List[str]]
    halo: Vec3
    num_chunks: int
    chunk: int                     # chunk extent along dim 0
    # pipeline x domain composition: domain dim (1=j / 2=k) -> mesh axis
    # carrying that dim's shards (None/{}: full domain per device)
    domain_axes: Optional[Dict[int, str]] = None
    # the port's segment geometry (module docstring): per segment, cells
    # of widening each side of its input tiles (E) and of its output
    # tiles (W), per dim; 0 in a dim a position holds whole
    widen: List[Vec3] = dataclasses.field(default_factory=list)
    emit: List[Vec3] = dataclasses.field(default_factory=list)

    def seg_of(self) -> Dict[str, int]:
        return {k: i for i, seg in enumerate(self.segments) for k in seg}

    def reach(self) -> Vec3:
        """The widest input widening of any segment: program inputs are
        widened by it once."""
        return tuple(max(w[d] for w in self.widen) for d in range(3))


def _gather_axis_halo(shards: Dict[Coord, torch.Tensor], mesh: Mesh,
                      mesh_axis: Optional[str], pos: int, h: int, local: int
                      ) -> Dict[Coord, torch.Tensor]:
    """Widen every position's tensor by ``h`` cells on both sides of array
    axis ``pos`` with data from its neighbours along ``mesh_axis`` —
    from as many neighbours as ``h`` spans (multi-hop when ``h`` exceeds
    the local extent ``local``).  Cells past the global edge are zeros,
    which the BC masks at global coordinates correct (the widened-tile
    discipline).  With one position on the axis, or no axis
    (``mesh_axis`` None), this is zero padding.  A neighbour on another
    process sends its part in one round of ``transport.Transfers``.  Also
    used by ``outofcore.compile_chunked_sharded``."""
    if h == 0:
        return dict(shards)
    ax = None if mesh_axis is None else mesh.axis_names.index(mesh_axis)
    n = 1 if ax is None else mesh.shape[mesh_axis]
    xfer = None
    if mesh.distributed:
        from .transport import Transfers
        xfer = Transfers(mesh)
    like = next(iter(shards.values()))
    shape = list(like.shape)
    shape[pos] = local + 2 * h
    out = {}
    for c in (mesh.coords() if xfer is not None else list(shards)):
        i = 0 if ax is None else c[ax]
        w = shards[c].new_zeros(shape) if c in shards else None
        if w is not None:
            out[c] = w
        lo = i * local - h            # global index of w's first cell
        for q in range(max(0, lo // local),
                       min(n, (lo + local + 2 * h - 1) // local + 1)):
            a = max(lo, q * local)
            b = min(lo + local + 2 * h, (q + 1) * local)
            src_c = c if ax is None else c[:ax] + (q,) + c[ax + 1:]
            src = (shards[src_c].narrow(pos, a - q * local, b - a)
                   if src_c in shards else None)
            dst = None if w is None else w.narrow(pos, a - lo, b - a)
            if xfer is None:
                dst.copy_(src, non_blocking=True)
            else:
                xfer.move(src_c, c, src, lambda v, dst=dst: dst.copy_(
                    v, non_blocking=True), like=dst)
    if xfer is not None:
        xfer.run()
    return out


def _narrow(t: torch.Tensor, spanned: Sequence[int], have: Sequence[int],
            want: Sequence[int]) -> torch.Tensor:
    """A tile widened by ``have`` cut down to ``want`` (per global dim;
    ``spanned``: the global dim of each array dim)."""
    for pos, d in enumerate(spanned):
        cut = have[d] - want[d]
        if cut:
            t = t.narrow(pos, cut, t.shape[pos] - 2 * cut)
    return t


def _spanned(spec: ir.InputSpec) -> List[int]:
    return [d for d in range(3) if spec.dim_mask[d]]


def _segment_eval(program, graph, segment, tiles, origin, halo):
    """Evaluate one contiguous kernel segment on a widened tile dict."""
    sub_order = [n for n in graph.order if n not in program.kernels
                 or n in segment]
    # evaluate_chain_tile walks graph.kernel_order; restrict via a shallow
    # proxy graph that only exposes this segment's kernels.
    proxy = dataclasses.replace(graph)
    proxy.order = sub_order
    return evaluate_chain_tile(program, proxy, tiles, origin, halo,
                               keep=segment)


def _segment_program(program: ir.Program, graph: ChainGraph,
                     segment: List[str], seg_idx: int,
                     later_kernels: Set[str]) -> ir.Program:
    """Stand-alone sub-program for one pipeline segment.

    Upstream kernel fields the segment reads become full-3D inputs (their
    widened tiles arrive in the pipeline carry); outputs are the segment's
    kernels consumed by ``later_kernels`` (membership in later segments —
    NOT topological position, so non-prefix downward-closed cuts work) or
    by the program itself.  Global ``dimensions`` are kept — boundary-
    condition masks must see global coordinates (the widened-tile origin
    is supplied at run time)."""
    seg_set = set(segment)
    kernels = {k: program.kernels[k] for k in segment}
    inputs: Dict[str, ir.InputSpec] = {}
    for k in segment:
        for f in program.kernels[k].accesses():
            if f in seg_set or f in inputs:
                continue
            if f in program.inputs:
                inputs[f] = program.inputs[f]
            else:
                inputs[f] = ir.InputSpec(f, program.kernels[f].dtype,
                                         (True, True, True), None)
    later_reads = set()
    for k in later_kernels:
        later_reads.update(program.kernels[k].accesses())
    outs = [k for k in segment
            if k in later_reads or k in program.outputs]
    return dataclasses.replace(program,
                               name=f"{program.name}_seg{seg_idx}",
                               inputs=inputs, outputs=outs, kernels=kernels)


def _segment_programs(program: ir.Program, graph: ChainGraph,
                      segments: List[List[str]]):
    """Every segment's sub-program and its analysis."""
    subs = []
    for seg_idx, segment in enumerate(segments):
        later = {k for s in segments[seg_idx + 1:] for k in s}
        subp = _segment_program(program, graph, segment, seg_idx, later)
        subs.append((subp, ChainAnalysis.run(subp)))
    return subs


def _segment_geometry(program: ir.Program, segments: List[List[str]],
                      subs, cut: Sequence[bool]):
    """(widen, emit) of every segment (``PipelineSplit``): ``emit[s]`` is
    the widest ``widen`` of the later segments reading segment ``s``'s
    fields, ``widen[s]`` that plus the segment's own halo, in the dims
    ``cut`` marks (0 in the others)."""
    S = len(segments)
    seg_of = {k: i for i, seg in enumerate(segments) for k in seg}
    widen: List[Vec3] = [None] * S
    emit: List[Vec3] = [None] * S
    for s in reversed(range(S)):
        w = [0, 0, 0]
        for s2 in range(s + 1, S):
            if any(seg_of.get(f) == s for f in subs[s2][0].inputs):
                w = [max(a, b) for a, b in zip(w, widen[s2])]
        h = chain_halo(subs[s][1])
        emit[s] = tuple(w)
        widen[s] = tuple(w[d] + h[d] if cut[d] else 0 for d in range(3))
    return widen, emit


def _cut_layouts(program: ir.Program, graph: ChainGraph,
                 segments: List[List[str]]) -> List[List[str]]:
    """Per cut: the fields crossing the cut after segment cs — kernels
    read by a later segment plus outputs produced at or before cs."""
    seg_of = {k: i for i, seg in enumerate(segments) for k in seg}
    idx_of = {k: i for i, k in enumerate(graph.kernel_order)}
    layouts: List[List[str]] = []
    for cs in range(len(segments) - 1):
        L = []
        for f in program.kernels:
            if seg_of[f] > cs:
                continue
            later = any(seg_of.get(c, -1) > cs
                        for c in graph.consumers(f)
                        if c in program.kernels)
            if later or f in program.outputs:
                L.append(f)
        layouts.append(sorted(L, key=idx_of.get))
    return layouts


def _segment_stream_plans(plan: PipelineSplit, subs, mxu: str,
                          mxu_precision: str, _composed=None):
    """Each segment's K4 plan in chunk mode (``plan_local_stream``'s
    legs: banded, every stage per cell, spilled) over its block of
    ``chunk + 2 W`` planes with its own i-halo, and the plan's
    ``last_config`` entry; None when no leg fits some segment (the
    caller takes the dense tile body).  A composed program plans its
    composed stages exactly or raises ValueError."""
    from .domain import DomainDecomposition, plan_local_stream
    _I, J, K = plan.program.dimensions
    got = []
    for s, (subp, suba) in enumerate(subs):
        E, W = plan.widen[s], plan.emit[s]
        geo = DomainDecomposition(
            program=subp, mesh=None, dim_axes=(None, None, None),
            halo=(E[0] - W[0], 0, 0), block=(plan.chunk + 2 * W[0], J, K))
        seg_composed = {n: b for n, b in (_composed or {}).items()
                        if n in subp.kernels}
        res = plan_local_stream(subp, suba, geo, mxu=mxu,
                                mxu_precision=mxu_precision,
                                _composed=seg_composed or None)
        if res is None:
            return None
        splan, cfg = res
        got.append((splan, {"mxu_stages": cfg["mxu_stages"],
                            "spilled": cfg["spilled"]}))
    return got


def _stream_runner(splan, lib, E: Vec3):
    """Segment body on K4: ``run(tiles, origin) -> outputs``, the tiles
    widened by ``E``, the outputs over the plan's block."""
    from ..backend.stream import run_local_stream

    def run(tiles, origin):
        slabs = {n: tiles[n] for n in splan.program.inputs}
        return run_local_stream(splan, origin[0] - E[0], slabs, lib)
    return run


def _dense_runner(program: ir.Program, graph: ChainGraph,
                  segment: List[str], E: Vec3, W: Vec3):
    """Segment body on the dense tile body (the reference's "xla")."""
    def run(tiles, origin):
        res = _segment_eval(program, graph, segment, tiles, origin, E)
        return {k: _narrow(v, (0, 1, 2), E, W) for k, v in res.items()}
    return run


def _lines(mesh: Mesh, axis: str) -> List[List[Coord]]:
    """The mesh's positions grouped into pipelines: every line along
    ``axis`` (the other coordinates fixed), in axis order."""
    ax = mesh.axis_names.index(axis)
    lines: Dict[Coord, List[Coord]] = {}
    for c in mesh.coords():
        lines.setdefault(c[:ax] + c[ax + 1:], []).append(c)
    return list(lines.values())


class _Body:
    """What both wavefront bodies share: the plan, the segment runners,
    the cut layouts and the tiles a segment reads."""

    def __init__(self, plan: PipelineSplit, graph: ChainGraph, runners,
                 subs):
        self.plan, self.graph, self.runners = plan, graph, runners
        self.subs = [sp for sp, _a in subs]
        self.seg_of = plan.seg_of()
        self.reach = plan.reach()
        self.layouts = _cut_layouts(plan.program, graph, plan.segments)

    def run(self, s: int, wide: Dict[str, Any],
            carried: Dict[str, torch.Tensor], origin) -> Dict[str, Any]:
        """Segment ``s`` on one chunk: ``wide`` holds the program inputs
        it reads at the chunk's widest window (``reach``), ``carried`` the
        kernel fields from earlier segments at their producers' ``emit``.
        Returns ``carried`` updated with the segment's results."""
        plan, program = self.plan, self.plan.program
        E = plan.widen[s]
        tiles = {}
        for f in self.subs[s].inputs:
            if f in program.kernels:
                tiles[f] = _narrow(carried[f], (0, 1, 2),
                                   plan.emit[self.seg_of[f]], E)
                continue
            spec = program.inputs[f]
            tiles[f] = wide[f] if spec.is_scalar else _narrow(
                wide[f], _spanned(spec), self.reach, E)
        new = dict(carried)
        new.update(self.runners[s](tiles, origin))
        return new

    def core(self, f: str, t: torch.Tensor) -> torch.Tensor:
        """An output tile cut to its chunk's core."""
        return _narrow(t, (0, 1, 2), self.plan.emit[self.seg_of[f]],
                       (0, 0, 0))


class _Hops:
    """One wavefront step's hops between positions: ``hop`` hands a dict
    of tiles from one position to another (``Tensor.to`` on this
    process; a send or a receive across processes, a dict of None
    placeholders where this process holds neither end, keys alike), and
    ``run`` completes the step's cross-process moves."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.xfer = None
        if mesh.distributed:
            from .transport import Transfers
            self.xfer = Transfers(mesh, headers=True)

    def hop(self, tiles: Dict[str, Any], src: Coord, dst: Coord
            ) -> Dict[str, Any]:
        dev = self.mesh.device(dst)
        if self.xfer is None:
            return {k: v.to(dev, non_blocking=True) for k, v in tiles.items()}
        got: Dict[str, Any] = dict.fromkeys(tiles)
        for k, v in tiles.items():
            self.xfer.move(src, dst, v, lambda t, k=k: got.__setitem__(
                k, t.to(dev, non_blocking=True)))
        return got

    def run(self) -> None:
        if self.xfer is not None:
            self.xfer.run()


def _pipeline_body(body: _Body, inputs: Dict[str, Any]
                   ) -> Dict[str, ShardedArray]:
    """The replicated-io wavefront: every position holds every input
    whole; the outputs are assembled on the last position of each line
    and replicated over the mesh.  Positions of other processes are
    skipped, their hops sent and received (``_Hops``)."""
    plan = body.plan
    program, mesh = plan.program, plan.mesh
    S, C, chunk = len(plan.segments), plan.num_chunks, plan.chunk
    dims = program.dimensions
    h0 = body.reach[0]
    raw = tuple(program.raw_dimensions)
    shards: Dict[str, Dict[Coord, torch.Tensor]] = {
        o: {} for o in program.outputs}
    for line in _lines(mesh, plan.axis):
        # every input padded by the widest i-widening once per tensor (a
        # mesh that repeats a device shares one copy)
        padded: List[Optional[Dict[str, Any]]] = []
        memo: Dict[Any, torch.Tensor] = {}
        for c in line:
            if not mesh.is_local(c):
                padded.append(None)
                continue
            pos = {}
            for n, spec in program.inputs.items():
                t = inputs[n] if spec.is_scalar else inputs[n].shards[c]
                if not spec.is_scalar and spec.dim_mask[0] and h0:
                    key = (t.data_ptr(), t.device)
                    if key not in memo:
                        w = t.new_zeros((dims[0] + 2 * h0,) + t.shape[1:])
                        w[h0:h0 + dims[0]].copy_(t)
                        memo[key] = w
                    t = memo[key]
                pos[n] = t
            padded.append(pos)

        def window(s, c):
            return {n: (t.narrow(0, c * chunk, chunk + 2 * h0)
                        if not program.inputs[n].is_scalar
                        and program.inputs[n].dim_mask[0] else t)
                    for n, t in padded[s].items()}

        last = mesh.device(line[-1])
        out = None
        if mesh.is_local(line[-1]):
            out = {o: torch.empty(
                (C * chunk,) + tuple(dims[1:]), device=last,
                dtype=to_torch_dtype(program.kernels[o].dtype))
                for o in program.outputs}
        carry: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
        for t in range(S + C - 1):
            hops = _Hops(mesh)
            nxt: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
            for s in range(S):
                c = t - s
                if not 0 <= c < C:
                    continue
                new = None
                if padded[s] is not None:
                    new = body.run(s, window(s, c), carry[s] or {},
                                   (c * chunk, 0, 0))
                if s == S - 1:
                    if out is not None:
                        for o in program.outputs:
                            out[o][c * chunk:(c + 1) * chunk].copy_(
                                body.core(o, new[o]))
                else:   # hop to the next position
                    nxt[s + 1] = hops.hop(
                        {f: None if new is None else new[f]
                         for f in body.layouts[s]}, line[s], line[s + 1])
            hops.run()
            carry = nxt
        # the whole outputs reach each other process once, at its first
        # position of the line; its other positions copy them there
        whole = {o: None if out is None else out[o].reshape(raw)
                 for o in program.outputs}
        first: Dict[int, Coord] = {}
        for c in line:
            first.setdefault(mesh.owner(c), c)
        last_rank = mesh.owner(line[-1])
        hops = _Hops(mesh)
        got = {c: hops.hop(whole, line[-1], c) for c in line
               if mesh.owner(c) == last_rank or first[mesh.owner(c)] == c}
        hops.run()
        for c in line:
            if mesh.is_local(c):
                for o in program.outputs:
                    shards[o][c] = (got[c][o] if c in got else
                                    got[first[mesh.rank]][o].to(
                                        mesh.device(c), non_blocking=True))
    return {o: ShardedArray(mesh, (), raw, s) for o, s in shards.items()}


def _pipeline_body_sharded(body: _Body, inputs: Dict[str, Any]
                           ) -> Dict[str, ShardedArray]:
    """Memory-scalable wavefront: every per-position buffer is O(N/S).

    Three systolic rings replace the replicated-io body (the reference's
    cut-stream-only traffic model, sdfg_generator.py:848-963):

    * **feed ring** (leftward, ``p+1 -> p``): position ``d`` starts
      holding its own halo-widened input shard (chunk ``d``); after ``t``
      shifts, stage 0 holds exactly chunk ``t``.  Inputs are i-sharded,
      never replicated; the i-halo is gathered multi-hop when the
      widening spans several chunks.
    * **wavefront carry** (rightward, ``p -> p+1``): at the hop out of
      stage ``s`` it holds the fields of ``cut_layouts[s]``, so only the
      fields crossing a cut travel; i-spanning inputs read past the first
      segment ride beside it.
    * **output return ring** (rightward, cyclic): the last stage drops
      each finished core chunk into the ring; chunk ``c`` reaches its home
      position ``c`` after ``(c+1) mod S`` hops and is kept there.

    Requires ``num_chunks == S`` and ``dims[0] % S == 0``.
    """
    plan = body.plan
    program, mesh = plan.program, plan.mesh
    S, C, chunk = len(plan.segments), plan.num_chunks, plan.chunk
    assert C == S
    dims = program.dimensions
    dax = dict(plan.domain_axes or {})
    nx = {d: mesh.shape[a] for d, a in dax.items()}
    loc = {d: dims[d] // nx.get(d, 1) for d in (1, 2)}
    reach = body.reach

    # per position: the widened input shards (feed ring's initial load)
    # and the non-i inputs' local windows
    wide: Dict[str, Dict[Coord, Any]] = {}
    for name, spec in program.inputs.items():
        arr = inputs[name]
        if spec.is_scalar:
            wide[name] = {c: arr for c in mesh.coords()}
            continue
        spanned = _spanned(spec)
        if not spec.dim_mask[0]:
            # replicated (non-i) input: pad by the reach in every widened
            # dim, then take this position's window of domain-sharded dims
            got = {}
            for c, t in arr.shards.items():
                pads = [reach[d] for d in spanned]
                if any(pads):
                    w = t.new_zeros(tuple(t.shape[p] + 2 * pads[p]
                                          for p in range(t.ndim)))
                    w[tuple(slice(pads[p], pads[p] + t.shape[p])
                            for p in range(t.ndim))].copy_(t)
                    t = w
                for p, d in enumerate(spanned):
                    if reach[d]:
                        x = mesh.index(c, dax[d])
                        t = t.narrow(p, x * loc[d], loc[d] + 2 * reach[d])
                got[c] = t
            wide[name] = got
            continue
        # i-spanning input, sharded over the pipeline axis (and any
        # domain axes): widen the domain-sharded dims by neighbour
        # gather, then the i-halo from pipeline neighbours
        shards = dict(arr.shards)
        for pos, d in reversed(list(enumerate(spanned))):
            if d and reach[d]:
                shards = _gather_axis_halo(shards, mesh, dax[d], pos,
                                           reach[d], loc[d])
        wide[name] = _gather_axis_halo(shards, mesh, plan.axis, 0, reach[0],
                                       chunk)

    seg_of = body.seg_of
    i_inputs = [n for n, sp in program.inputs.items()
                if not sp.is_scalar and sp.dim_mask[0]]
    carried_inputs = sorted({
        f for kname, kspec in program.kernels.items()
        if seg_of[kname] > 0 for f in kspec.accesses() if f in i_inputs})
    raw = (chunk, loc[1], loc[2])
    shards_out: Dict[str, Dict[Coord, torch.Tensor]] = {
        o: {} for o in program.outputs}
    T = max(S + C - 1, 3 * S - 3)
    for line in _lines(mesh, plan.axis):
        x0 = line[0]
        origin_jk = tuple(mesh.index(x0, dax[d]) * loc[d]
                          if d in dax else 0 for d in (1, 2))
        # slots of another process's positions hold None placeholders
        feed = [{n: wide[n].get(c) for n in i_inputs} for c in line]
        small = [{n: wide[n].get(c) for n in program.inputs
                  if n not in i_inputs} for c in line]
        wave: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
        wave_in: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
        ring: List[Optional[Tuple[int, Dict[str, torch.Tensor]]]] = \
            [None] * S
        out_local: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
        for t in range(T):
            hops = _Hops(mesh)
            new_wave: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
            new_in: List[Optional[Dict[str, torch.Tensor]]] = [None] * S
            for p in range(S):
                c = t - p
                if not 0 <= c < C:
                    continue
                new = tiles = None
                if mesh.is_local(line[p]):
                    # stage 0 takes its input tiles from the feed slot;
                    # later stages from the input carry
                    tiles = dict(small[p])
                    tiles.update(feed[0] if p == 0 else wave_in[p])
                    new = body.run(p, tiles, wave[p] or {},
                                   (c * chunk,) + origin_jk)
                if p < S - 1:
                    new_wave[p + 1] = hops.hop(
                        {f: None if new is None else new[f]
                         for f in body.layouts[p]},
                        line[p], line[p + 1])
                    new_in[p + 1] = hops.hop(
                        {n: None if tiles is None else tiles[n]
                         for n in carried_inputs},
                        line[p], line[p + 1])
                else:   # the finished core chunk into the return ring
                    ring[p] = (c, {o: None if new is None
                                   else body.core(o, new[o])
                                   for o in program.outputs})
            # capture: a chunk in its home position's ring slot stays there
            for q in range(S):
                if ring[q] is not None and ring[q][0] == q:
                    out_local[q] = ring[q][1]
            # systolic shifts
            feed = [hops.hop(feed[q + 1], line[q + 1], line[q])
                    for q in range(S - 1)] + [{}]
            ring = [None if ring[q - 1] is None else (
                ring[q - 1][0], hops.hop(ring[q - 1][1], line[q - 1],
                                         line[q])) for q in range(S)]
            hops.run()
            wave, wave_in = new_wave, new_in
        for q, c in enumerate(line):
            if mesh.is_local(c):
                for o in program.outputs:
                    shards_out[o][c] = out_local[q][o].reshape(raw)
    out_spec = (plan.axis, dax.get(1), dax.get(2))
    return {o: ShardedArray(mesh, out_spec, tuple(program.raw_dimensions), s)
            for o, s in shards_out.items()}


def _place(program: ir.Program, mesh: Mesh, spec, name: str, v):
    """An input as the bodies take it: a ShardedArray laid out by
    ``spec`` (placed now when given as a global array), scalars as 0-d
    host tensors."""
    ispec = program.inputs[name]
    if ispec.is_scalar:
        return to_torch(v)
    if isinstance(v, ShardedArray):
        if v.mesh is mesh and v.spec == tuple(spec) + (None,) * (
                len(v.shape) - len(spec)):
            return v
        v = v.gather()
    shape = tuple(program.dimensions[d] for d in _spanned(ispec))
    return ShardedArray.place(mesh, spec, to_torch(v).reshape(shape))


def compile_pipeline_split(program: ir.Program, mesh: Mesh, axis: str,
                           num_chunks: Optional[int] = None,
                           analysis: Optional[ChainAnalysis] = None,
                           local_backend: str = "auto",
                           mxu: str = "auto",
                           mxu_precision: str = "split",
                           split_at: Optional[Sequence[str]] = None,
                           cut: Optional[Sequence[str]] = None,
                           segments: Optional[Sequence[Sequence[str]]]
                           = None,
                           optimize_cuts: bool = False,
                           io: str = "auto",
                           compose: str = "auto",
                           domain_axes: Optional[Dict[int, str]] = None,
                           _composed=None):
    """Wavefront-pipelined chain over the ``mesh.shape[axis]`` positions
    of a mesh axis.

    ``io="sharded"`` (the default when the shape allows): inputs and
    outputs are i-sharded over the pipeline axis and every per-position
    buffer is O(N/S) (_pipeline_body_sharded) — the memory-scalable mode
    that justifies pipelining chains too deep for one device.  Requires
    ``dims[0]`` divisible by the position count, rank-3 output, and one
    dtype across cut-crossing fields (the reference's gate; the i-halo
    may exceed a chunk — the body gathers it multi-hop).
    ``io="replicated"`` keeps the replicated body (replicated
    inputs/outputs, any chunk count, mixed dtypes).

    ``local_backend``: per-segment compute — "stream" runs each segment
    on K4 in chunk mode (its plain version on CPU positions; banded
    stages where they plan, rings spilled where nothing else fits),
    "xla" the dense tile body (runs anywhere), "auto" "stream" on CUDA
    positions and "xla" on CPU ones.  "xla" is also the rescue where no
    K4 plan fits some segment, and ``last_config["backend"]`` says so.

    Partition selection (at most one): ``split_at`` cuts after named
    kernels in the global topological order; ``cut`` realizes ONE
    arbitrary downward-closed cut set (any ``enumerate_cuts()`` member —
    forks may interleave, the cut need not be an order prefix);
    ``segments`` gives the full partition explicitly (validated);
    ``optimize_cuts`` searches contiguous cuts for minimal bottleneck.
    Returns ``(fn, plan)``: ``fn(inputs)`` takes ShardedArrays laid out
    by ``last_config["in_specs"]`` (numpy arrays and tensors are placed
    on entry; ``fn.place(inputs)`` places them ahead) and returns
    ShardedArrays by ``out_specs``; ``fn.stream_plans`` holds each
    segment's K4 plan (None on the dense body), ``fn.cut_layouts`` the
    fields crossing each cut and ``fn.last_config`` the reference's
    keys.

    ``domain_axes`` composes the pipeline with domain decomposition on a
    multi-dim mesh: ``{1: "x"}`` shards j (and/or ``{2: "y"}`` k) over
    further mesh axes, so each segment runs on an O(N/(S*X)) subdomain
    with its j/k halo gathered from domain neighbours while chunks ride
    the pipeline axis.  Requires sharded io and a domain extent divisible
    by the axis size; the local body is the dense tile body ("xla"), as
    the reference's.

    ``mxu_precision="bf16"`` runs each segment's band passes as
    single-pass bf16 passes in K4 ("auto" then takes the stream body on
    CPU positions too, its plain version); where the dense tile body
    would run it raises ValueError (the JAX package's runs f32 there).
    """
    from .domain import check_dense_precision, reduced_precision
    analysis = analysis or ChainAnalysis.run(program)
    if axis not in mesh.shape:
        raise ValueError(f"unknown mesh axis {axis!r} (mesh has "
                         f"{list(mesh.shape)})")
    if local_backend not in ("auto", "stream", "xla"):
        raise ValueError(f"unknown local_backend {local_backend!r} "
                         "(choose from auto, stream, xla)")
    if domain_axes:
        bad = [d for d in domain_axes if d not in (1, 2)]
        if bad:
            raise ValueError(f"domain_axes keys must be 1 (j) or 2 (k), "
                             f"got {sorted(domain_axes)}")
        for d, ax in domain_axes.items():
            if ax == axis:
                raise ValueError(
                    f"domain axis {ax!r} is the pipeline axis")
            if ax not in mesh.shape:
                raise ValueError(f"unknown mesh axis {ax!r} (mesh has "
                                 f"{list(mesh.shape)})")
            if program.dimensions[d] % mesh.shape[ax]:
                raise ValueError(
                    f"dim {d} ({program.dimensions[d]}) not divisible "
                    f"by mesh axis {ax!r} ({mesh.shape[ax]})")
        if io == "replicated":
            raise ValueError("domain_axes requires sharded pipeline io")
        io = "sharded"
        if local_backend == "stream":
            raise ValueError(
                "domain_axes segments run the fused tile evaluator; "
                "pass local_backend='auto' or 'xla'")
        local_backend = "xla"
        compose = "off"   # composed stream segments are stream-only

    # affine-run composition before auto-splitting: the composed program
    # (fewer, wider stages) is what gets cut across positions; only the
    # AUTO split composes — explicit split_at/cut/segments name original
    # kernels that composition would elide.  The composed program
    # re-enters this compiler; any failure retries uncomposed (never the
    # dense segment body, whose composed IR is interior-only).
    if (_composed is None and compose != "off" and mxu != "off"
            and local_backend == "stream"
            and split_at is None and cut is None and segments is None):
        from ..backend.compose import compose_program
        S0 = mesh.shape[axis]
        if compose == "auto":
            # cap the composition factor so the composed program keeps
            # >= S kernels to split (a whole-run compose of an S-deep
            # chain would leave one kernel and nothing to pipeline)
            max_t = max(2, -(-len(program.kernels) // S0))
        else:
            max_t = int(compose)
        got = (compose_program(program, analysis, max_t)
               if max_t >= 0 else None)
        if got is not None:
            program2, builds = got
            if len(got[0].kernels) >= S0:
                try:
                    fn2, plan2 = compile_pipeline_split(
                        program2, mesh, axis, num_chunks, None, "stream",
                        mxu, mxu_precision,
                        optimize_cuts=optimize_cuts, io=io,
                        compose="off", _composed=builds)
                    if fn2.last_config["backend"] == "stream":
                        fn2.last_config["composed"] = {
                            n: list(b.stages) for n, b in builds.items()}
                        compile_pipeline_split.last_config = dict(
                            fn2.last_config)
                        return fn2, plan2
                except (ValueError, NotImplementedError):
                    pass

    graph = analysis.graph
    S = mesh.shape[axis]
    if sum(x is not None for x in (split_at, cut, segments)) > 1:
        raise ValueError("pass at most one of split_at / cut / segments")
    if segments is not None:
        # explicit partition: any order-respecting assignment, including
        # non-prefix downward-closed cuts on forked chains
        segments = validate_segments(graph, segments)
    elif cut is not None:
        # one arbitrary downward-closed cut set (enumerate_cuts member)
        segments = split_kernels_at_cut(graph, cut)
    elif split_at is not None:
        segments = split_kernels_at(graph, split_at)
    elif optimize_cuts:
        segments, _stats = optimize_split(program, graph, S)
    else:
        segments = split_kernels(graph, S)
    if len(segments) != S:
        raise ValueError(
            f"partition gives {len(segments)} segments but mesh axis "
            f"{axis!r} has {S} devices")
    halo = chain_halo(analysis)
    dims = program.dimensions
    # the sharded body carries every cut-crossing field in one carry of
    # one dtype in the reference (mixed dtypes would round-trip through a
    # promoted type), so its gate requires uniformity; the port keeps the
    # gate so that io="auto" chooses as the reference does
    seg_of = {f: si for si, seg in enumerate(segments) for f in seg}
    crossing = {
        np.dtype(program.kernels[f].dtype)
        for f in program.kernels
        if any(seg_of.get(c, -1) > seg_of[f]
               for c in graph.consumers(f) if c in program.kernels)
        or (f in program.outputs and seg_of[f] < S - 1)}
    # sharded-I/O eligibility: C == S chunks of equal size, rank-3 output
    # (the i-halo may span multiple chunks — gathered multi-hop), one
    # dtype across all cut-crossing fields
    can_shard = (S > 1 and dims[0] % S == 0
                 and len(program.raw_dimensions) == 3
                 and len(crossing) <= 1
                 and (num_chunks is None or num_chunks == S))
    if io == "sharded" and not can_shard:
        raise ValueError(
            "sharded pipeline I/O needs num_chunks == devices, dim 0 "
            f"divisible by {S}, a 3-D output, and one dtype across "
            f"cut-crossing fields (got {sorted(d.name for d in crossing)})")
    sharded_io = io == "sharded" or (io == "auto" and can_shard)
    if num_chunks is None:
        num_chunks = S if sharded_io else max(1, min(S, dims[0]))
    if dims[0] % num_chunks != 0:
        raise ValueError(f"dim 0 ({dims[0]}) not divisible into "
                         f"{num_chunks} chunks")
    chunk = dims[0] // num_chunks
    dax = dict(domain_axes or {})
    cut_dims = (True,) + tuple(d in dax and mesh.shape[dax[d]] > 1
                               for d in (1, 2))
    subs = _segment_programs(program, graph, segments)
    widen, emit = _segment_geometry(program, segments, subs, cut_dims)
    plan = PipelineSplit(program, mesh, axis, segments, halo, num_chunks,
                         chunk, domain_axes=dax, widen=widen, emit=emit)
    on_cuda = {d.type for d in mesh.devices.flat} == {"cuda"}
    if local_backend == "auto":
        local_backend = "stream" if on_cuda or reduced_precision(
            mxu_precision) else "xla"
    splans = None
    if local_backend == "stream":
        splans = _segment_stream_plans(plan, subs, mxu, mxu_precision,
                                       _composed)
        # None: a segment fits no K4 plan — the dense body
        if splans is None and _composed:
            raise ValueError(
                "composed pipeline segments not stream-plannable")
    if splans is not None:
        from ..backend import build
        from ..backend.stream import _pool_tensors, stream_source
        libs = [None] * len(splans)
        if on_cuda:   # one nvcc a segment, all at once
            libs = build.load_libraries([(stream_source(sp), "local_stream")
                                         for sp, _info in splans])
            for sp, _info in splans:
                for dev in mesh.local_devices():
                    _pool_tensors(sp, dev)
        runners = [_stream_runner(sp, lib, widen[s])
                   for s, ((sp, _info), lib) in enumerate(zip(splans, libs))]
    else:
        check_dense_precision(mxu_precision)
        runners = [_dense_runner(program, graph, seg, widen[s], emit[s])
                   for s, seg in enumerate(segments)]
    config = {
        "backend": "stream" if splans is not None else "xla",
        "io": "sharded" if sharded_io else "replicated",
        "segments": [info for _sp, info in splans]
        if splans is not None else [],
    }
    if sharded_io:
        in_specs = {}
        for n, spec in program.inputs.items():
            if spec.is_scalar or not spec.dim_mask[0]:
                # non-i inputs stay replicated; the body slices the
                # local widened window of any domain-sharded dim
                in_specs[n] = ()
            else:
                in_specs[n] = (axis,) + tuple(dax.get(d)
                                              for d in _spanned(spec)[1:])
        out_specs = {n: (axis, dax.get(1), dax.get(2))
                     for n in program.outputs}
        run_body = _pipeline_body_sharded
    else:
        in_specs = {n: () for n in program.inputs}
        out_specs = {n: () for n in program.outputs}
        run_body = _pipeline_body
    config["in_specs"] = dict(in_specs)
    config["out_specs"] = dict(out_specs)
    compile_pipeline_split.last_config = config
    body = _Body(plan, graph, runners, subs)

    def place(inputs):
        return {n: _place(program, mesh, in_specs[n], n, inputs[n])
                for n in program.inputs}

    def fn(inputs):
        return run_body(body, place(inputs))

    fn.place = place
    fn.last_config = dict(config)
    fn.stream_plans = [sp for sp, _info in splans] if splans else None
    fn.cut_layouts = body.layouts
    return fn, plan


compile_pipeline_split.last_config = {}


def run_pipeline_split(program: ir.Program, mesh: Mesh, axis: str,
                       inputs: Dict[str, Any],
                       num_chunks: Optional[int] = None,
                       split_at: Optional[Sequence[str]] = None,
                       cut: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
    fn, _ = compile_pipeline_split(program, mesh, axis, num_chunks,
                                   split_at=split_at, cut=cut)
    out = fn(inputs)
    return {k: v.numpy() for k, v in out.items()}

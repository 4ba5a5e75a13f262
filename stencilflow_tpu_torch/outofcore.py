"""Out-of-core execution: domains larger than device memory.

Port of ``stencilflow_tpu/outofcore.py`` (``ChunkPlan``,
``compile_chunked_chain``, ``compile_chunked_sharded``, ``_host_slab``,
``run_chunked``).  The i axis is split into C chunks of ``Ic = I / C``
core planes.  Each chunk's i-spanning inputs are sliced on the host with
the chain's cumulative i-halo h on both sides (zero planes outside the
domain: the kernel's boundary masks are global, so it treats them as any
out-of-domain read), one kernel built for all chunks evaluates each
chunk with the chunk's global origin as an argument, and the core planes
land in host ``out=`` arrays, which may be ``np.memmap``s.  Device
residency is O(N / C): two chunks in flight.

The chunk body on a CUDA device is K4, the local stream kernel
(``backend/stream.py`` local mode, chosen by
``parallel/domain.py plan_local_stream``, with rings spilled to device
memory where no (j, k) tile fits shared memory otherwise); where no plan
fits, or on the CPU, it is the dense tile body
(``backend/tile_eval.py evaluate_chain_tile`` at the core origin), as the
reference falls back to its XLA body.  ``backend="stream"`` on the CPU
runs K4's plain version, and so does a request for single-pass bf16
band passes (``mxu_precision="bf16"``), which K4 alone runs: where the
dense body would run, it raises.  ``compile_chunked_sharded``
(``run_chunked(..., mesh=, dim_axes=)``) evaluates each chunk sharded
over a mesh's (j, k) instead, on the dense tile body, as the reference
does.

Host staging (``run_chunked``).  The reference overlaps host slicing and
device work through JAX's asynchronous dispatch; here it is explicit.  On
a CUDA device every i-spanning input has two pinned host slabs and two
device slabs, written in place (in-range planes copied, pad planes
zeroed); chunk c + 1 is sliced on the host and uploaded on a copy stream
while chunk c computes, ordered by events, and each chunk's outputs come
back on a third stream into pinned buffers, then into ``out=`` while the
next chunk runs.  Non-i-spanning inputs are uploaded once.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import ir
from .backend.dense import chain_halo
from .backend.stacked_io import resolve_device
from .backend.tile_eval import evaluate_chain_tile
from .dtypes import from_numpy, to_torch, to_torch_dtype
from .frontend.analysis import ChainAnalysis
from .parallel.domain import (DomainDecomposition, check_dense_precision,
                              plan_local_stream, reduced_precision)


@dataclasses.dataclass
class ChunkPlan:
    """Geometry of an out-of-core run."""
    chunks: int
    block: int      # core i-planes per chunk
    halo: int       # i-halo each side (the chain's cumulative i extent)
    backend: str    # "stream" | "dense"
    config: Dict[str, Any]


def _fake_plan(program: ir.Program, block, halo) -> DomainDecomposition:
    """A single-block DomainDecomposition carrier (no mesh) for the
    per-block stream chooser."""
    return DomainDecomposition(program=program, mesh=None,
                               dim_axes=(None, None, None), halo=halo,
                               block=block)


def compile_chunked_chain(program: ir.Program, chunks: int,
                          analysis: Optional[ChainAnalysis] = None,
                          backend: str = "auto", mxu: str = "auto",
                          mxu_precision: str = "split", device="cuda",
                          spill: str = "auto",
                          smem_budget: Optional[int] = None):
    """Build ``(chunk_fn, plan)``: ``chunk_fn(origin_i, tiles) ->
    outputs`` evaluating one i-chunk on ``device``, built once for all
    chunks.

    ``tiles`` are the chunk's inputs as tensors on ``device``: i-spanning
    fields carry ``block + 2*halo`` planes (zero outside the domain),
    others pass whole, scalars 0-d.  ``origin_i`` is the global i index of
    the chunk's first *widened* plane (core start minus halo).  Outputs
    are the chunk's core planes at the program's raw rank.  ``backend``:
    "stream" (K4; its plain version on the CPU; ``chunk_fn.plan`` is
    its plan), "dense", or "auto" (stream on a CUDA device, dense on the
    CPU).  ``spill`` and ``smem_budget`` go to K4's planner
    (``plan_local_stream``).
    ``mxu_precision="bf16"`` (single-pass bf16 band passes) runs in K4
    alone: "auto" then takes the stream body on the CPU too, and where
    the dense body would run it raises ValueError (the JAX package's XLA
    body runs f32 there)."""
    analysis = analysis or ChainAnalysis.run(program)
    dims = program.dimensions
    I, J, K = dims
    if len(program.raw_dimensions) < 2 or I <= 1:
        raise ValueError("out-of-core chunking streams the i axis; "
                         f"domain {program.raw_dimensions} has no i "
                         "extent to chunk")
    if chunks < 1 or I % chunks:
        raise ValueError(f"chunks={chunks} must divide I={I}")
    Ic = I // chunks
    h = chain_halo(analysis)[0]
    if chunks > 1 and h >= Ic:
        raise ValueError(f"chain i-halo {h} >= chunk block {Ic}; "
                         "use fewer chunks")
    plan3 = _fake_plan(program, (Ic, J, K), (h if chunks > 1 else 0, 0, 0))
    halo_i = plan3.halo[0]
    device = resolve_device(device)
    if backend == "auto":
        backend = "stream" if device.type == "cuda" or reduced_precision(
            mxu_precision) else "dense"
    if backend not in ("stream", "dense"):
        raise ValueError(f"unknown chunk backend {backend!r} (choose from "
                         "auto, stream, dense)")
    local_raw = (Ic,) + tuple(program.raw_dimensions[1:])

    if backend == "stream":
        from .backend.stream import compile_local_stream
        got = plan_local_stream(program, analysis, plan3, mxu=mxu,
                                mxu_precision=mxu_precision, spill=spill,
                                smem_budget=smem_budget)
        if got is not None:
            splan, cfg = got
            kern = compile_local_stream(splan, device)

            def body(origin_i, tiles):
                return {n: arr.reshape(local_raw)
                        for n, arr in kern(origin_i, tiles).items()}

            body.device, body.plan = device, splan
            return body, ChunkPlan(chunks=chunks, block=Ic, halo=halo_i,
                                   backend="stream", config=cfg)
        # nothing fits: the dense tile body below

    check_dense_precision(mxu_precision)
    graph = analysis.graph

    def body(origin_i, tiles):
        # evaluate_chain_tile takes the *core* origin (the stream kernel
        # takes the widened one, hence the + halo_i here only)
        results = evaluate_chain_tile(program, graph, tiles,
                                      (int(origin_i) + halo_i, 0, 0),
                                      (halo_i, 0, 0))
        return {n: arr[halo_i:halo_i + Ic].reshape(local_raw)
                for n, arr in results.items()}

    body.device, body.plan = device, None
    return body, ChunkPlan(chunks=chunks, block=Ic, halo=halo_i,
                           backend="dense", config={})


def compile_chunked_sharded(program: ir.Program, chunks: int, mesh,
                            dim_axes=(None, "x", "y"),
                            analysis: Optional[ChainAnalysis] = None):
    """Out-of-core x domain decomposition: each host i-chunk is evaluated
    sharded over ``mesh`` — ``dim_axes`` maps j/k to mesh axes (i must
    stay None: it is the chunked streaming dim).  A position's chunk body
    holds O((block + 2h) * J/X * K/Y): the host feeds every position its
    shard of the chunk, and the j/k halos come from mesh neighbours
    (multi-hop when the chain halo exceeds a shard,
    ``parallel/pipeline.py _gather_axis_halo``).  The body is the dense
    tile body on every position, as the reference's is its XLA body.

    Returns ``(chunk_fn, plan)`` with ``compile_chunked_chain``'s
    ``chunk_fn(origin_i, tiles) -> outputs`` contract: tiles and outputs
    are GLOBAL (j, k) extents, on the host; the chunk function places the
    tiles over the mesh and gathers the outputs."""
    from .parallel.mesh import ShardedArray
    from .parallel.pipeline import _gather_axis_halo

    analysis = analysis or ChainAnalysis.run(program)
    dims = program.dimensions
    I, J, K = dims
    if dim_axes[0] is not None:
        raise ValueError("dim 0 (i) is the chunked streaming dim; "
                         "shard j/k only (dim_axes[0] must be None)")
    dax = {d: ax for d, ax in enumerate(dim_axes)
           if ax is not None and d in (1, 2)}
    for d, ax in dax.items():
        if ax not in mesh.shape:
            raise ValueError(f"unknown mesh axis {ax!r}")
        if dims[d] % mesh.shape[ax]:
            raise ValueError(f"dim {d} ({dims[d]}) not divisible by "
                             f"mesh axis {ax!r} ({mesh.shape[ax]})")
    if chunks < 1 or I % chunks:
        raise ValueError(f"chunks={chunks} must divide I={I}")
    Ic = I // chunks
    halo = chain_halo(analysis)
    h = (halo[0] if chunks > 1 else 0, halo[1], halo[2])
    if chunks > 1 and h[0] >= Ic:
        raise ValueError(f"chain i-halo {h[0]} >= chunk block {Ic}; "
                         "use fewer chunks")
    nx = {d: mesh.shape[a] for d, a in dax.items()}
    loc = {d: dims[d] // nx.get(d, 1) for d in (1, 2)}
    graph = analysis.graph
    local_raw = (Ic,) + tuple(program.raw_dimensions[1:])
    in_specs = {n: tuple(dax.get(d) for d in range(3) if spec.dim_mask[d])
                for n, spec in program.inputs.items()}
    out_spec = (None, dax.get(1), dax.get(2))
    core = (slice(h[0], h[0] + Ic), slice(h[1], h[1] + loc[1]),
            slice(h[2], h[2] + loc[2]))

    def chunk_fn(origin_i, tiles):
        wide: Dict[Any, Dict[str, Any]] = {c: {} for c in mesh.coords()}
        for name, spec in program.inputs.items():
            arr = to_torch(tiles[name])
            if spec.is_scalar:
                for c in wide:
                    wide[c][name] = arr
                continue
            spanned = [d for d in range(3) if spec.dim_mask[d]]
            shape = tuple(Ic + 2 * h[0] if d == 0 else dims[d]
                          for d in spanned)
            shards = ShardedArray.place(mesh, in_specs[name],
                                        arr.reshape(shape)).shards
            for pos, d in reversed(list(enumerate(spanned))):
                if d == 0:
                    continue   # the i-halo arrived in the host slab
                if d in dax:
                    shards = _gather_axis_halo(shards, mesh, dax[d], pos,
                                               h[d], loc[d])
                elif h[d]:
                    shards = _gather_axis_halo(shards, mesh, None, pos,
                                               h[d], loc[d])
            for c, t in shards.items():
                wide[c][name] = t
        outs: Dict[str, Dict[Any, torch.Tensor]] = {
            o: {} for o in program.outputs}
        for c, tiles_c in wide.items():
            origin = (int(origin_i) + h[0],
                      mesh.index(c, dax.get(1)) * loc[1],
                      mesh.index(c, dax.get(2)) * loc[2])
            results = evaluate_chain_tile(program, graph, tiles_c, origin,
                                          h)
            for n, arr in results.items():
                outs[n][c] = arr[core]
        return {n: ShardedArray(mesh, out_spec, (Ic, J, K), s).gather()
                .reshape(local_raw) for n, s in outs.items()}

    chunk_fn.device = torch.device("cpu")   # run_chunked stages on the host
    n_dev = int(np.prod([nx[d] for d in nx])) or 1
    per_host = sum(
        (Ic + 2 * h[0]) * (loc[1] + 2 * h[1]) * (loc[2] + 2 * h[2])
        * np.dtype(program.field_dtype(f)).itemsize
        for f in list(program.inputs) + list(program.kernels)
        if f not in program.inputs or not program.inputs[f].is_scalar)
    plan = ChunkPlan(chunks=chunks, block=Ic, halo=h[0],
                     backend="sharded-xla",
                     config={"dim_axes": tuple(dim_axes),
                             "devices": n_dev,
                             "per_device_tile_bytes": int(per_host)})
    return chunk_fn, plan


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over host array ``a`` (a numpy array or memmap: no
    copy; a read-only memmap is only read)."""
    if torch.is_tensor(a):
        return a
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only arrays
        return from_numpy(np.ascontiguousarray(a))


def _host_slab(arr, lo: int, hi: int, extent: int,
               dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``arr[lo:hi]`` along axis 0 with zero planes outside ``[0,
    extent)``, written in place into ``dst`` (a new CPU tensor when None):
    the in-range planes are copied, the pad planes zeroed.  The host-side
    equivalent of the sharded path's boundary zeros."""
    a0, a1 = max(0, lo), min(hi, extent)
    if dst is None:
        src = _host_tensor(arr[a0:a1])
        dst = torch.empty((hi - lo,) + tuple(src.shape[1:]), dtype=src.dtype)
    dst[:a0 - lo].zero_()
    dst[a0 - lo:a1 - lo].copy_(_host_tensor(arr[a0:a1]))
    dst[a1 - lo:].zero_()
    return dst


def link_bytes(program: ir.Program, plan: ChunkPlan):
    """(bytes up, bytes down) one ``run_chunked`` moves between host and
    device: every chunk's slab of each i-spanning input, every other
    array input once, every output once."""
    dims = program.dimensions
    Ii = plan.block + 2 * plan.halo
    up = 0
    for spec in program.inputs.values():
        if spec.is_scalar:
            continue
        cells = int(np.prod([d for d, m in zip(dims, spec.dim_mask) if m]))
        size = np.dtype(spec.dtype).itemsize
        up += (plan.chunks * Ii * cells // dims[0] if spec.dim_mask[0]
               else cells) * size
    down = sum(program.total_elements * np.dtype(program.kernels[o].dtype)
               .itemsize for o in program.outputs)
    return up, down


def run_chunked(program: ir.Program, inputs: Dict[str, Any], chunks: int,
                out: Optional[Dict[str, np.ndarray]] = None,
                analysis: Optional[ChainAnalysis] = None, compiled=None,
                stats: Optional[Dict[str, float]] = None,
                **compile_kw) -> Dict[str, np.ndarray]:
    """Evaluate the chain out-of-core: host-slice i-chunks (+halo), stream
    each through the compiled chunk body, assemble outputs on the host.

    ``inputs`` values may be numpy arrays or memmaps at raw rank; ``out``
    may supply preallocated (possibly memmapped) output arrays.
    ``compiled`` reuses a prior ``compile_chunked_chain`` result; else
    ``compile_kw`` (``device``, ``backend``, ``mxu``, ...) goes to it, or,
    when it names a ``mesh`` (and ``dim_axes``), to
    ``compile_chunked_sharded``.
    ``stats``, when given, receives the host seconds spent slicing inputs
    into the slabs (``fill_s``) and waiting for and copying outputs out of
    them (``drain_s``)."""
    analysis = analysis or ChainAnalysis.run(program)
    if compiled is not None:
        fn, plan = compiled
    elif "mesh" in compile_kw:
        fn, plan = compile_chunked_sharded(program, chunks,
                                           analysis=analysis, **compile_kw)
    else:
        fn, plan = compile_chunked_chain(program, chunks, analysis,
                                         **compile_kw)
    if plan.chunks != chunks:
        raise ValueError(f"compiled for {plan.chunks} chunks, got "
                         f"{chunks}")
    dims = program.dimensions
    I = dims[0]
    Ic, h = plan.block, plan.halo
    Ii = Ic + 2 * h
    raw = tuple(program.raw_dimensions)

    outputs: Dict[str, np.ndarray] = {}
    for o in program.outputs:
        dt = np.dtype(program.kernels[o].dtype)
        if out is not None and o in out:
            got = out[o]
            if got.shape != raw or got.dtype != dt:
                raise ValueError(f"out[{o!r}] has shape {got.shape} "
                                 f"dtype {got.dtype}; want {raw} {dt}")
            outputs[o] = got
        else:
            outputs[o] = np.empty(raw, dtype=dt)

    device = fn.device
    cuda = device.type == "cuda"
    nbuf = 2 if cuda else 1
    streamed, whole = [], {}
    for n, spec in program.inputs.items():
        if spec.is_scalar:
            whole[n] = to_torch(inputs[n])
        elif spec.dim_mask[0]:
            streamed.append(n)
        else:
            shape = tuple(dims[d] for d in range(3) if spec.dim_mask[d])
            whole[n] = _host_tensor(inputs[n]).reshape(shape).to(device)
    host_in = {}
    for n in streamed:
        spec = program.inputs[n]
        shape = (Ii,) + tuple(dims[d] for d in (1, 2) if spec.dim_mask[d])
        host_in[n] = [torch.empty(shape, dtype=to_torch_dtype(spec.dtype),
                                 pin_memory=cuda) for _ in range(nbuf)]
    spent = {"fill_s": 0.0, "drain_s": 0.0}

    def fill(c, b):
        t0 = time.perf_counter()
        lo = c * Ic - h
        for n in streamed:
            host = inputs[n]
            if not torch.is_tensor(host):
                host = np.asarray(host).reshape(
                    (I,) + tuple(host_in[n][b].shape[1:]))
            _host_slab(host, lo, lo + Ii, I, host_in[n][b])
        spent["fill_s"] += time.perf_counter() - t0

    def store(c, got):
        t0 = time.perf_counter()
        for o in program.outputs:   # in place, whatever the strides
            from_numpy(outputs[o][c * Ic:(c + 1) * Ic]).copy_(got[o])
        spent["drain_s"] += time.perf_counter() - t0

    if not cuda:
        for c in range(chunks):
            fill(c, 0)
            tiles = {**whole, **{n: host_in[n][0] for n in streamed}}
            store(c, fn(c * Ic - h, tiles))
        if stats is not None:
            stats.update(spent)
        return outputs

    main = torch.cuda.current_stream(device)
    up_stream = torch.cuda.Stream(device)
    down_stream = torch.cuda.Stream(device)
    dev_in = {n: [torch.empty_like(host_in[n][0], device=device)
                  for _ in range(2)] for n in streamed}
    host_out = {o: [torch.empty((Ic,) + raw[1:],
                               dtype=to_torch_dtype(program.kernels[o].dtype),
                               pin_memory=True) for _ in range(2)]
               for o in program.outputs}
    uploaded = [torch.cuda.Event() for _ in range(2)]
    computed = [torch.cuda.Event() for _ in range(2)]
    downloaded = [torch.cuda.Event() for _ in range(2)]

    def drain(c, b):
        t0 = time.perf_counter()
        downloaded[b].synchronize()
        spent["drain_s"] += time.perf_counter() - t0
        store(c, {o: host_out[o][b] for o in program.outputs})

    pending = None
    for c in range(chunks):
        b = c % 2
        if c >= 2:
            uploaded[b].synchronize()   # pinned slab b: chunk c - 2 is up
        fill(c, b)
        with torch.cuda.stream(up_stream):
            if c >= 2:   # device slab b: chunk c - 2's kernel is done
                up_stream.wait_event(computed[b])
            for n in streamed:
                dev_in[n][b].copy_(host_in[n][b], non_blocking=True)
            uploaded[b].record(up_stream)
        main.wait_event(uploaded[b])
        got = fn(c * Ic - h, {**whole, **{n: dev_in[n][b]
                                          for n in streamed}})
        computed[b].record(main)
        with torch.cuda.stream(down_stream):
            down_stream.wait_event(computed[b])
            for o in program.outputs:
                host_out[o][b].copy_(got[o], non_blocking=True)
                got[o].record_stream(down_stream)
            downloaded[b].record(down_stream)
        del got
        if pending is not None:
            drain(*pending)
        pending = (c, b)
    drain(*pending)
    if stats is not None:
        stats.update(spent)
    return outputs

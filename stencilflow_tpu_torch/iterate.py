"""Iterative solving: time-step a stencil chain with checkpoints.

Port of ``stencilflow_tpu/iterate.py``:

* ``compose_iterations`` fuses ``n`` time steps into one deeper chain
  (a copy: it maps IR to IR);
* ``make_step`` compiles one chain evaluation on any lowering into a
  state update ``{field: tensor} -> {field: tensor}`` that feeds
  designated outputs back into inputs;
* ``iterate`` runs N steps with checkpoints and resume: ``.npz`` files,
  or sharded asynchronous checkpoints (``checkpoint_format="orbax"``).

The device loop.  The reference runs ``chunk`` steps inside one jitted
``lax.fori_loop``.  Here each chunk of ``n`` steps is captured once in a
CUDA graph (``torch.cuda.CUDAGraph``) and replayed: one host call per
chunk, with no Python and no launch overhead per step.  The program's
array inputs live in static device buffers; the graph reads them,
chains the ``n`` steps through its own memory pool and, as its last
operations, copies the final state of each fed field back into its
buffer: one copy per chunk, none per step.  One graph is kept per
distinct ``n`` (the full chunk, a remainder, a checkpoint boundary), all
in one memory pool.  A capture that fails raises; nothing falls back to
eager launches.  On the CPU the loop is a Python loop over the kernels'
plain versions.

The reference's rule of two steps per loop iteration (XLA pins the loop
carry, and a ``pallas_call`` cannot alias its operand) has no
counterpart: a graph's steps write fresh buffers of its pool.

``host_chunks`` > 1 keeps the state in host numpy arrays and streams each
step through the device in i-chunks (``outofcore.run_chunked``, K4 on
the card).  ``mesh``/``dim_axes`` run each step through the sharded
engine (``parallel/domain.py compile_sharded_chain``: K4 per shard on
CUDA shards): the state is ``parallel.mesh.ShardedArray``s laid out by
the plan's specs, a chunk of steps is captured in one CUDA graph (the
exchange copies and every shard's launch) when the shards share one
device, and npz checkpoints gather the shards under the reference's
keys.

``checkpoint_format="orbax"`` keeps the JAX package's name for its
sharded asynchronous checkpoints, which here are written with
``torch.distributed.checkpoint`` (the card's machine has no orbax; the
files are DCP's, and neither package reads the other's).  Each step has
a directory named by its original step number (``ckpt/2``,
``ckpt/4``, ...), written as ``<step>.tmp`` and renamed once its save
has finished, so a directory without DCP's ``.metadata`` is never the
one resumed.  A ``ShardedArray`` is saved as one entry per block of the
global field (``<field>/shard_<block>_of_<blocks>``), never gathered;
state on one device as one entry per field.  Each save copies the state
to host tensors (so the next replay of the CUDA-graph loop may overwrite
its static buffers) and writes them with ``async_save`` while the next
chunk runs; the previous save is waited for before the next one, and in
a ``finally`` before ``iterate`` returns or raises.  A resume onto the
saved layout loads each shard in place; onto another (2 x 2 to one
device, one device to 2 x 2) it reads one saved block at a time and
copies its overlap into each new shard, as orbax's restore reshards.
"""
from __future__ import annotations

import dataclasses as dc
import glob
import os
import re
import shutil
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir
from .backend.stacked_io import resolve_device
from .dtypes import BFLOAT16, to_numpy, to_torch
from .frontend.analysis import ChainAnalysis

MESH_NEEDS_AXES = "mesh requires dim_axes, e.g. (None, 'x', 'y')"


class IterateError(ValueError):
    pass


def _default_feed(program: ir.Program) -> Dict[str, str]:
    """Map the unique full-domain input to the unique output (only
    full-domain inputs are feedable; lower-rank coefficient arrays and
    scalars are carried unchanged)."""
    raw = tuple(program.raw_dimensions)
    feedable = [
        n for n, s in program.inputs.items()
        if not s.is_scalar and tuple(s.shape(program.dimensions)) == raw
    ]
    if len(feedable) == 1 and len(program.outputs) == 1:
        return {feedable[0]: program.outputs[0]}
    raise IterateError(
        "ambiguous feedback: pass feed={input_name: output_name}")


def compose_iterations(program: ir.Program, n: int,
                       feed: Optional[Dict[str, str]] = None
                       ) -> ir.Program:
    """Fuse ``n`` time steps of a chain into one deeper chain program.

    Iteration ``t``'s kernels are cloned as ``<name>__it<t>`` with fed
    inputs rewired to the previous iteration's outputs; the final
    iteration's outputs keep their original names, so the fused program
    has the same external interface (inputs, outputs, BCs) as applying
    the original ``n`` times.  Fusing multiplies arithmetic intensity by
    ``n`` (one input read and one output write for the fused step).
    """
    if n < 1:
        raise IterateError("compose_iterations needs n >= 1")
    feed = feed or _default_feed(program)
    for iname, oname in feed.items():
        if iname not in program.inputs or oname not in program.outputs:
            raise IterateError(f"bad feed entry {iname!r} <- {oname!r}")
    if n == 1:
        return program

    def clone_name(k: str, t: int) -> str:
        if t == n - 1 and k in program.outputs:
            return k
        return f"{k}__it{t}"

    kernels: Dict[str, ir.KernelSpec] = {}
    for t in range(n):
        ren = {k: clone_name(k, t) for k in program.kernels}
        if t > 0:
            for iname, oname in feed.items():
                ren[iname] = clone_name(oname, t - 1)
        for k, spec in program.kernels.items():
            stmts = [dc.replace(s, rhs=ir.rename_fields(s.rhs, ren))
                     for s in spec.statements]
            bcs = {ren.get(f, f): bc
                   for f, bc in spec.boundary_conditions.items()}
            name = clone_name(k, t)
            kernels[name] = dc.replace(spec, name=name, statements=stmts,
                                       boundary_conditions=bcs)
    # prune clones not reachable from the final outputs: subtrees feeding
    # only non-fed outputs of intermediate iterations are dead (their
    # results are superseded, never emitted)
    live = set(program.outputs)
    frontier = list(program.outputs)
    while frontier:
        k = frontier.pop()
        if k not in kernels:
            continue
        for f in kernels[k].accesses():
            if f not in live:
                live.add(f)
                frontier.append(f)
    kernels = {k: v for k, v in kernels.items() if k in live}
    return dc.replace(program, name=f"{program.name}_x{n}",
                      kernels=kernels)


def _check_feed(program: ir.Program, feed: Dict[str, str]) -> None:
    for iname, oname in feed.items():
        if iname not in program.inputs or oname not in program.outputs:
            raise IterateError(f"bad feed entry {iname!r} <- {oname!r}")
        spec = program.inputs[iname]
        in_shape = spec.shape(program.dimensions)
        if tuple(in_shape) != tuple(program.raw_dimensions):
            raise IterateError(
                f"fed input {iname!r} must span the full domain")


def _compile(program, analysis, backend: str, device,
             ring_storage: str = "off"):
    """``(fn, lowering name)`` of one chain evaluation on ``device``: the
    ``run`` subcommand's lowerings, the dense one given its inputs on
    ``device`` as the kernels' wrappers move them."""
    from .backend.stacked_io import spanned_arrays
    from .driver import BACKEND_ALIASES, BACKENDS
    from .driver import _compile as compile_lowering
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend not in BACKENDS:
        raise IterateError(f"unknown backend: {backend} (choose from "
                           f"{BACKENDS}; pallas = tile, xla = dense)")
    fn, name = compile_lowering(program, analysis, backend, device,
                                mxu="auto", mxu_precision="split",
                                spill="auto", ring_storage=ring_storage)
    if name != "dense":
        return fn, name

    def forward(inputs):
        return fn(spanned_arrays(program, inputs, device=device))

    return forward, name


def make_step(program: ir.Program,
              feed: Optional[Dict[str, str]] = None,
              backend: str = "auto",
              device="cuda",
              mesh=None, dim_axes: Optional[Sequence] = None,
              analysis: Optional[ChainAnalysis] = None,
              host_chunks: int = 0,
              ring_storage: str = "off"
              ) -> Tuple[Callable, Dict[str, str]]:
    """Compile one time step.  Returns ``(step, feed)`` where
    ``step(state_dict) -> state_dict`` carries every program input; fed
    inputs are replaced by the designated outputs each call.  Array
    state on the device is a dict of tensors there; the lowering's name
    is ``step.backend``.

    ``host_chunks`` > 1 builds a *host-level* step: state stays in host
    numpy arrays and each step streams the domain through the device in
    i-chunks (outofcore.py); combine with ``fuse`` (via ``iterate``) to
    amortize the host-device traffic over several time steps a pass.

    ``mesh`` (with ``dim_axes``) builds a sharded step on the mesh's
    devices (``device`` is then unused): state arrays are ShardedArrays
    and the step's lowering is ``sharded[<local body>]``."""
    feed = feed or _default_feed(program)
    _check_feed(program, feed)
    if ring_storage != "off" and backend != "stream":
        raise IterateError(
            "ring_storage requires backend='stream'")
    if ring_storage != "off" and (mesh is not None or host_chunks > 1):
        raise IterateError("ring_storage does not reach make_step's chunk "
                           "and mesh steps: the JAX package's make_step "
                           "drops it there and runs f32 rings")
    analysis = analysis or ChainAnalysis.run(program)
    if host_chunks and host_chunks > 1 and mesh is not None:
        raise IterateError("host_chunks is incompatible with mesh")
    if mesh is not None:
        if dim_axes is None:
            raise IterateError(MESH_NEEDS_AXES)
        from .parallel.domain import compile_sharded_chain
        fn, _plan = compile_sharded_chain(program, mesh, dim_axes, analysis)

        def mesh_step(state: Dict[str, Any]) -> Dict[str, Any]:
            out = fn(state)
            new_state = dict(state)
            for iname, oname in feed.items():
                new_state[iname] = out[oname]
            return new_state

        mesh_step.backend = f"sharded[{fn.last_config['backend']}]"
        mesh_step.plan = _plan
        return mesh_step, feed
    device = resolve_device(device)
    if host_chunks and host_chunks > 1:
        if backend not in ("auto", "stream", "xla", "dense"):
            raise IterateError(
                f"backend {backend!r} is not available out-of-core "
                "(the chunk kernel supports auto/stream/dense)")
        from .outofcore import compile_chunked_chain, run_chunked
        compiled = compile_chunked_chain(
            program, host_chunks, analysis,
            backend="dense" if backend == "xla" else backend,
            device=device)

        def host_step(state: Dict[str, Any]) -> Dict[str, Any]:
            out = run_chunked(program, state, host_chunks,
                              analysis=analysis, compiled=compiled)
            new_state = dict(state)
            for iname, oname in feed.items():
                new_state[iname] = out[oname]
            return new_state

        host_step.backend = f"outofcore[{compiled[1].backend} x" \
                            f"{host_chunks} chunks]"
        return host_step, feed

    fn, name = _compile(program, analysis, backend, device, ring_storage)

    def step(state: Dict[str, Any]) -> Dict[str, Any]:
        out = fn(state)
        new_state = dict(state)
        for iname, oname in feed.items():
            new_state[iname] = out[oname]
        return new_state

    step.backend = name
    return step, feed


def _latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    best = None
    for path in glob.glob(os.path.join(ckpt_dir, "step_*.npz")):
        m = re.search(r"step_(\d+)\.npz$", path)
        if m:
            k = int(m.group(1))
            if best is None or k > best[0]:
                best = (k, path)
    return best


_SHARD_KEY = re.compile(r"^(.+)/shard_([\d_]+)_of_([\d_]+)$")


def _blocks(v) -> Tuple[int, ...]:
    """Blocks per dim of a ShardedArray."""
    spec = tuple(v.spec) + (None,) * (len(v.shape) - len(v.spec))
    return tuple(v.mesh.shape[ax] if ax is not None else 1 for ax in spec)


def _shard_key(name: str, block, blocks) -> str:
    return (f"{name}/shard_{'_'.join(map(str, block))}_of_"
            f"{'_'.join(map(str, blocks))}")


# what DCP warns at each save and load without a process group: that it
# assumes one process, which is what is meant here
_ONE_PROCESS = ("torch.distributed is disabled, unavailable or "
                "uninitialized, assuming the intent is to {} in a single "
                "process")


def _dcp():
    """``torch.distributed.checkpoint``, imported at first use.  A save's
    warning comes from DCP's writer thread after ``async_save`` has
    returned, where no scoped filter reaches (Python's filters are
    process-wide and ``catch_warnings`` restores them while the thread
    runs), so the save's message alone is filtered for the process; the
    loads are silenced where they are made (``_load``)."""
    import torch.distributed.checkpoint as dcp
    warnings.filterwarnings("ignore", message=_ONE_PROCESS.format("save"))
    return dcp


def _load(dcp, state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """``dcp.load`` into ``state_dict`` in this process alone."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=_ONE_PROCESS.format("load"))
        dcp.load(state_dict, checkpoint_id=path, no_dist=True)


def _latest_step_dir(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """The newest complete step directory (DCP's ``.metadata`` written;
    ``<step>.tmp`` and unfinished directories are skipped)."""
    best = None
    for d in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, d)
        if d.isdigit() and os.path.isfile(os.path.join(path, ".metadata")):
            if best is None or int(d) > best[0]:
                best = (int(d), path)
    return best


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, finished when this returns; from the card
    into pinned memory (its allocator reuses the blocks of earlier
    saves)."""
    if t.device.type != "cuda":
        return t.detach().clone()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _staged(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state as host tensors under DCP keys: one entry per block of a
    ShardedArray (each block once, from the first position holding it),
    one per field otherwise."""
    from .parallel.mesh import ShardedArray
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if isinstance(v, ShardedArray):
            blocks = _blocks(v)
            for c, t in v.shards.items():
                key = _shard_key(k, v.block_index(c), blocks)
                if key not in out:
                    out[key] = _host_copy(t)
        elif torch.is_tensor(v):
            out[k] = _host_copy(v)
        else:
            out[k] = to_torch(np.array(v))
    return out


def _saved_blocks(path: str):
    """{field: [(key, block index, blocks, size, dtype)]} of a DCP step
    directory (an unsharded entry as one block of one)."""
    import torch.distributed.checkpoint as dcp
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    got: Dict[str, list] = {}
    for key, m in md.items():
        size = tuple(m.size)
        hit = _SHARD_KEY.match(key)
        if hit:
            name = hit.group(1)
            block = tuple(int(x) for x in hit.group(2).split("_"))
            blocks = tuple(int(x) for x in hit.group(3).split("_"))
        else:
            name, block, blocks = key, (0,) * len(size), (1,) * len(size)
        got.setdefault(name, []).append(
            (key, block, blocks, size, m.properties.dtype))
    return got


def _restore(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` (freshly placed: the layout to resume onto) filled from
    the DCP step directory ``path``.  A ShardedArray saved in its own
    layout loads each shard in place; any other pair of layouts reads
    one saved block at a time and copies its overlap into each target
    block (a target on one device is its one block)."""
    from .parallel.mesh import ShardedArray
    dcp = _dcp()
    saved = _saved_blocks(path)
    out = dict(state)
    for k, v in state.items():
        entries = saved[k]
        if isinstance(v, ShardedArray):
            blocks = _blocks(v)
            targets = [(t, v.block_slices(c), v.block_index(c))
                       for c, t in v.shards.items()]
        else:
            t = (v if torch.is_tensor(v) else to_torch(np.array(v))).clone()
            blocks = (1,) * t.dim()
            targets = [(t, tuple(slice(0, n) for n in t.shape),
                        (0,) * t.dim())]
        if all(e[2] == blocks for e in entries):
            # the saved layout: every target block loads in place
            by_block = {e[1]: e[0] for e in entries}
            keys: Dict[str, torch.Tensor] = {}
            for t, _idx, block in targets:
                key = by_block[tuple(block)]
                if key in keys:
                    t.copy_(keys[key])
                else:
                    _load(dcp, {key: t}, path)
                    keys[key] = t
        else:
            for key, block, _blocks_, size, dtype in entries:
                buf = torch.empty(size, dtype=dtype)
                _load(dcp, {key: buf}, path)
                lo = [b * n for b, n in zip(block, size)]
                for t, idx, _block in targets:
                    a = [max(s.start, l) for s, l in zip(idx, lo)]
                    b = [min(s.stop, l + n) for s, l, n in zip(idx, lo, size)]
                    if any(x >= y for x, y in zip(a, b)):
                        continue
                    t[tuple(slice(x - s.start, y - s.start) for x, y, s in
                            zip(a, b, idx))].copy_(buf[tuple(
                                slice(x - l, y - l)
                                for x, y, l in zip(a, b, lo))])
        if not isinstance(v, ShardedArray):
            t = targets[0][0]
            out[k] = t if torch.is_tensor(v) else to_numpy(t)
    return out


class GraphLoop:
    """Chunks of ``n`` steps replayed from CUDA graphs over static
    buffers.

    ``state`` (every program input: device tensors, host scalars) holds
    the static buffers, which the loop owns; ``run(n)`` replays the graph
    of ``n`` steps (captured at its first use, after one eager warm-up
    step of the loop), whose last operations copy each fed field's final
    value into its buffer.  ``buffers`` is the state after the last
    replay.  ``captures`` and ``replays`` count graphs captured and
    chunks replayed."""

    def __init__(self, step: Callable, state: Dict[str, Any],
                 feed: Dict[str, str], device: torch.device):
        self.step = step
        self.feed = feed
        self.device = device
        self.buffers = dict(state)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.pool = None
        self.warm = False
        self.captures = 0
        self.replays = 0

    def _capture(self, n: int) -> torch.cuda.CUDAGraph:
        if not self.warm:
            # first-use work (builds, tables, attributes) runs outside the
            # capture, on a side stream; its result is dropped
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.step(self.buffers)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.warm = True
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            state = self.buffers
            for _ in range(n):
                state = self.step(state)
            for iname in self.feed:
                self.buffers[iname].copy_(state[iname])
            del state
        if self.pool is None:
            self.pool = graph.pool()
        self.captures += 1
        return graph

    def run(self, n: int) -> None:
        if n not in self.graphs:
            self.graphs[n] = self._capture(n)
        self.graphs[n].replay()
        self.replays += 1

    def state(self) -> Dict[str, Any]:
        """The buffers as host arrays (waits for the device)."""
        return {k: _host(v) for k, v in self.buffers.items()}


def _host(v):
    """A state value as a host array (a sharded one gathered)."""
    from .parallel.mesh import ShardedArray
    if isinstance(v, ShardedArray):
        return v.numpy()
    return to_numpy(v) if torch.is_tensor(v) else np.asarray(v)


def _checkpointed(program: ir.Program, name: str, a: np.ndarray):
    """A checkpointed state array as the field's type: the JAX package
    saves its ml_dtypes bfloat16 arrays as raw 2-byte voids (``|V2``),
    which are the bf16 bit patterns."""
    dt = np.dtype(program.field_dtype(name))
    if dt == BFLOAT16 and a.dtype != BFLOAT16 and a.dtype.itemsize == 2 \
            and a.dtype.kind == "V":
        return a.view(BFLOAT16)
    return a


def _place(v, device: torch.device, host_mode: bool, plan=None, name=None):
    """A state value where the loop keeps it: arrays on ``device`` (host
    numpy arrays in host mode; with a decomposition ``plan``, a
    ShardedArray laid out by the plan's spec for input ``name``),
    scalars on the host."""
    a = to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
    if a.ndim == 0 or host_mode:
        return a
    if plan is not None:
        from .parallel.domain import place_global_inputs
        return place_global_inputs(plan.program, plan, {name: a})[name]
    return to_torch(a, device)


def iterate(program: ir.Program, inputs: Dict[str, Any], steps: int,
            feed: Optional[Dict[str, str]] = None,
            backend: str = "auto", device="cuda",
            mesh=None, dim_axes: Optional[Sequence] = None,
            chunk: int = 16,
            fuse: int = 1,
            host_chunks: int = 0,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            checkpoint_format: str = "npz",
            resume: bool = True,
            stats: Optional[Dict[str, Any]] = None
            ) -> Dict[str, np.ndarray]:
    """Run ``steps`` chain evaluations with output->input feedback.

    On a CUDA device each chunk of ``chunk`` steps is one replay of a
    CUDA graph (see the module docstring); with ``checkpoint_every`` >
    0, state is persisted to ``checkpoint_dir`` at that cadence as
    ``step_<n>.npz`` (atomic rename; one written by the JAX package's
    ``iterate`` resumes here too) or, with ``checkpoint_format="orbax"``,
    as a directory ``<n>`` of sharded entries saved asynchronously (the
    module docstring), and, when ``resume``, execution continues from the
    newest checkpoint found.

    ``fuse`` > 1 composes that many time steps into one deeper chain
    (``compose_iterations``) before compiling; ``steps`` and
    ``checkpoint_every`` keep their original-step units and must be
    multiples of ``fuse``.  ``stats``, when given, receives the
    lowering (``backend``) and, on the card, the graphs captured and the
    chunks replayed, and under ``checkpoint_format="orbax"`` the host
    seconds of each save's staging and submission (``save_s``) and the
    seconds spent waiting for saves to finish (``save_wait_s``).
    Returns the final state as host arrays.

    ``mesh`` + ``dim_axes``: every step runs through the sharded engine
    on the mesh's devices (``make_step``); ``device`` is then unused.  A
    mesh spanning processes is refused: the state returned is the global
    field.
    """
    if fuse < 1:
        raise IterateError(f"fuse must be >= 1, got {fuse}")
    if chunk < 1:
        raise IterateError(f"chunk must be >= 1, got {chunk}")
    if mesh is not None and dim_axes is None:
        raise IterateError(MESH_NEEDS_AXES)
    if mesh is not None and host_chunks and host_chunks > 1:
        raise IterateError("host_chunks is incompatible with mesh")
    if getattr(mesh, "distributed", False):
        raise IterateError("iterate returns the global state; a mesh "
                           "spanning processes does not run here")
    scale = fuse
    if scale > 1:
        if steps % scale:
            raise IterateError(f"steps ({steps}) must be a multiple of "
                               f"fuse ({scale})")
        if checkpoint_every and checkpoint_every % scale:
            raise IterateError("checkpoint_every must be a multiple of "
                               "fuse")
        feed = feed or _default_feed(program)
        program = compose_iterations(program, scale, feed)
    steps_f = steps // scale
    ckpt_f = checkpoint_every // scale if checkpoint_every else 0
    if ckpt_f > 0:
        if not checkpoint_dir:
            raise IterateError("checkpoint_every requires checkpoint_dir")
        if checkpoint_format not in ("npz", "orbax"):
            raise IterateError(
                f"unknown checkpoint_format: {checkpoint_format!r}")

    analysis = ChainAnalysis.run(program)
    host_mode = bool(host_chunks and host_chunks > 1)
    step, feed = make_step(program, feed, backend, device, mesh, dim_axes,
                           analysis=analysis, host_chunks=host_chunks)
    plan = getattr(step, "plan", None)
    # the loop's device; with a mesh, the one every shard shares, or None
    # for a mesh of distinct devices (stepped eagerly, not yet run on
    # distinct devices)
    device = mesh.one_device() if mesh is not None else resolve_device(device)

    def place(k, v):
        return _place(v, device, host_mode, plan, k)

    start = 0
    state = {k: place(k, v) for k, v in inputs.items()}
    dcp_format = checkpoint_format == "orbax"
    if ckpt_f > 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        latest = None
        if resume:
            latest = (_latest_step_dir(checkpoint_dir) if dcp_format
                      else _latest_checkpoint(checkpoint_dir))
        if latest is not None:
            start_orig, path = latest
            if start_orig > steps:
                raise IterateError(
                    f"checkpoint {path} is at step {start_orig}, "
                    f"beyond the requested {steps}; pass resume=False "
                    "or a fresh checkpoint_dir")
            if start_orig % scale:
                raise IterateError(
                    f"checkpoint {path} at step {start_orig} does not "
                    f"align with fuse={scale}")
            start = start_orig // scale
            if dcp_format:
                state = _restore(path, state)
            else:
                with np.load(path) as data:
                    state = {k: place(k, _checkpointed(program, k, data[k]))
                             for k in state}
        # checkpoints must land on chunk boundaries
        chunk = min(chunk, ckpt_f)

    loop = None
    if device is not None and device.type == "cuda" and not host_mode:
        loop = GraphLoop(step, state, feed, device)

        def run_chunk(n):
            loop.run(n)

        def snapshot():
            return loop.state()

        def live():
            return loop.buffers
    else:
        # host mode (one chunked device sweep per fused step), the CPU and
        # a mesh of distinct devices
        def run_chunk(n):
            nonlocal state
            for _ in range(n):
                state = step(state)

        def snapshot():
            return {k: _host(v) for k, v in state.items()}

        def live():
            return state

    pending = []        # the save in flight: (future, tmp dir, step dir)
    save_s, wait_s = [], 0.0

    def finish_save():
        """Wait for the save in flight, then make its directory visible."""
        nonlocal wait_s
        if pending:
            fut, tmp, final = pending.pop()
            t0 = time.perf_counter()
            fut.result()
            wait_s += time.perf_counter() - t0
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)

    def save(step_orig):
        finish_save()
        final = os.path.join(checkpoint_dir, str(step_orig))
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        t0 = time.perf_counter()
        pending.append((_dcp().async_save(_staged(live()),
                                          checkpoint_id=tmp, no_dist=True),
                        tmp, final))
        save_s.append(time.perf_counter() - t0)

    done = start
    try:
        while done < steps_f:
            n = min(chunk, steps_f - done)
            if ckpt_f > 0:
                n = min(n, ckpt_f - done % ckpt_f or ckpt_f)
            run_chunk(n)
            done += n
            if ckpt_f > 0 and (done % ckpt_f == 0 or done >= steps_f):
                if dcp_format:
                    # asynchronous: the write overlaps the next chunk
                    save(done * scale)
                else:
                    final = os.path.join(checkpoint_dir,
                                         f"step_{done * scale}.npz")
                    tmp = final + ".tmp.npz"
                    np.savez(tmp, **snapshot())
                    os.replace(tmp, final)  # atomic: a crash never
                    #               corrupts the newest resumable one
    finally:
        # the save in flight completes even when the loop raises, so the
        # newest step directory is whole and resumable
        finish_save()
    if stats is not None:
        stats["backend"] = step.backend
        if loop is not None:
            stats.update(captures=loop.captures, replays=loop.replays)
        if dcp_format:
            stats.update(save_s=save_s, save_wait_s=wait_s)
    return snapshot()

"""Domain decomposition over a device mesh with a halo exchange.

Port of ``stencilflow_tpu/parallel/domain.py``.  Each mesh position owns a contiguous block of
the (i, j, k) domain.  One halo exchange per chain evaluation: every
sharded input receives slabs of the chain's *cumulative* halo width from
its mesh neighbours, after which the whole kernel chain is evaluated
locally on the widened block — one halo per input, not one per stage.
Global boundary blocks receive zero slabs, which is safe: the local body
masks every out-of-domain read with its boundary condition using
*global* coordinates derived from the block's mesh position.

The design is single-controller within a process, as the reference's
``shard_map`` is: one process drives the mesh positions it holds
(``mesh.Mesh``), each shard a tensor on its position's device
(``mesh.ShardedArray``).  The exchange is slab copies between shard
tensors (``copy_``; between two devices PyTorch orders the copy after
both devices' pending work with events), dim by dim, so corner slabs
come from diagonal neighbours as the reference's sequence of
``ppermute``s gives them.  A mesh may repeat a device: virtual shards on
one GPU run the same launches, one after another on its stream.  Across
processes (the multi-host launch, multi-controller as the JAX
package's) a neighbour on another process sends its slab through
``transport.py`` instead, a round a dim.  Copies between distinct GPUs
have not been run: the port's machine has one.

The local body is K4 in shard mode on CUDA shards (the stream kernel,
``backend/stream.py`` local mode with a 3-D origin: ``sf_shard_launch``
takes the shard's (i, j, k) origin, inputs arrive widened by the
exchanged halo, every BC mask and band edge is taken at the global
coordinate, and banded stages read this shard's slice of the
origin-aware band matrices and correction planes), and the dense tile
body (``backend/tile_eval.py evaluate_chain_tile``, the reference's
"xla" body) on CPU shards or where no stream plan fits.

The opt-in comm/compute overlap (``comm_overlap=True``, the reference's
``_local_forward_overlap`` and ``_local_forward_stream_overlap``) splits
each shard's work in two: the block's interior, which needs no
neighbour, is computed from the raw block, and boundary strips from the
widened block once the exchange has landed.  On CUDA shards the
exchange's copies run on a side stream of each device while the
interiors run on the compute stream; the strips wait for the exchange
with ``wait_stream``.  The stream body (K4) takes i-only sharding: an
interior K4 of ``B0 - 2h`` planes reads the raw block, and a strip K4
of ``h`` planes runs on a ``3h``-plane slab at each face, all three
writing slices of one output per shard.  The tile body overlaps on any
sharding (the interior on the unwidened block, ``3h`` strips per face,
stitched).  On one card the shards are virtual: the overlap there shows
the streams at work, not a scaling figure.

``plan_local_stream`` also chooses the out-of-core chunk body
(``outofcore.py``), a block with no mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ir
from ..backend.dense import chain_halo
from ..backend.tile_eval import evaluate_chain_tile
from ..dtypes import to_torch, to_torch_dtype
from ..frontend.analysis import ChainAnalysis
from .mesh import Mesh, ShardedArray

Vec3 = Tuple[int, int, int]

@dataclasses.dataclass
class DomainDecomposition:
    """Static plan for sharding one program's domain over a mesh.

    ``dim_axes[d]`` is the mesh axis name dim ``d`` is sharded over (None =
    replicated).  Dims must divide evenly by the axis size and each local
    block must be wider than the halo (single-hop exchange).  Without a
    mesh (``mesh=None``, all axes None) it describes the one block of an
    out-of-core chunk, whose i-halo arrives with the host slab."""
    program: ir.Program
    mesh: Optional[Mesh]
    dim_axes: Tuple[Optional[str], Optional[str], Optional[str]]
    halo: Vec3          # effective halo: chain halo in sharded dims, else 0
    block: Vec3

    @classmethod
    def plan(cls, program: ir.Program, mesh: Mesh,
             dim_axes: Sequence[Optional[str]],
             analysis: Optional[ChainAnalysis] = None
             ) -> "DomainDecomposition":
        analysis = analysis or ChainAnalysis.run(program)
        full_halo = chain_halo(analysis)
        dims = program.dimensions
        if dim_axes is None:
            raise ValueError(
                "dim_axes is required, e.g. (None, 'x', 'y') to shard "
                "(j, k) over a 2-D mesh")
        dim_axes = tuple(dim_axes)
        block = []
        halo = []
        for d in range(3):
            ax = dim_axes[d]
            if ax is not None and ax not in mesh.shape:
                raise ValueError(f"unknown mesh axis {ax!r} (mesh has "
                                 f"{list(mesh.shape)})")
            n = mesh.shape[ax] if ax is not None else 1
            if dims[d] % n != 0:
                raise ValueError(
                    f"dim {d} ({dims[d]}) not divisible by mesh axis "
                    f"'{ax}' size {n}")
            b = dims[d] // n
            # unsharded dims span the whole domain locally: offset reads
            # land on globally-OOB cells which every BC mask corrects, so
            # no widening is needed there
            h = full_halo[d] if (ax is not None and n > 1) else 0
            if h >= b > 0 and h > 0:
                raise ValueError(
                    f"halo {h} >= local block {b} in dim {d}; "
                    "use fewer shards or a shallower chain")
            block.append(b)
            halo.append(h)
        return cls(program, mesh, dim_axes, tuple(halo), tuple(block))

    # -- shardings -----------------------------------------------------------
    def spec_for_input(self, name: str) -> Tuple[Optional[str], ...]:
        """The input's PartitionSpec: a mesh axis per spanned dim."""
        spec = self.program.inputs[name]
        if spec.is_scalar:
            return ()
        return tuple(self.dim_axes[d] for d in range(3) if spec.dim_mask[d])

    def spec_for_output(self) -> Tuple[Optional[str], ...]:
        raw = self.program.raw_dimensions
        # outputs are produced at raw (unpadded) rank; padded leading dims
        # of size 1 are dropped, so map the trailing raw dims
        return tuple(self.dim_axes[d] for d in range(3 - len(raw), 3))

    def input_shardings(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return {n: self.spec_for_input(n) for n in self.program.inputs}

    # -- per shard -----------------------------------------------------------
    def block_origin(self, coord) -> Vec3:
        """Global element offset of ``coord``'s (unwidened) block."""
        return tuple(self.mesh.index(coord, self.dim_axes[d]) * self.block[d]
                     for d in range(3))

    def instance(self, coord) -> Tuple[int, int]:
        """``coord``'s (j, k) shard instance: its slice of the stacked
        band matrices and correction planes."""
        return (self.mesh.index(coord, self.dim_axes[1]),
                self.mesh.index(coord, self.dim_axes[2]))

    def local_raw(self) -> Tuple[int, ...]:
        raw = self.program.raw_dimensions
        return tuple(self.block[3 - len(raw) + i] for i in range(len(raw)))


def _exchange_halo(arr: ShardedArray, local_dims: Sequence[int],
                   plan: DomainDecomposition) -> Dict[Any, torch.Tensor]:
    """Widen every shard of ``arr`` by the halo in every spanned dim
    (``local_dims``: the global dims its array dims span, in order),
    with its neighbours' slabs (zeros at global boundaries).  Dims are
    widened one after another, each slab spanning the dims widened
    before it, so corners come from diagonal neighbours.  Returns the
    widened tensor of every mesh position this process holds.

    A neighbour on this process gives its slab by a device copy; one on
    another process by a round of ``transport.Transfers`` per dim: every
    remote slab posted at once, all waited for, then copied into place
    before the next dim."""
    mesh = plan.mesh
    out = {}
    for c, t in arr.shards.items():
        shape = tuple(t.shape[p] + 2 * plan.halo[d]
                      for p, d in enumerate(local_dims))
        if shape == tuple(t.shape):
            out[c] = t
            continue
        w = torch.empty(shape, dtype=t.dtype, device=t.device)
        w[tuple(slice(plan.halo[d], plan.halo[d] + t.shape[p])
                for p, d in enumerate(local_dims))].copy_(t)
        out[c] = w
    remote = mesh.distributed
    if remote:
        from .transport import Transfers
    for pos, d in enumerate(local_dims):
        h = plan.halo[d]
        ax = plan.dim_axes[d]
        if h == 0:
            continue
        n = mesh.shape[ax]
        B = plan.block[d]
        axis = mesh.axis_names.index(ax)

        def region(c, lo, hi):
            """Slab [lo, hi) of dim ``pos``: dims widened before it whole,
            the ones after it at their core."""
            idx = []
            for p, dd in enumerate(local_dims):
                if p == pos:
                    idx.append(slice(lo, hi))
                elif p < pos or plan.halo[dd] == 0:
                    idx.append(slice(None))
                else:
                    hh = plan.halo[dd]
                    idx.append(slice(hh, hh + plan.block[dd]))
            return out[c][tuple(idx)]

        xfer = Transfers(mesh) if remote else None
        for c in (mesh.coords() if remote else out):
            i = c[axis]
            # my left halo is my left neighbour's high core slab, my right
            # halo my right neighbour's low core slab
            mine = c in out
            for nb, dst, src in ((i - 1, (0, h), (B, B + h)),
                                 (i + 1, (h + B, 2 * h + B), (h, 2 * h))):
                if not 0 <= nb < n:
                    if mine:
                        region(c, *dst).zero_()
                    continue
                o = c[:axis] + (nb,) + c[axis + 1:]
                into = region(c, *dst) if mine else None
                value = region(o, *src) if o in out else None
                if xfer is None:
                    into.copy_(value, non_blocking=True)
                else:
                    xfer.move(o, c, value, lambda buf, into=into: into.copy_(
                        buf, non_blocking=True), like=into)
        if xfer is not None:
            xfer.run()
    return out


def exchange_bytes(plan: DomainDecomposition) -> Tuple[int, int]:
    """(bytes read, bytes written) of one exchange over the mesh: every
    widened shard written once, its core and its neighbours' slabs read
    (the global-edge slabs are zero-filled, not read)."""
    program, mesh = plan.program, plan.mesh
    read = written = 0
    for name, spec in program.inputs.items():
        if spec.is_scalar:
            continue
        dims = [d for d in range(3) if spec.dim_mask[d]]
        if not any(plan.halo[d] for d in dims):
            continue
        size = np.dtype(spec.dtype).itemsize
        core = int(np.prod([plan.block[d] for d in dims]))
        wide = int(np.prod([plan.block[d] + 2 * plan.halo[d] for d in dims]))
        read += mesh.size * core * size
        written += mesh.size * wide * size
        for pos, d in enumerate(dims):
            h = plan.halo[d]
            if not h:
                continue
            n = mesh.shape[plan.dim_axes[d]]
            slab = h * int(np.prod([
                (plan.block[dd] + 2 * plan.halo[dd]) if p < pos
                else plan.block[dd]
                for p, dd in enumerate(dims) if dd != d]))
            read += 2 * (n - 1) * (mesh.size // n) * slab * size
    return read, written


def _widen_and_origin(plan: DomainDecomposition,
                      inputs: Dict[str, ShardedArray]):
    """The exchange: every array input widened on every shard (scalars
    pass through).  Returns {coord: {name: tensor}}."""
    program = plan.program
    per: Dict[Any, Dict[str, Any]] = {c: {} for c in
                                      plan.mesh.local_coords()}
    for name, spec in program.inputs.items():
        arr = inputs[name]
        if spec.is_scalar:
            for c in per:
                per[c][name] = arr
            continue
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        for c, t in _exchange_halo(arr, spanned, plan).items():
            per[c][name] = t
    return per


def _local_forward(plan: DomainDecomposition, graph, coord,
                   tiles: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The dense tile body on one shard's widened block."""
    program = plan.program
    halo = plan.halo
    results = evaluate_chain_tile(program, graph, tiles,
                                  plan.block_origin(coord), halo)
    core = tuple(slice(halo[d], halo[d] + plan.block[d]) for d in range(3))
    return {n: arr[core].reshape(plan.local_raw())
            for n, arr in results.items()}


def _local_forward_stream(plan: DomainDecomposition, kern, coord,
                          tiles: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """K4 on one shard: origin i shifted back by the i-halo (local plane
    g is global i = origin + g), (j, k) at the core's origin, and this
    shard's instance of the pool."""
    oi, oj, ok = plan.block_origin(coord)
    outs = kern(oi - plan.halo[0], tiles, oj, ok, plan.instance(coord))
    return {n: arr.reshape(plan.local_raw()) for n, arr in outs.items()}


def _local_forward_overlap(plan: DomainDecomposition, graph, coord,
                           raw: Dict[str, Any]):
    """The tile body's overlap, first half: the shard's chain evaluated
    on its unwidened block (no exchange).  Wrap-around reads in sharded
    dims land on wrong cells, so its outermost cumulative-halo rim is
    invalid until ``_overlap_strips`` overwrites it; unsharded dims keep
    the single-device invariant."""
    results = evaluate_chain_tile(plan.program, graph, dict(raw),
                                  plan.block_origin(coord), (0, 0, 0))
    return {n: a.contiguous() for n, a in results.items()}


def _overlap_strips(plan: DomainDecomposition, graph, coord,
                    tiles: Dict[str, Any], outs: Dict[str, torch.Tensor]):
    """The tile body's overlap, second half: per sharded dim and face, a
    ``3h`` slab of the widened block (every other dim at its widened
    extent, so corners are covered) evaluated and its ``h`` core planes
    stitched over ``outs``' rim."""
    program, halo, B = plan.program, plan.halo, plan.block
    origin = plan.block_origin(coord)
    for d in [d for d in range(3) if halo[d] > 0]:
        h = halo[d]
        for side in (0, 1):
            strip: Dict[str, Any] = {}
            for name, spec in program.inputs.items():
                arr = tiles[name]
                if spec.is_scalar or not spec.dim_mask[d]:
                    strip[name] = arr
                    continue
                pos = sum(spec.dim_mask[:d])
                lo = 0 if side == 0 else arr.shape[pos] - 3 * h
                strip[name] = arr.narrow(pos, lo, 3 * h)
            so = list(origin)
            if side == 1:
                so[d] += B[d] - h
            res = evaluate_chain_tile(program, graph, strip, so, halo)
            for n, arr in res.items():
                core = [slice(halo[dd], halo[dd] + B[dd]) for dd in range(3)]
                core[d] = slice(h, 2 * h)
                dst = [slice(0, B[dd]) for dd in range(3)]
                dst[d] = slice(0, h) if side == 0 else slice(B[d] - h, B[d])
                outs[n][tuple(dst)] = arr[tuple(core)]
    return {n: a.reshape(plan.local_raw()) for n, a in outs.items()}


def _stream_overlap_interior(plan: DomainDecomposition, kern_i, coord,
                             raw: Dict[str, Any]):
    """The stream body's overlap, first half: each output of the shard
    allocated whole, and the interior K4 (local planes [h, B0 - h)) run
    on the raw block, whose plane 0 is global ``start``, writing its
    slice."""
    h, B0 = plan.halo[0], plan.block[0]
    start, oj, ok = plan.block_origin(coord)
    t = next(v for n, v in raw.items()
             if not plan.program.inputs[n].is_scalar)
    outs = {o: torch.empty((B0,) + tuple(plan.block[1:]), device=t.device,
                           dtype=to_torch_dtype(plan.program.kernels[o].dtype))
            for o in plan.program.outputs}
    kern_i(start, raw, oj, ok, plan.instance(coord),
           {o: v[h:B0 - h] for o, v in outs.items()})
    return outs


def _stream_overlap_strips(plan: DomainDecomposition, kern_s, coord,
                           tiles: Dict[str, Any], outs):
    """The stream body's overlap, second half: the strip K4 (h planes) on
    the widened block's ``3h``-plane slab at each face, writing the
    output's first and last ``h`` planes."""
    h, B0 = plan.halo[0], plan.block[0]
    start, oj, ok = plan.block_origin(coord)
    for lo, origin, dst in ((0, start - h, slice(0, h)),
                            (B0 - h, start + B0 - 2 * h, slice(B0 - h, B0))):
        slab = {n: v if plan.program.inputs[n].is_scalar
                or not plan.program.inputs[n].dim_mask[0]
                else v.narrow(0, lo, 3 * h)
                for n, v in tiles.items()}
        kern_s(origin, slab, oj, ok, plan.instance(coord),
               {o: v[dst] for o, v in outs.items()})
    return {n: v.reshape(plan.local_raw()) for n, v in outs.items()}


def _shard_contexts(plan: DomainDecomposition):
    """The j and k contexts of the origin-aware band matrices: the global
    coordinate of every shard instance's widened plane's row / col 0;
    None when the shard plane is the global (j, k) plane (i-only
    sharding)."""
    mesh = plan.mesh
    ax_j, ax_k = plan.dim_axes[1], plan.dim_axes[2]
    n_j = mesh.shape[ax_j] if ax_j is not None else 1
    n_k = mesh.shape[ax_k] if ax_k is not None else 1
    Bj, Bk = plan.block[1], plan.block[2]
    hjp, hkp = plan.halo[1], plan.halo[2]
    if n_j == 1 and n_k == 1 and hjp == 0 and hkp == 0:
        return None
    return ([s * Bj - hjp for s in range(n_j)],
            [s * Bk - hkp for s in range(n_k)])


def _sharded_mxu_assets(splan, plan: DomainDecomposition):
    """The stacked band-matrix assets of a shard plan, as the reference
    lays them over the mesh: ``(global_arrays, pspecs, local_shapes,
    resident_bytes)`` — L stacks over the j instances (sharded over the
    j axis), R over the k ones, correction planes over their j-major
    cross product (both axes), the rest replicated; or None when no
    stage is banded.  Each shard's kernel reads its instance's slice
    (``StreamPlan.kernel_pool(inst)``, passed per launch)."""
    from ..backend.linear import stacked_axes
    if not splan.mxu_plans:
        return None
    names = (plan.dim_axes[1], plan.dim_axes[2])
    n = splan.instances()
    global_arrays: Dict[str, np.ndarray] = {}
    pspecs: Dict[str, tuple] = {}
    local_shapes: Dict[str, tuple] = {}
    resident = 0
    for k, a in splan.pool.items():
        axes = stacked_axes(k)
        local = a.shape[1:] if axes else a.shape
        global_arrays[k] = a.reshape(tuple(n[x] for x in axes) + local)
        pspecs[k] = tuple(names[x] for x in axes)
        local_shapes[k] = local
        resident += int(np.prod(local)) * a.dtype.itemsize
    return global_arrays, pspecs, local_shapes, resident


def plan_local_stream(program: ir.Program, analysis: ChainAnalysis,
                      plan: DomainDecomposition, mxu: str = "auto",
                      mxu_precision: str = "split", spill: str = "auto",
                      smem_budget: Optional[int] = None,
                      ring_storage: str = "off", _composed=None):
    """Choose the per-block streaming kernel (K4) for a local block of
    ``plan.block`` with halo ``plan.halo``.

    Candidate order, as the reference's rescue: the block with banded
    stages, then every stage per cell, then (``spill="auto"``) every
    stage per cell with rings spilled to device memory (K3c).  Outputs
    may spill here: the kernel writes core planes directly, not through
    their ring.  The (j, k) tile is the port's own choice within each
    candidate (it replaces the reference's j-tiles, so ``jtiles`` is 1);
    ``smem_budget`` is the shared memory a block may take
    (``H100_SMEM_PER_BLOCK`` by default).  With a mesh (``plan.mesh``)
    the plan is K4's shard mode: the shard's (j, k) core, the exchanged
    halo and the origin-aware band contexts (``_shard_contexts``).
    ``mxu_precision="bf16"`` gives single-pass bf16 band passes and
    ``ring_storage="bfloat16"`` bf16 rings (every leg: the spill leg's
    choice sees the half-size rings).  A composed program (``_composed``:
    its segments) takes the banded leg only and raises ValueError where
    that fails.  Returns
    ``(stream_plan, config)``, ``config`` with the reference's keys
    (``backend``, ``jtiles``, ``mxu_stages``, ``spilled``), or None when
    the program is out of the kernel's scope or no candidate fits (the
    caller then takes the dense tile body, as the reference takes its
    fused-XLA one)."""
    from ..config import H100_SMEM_PER_BLOCK
    from ..backend.stacked_io import check_ring_storage
    from ..backend.stream import check_options, check_spill, plan_local
    check_options(mxu, mxu_precision)   # raised, never re-routed
    check_spill(spill)
    check_ring_storage(ring_storage)
    budget = H100_SMEM_PER_BLOCK if smem_budget is None else smem_budget
    legs = [("auto", "off")] if mxu != "off" else []
    legs += [("off", "off")] + ([("off", spill)] if spill != "off" else [])
    if spill == "all":   # the spill rung alone
        legs = [("off", "all")]
    if _composed:
        legs = [("auto", "off")]
    shard = {}
    if plan.mesh is not None:
        shard = dict(shard=plan.block[1:], xhalo=plan.halo[1:],
                     contexts=_shard_contexts(plan))
    for leg, leg_spill in legs:
        try:
            splan = plan_local(program, analysis, plan.block[0],
                               plan.halo[0], mxu=leg,
                               mxu_precision=mxu_precision,
                               smem_budget=budget, spill=leg_spill,
                               builds=_composed, ring_storage=ring_storage,
                               **shard)
        except (ValueError, NotImplementedError):
            if _composed:
                raise ValueError("composed segments not plannable on this "
                                 "decomposition")
            continue
        if leg == "auto" and not splan.mxu_plans:
            continue   # no banded stage: the same as the per-cell leg
        return splan, {"backend": "stream", "jtiles": 1,
                       "mxu_stages": sorted(splan.mxu_plans),
                       "spilled": sorted(splan.spilled)}
    if _composed:
        raise ValueError("composed segments not plannable on this "
                         "decomposition")
    return None


def reduced_precision(mxu_precision: str, ring_storage: str = "off") -> bool:
    """Is a reduced precision asked for: single-pass bf16 band passes or
    bf16 rings?  Both live in K4 alone."""
    return mxu_precision == "bf16" or ring_storage != "off"


def check_dense_precision(mxu_precision: str, ring_storage: str = "off"
                          ) -> None:
    """Refuse a reduced precision where the dense tile body would run: it
    has neither band passes nor rings, so it would compute in f32 (the
    JAX package's XLA tile body does so while its driver widens the
    verification for bf16); a bf16 request is K4's or an error."""
    if reduced_precision(mxu_precision, ring_storage):
        asked = ("mxu_precision='bf16'" if mxu_precision == "bf16"
                 else f"ring_storage={ring_storage!r}")
        raise ValueError(
            f"{asked} needs K4 (the stream body): the dense tile body "
            "has no bf16 band passes or rings and would run f32; no K4 "
            "plan fits here or local_backend='xla' was asked for")


def _as_sharded(plan: DomainDecomposition, name: str, v) -> Any:
    """An input as the local bodies take it: a ShardedArray laid out by
    the plan's spec (placed now when given as a global array), scalars
    as 0-d host tensors."""
    spec = plan.program.inputs[name]
    if spec.is_scalar:
        return to_torch(v)
    if isinstance(v, ShardedArray):
        if v.mesh is plan.mesh and v.spec == plan.spec_for_input(name):
            return v
        v = v.gather()
    return ShardedArray.place(plan.mesh, plan.spec_for_input(name),
                              _spanned(plan.program, name, v))


def _spanned(program: ir.Program, name: str, v):
    """An input value at its spanned shape."""
    spec = program.inputs[name]
    shape = tuple(program.dimensions[d] for d in range(3)
                  if spec.dim_mask[d])
    return to_torch(v).reshape(shape)


def _plan_sharded_chain(program: ir.Program, mesh: Mesh,
                       dim_axes: Sequence[Optional[str]],
                       analysis: Optional[ChainAnalysis] = None,
                       local_backend: str = "auto", mxu: str = "auto",
                       mxu_precision: str = "split", spill: str = "auto",
                       smem_budget: Optional[int] = None,
                       compose: str = "auto", ring_storage: str = "off",
                       comm_overlap: bool = False):
    """``compile_sharded_chain``'s planning, nothing built: ``(program,
    analysis, plan, stream_plan, config)`` — the program the shards run
    (composed where that plans), its decomposition, K4's shard plan (None
    for the dense tile body; under the stream body's overlap the pair
    (interior plan, strip plan)) and ``last_config``'s keys.

    ``comm_overlap`` as the reference takes it: dropped where no halo is
    exchanged, no composition under it; the stream body takes i-only
    sharding (ValueError "i-only") with an interior (B0 > 2h, ValueError
    "interior") and plans K4 twice, for the (B0 - 2h)-plane interior and
    the h-plane strip, each with its own pool instances; where either
    does not plan, the tile body's overlap runs.

    Affine-run composition on the sharded path: the composed i-table is
    indexed by the GLOBAL plane (the kernel globalizes via origin_i + q,
    so i-sharded decompositions compose too); per-shard j/k windows come
    from plan_composed's origin contexts.  Any planning failure of the
    composed program falls back to the uncomposed one.  A reduced
    precision (``reduced_precision``) takes K4 on any shard ("auto": its
    plain version on CPU shards) and raises where the dense tile body
    would run (``check_dense_precision``)."""
    analysis = analysis or ChainAnalysis.run(program)
    on_cuda = {d.type for d in mesh.devices.flat} == {"cuda"}
    if local_backend == "auto":
        local_backend = "stream" if on_cuda or reduced_precision(
            mxu_precision, ring_storage) else "xla"
    if local_backend not in ("stream", "xla"):
        raise ValueError(f"unknown local_backend {local_backend!r} "
                         "(choose from auto, stream, xla)")
    plan = DomainDecomposition.plan(program, mesh, dim_axes, analysis)
    comm_overlap = comm_overlap and any(h > 0 for h in plan.halo)
    if local_backend == "stream" and comm_overlap:
        if plan.halo[1] or plan.halo[2]:
            raise ValueError(
                "comm_overlap with the streaming local backend supports "
                "i-only sharding; use local_backend='xla' for j/k-sharded "
                "overlap, or comm_overlap=False")
        h, B0 = plan.halo[0], plan.block[0]
        if B0 <= 2 * h:
            raise ValueError(
                f"comm_overlap needs an interior: local i-block {B0} must "
                f"exceed twice the halo {h} (use fewer shards)")
        got = [plan_local_stream(
            program, analysis,
            dataclasses.replace(plan, block=(b,) + plan.block[1:]),
            mxu=mxu, mxu_precision=mxu_precision, spill=spill,
            smem_budget=smem_budget, ring_storage=ring_storage)
            for b in (B0 - 2 * h, h)]
        if None not in got:
            return program, analysis, plan, (got[0][0], got[1][0]), dict(
                got[0][1], comm_overlap=True,
                strip_jtiles=got[1][1]["jtiles"])
        local_backend = "xla"   # the tile body's overlap
    if (compose != "off" and mxu != "off" and local_backend == "stream"
            and not comm_overlap):
        from ..backend.compose import compose_program
        max_t = int(compose) if compose not in ("auto",) else 0
        got = (compose_program(program, analysis, max_t)
               if max_t >= 0 else None)
        if got is not None:
            program2, builds = got
            try:
                analysis2 = ChainAnalysis.run(program2)
                plan2 = DomainDecomposition.plan(program2, mesh, dim_axes,
                                                 analysis2)
                splan, cfg = plan_local_stream(
                    program2, analysis2, plan2, mxu=mxu,
                    mxu_precision=mxu_precision, spill=spill,
                    smem_budget=smem_budget, ring_storage=ring_storage,
                    _composed=builds)
                # the caller shards inputs/outputs by the ORIGINAL
                # program's field names; composition preserves inputs
                # and outputs, so plan2's shardings apply directly
                return program2, analysis2, plan2, splan, dict(
                    cfg, comm_overlap=False, composed={
                        name: list(b.stages) for name, b in builds.items()})
            except (ValueError, NotImplementedError):
                pass
    if local_backend == "stream":
        got = plan_local_stream(program, analysis, plan, mxu=mxu,
                                mxu_precision=mxu_precision, spill=spill,
                                smem_budget=smem_budget,
                                ring_storage=ring_storage)
        if got is not None:
            return program, analysis, plan, got[0], dict(
                got[1], comm_overlap=False)
    # the dense tile body: asked for, or the rescue where nothing fits
    check_dense_precision(mxu_precision, ring_storage)
    return program, analysis, plan, None, {
        "backend": "xla", "jtiles": 0, "mxu_stages": [],
        "comm_overlap": comm_overlap}


def compile_sharded_chain(program: ir.Program, mesh: Mesh,
                          dim_axes: Sequence[Optional[str]],
                          analysis: Optional[ChainAnalysis] = None,
                          local_backend: str = "auto",
                          mxu: str = "auto",
                          mxu_precision: str = "split",
                          spill: str = "auto",
                          smem_budget: Optional[int] = None,
                          comm_overlap: bool = False,
                          ring_storage: str = "off",
                          compose: str = "auto"):
    """Build a mesh-sharded ``fn(inputs) -> outputs`` for the chain.

    ``local_backend``: per-shard compute path — "stream" (K4 in shard
    mode on CUDA shards, its plain version on CPU shards; any subset of
    (i, j, k) may be sharded), "xla" (the dense tile body, runs
    anywhere), or "auto" ("stream" on CUDA shards, "xla" on CPU ones).
    "xla" is also the rescue when no stream plan fits, and
    ``compile_sharded_chain.last_config`` (and ``fn.last_config``) says
    so.  ``inputs`` are ShardedArrays laid out by
    ``plan.input_shardings()`` (others are placed on entry); the outputs
    are ShardedArrays by ``plan.spec_for_output()``.  Returns ``(fn,
    plan)``; ``fn.exchange`` and ``fn.compute`` are its two halves
    (placed inputs -> widened shards -> outputs) and ``fn.plan`` K4's
    shard plan (None on the tile body).

    ``mxu="auto"`` lowers wide affine stages to banded transforms inside
    the per-shard kernel, with origin-aware per-shard band matrices and
    correction planes; ``compose`` composes affine runs first
    (``_plan_sharded_chain``).  The JAX package's opt-in reduced
    precisions run in K4 alone: ``mxu_precision="bf16"`` (single-pass
    bf16 band passes) and ``ring_storage="bfloat16"`` (bf16 rings, f32
    compute) take the stream body on any shard and raise ValueError
    where the dense tile body would run.

    ``comm_overlap=True`` hides the exchange behind each shard's
    interior (``_plan_sharded_chain``): on CUDA shards the exchange's
    copies run on a side stream per device while the interiors (the
    interior K4, or the tile body on the unwidened block) run on the
    compute stream, which waits for the exchange before the strips
    (two strip K4s a shard, or the tile body's strips).  ``fn.plan`` is
    then the (interior, strip) pair of K4 plans, and ``fn`` has no
    ``compute`` half."""
    program, analysis, plan, splan, cfg = _plan_sharded_chain(
        program, mesh, dim_axes, analysis, local_backend, mxu,
        mxu_precision, spill, smem_budget, compose, ring_storage,
        comm_overlap)
    graph = analysis.graph
    compile_sharded_chain.last_config = cfg
    on_cuda = {d.type for d in mesh.devices.flat} == {"cuda"}
    if cfg["comm_overlap"]:
        return _compile_overlap(program, plan, graph, splan, cfg, on_cuda)
    if splan is not None:
        kern = _shard_kernel(splan, plan, on_cuda)

        def local(c, tiles):
            return _local_forward_stream(plan, kern, c, tiles)
    else:
        def local(c, tiles):
            return _local_forward(plan, graph, c, tiles)

    out_spec = plan.spec_for_output()
    out_shape = tuple(program.raw_dimensions)

    def exchange(placed):
        return _widen_and_origin(plan, placed)

    def compute(per):
        outs: Dict[str, Dict[Any, torch.Tensor]] = {
            o: {} for o in program.outputs}
        for c, tiles in per.items():
            for o, v in local(c, tiles).items():
                outs[o][c] = v
        return {o: ShardedArray(mesh, out_spec, out_shape, shards)
                for o, shards in outs.items()}

    def fn(inputs):
        placed = {n: _as_sharded(plan, n, inputs[n])
                  for n in program.inputs}
        return compute(exchange(placed))

    fn.exchange, fn.compute, fn.plan = exchange, compute, splan
    fn.last_config = dict(cfg)
    return fn, plan


compile_sharded_chain.last_config = {}


def _shard_kernel(splan, plan: DomainDecomposition, on_cuda: bool):
    """``kern(origin_i, tiles, origin_j, origin_k, inst, out=None)``: K4
    in shard mode for ``splan``, built now for CUDA shards with each
    shard's slice of the pool placed on its device (no launch copies
    from the host, a copy a CUDA graph capture refuses)."""
    from ..backend.stream import (_pool_tensors, build_stream,
                                  run_local_stream)
    lib = build_stream(splan) if on_cuda else None
    if lib is not None:
        for c in plan.mesh.local_coords():
            _pool_tensors(splan, plan.mesh.device(c), plan.instance(c))

    def kern(origin_i, tiles, origin_j, origin_k, inst, out=None):
        return run_local_stream(splan, origin_i, tiles, lib, origin_j,
                                origin_k, inst, out)
    return kern


def _compile_overlap(program, plan: DomainDecomposition, graph, splan,
                     cfg, on_cuda: bool):
    """``compile_sharded_chain``'s function under ``comm_overlap``: per
    call, every shard's interior is issued on the compute stream, then
    the exchange (on a side stream of each device on CUDA shards, which
    first waits for the compute stream's pending work: the inputs), then
    the compute stream waits for the exchange and every shard's strips
    run.  The widened blocks are recorded on the compute stream, so the
    caching allocator keeps them until the strips have read them."""
    mesh = plan.mesh
    if splan is not None:
        kern_i = _shard_kernel(splan[0], plan, on_cuda)
        kern_s = _shard_kernel(splan[1], plan, on_cuda)

        def interior(c, raw):
            return _stream_overlap_interior(plan, kern_i, c, raw)

        def strips(c, tiles, outs):
            return _stream_overlap_strips(plan, kern_s, c, tiles, outs)
    else:
        def interior(c, raw):
            return _local_forward_overlap(plan, graph, c, raw)

        def strips(c, tiles, outs):
            return _overlap_strips(plan, graph, c, tiles, outs)
    side = {}
    local = mesh.local_coords()
    if on_cuda:   # a side stream per device, keyed as tensors name it
        for c in local:
            d = mesh.device(c)
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            side.setdefault(d, torch.cuda.Stream(d))
    out_spec = plan.spec_for_output()
    out_shape = tuple(program.raw_dimensions)

    def exchange(placed):
        return _widen_and_origin(plan, placed)

    def fn(inputs):
        placed = {n: _as_sharded(plan, n, inputs[n])
                  for n in program.inputs}
        raw = {c: {n: v if program.inputs[n].is_scalar else v.shards[c]
                   for n, v in placed.items()} for c in local}
        for d, s in side.items():
            s.wait_stream(torch.cuda.current_stream(d))
        partial = {c: interior(c, raw[c]) for c in local}
        if side:
            with contextlib.ExitStack() as stack:
                for s in side.values():
                    stack.enter_context(torch.cuda.stream(s))
                for v in placed.values():
                    if isinstance(v, ShardedArray):
                        for t in v.shards.values():
                            t.record_stream(side[t.device])
                per = exchange(placed)
            for d, s in side.items():
                torch.cuda.current_stream(d).wait_stream(s)
            for tiles in per.values():
                for t in tiles.values():
                    if torch.is_tensor(t) and t.device.type == "cuda":
                        t.record_stream(torch.cuda.current_stream(t.device))
        else:
            per = exchange(placed)
        outs: Dict[str, Dict[Any, torch.Tensor]] = {
            o: {} for o in program.outputs}
        for c in local:
            for o, v in strips(c, per[c], partial[c]).items():
                outs[o][c] = v
        return {o: ShardedArray(mesh, out_spec, out_shape, shards)
                for o, shards in outs.items()}

    fn.exchange, fn.plan = exchange, splan
    fn.last_config = dict(cfg)
    return fn, plan


def place_global_inputs(program: ir.Program,
                        plan: DomainDecomposition,
                        inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Commit every input as a mesh-sharded array: each mesh position
    receives its block of the (full, replicated) host input on its
    device; scalars stay host values."""
    return {n: _as_sharded(plan, n, v) for n, v in inputs.items()
            if n in program.inputs}


def run_sharded_chain(program: ir.Program, mesh: Mesh,
                      dim_axes: Sequence[Optional[str]],
                      inputs: Dict[str, Any],
                      as_numpy: bool = True,
                      comm_overlap: bool = False,
                      **compile_kw) -> Dict[str, Any]:
    """One-shot sharded evaluation.  ``as_numpy=False`` returns the
    ShardedArrays (``.gather()`` assembles one)."""
    fn, plan = compile_sharded_chain(program, mesh, dim_axes,
                                     comm_overlap=comm_overlap,
                                     **compile_kw)
    out = fn(place_global_inputs(program, plan, inputs))
    if not as_numpy:
        return out
    return {k: v.numpy() for k, v in out.items()}

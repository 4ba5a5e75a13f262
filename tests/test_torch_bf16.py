"""The reduced-precision kernel paths of the port on the CPU.

Two opt-in modes of the JAX package, ported into the kernels that have
them:

* ``ring_storage="bfloat16"``: the f32 rings of the panel kernel (K1),
  the group kernel (K5) and the stream kernel's whole-plane bodies (K3a
  on chip, K3c on the spill rung) round to bf16 where they are stored
  and read back as f32; outputs are written unrounded;
* ``mxu_precision="bf16"``: the stream kernel's band transforms (K3b) as
  single-pass bf16 passes, matrix and operand plane rounded to bf16,
  products summed in f32.

Both reach K4, the stream kernel over one i-chunk (chunk mode: the
out-of-core path and each pipeline segment) and over one shard of a mesh
(shard mode): bf16 passes in every mode, bf16 rings in shard mode (the
JAX package's driver never passes ``ring_storage`` to its chunks).  A
shard plan with an i-halo (i sharded) emits its outputs through the
rounded rings, as the JAX package's kernel does there.

(a) The port's plain versions against the JAX package's kernels
(interpret mode, as its own tests run them) within ``ORDER_RTOL`` (an
f32 sum order; one rounding more or less moves a cell by up to 2^-9 of
its value), against the numpy oracle within ``BF16_VERIFY_RTOL`` (2e-2
relative to the output's largest magnitude, the JAX package's envelope
for these modes), and unequal to the f32 route; at 32 stages the two
drift from f32 alike.  (b) The generated CUDA sources built with g++ (one thread a
block, ``sf_host_launch``; K4's chunk by chunk and shard by shard)
against the plain versions bit for bit: the same roundings at the same
points and f32 math (-fmad=false on the card), except where band groups
are summed (``MXU_VERIFY_RTOL``).  (c) The
plans' bytes: a rounded stage ring takes 2 bytes a cell, a ring input
loaded by ``cp.async`` keeps f32 slots (rounded in place, or at read in
K5), and a shared-memory budget that spills a ring at f32 fits unspilled
at bf16.  (d) The single-pass band passes, both routes, and the
tensor-core pass's host version alone, and the bound's price of them.
(e) K4's entry points under bf16 passes, and the refusals: the dense
tile body's of a reduced precision (the JAX package runs f32 there), and
ring storage on chunks and on make_step's chunk and mesh steps (the JAX
package drops it there).
"""
import ctypes
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import compile_chain_rows as ref_rows
from stencilflow_tpu.backend.group import compile_chain_group as ref_group
from stencilflow_tpu.backend.panel import compile_chain_panel as ref_panel
from stencilflow_tpu.backend.stream import compile_chain_stream as ref_stream
from stencilflow_tpu.outofcore import (compile_chunked_chain as
                                       ref_chunked, run_chunked as
                                       ref_run_chunked)
from stencilflow_tpu.parallel import domain as ref_domain
from stencilflow_tpu.parallel import pipeline as ref_pipeline
from stencilflow_tpu_torch.backend import (codegen, compile_chain_rows, group,
                                           panel, stream)
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL, MXU_VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.outofcore import compile_chunked_chain, run_chunked
from stencilflow_tpu_torch.parallel.domain import compile_sharded_chain
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.parallel.pipeline import compile_pipeline_split
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_torch_stream import _gxx, run_host, run_source

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_spill import _reconvergent_chain  # noqa: E402

BF = "bfloat16"
# the port's plain versions against the JAX package's kernels, relative
# to the output's largest magnitude: the same roundings at the same
# points, f32 sums in another order (7e-8 on the reconvergent chain, 6e-8
# on the box chain's bf16 passes; the other cases bit for bit)
ORDER_RTOL = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _pair(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                  name=name)


def _ref_out(fn, inputs):
    out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_out(fn, inputs):
    return {k: v if isinstance(v, np.ndarray) else v.numpy()
            for k, v in fn(inputs).items()}


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh as JaxMesh
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_placed(fn, program, specs, mesh):
    """The JAX package's mesh function on inputs placed by ``specs``
    (shardings, or partition specs over ``mesh``)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    def run(inputs):
        placed = {}
        for n, v in inputs.items():
            spec = program.inputs[n]
            arr = jnp.asarray(v)
            if not spec.is_scalar:
                arr = arr.reshape(tuple(program.dimensions[d]
                                        for d in range(3)
                                        if spec.dim_mask[d]))
            sh = specs[n]
            if not isinstance(sh, NamedSharding):
                sh = NamedSharding(mesh, PartitionSpec(*sh))
            placed[n] = jax.device_put(arr, sh)
        return fn(placed)
    return run


def _mode(rs):
    """The reduced-precision case's option: ``rs`` is BF (the mode on) or
    "off" (f32 rings, split passes)."""
    return {"mxu_precision": "bf16" if rs == BF else "split"}


JK = ((2, 2), ("x", "y"), (None, "x", "y"))
IJK = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))


def _box(dims, stages=2, **kw):
    return synthesize_stencil(num_stages=stages, dimensions=dims,
                              shape="box", extent=2,
                              seed_data="random:0,1", **kw)


def _ref_sharded(mesh_args, **kw):
    shape, names, axes = mesh_args

    def build(p):
        mesh = _jax_mesh(shape, names)
        fn, plan = ref_domain.compile_sharded_chain(
            p, mesh, axes, local_backend="stream", interpret=True, **kw)
        return _jax_placed(fn, p, plan.input_shardings(), mesh)
    return build


def _port_sharded(mesh_args, **kw):
    shape, names, axes = mesh_args
    return lambda p: compile_sharded_chain(
        p, make_mesh(["cpu"], shape, names), axes, local_backend="stream",
        **kw)[0]


def _ref_segments(p, rs):
    mesh = _jax_mesh((2,), ("p",))
    fn, _plan = ref_pipeline.compile_pipeline_split(
        p, mesh, "p", local_backend="stream", interpret=True, **_mode(rs))
    specs = ref_pipeline.compile_pipeline_split.last_config["in_specs"]
    return _jax_placed(fn, p, specs, mesh)


def _ref_chunks(p, rs, chunks=2):
    compiled = ref_chunked(p, chunks, backend="stream", interpret=True,
                           **_mode(rs))
    return lambda inputs: ref_run_chunked(p, inputs, chunks,
                                          compiled=compiled)


def _port_chunks(p, rs, chunks=2):
    compiled = compile_chunked_chain(p, chunks, backend="stream",
                                     device="cpu", **_mode(rs))

    def fn(inputs):
        return run_chunked(p, inputs, chunks, compiled=compiled)
    fn.plan = compiled[0].plan
    return fn


# -- (a) the port against the JAX package and the oracle -----------------------

def _jacobi3d(size, iters):
    return jacobi(3, size, iterations=iters)


CASES = {
    # name: (spec, seed, JAX package's compile, the port's compile)
    "K1 jacobi3d 16^3 x 4": (
        lambda: _jacobi3d(16, 4), 61,
        lambda p, rs: ref_panel(
            p, interpret=True, ring_storage=rs),
        lambda p, rs: panel.compile_chain_panel(p, device="cpu",
                                                ring_storage=rs)),
    "K5 jacobi3d 16^3 x 4": (
        lambda: _jacobi3d(16, 4), 77,
        lambda p, rs: ref_group(
            p, panel=2, group=2, interpret=True, ring_storage=rs),
        lambda p, rs: group.compile_chain_group(p, panel=2, group=2,
                                                device="cpu",
                                                ring_storage=rs)),
    "K5 rows jacobi2d 64^2 x 4": (
        lambda: synthesize_stencil(num_stages=4, dimensions=(64, 64),
                                   shape="diffusion",
                                   seed_data="random:0,1"), 78,
        lambda p, rs: ref_rows(
            p, interpret=True, backend="group", panel=8, group=2,
            ring_storage=rs)[0],
        lambda p, rs: compile_chain_rows(p, "group", group=2, panel=8,
                                         device="cpu", ring_storage=rs)[0]),
    "K3a jacobi3d 12^3 x 4": (
        lambda: _jacobi3d(12, 4), 61,
        lambda p, rs: ref_stream(
            p, interpret=True, mxu="off", ring_storage=rs),
        lambda p, rs: stream.compile_chain_stream(p, mxu="off", device="cpu",
                                                  ring_storage=rs)),
    "K3c reconvergent spilled": (
        _reconvergent_chain, 31,
        lambda p, rs: ref_stream(
            p, interpret=True, vmem_budget=125 * 1024, ring_storage=rs),
        lambda p, rs: stream.compile_chain_stream(p, device="cpu",
                                                  smem_budget=64 * 1024,
                                                  ring_storage=rs)),
    # K4: the chunk mode (2 chunks), the shard mode (a 2 x 2 mesh of
    # (j, k) shards, and 2 x 2 x 2 with i sharded too) and the segment
    # mode (2 pipeline positions)
    "K4 chunk box 16x12x16 x 2 bf16 passes": (
        lambda: _box((16, 12, 16)), 41, _ref_chunks, _port_chunks),
    "K4 shard jacobi3d 12x16x16 x 3 bf16 rings": (
        lambda: synthesize_stencil(num_stages=3, dimensions=(12, 16, 16),
                                   shape="diffusion", boundary_value=0.5,
                                   seed_data="random:0,1"), 43,
        lambda p, rs: _ref_sharded(JK, ring_storage=rs)(p),
        lambda p, rs: _port_sharded(JK, ring_storage=rs)(p)),
    "K4 shard jacobi3d 16^3 x 2 ijk bf16 rings": (
        lambda: synthesize_stencil(num_stages=2, dimensions=(16, 16, 16),
                                   shape="diffusion", boundary="copy",
                                   seed_data="random:0,1"), 44,
        lambda p, rs: _ref_sharded(IJK, ring_storage=rs)(p),
        lambda p, rs: _port_sharded(IJK, ring_storage=rs)(p)),
    "K4 shard box 8x24x24 x 2 bf16 passes": (
        lambda: _box((8, 24, 24)), 45,
        lambda p, rs: _ref_sharded(JK, **_mode(rs))(p),
        lambda p, rs: _port_sharded(JK, **_mode(rs))(p)),
    "K4 segment box 8x16x24 x 2 bf16 passes": (
        lambda: _box((8, 16, 24), boundary="constant", boundary_value=0.3),
        46, _ref_segments,
        lambda p, rs: compile_pipeline_split(
            p, make_mesh(["cpu"], (2,), ("p",)), "p",
            local_backend="stream", **_mode(rs))[0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_package_and_oracle(name):
    make, seed, ref_compile, port_compile = CASES[name]
    rp, pp = _pair(make(), name.split()[0].lower())
    inputs = port.load_input_arrays(pp, seed=seed)
    oracle = port.run_interpreter(pp, inputs)
    fn = port_compile(pp, BF)
    got = _port_out(fn, inputs)
    f32 = _port_out(port_compile(pp, "off"), inputs)
    want = _ref_out(ref_compile(rp, BF), inputs)
    if name.startswith("K3c"):   # the spill rung, a ring spilled
        assert fn.plan.packed and fn.plan.spilled
    passes = name.endswith("passes")
    if name.startswith("K4"):   # K4 ran, in the mode asked for
        plans = getattr(fn, "stream_plans", None) or [fn.plan]
        assert all(sp.block for sp in plans)
        assert all(bool(sp.shard[0]) == (" shard " in name) for sp in plans)
        assert all(stream.reduced(sp) for sp in plans)
        assert all(bool(sp.tkeys) == passes for sp in plans)
        # i sharded: the outputs leave through their rounded rings
        assert all(bool(sp.rounds_out) == (" ijk " in name) for sp in plans)
    for o in pp.outputs:
        assert got[o].dtype == np.float32
        assert _rel(got[o], want[o]) < ORDER_RTOL
        assert 0 < _rel(got[o], oracle[o]) < BF16_VERIFY_RTOL
        assert _rel(got[o], f32[o]) > 0
        if passes:   # split band passes re-associate f32 sums
            assert _rel(f32[o], oracle[o]) < MXU_VERIFY_RTOL
        else:
            np.testing.assert_array_equal(f32[o].reshape(oracle[o].shape),
                                          oracle[o])


def test_deep_chain_drifts_as_the_jax_package_does():
    """bf16 rings over 32 stages (the spec of chip_smoke.py's jacobi3d
    512^3 x 32 leg on a 24^3 grid): the port's plain version equals the
    JAX package's kernel, so its drift from f32, which grows with the
    grid past BF16_VERIFY_RTOL at 512^3, is the mode's own."""
    spec = synthesize_stencil(num_stages=32, dimensions=(24, 24, 24),
                              shape="diffusion", seed_data="random:0.0,1.0")
    rp, pp = _pair(spec, "deep")
    inputs = port.load_input_arrays(pp, seed=0)
    o = pp.outputs[0]
    got = _port_out(stream.compile_chain_stream(
        pp, mxu="off", device="cpu", ring_storage=BF), inputs)[o]
    f32 = _port_out(stream.compile_chain_stream(pp, mxu="off", device="cpu"),
                    inputs)[o]
    want = _ref_out(ref_stream(rp, interpret=True, mxu="off",
                               ring_storage=BF), inputs)[o]
    assert _rel(got, want) < ORDER_RTOL
    drift = _rel(got, f32)
    print(f"32 stages on 24^3: the port {drift:.4g} from f32, the JAX "
          f"package {_rel(want, f32):.4g}")
    assert drift > 0 and abs(_rel(want, f32) - drift) < ORDER_RTOL


# -- (b) the generated sources through g++ -------------------------------------

def _k1(p, tile):
    an = port.ChainAnalysis.run(p)
    plan = panel.PanelPlan.build(an, tile, ring_storage=BF)
    return (codegen.panel_source(p, an, plan),
            lambda arrays: panel.panel_plain(p, an, plan, arrays))


def _k5(p, B, g):
    an = port.ChainAnalysis.run(p)
    plan = group.plan_group(p, an, B, g, ring_storage=BF)
    return (codegen.group_source(p, an, plan),
            lambda arrays: group.group_plain(p, an, plan, arrays))


TWINS = {
    "K1 jacobi3d": (lambda: _jacobi3d(16, 4), lambda p: _k1(p, None)),
    "K1 jacobi3d (4, 8)": (lambda: _jacobi3d(16, 4), lambda p: _k1(p, (4, 8))),
    "K1 hdiff": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(5, 52, 60), shape="hdiff",
        seed_data="random:0,1"), lambda p: _k1(p, (4, 8))),
    "K5 jacobi3d": (lambda: _jacobi3d(16, 4), lambda p: _k5(p, 2, 2)),
    "K5 rows g4": (lambda: jacobi(2, 64, iterations=8),
                   lambda p: _k5(rotate_2d_to_rows(p), 8, 4)),
    "K5 rows g2 copy": (lambda: synthesize_stencil(
        num_stages=4, dimensions=(48, 40), shape="diffusion",
        boundary="copy", seed_data="random:0,1"),
        lambda p: _k5(rotate_2d_to_rows(p), 4, 2)),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_k1_k5_host_build_matches_plain(name, tmp_path):
    make, build = TWINS[name]
    p = port.parse_program(make())
    src, plain = build(p)
    q = rotate_2d_to_rows(p) if name.startswith("K5 rows") else p
    inputs = port.load_input_arrays(q, seed=3)
    got = run_source(src, q, inputs, [], tmp_path)
    want = plain(spanned_arrays(q, inputs))
    for o in q.outputs:
        np.testing.assert_array_equal(got[o], want[o].numpy().reshape(
            got[o].shape))
    assert "sf_f2bf(" in src and "sf_bf16* const r_" in src


STREAM_TWINS = {
    "K3a jacobi3d": (lambda: _jacobi3d(12, 4), dict(mxu="off")),
    "K3a jacobi3d (4, 8)": (lambda: _jacobi3d(12, 4),
                            dict(mxu="off", tile=(4, 8))),
    "K3c reconvergent 64K": (_reconvergent_chain,
                             dict(smem_budget=64 * 1024)),
    "K3c jacobi3d all": (lambda: _jacobi3d(12, 4), dict(spill="all")),
    "K3 box rings": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(10, 12, 16), shape="box", extent=2,
        seed_data="random:0,1"), dict()),
}


@pytest.mark.parametrize("name", sorted(STREAM_TWINS))
def test_stream_host_build_matches_plain(name, tmp_path):
    make, kw = STREAM_TWINS[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, ring_storage=BF, **kw)
    assert bool(plan.packed and plan.spilled) == name.startswith("K3c")
    inputs = port.load_input_arrays(p, seed=2)
    got = run_host(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    for o in p.outputs:
        w = want[o].numpy().reshape(got[o].shape)
        if plan.mxu_plans:   # banded groups sum in another order
            assert np.allclose(got[o], w, rtol=MXU_VERIFY_RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[o], w)


def _k4_chunks(p, chunks, **kw):
    """[(K4 plan, launch arguments, slabs, pool instance)] of a chunk
    plan over every chunk of ``p``."""
    from test_torch_outofcore import _chunk_slabs
    from stencilflow_tpu_torch.backend.dense import chain_halo
    an = port.ChainAnalysis.run(p)
    Ic, h = p.dimensions[0] // chunks, chain_halo(an)[0]
    plan = stream.plan_local(p, an, Ic, h, **kw)
    inputs = port.load_input_arrays(p, seed=8)
    return [(plan, (c * Ic - h,), _chunk_slabs(p, inputs, c * Ic - h,
                                               Ic + 2 * h), (0, 0))
            for c in range(chunks)]


def _k4_shards(p, mesh_args, **kw):
    """The same of a shard plan over every shard of a CPU mesh, the
    shards widened by the engine's own exchange."""
    from stencilflow_tpu_torch.parallel.domain import (
        DomainDecomposition, _shard_contexts, _widen_and_origin,
        place_global_inputs)
    shape, names, axes = mesh_args
    an = port.ChainAnalysis.run(p)
    plan = DomainDecomposition.plan(p, make_mesh(["cpu"], shape, names),
                                    axes, an)
    splan = stream.plan_local(p, an, plan.block[0], plan.halo[0],
                              shard=plan.block[1:], xhalo=plan.halo[1:],
                              contexts=_shard_contexts(plan), **kw)
    inputs = port.load_input_arrays(p, seed=9)
    out = []
    for c, tiles in _widen_and_origin(
            plan, place_global_inputs(p, plan, inputs)).items():
        oi, oj, ok = plan.block_origin(c)
        out.append((splan, (oi - plan.halo[0], oj, ok), tiles,
                    plan.instance(c)))
    return out


def _k4_segments(p, monkeypatch):
    """The same of every segment's plan on the tiles a 2-position
    pipeline run gives it."""
    calls = []
    plain = stream.run_local_stream

    def record(plan, origin_i, slabs, lib=None, *rest):
        calls.append((plan, (origin_i,), dict(slabs), (0, 0)))
        return plain(plan, origin_i, slabs, lib, *rest)
    monkeypatch.setattr(stream, "run_local_stream", record)
    fn, _plan = compile_pipeline_split(p, make_mesh(["cpu"], (2,), ("p",)),
                                       "p", mxu_precision="bf16")
    fn(port.load_input_arrays(p, seed=10))
    return calls


K4_TWINS = {
    # name: (program, launches of K4, banded)
    "chunk box fma": (lambda: _box((16, 12, 16)), lambda p, mp: _k4_chunks(
        p, 2, mxu_precision="bf16", passes="fma", tile=(4, 8)), True),
    "chunk box mma": (lambda: _box((16, 20, 24)), lambda p, mp: _k4_chunks(
        p, 2, mxu_precision="bf16", passes="mma"), True),
    "shard jacobi rings": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(6, 24, 32), shape="diffusion",
        boundary_value=0.5, seed_data="random:0,1"),
        lambda p, mp: _k4_shards(p, JK, ring_storage=BF, tile=(4, 8)),
        False),
    "shard jacobi rings ijk": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 24, 32), shape="diffusion",
        boundary="copy", seed_data="random:0,1"),
        lambda p, mp: _k4_shards(p, IJK, ring_storage=BF, tile=(8, 8)),
        False),
    "shard hotspot rings spilled": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(8, 24, 32), shape="hotspot",
        seed_data="random:0,1"),
        lambda p, mp: _k4_shards(p, IJK, ring_storage=BF, spill="all"),
        False),
    "shard box rings banded": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(6, 24, 32), shape="box", extent=1,
        boundary_value=0.7, seed_data="random:0,1"),
        lambda p, mp: _k4_shards(p, JK, ring_storage=BF, tile=(4, 8)),
        True),
    "shard box fma": (lambda: _box((6, 32, 48)), lambda p, mp: _k4_shards(
        p, JK, mxu_precision="bf16", passes="fma"), True),
    "shard box mma": (lambda: _box((6, 32, 48)), lambda p, mp: _k4_shards(
        p, JK, mxu_precision="bf16", passes="mma"), True),
    "shard cross": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(6, 32, 32), shape="cross", extent=2,
        seed_data="random:0,1"), lambda p, mp: _k4_shards(
        p, JK, mxu_precision="bf16", tile=(2, 8)), True),
    "segment box": (lambda: _box((8, 16, 24), boundary="constant",
                                 boundary_value=0.3), _k4_segments, True),
}


@pytest.mark.parametrize("name", sorted(K4_TWINS))
def test_k4_host_build_matches_plain(name, tmp_path, monkeypatch):
    """K4's chunk, shard and segment sources under a reduced precision,
    built with g++ and run launch by launch (``sf_host_launch`` with the
    launch's origin) on the slabs the entry points give it, against
    ``local_stream_plain``: bit for bit per cell, within MXU_VERIFY_RTOL
    where band groups are summed.  The f32 source of the same plan does
    not hold the rounding's marks."""
    from test_torch_domain_sched import _build
    from stencilflow_tpu_torch.backend.build import scalar_blob
    make, launches, banded = K4_TWINS[name]
    p = port.parse_program(make())
    calls = launches(p, monkeypatch)
    libs = {}
    for plan, origin, slabs, inst in calls:
        q = plan.program
        assert stream.reduced(plan) and bool(plan.mxu_plans) == banded
        assert bool(plan.shard[0]) == name.startswith("shard")
        assert bool(plan.rounds_out) == ("ijk" in name or "spilled" in name)
        if id(plan) not in libs:
            src = stream.stream_source(plan)
            assert "sf_bfr(" in src
            libs[id(plan)] = _build(src, tmp_path)
            libs[id(plan)].sf_host_launch.argtypes = \
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * len(origin)
        want = stream.local_stream_plain(plan, origin[0], slabs,
                                         *origin[1:], inst=inst)
        arrays = [slabs[n].numpy() for n, s in q.inputs.items()
                  if not s.is_scalar]
        arrays += [np.ascontiguousarray(a, np.float32)
                   for _k, a in plan.kernel_pool(inst)]
        outs = [np.zeros((plan.block,) + plan.core(), q.kernels[o].dtype)
                for o in q.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                               for a in arrays])
        op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
        libs[id(plan)].sf_host_launch(
            ctypes.addressof(ip), ctypes.addressof(op),
            scalar_blob(q, slabs).ctypes.data, *origin)
        # the planes of a segment's block past the domain hold junk
        g0 = origin[0] + plan.halo_i
        lo, hi = max(0, -g0), min(plan.block, q.dimensions[0] - g0)
        for o, got in zip(q.outputs, outs):
            w = want[o].numpy()[lo:hi]
            assert np.isfinite(got[lo:hi]).all()
            if banded:
                assert np.allclose(got[lo:hi], w, rtol=MXU_VERIFY_RTOL,
                                   atol=1e-6)
            else:
                np.testing.assert_array_equal(got[lo:hi], w)
    assert len(libs) >= 1 and len(calls) >= 2


def _plane_input_box(I):
    """A banded stage of a 3-D input and a (j, k) input read at a 5 x 5
    box: the plane input has no ring, so its transform is summed on the
    fly from device memory (``_StreamEmitter.otf``)."""
    terms = " + ".join(f"0.04 * c[j{dj:+d},k{dk:+d}]"
                       for dj in range(-2, 3) for dk in range(-2, 3))
    bc = {"type": "constant", "value": 0.0}
    return {"inputs": {"a": {"data": "random:0,1", "data_type": "float32"},
                       "c": {"data": "random:0,1", "data_type": "float32",
                             "input_dims": ["j", "k"]}},
            "outputs": ["s0"], "dimensions": [I, 20, 24],
            "program": {"s0": {
                "computation_string": "s0 = a[i,j,k] + " + terms.replace(
                    "+0", "").replace("-0", ""),
                "boundary_conditions": {"a": bc, "c": bc},
                "data_type": "float32"}}}


@pytest.mark.parametrize("mode", ["whole", "chunk"])
def test_bf16_passes_of_a_plane_input(mode, tmp_path):
    """The on-the-fly transform of an input without a ring under bf16
    passes: its source builds (the bf16 macros), sums the j-pass first
    with each sum rounded, equals the plain version bit for bit (g++),
    and the plain version equals the JAX package's kernel."""
    from test_torch_domain_sched import _build
    from stencilflow_tpu_torch.backend.build import scalar_blob
    rp, p = _pair(_plane_input_box(6 if mode == "whole" else 12), "otf")
    inputs = port.load_input_arrays(p, seed=3)
    if mode == "whole":
        plan = stream.plan_stream(p, mxu_precision="bf16")
        got = run_host(plan, inputs, tmp_path)["s0"]
        want = stream.stream_plain(plan, spanned_arrays(p, inputs))["s0"]
        jax_out = _ref_out(ref_stream(rp, interpret=True,
                                      mxu_precision="bf16"), inputs)["s0"]
        plain = _port_out(stream.compile_chain_stream(
            p, mxu_precision="bf16", device="cpu"), inputs)["s0"]
    else:
        calls = _k4_chunks(p, 2, mxu_precision="bf16")
        plan = calls[0][0]
        lib = _build(stream.stream_source(plan), tmp_path)
        lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        got, want = [], []
        for _plan, (lo,), slabs, _inst in calls:
            arrays = [slabs[n].numpy() for n, sp in p.inputs.items()
                      if not sp.is_scalar]
            arrays += [np.ascontiguousarray(a, np.float32)
                       for _k, a in plan.kernel_pool()]
            out = np.zeros((plan.block,) + plan.core(), np.float32)
            ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                                   for a in arrays])
            op = (ctypes.c_void_p * 1)(out.ctypes.data)
            lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                               scalar_blob(p, slabs).ctypes.data, lo)
            got.append(out)
            want.append(stream.local_stream_plain(plan, lo, slabs)["s0"])
        got, want = np.concatenate(got), torch.cat(want)
        jax_out = ref_run_chunked(rp, inputs, 2, compiled=ref_chunked(
            rp, 2, backend="stream", interpret=True,
            mxu_precision="bf16"))["s0"]
        plain = _port_chunks(p, BF)(inputs)["s0"]
    assert plan.mxu_plans and not plan.tkeys and stream.reduced(plan)
    np.testing.assert_array_equal(got, want.numpy().reshape(got.shape))
    assert _rel(plain, jax_out) < ORDER_RTOL
    oracle = port.run_interpreter(p, inputs)["s0"]
    assert 0 < _rel(plain, oracle) < BF16_VERIFY_RTOL


# -- (c) the plans' bytes ------------------------------------------------------

def test_ring_bytes_halve():
    """Each rounded stage ring's planes take half the bytes; a ring input
    that ``cp.async`` loads keeps f32 slots (K1, K3 on chip: rounded in
    place once landed; K5: at read), while the spill rung, which loads
    its inputs itself, keeps them in bf16 too."""
    p = port.parse_program(_jacobi3d(16, 4))
    an = port.ChainAnalysis.run(p)
    k1 = panel.PanelPlan.build(an, (4, 16), ring_storage=BF)
    k1f = panel.PanelPlan.build(an, (4, 16))
    for f in k1.ring:
        assert k1.plane_bytes(f, p) * (1 if f in p.inputs else 2) == \
            k1f.plane_bytes(f, p)
    assert k1.smem_bytes(p) < k1f.smem_bytes(p)
    k5 = group.plan_group(p, an, 2, 2, tile=(8, 8), ring_storage=BF)
    k5f = group.plan_group(p, an, 2, 2, tile=(8, 8))
    assert k5.rounds == set(k5.rings) and k5.narrow_slots("s1")
    assert not k5.narrow_slots("a") and k5.smem_bytes(p) < k5f.smem_bytes(p)
    for packed in (False, True):
        kw = dict(spill="all", tile=(2, 8)) if packed else dict(
            mxu="off", tile=(4, 8))
        k3 = stream.plan_stream(p, ring_storage=BF, **kw)
        k3f = stream.plan_stream(p, **kw)
        assert k3.packed == packed and k3.tile == k3f.tile
        for f in k3.raw_ring:
            size = 2 if packed or f not in p.inputs else 4
            cells = math.prod(k3.region(f))
            assert k3.plane_bytes(f) == -(-cells * size // 16) * 16
            assert k3.ring_bytes(f) == -(-k3.slots(f) * cells * size
                                         // 16) * 16
            assert k3f.plane_bytes(f) == cells * 4
        if packed:   # about half the spill buffer and its traffic
            assert k3.spill_bytes() < k3f.spill_bytes()
            assert k3.spill_traffic() < k3f.spill_traffic()


def test_budget_that_spills_at_f32_fits_at_bf16():
    """As tests/test_spill.py shows on the TPU: a shared-memory budget
    that spills the reconvergent chain's s0 at f32 keeps every ring on
    chip at bf16, and a budget half as large spills s0 at bf16."""
    p = port.parse_program(_reconvergent_chain())
    f32 = stream.plan_stream(p, smem_budget=128 * 1024)
    bf = stream.plan_stream(p, smem_budget=128 * 1024, ring_storage=BF)
    assert f32.last_config()["spilled"] == ["s0"]
    assert bf.last_config()["spilled"] == []
    small = stream.plan_stream(p, smem_budget=64 * 1024, ring_storage=BF)
    assert small.last_config()["spilled"] == ["s0"]


# -- (d) single-pass bf16 band transforms (K3b) --------------------------------

def _box_chain():
    return synthesize_stencil(num_stages=2, dimensions=(10, 12, 16),
                              shape="box", extent=2, boundary="constant",
                              boundary_value=0.3)


def test_box_chain_bf16_single_pass():
    """The JAX package's test_box_chain_bf16_single_pass, on the port."""
    rp, pp = _pair(_box_chain(), "boxbf16")
    inputs = port.load_input_arrays(pp, seed=3)
    oracle = port.run_interpreter(pp, inputs)["s1"]
    fn = stream.compile_chain_stream(pp, mxu_precision="bf16", device="cpu")
    assert fn.plan.mxu_plans
    got = _port_out(fn, inputs)["s1"]
    split = _port_out(stream.compile_chain_stream(pp, device="cpu"),
                      inputs)["s1"]
    want = _ref_out(ref_stream(
        rp, interpret=True, mxu_precision="bf16"), inputs)["s1"]
    assert _rel(got, oracle) < BF16_VERIFY_RTOL
    # the JAX package's (L @ P) @ R rounds its intermediate where the
    # port's passes do; the split route lies a thousand times farther
    assert _rel(got, want) < ORDER_RTOL
    assert _rel(got, split) > 1000 * ORDER_RTOL


@pytest.mark.parametrize("passes", ["mma", "fma"])
@pytest.mark.parametrize("name", ["box composed", "box two stages"])
def test_bf16_passes_host_build_matches_plain(name, passes, tmp_path):
    """The g++ build of a chain's single-pass bf16 passes (the j-pass
    into a scratch widened along k, then the k-pass) against the plain
    version: the composed box meets its band's table edges."""
    spec = (synthesize_stencil(num_stages=4, dimensions=(20, 40, 48),
                               shape="box", extent=2,
                               seed_data="random:0,1")
            if name == "box composed" else _box_chain())
    p = port.parse_program(spec)
    plan = stream.plan_stream(p, mxu_precision="bf16", passes=passes)
    assert plan.tkeys and not any(plan.fused(t) for t in plan.tkeys)
    two = [t for t in plan.tkeys if len(plan.pass_order(t)) == 2]
    assert two and all(plan.pass_order(t) == ("L", "R") for t in two)
    if name == "box composed":
        assert plan.composed and any(
            not plan.band_info(t[1], "L").toeplitz for t in two)
    inputs = port.load_input_arrays(p, seed=6)
    got = run_host(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    for o in p.outputs:
        w = want[o].numpy().reshape(got[o].shape)
        assert np.allclose(got[o], w, rtol=MXU_VERIFY_RTOL, atol=1e-6)


def test_bf16_passes_agree_takes_a_tie_cone_and_refuses_split(tmp_path):
    """``stream.bf16_passes_agree``, which holds the card's bf16 passes to
    their plain version: on cross-r2 the g++ build's stage sums (fmaf)
    round a bf16 tie the other way, and a cone of cells differs by bf16
    ulps; it agrees.  The split route's output, and the plain version
    with 2 % of its cells moved by 1e-3, do not."""
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(8, 48, 72), shape="cross", extent=2,
        seed_data="random:0,1"))
    plan = stream.plan_stream(p, mxu_precision="bf16", passes="fma",
                              tile=(4, 8))
    inputs = port.load_input_arrays(p, seed=4)
    got = run_host(plan, inputs, tmp_path)
    arrays = spanned_arrays(p, inputs)
    o = p.outputs[0]
    want = stream.stream_plain(plan, arrays)[o].numpy()
    split = stream.stream_plain(stream.plan_stream(p), arrays)[o].numpy()
    ok, fig = stream.bf16_passes_agree(want, got[o], split)
    assert ok and 0 < fig["max_abs_err"] and fig["share"] < 1, fig
    assert not stream.bf16_passes_agree(want, split, split)[0]
    moved = want.copy().reshape(-1)
    moved[::50] += np.float32(1e-3)
    assert not stream.bf16_passes_agree(want, moved, split)[0]


def test_report_bound_prices_bf16_passes():
    """``Report.roofline_time_s``/``bound`` under ``mxu_precision="bf16"``
    take the band transforms at the bf16 tensor rate (one yardstick for
    ``cli run``, chip_smoke.py and the bench)."""
    from stencilflow_tpu_torch.report import Report
    rep = Report.build(port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(64, 64, 64), shape="box", extent=2,
        seed_data="random:0,1")))
    m = rep.mxu_model()
    compute = min(rep.alu_time_s(),
                  m["mxu_time_s_bf16"] + m["vpu_rest_time_s"])
    assert rep.roofline_time_s("bf16") == max(rep.hbm_time_s(), compute)
    assert rep.roofline_time_s("bf16") <= rep.roofline_time_s()
    assert rep.bound("bf16") == ("hbm" if rep.hbm_time_s() >= compute
                                 else "mxu")


@pytest.mark.parametrize("passes", ["mma", "fma"])
def test_one_stage_bf16_passes_match_plain(passes, tmp_path):
    """One banded stage: the host version of the tensor-core pass
    (``sf_mma_band_bf16``) and of the CUDA-core pass against the plain
    version's tap-order sums of the same rounded operands."""
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(6, 20, 24), shape="box", extent=2,
        seed_data="random:0,1"))
    plan = stream.plan_stream(p, mxu_precision="bf16", passes=passes,
                              tile=(8, 8))
    assert plan.mxu_plans and plan.tkeys
    routes = {plan.route(k, s) for t in plan.tkeys
              for k, s in ((t[1], "L"), (t[2], "R")) if k is not None}
    assert routes == {passes}
    src = stream.stream_source(plan)
    assert ("sf_mma_band_bf16<" in src) == (passes == "mma")
    inputs = port.load_input_arrays(p, seed=5)
    got = run_host(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    split = stream.stream_plain(stream.plan_stream(p, tile=(8, 8)),
                                spanned_arrays(p, inputs))
    for o in p.outputs:
        w = want[o].numpy().reshape(got[o].shape)
        assert np.allclose(got[o], w, rtol=MXU_VERIFY_RTOL, atol=1e-6)
        assert np.max(np.abs(w - split[o].numpy().reshape(w.shape))) > 0


def test_mma_bf16_host_version(tmp_path):
    """``sf_mma_band_bf16``'s host version on one tile: the rounded
    operands' exact products summed in f32 in tap order."""
    src = codegen.mma_probe_source((1, 3), bf16=True)
    cpp, so = tmp_path / "probe.cpp", tmp_path / "probe.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_mma_probe_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 8
    rng = np.random.default_rng(12)

    def bf(a):
        return torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    for taps, ks, table in ((5, 1, False), (33, 3, False), (41, 3, True)):
        x = rng.standard_normal((16, 16 * ks)).astype(np.float32)
        w = rng.standard_normal((taps, 8) if table else (taps,)).astype(
            np.float32)
        d = np.zeros((16, 8), np.float32)
        assert lib.sf_mma_probe_host(
            x.ctypes.data, w.ctypes.data, d.ctypes.data, 16 * ks, 1, 16,
            16 * ks, 8 if table else 1, 1 if table else 0, taps, ks) == 0
        want = np.zeros((16, 8), np.float32)
        for n in range(8):
            for m in range(16 * ks):
                if 0 <= m - n < taps:
                    b = w[m - n, n] if table else w[m - n]
                    want[:, n] = want[:, n] + bf(x[:, m]) * bf(np.float32(b))
        np.testing.assert_array_equal(d, want)


# -- (e) refusals --------------------------------------------------------------

@pytest.mark.parametrize("lowering", ["panel", "group", "stream", "rows"])
def test_unknown_ring_storage_raises(lowering):
    p = port.parse_program(_jacobi3d(8, 2))
    call = {"panel": lambda: panel.compile_chain_panel(
                p, device="cpu", ring_storage="float16"),
            "group": lambda: group.compile_chain_group(
                p, device="cpu", ring_storage="float16"),
            "stream": lambda: stream.compile_chain_stream(
                p, device="cpu", ring_storage="float16"),
            "rows": lambda: compile_chain_rows(
                port.parse_program(jacobi(2, 32, iterations=2)), "group",
                device="cpu", ring_storage="float16")}[lowering]
    with pytest.raises(ValueError, match="ring_storage"):
        call()


@pytest.mark.parametrize("backend", ["overlap", "tile", "auto"])
def test_run_program_ring_storage_needs_a_ring_lowering(backend):
    p = port.parse_program(_jacobi3d(8, 2))
    with pytest.raises(ValueError, match="--ring-storage requires"):
        run_program(p, device="cpu", backend=backend, ring_storage=BF,
                    save_results=False, log_level=0)


def test_rows_ring_storage_refused_on_other_lowerings():
    p = port.parse_program(jacobi(2, 32, iterations=2))
    with pytest.raises(ValueError, match="ring_storage requires"):
        compile_chain_rows(p, "overlap", device="cpu", ring_storage=BF)


def test_run_program_ring_storage_refused_out_of_core():
    """K4's chunk mode keeps f32 rings: a bf16 request is refused there,
    not run in f32."""
    p = port.parse_program(_jacobi3d(8, 2))
    with pytest.raises(ValueError, match="chunk kernel"):
        run_program(p, device="cpu", backend="stream", ring_storage=BF,
                    host_chunks=2, save_results=False, log_level=0)


def _box2():
    return port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(16, 12, 16), shape="box", extent=2,
        seed_data="random:0,1"))


@pytest.mark.parametrize("entry", ["run_program", "chunked", "sharded",
                                   "pipeline", "plan_local"])
def test_bf16_passes_reach_k4(entry):
    """The entry points that refused single-pass bf16 passes run them in
    K4 now, its plain version on the CPU ("auto" takes the stream body on
    the CPU under bf16): every K4 plan has bf16 passes, and the outputs
    lie within BF16_VERIFY_RTOL of the oracle and away from the split
    route's."""
    p = _box2()
    inputs = port.load_input_arrays(p, seed=12)
    oracle = port.run_interpreter(p, inputs)["s1"]
    bf = dict(mxu_precision="bf16")
    if entry == "plan_local":
        plan = stream.plan_local(p, None, 8, 2, **bf)
        assert plan.mxu_precision == "bf16" and plan.tkeys
        return
    if entry == "run_program":
        res = run_program(p, device="cpu", host_chunks=2, seed=12,
                          compare_to_reference=True, save_results=False,
                          log_level=0, **bf)
        assert res.backend == "outofcore[stream x2 chunks]"
        assert res.verified_against_reference
        got = res.outputs["s1"]
    elif entry == "chunked":
        fn, plan = compile_chunked_chain(p, 2, device="cpu", **bf)
        assert plan.backend == "stream" and fn.plan.tkeys
        got = run_chunked(p, inputs, 2, compiled=(fn, plan))["s1"]
    elif entry == "sharded":
        fn, _ = compile_sharded_chain(p, make_mesh(["cpu"], *JK[:2]), JK[2],
                                      **bf)
        assert fn.last_config["backend"] == "stream" and fn.plan.tkeys
        got = fn(inputs)["s1"].numpy()
    else:
        fn, _ = compile_pipeline_split(p, make_mesh(["cpu"], (2,), ("p",)),
                                       "p", **bf)
        assert fn.last_config["backend"] == "stream"
        assert all(sp.tkeys for sp in fn.stream_plans)
        got = fn(inputs)["s1"].numpy()
    split = stream.compile_chain_stream(p, device="cpu")(inputs)["s1"]
    assert 0 < _rel(got, oracle) < BF16_VERIFY_RTOL
    assert _rel(got, split.numpy()) > 100 * ORDER_RTOL


@pytest.mark.parametrize("entry", ["chunked dense", "chunked nothing fits",
                                   "sharded xla", "sharded xla rings",
                                   "pipeline xla"])
def test_dense_body_refuses_reduced_precision(entry):
    """Where the dense tile body would run a reduced-precision request
    (asked for, or the rescue where no K4 plan fits), the port raises
    and says why: the JAX package's XLA body computes f32 there."""
    p = _box2()
    bf = dict(mxu_precision="bf16")
    mesh = make_mesh(["cpu"], *JK[:2])
    call = {"chunked dense": lambda: compile_chunked_chain(
                p, 2, backend="dense", device="cpu", **bf),
            "chunked nothing fits": lambda: compile_chunked_chain(
                p, 2, device="cpu", spill="off", smem_budget=256, **bf),
            "sharded xla": lambda: compile_sharded_chain(
                p, mesh, JK[2], local_backend="xla", **bf),
            "sharded xla rings": lambda: compile_sharded_chain(
                p, mesh, JK[2], local_backend="xla", ring_storage=BF),
            "pipeline xla": lambda: compile_pipeline_split(
                p, make_mesh(["cpu"], (2,), ("p",)), "p",
                local_backend="xla", **bf)}[entry]
    with pytest.raises(ValueError, match="needs K4.*would run f32"):
        call()


@pytest.mark.parametrize("name", ["sharded box r1 x 3", "sharded box r2",
                                  "pipeline box r1 x 8"])
def test_bf16_composition_is_the_jax_packages(name):
    """``compose="auto"`` under bf16 passes: the port composes (or keeps
    every stage) where the JAX package does, and its segments' banded
    stages are the JAX package's."""
    if name.startswith("sharded"):
        spec = (synthesize_stencil(num_stages=3, dimensions=(8, 16, 16),
                                   shape="box", extent=1)
                if "r1" in name else _box((8, 24, 24)))
        rp, pp = _pair(spec, "boxc")
        fn = _port_sharded(JK, mxu_precision="bf16")(pp)
        _ref_sharded(JK, mxu_precision="bf16")(rp)
        jcfg = ref_domain.compile_sharded_chain.last_config
        assert fn.last_config.get("composed") == jcfg.get("composed")
        assert bool(jcfg.get("composed")) == ("r1" in name)
    else:
        rp, pp = _pair(synthesize_stencil(num_stages=8,
                                          dimensions=(16, 16, 24),
                                          shape="box", extent=1), "box8")
        fn, _ = compile_pipeline_split(pp, make_mesh(["cpu"], (2,), ("p",)),
                                       "p", local_backend="stream",
                                       mxu_precision="bf16")
        ref_pipeline.compile_pipeline_split(
            rp, _jax_mesh((2,), ("p",)), "p", local_backend="stream",
            interpret=True, mxu_precision="bf16")
        jcfg = ref_pipeline.compile_pipeline_split.last_config
        assert fn.last_config["composed"] == jcfg["composed"]
        assert fn.last_config["segments"] == jcfg["segments"]
    assert fn.last_config["mxu_stages" if name.startswith("sharded")
                          else "backend"] == jcfg["mxu_stages" if
                                                  name.startswith("sharded")
                                                  else "backend"]


@pytest.mark.parametrize("backend,kw", [("stream", {}),
                                        ("panel", {}),
                                        ("stream", {"host_chunks": 2}),
                                        ("stream", {"mesh": JK})])
def test_make_step_ring_storage(backend, kw):
    """``make_step(ring_storage="bfloat16")`` takes the stream lowering,
    as the JAX package's does, and refuses every other backend, the
    chunk step and the mesh step (the JAX package's make_step drops
    ring storage on those two and runs f32 rings)."""
    from stencilflow_tpu_torch.iterate import IterateError, make_step
    if "mesh" in kw:
        kw = dict(mesh=make_mesh(["cpu"], *JK[:2]), dim_axes=JK[2])
    p = port.parse_program(_jacobi3d(12, 3))
    if backend != "stream" or kw:
        with pytest.raises(IterateError, match="ring_storage"):
            make_step(p, backend=backend, device="cpu", ring_storage=BF,
                      **kw)
        return
    step, feed = make_step(p, backend=backend, device="cpu",
                           ring_storage=BF)
    inputs = port.load_input_arrays(p, seed=5)
    state = {k: torch.as_tensor(v) for k, v in inputs.items()}
    got = step(state)
    (iname, oname), = feed.items()
    want = stream.compile_chain_stream(p, device="cpu",
                                       ring_storage=BF)(inputs)[oname]
    assert step.backend == "stream"
    np.testing.assert_array_equal(np.asarray(got[iname]).reshape(
        want.shape), want.numpy())
    assert _rel(want.numpy(), port.run_interpreter(p, inputs)[oname]) > 0

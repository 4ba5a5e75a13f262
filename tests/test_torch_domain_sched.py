"""K4's shard mode on the CPU: the generated per-shard source through g++.

``codegen.stream_source`` of a shard plan (``stream.plan_local`` with a
shard core, the exchanged halo and the origin-aware band contexts, as
``parallel/domain.py plan_local_stream`` builds it) compiles with g++ into
``sf_host_launch(in, out, scal, origin_i, origin_j, origin_k)``, which
runs every block with one thread over shared memory filled with NaN.
Each shard's widened inputs come from the engine's own halo exchange on
a CPU mesh of virtual shards; the kernel runs shard by shard at its
shard's origin, on its instance of the pool, and is held to its plain
version (``stream.local_stream_plain``) and to the numpy oracle's core:
bit for bit on per-cell programs, within MXU_VERIFY_RTOL on banded
ones.  Every case has shards whose j and k origins are not 0.
"""
import ctypes
import hashlib
import subprocess

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.compose import compose_program
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
from stencilflow_tpu_torch.parallel.domain import (
    DomainDecomposition, _shard_contexts, place_global_inputs,
    _widen_and_origin)
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_torch_stream import _gxx


def _synth(shape, dims, iters, **kw):
    return port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=dims, shape=shape,
        seed_data="random:0,1", **kw))


JK = ((2, 2), ("x", "y"), (None, "x", "y"))
IJK = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))
# name: (program, mesh, plan_local options, banded, composed)
CASES = {
    "jacobi-constant": (lambda: _synth("diffusion", (6, 24, 32), 2,
                                       boundary_value=0.5), JK,
                        dict(tile=(4, 8)), False, False),
    "jacobi-copy-ijk": (lambda: _synth("diffusion", (8, 24, 32), 2,
                                       boundary="copy"), IJK,
                        dict(tile=(8, 8)), False, False),
    "jacobi-shrink-overrun": (lambda: _synth(
        "diffusion", (6, 24, 40), 2, boundary="shrink"), JK,
        dict(tile=(8, 16)), False, False),
    "hdiff": (lambda: _synth("hdiff", (5, 32, 32), 1), JK,
              dict(tile=(4, 8)), False, False),
    "hotspot-spilled": (lambda: _synth("hotspot", (8, 24, 32), 3), IJK,
                        dict(spill="all"), False, False),
    "box-bc0.7": (lambda: _synth("box", (6, 24, 32), 2, extent=1,
                                 boundary_value=0.7), JK,
                  dict(tile=(4, 8)), True, False),
    "box-r2-mma": (lambda: _synth("box", (6, 32, 48), 2, extent=2), JK,
                   dict(passes="mma"), True, False),
    "box-composed": (lambda: _synth("box", (8, 32, 48), 3, extent=1), JK,
                     dict(tile=(4, 8)), True, True),
    "cross-r2": (lambda: _synth("cross", (6, 32, 32), 2, extent=2), JK,
                 dict(tile=(2, 8)), True, False),
}


def _build(src, tmp_path):
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    return lib


def _shard_plan(p, mesh_args, opts, composed):
    shape, names, axes = mesh_args
    mesh = make_mesh(["cpu"], shape, names)
    builds = None
    if composed:
        p, builds = compose_program(p, port.ChainAnalysis.run(p), 0)
    an = port.ChainAnalysis.run(p)
    plan = DomainDecomposition.plan(p, mesh, axes, an)
    splan = stream.plan_local(
        p, an, plan.block[0], plan.halo[0], shard=plan.block[1:],
        xhalo=plan.halo[1:], contexts=_shard_contexts(plan),
        builds=builds, **opts)
    return p, plan, splan


@pytest.mark.parametrize("name", sorted(CASES))
def test_shard_kernel_matches_plain(name, tmp_path):
    make, mesh_args, opts, banded, composed = CASES[name]
    p0 = make()
    inputs = port.load_input_arrays(p0, seed=4)
    oracle = port.run_interpreter(p0, inputs)
    p, plan, splan = _shard_plan(p0, mesh_args, opts, composed)
    assert bool(splan.mxu_plans) == banded
    assert bool(splan.composed) == composed
    if opts.get("spill") == "all":
        assert splan.packed and splan.spilled
    src = stream.stream_source(splan)
    assert "sf_shard_launch" in src and "const int origin_j" in src
    lib = _build(src, tmp_path)
    per = _widen_and_origin(plan, place_global_inputs(p, plan, inputs))
    blob = scalar_blob(p, inputs)
    nonzero = False
    for c, tiles in per.items():
        oi, oj, ok = plan.block_origin(c)
        nonzero |= oj > 0 and ok > 0
        inst = plan.instance(c)
        want = stream.local_stream_plain(splan, oi - plan.halo[0], tiles,
                                         oj, ok, inst)
        arrays = [tiles[n].numpy() for n, s in p.inputs.items()
                  if not s.is_scalar]
        arrays += [np.ascontiguousarray(a, np.float32)
                   for _k, a in splan.kernel_pool(inst)]
        outs = [np.zeros((plan.block[0],) + splan.core(),
                         p.kernels[o].dtype) for o in p.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                               for a in arrays])
        op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
        lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                           blob.ctypes.data, oi - plan.halo[0], oj, ok)
        core = tuple(slice(o, o + b) for o, b in zip((oi, oj, ok),
                                                      plan.block))
        for o, got in zip(p.outputs, outs):
            w = want[o].numpy()
            ref = np.asarray(oracle[o]).reshape(p.dimensions)[core]
            assert np.isfinite(got).all()
            if banded:
                np.testing.assert_allclose(got, w, rtol=MXU_VERIFY_RTOL,
                                           atol=1e-6)
                np.testing.assert_allclose(got, ref, rtol=MXU_VERIFY_RTOL,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got, w)
                np.testing.assert_array_equal(got, ref)
    assert nonzero


def test_shard_source_reads_the_3d_origin():
    """A shard plan's kernel takes (origin_i, origin_j, origin_k), tiles
    its shard's core from (origin_j, origin_k), reads the widened
    plane's cells at their offset from the plane's origin (wj, wk), and
    calls no library."""
    p, plan, splan = _shard_plan(CASES["box-bc0.7"][0](), JK,
                                 dict(tile=(4, 8)), False)
    src = stream.stream_source(splan)
    for word in ("cublas", "cudnn", "wmma", "#include <cub"):
        assert word not in src.lower()
    assert "const int j0 = origin_j + by * 4, k0 = origin_k + bx * 8;" in src
    xj, xk = plan.halo[1:]
    assert f"const int wj = origin_j - {xj}, wk = origin_k - {xk};" in src
    assert "(gj - wj)" in src and "gk - origin_k" in src
    assert splan.grid() == (-(-plan.block[1] // 4), -(-plan.block[2] // 8))
    # corrections differ per shard instance: stacked, one slice each
    assert any(k.startswith("corrs_") for k in splan.pool)
    pools = {inst: [a for _k, a in splan.kernel_pool(inst)]
             for inst in ((0, 0), (1, 1))}
    assert any(not np.array_equal(a, b)
               for a, b in zip(pools[0, 0], pools[1, 1]))

"""The port's domain decomposition against the JAX package's.

``stencilflow_tpu_torch.parallel.domain.compile_sharded_chain`` runs on a
CPU mesh of virtual shards (``mesh.make_mesh(["cpu"], ...)``); the JAX
package's ``compile_sharded_chain`` runs on its 8-device virtual CPU
mesh (tests/conftest.py) with the same mesh shape and dim axes.  Each
case holds the port's output to the numpy oracle bit for bit per cell
(within MXU_VERIFY_RTOL where stages are banded), and to the JAX engine
within VERIFY_RTOL (MXU_VERIFY_RTOL banded).  Local bodies: the dense
tile body ("xla", both packages' name) for most cases; the port's K4
shard mode ("stream": its plain version on CPU shards) against the JAX
interpret-mode stream body for a few.  Also: the origin-aware stacked
band matrices of ``plan_all_stages`` equal the JAX package's array for
array, and the errors are the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import linear as ref_linear
from stencilflow_tpu.parallel import domain as ref_domain
from stencilflow_tpu_torch.backend import linear
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
from stencilflow_tpu_torch.parallel import (
    DomainDecomposition, Mesh, ShardedArray, compile_sharded_chain,
    run_sharded_chain)
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.synthesize import synthesize_stencil

JK = ((2, 2), ("x", "y"), (None, "x", "y"))
I4 = ((4,), ("x",), ("x", None, None))
IJ = ((2, 2), ("x", "y"), ("x", "y", None))
IJK = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))


def _synth(shape, dims=(16, 8, 16), iters=2, **kw):
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0,1", **kw)


def _lower_rank():
    """Scalar, k-only and (i, j) inputs beside a 3-D field."""
    return {
        "inputs": {
            "a": {"data": "random:-1,1", "data_type": "float32"},
            "row": {"data": "random:0,1", "data_type": "float32",
                    "input_dims": ["k"]},
            "cij": {"data": "random:0,1", "data_type": "float32",
                    "input_dims": ["i", "j"]},
            "c": {"data": "constant:1.5", "data_type": "float32",
                  "input_dims": []}},
        "outputs": ["res"], "dimensions": [16, 8, 16],
        "program": {
            "u": {"computation_string":
                  "u = a[i,j,k] * c + row[k] + cij[i,j]",
                  "boundary_conditions": {
                      "a": {"type": "constant", "value": 0.0},
                      "row": {"type": "constant", "value": 0.0},
                      "cij": {"type": "constant", "value": 0.0}},
                  "data_type": "float32"},
            "res": {"computation_string":
                    "res = 0.5 * (u[i-1,j,k] + u[i+1,j,k]) + u[i,j+1,k-1]",
                    "boundary_conditions": {
                        "u": {"type": "constant", "value": 1.0}},
                    "data_type": "float32"}}}


def _const_ireach():
    """A constant stage read at backward i-offsets (its reach is on no
    input path; tests/test_comm_overlap.py, overlap off)."""
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s1"], "dimensions": [16, 8, 16],
        "program": {
            "s0": {"computation_string": "s0 = -0.748",
                   "boundary_conditions": {}, "data_type": "float32"},
            "s1": {"computation_string":
                   "s1 = s0[i+2,j,k] + s0[i-2,j,k] + a[i,j,k]",
                   "boundary_conditions":
                   {"s0": {"type": "constant", "value": 0.5},
                    "a": {"type": "constant", "value": 0.0}},
                   "data_type": "float32"}}}


# name: (spec, mesh, port local backend, banded)
CASES = {
    "jacobi-constant-jk": (lambda: _synth("diffusion", boundary_value=0.5),
                           JK, "xla", False),
    "jacobi-copy-i": (lambda: _synth("diffusion", boundary="copy"), I4,
                      "xla", False),
    "jacobi-shrink-ij": (lambda: _synth("diffusion", boundary="shrink"),
                         IJ, "xla", False),
    "jacobi-constant-ijk": (lambda: _synth("diffusion", boundary_value=0.5),
                            IJK, "xla", False),
    "hdiff-jk": (lambda: _synth("hdiff", (8, 16, 16), 1), JK, "xla", False),
    "lower-rank-ijk": (_lower_rank, IJK, "xla", False),
    "const-ireach-i": (_const_ireach, ((2,), ("x",), ("x", None, None)),
                       "xla", False),
    "jacobi-copy-stream-jk": (lambda: _synth("diffusion", boundary="copy"),
                              JK, "stream", False),
    "jacobi-shrink-stream-ijk": (lambda: _synth(
        "diffusion", boundary="shrink"), IJK, "stream", False),
    "const-ireach-stream-i": (_const_ireach,
                              ((2,), ("x",), ("x", None, None)), "stream",
                              False),
    "box-banded-stream-jk": (lambda: _synth("box", (8, 16, 16), 2, extent=1,
                                            boundary_value=0.7), JK,
                             "stream", True),
    "box-composed-stream-jk": (lambda: _synth("box", (8, 16, 16), 3,
                                              extent=1), JK, "stream", True),
}


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _close(got, want, rtol):
    return np.allclose(got, want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_oracle_and_jax(name):
    make, (shape, names, axes), lb, banded = CASES[name]
    spec = make()
    a, b = ref.parse_program(spec), port.parse_program(spec)
    inputs = port.load_input_arrays(b, seed=7)
    oracle = port.run_interpreter(b, inputs)

    fn, plan = compile_sharded_chain(b, make_mesh(["cpu"], shape, names),
                                     axes, local_backend=lb)
    cfg = fn.last_config
    assert cfg["backend"] == ("stream" if lb == "stream" else "xla")
    assert bool(cfg["mxu_stages"]) == banded
    out = {k: v.numpy() for k, v in fn(inputs).items()}

    jfn, jplan = ref_domain.compile_sharded_chain(
        a, _jax_mesh(shape, names), axes, local_backend=lb, interpret=True)
    sh = jplan.input_shardings()
    jin = {n: jax.device_put(jnp.asarray(v), sh[n])
           for n, v in inputs.items()}
    jout = {k: np.asarray(v) for k, v in jfn(jin).items()}
    assert plan.halo == jplan.halo and plan.block == jplan.block

    rtol = MXU_VERIFY_RTOL if banded else VERIFY_RTOL
    for o in b.outputs:
        want = np.asarray(oracle[o])
        assert out[o].shape == want.shape and np.isfinite(out[o]).all()
        if banded:
            assert _close(out[o], want, MXU_VERIFY_RTOL)
        else:
            np.testing.assert_array_equal(out[o], want)
        assert _close(out[o], jout[o], rtol)


def test_composed_reports_its_segments():
    """The composed retry on the sharded path, with the reference's
    last_config keys."""
    b = port.parse_program(_synth("box", (8, 16, 16), 3, extent=1))
    fn, _plan = compile_sharded_chain(b, make_mesh(["cpu"], *JK[:2]),
                                      JK[2], local_backend="stream")
    assert fn.last_config["composed"] == {"s2": ["s0", "s1", "s2"]}
    assert compile_sharded_chain.last_config["composed"] == \
        fn.last_config["composed"]
    # the composed chain's halo is 3: widened planes start 3 before a core
    assert fn.plan.contexts == ([-3, 5], [-3, 5])


@pytest.mark.parametrize("spec,plane,jctx,kctx", [
    (lambda: _synth("box", (4, 12, 16), 1, extent=2, boundary_value=0.7),
     (10, 12), [-2, 4], [-2, 6]),
    (lambda: _synth("box", (4, 12, 16), 1, extent=1), (8, 16), [-1, 5],
     None),
    (lambda: _synth("cross", (4, 12, 16), 1, extent=2), (12, 12), None,
     [-2, 6]),
])
def test_stacked_plans_equal_jax(spec, plane, jctx, kctx):
    """plan_all_stages with j/k contexts (two shards a sharded dim, the
    widened shard plane): the same groups, and every pool entry (stacked
    or collapsed) equal to the JAX package's."""
    s = spec()
    a, b = ref.parse_program(s), port.parse_program(s)
    rpool, ppool = ref_linear.MatrixPool(), linear.MatrixPool()
    rp = ref_linear.plan_all_stages(a, plane, a.dimensions, rpool, 12,
                                    jctx, kctx)
    pp = linear.plan_all_stages(b, plane, b.dimensions, ppool, 12, jctx,
                                kctx)
    assert rp.keys() == pp.keys() and pp
    for k in rp:
        for rg, pg in zip(rp[k].groups, pp[k].groups):
            assert (rg.field, rg.oi, rg.weight_sum, rg.bc_value) == \
                (pg.field, pg.oi, pg.weight_sum, pg.bc_value)
            assert rg.correction_key == pg.correction_key
            for rt, pt in zip(rg.terms, pg.terms):
                assert (rt.left_key, rt.right_key) == \
                    (pt.left_key, pt.right_key)
                assert rt.scale == pt.scale
    assert rpool.items.keys() == ppool.items.keys()
    stacked = [k for k in ppool.items if linear.is_stacked_key(k)]
    assert stacked
    for k in ppool.items:
        np.testing.assert_array_equal(ppool.items[k], rpool.items[k])
        assert linear.is_stacked_key(k) == ref_linear.is_stacked_key(k)


def test_plan_errors_match_the_reference():
    b = port.parse_program(_synth("diffusion", (16, 8, 16), 3))
    mesh = make_mesh(["cpu"], (3,), ("x",))
    with pytest.raises(ValueError, match=r"dim 0 \(16\) not divisible by "
                                         r"mesh axis 'x' size 3"):
        DomainDecomposition.plan(b, mesh, ("x", None, None))
    mesh8 = make_mesh(["cpu"], (8,), ("x",))
    with pytest.raises(ValueError, match=r"halo 3 >= local block 2 in "
                                         r"dim 0; use fewer shards"):
        DomainDecomposition.plan(b, mesh8, ("x", None, None))
    with pytest.raises(ValueError, match="dim_axes is required"):
        DomainDecomposition.plan(b, mesh, None)
    # the overlap's refusals, as the reference words them: the stream
    # body takes i-only sharding with an interior (B0 > 2h)
    with pytest.raises(ValueError, match="i-only"):
        compile_sharded_chain(b, make_mesh(["cpu"], (2,), ("x",)),
                              (None, "x", None), local_backend="stream",
                              comm_overlap=True)
    thin = port.parse_program(_synth("diffusion", (8, 8, 16), 2))
    with pytest.raises(ValueError, match="interior"):
        compile_sharded_chain(thin, make_mesh(["cpu"], (2,), ("x",)),
                              ("x", None, None), local_backend="stream",
                              comm_overlap=True)


def test_run_sharded_chain_and_arrays():
    """run_sharded_chain returns host arrays or ShardedArrays whose shards
    sit on their mesh positions' devices with the plan's specs; a
    mesh built from a nested device list equals make_mesh's."""
    b = port.parse_program(_lower_rank())
    inputs = port.load_input_arrays(b, seed=3)
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("x", "y"))
    assert mesh.shape == {"x": 2, "y": 2} and mesh.size == 4
    assert mesh.one_device() == torch.device("cpu")
    got = run_sharded_chain(b, mesh, (None, "x", "y"), inputs)
    oracle = port.run_interpreter(b, inputs)
    np.testing.assert_array_equal(got["res"], np.asarray(oracle["res"]))
    arrs = run_sharded_chain(b, mesh, (None, "x", "y"), inputs,
                             as_numpy=False)
    res = arrs["res"]
    assert isinstance(res, ShardedArray) and res.spec == (None, "x", "y")
    assert set(res.shards) == set(mesh.coords())
    assert res.shards[(1, 1)].shape == (16, 4, 8)
    np.testing.assert_array_equal(res.numpy(), got["res"])
    placed = ShardedArray.place(mesh, ("x",), np.arange(8.0))
    assert placed.shards[(1, 0)].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert placed.gather().tolist() == list(np.arange(8.0))


@pytest.mark.parametrize("spec,shape,names,axes", [
    (lambda: _synth("box", (8, 16, 16), 2, extent=1, boundary_value=0.7),
     (2, 2), ("x", "y"), (None, "x", "y")),
    (lambda: _synth("box", (8, 16, 24), 2, extent=1), (2,), ("x",),
     (None, None, "x")),
])
def test_sharded_band_assets_equal_jax(spec, shape, names, axes):
    """_sharded_mxu_assets of the port's shard plan: the global stacked
    arrays, their mesh specs and the per-shard slices' shapes of the JAX
    package's (exact precision: f32 matrices on both sides; the port's
    j-tiles stay 1, so the JAX package's j-tile dim of size 1 is
    dropped)."""
    from stencilflow_tpu.backend.stream import StreamPlan as RefPlan
    from stencilflow_tpu_torch.backend.stream import plan_local
    from stencilflow_tpu_torch.parallel.domain import (_shard_contexts,
                                                       _sharded_mxu_assets)
    s = spec()
    a, b = ref.parse_program(s), port.parse_program(s)
    aa, ba = ref.ChainAnalysis.run(a), port.ChainAnalysis.run(b)
    plan = DomainDecomposition.plan(b, make_mesh(["cpu"], shape, names),
                                    axes, ba)
    splan = plan_local(b, ba, plan.block[0], plan.halo[0], spill="off",
                       shard=plan.block[1:], xhalo=plan.halo[1:],
                       contexts=_shard_contexts(plan))
    garr, specs, shapes, resident = _sharded_mxu_assets(splan, plan)
    jplan = ref_domain.DomainDecomposition.plan(a, _jax_mesh(shape, names),
                                                axes, aa)
    rsplan = RefPlan.build(aa, local_jk=jplan.block[1:],
                           halo_jk=jplan.halo[1:],
                           min_lag_max=jplan.halo[0],
                           direct_emit=jplan.halo[0] == 0)
    _assets, rarr, rspecs, _res = ref_domain._sharded_mxu_assets(
        a, aa, rsplan, jplan, 1, 12, "exact")
    assert garr.keys() == rarr.keys()
    assert any(linear.is_stacked_key(k) for k in garr)
    for k, v in garr.items():
        want = np.asarray(rarr[k])
        if k.startswith("Ls_"):
            want = want[:, 0]
        elif k.startswith("corrs_"):
            want = want[:, :, 0]
        np.testing.assert_array_equal(v, want)
        assert specs[k] == tuple(rspecs[k])
        assert shapes[k] == (v.shape[2:] if k.startswith("corrs_") else
                             v.shape[1:] if linear.is_stacked_key(k)
                             else v.shape)
    assert resident == sum(int(np.prod(s)) * 4 for s in shapes.values())


# -- the comm/compute overlap (tests/test_comm_overlap.py's cases) --------------

# name: (spec, mesh, local backend, last_config backend)
OVERLAP = {
    "tile-jk-constant": (lambda: _synth("diffusion", boundary_value=0.5),
                         JK, "xla", "xla"),
    "tile-jk-copy": (lambda: _synth("diffusion", boundary="copy"), JK,
                     "xla", "xla"),
    "tile-jk-shrink": (lambda: _synth("diffusion", boundary="shrink"), JK,
                       "xla", "xla"),
    "stream-i-constant": (lambda: _synth("diffusion", (16, 8, 32),
                                         boundary_value=0.5),
                          ((2,), ("x",), ("x", None, None)), "stream",
                          "stream"),
    "stream-i-copy": (lambda: _synth("diffusion", (16, 8, 32),
                                     boundary="copy"),
                      ((2,), ("x",), ("x", None, None)), "stream", "stream"),
    "stream-i-shrink": (lambda: _synth("diffusion", (16, 8, 32),
                                       boundary="shrink"),
                        ((2,), ("x",), ("x", None, None)), "stream",
                        "stream"),
    "tile-const-ireach-i": (_const_ireach,
                            ((2,), ("x",), ("x", None, None)), "xla", "xla"),
    "stream-const-ireach-i": (_const_ireach,
                              ((2,), ("x",), ("x", None, None)), "stream",
                              "stream"),
    "stream-deep-i": (lambda: _synth("diffusion", (32, 8, 16), 4),
                      ((2,), ("x",), ("x", None, None)), "stream", "stream"),
    "tile-thin-i": (lambda: _synth("diffusion", (12, 8, 16), 2),
                    I4, "xla", "xla"),
    "stream-banded-i": (lambda: _synth("box", (32, 12, 16), 2, extent=2,
                                       boundary_value=0.7),
                        ((2,), ("x",), ("x", None, None)), "stream",
                        "stream"),
}


@pytest.mark.parametrize("name", sorted(OVERLAP))
def test_overlap_matches_blocking_and_jax(name):
    """The overlapped call against the port's blocking body bit for bit
    (within MXU_VERIFY_RTOL banded) and against the JAX package's
    ``run_sharded_chain(comm_overlap=True)`` within its own rtol 1e-6
    (MXU_VERIFY_RTOL banded), with the reference's last_config keys."""
    make, (shape, names, axes), lb, backend = OVERLAP[name]
    spec = make()
    a, b = ref.parse_program(spec), port.parse_program(spec)
    inputs = port.load_input_arrays(b, seed=71)
    mesh = make_mesh(["cpu"], shape, names)
    fn, _plan = compile_sharded_chain(b, mesh, axes, local_backend=lb,
                                      comm_overlap=True)
    cfg = fn.last_config
    assert cfg["comm_overlap"] and cfg["backend"] == backend
    assert compile_sharded_chain.last_config == cfg
    if backend == "stream":
        assert cfg["strip_jtiles"] == 1 and len(fn.plan) == 2
        assert [p.block for p in fn.plan] == [
            b.dimensions[0] // shape[0] - 2 * _plan.halo[0], _plan.halo[0]]
    banded = bool(cfg["mxu_stages"])
    assert banded == name.startswith("stream-banded")
    block, _ = compile_sharded_chain(b, mesh, axes, local_backend=lb)
    want = {k: v.numpy() for k, v in block(inputs).items()}
    for _rep in range(2):   # the same function called again
        got = {k: v.numpy() for k, v in fn(inputs).items()}
        for o in b.outputs:
            assert np.isfinite(got[o]).all()
            if banded:
                assert _close(got[o], want[o], MXU_VERIFY_RTOL)
            else:
                np.testing.assert_array_equal(got[o], want[o])
    jfn, jplan = ref_domain.compile_sharded_chain(
        a, _jax_mesh(shape, names), axes, local_backend=lb, interpret=True,
        comm_overlap=True)
    assert ref_domain.compile_sharded_chain.last_config["comm_overlap"]
    sh = jplan.input_shardings()
    jout = jfn({n: jax.device_put(jnp.asarray(v), sh[n])
                for n, v in inputs.items()})
    for o in b.outputs:
        np.testing.assert_allclose(
            got[o], np.asarray(jout[o]),
            rtol=MXU_VERIFY_RTOL if banded else 1e-6,
            atol=MXU_VERIFY_RTOL if banded else 0)


def test_overlap_without_exchange_is_dropped():
    """One shard: no halo to hide, the flag downgrades (the reference's
    test_no_exchange_is_a_noop)."""
    b = port.parse_program(_synth("diffusion", (8, 8, 16), 2))
    fn, _plan = compile_sharded_chain(b, make_mesh(["cpu"], (1,), ("x",)),
                                      ("x", None, None), comm_overlap=True)
    assert not fn.last_config["comm_overlap"]
    inputs = port.load_input_arrays(b, seed=74)
    np.testing.assert_array_equal(
        fn(inputs)[b.outputs[0]].numpy(),
        np.asarray(port.run_interpreter(b, inputs)[b.outputs[0]]))


def test_overlap_refuses_reduced_precision_on_the_tile_body():
    """Where the stream overlap does not plan (here: asked for the tile
    body), a reduced precision raises as the blocking body's does."""
    b = port.parse_program(_synth("diffusion", (16, 8, 16), 2))
    with pytest.raises(ValueError, match="needs K4"):
        compile_sharded_chain(b, make_mesh(["cpu"], (2,), ("x",)),
                              ("x", None, None), local_backend="xla",
                              comm_overlap=True, mxu_precision="bf16")

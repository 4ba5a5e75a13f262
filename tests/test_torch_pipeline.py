"""The port's operator-pipeline split against the JAX package's.

``stencilflow_tpu_torch.parallel.pipeline.compile_pipeline_split`` runs
on CPU meshes of virtual positions (``mesh.make_mesh(["cpu"], ...)``);
the JAX package's runs on its 8-device virtual CPU mesh
(tests/conftest.py) with the same mesh shape, partition and io, on its
fused-XLA segment body (its stream body in interpret mode for the banded
box).  The port's segment bodies: the dense tile body ("xla", both
packages' name) and K4 in chunk mode ("stream": its plain version on CPU
positions).  Tolerances: per-cell programs equal the numpy oracle bit
for bit and the JAX pipeline within VERIFY_RTOL (XLA's CPU fusion);
banded segments are within MXU_VERIFY_RTOL of both.  The cut search
(every cut function, ``enumerate_cuts``, ``optimize_split`` under the
JAX package's op costs), the segment sub-programs, the errors and the
``last_config`` keys are equal to the JAX package's.  Also: K4's
generated source of every segment, compiled with g++, run on the exact
tiles a pipeline run hands each segment, against the plain version;
``outofcore.compile_chunked_sharded`` against the JAX package's; and
the multi-hop halo gather.
"""
import ctypes
import hashlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu import report as ref_report
from stencilflow_tpu.outofcore import (compile_chunked_sharded as
                                       ref_chunked_sharded)
from stencilflow_tpu.outofcore import run_chunked as ref_run_chunked
from stencilflow_tpu.parallel import pipeline as rp
from stencilflow_tpu_torch import report as port_report
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
from stencilflow_tpu_torch.outofcore import (compile_chunked_sharded,
                                             run_chunked)
from stencilflow_tpu_torch.parallel import (PipelineSplit,
                                            compile_pipeline_split,
                                            run_pipeline_split)
from stencilflow_tpu_torch.parallel import pipeline as pp
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_fuzz import make_random_program

FUZZ_SEEDS = range(6)


def _programs(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                 name=name)


def _graphs(spec):
    a, b = _programs(spec, "g")
    return (a, ref.ChainAnalysis.run(a).graph,
            b, port.ChainAnalysis.run(b).graph)


def _same(f_ref, f_port):
    """Both calls return equal values, or raise the same error type with
    the same message."""
    try:
        want = f_ref()
    except Exception as exc:   # noqa: BLE001 — compared below
        with pytest.raises(type(exc)) as got:
            f_port()
        assert str(got.value) == str(exc)
        return None
    assert f_port() == want
    return want


# -- the cut search -----------------------------------------------------------

@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_cut_functions_and_enumerate_cuts_equal(seed):
    """Every cut function on the fuzz programs: equal segments, or the
    same error."""
    spec = make_random_program(np.random.default_rng(seed), seed)
    _a, ga, _b, gb = _graphs(spec)
    order = gb.kernel_order
    assert ga.kernel_order == order
    cuts = [sorted(c) for c in ga.enumerate_cuts()]
    assert [sorted(c) for c in gb.enumerate_cuts()] == cuts
    for n in range(1, len(order) + 2):
        _same(lambda: rp.split_kernels(ga, n), lambda: pp.split_kernels(gb, n))
    names = [[k] for k in order] + [order[:2], ["nope"], [order[0]] * 2]
    for at in names:
        _same(lambda: rp.split_kernels_at(ga, at),
              lambda: pp.split_kernels_at(gb, at))
    for cut in cuts + [[order[-1]], [], list(order)]:
        _same(lambda: rp.split_kernels_at_cut(ga, cut),
              lambda: pp.split_kernels_at_cut(gb, cut))
    parts = [[order], [order[::-1]], [order[:1], order[1:]],
             [order[1:], order[:1]], [order[:1], order], [order[:1], []]]
    for segs in parts:
        _same(lambda: rp.validate_segments(ga, segs),
              lambda: pp.validate_segments(gb, segs))


def _heavy_s1():
    spec = synthesize_stencil(num_stages=4, dimensions=(8, 8, 16))
    big = " + ".join(f"{0.01 * i:.3f} * s0[i,j,k-{i % 3}]"
                     for i in range(1, 30))
    spec["program"]["s1"]["computation_string"] = f"s1 = {big}"
    return spec


@pytest.mark.parametrize("seed", list(FUZZ_SEEDS) + ["heavy-s1"])
def test_optimize_split_equal_under_the_reference_costs(seed, monkeypatch):
    """The two DPs give the JAX package's segments and stats when the
    port's op-cost table is the JAX package's."""
    monkeypatch.setattr(port_report, "_OP_COST", ref_report._OP_COST)
    spec = _heavy_s1() if seed == "heavy-s1" else \
        make_random_program(np.random.default_rng(seed), seed)
    a, ga, b, gb = _graphs(spec)
    for n in range(1, len(gb.kernel_order) + 2):
        _same(lambda: rp.optimize_split(a, ga, n),
              lambda: pp.optimize_split(b, gb, n))


def test_optimize_split_weighs_h100_costs():
    """Without the patch the port weighs ops by the H100 table (div
    17.12): a division-heavy stage gets a segment of its own."""
    spec = synthesize_stencil(num_stages=4, dimensions=(8, 8, 16))
    spec["program"]["s2"]["computation_string"] = \
        "s2 = s1[i,j,k] / (s1[i,j,k] + 2.0) / 3.0 / 5.0"
    b = port.parse_program(spec)
    gb = port.ChainAnalysis.run(b).graph
    segs, stats = pp.optimize_split(b, gb, 3)
    assert ["s2"] in segs
    assert stats["bottleneck_load"] == max(stats["segment_loads"])


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_segment_programs_equal(seed):
    """``_segment_program`` of every contiguous 2-way split equals the
    JAX package's through ``program_to_json``."""
    spec = make_random_program(np.random.default_rng(seed), seed)
    a, ga, b, gb = _graphs(spec)
    order = gb.kernel_order
    for i in range(1, len(order)):
        segs = [order[:i], order[i:]]
        for si, seg in enumerate(segs):
            later = {k for s in segs[si + 1:] for k in s}
            ra = rp._segment_program(a, ga, seg, si, later)
            pb = pp._segment_program(b, gb, seg, si, later)
            assert port.program_to_json(pb) == ref.program_to_json(ra)


# -- compile_pipeline_split ---------------------------------------------------

def _jacobi4():
    return jacobi(3, 16, iterations=4)


def _forked():
    """Two branches off s0 rejoining at the output (test_backends'
    non-prefix cut fixture)."""
    def st(name, src):
        return {"computation_string":
                f"{name} = 0.25 * ({src}[i-1,j,k] + {src}[i+1,j,k] "
                f"+ {src}[i,j,k-1] + {src}[i,j,k+1])",
                "boundary_conditions":
                    {src: {"type": "constant", "value": 0.0}},
                "data_type": "float32"}
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["j0"], "dimensions": [24, 8, 8],
        "program": {
            "s0": st("s0", "a"), "aa0": st("aa0", "s0"),
            "aa1": st("aa1", "aa0"), "bb0": st("bb0", "s0"),
            "bb1": st("bb1", "bb0"),
            "j0": {"computation_string": "j0 = aa1[i,j,k] + bb1[i,j,k]",
                   "boundary_conditions": {}, "data_type": "float32"}}}


def _early_late():
    """An output before the last segment and an input read by the last
    (test_backends' sharded-io fixture)."""
    c0 = {"type": "constant", "value": 0.0}
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["early", "late"], "dimensions": [8, 12, 12],
        "program": {
            "early": {"computation_string":
                      "early = a[i,j,k] * 2.0 + a[i-1,j,k]",
                      "boundary_conditions": {"a": c0},
                      "data_type": "float32"},
            "mid": {"computation_string": "mid = early[i,j-1,k] + a[i,j,k]",
                    "boundary_conditions": {"early": c0, "a": c0},
                    "data_type": "float32"},
            "late": {"computation_string":
                     "late = mid[i+1,j,k] + early[i,j,k] + a[i,j,k+1]",
                     "boundary_conditions": {"mid": c0, "early": c0,
                                             "a": c0},
                     "data_type": "float32"}}}


def _mixed_crossing():
    """Cut-crossing fields of float64 and float32 (test_backends' gate
    fixture)."""
    def k(src, bcs, dt):
        return {"computation_string": src,
                "boundary_conditions": {f: {"type": "constant",
                                            "value": 0.0} for f in bcs},
                "data_type": dt}
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s3"], "dimensions": [16, 8, 8],
        "program": {
            "s0": k("s0 = (a[i-1,j,k] + a[i+1,j,k]) * 0.5", ["a"],
                    "float64"),
            "s1": k("s1 = s0[i,j,k] * 0.5", ["s0"], "float32"),
            "s2": k("s2 = s1[i-1,j,k] + s0[i,j,k]", ["s1", "s0"],
                    "float64"),
            "s3": k("s3 = s2[i,j,k] * 2.0", ["s2"], "float64")}}


# name: (spec, positions, compile kwargs)
CASES = {
    "jacobi-auto": (_jacobi4, 4, {}),
    "jacobi-split_at": (_jacobi4, 4, {"split_at": ["s0", "s1", "s2"]}),
    "jacobi-cut": (_jacobi4, 2, {"cut": ["s0", "s1", "s2"]}),
    "jacobi-segments": (_jacobi4, 4, {"segments": [["s0"], ["s1"], ["s2"],
                                                   ["s3"]]}),
    "jacobi-optimize": (_jacobi4, 4, {"optimize_cuts": True}),
    "jacobi-chunks8": (_jacobi4, 4, {"num_chunks": 8}),
    "forked-cut": (_forked, 2, {"cut": ["s0", "bb0", "bb1"]}),
    "forked-segments": (_forked, 3, {"segments": [
        ["s0", "bb0"], ["aa0", "aa1", "bb1"], ["j0"]]}),
    "early-late-split": (_early_late, 2, {"split_at": ["early"]}),
    "early-late-mid": (_early_late, 2, {"split_at": ["mid"]}),
    "hotspot": (lambda: synthesize_stencil(
        num_stages=4, dimensions=(8, 16, 16), shape="hotspot"), 4, {}),
    "mixed-crossing": (_mixed_crossing, 4, {}),
}
IO = {"jacobi-chunks8": ("replicated",),
      "mixed-crossing": ("auto", "replicated")}


def _jax_run(a, positions, inputs, shape=None, names=("p",), **kw):
    n = int(np.prod(shape or (positions,)))
    mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(shape or (n,)),
                   names)
    fn, plan = rp.compile_pipeline_split(a, mesh, names[0], **kw)
    cfg = dict(rp.compile_pipeline_split.last_config)
    jin = {}
    for nm, v in inputs.items():
        spec = a.inputs[nm]
        arr = jnp.asarray(v)
        if not spec.is_scalar:
            arr = arr.reshape(tuple(a.dimensions[d] for d in range(3)
                                    if spec.dim_mask[d]))
        jin[nm] = jax.device_put(arr, NamedSharding(mesh,
                                                    cfg["in_specs"][nm]))
    return {k: np.asarray(v) for k, v in fn(jin).items()}, cfg, plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_oracle_and_jax(name):
    """Both io bodies (where the case allows sharded io) and both port
    segment bodies: the oracle bit for bit, the JAX pipeline within
    VERIFY_RTOL, the same segments, io choice and last_config keys."""
    make, S, kw = CASES[name]
    a, b = _programs(make(), name.replace("-", "_"))
    inputs = port.load_input_arrays(b, seed=7)
    oracle = {k: np.asarray(v)
              for k, v in port.run_interpreter(b, inputs).items()}
    mesh = make_mesh(["cpu"], (S,), ("p",))
    for io in IO.get(name, ("replicated", "sharded")):
        want, jcfg, jplan = _jax_run(a, S, inputs, io=io, **kw)
        for lb in ("xla", "stream"):
            fn, plan = compile_pipeline_split(b, mesh, "p", io=io,
                                              local_backend=lb, **kw)
            cfg = fn.last_config
            assert isinstance(plan, PipelineSplit)
            assert plan.segments == jplan.segments
            assert (plan.halo, plan.num_chunks, plan.chunk) == \
                (jplan.halo, jplan.num_chunks, jplan.chunk)
            assert set(cfg) == set(jcfg)
            assert cfg["backend"] == lb and cfg["io"] == jcfg["io"]
            assert cfg["in_specs"] == {n: tuple(s) for n, s in
                                       jcfg["in_specs"].items()}
            out = fn(inputs)
            for o in b.outputs:
                got = out[o].numpy()
                np.testing.assert_array_equal(got, oracle[o])
                assert np.allclose(got, want[o].reshape(got.shape),
                                   rtol=VERIFY_RTOL, atol=VERIFY_RTOL)


def test_mixed_dtype_crossing_refuses_sharded_io():
    a, b = _programs(_mixed_crossing(), "mixcross")
    mesh = make_mesh(["cpu"], (4,), ("p",))
    fn, _ = compile_pipeline_split(b, mesh, "p", io="auto")
    assert fn.last_config["io"] == "replicated"
    jmesh = JaxMesh(np.array(jax.devices()[:4]), ("p",))
    _same(lambda: rp.compile_pipeline_split(a, jmesh, "p", io="sharded"),
          lambda: compile_pipeline_split(b, mesh, "p", io="sharded"))


def test_banded_segments_match_jax_stream():
    """box 8 x 16 x 24 x 2 extent 2 over 2: banded K4 segments (the plain
    version) against the JAX package's interpret-mode stream segments,
    within MXU_VERIFY_RTOL, with the same banded stages a segment."""
    spec = synthesize_stencil(num_stages=2, dimensions=(8, 16, 24),
                              shape="box", extent=2, boundary="constant",
                              boundary_value=0.3)
    a, b = _programs(spec, "pipembox")
    inputs = port.load_input_arrays(b, seed=29)
    oracle = np.asarray(port.run_interpreter(b, inputs)["s1"])
    want, jcfg, _ = _jax_run(a, 2, inputs, local_backend="stream",
                             interpret=True)
    fn, _ = compile_pipeline_split(b, make_mesh(["cpu"], (2,), ("p",)), "p",
                                   local_backend="stream")
    assert fn.last_config["backend"] == jcfg["backend"] == "stream"
    assert fn.last_config["segments"] == jcfg["segments"]
    assert all(s["mxu_stages"] for s in fn.last_config["segments"])
    got = fn(inputs)["s1"].numpy()
    assert np.allclose(got, oracle, rtol=MXU_VERIFY_RTOL,
                       atol=MXU_VERIFY_RTOL)
    assert np.allclose(got, want["s1"].reshape(got.shape),
                       rtol=MXU_VERIFY_RTOL, atol=MXU_VERIFY_RTOL)


def test_composed_auto_split():
    """The affine-run composition before an automatic split: box 16 x 16
    x 24 x 8 over 2 composes each half, reports it under ``composed``
    with the JAX package's keys, and retries uncomposed when asked not
    to compose."""
    spec = synthesize_stencil(num_stages=8, dimensions=(16, 16, 24),
                              shape="box", extent=1)
    b = port.parse_program(spec, name="box8")
    inputs = port.load_input_arrays(b, seed=3)
    oracle = np.asarray(port.run_interpreter(b, inputs)["s7"])
    mesh = make_mesh(["cpu"], (2,), ("p",))
    fn, plan = compile_pipeline_split(b, mesh, "p", local_backend="stream")
    cfg = fn.last_config
    assert cfg["composed"] and set(cfg) == {
        "backend", "io", "segments", "in_specs", "out_specs", "composed"}
    assert compile_pipeline_split.last_config == cfg
    assert len(plan.segments) == 2 and len(plan.program.kernels) == 2
    assert np.allclose(fn(inputs)["s7"].numpy(), oracle,
                       rtol=MXU_VERIFY_RTOL, atol=MXU_VERIFY_RTOL)
    fn, plan = compile_pipeline_split(b, mesh, "p", local_backend="stream",
                                      compose="off")
    assert "composed" not in fn.last_config
    assert [len(s) for s in plan.segments] == [4, 4]


def test_segment_geometry():
    """Chunk mode's per-segment widening: jacobi 16^3 x 4 over 4 reads
    4, 3, 2 and 1 halo planes a side, writes 3, 2, 1 and 0."""
    b = port.parse_program(_jacobi4())
    fn, plan = compile_pipeline_split(b, make_mesh(["cpu"], (4,), ("p",)),
                                      "p", local_backend="stream")
    assert plan.widen == [(4, 0, 0), (3, 0, 0), (2, 0, 0), (1, 0, 0)]
    assert plan.emit == [(3, 0, 0), (2, 0, 0), (1, 0, 0), (0, 0, 0)]
    assert [sp.block for sp in fn.stream_plans] == [10, 8, 6, 4]
    assert [sp.halo_i for sp in fn.stream_plans] == [1, 1, 1, 1]
    assert fn.cut_layouts == [["s0"], ["s1"], ["s2"]]


def test_run_pipeline_split_and_errors():
    a, b = _programs(jacobi(3, 16, iterations=8), "j8")
    inputs = port.load_input_arrays(b, seed=8)
    oracle = np.asarray(port.run_interpreter(b, inputs)["s7"])
    mesh = make_mesh(["cpu"], (2,), ("p",))
    got = run_pipeline_split(b, mesh, "p", inputs, split_at=["s5"])
    np.testing.assert_array_equal(got["s7"], oracle)
    jmesh = JaxMesh(np.array(jax.devices()[:2]), ("p",))
    for kw in ({"split_at": ["s1", "s5"]}, {"split_at": ["s0"],
                                             "cut": ["s0"]},
               {"num_chunks": 3}, {"num_chunks": 4, "io": "sharded"}):
        _same(lambda: rp.compile_pipeline_split(a, jmesh, "p", **kw),
              lambda: compile_pipeline_split(b, mesh, "p", **kw))


# -- pipeline x domain ---------------------------------------------------------

@pytest.mark.parametrize("spec,shape,names,daxes,rtol", [
    (lambda: jacobi(3, 16, iterations=8), (2, 4), ("p", "x"), {1: "x"}, 0),
    (lambda: jacobi(3, 16, iterations=8), (2, 4), ("p", "x"), {2: "x"}, 0),
    (lambda: jacobi(3, 16, iterations=4), (2, 2, 2), ("p", "x", "y"),
     {1: "x", 2: "y"}, 0),
    (lambda: synthesize_stencil(num_stages=4, dimensions=(8, 16, 16),
                                shape="hotspot"), (4, 2), ("p", "x"),
     {1: "x"}, 0),
], ids=["2x4-j-deep-halo", "2x4-k-deep-halo", "2x2x2-jk", "4x2-hotspot"])
def test_pipeline_domain_matches_oracle_and_jax(spec, shape, names, daxes,
                                                rtol):
    """test_pipeline_domain.py's cases: the chain halo (8) exceeds the
    4-way local extent (4), so the j/k halos gather multi-hop."""
    s = spec()
    a, b = _programs(s, "pdc")
    inputs = port.load_input_arrays(b, seed=5)
    oracle = {k: np.asarray(v)
              for k, v in port.run_interpreter(b, inputs).items()}
    want, jcfg, _ = _jax_run(a, None, inputs, shape=shape, names=names,
                             domain_axes=daxes, interpret=True)
    fn, plan = compile_pipeline_split(b, make_mesh(["cpu"], shape, names),
                                      names[0], domain_axes=daxes)
    assert fn.last_config["backend"] == "xla" == jcfg["backend"]
    assert fn.last_config["out_specs"] == {
        n: tuple(v) for n, v in jcfg["out_specs"].items()}
    out = fn(inputs)
    for o in b.outputs:
        got = out[o].numpy().reshape(oracle[o].shape)
        np.testing.assert_array_equal(got, oracle[o])
        assert np.allclose(got, want[o].reshape(got.shape),
                           rtol=VERIFY_RTOL, atol=VERIFY_RTOL)


def test_pipeline_domain_gates_equal():
    a, b = _programs(jacobi(3, 16, iterations=4), "pdc_g")
    a18, b18 = _programs(jacobi(3, 18, iterations=4), "pdc_nd")
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("p", "x"))
    mesh = make_mesh(["cpu"], (2, 4), ("p", "x"))
    for pa, pb, kw in [
            (a18, b18, {"domain_axes": {1: "x"}}),
            (a, b, {"domain_axes": {1: "p"}}),
            (a, b, {"domain_axes": {0: "x"}}),
            (a, b, {"domain_axes": {1: "x"}, "io": "replicated"}),
            (a, b, {"domain_axes": {1: "x"}, "local_backend": "stream"})]:
        _same(lambda: rp.compile_pipeline_split(pa, jmesh, "p",
                                                interpret=True, **kw),
              lambda: compile_pipeline_split(pb, mesh, "p", **kw))


# -- K4 per segment: the generated source through g++ --------------------------

def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    return gxx


@pytest.mark.parametrize("spec,S,banded", [
    (_jacobi4, 4, False),
    (lambda: jacobi(3, 16, iterations=4, boundary="copy"), 2, False),
    (lambda: synthesize_stencil(num_stages=2, dimensions=(8, 16, 24),
                                shape="box", extent=2, boundary="constant",
                                boundary_value=0.3), 2, True),
], ids=["jacobi-4", "jacobi-copy-2", "box-banded-2"])
def test_generated_segment_kernels_match_plain(spec, S, banded, tmp_path,
                                               monkeypatch):
    """Each segment's K4 source, built with g++ (``sf_host_launch``), run
    on the exact tiles a pipeline run gives that segment (blocks past the
    domain at the first and last chunks): every output plane equal to
    the plain version (per cell), the in-domain planes within
    MXU_VERIFY_RTOL (banded)."""
    calls = []
    plain = stream.run_local_stream

    def record(plan, origin_i, slabs, lib=None, *rest):
        out = plain(plan, origin_i, slabs, lib, *rest)
        calls.append((plan, origin_i, dict(slabs), out))
        return out
    monkeypatch.setattr(stream, "run_local_stream", record)
    b = port.parse_program(spec())
    inputs = port.load_input_arrays(b, seed=3)
    fn, plan = compile_pipeline_split(b, make_mesh(["cpu"], (S,), ("p",)),
                                      "p", local_backend="stream")
    fn(inputs)
    assert len(calls) == S * plan.num_chunks
    I = b.dimensions[0]
    libs = {}
    for sp, oi, slabs, want in calls:
        assert bool(sp.mxu_plans) == banded
        if id(sp) not in libs:
            src = stream.stream_source(sp)
            tag = hashlib.sha256(src.encode()).hexdigest()[:16]
            cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
            cpp.write_text(src)
            proc = subprocess.run([_gxx(), "-std=c++17", "-O1",
                                   "-ffp-contract=off", "-shared", "-fPIC",
                                   "-o", str(so), str(cpp)],
                                  capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-3000:]
            libs[id(sp)] = ctypes.CDLL(str(so))
            libs[id(sp)].sf_host_launch.argtypes = \
                [ctypes.c_void_p] * 3 + [ctypes.c_int]
        q = sp.program
        arrays = [slabs[n].numpy() for n, s in q.inputs.items()
                  if not s.is_scalar]
        arrays += [np.ascontiguousarray(m, np.float32)
                   for _k, m in sp.kernel_pool()]
        outs = [np.zeros((sp.block,) + q.dimensions[1:], q.kernels[o].dtype)
                for o in q.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[x.ctypes.data for x in arrays])
        op = (ctypes.c_void_p * len(outs))(*[x.ctypes.data for x in outs])
        libs[id(sp)].sf_host_launch(
            ctypes.addressof(ip), ctypes.addressof(op),
            scalar_blob(q, slabs).ctypes.data, oi)
        g0 = oi + sp.halo_i          # global plane of output plane 0
        lo, hi = max(0, -g0), min(sp.block, I - g0)
        for o, got in zip(q.outputs, outs):
            w = want[o].numpy()
            if banded:
                assert np.allclose(got[lo:hi], w[lo:hi], rtol=MXU_VERIFY_RTOL,
                                   atol=MXU_VERIFY_RTOL)
            else:
                np.testing.assert_array_equal(got, w)


# -- the multi-hop gather and compile_chunked_sharded --------------------------

@pytest.mark.parametrize("n,local,h", [(4, 4, 1), (4, 4, 6), (3, 2, 5),
                                       (1, 8, 3)])
def test_gather_axis_halo(n, local, h):
    """Each position's block widened by h from as many neighbours as h
    spans, zeros past the global edge."""
    mesh = make_mesh(["cpu"], (2, n), ("a", "b"))
    full = torch.arange(2 * n * local * 3, dtype=torch.float32).reshape(
        2, n * local, 3)
    shards = {c: full[c[0], c[1] * local:(c[1] + 1) * local].clone()
              for c in mesh.coords()}
    got = pp._gather_axis_halo(shards, mesh, "b", 0, h, local)
    for c, t in got.items():
        padded = torch.nn.functional.pad(full[c[0]], (0, 0, h, h))
        want = padded[c[1] * local:c[1] * local + local + 2 * h]
        assert torch.equal(t, want)


def _raw_inputs(p, inputs):
    return {k: (np.asarray(v).reshape(p.raw_dimensions)
                if not p.inputs[k].is_scalar and all(p.inputs[k].dim_mask)
                else np.asarray(v))
            for k, v in inputs.items()}


def _jax_mesh(shape, names):
    return JaxMesh(np.array(jax.devices()[:int(np.prod(shape))])
                   .reshape(shape), names)


@pytest.mark.parametrize("spec,chunks,shape,daxes,rtol", [
    (lambda: jacobi(3, 32, iterations=3), 2, (4, 2), (None, "x", "y"), 0),
    (lambda: jacobi(3, 32, iterations=3), 4, (4, 2), (None, "x", None), 0),
    (lambda: jacobi(3, 32, iterations=3), 8, (2, 4), (None, None, "y"), 0),
    (lambda: jacobi(3, 32, iterations=3), 1, (2, 2), (None, "x", "y"), 0),
    (lambda: jacobi(3, 16, iterations=6), 2, (4, 2), (None, "x", None), 0),
    (lambda: synthesize_stencil(num_stages=3, dimensions=(12, 16, 16),
                                shape="hotspot"), 3, (4, 2),
     (None, "x", "y"), 0),
], ids=["jacobi-2-xy", "jacobi-4-x", "jacobi-8-y", "jacobi-1-xy",
        "multi-hop-j", "hotspot-3-xy"])
def test_chunked_sharded_matches_oracle_and_jax(spec, chunks, shape, daxes,
                                                rtol, tmp_path):
    """test_outofcore_sharded.py's cases, the last into memmapped
    outputs."""
    a, b = _programs(spec(), "ocs")
    inputs = port.load_input_arrays(b, seed=21)
    oracle = {k: np.asarray(v)
              for k, v in port.run_interpreter(b, inputs).items()}
    raw = _raw_inputs(b, inputs)
    want = ref_run_chunked(a, raw, chunks, mesh=_jax_mesh(shape, ("x", "y")),
                           dim_axes=daxes)
    out = {o: np.lib.format.open_memmap(
        str(tmp_path / f"{o}.npy"), mode="w+",
        dtype=np.dtype(b.kernels[o].dtype), shape=tuple(b.raw_dimensions))
        for o in b.outputs}
    got = run_chunked(b, raw, chunks, out=out,
                      mesh=make_mesh(["cpu"], shape, ("x", "y")),
                      dim_axes=daxes)
    for o in b.outputs:
        assert got[o] is out[o]
        np.testing.assert_array_equal(got[o], oracle[o])
        assert np.allclose(got[o], want[o], rtol=VERIFY_RTOL,
                           atol=VERIFY_RTOL)


def test_chunked_sharded_plan_and_gates_equal():
    a, b = _programs(jacobi(3, 32, iterations=2), "ocs_fp")
    jmesh, mesh = _jax_mesh((4, 2), ("x", "y")), make_mesh(["cpu"], (4, 2),
                                                          ("x", "y"))
    _fn, jplan = ref_chunked_sharded(a, 4, jmesh, dim_axes=(None, "x", "y"))
    _fn, plan = compile_chunked_sharded(b, 4, mesh,
                                        dim_axes=(None, "x", "y"))
    assert (plan.chunks, plan.block, plan.halo, plan.backend,
            plan.config) == (jplan.chunks, jplan.block, jplan.halo,
                             jplan.backend, jplan.config)
    a30, b30 = _programs(jacobi(3, 30, iterations=2), "ocs_nd")
    for pa, pb, kw in [(a, b, {"dim_axes": ("x", None, None)}),
                       (a30, b30, {"dim_axes": (None, "x", None)}),
                       (a, b, {"dim_axes": (None, "z", None)}),
                       (a, b, {"dim_axes": (None, "x", "y"),
                               "chunks": 3})]:
        kw = dict(kw)
        chunks = kw.pop("chunks", 2)
        _same(lambda: ref_chunked_sharded(pa, chunks, jmesh, **kw),
              lambda: compile_chunked_sharded(pb, chunks, mesh, **kw))

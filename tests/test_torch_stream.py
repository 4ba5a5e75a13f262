"""The port's stream lowering (backend/stream.py) against the JAX package's,
on the CPU.

The same inputs, made once with numpy from a seed, go through the JAX
package's ``compile_chain_stream(interpret=True)`` (its Pallas kernel in
interpret mode, banded stages as split-precision matmuls) and through the
port's ``compile_chain_stream(device="cpu")``, which runs the kernel's
plain torch version under the same plan.  Tolerance: ``MXU_VERIFY_RTOL``
(3e-5 relative, the JAX package's own envelope for banded stages), against
the JAX kernel and against the numpy oracle — both re-associate the f32
sums of a banded stage differently.  Shrink programs are held to the
oracle on the core only (their halo cells are junk by contract).

The generated CUDA source itself compiles with g++ as well (its block body
is a plain function of the block and thread index); those tests run it
one thread per block over every block, against the plain version at the
same tolerance.  On the card, chip_smoke.py and tests/test_torch_cuda.py
compare the CUDA kernel with the plain version.
"""
import ctypes
import hashlib
import json
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import stream as ref_stream
from stencilflow_tpu.backend.compose import compose_program
from stencilflow_tpu_torch.backend import (choose_backend, overlap, panel,
                                           stream)
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.synthesize import synthesize_stencil


def mixed_spec(dims=(12, 14, 16)):
    """A per-cell stage feeding a wide affine stage that reads two fields
    (a rank-1 box of s0 with a constant-0.2 BC, a rank-2 cross of b), an
    (i, k) input, a scalar and a bias; then a narrow per-cell stage."""
    box = " + ".join(f"s0[i{di:+d},j{dj:+d},k{dk:+d}]"
                     for di in (-1, 0, 1) for dj in (-1, 0, 1)
                     for dk in (-1, 0, 1))
    cross = " + ".join(f"b[i{o[0]:+d},j{o[1]:+d},k{o[2]:+d}]" for o in
                       [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                        (0, -1, 0), (0, 0, 1), (0, 0, -1)])

    def bc(v):
        return {"type": "constant", "value": v}
    return {
        "inputs": {
            "a": {"data": "random:0.0,1.0", "data_type": "float32"},
            "b": {"data": "random:0.0,1.0", "data_type": "float32"},
            "ik": {"data": "random:0.0,1.0", "data_type": "float32",
                   "input_dims": ["i", "k"]},
            "sc": {"data": 0.5, "data_type": "float32", "input_dims": []}},
        "outputs": ["s2"], "dimensions": list(dims),
        "program": {
            "s0": {"computation_string":
                   "s0 = a[i,j,k] * a[i,j,k] + 0.1 * a[i,j+1,k]",
                   "boundary_conditions": {"a": bc(0.0)},
                   "data_type": "float32"},
            "s1": {"computation_string":
                   f"s1 = 0.04 * ({box}) + 0.1 * ({cross}) "
                   "+ 0.3 * ik[i,k+1] + sc + 1.0",
                   "boundary_conditions": {"s0": bc(0.2), "b": bc(0.0),
                                           "ik": bc(0.0)},
                   "data_type": "float32"},
            "s2": {"computation_string": "s2 = s1[i,j,k] * 0.5 + "
                   "s1[i-1,j+1,k]",
                   "boundary_conditions": {"s1": bc(0.0)},
                   "data_type": "float32"}}}


def rank3_spec(dims=(8, 16, 16), stages=3):
    """A chain of wide affine stages whose (j, k) coefficients have rank
    above 2: an MXU candidate the banded planner declines."""
    w = (1, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)
    taps = [(o, p) for o in (-2, -1, 0, 1) for p in (-1, 0, 1, 2)]
    program, prev = {}, "a"
    for s in range(stages):
        expr = " + ".join(f"{x / 500}*{prev}[i,j{o:+d},k{p:+d}]"
                          for (o, p), x in zip(taps, w))
        program[f"s{s}"] = {
            "computation_string": f"s{s} = {expr} + 0.5*{prev}[i-1,j,k]",
            "boundary_conditions": {prev: {"type": "constant",
                                           "value": 0.0}},
            "data_type": "float32"}
        prev = f"s{s}"
    return {"inputs": {"a": {"data": "random:0.0,1.0",
                             "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims),
            "program": program}


def _synth(shape, dims, stages, **kw):
    kw.setdefault("seed_data", "random:0.0,1.0")
    return lambda: synthesize_stencil(num_stages=stages, dimensions=dims,
                                      shape=shape, **kw)


# name: (spec, shrink halo to prune against the oracle)
PROGRAMS = {
    "box1": (_synth("box", (10, 12, 16), 2, extent=1), 0),
    "box2_bval": (_synth("box", (10, 12, 16), 2, extent=2,
                         boundary_value=0.7), 0),
    "box4_composed": (_synth("box", (20, 16, 16), 4, extent=2), 0),
    "box4_small_i": (_synth("box", (12, 24, 24), 4, extent=2), 0),
    "box_shrink": (_synth("box", (12, 14, 16), 2, extent=1,
                          boundary="shrink"), 2),
    "cross_wide_2d": (_synth("cross", (12, 16), 2, extent=3), 0),
    "cross_r2": (_synth("cross", (12, 14, 16), 3, extent=2), 0),
    "fork": (_synth("box", (12, 12, 12), 5, extent=1, fork_frequency=2),
             0),
    "mixed": (mixed_spec, 0),
    "f64_box": (_synth("box", (4, 8, 8), 2, extent=1,
                       data_type="float64"), 0),
    "rank3": (rank3_spec, 0),
}


def _close(want, got, rtol=MXU_VERIFY_RTOL):
    return ref.arrays_are_equal(np.asarray(want), np.asarray(got), rtol)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_stream_matches_jax_stream(name):
    make, halo = PROGRAMS[name]
    spec = make()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=5)
    jax_fn = ref_stream.compile_chain_stream(p_ref, interpret=True)
    cfg = dict(ref_stream.compile_chain_stream.last_config)
    jax_out = jax_fn({k: jnp.asarray(v) for k, v in inputs.items()})
    oracle = ref.run_interpreter(p_ref, inputs)
    fn = stream.compile_chain_stream(p, device="cpu")
    assert fn.last_config["mxu_stages"] == cfg["mxu_stages"]
    assert fn.last_config["composed"] == cfg["composed"]
    assert fn.last_config["jtiles"] == 1 and fn.last_config["spilled"] == []
    got = fn(inputs)
    for o in oracle:
        g = got[o].numpy()
        assert g.dtype == oracle[o].dtype and g.shape == oracle[o].shape
        assert _close(np.asarray(jax_out[o]), g)
        assert _close(port.prune_halo(oracle[o], p.raw_dimensions, halo),
                      port.prune_halo(g, p.raw_dimensions, halo))
    if not cfg["mxu_stages"]:
        # per-cell only: the plain version is the oracle's math, exactly
        for o in oracle:
            np.testing.assert_array_equal(got[o].numpy(), oracle[o])


@pytest.mark.parametrize("name", ["box4_composed", "box2_bval", "cross_r2",
                                  "mixed", "fork"])
def test_lags_are_the_reference_algebra(name):
    """StreamPlan.lags equals the JAX package's StreamPlan.build at block
    1 on the program the kernel runs (the composed one where runs
    compose)."""
    spec = PROGRAMS[name][0]()
    a = ref.parse_program(spec)
    got = compose_program(a, ref.ChainAnalysis.run(a))
    plan = stream.plan_stream(port.parse_program(spec))
    if plan.composed:
        a = got[0]
    rp = ref_stream.StreamPlan.build(ref.ChainAnalysis.run(a))
    assert (rp.lag, rp.ring, rp.lag_max) == \
        (plan.lag, plan.ring, plan.lag_max)
    assert list(plan.program.kernels) == list(a.kernels)
    for f, d in plan.raw_ring.items():
        assert d <= rp.ring[f]


# -- the generated kernel, compiled with g++ --------------------------------

def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    return gxx


def run_host(plan, inputs, tmp_path):
    """Compile ``stream_source`` with g++ and run every block with one
    thread (``sf_host_launch``)."""
    return run_source(stream.stream_source(plan), plan.program, inputs,
                      [a for _k, a in plan.kernel_pool()], tmp_path)


def run_source(src, p, inputs, extra, tmp_path):
    """Compile a generated source with an ``sf_host_launch`` with g++ and
    run it on ``inputs`` (then the float32 tables ``extra``)."""
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3
    arrays = [np.ascontiguousarray(inputs[n])
              for n, s in p.inputs.items() if not s.is_scalar]
    arrays += [np.ascontiguousarray(a, np.float32) for a in extra]
    outs = [np.zeros(p.dimensions, p.kernels[o].dtype) for o in p.outputs]
    ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
    blob = scalar_blob(p, inputs)
    lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                       blob.ctypes.data)
    return dict(zip(p.outputs, outs))


@pytest.mark.parametrize("name,tile", [
    ("box4_composed", (4, 8)), ("box2_bval", None), ("cross_r2", (2, 8)),
    ("mixed", (4, 16)), ("box_shrink", None)])
def test_generated_kernel_matches_plain(name, tile, tmp_path):
    make, halo = PROGRAMS[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, tile=tile)
    assert plan.mxu_plans and plan.grid()[0] * plan.grid()[1] > 1
    inputs = port.load_input_arrays(p, seed=2)
    got = run_host(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    oracle = port.run_interpreter(p, inputs)
    for o in p.outputs:
        assert np.isfinite(got[o]).all()
        assert _close(want[o].numpy(), got[o])
        assert _close(port.prune_halo(oracle[o], p.raw_dimensions, halo),
                      port.prune_halo(got[o], p.raw_dimensions, halo))


def test_kernel_source_calls_no_library():
    """The band transforms are the kernel's own sums: no cuBLAS / cuDNN
    or torch call in the generated source, and a ring per transform."""
    plan = stream.plan_stream(port.parse_program(PROGRAMS["mixed"][0]()))
    src = stream.stream_source(plan)
    for word in ("cublas", "cudnn", "wmma", "mma.sync", "#include <cub"):
        assert word not in src.lower()
    assert src.count("// transform") == len(plan.tkeys) >= 2


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw,expected", [
    ("box", {"extent": 2}, "stream"),
    ("cross", {"extent": 2}, "stream"),
    ("diffusion", {}, "panel"),
    ("hdiff", {}, "panel"),
    ("hotspot", {}, "panel"),
])
def test_choose_backend_at_256(shape, kw, expected):
    """By planning only, at the main path's 256^3 x 8."""
    p = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(256,) * 3, shape=shape, **kw))
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda") == expected
    assert choose_backend(p, an, "cpu") == "dense"


def test_declined_candidate_routes_like_the_reference():
    """A wide affine chain of rank 3: the JAX package's streamer plans no
    banded stage and compile_chain_best goes back to panel; the port
    follows (it used to send every candidate to dense)."""
    p_ref = ref.parse_program(rank3_spec())
    ref_stream.compile_chain_stream(p_ref, interpret=True)
    assert ref_stream.compile_chain_stream.last_config["mxu_stages"] == []
    p = port.parse_program(rank3_spec(dims=(64, 64, 64)))
    an = port.ChainAnalysis.run(p)
    from stencilflow_tpu_torch.backend import _any_mxu_candidate
    assert _any_mxu_candidate(p)
    assert stream.plan_stream(p, an).mxu_plans == {}
    assert choose_backend(p, an, "cuda") == "panel"
    assert choose_backend(p, an, "cuda", mxu="off") == "panel"


def test_main_path_plans_fit():
    """box-r2 256^3 x 8 composes all 8 stages into one banded stage;
    cross-r2 plans every stage on its own; both fit shared memory."""
    for shape, mxu, composed in (("box", ["s7"], {"s7": [
            f"s{i}" for i in range(8)]}), ("cross", [
                f"s{i}" for i in range(8)], {})):
        p = port.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape=shape, extent=2))
        plan = stream.plan_stream(p)
        assert plan.last_config()["mxu_stages"] == mxu
        assert plan.last_config()["composed"] == composed
        assert 0 < plan.smem_bytes() <= stream.H100_SMEM_PER_BLOCK


def test_options():
    p = port.parse_program(PROGRAMS["box1"][0]())
    with pytest.raises(NotImplementedError, match="bf16"):
        stream.compile_chain_stream(p, mxu_precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="mxu_precision"):
        stream.compile_chain_stream(p, mxu_precision="fast", device="cpu")
    with pytest.raises(ValueError, match="mxu"):
        stream.compile_chain_stream(p, mxu="on", device="cpu")
    off = stream.plan_stream(p, mxu="off")
    assert off.mxu_plans == {} and off.tkeys == []
    assert stream.plan_stream(p, compose="off").composed == {}
    inputs = port.load_input_arrays(p, seed=1)
    got = stream.compile_chain_stream(p, mxu="off", device="cpu")(inputs)
    np.testing.assert_array_equal(got["s1"].numpy(),
                                  port.run_interpreter(p, inputs)["s1"])


# -- entry points on the card by default -------------------------------------

def test_cuda_entry_points_raise_without_gpu(monkeypatch):
    """Built for the card (the default) on a machine without one: every
    entry point raises, and no plain version runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for mod, name in ((stream, "stream_plain"), (panel, "panel_plain"),
                      (overlap, "overlap_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: ran.append(1))
    p = port.parse_program(synthesize_stencil(num_stages=2,
                                              dimensions=(8, 8, 8)))
    inputs = port.load_input_arrays(p, seed=0)
    for compile_fn in (stream.compile_chain_stream,
                       panel.compile_chain_panel,
                       overlap.compile_chain_overlap):
        with pytest.raises(RuntimeError, match="no GPU"):
            compile_fn(p)(inputs)
    assert ran == []


def test_forward_moves_inputs_to_its_device():
    """A function built for a device runs on it whatever the inputs'
    device: numpy inputs go to the CPU function's device."""
    p = port.parse_program(PROGRAMS["box2_bval"][0]())
    fn = stream.compile_chain_stream(p, device="cpu")
    before = stream.launches
    out = fn(port.load_input_arrays(p, seed=0))
    assert stream.launches == before
    assert out["s1"].device.type == "cpu"
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=0))
    with pytest.raises(ValueError, match="device"):
        stream.run_stream(fn.plan, {"a": arrays["a"].to("meta")})


# -- driver and CLI ------------------------------------------------------------

def test_run_program_stream(tmp_path, monkeypatch, capsys):
    spec = PROGRAMS["box4_composed"][0]()
    res = run_program(spec, device="cpu", backend="stream",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "stream" and res.verified_against_reference
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(PROGRAMS["mixed"][0]()))
    monkeypatch.chdir(tmp_path)
    for extra in (["--mxu", "auto", "--mxu-precision", "exact"],
                  ["--mxu", "off"]):
        rc = cli_main(["run", str(path), "--device", "cpu", "--backend",
                       "stream", "--compare-to-reference"] + extra)
        out = capsys.readouterr().out
        assert rc == 0
        assert "backend: stream" in out
        assert "verified against reference: OK" in out

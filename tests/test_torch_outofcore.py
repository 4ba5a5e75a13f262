"""The port's out-of-core path (outofcore.py, parallel/domain.py and the
local stream kernel K4) against the JAX package's, on the CPU.

The same numpy inputs (``load_input_arrays`` from a seed) go through the
JAX package's ``run_chunked`` — its fused-XLA chunk body and its stream
chunk body in interpret mode — and through the port's ``run_chunked(...,
device="cpu")`` with the dense body and with ``backend="stream"`` (K4's
plain version, ``local_stream_plain``).  Tolerances: per-cell chains
equal the numpy oracle exactly and the JAX chunk bodies within
``VERIFY_RTOL``; chains with banded stages agree with both within
``MXU_VERIFY_RTOL`` (their f32 sums are re-associated).

K4's generated source also compiles with g++ (``sf_host_launch``, one
thread per block, shared memory filled with NaN): run chunk by chunk it
equals ``local_stream_plain`` bit for bit on per-cell chains, so no plane
outside a chunk reaches a core plane.  On the card, chip_smoke.py and
tests/test_torch_cuda.py compare the CUDA kernel with the plain version.
"""
import ctypes
import hashlib
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import stream as ref_stream
from stencilflow_tpu.outofcore import (compile_chunked_chain as
                                       ref_compile_chunked,
                                       run_chunked as ref_run_chunked)
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.dense import chain_halo
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.outofcore import (_host_slab,
                                             compile_chunked_chain,
                                             link_bytes, run_chunked)
from stencilflow_tpu_torch.synthesize import (jacobi, random_program,
                                              synthesize_stencil)


def _jacobi_bc(kind, size=8, iterations=2):
    spec = jacobi(3, size, iterations=iterations)
    for k in spec["program"].values():
        for bc in k["boundary_conditions"].values():
            bc["type"] = kind
    return spec


def _fuzz(seed=1004, dims=(24, 10, 12)):
    """A 3-D fuzz chain with a scalar, a (k) and an (i, k) input, at a
    size that chunks (i-halo 4)."""
    spec = random_program(np.random.default_rng(seed), ndim=3,
                          bc_kinds=("constant", "copy", "shrink"))
    spec["dimensions"] = list(dims)
    return spec


# name: (spec, chunks, banded)
PROGRAMS = {
    "jacobi3d_c1": (lambda: jacobi(3, 16, iterations=3), 1, False),
    "jacobi3d_c2": (lambda: jacobi(3, 16, iterations=3), 2, False),
    "jacobi3d_c4": (lambda: jacobi(3, 16, iterations=3), 4, False),
    "jacobi_copy": (lambda: _jacobi_bc("copy"), 2, False),
    "jacobi_shrink": (lambda: _jacobi_bc("shrink"), 2, False),
    "hdiff_dag": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="hdiff"), 4, False),
    "box_r2": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(12, 12, 16), shape="box", extent=2,
        seed_data="random:0.0,1.0"), 2, True),
    "fuzz": (_fuzz, 4, False),
}


def _close(want, got, rtol):
    return ref.arrays_are_equal(np.asarray(want), np.asarray(got), rtol)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_chunked_matches_jax_and_oracle(name):
    """Both chunk bodies of the port against both of the JAX package's and
    the oracle, and the chosen plans alike."""
    make, chunks, banded = PROGRAMS[name]
    spec = make()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=3)
    oracle = ref.run_interpreter(p_ref, inputs)
    jax_xla = ref_run_chunked(p_ref, inputs, chunks, backend="xla")
    ref_fn, ref_plan = ref_compile_chunked(p_ref, chunks, backend="stream",
                                           interpret=True)
    jax_stream = ref_run_chunked(p_ref, inputs, chunks,
                                 compiled=(ref_fn, ref_plan))
    dense = run_chunked(p, inputs, chunks, device="cpu")
    fn, plan = compile_chunked_chain(p, chunks, backend="stream",
                                     device="cpu")
    assert (plan.chunks, plan.block, plan.halo) == \
        (ref_plan.chunks, ref_plan.block, ref_plan.halo)
    assert plan.backend == ref_plan.backend == "stream"
    assert plan.config == ref_plan.config
    assert bool(plan.config["mxu_stages"]) == banded
    local = run_chunked(p, inputs, chunks, compiled=(fn, plan))
    for o in p.outputs:
        assert dense[o].dtype == oracle[o].dtype
        assert dense[o].shape == oracle[o].shape
        np.testing.assert_array_equal(dense[o], oracle[o])
        assert _close(jax_xla[o], dense[o], VERIFY_RTOL)
        if banded:
            assert _close(oracle[o], local[o], MXU_VERIFY_RTOL)
            assert _close(jax_stream[o], local[o], MXU_VERIFY_RTOL)
        else:
            np.testing.assert_array_equal(local[o], oracle[o])
            assert _close(jax_stream[o], local[o], VERIFY_RTOL)


@pytest.mark.parametrize("name", ["jacobi3d_c4", "jacobi_shrink",
                                  "hdiff_dag", "box_r2", "fuzz"])
def test_local_lags_are_the_reference_algebra(name):
    """A local plan's (lag, ring, lag_max) equal the JAX package's
    ``StreamPlan.build(min_lag_max=h, direct_emit=h == 0)``; the rings the
    kernel allocates are never deeper (it writes outputs directly)."""
    make, chunks, _ = PROGRAMS[name]
    spec = make()
    a = ref.parse_program(spec)
    p = port.parse_program(spec)
    an = port.ChainAnalysis.run(p)
    h = chain_halo(an)[0] if chunks > 1 else 0
    plan = stream.plan_local(p, an, p.dimensions[0] // chunks, h)
    rp = ref_stream.StreamPlan.build(ref.ChainAnalysis.run(a),
                                     min_lag_max=h, direct_emit=h == 0)
    assert (rp.lag, rp.ring, rp.lag_max) == \
        (plan.lag, plan.ring, plan.lag_max)
    assert plan.extent() == p.dimensions[0] // chunks + 2 * h
    for f, d in plan.raw_ring.items():
        assert d <= rp.ring[f]
    read = {f for k in p.kernels.values() for f in k.accesses()}
    assert not [o for o in p.outputs if o in plan.raw_ring and o not in read]


# -- K4's generated source, compiled with g++ ---------------------------------

def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    return gxx


def _chunk_slabs(p, inputs, lo, Ii):
    I = p.dimensions[0]
    slabs = {}
    for n, s in p.inputs.items():
        arr = np.asarray(inputs[n])
        if s.is_scalar or not s.dim_mask[0]:
            slabs[n] = torch.as_tensor(arr)
        else:
            slabs[n] = _host_slab(arr, lo, lo + Ii, I)
    return slabs


@pytest.mark.parametrize("name,tile", [
    ("jacobi3d_c4", (4, 8)), ("jacobi_copy", (2, 8)),
    ("jacobi_shrink", None), ("hdiff_dag", (4, 8)), ("box_r2", (4, 8)),
    ("fuzz", (4, 8))])
def test_generated_local_kernel_matches_plain(name, tile, tmp_path):
    make, chunks, banded = PROGRAMS[name]
    p = port.parse_program(make())
    an = port.ChainAnalysis.run(p)
    I = p.dimensions[0]
    Ic = I // chunks
    h = chain_halo(an)[0] if chunks > 1 else 0
    plan = stream.plan_local(p, an, Ic, h, tile=tile)
    assert bool(plan.mxu_plans) == banded
    src = stream.stream_source(plan)
    assert "sf_local_stream" in src and "sf_local_launch" in src
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    inputs = port.load_input_arrays(p, seed=2)
    oracle = port.run_interpreter(p, inputs)
    blob = scalar_blob(p, inputs)
    for c in range(chunks):
        lo = c * Ic - h
        slabs = _chunk_slabs(p, inputs, lo, Ic + 2 * h)
        want = stream.local_stream_plain(plan, lo, slabs)
        arrays = [slabs[n].numpy() for n, s in p.inputs.items()
                  if not s.is_scalar]
        arrays += [np.ascontiguousarray(a, np.float32)
                   for _k, a in plan.kernel_pool()]
        outs = [np.zeros((Ic,) + p.dimensions[1:], p.kernels[o].dtype)
                for o in p.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                               for a in arrays])
        op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
        lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                           blob.ctypes.data, lo)
        for o, got in zip(p.outputs, outs):
            w = want[o].numpy()
            core = oracle[o][c * Ic:(c + 1) * Ic]
            assert np.isfinite(got).all()
            if banded:
                assert _close(w, got, MXU_VERIFY_RTOL)
                assert _close(core, got, MXU_VERIFY_RTOL)
            else:
                np.testing.assert_array_equal(got, w)
                np.testing.assert_array_equal(got, core)


def test_local_source_calls_no_library_and_reads_the_origin():
    p = port.parse_program(PROGRAMS["box_r2"][0]())
    plan = stream.plan_local(p, None, 6, 4)
    src = stream.stream_source(plan)
    for word in ("cublas", "cudnn", "wmma", "mma.sync", "#include <cub"):
        assert word not in src.lower()
    assert "const int origin_i" in src
    assert "(origin_i + pi)" in src      # banded groups: global i masks
    whole = stream.stream_source(stream.plan_stream(p, compose="off"))
    assert "origin_i" not in whole and "sf_local" not in whole


# -- host staging -------------------------------------------------------------

def test_host_slab_pads_in_place():
    a = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    dst = torch.full((4, 2), 7.0)
    got = _host_slab(a, -1, 3, 6, dst)
    assert got is dst
    np.testing.assert_array_equal(got[0].numpy(), [0, 0])
    np.testing.assert_array_equal(got[1:].numpy(), a[:3])
    np.testing.assert_array_equal(_host_slab(a, 4, 8, 6).numpy(),
                                  np.concatenate([a[4:], np.zeros((2, 2))]))


def test_link_bytes():
    p = port.parse_program(PROGRAMS["hdiff_dag"][0]())
    _fn, plan = compile_chunked_chain(p, 4, device="cpu")
    up, down = link_bytes(p, plan)
    cells = 8 * 12 * 16
    assert down == 4 * cells * len(p.outputs)
    full = [n for n, s in p.inputs.items() if all(s.dim_mask)]
    assert up >= 4 * cells * len(full)


@pytest.mark.parametrize("body", ["dense", "stream"])
def test_memmap_in_and_out(body, tmp_path):
    """Inputs from np.memmap, outputs into caller-provided memmaps."""
    p = port.parse_program(jacobi(3, 16, iterations=2))
    inputs = port.load_input_arrays(p, seed=5)
    oracle = port.run_interpreter(p, inputs)
    name = next(iter(p.inputs))
    mm_in = np.memmap(tmp_path / "in.dat", dtype=np.float32, mode="w+",
                      shape=inputs[name].shape)
    mm_in[:] = inputs[name]
    mm_in.flush()
    ro = np.memmap(tmp_path / "in.dat", dtype=np.float32, mode="r",
                   shape=inputs[name].shape)
    out_name = p.outputs[0]
    mm_out = np.memmap(tmp_path / "out.dat", dtype=np.float32, mode="w+",
                       shape=tuple(p.raw_dimensions))
    got = run_chunked(p, {**inputs, name: ro}, 4, out={out_name: mm_out},
                      device="cpu", backend=body)
    assert got[out_name] is mm_out
    np.testing.assert_array_equal(np.asarray(mm_out), oracle[out_name])


def test_out_shape_mismatch_raises():
    p = port.parse_program(jacobi(3, 8, iterations=1))
    inputs = port.load_input_arrays(p, seed=0)
    with pytest.raises(ValueError, match="shape"):
        run_chunked(p, inputs, 2, device="cpu",
                    out={p.outputs[0]: np.empty((4, 4, 4), np.float32)})


# -- errors: the reference's messages -------------------------------------------

@pytest.mark.parametrize("spec,chunks,match", [
    (lambda: jacobi(3, 8, iterations=1), 3, "divide"),
    (lambda: jacobi(3, 8, iterations=8), 8, "halo"),
    (lambda: jacobi(2, 8, iterations=1), 2, "i extent"),
])
def test_errors_match_the_reference(spec, chunks, match):
    s = spec()
    with pytest.raises(ValueError) as want:
        ref_compile_chunked(ref.parse_program(s), chunks)
    with pytest.raises(ValueError, match=match) as got:
        compile_chunked_chain(port.parse_program(s), chunks, device="cpu")
    assert str(got.value) == str(want.value)


def test_compiled_chunk_mismatch():
    p = port.parse_program(jacobi(3, 8, iterations=1))
    inputs = port.load_input_arrays(p, seed=0)
    compiled = compile_chunked_chain(p, 2, device="cpu")
    with pytest.raises(ValueError, match="compiled for 2 chunks, got 4"):
        run_chunked(p, inputs, 4, compiled=compiled)


def test_entry_points_need_the_card(monkeypatch):
    """Built for the card by default: without one they raise, and no plain
    version runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = port.parse_program(jacobi(3, 8, iterations=1))
    with pytest.raises(RuntimeError, match="no GPU"):
        compile_chunked_chain(p, 2)
    with pytest.raises(RuntimeError, match="no GPU"):
        run_program(p, host_chunks=2, save_results=False, log_level=0)
    with pytest.raises(RuntimeError, match="no GPU"):
        stream.compile_local_stream(stream.plan_local(p, None, 4, 1))


def test_local_wrapper_refuses_whole_plans():
    p = port.parse_program(jacobi(3, 8, iterations=1))
    whole = stream.plan_stream(p, mxu="off")
    local = stream.plan_local(p, None, 4, 1)
    name = next(iter(p.inputs))
    arrays = {name: torch.zeros((6, 8, 8))}
    with pytest.raises(ValueError, match="local plan"):
        stream.run_local_stream(whole, 0, arrays)
    with pytest.raises(ValueError, match="run_local_stream"):
        stream.run_stream(local, arrays)
    with pytest.raises(ValueError, match="shape"):
        stream.run_local_stream(local, 0, {name: torch.zeros((8, 8, 8))})


# -- driver and CLI -------------------------------------------------------------

def test_run_program_host_chunks():
    spec = PROGRAMS["box_r2"][0]()
    res = run_program(spec, device="cpu", host_chunks=2,
                      compare_to_reference=True, save_results=False,
                      log_level=0, repetitions=2)
    assert res.backend == "outofcore[dense x2 chunks]"
    assert res.verified_against_reference
    assert isinstance(res.outputs["s1"], np.ndarray)


def test_cli_host_chunks(tmp_path, monkeypatch, capsys):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(3, 8, iterations=2)))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["run", str(path), "--device", "cpu", "--host-chunks", "2",
                   "--compare-to-reference"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "backend: outofcore[dense x2 chunks]" in out
    assert "transfers included" in out
    assert "verified against reference: OK" in out
    rc = cli_main(["run", str(path), "--device", "cpu", "--host-chunks", "3"])
    captured = capsys.readouterr()
    assert rc == 2
    assert "error:" in captured.err and "divide" in captured.err

"""The generated CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it also runs where those are not
installed; there, skip the jax-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: bit-exact (np.array_equal, NaN == NaN).  The kernels are built
with -fmad=false and without fast math, and none of these programs calls
a transcendental, so kernel, plain version and numpy oracle compute the
same correctly rounded operations in the same order.  The stream kernel's
banded stages sum in another order than its plain version (which applies
the bands with torch.matmul): MXU_VERIFY_RTOL there, as in the JAX
package; the same holds for the local chunk kernel K4.
"""
import json
import os

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import group, overlap, panel, stream
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _example(name, size):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


PROGRAMS = {
    "jacobi3d": lambda: _example("jacobi3d_32x32x32_8itr.json", 20),
    "hdiff": lambda: _example("hdiff_64x64x64.json", 24),
    "forked_box": lambda: _example("forked_box_chain.json", 40),
    # the fuzz generator of tests/test_fuzz.py (scalar, (k) and (i, k)
    # inputs), then float64 with shrink BCs and int32 with wraparound
    "fuzz122": lambda: random_program(np.random.default_rng(122)),
    "fuzz127": lambda: random_program(np.random.default_rng(127)),
    "fuzz_f64_shrink": lambda: random_program(
        np.random.default_rng(5), ndim=3, data_type="float64",
        bc_kinds=("constant", "copy", "shrink")),
    "fuzz_i32": lambda: random_program(
        np.random.default_rng(6), ndim=3, data_type="int32",
        data="random:-20,20"),
}
KERNELS = {"panel": (panel, panel.PanelPlan, panel.run_panel,
                     panel.panel_plain),
           "overlap": (overlap, overlap.OverlapPlan, overlap.run_overlap,
                       overlap.overlap_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_matches_plain_on_card(kernel, name, cuda):
    module, plan_cls, run, plain = KERNELS[kernel]
    p = port.parse_program(PROGRAMS[name]())
    an = port.ChainAnalysis.run(p)
    plan = plan_cls.build(an)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = module.launches
    got = run(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    want = plain(p, an, plan, arrays)
    for o in want:
        g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("iters,backend", [(2, "overlap"), (4, "panel")])
def test_run_program_on_card(iters, backend, cuda):
    """The main path picks the kernel and matches the numpy oracle."""
    p = port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=(40, 48, 72), shape="diffusion",
        seed_data="random:0,1"))
    res = run_program(p, device=cuda, compare_to_reference=True,
                      save_results=False, log_level=0)
    assert res.backend == backend and res.verified_against_reference
    oracle = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    np.testing.assert_array_equal(res.outputs[p.outputs[0]],
                                  oracle[p.outputs[0]])


STREAM_PROGRAMS = {
    "box_r1_composed": lambda: synthesize_stencil(
        num_stages=4, dimensions=(40, 48, 72), shape="box", extent=1,
        seed_data="random:0,1"),
    "box_r2_bc07": lambda: synthesize_stencil(
        num_stages=3, dimensions=(40, 48, 72), shape="box", extent=2,
        boundary_value=0.7, seed_data="random:0,1"),
    "box_shrink": lambda: synthesize_stencil(
        num_stages=3, dimensions=(40, 48, 72), shape="box", extent=1,
        boundary="shrink", seed_data="random:0,1"),
    "cross_r2": lambda: synthesize_stencil(
        num_stages=4, dimensions=(40, 48, 72), shape="cross", extent=2,
        seed_data="random:0,1"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STREAM_PROGRAMS))
def test_stream_kernel_matches_plain_on_card(name, cuda):
    p = port.parse_program(STREAM_PROGRAMS[name]())
    plan = stream.plan_stream(p)
    assert plan.mxu_plans
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.launches
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    want = stream.stream_plain(plan, arrays)
    for o in want:
        g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        assert np.isfinite(g).all()
        assert port.arrays_are_equal(w, g, MXU_VERIFY_RTOL)


@pytest.mark.cuda
def test_run_program_stream_on_card(cuda):
    """A wide affine chain takes the stream kernel and matches the oracle
    at MXU_VERIFY_RTOL."""
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(40, 48, 72), shape="box", extent=2,
        seed_data="random:0,1"))
    res = run_program(p, device=cuda, compare_to_reference=True,
                      save_results=False, log_level=0)
    assert res.backend == "stream" and res.verified_against_reference


def _jacobi2d(bc="constant", shape="diffusion", iters=8):
    return synthesize_stencil(num_stages=iters, dimensions=(256, 192),
                              shape=shape, boundary=bc,
                              seed_data="random:0,1")


# name: (spec, rotate to rows, B, g)
GROUP_PROGRAMS = {
    "rows_jacobi2d_constant": (lambda: _jacobi2d(), True, 64, 8),
    "rows_jacobi2d_copy": (lambda: _jacobi2d("copy"), True, 64, 8),
    "rows_jacobi2d_shrink": (lambda: _jacobi2d("shrink"), True, 64, 8),
    "rows_hotspot2d": (lambda: _jacobi2d(shape="hotspot"), True, 64, 8),
    "fuzz_f64_shrink": (lambda: random_program(
        np.random.default_rng(5), ndim=3, data_type="float64",
        bc_kinds=("constant", "copy", "shrink")), False, 0, 2),
    "fuzz122": (lambda: random_program(np.random.default_rng(122)), False,
                0, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GROUP_PROGRAMS))
def test_group_kernel_matches_plain_on_card(name, cuda):
    make, rows, B, g = GROUP_PROGRAMS[name]
    p0 = port.parse_program(make())
    p = rotate_2d_to_rows(p0) if rows else p0
    an = port.ChainAnalysis.run(p)
    plan = group.plan_group(p, an, B, g)
    arrays = spanned_arrays(p, port.load_input_arrays(p0, seed=4),
                            device=cuda)
    before = group.launches
    got = group.run_group(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert group.launches == before + 1
    want = group.group_plain(p, an, plan, arrays)
    for o in want:
        g_, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        assert g_.dtype == w.dtype
        np.testing.assert_array_equal(g_, w)


def _chunks(p, inputs, chunks, plan, device):
    """(origin, slabs on ``device``) of every chunk of a local plan."""
    from stencilflow_tpu_torch.outofcore import _host_slab
    I = p.dimensions[0]
    Ii = plan.extent()
    for c in range(chunks):
        lo = c * plan.block - plan.halo_i
        slabs = {}
        for n, s in p.inputs.items():
            a = np.asarray(inputs[n])
            if s.is_scalar:
                slabs[n] = torch.as_tensor(a)
            elif s.dim_mask[0]:
                slabs[n] = _host_slab(a, lo, lo + Ii, I).to(device)
            else:
                slabs[n] = torch.as_tensor(a).to(device)
        yield lo, slabs


# name: (spec, chunks)
LOCAL_PROGRAMS = {
    "jacobi3d_shrink_c4": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(64, 40, 72), shape="diffusion",
        boundary="shrink", seed_data="random:0,1"), 4),
    "box_r2_c2": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(40, 48, 72), shape="box", extent=2,
        seed_data="random:0,1"), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LOCAL_PROGRAMS))
def test_local_kernel_matches_plain_on_card(name, cuda):
    """K4 chunk by chunk against local_stream_plain: bit-exact per cell,
    MXU_VERIFY_RTOL with banded stages."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    make, chunks = LOCAL_PROGRAMS[name]
    p = port.parse_program(make())
    an = port.ChainAnalysis.run(p)
    plan = stream.plan_local(p, an, p.dimensions[0] // chunks,
                             chain_halo(an)[0])
    lib = stream.build_stream(plan)
    inputs = port.load_input_arrays(p, seed=4)
    for lo, slabs in _chunks(p, inputs, chunks, plan, cuda):
        before = stream.local_launches
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.local_launches == before + 1
        want = stream.local_stream_plain(plan, lo, slabs)
        for o in want:
            g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
            assert np.isfinite(g).all()
            if plan.mxu_plans:
                assert port.arrays_are_equal(w, g, MXU_VERIFY_RTOL)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_run_chunked_matches_in_core_on_card(cuda):
    """jacobi3d 128^3 x 4 through 4 host chunks (K4) equals the in-core
    route bit for bit."""
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(128,) * 3, shape="diffusion",
        seed_data="random:0,1"))
    res = run_program(p, device=cuda, save_results=False, log_level=0)
    before = stream.local_launches
    oc = run_program(p, device=cuda, host_chunks=4, save_results=False,
                     log_level=0)
    assert oc.backend == "outofcore[stream x4 chunks]"
    assert stream.local_launches == before + 2 * 4   # warm-up + 1 run
    np.testing.assert_array_equal(oc.outputs[p.outputs[0]],
                                  res.outputs[p.outputs[0]])


@pytest.mark.cuda
def test_local_build_failure_raises(cuda, monkeypatch):
    """A K4 that does not build raises: no plain version, no dense body."""
    from stencilflow_tpu_torch.backend import build
    from stencilflow_tpu_torch.outofcore import run_chunked
    ran = []
    monkeypatch.setattr(stream, "stream_source",
                        lambda plan: "this is not C++\n")
    monkeypatch.setattr(stream, "stream_plain",
                        lambda *a, **k: ran.append(1))
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(16, 16, 16), shape="diffusion"))
    with pytest.raises(build.KernelBuildError):
        run_chunked(p, port.load_input_arrays(p, seed=0), 2, device=cuda)
    assert ran == []


@pytest.mark.cuda
def test_run_program_rows_group_on_card(cuda):
    """A deep 2-D chain routes to rows+group_g8 and equals the oracle."""
    p = port.parse_program(_jacobi2d())
    res = run_program(p, device=cuda, compare_to_reference=True,
                      save_results=False, log_level=0)
    assert res.backend == "rows+group_g8" and res.verified_against_reference
    oracle = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    np.testing.assert_array_equal(res.outputs[p.outputs[0]],
                                  oracle[p.outputs[0]])


def reconvergent_chain(stages=16, dims=(12, 24, 32), bc="constant"):
    """A deep chain whose last stage reads the first again: one ring far
    deeper than its read count (the JAX package's spill fixture)."""
    prog, prev = {}, "a"
    for s in range(stages):
        expr = (f"s{s} = 0.16 * ({prev}[i-1,j,k] + {prev}[i+1,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k-1] + "
                f"{prev}[i,j,k+1])")
        fields = {prev}
        if s == stages - 1:
            expr += " + 0.1 * s0[i,j,k]"
            fields.add("s0")
        cond = {"type": "constant", "value": 0.2} if bc == "constant" \
            else {"type": bc}
        prog[f"s{s}"] = {"computation_string": expr,
                         "boundary_conditions": {f: dict(cond)
                                                 for f in fields},
                         "data_type": "float32"}
        prev = f"s{s}"
    return {"inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims), "program": prog}


# name: (spec, smem_budget): every ring spilled at budget 0
SPILL_PROGRAMS = {
    "reconvergent": (lambda: reconvergent_chain(), 40000),
    "reconvergent_copy": (lambda: reconvergent_chain(12, bc="copy"), 0),
    "jacobi3d_shrink": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(24, 40, 72), shape="diffusion",
        boundary="shrink", seed_data="random:0,1"), 0),
    "hdiff_dag": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 40, 72), shape="hdiff"), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPILL_PROGRAMS))
def test_spill_kernel_matches_plain_on_card(name, cuda):
    """K3c: the stream kernel with rings spilled to device memory equals
    its plain version bit for bit."""
    make, budget = SPILL_PROGRAMS[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, smem_budget=budget)
    assert plan.spilled and plan.smem_bytes() <= budget
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.spill_launches
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.spill_launches == before + 1
    want = stream.stream_plain(plan, arrays)
    for o in want:
        np.testing.assert_array_equal(got[o].cpu().numpy(),
                                      want[o].cpu().numpy())


@pytest.mark.cuda
def test_local_spill_kernel_matches_plain_on_card(cuda):
    """K4 with every ring spilled, chunk by chunk at 4 chunks."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(64, 40, 72), shape="diffusion",
        boundary="copy", seed_data="random:0,1"))
    an = port.ChainAnalysis.run(p)
    plan = stream.plan_local(p, an, 16, chain_halo(an)[0], smem_budget=0)
    assert plan.spilled
    lib = stream.build_stream(plan)
    inputs = port.load_input_arrays(p, seed=4)
    for lo, slabs in _chunks(p, inputs, 4, plan, cuda):
        before = stream.spill_launches
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.spill_launches == before + 1
        want = stream.local_stream_plain(plan, lo, slabs)
        for o in want:
            np.testing.assert_array_equal(got[o].cpu().numpy(),
                                          want[o].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["masked", "fast"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tile_kernel_matches_plain_on_card(name, mode, cuda):
    """K6, the overlapped-tile kernel, equals its plain version."""
    from stencilflow_tpu_torch.backend import tile
    p = port.parse_program(PROGRAMS[name]())
    plan = tile.plan_tile(p, mode=mode)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = tile.launches
    got = tile.run_tile(plan, arrays)
    torch.cuda.synchronize()
    assert tile.launches == before + 1
    want = tile.tile_plain(plan, arrays)
    for o in want:
        g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_run_program_tile_on_card(cuda):
    """``run --backend tile`` reaches K6 and matches the oracle."""
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(40, 48, 72), shape="diffusion",
        seed_data="random:0,1"))
    res = run_program(p, device=cuda, backend="tile",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "tile" and res.verified_against_reference
    oracle = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    np.testing.assert_array_equal(res.outputs[p.outputs[0]],
                                  oracle[p.outputs[0]])

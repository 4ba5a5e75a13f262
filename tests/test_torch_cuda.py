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


# the panel cells of chip_smoke.py (jacobi3d 512^3 x 8, hdiff3d and
# hotspot3d 256^3 x 8) at a reduced size, at tiles of their full-size
# plans, each with blocks that take the mask-free bodies
PANEL_CELLS = {
    "jacobi3d": (("diffusion", (16, 64, 96), 8), (16, 32)),
    "hdiff3d": (("hdiff", (10, 96, 96), 8), (16, 16)),
    "hdiff3d_16x32": (("hdiff", (10, 112, 128), 8), (16, 32)),
    "hotspot3d": (("hotspot", (12, 64, 64), 8), (16, 16)),
}


def _panel_matches_plain(p, plan, cuda):
    an = port.ChainAnalysis.run(p)
    lib = panel.build_panel(p, an, plan)
    assert panel.occupancy(lib) >= 1
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = panel.launches
    got = panel.run_panel(p, an, plan, arrays, lib)
    torch.cuda.synchronize()
    assert panel.launches == before + 1
    want = panel.panel_plain(p, an, plan, arrays)
    for o in want:
        np.testing.assert_array_equal(got[o].cpu().numpy(),
                                      want[o].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PANEL_CELLS))
def test_panel_cell_plans_match_plain_on_card(name, cuda):
    """K1 on the panel cells' programs at a reduced size: boundary and
    mask-free blocks, rings of one step packed, input planes by
    cp.async, bit for bit against its plain version."""
    (shape, dims, iters), tile = PANEL_CELLS[name]
    p = port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=dims, shape=shape,
        seed_data="random:0,1"))
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p), tile)
    assert plan.inner_blocks(p) > 0
    if shape == "hdiff":
        assert plan.smem_bytes(p) < plan.unpacked_bytes(p)
    _panel_matches_plain(p, plan, cuda)


@pytest.mark.cuda
def test_rows_panel_plan_matches_plain_on_card(cuda):
    """K1 on a rows+panel plan (J = 1, tiles (1, tk))."""
    p = rotate_2d_to_rows(port.parse_program(synthesize_stencil(
        num_stages=6, dimensions=(96, 640), shape="diffusion",
        seed_data="random:0,1")))
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p))
    assert plan.tile[0] == 1 and p.dimensions[1] == 1
    _panel_matches_plain(p, plan, cuda)


@pytest.mark.cuda
def test_panel_build_failure_raises(cuda, monkeypatch):
    """A K1 that does not build raises: no plain version, no
    synchronous-load variant."""
    from stencilflow_tpu_torch.backend import build, codegen
    ran = []
    monkeypatch.setattr(codegen, "panel_source",
                        lambda *a, **k: "this is not C++\n")
    monkeypatch.setattr(panel, "panel_plain",
                        lambda *a, **k: ran.append(1))
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(16, 16, 16), shape="diffusion"))
    with pytest.raises(build.KernelBuildError):
        panel.compile_chain_panel(p, device=cuda)(
            port.load_input_arrays(p, seed=0))
    assert ran == []


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


@pytest.mark.cuda
@pytest.mark.parametrize("name,segments", [
    ("rows_jacobi2d_constant", 4), ("rows_jacobi2d_copy", 2),
    ("rows_jacobi2d_shrink", 3), ("rows_hotspot2d", 2), ("fuzz122", 3)])
def test_group_segments_match_plain_on_card(name, segments, cuda):
    """K5 with its panels cut into i-segments (one block per segment and
    tile, each warming its rings up) equals its plain version and the
    oracle."""
    make, rows, B, g = GROUP_PROGRAMS[name]
    p0 = port.parse_program(make())
    p = rotate_2d_to_rows(p0) if rows else p0
    an = port.ChainAnalysis.run(p)
    if not B:
        B = 2 if p.dimensions[0] % 2 == 0 else 1
    plan = group.plan_group(p, an, B, g, segments=segments)
    assert plan.segments > 1
    inputs = port.load_input_arrays(p0, seed=4)
    arrays = spanned_arrays(p, inputs, device=cuda)
    before = group.launches
    got = group.run_group(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert group.launches == before + 1
    want = group.group_plain(p, an, plan, arrays)
    oracle = port.run_interpreter(p0, inputs)
    for o in want:
        g_ = got[o].cpu().numpy()
        np.testing.assert_array_equal(g_, want[o].cpu().numpy())
        np.testing.assert_array_equal(g_.reshape(oracle[o].shape), oracle[o])


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


def _mma_probe_libs(tmp_path):
    """``codegen.mma_probe_source`` built by nvcc (the card) and by g++
    (its host version)."""
    import ctypes
    import shutil
    import subprocess
    from stencilflow_tpu_torch.backend import build, codegen
    src = codegen.mma_probe_source()
    dev = build.load_library(src, "mma_probe")
    gxx = shutil.which("g++") or shutil.which("c++")
    assert gxx, "the card's machine has no host C++ compiler"
    cpp, so = tmp_path / "probe.cpp", tmp_path / "probe.so"
    cpp.write_text(src)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dev, ctypes.CDLL(str(so))


@pytest.mark.cuda
def test_mma_band_matches_host_version_on_card(cuda, tmp_path):
    """``sf_mma_band`` on tensor cores (mma.sync TF32, hi/lo split, three
    products) against its host version on one tile: a 5- and a 33-tap
    band from a weight vector, a 33- and a 41-tap band from a table.  The
    two sum the same products in another order: each element within
    1e-6 of the sum of its products' magnitudes."""
    import ctypes
    dev, host = _mma_probe_libs(tmp_path)
    rng = np.random.default_rng(11)
    for taps, ks, table in ((5, 2, False), (33, 5, False), (33, 5, True),
                            (41, 6, True)):
        x = rng.standard_normal((16, 8 * ks)).astype(np.float32)
        w = rng.standard_normal((taps, 8) if table else (taps,)).astype(
            np.float32)
        args = [8 * ks, 1, 16, 8 * ks, 8 if table else 1,
                1 if table else 0, taps, ks]
        want = np.zeros((16, 8), np.float32)
        host.sf_mma_probe_host.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 8
        assert host.sf_mma_probe_host(x.ctypes.data, w.ctypes.data,
                                      want.ctypes.data, *args) == 0
        xt, wt = torch.as_tensor(x).to(cuda), torch.as_tensor(w).to(cuda)
        dt = torch.zeros((16, 8), dtype=torch.float32, device=cuda)
        dev.sf_mma_probe.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        assert dev.sf_mma_probe(xt.data_ptr(), wt.data_ptr(),
                                dt.data_ptr(), *args,
                                torch.cuda.current_stream(cuda).cuda_stream
                                ) == 0
        torch.cuda.synchronize()
        got = dt.cpu().numpy()
        band = np.zeros((8 * ks, 8), np.float32)
        for m in range(8 * ks):
            for n in range(8):
                if 0 <= m - n < taps:
                    band[m, n] = w[m - n, n] if table else w[m - n]
        scale = np.abs(x) @ np.abs(band)
        assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30), \
            (taps, np.max(np.abs(got - want) / (scale + 1e-30)))


# (program, planner options): the on-chip body per cell (K3a, bit-exact)
# and banded on each route (K3b: CUDA-core passes, tensor-core passes
# under "split", and "exact")
ONCHIP = {
    "jacobi_copy_k3a": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(40, 48, 72), shape="diffusion",
        boundary="copy", seed_data="random:0,1"),
        {"mxu": "off", "spill": "off"}),
    "hdiff_k3a": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(12, 52, 72), shape="hdiff",
        seed_data="random:0,1"), {"mxu": "off", "spill": "off"}),
}
ONCHIP_BANDED = dict(STREAM_PROGRAMS, box_r2=lambda: synthesize_stencil(
    num_stages=4, dimensions=(40, 48, 72), shape="box", extent=2,
    seed_data="random:0,1"))
for _name in ("box_r2", "box_r2_bc07", "cross_r2"):
    for _route, _kw in (("fma", {"passes": "fma"}),
                        ("mma", {"passes": "mma"}),
                        ("exact", {"mxu_precision": "exact"})):
        ONCHIP[f"{_name}_{_route}"] = (ONCHIP_BANDED[_name], _kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONCHIP))
def test_onchip_stream_matches_plain_on_card(name, cuda):
    make, kw = ONCHIP[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, **kw)
    assert not plan.packed and bool(plan.mxu_plans) == ("mxu" not in kw)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.launches
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    want = stream.stream_plain(plan, arrays)
    for o in want:
        g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        if plan.mxu_plans:
            assert np.isfinite(g).all()
            assert port.arrays_are_equal(w, g, MXU_VERIFY_RTOL)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", ["fma", "mma"])
def test_local_banded_routes_match_plain_on_card(passes, cuda):
    """K4 with per-stage banded stages on either route, chunk by chunk."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(48, 48, 72), shape="cross", extent=2,
        seed_data="random:0,1"))
    an = port.ChainAnalysis.run(p)
    plan = stream.plan_local(p, an, 16, chain_halo(an)[0], passes=passes)
    assert plan.mxu_plans and not plan.packed
    lib = stream.build_stream(plan)
    inputs = port.load_input_arrays(p, seed=4)
    for lo, slabs in _chunks(p, inputs, 3, plan, cuda):
        got = stream.run_local_stream(plan, lo, slabs, lib)
        want = stream.local_stream_plain(plan, lo, slabs)
        for o in want:
            g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
            assert np.isfinite(g).all()
            assert port.arrays_are_equal(w, g, MXU_VERIFY_RTOL)


@pytest.mark.cuda
def test_stream_build_failure_raises(cuda, monkeypatch):
    """A K3b that does not build raises: no plain version."""
    from stencilflow_tpu_torch.backend import build
    ran = []
    monkeypatch.setattr(stream, "stream_source",
                        lambda plan: "this is not C++\n")
    monkeypatch.setattr(stream, "stream_plain",
                        lambda *a, **k: ran.append(1))
    p = port.parse_program(ONCHIP_BANDED["cross_r2"]())
    with pytest.raises(build.KernelBuildError):
        stream.compile_chain_stream(p, device=cuda)(
            port.load_input_arrays(p, seed=0))
    assert ran == []


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


# name: (spec, planner options): spill="all" spills every ring read at an
# earlier step, whatever the budget (hdiff's rings all live within one)
SPILL_PROGRAMS = {
    "reconvergent": (lambda: reconvergent_chain(), {"smem_budget": 40000}),
    "reconvergent_copy": (lambda: reconvergent_chain(12, bc="copy"),
                          {"spill": "all"}),
    "jacobi3d_shrink": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(24, 40, 72), shape="diffusion",
        boundary="shrink", seed_data="random:0,1"), {"spill": "all"}),
    "hdiff_dag": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 40, 72), shape="hdiff"),
        {"spill": "all"}),
    "hotspot_deep": (lambda: synthesize_stencil(
        num_stages=32, dimensions=(40, 40, 72), shape="hotspot"),
        {"spill": "all"}),
    "jacobi3d_deep": (lambda: synthesize_stencil(
        num_stages=12, dimensions=(40, 96, 136), shape="diffusion",
        seed_data="random:0,1"), {"smem_budget": 20000}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPILL_PROGRAMS))
def test_spill_kernel_matches_plain_on_card(name, cuda):
    """K3c: the stream kernel of the spill rung (staging planes, bulk
    stores and mbarrier-completed bulk loads) equals its plain version
    bit for bit."""
    make, kw = SPILL_PROGRAMS[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, **kw)
    assert plan.packed and (plan.spilled or name == "hdiff_dag")
    assert plan.smem_bytes() <= kw.get("smem_budget",
                                       stream.H100_SMEM_PER_BLOCK)
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
    plan = stream.plan_local(p, an, 16, chain_halo(an)[0], spill="all")
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
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tile_fast_equals_masked_and_oracle_on_card(name, cuda):
    """K6's fast mode is one launch (mask-free interior blocks, masked
    border blocks, no fix-up) and equals masked mode and the oracle."""
    from stencilflow_tpu_torch.backend import tile
    p = port.parse_program(PROGRAMS[name]())
    inputs = port.load_input_arrays(p, seed=4)
    arrays = spanned_arrays(p, inputs, device=cuda)
    oracle = port.run_interpreter(p, inputs)
    got = {}
    for mode in ("masked", "fast"):
        plan = tile.plan_tile(p, mode=mode)
        before = tile.launches
        got[mode] = tile.run_tile(plan, arrays)
        torch.cuda.synchronize()
        assert tile.launches == before + 1
    for o in oracle:
        f, m = got["fast"][o].cpu().numpy(), got["masked"][o].cpu().numpy()
        np.testing.assert_array_equal(f, m)
        np.testing.assert_array_equal(f.reshape(oracle[o].shape), oracle[o])


# K2's redesigned schedule on the card: (program maker, plan options) --
# several blocks along i (constant, copy and shrink BCs, register windows
# and runs of j cells, the skeleton alone), the I = 1 regime, an integer
# program and hotspot's two streamed inputs and scalars
OVERLAP_CASES = {
    "jacobi3d-R4": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(24, 40, 72), shape="diffusion",
        seed_data="random:0,1"), dict(tile=(4, 8, 32), R=4, window=True)),
    "jacobi3d-copy-R2": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(20, 40, 72), shape="diffusion",
        boundary="copy", seed_data="random:0,1"),
        dict(tile=(2, 16, 32), R=2, window=True)),
    "jacobi3d-shrink-skeleton": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(18, 40, 72), shape="diffusion",
        boundary="shrink", seed_data="random:0,1"),
        dict(tile=(4, 8, 32), R=1, window=False)),
    "jacobi3d-R1-window": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(16, 40, 72), shape="diffusion",
        seed_data="random:0,1"), dict(tile=(4, 8, 32), R=1, window=True)),
    "hotspot3d-R4": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(16, 48, 64), shape="hotspot",
        seed_data="random:0,1"), dict(tile=(4, 16, 16), R=4, window=True)),
    "hotspot3d-R2-ragged": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(20, 48, 64), shape="hotspot",
        seed_data="random:0,1"), dict(tile=(8, 16, 16), R=2, window=True)),
    "jacobi3d-copy-R2-ragged": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(20, 42, 72), shape="diffusion",
        boundary="copy", seed_data="random:0,1"),
        dict(tile=(8, 8, 32), R=2, window=True)),
    "jacobi2d-I1": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(96, 200), shape="diffusion",
        seed_data="random:0,1"), dict(R=4, window=True)),
    "fuzz_i32": (lambda: random_program(
        np.random.default_rng(6), ndim=3, data_type="int32",
        data="random:-20,20"), dict(tile=(2, 4, 8), R=4, window=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OVERLAP_CASES))
def test_overlap_schedule_matches_plain_on_card(name, cuda):
    """K2 (cp.async input windows, mask-free and masked bodies, register
    windows) equals its plain version and the oracle bit for bit."""
    make, kw = OVERLAP_CASES[name]
    p = port.parse_program(make())
    an = port.ChainAnalysis.run(p)
    plan = overlap.OverlapPlan.build(an, **kw)
    inputs = port.load_input_arrays(p, seed=4)
    arrays = spanned_arrays(p, inputs, device=cuda)
    lib = overlap.build_overlap(p, an, plan)
    assert panel.occupancy(lib) >= 1
    before = overlap.launches
    got = overlap.run_overlap(p, an, plan, arrays, lib)
    torch.cuda.synchronize()
    assert overlap.launches == before + 1
    want = overlap.overlap_plain(p, an, plan, arrays)
    oracle = port.run_interpreter(p, inputs)
    for o in want:
        g = got[o].cpu().numpy()
        np.testing.assert_array_equal(g, want[o].cpu().numpy())
        np.testing.assert_array_equal(g.reshape(oracle[o].shape), oracle[o])


@pytest.mark.cuda
def test_overlap_input_at_a_storage_offset_matches_plain_on_card(cuda):
    """An input that starts 4 bytes off a 16-byte boundary (a contiguous
    view at a storage offset) still loads by 16-byte copies: the wrapper
    copies it into fresh storage, and the result equals the plain
    version."""
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(16, 24, 32), shape="diffusion",
        seed_data="random:0,1"))
    an = port.ChainAnalysis.run(p)
    plan = overlap.OverlapPlan.build(an)
    assert plan.vec == {"a": 4}
    a = port.load_input_arrays(p, seed=5)["a"]
    flat = torch.empty(a.size + 1, dtype=torch.float32, device=cuda)
    view = flat[1:].view(16, 24, 32)
    view.copy_(torch.as_tensor(a.reshape(16, 24, 32)))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    fn = overlap.compile_chain_overlap(p, an)
    got = fn({"a": view})
    torch.cuda.synchronize()
    want = overlap.overlap_plain(p, an, fn.plan, {"a": view.clone()})
    for o in want:
        np.testing.assert_array_equal(got[o].reshape(want[o].shape)
                                      .cpu().numpy(), want[o].cpu().numpy())


def float16_chain(shape, extent):
    return synthesize_stencil(num_stages=4, dimensions=(12, 12, 12),
                              shape=shape, extent=extent,
                              data_type="float16",
                              seed_data="random:0.0,1.0")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,extent", [("box", 1), ("cross", 2),
                                          ("diffusion", 1)])
def test_float16_dense_matches_oracle_on_card(shape, extent, cuda):
    """float16 runs on ``dense`` on the card (the kernels refuse it), one
    op at a time in float32 rounded to float16, as numpy does: equal to
    the oracle bit for bit (tests/test_torch_float16.py on the CPU)."""
    p = port.parse_program(float16_chain(shape, extent))
    res = run_program(p, device=cuda, save_results=False, log_level=0)
    assert res.backend == "dense"
    oracle = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    for o in oracle:
        got = np.asarray(res.outputs[o]).reshape(oracle[o].shape)
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got, oracle[o])


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


# -- the probes (P1, P4, P7) and the bench ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode,vec", [
    ((3, 17, 33), "flat", 1), ((3, 17, 33), "flat", 4),
    ((3, 17, 33), "tile", 1), ((5, 24, 40), "tile", 4),
    ((16, 512, 512), "flat", 4)])
def test_copy_probe_on_card(shape, mode, vec, cuda):
    """P4's kernel returns its input bit for bit, ragged edges too."""
    from stencilflow_tpu_torch.probes import copy_floor
    x = torch.rand(shape, device=cuda)
    before = copy_floor.launches
    out = copy_floor.copy(x, torch.full_like(x, float("nan")), mode=mode,
                          vec=vec, grid=3)
    torch.cuda.synchronize()
    assert torch.equal(out, x) and copy_floor.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "fma", "fma_fused", "div", "sqrt",
                                "select", "min", "abs", "sin", "exp",
                                "add8", "expr_hs"])
def test_alu_probe_matches_plain_on_card(op, cuda):
    """P1's kernel equals its plain version: bit-exact, or within
    ``alu_ceiling.TOLERANCE`` where stated."""
    from stencilflow_tpu_torch.probes import alu_ceiling
    x = alu_ceiling.inputs(1000, cuda)
    for steps in (1, 3):
        got = alu_ceiling.alu(op, x, steps)
        torch.cuda.synchronize()
        ok, err = alu_ceiling.compare(op, got,
                                      alu_ceiling.alu_plain(op, x, steps))
        assert ok, f"{op}: max abs diff {err}"
    got = alu_ceiling.alu("add", x, 2, smem=True)
    torch.cuda.synchronize()
    assert torch.equal(got, alu_ceiling.alu_plain("add", x, 2))


@pytest.mark.cuda
def test_loop_copy_graph_on_card(cuda):
    """P7's loop, eager and replayed from a CUDA graph, ends on the input
    values; its launches count in P4's wrapper."""
    from stencilflow_tpu_torch.probes import (copy_floor, differenced_ms,
                                              loop_copy)
    a = torch.rand(4, 32, 64, device=cuda)
    keep = a.clone()
    b = torch.empty_like(a)
    before = copy_floor.launches
    ms = differenced_ms(lambda n: loop_copy.loop(a, b, n, 2), 2, 4, 2,
                        graph=True)
    # the warm-up (4 launches) and the two captures (4 + 8): replays
    # launch from the graphs, not from the wrapper
    assert copy_floor.launches - before == 16
    assert np.isfinite(ms) and torch.equal(a, keep) and torch.equal(b, keep)


@pytest.mark.cuda
def test_bench_on_card(cuda, capsys):
    """The bench at a small size: one JSON line, every bound fraction at
    most 1 (a fraction above 1 would mean the yardstick is wrong)."""
    from stencilflow_tpu_torch import bench
    assert bench.main(["--workload", "jacobi", "--size", "64",
                       "--sessions", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"].startswith("jacobi3d_64^3_8itr_")
    assert rec["value"] > 0 and 0 < rec["vs_baseline"] <= 1.0
    assert rec["bounds"] and all(0 < v <= 1.0
                                 for v in rec["bounds"].values())
    assert rec["device"]["name"] and len(rec["session_clocks"]) == 2


# -- the probes P6, P3, P2 and P5 -------------------------------------------

# ragged: J not a multiple of the 8-row tile, K of the 32-unit tile (float4
# units at K = 200, scalar at K = 37), P not a multiple of the 32-plane
# chunk; then the main shape
PLANE_SHAPES = [(45, 37, 200), (13, 19, 37), (512, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLANE_SHAPES)
@pytest.mark.parametrize("bps", [1, 0])
def test_dma_overlap_probe_matches_plain_on_card(shape, bps, cuda):
    """P6's out and acc equal the plain version bit for bit."""
    from stencilflow_tpu_torch.probes import dma_overlap as do
    x = torch.rand(shape, device=cuda) * 0.5 + 0.5
    for mode in do.MODES:
        before = do.launches
        out, acc = do.overlap(x, mode, 16, blocks_per_sm=bps)
        torch.cuda.synchronize()
        want, want_acc = do.overlap_plain(x, mode, 16)
        assert torch.equal(out, want) and do.launches == before + 1
        if mode == "indep":
            assert torch.equal(acc, want_acc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLANE_SHAPES)
@pytest.mark.parametrize("bps", [1, 0])
def test_async_ring_probe_matches_plain_on_card(shape, bps, cuda):
    """P3: ring == direct == plain, bit for bit, for every S."""
    from stencilflow_tpu_torch.probes import async_ring as ar
    x = torch.rand(shape, device=cuda) * 0.5 + 0.5
    want = ar.ring_plain(x, 16)
    before = ar.launches
    for mode, s in ar.cases():
        got = ar.ring(x, 16, mode, s, torch.full_like(x, float("nan")),
                      blocks_per_sm=bps)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (mode, s)
    assert ar.launches == before + len(ar.cases())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(ntab=7, noff=5, rows=64, cols=256,
                                        steps=9),
                                   dict(ntab=33, noff=33, rows=5, cols=37,
                                        steps=41),
                                   dict(ntab=33, noff=33, rows=256,
                                        cols=256, steps=256)])
def test_table_read_probe_matches_plain_on_card(shape, cuda):
    """P2: every variant equals the plain version bit for bit (the
    TPU's shape, a ragged one and the timed one)."""
    from stencilflow_tpu_torch.probes import table_read as tr
    tab, x = tr.inputs(shape["ntab"], shape["noff"], shape["rows"],
                       shape["cols"], device=cuda)
    want = tr.table_read_plain(tab, x, shape["steps"])
    for v in tr.VARIANTS:
        before = tr.launches
        got = tr.table_read(tab, x, shape["steps"], v,
                            torch.full_like(want, float("nan")))
        torch.cuda.synchronize()
        assert torch.equal(got, want), v
        assert tr.launches - before == (
            len(tr.row_runs(shape["steps"], shape["ntab"]))
            if v == "param" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B,tile", [((37, 45, 70), 8, (16, 32)),
                                          ((20, 9, 100), 4, (8, 64)),
                                          ((512, 512, 512), 8, (16, 32))])
def test_stateless_panel_probe_matches_plain_on_card(shape, B, tile, cuda):
    """P5 in every walk equals the plain version bit for bit; the
    persistent walks, which reuse a block's shared memory box after box,
    several times over, so a race between boxes shows."""
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    x = torch.rand(shape, device=cuda) * 0.5 + 0.5
    want = sp.panel_plain(x)
    for walk in sp.WALKS:
        for rep in range(1 if walk == "box" else 8):
            got = sp.panel(x, torch.full_like(x, float("nan")), B, tile,
                           walk)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (walk, rep)


@pytest.mark.cuda
def test_stateless_panel_probe_equals_k2_on_card(cuda):
    """The shared StencilFlow program through the overlap kernel (K2)
    equals P5 bit for bit."""
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    shape = (40, 48, 72)
    x = torch.rand(shape, device=cuda) * 0.5 + 0.5
    before = overlap.launches
    got = sp.overlap_k2(shape)(x)
    torch.cuda.synchronize()
    assert overlap.launches == before + 1
    assert torch.equal(got, sp.panel(x))


@pytest.mark.cuda
def test_probe_launch_refused_for_shared_memory_raises(cuda):
    """A launch asking for more shared memory than a block may have never
    runs: the wrapper raises (P5's box of 66^3 stage-1 values, 1.15 MB);
    a ring larger than a residency cap leaves is refused before it."""
    from stencilflow_tpu_torch.probes import async_ring as ar
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    x = torch.rand(4, 16, 64, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        sp.panel(x, B=64, tile=(64, 64))
    with pytest.raises(ValueError):
        ar.ring(x, 4, slots=4, blocks_per_sm=16)   # ring above the cap


# -- the solver entry points: iterate (CUDA graphs), grad, solve -------------

def _eager_steps(program, inputs, steps, feed=None, fuse=1):
    """Eager stepping on the card through make_step (no graph)."""
    from stencilflow_tpu_torch.iterate import compose_iterations, make_step
    if fuse > 1:
        program = compose_iterations(program, fuse, feed)
    step, feed = make_step(program, feed, device="cuda")
    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in inputs.items()}
    for _ in range(steps // fuse):
        state = step(state)
    return {k: state[k].cpu().numpy() for k in feed}


def _gray_scott(n):
    lap = ("({f}[j-1, k] + {f}[j+1, k] + {f}[j, k-1] + {f}[j, k+1] "
           "- 4.0 * {f}[j, k])")
    bc = {t: {"type": "copy"} for t in ("u", "v")}
    return port.parse_program({
        "inputs": {"u": {"data": "random:0.4,1.0", "data_type": "float32"},
                   "v": {"data": "random:0.0,0.3", "data_type": "float32"}},
        "outputs": ["u1", "v1"], "dimensions": [n, n],
        "program": {
            "u1": {"computation_string":
                   "u1 = u[j, k] + 0.16 * " + lap.format(f="u") +
                   " - u[j, k] * v[j, k] * v[j, k] + 0.0545 * "
                   "(1.0 - u[j, k])",
                   "boundary_conditions": bc, "data_type": "float32"},
            "v1": {"computation_string":
                   "v1 = v[j, k] + 0.08 * " + lap.format(f="v") +
                   " + u[j, k] * v[j, k] * v[j, k] - 0.1165 * v[j, k]",
                   "boundary_conditions": bc, "data_type": "float32"}}},
        name="gray_scott")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # chunks of 4, 4, 2 (a remainder); fused, 3, 3, 1; 4, 2 (a checkpoint
    # boundary), 4; a two-field feed, fused, one chunk; the dense
    # lowering (its constants written by fill kernels) in the graph
    dict(fuse=1, chunk=4, steps=10, replays=3),
    dict(fuse=1, chunk=4, steps=6, backend="dense", replays=2),
    dict(fuse=2, chunk=3, steps=14, replays=3),
    dict(fuse=1, chunk=4, steps=10, every=6, replays=3),
    dict(fuse=2, chunk=16, steps=8, gray_scott=True, replays=1),
])
def test_iterate_graph_replay_equals_eager_on_card(case, cuda, tmp_path):
    """Bit for bit: the graph-replayed loop against eager stepping."""
    if case.get("gray_scott"):
        p = _gray_scott(96)
        feed = {"u": "u1", "v": "v1"}
    else:
        p = port.parse_program(synthesize_stencil(
            num_stages=1, dimensions=(24, 40, 72), shape="diffusion"),
            name="step")
        feed = {"a": p.outputs[0]}
    inputs = port.load_input_arrays(p, seed=3)
    stats = {}
    kw = {}
    if case.get("every"):
        kw = dict(checkpoint_every=case["every"],
                  checkpoint_dir=str(tmp_path / "ck"))
    got = port.iterate(p, inputs, case["steps"], feed=feed,
                       fuse=case["fuse"], chunk=case["chunk"], stats=stats,
                       backend=case.get("backend", "auto"), **kw)
    assert stats["backend"] != "dense" or case.get("backend") == "dense"
    want = _eager_steps(p, inputs, case["steps"], feed, case["fuse"])
    for k in feed:
        assert np.array_equal(got[k], want[k]), k
    assert stats["replays"] == case["replays"]
    assert 1 <= stats["captures"] <= 2
    if case.get("every"):
        assert sorted(os.listdir(tmp_path / "ck")) == ["step_10.npz",
                                                      "step_6.npz"]


@pytest.mark.cuda
def test_iterate_capture_failure_raises_on_card(cuda):
    """A step that cannot be captured (it waits for the device) raises;
    nothing runs eagerly in its place."""
    from stencilflow_tpu_torch.iterate import GraphLoop, make_step
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(16, 24, 40), shape="diffusion"),
        name="bad")
    step, feed = make_step(p, device="cuda")

    def waits(state):
        state = step(state)
        float(state["a"].sum())   # a host read: refused under capture
        return state

    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in port.load_input_arrays(p).items()}
    loop = GraphLoop(waits, state, feed, cuda)
    with pytest.raises(RuntimeError):
        loop.run(2)
    assert loop.replays == 0 and loop.captures == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ["constant", "copy"])
def test_fast_value_and_grad_equals_cpu_on_card(boundary, cuda):
    """The kernels' forward and adjoint equal their plain versions' run
    on the CPU bit for bit (value to VERIFY_RTOL: reduction order)."""
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(24, 40, 72), shape="diffusion",
        boundary=boundary), name=f"fv_{boundary}")
    inputs = port.load_input_arrays(p, seed=5)
    f = port.fast_value_and_grad(p)
    assert "dense" not in f.lowering.values()
    val, grads = f(inputs)
    cval, cgrads = port.fast_value_and_grad(p, device="cpu")(inputs)
    assert np.array_equal(grads["a"].cpu().numpy(), cgrads["a"].numpy())
    assert abs(float(val) - float(cval)) <= VERIFY_RTOL * abs(float(cval))


@pytest.mark.cuda
def test_solve_cg_equals_cpu_on_card(cuda):
    """CG on the card against CG on the CPU: both within tol, x within
    10 * tol relative of each other."""
    tol = 1e-6
    p = port.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [24, 40, 72],
        "program": {"y": {
            "computation_string":
                "y = x[i,j,k] - 0.3*(x[i-1,j,k] + x[i+1,j,k] + x[i,j-1,k] "
                "+ x[i,j+1,k] + x[i,j,k-1] + x[i,j,k+1] - 6.0*x[i,j,k])",
            "boundary_conditions": {"x": {"type": "constant",
                                          "value": 0.0}},
            "data_type": "float32"}}}, name="impl")
    rhs = np.random.default_rng(0).random((24, 40, 72)).astype(np.float32)
    solver = port.make_solver(p, tol=tol)
    assert solver.lowering["operator"] == "overlap"
    x, info = solver(rhs)
    xc, info_c = port.make_solver(p, tol=tol, device="cpu")(rhs)
    assert info["residual"] <= tol * 100 and info_c["residual"] <= tol * 100
    assert abs(info["iterations"] - info_c["iterations"]) <= 1
    x = x.cpu().numpy()
    assert np.linalg.norm(x - xc.numpy()) <= 10 * tol * np.linalg.norm(x)


def _sim_case(shape, dims, stages, extent=1):
    return lambda: port.parse_program(synthesize_stencil(
        num_stages=stages, dimensions=dims, shape=shape, extent=extent,
        seed_data="random:0.0,1.0"),
        name=f"sim_{shape}_{len(dims)}d_{stages}")


# (program, backend, the label run_program gives)
SIM_CASES = {
    "K1-panel": (_sim_case("diffusion", (24, 24, 24), 8), "auto", "panel"),
    "K2-overlap": (_sim_case("diffusion", (24, 24, 24), 2), "auto",
                   "overlap"),
    "K3b-stream-banded": (_sim_case("box", (24, 32, 40), 4, extent=2),
                          "auto", "stream"),
    "K5-group": (_sim_case("hotspot", (256, 192), 8), "auto",
                 "rows+group_g8"),
    "K6-tile": (_sim_case("diffusion", (24, 40, 72), 2), "tile", "tile"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_run_program_verified_against_simulation_on_card(case, cuda):
    """``run --run-simulation`` on the card: each kernel's output is held
    against the dataflow simulator's (run on the host, its C++ core) and
    the oracle; per-cell kernels equal the simulator bit for bit, the
    banded stream kernel within MXU_VERIFY_RTOL."""
    from stencilflow_tpu_torch.backend import tile
    from stencilflow_tpu_torch.sim import simulate
    from stencilflow_tpu_torch.sim.native import NativeSimulator
    build, backend, label = SIM_CASES[case]
    p = build()
    NativeSimulator(p)   # the native core builds: no Python-machine fallback
    module = {"panel": panel, "overlap": overlap, "stream": stream,
              "rows+group_g8": group, "tile": tile}[label]
    before = module.launches
    res = run_program(p, device="cuda", backend=backend,
                      run_simulation=True, compare_to_reference=True,
                      save_results=False, log_level=0)
    assert res.backend == label
    assert module.launches > before
    assert res.verified_against_simulation is True
    assert res.verified_against_reference is True
    sim = simulate(p, port.load_input_arrays(p, seed=0))
    assert res.simulation_cycles == sim.cycles >= p.total_elements
    for o in p.outputs:
        if label == "stream":
            assert stream.plan_stream(p).tkeys   # banded stages
            assert port.arrays_are_equal(sim.outputs[o], res.outputs[o],
                                         MXU_VERIFY_RTOL)
        else:
            assert np.array_equal(res.outputs[o], sim.outputs[o])


@pytest.mark.cuda
def test_cli_run_simulation_on_card(cuda, tmp_path, capsys, monkeypatch):
    """``cli run prog.json --compare-to-reference --run-simulation``: the
    kernel's backend, the simulated cycles and both checks OK."""
    from stencilflow_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    prog = tmp_path / "prog.json"
    prog.write_text(json.dumps(synthesize_stencil(
        num_stages=8, dimensions=(24, 24, 24), shape="diffusion",
        seed_data="random:0.0,1.0")))
    assert main(["run", str(prog), "--compare-to-reference",
                 "--run-simulation"]) == 0
    out = capsys.readouterr().out
    for line in ("backend: panel\n", "simulated cycles: ",
                 "verified against reference: OK\n",
                 "verified against simulation: OK\n"):
        assert line in out

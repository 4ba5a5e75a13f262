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
from stencilflow_tpu_torch.cardcheck import wide_i_spec
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
    before = module.launches_by["exact"]
    got = run(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert module.launches_by["exact"] == before + 1
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
    before = panel.launches_by["exact"]
    got = panel.run_panel(p, an, plan, arrays, lib)
    torch.cuda.synchronize()
    assert panel.launches_by["exact"] == before + 1
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
    before = stream.launches_by["exact"]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by["exact"] == before + 1
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
    # beside chip_smoke.py's phase-3 cases (its shrink jacobi2d and the
    # jacobi whose stages read i-offsets of 3): its 2-D and 3-D random
    # chains (the first draws from seed 1000 that read a scalar and the
    # lower-rank inputs) and the i-offset jacobi again
    "rows_fuzz1001_2d": (lambda: random_program(
        np.random.default_rng(1001), ndim=2,
        bc_kinds=("constant", "copy", "shrink")), True, 0, 2),
    "fuzz1000": (lambda: random_program(np.random.default_rng(1000),
                                        ndim=3), False, 0, 2),
    "jacobi3d_i3": (lambda: wide_i_spec((24, 40, 72), 4), False, 2, 2),
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
    before = group.launches_by["exact"]
    got = group.run_group(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert group.launches_by["exact"] == before + 1
    want = group.group_plain(p, an, plan, arrays)
    for o in want:
        g_, w = got[o].cpu().numpy(), want[o].cpu().numpy()
        assert g_.dtype == w.dtype
        np.testing.assert_array_equal(g_, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name,segments", [
    ("rows_jacobi2d_constant", 4), ("rows_jacobi2d_copy", 2),
    ("rows_jacobi2d_shrink", 3), ("rows_hotspot2d", 2), ("fuzz122", 3),
    ("rows_jacobi2d_shrink", 4), ("jacobi3d_i3", 4)])
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
    before = group.launches_by["exact"]
    got = group.run_group(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert group.launches_by["exact"] == before + 1
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
        before = stream.launches_by["local"]
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.launches_by["local"] == before + 1
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
    before = stream.launches_by["local"]
    oc = run_program(p, device=cuda, host_chunks=4, save_results=False,
                     log_level=0)
    assert oc.backend == "outofcore[stream x4 chunks]"
    assert stream.launches_by["local"] == before + 2 * 4   # warm-up + 1 run
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
    before = stream.launches_by["exact"]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by["exact"] == before + 1
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
    # beside chip_smoke.py's phase-3 case (the shrink one): jacobi3d 64^3
    # x 3 with every ring spilled, and the small hdiff DAG (nothing to
    # spill)
    **{f"jacobi3d_64_{bc}": (lambda bc=bc: synthesize_stencil(
        num_stages=3, dimensions=(64,) * 3, shape="diffusion", boundary=bc,
        seed_data="random:0.0,1.0"), {"spill": "all"})
       for bc in ("constant", "copy", "shrink")},
    "hdiff_dag_small": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="hdiff"),
        {"spill": "all"}),
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
    assert plan.packed and (plan.spilled or name.startswith("hdiff_dag"))
    assert plan.smem_bytes() <= kw.get("smem_budget",
                                       stream.H100_SMEM_PER_BLOCK)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.launches_by["spill"]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by["spill"] == before + 1
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
        before = stream.launches_by["spill"]
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.launches_by["spill"] == before + 1
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
    before = tile.launches_by["exact"]
    got = tile.run_tile(plan, arrays)
    torch.cuda.synchronize()
    assert tile.launches_by["exact"] == before + 1
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
        before = tile.launches_by["exact"]
        got[mode] = tile.run_tile(plan, arrays)
        torch.cuda.synchronize()
        assert tile.launches_by["exact"] == before + 1
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
    before = overlap.launches_by["exact"]
    got = overlap.run_overlap(p, an, plan, arrays, lib)
    torch.cuda.synchronize()
    assert overlap.launches_by["exact"] == before + 1
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
    """float16 runs on its route's kernel on the card (no longer on
    ``dense``), one op at a time in float32 rounded to float16, as numpy
    does: equal to the oracle bit for bit (tests/test_torch_float16.py
    holds ``dense`` itself on the CPU)."""
    from stencilflow_tpu_torch.backend import choose_backend
    p = port.parse_program(float16_chain(shape, extent))
    route = choose_backend(p, port.ChainAnalysis.run(p), "cuda")
    assert route in ("panel", "overlap", "stream")
    res = run_program(p, device=cuda, save_results=False, log_level=0)
    assert res.backend == route
    oracle = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    for o in oracle:
        got = np.asarray(res.outputs[o]).reshape(oracle[o].shape)
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got, oracle[o])


def _narrow_case(kind, dt):
    """(program the kernel runs, plan, run, plain, narrow count) of a
    small program typed ``dt`` on kernel ``kind``."""
    def typed(shape, dims, iters):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0.0,1.0", data_type=dt))
    if kind == "panel":
        p = typed("hdiff", (12, 40, 48), 3)
        an = port.ChainAnalysis.run(p)
        plan = panel.PanelPlan.build(an)
        return (p, lambda a: panel.run_panel(p, an, plan, a),
                lambda a: panel.panel_plain(p, an, plan, a),
                lambda: panel.launches_by["narrow"])
    if kind == "overlap":
        p = typed("diffusion", (12, 40, 48), 2)
        an = port.ChainAnalysis.run(p)
        plan = overlap.OverlapPlan.build(an)
        return (p, lambda a: overlap.run_overlap(p, an, plan, a),
                lambda a: overlap.overlap_plain(p, an, plan, a),
                lambda: overlap.launches_by["narrow"])
    if kind == "group":
        p = rotate_2d_to_rows(typed("diffusion", (256, 192), 8))
        an = port.ChainAnalysis.run(p)
        plan = group.plan_group(p, an, 64, 8)
        return (p, lambda a: group.run_group(p, an, plan, a),
                lambda a: group.group_plain(p, an, plan, a),
                lambda: group.launches_by["narrow"])
    p = typed("diffusion", (16, 24, 40), 3)
    plan = stream.plan_stream(p, mxu="off",
                              spill="all" if kind == "spill" else "auto")
    assert plan.packed == (kind == "spill")
    return (p, lambda a: stream.run_stream(plan, a),
            lambda a: stream.stream_plain(plan, a),
            lambda: (stream.launches_by["spill_narrow"] if plan.packed
                     else stream.launches_by["narrow"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["panel", "overlap", "stream", "spill",
                                  "group"])
def test_narrow_kernel_matches_plain_and_oracle_on_card(kind, dt, cuda):
    """K1, K2, K3a, K3c and K5 on programs typed bf16 and f16: storage
    and values in 2 bytes, every op rounded once to the narrow type (the
    card's bf16 / f16 instruction for + - *), equal to the plain version
    and the numpy oracle bit for bit (2-byte patterns); one launch,
    counted apart."""
    from stencilflow_tpu_torch.dtypes import to_numpy
    p, run, plain, count = _narrow_case(kind, dt)
    inputs = port.load_input_arrays(p, seed=5)
    arrays = spanned_arrays(p, inputs, device=cuda)
    before = count()
    got = run(arrays)
    torch.cuda.synchronize()
    assert count() == before + 1
    want = plain(arrays)
    oracle = port.run_interpreter(p, inputs)
    for o in p.outputs:
        g = to_numpy(got[o])
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g.view(np.uint16),
                                      to_numpy(want[o]).view(np.uint16))
        np.testing.assert_array_equal(
            g.reshape(oracle[o].shape).view(np.uint16),
            oracle[o].view(np.uint16))


@pytest.mark.cuda
def test_bf16_meets_f16_on_card(cuda):
    """bf16 meeting f16 at ufunc sites (+, *, max, a comparison) computes
    in float32, as ml_dtypes' loops do: K1 equals its plain version and
    the oracle bit for bit, on a float32 and a bf16 output."""
    from stencilflow_tpu_torch.dtypes import to_numpy
    bf, hf = "bfloat16", "float16"
    p = port.parse_program({
        "inputs": {"a": {"data": "random:-2,3", "data_type": bf},
                   "b": {"data": "random:-2,3", "data_type": hf}},
        "outputs": ["s", "t"], "dimensions": [12, 40, 48],
        "program": {
            "s": {"computation_string": "s = a[i,j,k] + b[i,j+1,k] * 0.5 - "
                  "max(a[i,j,k-1], b[i,j,k])",
                  "boundary_conditions": {"a": {"type": "constant",
                                                "value": 0.3},
                                          "b": {"type": "copy"}},
                  "data_type": "float32"},
            "t": {"computation_string": "t = a[i-1,j,k] * b[i,j,k] + "
                  "s[i,j,k] if a[i,j,k] > b[i,j,k] else a[i,j,k] / "
                  "b[i,j-1,k]",
                  "boundary_conditions": {"a": {"type": "constant",
                                                "value": 0.3},
                                          "b": {"type": "constant",
                                                "value": 1.5},
                                          "s": {"type": "copy"}},
                  "data_type": bf}}})
    an = port.ChainAnalysis.run(p)
    plan = panel.PanelPlan.build(an)
    inputs = port.load_input_arrays(p, seed=1)
    arrays = spanned_arrays(p, inputs, device=cuda)
    before = panel.launches_by["narrow"]
    got = panel.run_panel(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert panel.launches_by["narrow"] == before + 1
    want = panel.panel_plain(p, an, plan, arrays)
    oracle = port.run_interpreter(p, inputs)
    for o in p.outputs:
        g = to_numpy(got[o]).reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(
            g.view(np.uint8), to_numpy(want[o]).reshape(g.shape).view(
                np.uint8))
        np.testing.assert_array_equal(g.view(np.uint8),
                                      oracle[o].view(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_run_program_narrow_on_card(dt, cuda):
    """``run --compare-to-reference`` on a bf16 / f16 program on the
    card: its route's kernel, verified at VERIFY_RTOL (exact here), the
    simulator too."""
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(12, 20, 24), shape="hdiff",
        seed_data="random:0.0,1.0", data_type=dt))
    res = run_program(p, device=cuda, compare_to_reference=True,
                      run_simulation=True, save_results=False, log_level=0)
    assert res.backend == "panel"
    assert res.verified_against_reference and \
        res.verified_against_simulation


def _narrow_k4k6(kind, dt, cuda):
    """(outputs, the narrow launches they took, the launches expected) of
    a small program typed ``dt`` through ``kind``'s entry point on the
    card: K4 chunk / shard / segment, K6 masked / fast."""
    from stencilflow_tpu_torch.backend import tile
    from stencilflow_tpu_torch.outofcore import run_chunked
    from stencilflow_tpu_torch.parallel import compile_pipeline_split
    from stencilflow_tpu_torch.parallel.domain import run_sharded_chain
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    shape = "hdiff" if kind in ("shard", "masked") else "diffusion"
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(16, 32, 48), shape=shape,
        seed_data="random:0.0,1.0", data_type=dt,
        boundary="copy" if kind == "chunk" else "constant"))
    inputs = port.load_input_arrays(p, seed=5)
    for m in (stream, tile):
        m.launches_by.clear()
    if kind == "chunk":
        got = run_chunked(p, inputs, 4, device=cuda)
        return p, inputs, got, stream.launches_by["local_narrow"], 4
    if kind == "shard":
        got = run_sharded_chain(p, make_mesh([cuda], (2, 2), ("x", "y")),
                                (None, "x", "y"), inputs)
        return p, inputs, got, stream.launches_by["shard_narrow"], 4
    if kind == "segment":
        fn, plan = compile_pipeline_split(
            p, make_mesh([cuda], (2,), ("p",)), "p")
        got = {k: v.numpy() for k, v in fn(inputs).items()}
        return (p, inputs, got, stream.launches_by["local_narrow"],
                len(plan.segments) * plan.num_chunks)
    got = tile.run_chain_tile(p, inputs, mode=kind, device=cuda)
    return p, inputs, got, tile.launches_by["narrow"], 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["chunk", "shard", "segment", "masked",
                                  "fast"])
def test_narrow_k4_k6_on_card(kind, dt, cuda):
    """K4 (chunk, shard, segment) and K6 (masked, fast) on programs typed
    bf16 and f16, through their entry points: 2-byte cells (K4's ring
    inputs by cp.async groups where its plan aligns them, K6's tiles
    synchronously), every op rounded once, equal to the numpy oracle bit
    for bit; every launch counted under its narrow mode."""
    p, inputs, got, n, want_n = _narrow_k4k6(kind, dt, cuda)
    assert n == want_n
    oracle = port.run_interpreter(p, inputs)
    for o in oracle:
        g = np.asarray(got[o]).reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g.view(np.uint16),
                                      oracle[o].view(np.uint16))


@pytest.mark.cuda
def test_narrow_solver_entry_points_on_card(cuda, tmp_path):
    """``iterate`` (fused, checkpointed and resumed), ``fast_value_and_grad``
    and ``solve_cg`` on bf16 / f16 programs on the card: the resumed run
    bit-equal to the uninterrupted one, the gradient bit-equal to the
    adjoint program's dense lowering, CG's four iterations in float16."""
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.dtypes import to_numpy, to_torch
    from stencilflow_tpu_torch.grad import _adjoint_extras
    from stencilflow_tpu_torch.solver_cells import implicit_diffusion
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(24, 32, 48), shape="diffusion",
        seed_data="random:0.0,1.0", data_type="bfloat16"))
    inputs = port.load_input_arrays(p, seed=2)
    whole = port.iterate(p, inputs, 8, fuse=2, device=cuda)
    port.iterate(p, inputs, 4, fuse=2, device=cuda, checkpoint_every=4,
                 checkpoint_dir=str(tmp_path))
    resumed = port.iterate(p, inputs, 8, fuse=2, device=cuda,
                           checkpoint_every=4, checkpoint_dir=str(tmp_path))
    for k in whole:
        assert resumed[k].dtype == whole[k].dtype
        np.testing.assert_array_equal(resumed[k].view(np.uint8),
                                      whole[k].view(np.uint8))
    g = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(24, 32, 48), shape="diffusion",
        seed_data="random:0.0,1.0", data_type="bfloat16"))
    _v, grads = port.fast_value_and_grad(g, device=cuda)(
        port.load_input_arrays(g, seed=3))
    adj, cot = port.adjoint_program(g)
    o = g.outputs[0]
    dense = compile_chain(adj)({cot[o]: torch.ones(
        g.raw_dimensions, dtype=torch.bfloat16, device=cuda), **{
        k: to_torch(v, cuda) for k, v in _adjoint_extras(adj, cot).items()}})
    name = next(iter(grads))
    np.testing.assert_array_equal(
        to_numpy(grads[name]).view(np.uint16),
        to_numpy(dense[f"adj_{name}"]).reshape(
            grads[name].shape).view(np.uint16))
    e = implicit_diffusion(32, dtype="float16")
    rhs = np.random.default_rng(0).random((32,) * 3).astype(np.float16)
    x, info = port.solve_cg(e, rhs, maxiter=4, device=cuda)
    assert info["iterations"] == 4 and x.dtype == torch.float16
    assert torch.isfinite(x).all() and info["residual"] < 1


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
    before = overlap.launches_by["exact"]
    got = sp.overlap_k2(shape)(x)
    torch.cuda.synchronize()
    assert overlap.launches_by["exact"] == before + 1
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
@pytest.mark.parametrize("mesh", [False, True])
def test_iterate_orbax_resume_on_card(mesh, cuda, tmp_path):
    """Sharded asynchronous checkpoints from the CUDA-graph loop: each
    save stages the static buffers before the next replay overwrites
    them, and a resume from the step before the newest equals the
    uninterrupted run bit for bit (on one device and on 2 x 2 virtual
    shards of the card)."""
    import shutil

    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(24, 40, 72), shape="diffusion"),
        name="ock")
    inputs = port.load_input_arrays(p, seed=3)
    kw = dict(mesh=make_mesh([cuda], (2, 2), ("x", "y")),
              dim_axes=(None, "x", "y")) if mesh else {}
    ck = str(tmp_path / "ck")
    stats = {}
    full = port.iterate(p, inputs, 12, chunk=2, checkpoint_every=4,
                        checkpoint_dir=ck, checkpoint_format="orbax",
                        stats=stats, **kw)
    assert stats["replays"] == 6 and len(stats["save_s"]) == 3
    assert sorted(os.listdir(ck)) == ["12", "4", "8"]
    shutil.rmtree(os.path.join(ck, "12"))
    again = port.iterate(p, inputs, 12, chunk=2, checkpoint_every=4,
                         checkpoint_dir=ck, checkpoint_format="orbax", **kw)
    assert np.array_equal(full["a"], again["a"])
    want = _eager_steps(p, inputs, 12, {"a": p.outputs[0]}, 1)
    assert np.array_equal(full["a"], want["a"])


@pytest.mark.cuda
def test_two_process_run_distributed_on_card(cuda, tmp_path):
    """Two processes of ``run-distributed --coordinator``, one position
    each on cuda:0 (K4 a shard), exchanging over gloo: both verify the
    shards they hold."""
    import socket
    import subprocess
    import sys
    path = tmp_path / "p.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=3, dimensions=(32, 48, 64), shape="diffusion")))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port_no = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stencilflow_tpu_torch.cli",
         "run-distributed", str(path), "--devices", "2",
         "--coordinator", f"127.0.0.1:{port_no}", "--num-hosts", "2",
         "--host-id", str(h), "--compare-to-reference"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for h, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"host {h}: verified local shards: OK" in out, out


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
    before = module.launches_by["exact"]
    res = run_program(p, device="cuda", backend=backend,
                      run_simulation=True, compare_to_reference=True,
                      save_results=False, log_level=0)
    assert res.backend == label
    assert module.launches_by["exact"] > before
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


# -- domain decomposition: K4 per shard (virtual shards of one card) ---------

def _check(got, want, rtol):
    """Bit-exact where ``rtol`` is 0, else within it."""
    assert np.isfinite(got).all()
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _shard_cases():
    """(program, mesh shape, axis names, dim axes, banded)."""
    def synth(shape, dims, iters, **kw):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0,1", **kw))
    jk = ((2, 2), ("x", "y"), (None, "x", "y"))
    ijk = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))
    return {
        "jacobi-copy-ijk": (synth("diffusion", (16, 24, 40), 3,
                                  boundary="copy"),) + ijk + (False,),
        "jacobi-shrink-jk": (synth("diffusion", (8, 40, 72), 3,
                                   boundary="shrink"),) + jk + (False,),
        "hdiff-jk": (synth("hdiff", (8, 32, 48), 2),) + jk + (False,),
        "box-bc0.7-jk": (synth("box", (8, 40, 48), 2, extent=1,
                               boundary_value=0.7),) + jk + (True,),
        "box-r2-composed-jk": (synth("box", (16, 64, 64), 4, extent=2),)
        + jk + (True,),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_shard_cases()))
def test_shard_kernel_matches_plain_on_card(name, cuda):
    """K4 in shard mode, shard by shard on virtual shards of the card,
    against its plain version (bit-exact per cell, MXU_VERIFY_RTOL
    banded); every shard launches once, and the assembled result equals
    the single-device route."""
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    p, shape, names, axes, banded = _shard_cases()[name]
    mesh = make_mesh([cuda], shape, names)
    fn, plan = compile_sharded_chain(p, mesh, axes)
    assert fn.last_config["backend"] == "stream"
    assert bool(fn.last_config["mxu_stages"]) == banded
    inputs = port.load_input_arrays(p, seed=4)
    placed = place_global_inputs(p, plan, inputs)
    per = fn.exchange(placed)
    splan = fn.plan
    rtol = MXU_VERIFY_RTOL if banded else 0.0
    for c, tiles in per.items():
        oi, oj, ok = plan.block_origin(c)
        args = (oi - plan.halo[0], tiles)
        got = stream.run_local_stream(splan, *args, None, oj, ok,
                                      plan.instance(c))
        want = stream.local_stream_plain(splan, *args, oj, ok,
                                         plan.instance(c))
        for o in p.outputs:
            _check(got[o].cpu().numpy(), want[o].cpu().numpy(), rtol)
    before = stream.launches_by["shard"]
    out = fn(placed)
    assert stream.launches_by["shard"] - before == mesh.size
    single, _route = compile_chain_best(p, device=cuda)
    ref = single({n: torch.as_tensor(np.asarray(v)).to(cuda)
                  if np.ndim(v) else v for n, v in inputs.items()})
    for o in p.outputs:
        _check(out[o].numpy(), ref[o].cpu().numpy(), rtol)


@pytest.mark.cuda
def test_sharded_iterate_and_grad_on_card(cuda):
    """iterate(mesh=) replayed from CUDA graphs, and fast_value_and_grad
    (mesh=), on a 2 x 2 mesh of virtual shards: equal to their
    single-device runs."""
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh([cuda], (2, 2), ("x", "y"))
    p = port.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(32, 48, 64), shape="diffusion",
        seed_data="random:0,1"))
    inputs = port.load_input_arrays(p, seed=2)
    stats = {}
    got = port.iterate(p, inputs, 8, fuse=4, chunk=2, mesh=mesh,
                       dim_axes=(None, "x", "y"), stats=stats)
    assert stats["backend"] == "sharded[stream]" and stats["captures"] >= 1
    want = port.iterate(p, inputs, 8, fuse=4, chunk=2, device=cuda)
    np.testing.assert_array_equal(got["a"], want["a"])
    p3 = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(16, 32, 48), shape="diffusion",
        boundary="copy", seed_data="random:0,1"))
    inputs = port.load_input_arrays(p3, seed=3)
    f = port.fast_value_and_grad(p3, mesh=mesh, dim_axes=(None, "x", "y"))
    assert f.lowering == {"forward": "sharded[stream]",
                          "adjoint": "sharded[stream]"}
    v1, g1 = f(inputs)
    v2, g2 = port.fast_value_and_grad(p3, device=cuda)(inputs)
    np.testing.assert_array_equal(g1["a"].cpu().numpy(),
                                  g2["a"].cpu().numpy())


# -- the pipeline split: K4 a segment (positions repeating one card) ---------

def _pipeline_cases():
    """(program, mesh shape, axis names, compile options, banded)."""
    def synth(shape, dims, iters, **kw):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0,1", **kw))
    return {
        "jacobi-4-sharded": (synth("diffusion", (32, 24, 40), 4), (4,),
                             ("p",), {"io": "sharded"}, False),
        "jacobi-copy-4-replicated-6-chunks": (
            synth("diffusion", (24, 24, 40), 4, boundary="copy"), (4,),
            ("p",), {"io": "replicated", "num_chunks": 6}, False),
        "hdiff-2": (synth("hdiff", (16, 32, 48), 2), (2,), ("p",), {},
                    False),
        "box-r2-2-banded": (synth("box", (16, 40, 48), 2, extent=2), (2,),
                            ("p",), {}, True),
        "jacobi-2x2-domain": (synth("diffusion", (16, 32, 40), 4), (2, 2),
                              ("p", "x"), {"domain_axes": {1: "x"}}, False),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_pipeline_cases()))
def test_pipeline_segments_match_plain_on_card(name, cuda, monkeypatch):
    """compile_pipeline_split over positions repeating the card: every
    K4 launch of a run against its plain version on the same tiles (the
    in-domain planes; bit-exact per cell, MXU_VERIFY_RTOL banded), K4
    launched segments x chunks times (the pipeline x domain case runs
    the dense tile body, as the reference's, and launches none), and the
    result equal to the single-device route."""
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.parallel import compile_pipeline_split
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    calls = []
    launch = stream.run_local_stream

    def record(plan, origin_i, slabs, lib=None, *rest):
        got = launch(plan, origin_i, slabs, lib, *rest)
        calls.append((plan, origin_i, dict(slabs), got))
        return got
    monkeypatch.setattr(stream, "run_local_stream", record)
    p, shape, names, kw, banded = _pipeline_cases()[name]
    fn, plan = compile_pipeline_split(p, make_mesh([cuda], shape, names),
                                      "p", **kw)
    domain = bool(kw.get("domain_axes"))
    assert fn.last_config["backend"] == ("xla" if domain else "stream")
    inputs = port.load_input_arrays(p, seed=4)
    before = stream.launches_by["local"] + stream.launches_by["spill"]
    out = fn(inputs)
    S, C = len(plan.segments), plan.num_chunks
    assert (stream.launches_by["local"] + stream.launches_by["spill"]
            - before) == (0 if domain else S * C)
    assert len(calls) == (0 if domain else S * C)
    rtol = MXU_VERIFY_RTOL if banded else 0.0
    I = p.dimensions[0]
    for sp, oi, slabs, got in calls:
        want = stream.local_stream_plain(sp, oi, slabs)
        g0 = oi + sp.halo_i
        lo, hi = max(0, -g0), min(sp.block, I - g0)
        for o in sp.program.outputs:
            _check(got[o][lo:hi].cpu().numpy(), want[o][lo:hi].cpu().numpy(),
                   rtol)
    single, _route = compile_chain_best(p, device=cuda)
    ref = single({n: torch.as_tensor(np.asarray(v)).to(cuda)
                  if np.ndim(v) else v for n, v in inputs.items()})
    for o in p.outputs:
        _check(out[o].numpy(), ref[o].reshape(p.raw_dimensions).cpu()
               .numpy(), rtol)


@pytest.mark.cuda
def test_chunked_sharded_on_card(cuda):
    """run_chunked(mesh=) over a 2 x 2 mesh repeating the card (the dense
    tile body on every position): equal to the in-core route."""
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.outofcore import run_chunked
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(32, 24, 40), shape="diffusion",
        seed_data="random:0,1"))
    inputs = port.load_input_arrays(p, seed=5)
    got = run_chunked(p, {k: np.asarray(v) for k, v in inputs.items()}, 4,
                      mesh=make_mesh([cuda], (2, 2), ("x", "y")),
                      dim_axes=(None, "x", "y"))
    single, _route = compile_chain_best(p, device=cuda)
    ref = single({n: torch.as_tensor(np.asarray(v)).to(cuda)
                  for n, v in inputs.items()})
    for o in p.outputs:
        np.testing.assert_array_equal(
            got[o], ref[o].reshape(p.raw_dimensions).cpu().numpy())


# -- autotune: every candidate on the card ------------------------------------

def _autotune_cases():
    def synth(shape, dims, iters, **kw):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0,1", **kw))
    return {"jacobi3d": synth("diffusion", (32, 40, 48), 3),
            "box-r2": synth("box", (24, 32, 40), 2, extent=2),
            "jacobi2d": synth("diffusion", (128, 192), 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_autotune_cases()))
def test_autotune_candidates_equal_dense_on_card(name, cuda):
    """``autotune(device="cuda", sweep=True)``: every candidate is built
    and timed on the card (only planner refusals skipped), and each one's
    output equals ``dense``'s on the same inputs, bit for bit per cell,
    within MXU_VERIFY_RTOL where its stream plan has banded stages."""
    from stencilflow_tpu_torch import autotune as at
    from stencilflow_tpu_torch.backend import compile_chain
    p = _autotune_cases()[name]
    res = at.autotune(p, device="cuda", sweep=True, trials=1)
    assert res.label in res.timings
    assert all(np.isfinite(t) and t > 0 for t in res.timings.values())
    inputs = {k: v if p.inputs[k].is_scalar else
              torch.as_tensor(np.asarray(v)).to(cuda)
              for k, v in port.load_input_arrays(p, seed=0).items()}
    want = compile_chain(p)(inputs)
    for label in res.timings:
        fn = at.build_from_label(p, label, device="cuda")
        got = fn(inputs)
        banded = bool(getattr(fn, "last_config", {}).get("mxu_stages"))
        for o in p.outputs:
            _check(got[o].cpu().numpy(), want[o].cpu().numpy(),
                   MXU_VERIFY_RTOL if banded else 0)


@pytest.mark.cuda
def test_autotune_cache_key_names_the_card(cuda, tmp_path, monkeypatch):
    from stencilflow_tpu_torch import autotune as at
    p = _autotune_cases()["jacobi3d"]
    key = at.cache_key(p, "cuda")
    assert key != at.cache_key(p, "cpu")
    res = at.AutotuneResult("xla", 1e-3, {"xla": 1e-3}, {})
    path = at.save_result(p, res, str(tmp_path / "at.json"), "cuda")
    entry = json.load(open(path))[key]
    assert entry["device"] == f"cuda:{torch.cuda.get_device_name()}"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "another card")
    assert at.cache_key(p, "cuda") != key


@pytest.mark.cuda
def test_cli_run_backend_autotuned_on_card(cuda, tmp_path, capsys,
                                           monkeypatch):
    """``cli run prog.json --backend autotuned --compare-to-reference``:
    tuned on the card, verified, and served from the cache the second
    time."""
    from stencilflow_tpu_torch import autotune as at
    from stencilflow_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    prog = tmp_path / "prog.json"
    prog.write_text(json.dumps(synthesize_stencil(
        num_stages=4, dimensions=(24, 32, 40), shape="diffusion",
        seed_data="random:0.0,1.0")))
    argv = ["run", str(prog), "--backend", "autotuned",
            "--compare-to-reference"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "backend: autotuned:" in out
    assert "verified against reference: OK\n" in out
    label = out.split("backend: autotuned:")[1].split()[0]

    def boom(*a, **k):
        raise AssertionError("tuned again on a cache hit")
    monkeypatch.setattr(at, "autotune", boom)
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert f"backend: autotuned:{label}\n" in out
    assert "verified against reference: OK\n" in out


# -- reduced precision: bf16 rings (K1, K5, K3a, K3c), single-pass bf16
# band passes (K3b) -----------------------------------------------------------

@pytest.mark.cuda
def test_mma_bf16_band_matches_host_version_on_card(cuda, tmp_path):
    """``sf_mma_band_bf16`` alone (mma.sync m16n8k16 bf16, operands
    rounded to nearest even, f32 accumulation) against its host version on
    one tile: 5- and 33-tap bands from a weight vector, a 41-tap band from
    a table.  The rounded operands' products are exact in f32, so the two
    differ only in the order of their sums: each element within 1e-6 of
    the sum of its products' magnitudes."""
    import ctypes
    import shutil
    import subprocess
    from stencilflow_tpu_torch.backend import build, codegen
    src = codegen.mma_probe_source((1, 3), bf16=True)
    dev = build.load_library(src, "mma_bf16_probe")
    gxx = shutil.which("g++") or shutil.which("c++")
    assert gxx, "the card's machine has no host C++ compiler"
    cpp, so = tmp_path / "probe.cpp", tmp_path / "probe.so"
    cpp.write_text(src)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(so))
    rng = np.random.default_rng(12)

    def bf(a):
        return torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    for taps, ks, table in ((5, 1, False), (33, 3, False), (41, 3, True)):
        x = rng.standard_normal((16, 16 * ks)).astype(np.float32)
        w = rng.standard_normal((taps, 8) if table else (taps,)).astype(
            np.float32)
        args = [16 * ks, 1, 16, 16 * ks, 8 if table else 1,
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
        band = np.zeros((16 * ks, 8), np.float32)
        for m in range(16 * ks):
            for n in range(8):
                if 0 <= m - n < taps:
                    band[m, n] = w[m - n, n] if table else w[m - n]
        scale = np.abs(bf(x)) @ np.abs(bf(band))
        err = np.max(np.abs(got - want) / (scale + 1e-30))
        print(f"sf_mma_band_bf16 taps {taps}: max error {err:.3g} of the "
              "products' magnitudes")
        assert err <= 1e-6, (taps, err)


def _jacobi_bf16(dims, iters, **kw):
    return lambda: synthesize_stencil(num_stages=iters, dimensions=dims,
                                      shape="diffusion",
                                      seed_data="random:0,1", **kw)


# name: (spec, kernel): bf16 rings, bit for bit against the plain version
BF16_RINGS = {
    "K1 jacobi3d": (_jacobi_bf16((32, 40, 72), 4), "panel"),
    "K1 hdiff": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(12, 52, 72), shape="hdiff",
        seed_data="random:0,1"), "panel"),
    "K5 jacobi3d g2": (_jacobi_bf16((16, 40, 72), 4), "group"),
    "K5 rows jacobi2d g8": (_jacobi_bf16((256, 192), 8), "rows"),
    "K5 rows copy g8": (_jacobi_bf16((256, 192), 8, boundary="copy"),
                        "rows"),
    "K3a jacobi3d": (_jacobi_bf16((40, 48, 72), 4), "stream"),
    "K3c reconvergent": (lambda: reconvergent_chain(), "spill"),
    "K3c hotspot deep": (lambda: synthesize_stencil(
        num_stages=32, dimensions=(40, 40, 72), shape="hotspot"),
        "spill_all"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BF16_RINGS))
def test_bf16_rings_match_plain_on_card(name, cuda):
    """``ring_storage="bfloat16"``: the kernel and its plain version round
    the same rings at the same points and compute in f32 alike."""
    make, kind = BF16_RINGS[name]
    p = port.parse_program(make())
    if kind == "rows":
        p = rotate_2d_to_rows(p)
    an = port.ChainAnalysis.run(p)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    if kind == "panel":
        plan = panel.PanelPlan.build(an, ring_storage="bfloat16")
        before = panel.launches_by["bf16"]
        got = panel.run_panel(p, an, plan, arrays)
        n = panel.launches_by["bf16"] - before
        want = panel.panel_plain(p, an, plan, arrays)
    elif kind in ("group", "rows"):
        B, g = (64, 8) if kind == "rows" else (2, 2)
        plan = group.plan_group(p, an, B, g, ring_storage="bfloat16")
        before = group.launches_by["bf16"]
        got = group.run_group(p, an, plan, arrays)
        n = group.launches_by["bf16"] - before
        want = group.group_plain(p, an, plan, arrays)
    else:
        kw = {"stream": {"mxu": "off"}, "spill": {"smem_budget": 64 * 1024},
              "spill_all": {"spill": "all"}}[kind]
        plan = stream.plan_stream(p, ring_storage="bfloat16", **kw)
        assert plan.packed == (kind != "stream")
        mode = "spill_bf16" if plan.packed else "bf16"
        before = stream.launches_by[mode]
        got = stream.run_stream(plan, arrays)
        n = stream.launches_by[mode] - before
        want = stream.stream_plain(plan, arrays)
    torch.cuda.synchronize()
    assert plan.rounds and n == 1
    for o in want:
        np.testing.assert_array_equal(got[o].cpu().numpy(),
                                      want[o].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", ["auto", "fma", "mma"])
@pytest.mark.parametrize("name", ["box_r2", "cross_r2"])
def test_bf16_passes_match_plain_on_card(name, passes, cuda):
    """``mxu_precision="bf16"``: single-pass bf16 band passes on either
    route against the plain version's sums of the same rounded operands
    and apart from the split route's (``stream.bf16_passes_agree``: the
    tensor cores sum in their own order, and a sum that lands near a bf16
    tie may round the other way before the next pass, so a few cells
    differ by bf16 ulps; passes run unrounded or split fail)."""
    p = port.parse_program(ONCHIP_BANDED[name]())
    kw = {} if passes == "auto" else {"passes": passes}
    plan = stream.plan_stream(p, mxu_precision="bf16", **kw)
    assert plan.tkeys and not plan.packed
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.launches_by["bf16"]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by["bf16"] == before + 1
    want = stream.stream_plain(plan, arrays)
    split = stream.stream_plain(stream.plan_stream(p), arrays)
    for o in want:
        ok, fig = stream.bf16_passes_agree(want[o].cpu().numpy(),
                                           got[o].cpu().numpy(),
                                           split[o].cpu().numpy())
        print(f"{name} {passes}: {fig}")
        assert ok, fig


# -- K4's reduced precisions: single-pass bf16 passes in the chunk, shard
# and segment modes, bf16 rings on shards ---------------------------------------

def _agree(want, got, split, label):
    """``stream.bf16_passes_agree`` of every output."""
    for o in want:
        ok, fig = stream.bf16_passes_agree(want[o].cpu().numpy(),
                                           got[o].cpu().numpy(),
                                           split[o].cpu().numpy())
        print(f"{label} {o}: {fig}")
        assert ok, fig


def _banded(shape, dims, stages=2):
    return port.parse_program(synthesize_stencil(
        num_stages=stages, dimensions=dims, shape=shape, extent=2,
        seed_data="random:0,1"))


@pytest.mark.cuda
@pytest.mark.parametrize("passes", ["auto", "fma", "mma"])
@pytest.mark.parametrize("shape", ["box", "cross"])
def test_k4_chunk_bf16_passes_match_plain_on_card(shape, passes, cuda):
    """K4 in chunk mode under ``mxu_precision="bf16"``, chunk by chunk:
    each launch counts in ``local_bf16_launches`` and agrees with its
    plain version, apart from the split route's."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    p = _banded(shape, (48, 48, 72))
    an = port.ChainAnalysis.run(p)
    kw = {} if passes == "auto" else {"passes": passes}
    h = chain_halo(an)[0]
    plan = stream.plan_local(p, an, 16, h, mxu_precision="bf16", **kw)
    split = stream.plan_local(p, an, 16, h, **kw)
    assert plan.tkeys and not plan.packed and stream.reduced(plan)
    lib = stream.build_stream(plan)
    inputs = port.load_input_arrays(p, seed=4)
    for lo, slabs in _chunks(p, inputs, 3, plan, cuda):
        before = stream.launches_by["local_bf16"]
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.launches_by["local_bf16"] == before + 1
        _agree(stream.local_stream_plain(plan, lo, slabs), got,
               stream.local_stream_plain(split, lo, slabs),
               f"{shape} {passes} chunk {lo}")


@pytest.mark.cuda
def test_run_program_host_chunks_bf16_on_card(cuda):
    """``run_program(host_chunks=4, mxu_precision="bf16")``: K4's bf16
    passes on every chunk, verified against the oracle at
    BF16_VERIFY_RTOL."""
    p = _banded("box", (64, 64, 64))
    before = stream.launches_by["local_bf16"]
    res = run_program(p, device=cuda, host_chunks=4, mxu_precision="bf16",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "outofcore[stream x4 chunks]"
    assert res.verified_against_reference
    # warm-up + 1 run
    assert stream.launches_by["local_bf16"] == before + 2 * 4


def _k4_shards(p, mesh_args, cuda, **kw):
    """(sharded fn, decomposition, widened shards) of K4 on virtual
    shards of the card."""
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    shape, names, axes = mesh_args
    fn, plan = compile_sharded_chain(p, make_mesh([cuda], shape, names),
                                     axes, **kw)
    assert fn.last_config["backend"] == "stream"
    placed = place_global_inputs(p, plan, port.load_input_arrays(p, seed=4))
    return fn, plan, placed


JK_MESH = ((2, 2), ("x", "y"), (None, "x", "y"))
IJK_MESH = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))
# name: (program, mesh, options)
SHARD_BF16_RINGS = {
    "jacobi-jk": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(8, 40, 72), shape="diffusion",
        boundary_value=0.5, seed_data="random:0,1"), JK_MESH, {}),
    "jacobi-copy-ijk": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(16, 24, 40), shape="diffusion",
        boundary="copy", seed_data="random:0,1"), IJK_MESH, {}),
    "hdiff-jk": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 32, 48), shape="hdiff",
        seed_data="random:0,1"), JK_MESH, {}),
    "hotspot-spilled-jk": (lambda: synthesize_stencil(
        num_stages=3, dimensions=(8, 40, 48), shape="hotspot",
        seed_data="random:0,1"), JK_MESH, {"spill": "all"}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHARD_BF16_RINGS))
def test_k4_shard_bf16_rings_match_plain_on_card(name, cuda):
    """K4 in shard mode under ``ring_storage="bfloat16"``: shard by shard
    bit for bit against its plain version (an i-sharded mesh's outputs
    leave through the rounded rings), one launch a shard counted in
    ``shard_bf16_launches``."""
    make, mesh_args, kw = SHARD_BF16_RINGS[name]
    p = port.parse_program(make())
    fn, plan, placed = _k4_shards(p, mesh_args, cuda,
                                  ring_storage="bfloat16", **kw)
    splan = fn.plan
    assert splan.rounds and bool(splan.rounds_out) == ("ijk" in name)
    assert splan.packed == ("spilled" in name)
    for c, tiles in fn.exchange(placed).items():
        oi, oj, ok = plan.block_origin(c)
        args = (oi - plan.halo[0], tiles)
        before = stream.launches_by["shard_bf16"]
        got = stream.run_local_stream(splan, *args, None, oj, ok,
                                      plan.instance(c))
        torch.cuda.synchronize()
        assert stream.launches_by["shard_bf16"] == before + 1
        want = stream.local_stream_plain(splan, *args, oj, ok,
                                         plan.instance(c))
        for o in p.outputs:
            np.testing.assert_array_equal(got[o].cpu().numpy(),
                                          want[o].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", ["auto", "fma", "mma"])
@pytest.mark.parametrize("shape", ["box", "cross"])
def test_k4_shard_bf16_passes_match_plain_on_card(shape, passes, cuda):
    """K4 in shard mode under ``mxu_precision="bf16"`` on a 2 x 2 mesh:
    each shard's launch (its slice of the origin-aware bf16 bands, f32
    correction planes) agrees with its plain version, apart from the
    split route's."""
    p = _banded(shape, (8, 64, 64))
    kw = {} if passes == "auto" else {"passes": passes}
    fn, plan, placed = _k4_shards(p, JK_MESH, cuda, mxu_precision="bf16")
    if kw:   # the forced route on the same shard plan's geometry
        from stencilflow_tpu_torch.parallel.domain import _shard_contexts
        fn.plan = stream.plan_local(
            fn.plan.program, fn.plan.analysis, plan.block[0], plan.halo[0],
            mxu_precision="bf16", shard=plan.block[1:],
            xhalo=plan.halo[1:], contexts=_shard_contexts(plan), **kw)
    split, _ = _k4_shards(p, JK_MESH, cuda)[:2]
    splan = fn.plan
    assert splan.tkeys and stream.reduced(splan)
    for c, tiles in fn.exchange(placed).items():
        oi, oj, ok = plan.block_origin(c)
        args = (oi - plan.halo[0], tiles)
        inst = plan.instance(c)
        before = stream.launches_by["shard_bf16"]
        got = stream.run_local_stream(splan, *args, None, oj, ok, inst)
        torch.cuda.synchronize()
        assert stream.launches_by["shard_bf16"] == before + 1
        _agree(stream.local_stream_plain(splan, *args, oj, ok, inst), got,
               stream.local_stream_plain(split.plan, *args, oj, ok, inst),
               f"{shape} {passes} shard {c}")


@pytest.mark.cuda
def test_k4_segment_bf16_passes_match_plain_on_card(cuda, monkeypatch):
    """compile_pipeline_split(mxu_precision="bf16") over 2 positions
    repeating the card: every segment's K4 launch (counted in
    ``local_bf16_launches``) agrees with its plain version on the same
    tiles (the in-domain planes), apart from the split segments'."""
    from stencilflow_tpu_torch.parallel import compile_pipeline_split
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    calls = []
    launch = stream.run_local_stream

    def record(plan, origin_i, slabs, lib=None, *rest):
        got = launch(plan, origin_i, slabs, lib, *rest)
        calls.append((plan, origin_i, dict(slabs), got))
        return got
    monkeypatch.setattr(stream, "run_local_stream", record)
    p = _banded("box", (16, 40, 48))
    mesh = make_mesh([cuda], (2,), ("p",))
    fn, plan = compile_pipeline_split(p, mesh, "p", mxu_precision="bf16")
    split, _ = compile_pipeline_split(p, mesh, "p")
    assert fn.last_config["backend"] == "stream"
    before = stream.launches_by["local_bf16"]
    fn(port.load_input_arrays(p, seed=4))
    torch.cuda.synchronize()
    S, C = len(plan.segments), plan.num_chunks
    assert stream.launches_by["local_bf16"] - before == S * C == len(calls)
    I = p.dimensions[0]
    for sp, oi, slabs, got in calls:
        s = fn.stream_plans.index(sp)
        assert sp.tkeys and stream.reduced(sp)
        g0 = oi + sp.halo_i
        lo, hi = max(0, -g0), min(sp.block, I - g0)

        def core(out):
            return {o: v[lo:hi] for o, v in out.items()}
        _agree(core(stream.local_stream_plain(sp, oi, slabs)), core(got),
               core(stream.local_stream_plain(split.stream_plans[s], oi,
                                              slabs)),
               f"segment {s} origin {oi}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["whole", "chunk"])
def test_bf16_passes_of_a_plane_input_on_card(mode, cuda):
    """A banded stage's transform of a (j, k) input, which has no ring and
    is summed on the fly from device memory, under bf16 passes (the
    j-pass first, each sum rounded): K3b whole and K4 chunk by chunk
    agree with their plain versions, apart from the split route's."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    terms = " + ".join(f"0.04 * c[j{dj:+d},k{dk:+d}]"
                       for dj in range(-2, 3) for dk in range(-2, 3))
    bc = {"type": "constant", "value": 0.0}
    p = port.parse_program({
        "inputs": {"a": {"data": "random:0,1", "data_type": "float32"},
                   "c": {"data": "random:0,1", "data_type": "float32",
                         "input_dims": ["j", "k"]}},
        "outputs": ["s0"], "dimensions": [24, 40, 72],
        "program": {"s0": {
            "computation_string": "s0 = a[i,j,k] + " + terms.replace(
                "+0", "").replace("-0", ""),
            "boundary_conditions": {"a": bc, "c": bc},
            "data_type": "float32"}}})
    inputs = port.load_input_arrays(p, seed=4)
    if mode == "whole":
        plan = stream.plan_stream(p, mxu_precision="bf16")
        split = stream.plan_stream(p)
        assert plan.mxu_plans and not plan.tkeys
        arrays = spanned_arrays(p, inputs, device=cuda)
        before = stream.launches_by["bf16"]
        got = stream.run_stream(plan, arrays)
        torch.cuda.synchronize()
        assert stream.launches_by["bf16"] == before + 1
        _agree(stream.stream_plain(plan, arrays), got,
               stream.stream_plain(split, arrays), "plane input whole")
        return
    an = port.ChainAnalysis.run(p)
    h = chain_halo(an)[0]
    plan = stream.plan_local(p, an, 8, h, mxu_precision="bf16")
    split = stream.plan_local(p, an, 8, h)
    lib = stream.build_stream(plan)
    for lo, slabs in _chunks(p, inputs, 3, plan, cuda):
        before = stream.launches_by["local_bf16"]
        got = stream.run_local_stream(plan, lo, slabs, lib)
        torch.cuda.synchronize()
        assert stream.launches_by["local_bf16"] == before + 1
        _agree(stream.local_stream_plain(plan, lo, slabs), got,
               stream.local_stream_plain(split, lo, slabs),
               f"plane input chunk {lo}")


def _kernel_counts():
    """Every kernel route's launch count (the bf16 and spilled variants
    with their route)."""
    from stencilflow_tpu_torch.backend import tile
    return {"panel": panel.launches_by["exact"] + panel.launches_by["bf16"],
            "overlap": overlap.launches_by["exact"],
            "stream": sum(stream.launches_by[k] for k in (
                "exact", "spill", "bf16", "spill_bf16")),
            "group": group.launches_by["exact"] + group.launches_by["bf16"],
            "tile": tile.launches_by["exact"],
            "local_stream": (stream.launches_by["local"]
                             + stream.launches_by["local_bf16"])}


def _zero_kernel_counts():
    from stencilflow_tpu_torch.backend import tile
    for m in (panel, overlap, group, tile, stream):
        m.launches_by["exact"] = 0
    panel.launches_by["bf16"] = group.launches_by["bf16"] = 0
    for k in ("spill", "bf16", "spill_bf16", "local", "local_bf16"):
        stream.launches_by[k] = 0


def _route_kernel(lowering: str) -> str:
    """The kernel a lowering label launches."""
    if lowering.startswith("outofcore[stream"):
        return "local_stream"
    inner = lowering.split("+")[-1]
    return "group" if inner.startswith("group") else inner


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["walkthrough", "gray_scott",
                                  "shallow_water", "wave_propagation",
                                  "implicit_diffusion", "inverse_problem",
                                  "outofcore_weather", "sdfg_roundtrip"])
def test_example_on_card(name, cuda, tmp_path, monkeypatch):
    """Each ported example at its own size on the card, through its own
    oracle assertions; every lowering it names launched its kernel
    (counts reset just before, read just after)."""
    import importlib
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"stencilflow_tpu_torch.examples.{name}")
    _zero_kernel_counts()
    lowerings = module.main(device="cuda")
    torch.cuda.synchronize()
    counts = _kernel_counts()
    for lowering in lowerings:
        assert counts.get(_route_kernel(lowering), 0) >= 1, \
            (name, lowering, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("route,spec", [
    ("panel", dict(num_stages=8, dimensions=(64, 64, 64),
                   shape="diffusion")),
    ("stream", dict(num_stages=2, dimensions=(64, 64, 64), shape="box",
                    extent=2)),
    ("rows+group_g8", dict(num_stages=4, dimensions=(256, 256),
                           shape="diffusion"))])
def test_cli_compile_builds_what_the_route_launches(route, spec, cuda,
                                                    tmp_path, monkeypatch):
    """``cli compile`` writes and builds the source that
    ``compile_chain_best`` hands to ``build.load_library`` for the
    program, and the built library is the one that route loads."""
    from stencilflow_tpu_torch.backend import build, compile_chain_best
    from stencilflow_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    with open("prog.json", "w") as f:
        json.dump(synthesize_stencil(**spec), f)
    assert main(["compile", "prog.json", "-o", "k.cu"]) == 0
    written = open("k.cu").read()
    p = port.parse_program("prog.json")
    real, handed = build.load_library, []

    def recording(source, name):
        handed.append((source, name))
        return real(source, name)
    monkeypatch.setattr(build, "load_library", recording)
    fn, backend = compile_chain_best(p, device="cuda")
    assert backend == route
    assert [s for s, _ in handed] == [written]
    assert os.path.isfile(build.library_path(written, handed[0][1]))
    _zero_kernel_counts()
    out = fn(port.load_input_arrays(p, seed=0))
    torch.cuda.synchronize()
    assert _kernel_counts()[_route_kernel(backend)] == 1
    want = port.run_interpreter(p, port.load_input_arrays(p, seed=0))
    for o in p.outputs:
        got = out[o].cpu().numpy()
        if backend == "stream":   # banded stages: another summation order
            assert port.arrays_are_equal(np.asarray(want[o]), got,
                                         MXU_VERIFY_RTOL)
        else:
            assert np.array_equal(got, np.asarray(want[o]))


# -- bf16 compute, the sharded engine's overlap, P1's variant bodies ----------

def _bf16_compute_cases():
    def synth(shape, dims, iters, **kw):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0,1", **kw))
    return {
        "K3a-jacobi": (synth("diffusion", (24, 40, 72), 4), {"mxu": "off"}),
        "K3a-hotspot": (synth("hotspot", (16, 40, 72), 3,
                              boundary_value=0.3), {}),
        "K3b-box-r2-mma": (synth("box", (16, 40, 72), 3, extent=2), {}),
        "K3b-box-bc0.7-fma": (synth("box", (16, 40, 72), 2, extent=2,
                                    boundary_value=0.7), {"passes": "fma"}),
        "K3c-jacobi-spilled": (synth("diffusion", (24, 40, 72), 3,
                                     boundary="copy"), {"spill": "all"}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_bf16_compute_cases()))
def test_bf16_compute_matches_plain_on_card(name, cuda):
    """compute_dtype="bfloat16": the kernel on bf16 arrays against its
    plain version (``stream.bf16_compute_agree``: bit for bit per cell,
    at least BF16_COMPUTE_SHARE equal and every cell within
    BF16_VERIFY_RTOL banded), one launch counted under "compute_bf16"
    ("spill_compute_bf16" on the spill rung), and the entry point equal
    to it."""
    p, kw = _bf16_compute_cases()[name]
    plan = stream.plan_stream(p, compute_dtype="bfloat16", **kw)
    assert plan.packed == name.startswith("K3c")
    assert bool(plan.mxu_plans) == name.startswith("K3b")
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    key = "spill_compute_bf16" if plan.packed else "compute_bf16"
    assert stream.compute_key(plan) == key
    before = stream.launches_by[key]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by[key] == before + 1
    want = stream.stream_plain(plan, arrays)
    for o in p.outputs:
        assert got[o].dtype == torch.float32
        ok, fig = stream.bf16_compute_agree(
            want[o].cpu().numpy(), got[o].cpu().numpy(),
            bool(plan.mxu_plans))
        assert ok, fig
    # the entry point (compile_chain_stream takes no ``passes``: the plan
    # then goes through compile_stream_plan, the function beneath it)
    fn = stream.compile_stream_plan(plan, cuda) if "passes" in kw else \
        stream.compile_chain_stream(p, compute_dtype="bfloat16", **kw)
    again = fn(port.load_input_arrays(p, seed=4))
    for o in p.outputs:
        assert torch.equal(again[o].reshape(got[o].shape), got[o])


def _compute_type_cases():
    """(program, plan keywords, compute type) of the compute types on
    programs typed other than float32 and of int32 and bool compute, as
    chip_smoke.py's phase 3 runs them, smaller: the mixed-type chain and
    the bf16 chain with an int32 stage under float32, bf16 and f16, and
    jacobi3d on [-1000, 1000) under int32 and bool, each as K3a and as
    K3c (``spill="all"``)."""
    from stencilflow_tpu_torch.synthesize import (mixed_dtype_spec,
                                                  narrow_mixed_spec)
    dims = (16, 24, 40)
    progs = {"mixed": port.parse_program(mixed_dtype_spec(dims)[0]),
             "narrow": port.parse_program(narrow_mixed_spec(dims)),
             "jacobi": port.parse_program(synthesize_stencil(
                 num_stages=3, dimensions=(24, 40, 72), shape="diffusion",
                 seed_data="random:-1000,1000"))}
    cases = {}
    for prog, cds in (("mixed", ("float32", "bfloat16", "float16")),
                      ("narrow", ("float32", "bfloat16", "float16")),
                      ("jacobi", ("int32", "bool"))):
        for cd in cds:
            for kernel, kw in (("K3a", {}), ("K3c", {"spill": "all"})):
                cases[f"{kernel}-{prog}-{cd}"] = (progs[prog], kw, cd)
    return cases


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_compute_type_cases()))
def test_compute_type_matches_plain_on_card(name, cuda):
    """compute_dtype on a program typed other than float32, and int32 and
    bool compute: the kernel on arrays of the compute type against its
    plain version bit for bit (NaN == NaN; within VERIFY_RTOL where the
    bf16 chain's transcendentals meet float32 compute: libdevice against
    torch's own), one launch counted under ``stream.compute_key``, and
    the entry point equal to it."""
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    p, kw, cd = _compute_type_cases()[name]
    plan = stream.plan_stream(p, compute_dtype=cd, **kw)
    assert plan.packed == name.startswith("K3c") and not plan.mxu_plans
    key = stream.compute_key(plan)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=4),
                            device=cuda)
    before = stream.launches_by[key]
    got = stream.run_stream(plan, arrays)
    torch.cuda.synchronize()
    assert stream.launches_by[key] == before + 1
    want = stream.stream_plain(plan, arrays)
    loose = name.startswith("K3a-narrow-float32") or name.startswith(
        "K3c-narrow-float32")
    for o in p.outputs:
        assert got[o].dtype == want[o].dtype
        if loose and got[o].dtype == torch.bfloat16:
            assert port.arrays_are_equal(want[o].float().cpu().numpy(),
                                         got[o].float().cpu().numpy(),
                                         VERIFY_RTOL)
        else:
            assert torch.equal(_bits(got[o]), _bits(want[o])) or \
                np.array_equal(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               equal_nan=True)
    fn = stream.compile_chain_stream(p, compute_dtype=cd, **kw)
    again = fn(port.load_input_arrays(p, seed=4))
    for o in p.outputs:
        assert torch.equal(_bits(again[o].reshape(got[o].shape)),
                           _bits(got[o]))


# -- the wider matrix of chip_smoke.py's phase 3 ------------------------------

class _BuildOnMiss(dict):
    """chip_smoke.py's ``lib_of`` (source -> built kernel), building a
    source the first time it is asked for."""

    def __missing__(self, src):
        from stencilflow_tpu_torch.backend import build
        self[src] = build.load_library(src, "moved")
        return self[src]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", ["diffusion", "hdiff"])
@pytest.mark.parametrize("kind", ["chunk", "shard", "masked", "fast"])
def test_narrow_k4_k6_launches_match_plain_on_card(kind, shape, dt, cuda):
    """jacobi3d and hdiff3d 64^3 x 3 typed bf16 and f16: K4 chunk by chunk
    (4 chunks) and shard by shard over 2 x 2 (shards at non-zero j and k
    origins), K6 masked and fast; every launch against its plain version
    bit for bit and counted under its narrow mode ("local_narrow",
    "shard_narrow", K6's "narrow"), the assembled output bit-equal to the
    host oracle."""
    from stencilflow_tpu_torch.backend import tile
    from stencilflow_tpu_torch.cardcheck import (chunk_slabs, local_plan,
                                                 narrow_held)
    from stencilflow_tpu_torch.dtypes import to_numpy
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    p = port.parse_program(synthesize_stencil(
        num_stages=3, dimensions=(64,) * 3, shape=shape,
        seed_data="random:0.0,1.0", data_type=dt))
    libs = _BuildOnMiss()
    for module, mode in ((stream, "local_narrow"), (stream, "shard_narrow"),
                         (tile, "narrow")):
        module.launches_by[mode] = 0
    inputs = port.load_input_arrays(p, seed=7)
    o = p.outputs[0]
    want_o = port.run_interpreter(p, inputs)[o]
    full = np.zeros(p.dimensions, want_o.dtype)
    pieces = []
    if kind == "chunk":
        module, mode = stream, "local_narrow"
        plan = local_plan(p, 4)
        lib = libs[stream.stream_source(plan)]
        for c in range(4):
            lo = c * plan.block - plan.halo_i
            slabs = chunk_slabs(p, inputs, lo, plan.extent())
            pieces.append((stream.run_local_stream(plan, lo, slabs, lib),
                           stream.local_stream_plain(plan, lo, slabs),
                           slice(c * plan.block, (c + 1) * plan.block)))
        want_n = 4
    elif kind == "shard":
        module, mode = stream, "shard_narrow"
        jk = make_mesh([cuda], (2, 2), ("x", "y"))
        fn, dplan = compile_sharded_chain(p, jk, (None, "x", "y"))
        assert fn.plan is not None
        plan = fn.plan
        lib = stream.build_stream(plan)
        per = fn.exchange(place_global_inputs(p, dplan, inputs))
        for c, tiles in per.items():
            oi, oj, ok = dplan.block_origin(c)
            args = (oi - dplan.halo[0], tiles)
            extra = (oj, ok, dplan.instance(c))
            pieces.append((
                stream.run_local_stream(plan, *args, lib, *extra),
                stream.local_stream_plain(plan, *args, *extra),
                tuple(slice(a, a + b) for a, b in zip((oi, oj, ok),
                                                      dplan.block))))
        want_n = 4
    else:
        module, mode = tile, "narrow"
        plan = tile.plan_tile(p, mode=kind)
        lib = libs[tile.tile_source(plan)]
        arrays = spanned_arrays(p, inputs, device=cuda)
        pieces.append((tile.run_tile(plan, arrays, lib),
                       tile.tile_plain(plan, arrays), slice(None)))
        want_n = 1
    torch.cuda.synchronize()
    assert module.launches_by[mode] == want_n
    for got, want, at in pieces:
        g = to_numpy(got[o])
        ok, err = narrow_held(g, to_numpy(want[o]), 0.0)
        assert ok, err
        full[at] = g.reshape(full[at].shape)
    ok, err = narrow_held(full, want_o, 0.0)
    assert ok, err


def _smoke_programs():
    """The three example programs at full size and the five random
    chains of ``cardcheck.FUZZ_VARIANTS`` (BC kinds, input ranks and
    dtypes)."""
    from stencilflow_tpu_torch.cardcheck import fuzz_programs
    examples = [(n, port.parse_program(os.path.join(ROOT, "examples",
                                                    n + ".json")))
                for n in ("jacobi3d_32x32x32_8itr", "hdiff_64x64x64",
                          "forked_box_chain")]
    return dict(examples + [(label.rsplit("-", 1)[0], p) for label, p
                            in fuzz_programs()])


SMOKE_PROGRAMS = ["jacobi3d_32x32x32_8itr", "hdiff_64x64x64",
                  "forked_box_chain", "fuzz-f32", "fuzz-f64-shrink",
                  "fuzz-i32", "fuzz-f32-shrink", "fuzz-f32-2d"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMOKE_PROGRAMS)
@pytest.mark.parametrize("kernel", ["panel", "overlap", "masked", "fast"])
def test_kernel_matches_plain_on_smoke_programs_on_card(kernel, name, cuda):
    """K1, K2 and K6 (masked and fast), each forced through its own plan,
    against its plain version on the card on the example programs and
    the random chains (chip_smoke.py's phase 3 runs two of the chains):
    bit-exact, one launch each."""
    from stencilflow_tpu_torch.backend import tile
    p = _smoke_programs()[name]
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=7),
                            device=cuda)
    if kernel in ("masked", "fast"):
        module = tile
        plan = tile.plan_tile(p, mode=kernel)
        before = module.launches_by["exact"]
        got = tile.run_tile(plan, arrays)
        want = tile.tile_plain(plan, arrays)
    else:
        module, plan_cls, run, plain = KERNELS[kernel]
        an = port.ChainAnalysis.run(p)
        plan = plan_cls.build(an)
        before = module.launches_by["exact"]
        got = run(p, an, plan, arrays)
        want = plain(p, an, plan, arrays)
    torch.cuda.synchronize()
    assert module.launches_by["exact"] == before + 1
    for o in p.outputs:
        assert np.array_equal(got[o].cpu().numpy(), want[o].cpu().numpy(),
                              equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,axes,lb", [
    ("stream-i", (2,), ("x", None, None), "stream"),
    ("stream-i4", (4,), ("x", None, None), "stream"),
    ("tile-jk", (2, 2), (None, "x", "y"), "xla")])
def test_overlap_equals_blocking_on_card(name, shape, axes, lb, cuda):
    """comm_overlap=True on virtual shards of the card: the exchange on a
    side stream, interiors (and strips) on the compute stream; 3 K4
    launches a shard on the stream body; equal to the blocking call bit
    for bit over 12 repeated calls (a strip launched before the exchange
    landed would read stale slabs only sometimes)."""
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    p = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(64, 40, 72), shape="diffusion",
        seed_data="random:0,1", boundary="copy"))
    names = ("x", "y")[:len(shape)]
    mesh = make_mesh([cuda], shape, names)
    fn, plan = compile_sharded_chain(p, mesh, axes, local_backend=lb,
                                     comm_overlap=True)
    assert fn.last_config["comm_overlap"]
    assert fn.last_config["backend"] == ("stream" if lb == "stream"
                                         else "xla")
    block, _ = compile_sharded_chain(p, mesh, axes, local_backend=lb)
    placed = place_global_inputs(p, plan, port.load_input_arrays(p, seed=4))
    want = block(placed)[p.outputs[0]].numpy()
    before = stream.launches_by["shard"]
    for _rep in range(12):
        got = fn(placed)[p.outputs[0]].numpy()
        np.testing.assert_array_equal(got, want)
    if lb == "stream":
        assert stream.launches_by["shard"] - before == 12 * 3 * mesh.size


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul4", "expr_jac2d", "expr_jac2d_shift",
                                "expr_lim_sel", "expr_lim_mask",
                                "expr_lim_minmax", "selc", "maskmul"])
def test_alu_variant_matches_plain_on_card(op, cuda):
    """P1's variant bodies equal their plain versions bit for bit."""
    from stencilflow_tpu_torch.probes import alu_ceiling
    x = alu_ceiling.inputs(1024, cuda)
    for steps in (1, 3):
        got = alu_ceiling.alu(op, x, steps)
        torch.cuda.synchronize()
        ok, err = alu_ceiling.compare(op, got,
                                      alu_ceiling.alu_plain(op, x, steps))
        assert ok, f"{op}: max abs diff {err}"


# -- narrow K1 and K4: grouped cp.async loads, native bf16 / f16 operations --

@pytest.mark.cuda
def test_native_narrow_ops_equal_the_float_path_on_card(cuda):
    """add.rn / sub.rn / mul.rn in bf16 and f16, as the typed emitter
    emits them (``sf_bf_add``, ``sf_h_mul``, ...), equal the float32
    operation rounded once (the float path they replace) on all 2^32
    operand pairs of each, NaNs included, bit for bit: 0 mismatches."""
    from stencilflow_tpu_torch.probes import narrow_ops
    before = narrow_ops.launches
    counts, first = narrow_ops.mismatches(device=cuda)
    assert narrow_ops.launches == before + 1
    assert sum(counts.values()) == 0, (counts, first)


# special 2-byte patterns put into the inputs: NaNs with payloads and
# signs, infinities, subnormals, and pairs that meet at rounding ties
# (1 + 2^-8 in bf16, 1 + 2^-11 in f16)
_SPECIALS = {"bfloat16": (0x7fc1, 0xffc0, 0x7f80, 0xff80, 0x0001, 0x8003,
                          0x007f, 0x3f80, 0x3b80, 0xbb80),
             "float16": (0x7e01, 0xfe00, 0x7c00, 0xfc00, 0x0001, 0x8003,
                         0x03ff, 0x3c00, 0x1000, 0x9000)}


def _special_values(shape, dt, seed):
    """Random values of ``dt`` in [-2, 3) with 0.2 % of the cells set to
    ``_SPECIALS`` (so that most outputs stay numbers through a chain of
    8 stages), as a numpy array of the port's type."""
    from stencilflow_tpu_torch import dtypes
    rng = np.random.default_rng(seed)
    a = dtypes.cast(rng.uniform(-2, 3, shape), dtypes.str_to_dtype(dt))
    bits = a.view(np.uint16).copy()
    hit = rng.random(shape) < 0.002
    bits[hit] = rng.choice(np.array(_SPECIALS[dt], np.uint16), hit.sum())
    return bits.view(a.dtype)


def _aligned_case(name, dt):
    """(program, plan, run(arrays), plain(arrays), arrays' shape, count)
    of the alignment branches of the narrow loader: K1 on odd K (the
    synchronous loads), an odd left halo (widened to groups of 2), a halo
    of 8 (groups of 8); K4 on a chunk at an odd i origin, on shards whose
    exchanged halo or core is odd (synchronous) or even (groups)."""
    def jac(dims, iters):
        return port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape="diffusion",
            seed_data="random:0.0,1.0", data_type=dt))
    if name.startswith("K1"):
        dims, iters, groups = {"K1 odd K": ((12, 20, 37), 3, {}),
                               "K1 odd halo": ((12, 20, 48), 3, {"a": 2}),
                               "K1 halo 8": ((12, 24, 64), 8, {"a": 8})}[
                                   name]
        p = jac(dims, iters)
        an = port.ChainAnalysis.run(p)
        plan = panel.PanelPlan.build(an)
        assert plan.copy_groups == groups
        return (p, lambda a: panel.run_panel(p, an, plan, a),
                lambda a: panel.panel_plain(p, an, plan, a), p.dimensions,
                lambda: panel.launches_by["narrow"])
    p = jac((24, 20, 48) if name == "K4 chunk" else (16, 32, 46), 3)
    an = port.ChainAnalysis.run(p)
    if name == "K4 chunk":
        plan = stream.plan_local(p, an, 8, 3, mxu="off")
        assert plan.copy_groups == {"a": 2}
        org = (5, 0, 0)   # chunk 1 of 3: an odd i origin
    else:
        shard, xhalo, groups = {
            "K4 shard odd halo": ((16, 23), (3, 3), {}),
            "K4 shard odd core": ((16, 23), (4, 4), {}),
            "K4 shard": ((16, 23), (4, 4), {})}[name]
        if name == "K4 shard":
            p = jac((16, 32, 48), 3)
            an = port.ChainAnalysis.run(p)
            shard, groups = (16, 24), {"a": 2}
        plan = stream.plan_local(p, an, 16, 0, mxu="off", shard=shard,
                                 xhalo=xhalo)
        assert plan.copy_groups == groups
        org = (0, 16, shard[1])   # the shard at (1, 1)
    key = "shard_narrow" if plan.shard[0] else "local_narrow"
    return (p, lambda a: stream.run_local_stream(plan, org[0], a, None,
                                                 org[1], org[2]),
            lambda a: stream.local_stream_plain(plan, org[0], a, org[1],
                                                org[2]),
            (plan.extent(),) + plan.plane(),
            lambda: stream.launches_by[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["K1 odd K", "K1 odd halo", "K1 halo 8",
                                  "K4 chunk", "K4 shard odd halo",
                                  "K4 shard odd core", "K4 shard"])
def test_narrow_loads_and_ops_match_plain_on_card(name, dt, cuda):
    """K1 and K4 typed bf16 and f16 on every branch of the loader's
    alignment, on inputs carrying NaNs, infinities, subnormals and
    rounding ties: one launch, equal to the plain version bit for bit
    (2-byte patterns, NaNs included)."""
    from stencilflow_tpu_torch import dtypes
    p, run, plain, shape, count = _aligned_case(name, dt)
    arrays = {n: dtypes.to_torch(_special_values(shape, dt, 7 + i), cuda)
              for i, n in enumerate(p.inputs)}
    before = count()
    got = run(arrays)
    torch.cuda.synchronize()
    assert count() == before + 1
    want = plain(arrays)
    for o in p.outputs:
        assert got[o].dtype == want[o].dtype
        assert torch.equal(got[o].view(torch.int16), want[o].view(
            torch.int16)), o

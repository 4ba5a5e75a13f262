"""The stream kernel's on-chip body (K3a, K3b, K4: ``codegen.stream_source``
for plans off the spill rung) on the CPU.

The generated CUDA source also compiles with g++ (``sf_host_launch``: one
thread runs each block over shared memory filled with NaN; the
``cp.async`` loads of the input planes are copies at the point of issue
and their waits do nothing; ``sf_mma_band``, the tensor-core band
product, has a host version that computes the same three TF32 products
per element).  That build runs the kernel's own schedule — ring slots
from per-step counters, a thread's cell from one division before the
march, the mask-free or the masked body per block and step, input planes
a step ahead, each transform at its reader's step, shared memory packed
by liveness (``stream.pack_layout``) — and is held to the plain version
(``stream_plain``) and the numpy oracle: bit for bit on per-cell programs
(np.array_equal: no transcendental here), within MXU_VERIFY_RTOL (3e-5,
the JAX package's envelope for banded stages: the passes sum in another
order than the plain version's torch.matmul) on banded ones, whole and
chunk by chunk (K4: first, interior and last chunks).  The plain version
is held to the JAX package by tests/test_torch_stream.py and
tests/test_torch_outofcore.py; the CUDA build to the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.  Three deliberately
wrong schedules (every block mask-free, a transform plane packed over a
live ring, no slot for the plane in flight) must show as mismatches here,
and the sources of the other kernels (K1, K2, K3c, K5, K6), of K3b and of
K4's chunk and shard modes (f32: the reduced-precision branches leave
them as they were) must not move.
"""
import ctypes
import hashlib
import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import (codegen, group, overlap, panel,
                                           stream, tile)
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.dense import chain_halo
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.config import H100_SMEM_PER_BLOCK, MXU_VERIFY_RTOL
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil
from test_torch_stream import _gxx, mixed_spec, run_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth(shape, dims, iters, **kw):
    return port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=dims, shape=shape,
        seed_data="random:0,1", **kw))


def _fuzz(seed, **kw):
    return port.parse_program(random_program(np.random.default_rng(seed),
                                             **kw))


# per-cell programs (bit for bit): one per boundary condition, the hdiff
# DAG (rings of one step), hotspot (two inputs, scalars), float64 and
# int32 fuzz chains; each with blocks inside the (j, k) domain
PER_CELL = {
    "jacobi-constant": (lambda: _synth("diffusion", (8, 40, 44), 3,
                                       boundary_value=0.5), (4, 8)),
    "jacobi-copy": (lambda: _synth("diffusion", (8, 40, 44), 3,
                                   boundary="copy"), (4, 8)),
    "jacobi-shrink": (lambda: _synth("diffusion", (8, 40, 44), 3,
                                     boundary="shrink"), (4, 8)),
    "hdiff-dag": (lambda: _synth("hdiff", (5, 52, 60), 2), (4, 8)),
    "hotspot": (lambda: _synth("hotspot", (6, 36, 44), 3), (4, 8)),
    "fuzz-f64-shrink": (lambda: _fuzz(5, ndim=3, data_type="float64",
                                      bc_kinds=("constant", "copy",
                                                "shrink")), (2, 8)),
    "fuzz-i32": (lambda: _fuzz(6, ndim=3, data_type="int32",
                               data="random:-20,20"), (2, 8)),
}
# banded programs (MXU_VERIFY_RTOL): the composed box (a transform ring,
# the i-table, table windows at the edges), the box with a 0.7 boundary
# value (per-stage groups over five planes, correction planes), the
# radius-2 cross (rank 2, transforms at their reader's step) and a
# per-cell stage feeding a wide affine stage that reads two fields
BANDED = {
    "box-composed": (lambda: _synth("box", (20, 40, 48), 4, extent=2),
                     (4, 8)),
    "box-bc0.7": (lambda: _synth("box", (10, 40, 48), 2, extent=2,
                                 boundary_value=0.7), (4, 8)),
    "cross-r2": (lambda: _synth("cross", (12, 44, 48), 3, extent=2),
                 (4, 8)),
    "mixed": (lambda: port.parse_program(mixed_spec((12, 40, 44))), (4, 8)),
}
# the band passes' routes: CUDA cores, tensor cores (split), and "exact"
ROUTES = {"fma": {"passes": "fma"}, "mma": {"passes": "mma"},
          "exact": {"mxu_precision": "exact"}}


def _whole(name, route="fma"):
    if name in PER_CELL:
        make, t = PER_CELL[name]
        return stream.plan_stream(make(), mxu="off", spill="off", tile=t)
    make, t = BANDED[name]
    return stream.plan_stream(make(), tile=t, **ROUTES[route])


def _run_whole(plan, tmp_path, seed=3):
    p = plan.program
    inputs = port.load_input_arrays(p, seed=seed)
    got = run_source(stream.stream_source(plan), p, inputs,
                     [a for _k, a in plan.kernel_pool()], tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    return got, {o: v.numpy() for o, v in want.items()}, inputs


def _exact(p, got, want, inputs):
    oracle = port.run_interpreter(p, inputs)
    for o in oracle:
        g = got[o].reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, want[o].reshape(g.shape))
        np.testing.assert_array_equal(g, oracle[o])


def _close(a, b):
    return port.arrays_are_equal(np.asarray(a), np.asarray(b),
                                 MXU_VERIFY_RTOL)


@pytest.mark.parametrize("name", sorted(PER_CELL))
def test_per_cell_twin_is_exact(name, tmp_path):
    plan = _whole(name)
    assert not plan.packed and not plan.mxu_plans
    got, want, inputs = _run_whole(plan, tmp_path)
    _exact(plan.program, got, want, inputs)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(BANDED))
def test_banded_twin_within_mxu_rtol(name, route, tmp_path):
    make, _t = BANDED[name]
    source = make()
    plan = _whole(name, route)
    assert plan.mxu_plans and not plan.packed
    got, want, inputs = _run_whole(plan, tmp_path)
    oracle = port.run_interpreter(source, inputs)
    for o in oracle:
        assert np.isfinite(got[o]).all()
        assert _close(want[o], got[o])
        assert _close(oracle[o], got[o].reshape(oracle[o].shape))


def test_fixtures_cover_both_bodies_and_routes():
    """Every fixture but the small fuzz chains (their types) has
    mask-free and masked blocks; the banded ones run their passes on the
    route asked for, the composed box meets the edges of its band (table
    windows) in some blocks and not in others."""
    for name in list(PER_CELL) + list(BANDED):
        if name.startswith("fuzz"):
            continue
        plan = _whole(name)
        ntj, ntk = plan.grid()
        assert 0 < plan.inner_blocks() < ntj * ntk, name
    for name in BANDED:
        for route in ("fma", "mma"):
            src = stream.stream_source(_whole(name, route))
            assert ("sf_mma_band<" in src) == (route == "mma"), name
    plan = _whole("box-composed")
    key = plan.tkeys[0][2]
    info = plan.band_info(key, "R")
    assert not info.toeplitz and 0 < info.lo < info.hi < info.n
    assert "tb0R" in stream.stream_source(plan)


def _chunks(p, inputs, plan):
    from stencilflow_tpu_torch.outofcore import _host_slab
    I = p.dimensions[0]
    for c in range(I // plan.block):
        lo = c * plan.block - plan.halo_i
        slabs = {}
        for n, s in p.inputs.items():
            a = np.asarray(inputs[n])
            slabs[n] = _host_slab(a, lo, lo + plan.extent(), I) if (
                not s.is_scalar and s.dim_mask[0]) else torch.as_tensor(a)
        yield c, lo, slabs


# K4: (program, chunks, tile, banded)
LOCAL = {
    "jacobi-copy": (lambda: _synth("diffusion", (24, 40, 44), 3,
                                   boundary="copy"), 3, (4, 8), False),
    "fuzz-i32": (lambda: _fuzz(6, ndim=3, data_type="int32",
                               data="random:-20,20"), 2, (2, 8), False),
    "cross-r2": (lambda: _synth("cross", (24, 44, 48), 2, extent=2), 3,
                 (4, 8), True),
    "box-r2": (lambda: _synth("box", (18, 40, 48), 2, extent=2), 3,
               (4, 8), True),
}


@pytest.mark.parametrize("name,route", [
    (n, r) for n in sorted(LOCAL)
    for r in (("fma", "mma") if LOCAL[n][3] else ("fma",))])
def test_local_twin_first_interior_last(name, route, tmp_path):
    make, chunks, t, banded = LOCAL[name]
    p = make()
    an = port.ChainAnalysis.run(p)
    Ic = p.dimensions[0] // chunks
    plan = stream.plan_local(p, an, Ic, chain_halo(an)[0], tile=t,
                             passes=route, spill="off")
    assert bool(plan.mxu_plans) == banded and not plan.packed
    src = stream.stream_source(plan)
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
    for c, lo, slabs in _chunks(p, inputs, plan):
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
            core = oracle[o][c * Ic:(c + 1) * Ic]
            if banded:
                assert np.isfinite(got).all()
                assert _close(want[o].numpy(), got) and _close(core, got)
            else:
                np.testing.assert_array_equal(got, want[o].numpy())
                np.testing.assert_array_equal(got, core)


# -- the source and the plans -----------------------------------------------

def _march(src):
    """The block body's i-march, comments dropped."""
    body = src[src.index("for (int t = 0;"):src.index(
        "#ifdef __CUDACC__\n__global__")]
    return "\n".join(line.split("//")[0] for line in body.splitlines())


def test_no_modulo_or_division_in_reads_or_passes():
    """Every ring and transform read is a base (set once per stage and
    step) plus the thread's cell and a constant; the march has no % or /
    but the constant strides of the region and tile loops."""
    plans = [_whole(n) for n in PER_CELL] + [
        _whole(n, r) for n in BANDED for r in ("fma", "mma")]
    p = LOCAL["cross-r2"][0]()
    an = port.ChainAnalysis.run(p)
    plans.append(stream.plan_local(p, an, 8, chain_halo(an)[0],
                                   tile=(4, 8)))
    for plan in plans:
        body = _march(stream.stream_source(plan))
        ops = re.findall(r"SF_N[TW] [%/] \d+|[%/]", body)
        assert ops and all(o.startswith("SF_N") for o in ops), \
            sorted(set(ops))
        reads = re.findall(r"\b(?:b_\w+|tp\d+|tb\d+_\d+|u\d+)\[[^\]]*\]",
                           body)
        for r in reads:
            assert re.fullmatch(r"\w+\[(p|x\d+)( \+ -?\d+)?\]", r), r
    # the cross's stages read their transforms' scratch tiles (the
    # j-passes run in the stage), the tensor-core route's planes
    assert re.findall(r"u\d+\[x?\w* \+", _march(stream.stream_source(
        _whole("cross-r2"))))
    assert re.findall(r"tp\d+\[", _march(stream.stream_source(
        _whole("cross-r2", "mma"))))


def _cross256():
    return _synth("cross", (256,) * 3, 8, extent=2)


def test_cross256_plan():
    """cross-r2 256^3 x 8: every transform lives within the step (no
    transform ring), and the tile holds at least 128 core cells at most
    50 stage evaluations a cell within a block's shared memory: (16, 16)
    at 30.75 evaluations a cell (the parent's (4, 8) took 120).  On CUDA
    cores a stage's two transforms share one k-pass phase into their
    scratch tiles, which live until the stage sums their j-bands (three
    phases a stage); on tensor cores each transform has a k-pass into its
    scratch and a j-pass into its plane, which lives until the stage."""
    plan = stream.plan_stream(_cross256())
    assert set(plan.instep) == set(plan.tkeys) and not plan.tring
    assert len(plan.tkeys) == 16 and not plan.packed
    assert plan.tile[0] * plan.tile[1] >= 128
    assert plan.evaluations() <= 50
    assert plan.tile == (16, 16) and plan.evaluations() == 30.75
    assert plan.smem_bytes() <= H100_SMEM_PER_BLOCK < plan.unpacked_bytes()
    assert all(plan.fused(t) for t in plan.tkeys)
    assert plan.phases() == 1 + 8 * 2
    n = plan.phases()
    for _p, key, _b, mask, _e in plan.onchip_items():
        t = key[1]
        reader = plan.phase(plan.readers(t)[0])
        assert key[0] == "scratch" and reader == plan.pass_phase(t, "R") + 1
        assert mask == 0b11 << plan.pass_phase(t, "R") and mask < 1 << n
    mma = stream.plan_stream(_cross256(), passes="mma")
    assert mma.tile == (16, 16) and not any(mma.fused(t) for t in mma.tkeys)
    assert mma.phases() == 1 + 8 * 5
    for _p, key, _b, mask, _e in mma.onchip_items():
        t = key[1]
        a, b = mma.pass_phase(t, "R"), mma.pass_phase(t, "L")
        last = b if key[0] == "scratch" else mma.phase(mma.readers(t)[0])
        assert mask == sum(1 << x for x in range(
            a if key[0] == "scratch" else b, last + 1))


def _overlaps(plan):
    """Pairs of shared-memory items live in a common phase whose bytes
    overlap (regions are live in every phase)."""
    lay = plan.spill_layout(ahead=False)
    full = (1 << plan.phases()) - 1
    size = {f: plan.ring_bytes(f) for f in plan.raw_ring}
    size.update(dict(plan.onchip_regions()))
    live = {}
    for f in plan.raw_ring:
        key = f if f in lay.offset else ("ring", f)
        live[key] = lay.live.get(key, full)
        size[key] = size[f]
    for _p, key, nbytes, _m, _e in plan.onchip_items():
        live[key], size[key] = lay.live[key], nbytes
    for key, _n in plan.onchip_regions():
        live[key] = full
    keys = sorted(live, key=str)
    bad = [(a, b) for i, a in enumerate(keys) for b in keys[i + 1:]
           if live[a] & live[b]
           and lay.offset[a] < lay.offset[b] + size[b]
           and lay.offset[b] < lay.offset[a] + size[a]]
    assert max(lay.offset[k] + size[k] for k in keys) <= lay.end
    return bad


def test_packed_layout_never_overlaps_live_items():
    for name in list(PER_CELL) + list(BANDED):
        assert not _overlaps(_whole(name)), name
    for tile in ((8, 16), (16, 16)):
        assert not _overlaps(stream.plan_stream(_cross256(), tile=tile))


def test_box256_plan():
    """box-r2 256^3 x 8 composes into one stage whose transform keeps its
    33-plane ring; its 33-tap bands run on tensor cores under "split" and
    on CUDA cores under "exact"."""
    p = _synth("box", (256,) * 3, 8, extent=2)
    plan = stream.plan_stream(p)
    assert plan.composed and not plan.instep
    assert list(plan.tring.values()) == [33]
    t = plan.tkeys[0]
    assert plan.route(t[1], "L") == plan.route(t[2], "R") == "mma"
    exact = stream.plan_stream(p, mxu_precision="exact")
    assert exact.route(t[1], "L") == "fma"
    cross = stream.plan_stream(_cross256())
    assert {cross.route(k[2], "R") for k in cross.tkeys} == {"fma"}
    with pytest.raises(ValueError, match="split"):
        stream.plan_stream(p, mxu_precision="exact", passes="mma")


def test_local_chunk_plan():
    """K4 on jacobi3d 1024^3 x 8 at 8 chunks keeps its (16, 32) tile, its
    input plane in flight in a slot of its own."""
    p = _synth("diffusion", (1024,) * 3, 8)
    an = port.ChainAnalysis.run(p)
    plan = stream.plan_local(p, an, 128, chain_halo(an)[0])
    assert plan.tile == (16, 32) and not plan.packed
    assert plan.slots("a") == plan.raw_ring["a"] + panel.AHEAD
    assert plan.smem_bytes() <= H100_SMEM_PER_BLOCK


# -- three wrong schedules ----------------------------------------------------

def test_every_block_mask_free_shows(tmp_path, monkeypatch):
    """Taking the mask-free bodies in boundary blocks breaks the result."""
    plan = _whole("jacobi-constant")
    monkeypatch.setattr(stream.StreamPlan, "inner_reach",
                        lambda self: (-10 ** 6, -10 ** 6))
    got, want, _ = _run_whole(plan, tmp_path)
    assert not all(np.array_equal(got[o], want[o]) for o in want)


@pytest.mark.parametrize("route", ["fma", "mma"])
def test_transform_plane_over_a_live_ring_shows(route, tmp_path,
                                               monkeypatch):
    """A transform's plane (on CUDA cores the scratch its stage sums the
    j-band of) placed on its source's ring, which the stage still reads,
    breaks the result."""
    real = stream.pack_layout

    def over_ring(plan, ahead=True):
        lay = real(plan, ahead)
        for t in plan.instep:
            item = ("scratch", t) if plan.fused(t) else ("tplane", t)
            lay.offset[item] = lay.offset[t[0]]
        return lay
    monkeypatch.setattr(stream, "pack_layout", over_ring)
    plan = _whole("cross-r2", route)
    assert plan.instep
    got, want, _ = _run_whole(plan, tmp_path)
    assert not all(_close(want[o], got[o]) for o in want)


def test_no_slot_for_the_plane_in_flight_shows(tmp_path, monkeypatch):
    """Loading plane t + 1 into a ring without its extra slot overwrites
    a plane the step still reads."""
    plan = _whole("jacobi-copy")
    monkeypatch.setattr(plan, "slots", lambda f: plan.raw_ring[f])
    got, want, _ = _run_whole(plan, tmp_path)
    assert not all(np.array_equal(got[o], want[o]) for o in want)


# -- the tensor-core product's host version -------------------------------------

def _tf32(v):
    """cvt.rna.tf32.f32 in numpy: 10 mantissa bits, ties away from 0."""
    u = np.asarray(v, np.float32).view(np.uint32)
    r = ((u.astype(np.uint64) + 0x1000) & 0xffffe000).astype(np.uint32)
    return np.where((u & 0x7f800000) == 0x7f800000, u, r).view(np.float32)


def mma_reference(x, w, taps, ks, table=False):
    """The 16 x 8 tile the three TF32 products give, summed in order."""
    d = np.zeros((16, 8), np.float32)
    for r in range(16):
        for n in range(8):
            acc = np.float32(0)
            for m in range(8 * ks):
                a = x[r, m]
                t = m - n
                b = np.float32(0) if not 0 <= t < taps else (
                    w[t, n] if table else w[t])
                ah, bh = _tf32(a), _tf32(b)
                al, bl = _tf32(a - ah), _tf32(b - bh)
                acc = np.float32(acc + al * bh)
                acc = np.float32(acc + ah * bl)
                acc = np.float32(acc + ah * bh)
            d[r, n] = acc
    return d


def run_mma_probe(lib, x, w, taps, ks, table, device=None):
    """``sf_mma_probe`` (card, ``device``) or ``sf_mma_probe_host`` on one
    tile: X (16 x 8 ks, row-major), the band as a vector or an 8-wide
    table."""
    args = [8 * ks, 1, 16, 8 * ks, 8 if table else 1, 1 if table else 0,
            taps, ks]
    if device is None:
        x, w = np.ascontiguousarray(x), np.ascontiguousarray(w)
        d = np.zeros((16, 8), np.float32)
        fn = lib.sf_mma_probe_host
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
        assert fn(x.ctypes.data, w.ctypes.data, d.ctypes.data, *args) == 0
        return d
    xt = torch.as_tensor(x).to(device)
    wt = torch.as_tensor(w).to(device)
    dt = torch.zeros((16, 8), dtype=torch.float32, device=device)
    fn = lib.sf_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    rc = fn(xt.data_ptr(), wt.data_ptr(), dt.data_ptr(), *args,
            torch.cuda.current_stream(device).cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return dt.cpu().numpy()


def mma_cases():
    rng = np.random.default_rng(11)
    for taps, ks, table in ((5, 2, False), (33, 5, False), (33, 5, True),
                            (41, 6, True)):
        x = rng.standard_normal((16, 8 * ks)).astype(np.float32)
        w = rng.standard_normal((taps, 8) if table else (taps,)).astype(
            np.float32)
        yield taps, ks, table, x, w


def test_mma_host_version_is_the_three_products(tmp_path):
    src = codegen.mma_probe_source()
    cpp, so = tmp_path / "probe.cpp", tmp_path / "probe.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    for taps, ks, table, x, w in mma_cases():
        got = run_mma_probe(lib, x, w, taps, ks, table)
        np.testing.assert_array_equal(got, mma_reference(x, w, taps, ks,
                                                         table))
        exact = np.array([[sum(float(x[r, m]) * float(
            (w[m - n, n] if table else w[m - n])) for m in range(8 * ks)
            if 0 <= m - n < taps) for n in range(8)] for r in range(16)])
        assert np.allclose(got, exact, rtol=1e-5, atol=1e-5)


# -- the other kernels' sources do not move ---------------------------------------

def _example(name, size):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return port.parse_program(spec)


def _panel(p, t=None):
    an = port.ChainAnalysis.run(p)
    return codegen.panel_source(p, an, panel.PanelPlan.build(an, t))


def _overlap(p):
    an = port.ChainAnalysis.run(p)
    return codegen.overlap_source(p, an, overlap.OverlapPlan.build(an))


def _group(p, B, g):
    an = port.ChainAnalysis.run(p)
    return codegen.group_source(p, an, group.plan_group(p, an, B, g))


def _local(p, chunks):
    an = port.ChainAnalysis.run(p)
    return stream.stream_source(stream.plan_local(
        p, an, p.dimensions[0] // chunks, chain_halo(an)[0]))


def _local_spill(p, chunks):
    an = port.ChainAnalysis.run(p)
    return stream.stream_source(stream.plan_local(
        p, an, p.dimensions[0] // chunks, chain_halo(an)[0], spill="all"))


def _shard(p):
    """K4's shard-mode source of ``p`` over a 2 x 2 mesh of (j, k)
    shards, as ``parallel/domain.py`` plans it."""
    from stencilflow_tpu_torch.parallel.domain import (DomainDecomposition,
                                                       _shard_contexts)
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    an = port.ChainAnalysis.run(p)
    plan = DomainDecomposition.plan(p, make_mesh(["cpu"], (2, 2),
                                                 ("x", "y")),
                                    (None, "x", "y"), an)
    return stream.stream_source(stream.plan_local(
        p, an, plan.block[0], plan.halo[0], shard=plan.block[1:],
        xhalo=plan.halo[1:], contexts=_shard_contexts(plan)))


# kernel and fixture: (source, sha256 of the source: K1 and K3c the
# parent's, K2, K5 and K6 the redesigned ones; K3b and K4's chunk mode as
# they were before K4 took a shard origin; K4's f32 shard mode as it was
# before K4 took bf16 passes and rings)
FROZEN = {
    "K1 jacobi3d": (lambda: _panel(_example(
        "jacobi3d_32x32x32_8itr.json", 10)),
        "8c3afdbc1302cef970ad15e0ef2090e611c2dd50947f95932cf14d5c830892de"),
    "K1 hdiff": (lambda: _panel(_example("hdiff_64x64x64.json", 12),
                                (4, 8)),
                 "242edded3ec7716c7d67b0c6b84d6a20f33eab5828c471e22a8f3756ba80edaf"),
    "K1 hdiff3d 256 x 8": (lambda: _panel(_synth("hdiff", (256,) * 3, 8)),
                           "b400888f9ac68215c68d73cf3b8e254cdb7d6fd142f8768377f6ad4985c39ac0"),
    "K1 hotspot": (lambda: _panel(_synth("hotspot", (6, 36, 44), 3)),
                   "efa186faeb99e56cea29deba4f68e21b08229ffaf376cd803d169a3e2a0d4a94"),
    "K1 fuzz i32": (lambda: _panel(_fuzz(6, ndim=3, data_type="int32",
                                         data="random:-20,20")),
                    "67e8c2b9e5c1571cae11f137be1579f482f30f978b884e3c03381f9ff355c940"),
    "K1 rows": (lambda: _panel(rotate_2d_to_rows(_synth(
        "diffusion", (24, 120), 4)), (1, 16)),
        "62c5fd250232a3b9d9852145683edaa7ede35bc74460febb0eddb11050c3cdd0"),
    "K2 jacobi3d": (lambda: _overlap(_example(
        "jacobi3d_32x32x32_8itr.json", 10)),
        "c0be116f9aaa000c5278fa4e5e1a7095dde57b91e68bcc2d0e386976d49fd41a"),
    "K2 hdiff": (lambda: _overlap(_example("hdiff_64x64x64.json", 12)),
                 "29f26952f0f6e5453efa564c0a4d6698144b99018d130731836f24f13cfc917e"),
    "K3c jacobi copy": (lambda: stream.stream_source(stream.plan_stream(
        _synth("diffusion", (24, 24, 24), 3, boundary="copy"),
        spill="all")),
        "7d5368b4d1df05455637a519a7d8b5a08ad7ef0ef12fc33cf0c684186cf0d777"),
    "K3c hotspot deep": (lambda: stream.stream_source(stream.plan_stream(
        _synth("hotspot", (40, 40, 72), 32), spill="all")),
        "3be2843fdf7405bb325c0549d4923613145594b2b418abac971820cf22a14b64"),
    "K3c jacobi3d 512 x 32": (lambda: stream.stream_source(
        stream.plan_stream(_synth("diffusion", (512,) * 3, 32), mxu="off")),
        "64e5fe4bf709260cc688d27e32632cb06055a11cb5006e948a2da5d6c7545a36"),
    "K3c local": (lambda: _local_spill(_synth(
        "diffusion", (64, 40, 72), 3, boundary="shrink"), 4),
        "2d7996d909942af075e030c37dee5057fbe10303c06758428883ce9399148f4e"),
    "K3b box composed": (lambda: stream.stream_source(stream.plan_stream(
        _synth("box", (20, 40, 48), 4, extent=2))),
        "7567b94f04e8eeef8182a2827ec1ceb2584952b5544ba2e12b247918b83a7c1e"),
    "K3b cross": (lambda: stream.stream_source(stream.plan_stream(
        _synth("cross", (12, 44, 48), 3, extent=2))),
        "a242e1cf2f7362f051f0e4804a4bbd3cbd7268250ecb1356981272b1cdec374f"),
    "K4 jacobi3d 4 chunks": (lambda: _local(_example(
        "jacobi3d_32x32x32_8itr.json", 10), 4),
        "ae4473c716d612a52ed964a84628a9992ebbb1378d3dcec913dee4003131d62e"),
    "K4 box banded 2 chunks": (lambda: _local(_synth(
        "box", (16, 40, 48), 2, extent=2), 2),
        "511e9bc5e7939978403d735bf4aed9d158c7a7de7c68cf56c098e6c9858c9c3b"),
    "K4 shard jacobi3d 2 x 2": (lambda: _shard(_example(
        "jacobi3d_32x32x32_8itr.json", 24)),
        "cf2c33d7fafb38138c16f2b452b13f06384897870e9bfd1dd93f7caeea3f7c34"),
    "K4 shard box banded 2 x 2": (lambda: _shard(_synth(
        "box", (8, 32, 48), 2, extent=2)),
        "a04b898f4957c0a43079230b4739033563fdc06aebfc93af53dafd006cca7c18"),
    "K5 rows jacobi2d": (lambda: _group(rotate_2d_to_rows(_synth(
        "diffusion", (256, 192), 8)), 64, 8),
        "42691b2977a08c63d3c4995bff669b77b93b10a73f7cfe65695e8dce5bf633a8"),
    "K5 fuzz": (lambda: _group(_fuzz(122), 0, 2),
                "11c0fc29378503d3503c9e99ceaad1a5ae8dd02ea7ded4b0366d5689cdcb7c33"),
    "K6 jacobi3d masked": (lambda: tile.tile_source(tile.plan_tile(
        _example("jacobi3d_32x32x32_8itr.json", 10), mode="masked")),
        "5b9dcfa623498ee9ecd1be1d6ba4305f05079e2bbab2fe4ac5d717f244776f3a"),
    "K6 hdiff fast": (lambda: tile.tile_source(tile.plan_tile(
        _example("hdiff_64x64x64.json", 12), mode="fast")),
        "6c56d03bb1519050d12aa9a809e34cdb28b75a7d19fe371d2c0cab10596371cf"),
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_other_kernels_source_unchanged(name):
    make, digest = FROZEN[name]
    assert hashlib.sha256(make().encode()).hexdigest() == digest


# the narrow K1 and K4 sources (2-byte ring inputs by cp.async groups, bf16
# and f16 values computed in 2 bytes), pinned as FROZEN pins the others:
# groups of 8 (jacobi3d x 8), of 2 (hdiff's halo 3 widened to 4), K4's
# chunk and its shard over 2 x 2
NARROW_PINS = {
    "K1 jacobi3d bf16": (lambda: _panel(_synth(
        "diffusion", (16, 24, 64), 8, data_type="bfloat16")),
        "258de2e16effde7c615b24dcb7e7de6474af3f538d68e8d909438fa7660819be"),
    "K1 hdiff f16": (lambda: _panel(_synth(
        "hdiff", (12, 40, 48), 3, data_type="float16")),
        "396ea3b1737af765b222647724e78add951d525bae213379e26d8de3fd512d24"),
    "K4 jacobi3d bf16 4 chunks": (lambda: _local(_synth(
        "diffusion", (32, 24, 64), 8, data_type="bfloat16"), 4),
        "aee23714d0003deec76b40e1f8c853fb555e74cd0453b0d2bdb15fd2f42ad73e"),
    "K4 shard jacobi3d f16 2 x 2": (lambda: _shard(_synth(
        "diffusion", (16, 32, 48), 3, data_type="float16")),
        "106c5c1f0468820e6c7e1b85fad53ba3bbe17bf11e680f9f454115ddc5600845"),
}


@pytest.mark.parametrize("name", sorted(NARROW_PINS))
def test_narrow_k1_k4_source_unchanged(name):
    make, digest = NARROW_PINS[name]
    assert hashlib.sha256(make().encode()).hexdigest() == digest

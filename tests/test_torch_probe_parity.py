"""The H100 probes P6, P3, P2 and P5 on the CPU, against the TPU scripts.

Three legs per probe, all on the CPU:

* the kernel source (``stencilflow_tpu_torch/csrc/probes/*.cu``) built
  with g++ (no ``__CUDACC__``: every block run by one thread over the same
  per-thread bodies; P3's ring copies synchronous into a NaN-filled ring,
  P2's and P5's shared memory NaN-filled) against the wrapper's plain
  version at odd sizes: bit-exact;
* the plain version against a numpy float32 transcription of the script's
  math in the kernel's order of operations (P5: the script's own numpy
  ``reference``): bit-exact;
* the plain version against the script's own Pallas kernel, loaded from
  ``scripts/`` with ``pallas_call`` in interpret mode and small J, K (the
  script's module globals) -- ``scripts/`` stays untouched.  XLA's CPU
  compiler folds and reassociates the constant chains, so the tolerances
  are the scripts' own comparators: P2 max abs error <= 1e-6 x max |ref|
  (``smem_table_probe.py:78-81``), P5 <= 1e-5 abs
  (``stateless_panel_probe.py:148``), P6 and P3 <= N 2^-22 x max |ref|
  (N rounded multiplies), and P3's manual ring against its automatic
  pipeline inside JAX bit-exact (``dma_manual_probe.py:146``).

The wrappers take the plain version for CPU tensors only; for a device
tensor they launch or raise, and without a GPU they raise.
"""
import ctypes
import functools
import importlib.util
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stencilflow_tpu_torch import probes
from stencilflow_tpu_torch.probes import (async_ring, dma_overlap,
                                          stateless_panel, table_read)
from test_torch_probes import _gxx_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_vp, _int, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)


def _script(name, **globals_):
    """``scripts/<name>.py`` loaded as a module whose ``pallas_call``
    interprets, with module globals set (``J``/``K`` small)."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.ModuleType("pl")
    interp.__dict__.update(pl.__dict__)
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    for k, v in globals_.items():
        setattr(mod, k, v)
    return mod


def _uniform(shape, seed=0, lo=0.5, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _chain_np(v, nops):
    a, b = np.float32(0.9999), np.float32(1.0001)
    for i in range(nops):
        v = v * (a if i % 2 == 0 else b)
    return v


def _chain_tol(nops, ref):
    return nops * 2.0 ** -22 * float(np.abs(ref).max())


# -- g++ builds of the sources ---------------------------------------------

@pytest.fixture(scope="module")
def overlap_lib(tmp_path_factory):
    lib = _gxx_build("dma_overlap", tmp_path_factory.mktemp("dma_overlap"))
    lib.sf_dma_overlap_host.argtypes = [_vp] * 3 + [_int] * 7 + [_f, _f]
    lib.sf_async_ring_host.argtypes = [_vp] * 2 + [_int] * 8 + [_f, _f]
    lib.sf_async_ring_host.restype = _int
    return lib


@pytest.fixture(scope="module")
def table_lib(tmp_path_factory):
    lib = _gxx_build("table_read", tmp_path_factory.mktemp("table_read"))
    lib.sf_table_read_host.argtypes = [_vp] * 3 + [_int, _int, _ll] + \
        [_int] * 4
    lib.sf_table_read_host.restype = _int
    return lib


@pytest.fixture(scope="module")
def panel_lib(tmp_path_factory):
    lib = _gxx_build("stateless_panel",
                     tmp_path_factory.mktemp("stateless_panel"))
    lib.sf_stateless_panel_host.argtypes = [_vp] * 2 + [_int] * 7 + [_f]
    lib.sf_stateless_panel_host.restype = _int
    return lib


# (shape, vec): ragged tiles (J not a multiple of 8, K of 32 units) and
# P not a multiple of the chunk (5)
PLANE_SHAPES = [((13, 11, 37), 1), ((13, 19, 36), 4), ((3, 9, 132), 4)]


@pytest.mark.parametrize("shape,vec", PLANE_SHAPES)
@pytest.mark.parametrize("mode", dma_overlap.MODES)
@pytest.mark.parametrize("nops", [0, 3, 16])
def test_overlap_host_twin_matches_plain(shape, vec, mode, nops,
                                         overlap_lib):
    x = torch.as_tensor(_uniform(shape))
    P, J, K = shape
    chunk = 5
    out = torch.full_like(x, float("nan"))
    acc = torch.full((len(dma_overlap.chunks_of(P, chunk)), J, K),
                     float("nan"))
    overlap_lib.sf_dma_overlap_host(
        x.data_ptr(), out.data_ptr(), acc.data_ptr(), P, J, K, chunk,
        dma_overlap.MODES.index(mode), vec, nops, float(dma_overlap.A),
        float(dma_overlap.B))
    want, want_acc = dma_overlap.overlap_plain(x, mode, nops, chunk)
    assert torch.equal(out, want)
    if mode == "indep":
        assert torch.equal(acc, want_acc)
    got, got_acc = dma_overlap.overlap(x, mode, nops)
    plain, plain_acc = dma_overlap.overlap_plain(x, mode, nops)
    assert torch.equal(got, plain)
    assert got_acc is None if mode == "dep" else torch.equal(got_acc,
                                                            plain_acc)


@pytest.mark.parametrize("shape,vec", PLANE_SHAPES)
@pytest.mark.parametrize("slots", async_ring.SLOTS)
def test_ring_host_twin_matches_plain(shape, vec, slots, overlap_lib):
    """The ring's slot arithmetic, run with synchronous copies into a
    NaN-filled ring: a wrong slot reads NaN or another plane."""
    x = torch.as_tensor(_uniform(shape, seed=1))
    P, J, K = shape
    want = async_ring.ring_plain(x, 5)
    for mode in async_ring.MODES:
        for chunk in (5, 1, P):
            out = torch.full_like(x, float("nan"))
            assert overlap_lib.sf_async_ring_host(
                x.data_ptr(), out.data_ptr(), P, J, K, chunk,
                async_ring.MODES.index(mode), slots, vec, 5,
                float(dma_overlap.A), float(dma_overlap.B)) == 0
            assert torch.equal(out, want), (mode, chunk)
    assert torch.equal(async_ring.ring(x, 5, slots=slots), want)
    assert overlap_lib.sf_async_ring_host(
        x.data_ptr(), out.data_ptr(), P, J, K, 5, 1, 5, vec, 5, 1.0,
        1.0) == -1                    # a slot count not built


TABLE_CASES = [((7, 5), (5, 7), 9), ((7, 5), (8, 6), 9), ((4, 3), (3, 4), 2),
               ((33, 33), (4, 9), 40), ((33, 33), (4, 8), 70)]


@pytest.mark.parametrize("tab_shape,x_shape,steps", TABLE_CASES)
@pytest.mark.parametrize("variant", table_read.VARIANTS)
def test_table_host_twin_matches_plain(tab_shape, x_shape, steps, variant,
                                       table_lib):
    tab, x = table_read.inputs(*tab_shape, *x_shape, seed=2)
    n = x.numel()
    want = table_read.table_read_plain(tab, x, steps)
    for vec in ((1, 4) if n % 4 == 0 else (1,)):
        out = torch.full_like(want, float("nan"))
        assert table_lib.sf_table_read_host(
            tab.data_ptr(), x.data_ptr(), out.data_ptr(), *tab_shape, n,
            steps, table_read.VARIANTS.index(variant), vec, 4) == 0
        assert torch.equal(out, want), vec
    assert torch.equal(table_read.table_read(tab, x, steps, variant), want)


def test_table_host_twin_refuses_unbuilt_term_counts(table_lib):
    tab, x = table_read.inputs(3, 4, 2, 2)
    out = torch.empty(4, 2)
    assert table_lib.sf_table_read_host(tab.data_ptr(), x.data_ptr(),
                                        out.data_ptr(), 3, 4, 4, 2, 0, 1,
                                        4) == -1


PANEL_CASES = [((7, 9, 37), 2, (3, 16), 0), ((7, 9, 37), 3, (4, 32), 2),
               ((10, 5, 70), 4, (2, 64), 5), ((5, 12, 20), 1, (8, 16), 3),
               ((16, 16, 16), 8, (16, 16), 0)]


@pytest.mark.parametrize("shape,B,tile,grid", PANEL_CASES)
def test_panel_host_twin_matches_plain(shape, B, tile, grid, panel_lib):
    """Boxes ragged in every dimension, one per block or walked by
    ``grid`` persistent blocks."""
    x = torch.as_tensor(_uniform(shape, seed=3))
    out = torch.full_like(x, float("nan"))
    assert panel_lib.sf_stateless_panel_host(
        x.data_ptr(), out.data_ptr(), *shape, B, *tile, grid,
        float(stateless_panel.C7)) == 0
    want = stateless_panel.panel_plain(x)
    assert torch.equal(out, want)
    assert torch.equal(stateless_panel.panel(x, B=B, tile=tile), want)
    assert panel_lib.sf_stateless_panel_host(
        x.data_ptr(), out.data_ptr(), *shape, B, tile[0], 48, 0,
        1.0) == -1                    # a TK not built


# -- plain versions against numpy transcriptions ---------------------------

@pytest.mark.parametrize("nops", [0, 1, 16, 33])
def test_chain_plain_is_the_numpy_chain(nops):
    x = _uniform((6, 5, 7), seed=4)
    want = _chain_np(x, nops)
    assert np.array_equal(dma_overlap.chain_plain(torch.as_tensor(x),
                                                  nops).numpy(), want)
    assert np.array_equal(async_ring.ring_plain(torch.as_tensor(x),
                                                nops).numpy(), want)


@pytest.mark.parametrize("P,chunk", [(12, 4), (13, 5), (3, 8)])
def test_indep_plain_is_the_numpy_accumulator(P, chunk):
    """acc of chunk c = x[c * chunk] * 0.5, then N multiplies per plane
    of the chunk, the alternation restarting at every plane."""
    x = _uniform((P, 4, 6), seed=5)
    out, acc = dma_overlap.overlap_plain(torch.as_tensor(x), "indep", 7,
                                         chunk)
    assert np.array_equal(out.numpy(), x)
    for c, p0 in enumerate(range(0, P, chunk)):
        a = x[p0] * np.float32(0.5)
        for _ in range(min(chunk, P - p0)):
            a = _chain_np(a, 7)
        assert np.array_equal(acc[c].numpy(), a), c


def _table_np(tab, x, steps):
    ntab, noff = tab.shape
    D = ntab // 2
    out = []
    for g in range(steps):
        row = g if g < D else (ntab + g - steps if g >= steps - D else D)
        acc = np.zeros_like(x)
        for d in range(noff):
            acc = acc + tab[row, d] * (x + np.float32(d))
        out.append(acc)
    return np.concatenate(out, axis=0)


@pytest.mark.parametrize("tab_shape,x_shape,steps", TABLE_CASES)
def test_table_plain_is_the_numpy_sum(tab_shape, x_shape, steps):
    tab, x = table_read.inputs(*tab_shape, *x_shape, seed=6)
    got = table_read.table_read_plain(tab, x, steps).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, _table_np(tab.numpy(), x.numpy(), steps))


def test_table_rows_and_runs():
    """The clamp of the composed plan, and the param variant's launches:
    the interior and one per boundary row."""
    assert [table_read.table_row(g, 9, 7) for g in range(9)] == \
        [0, 1, 2, 3, 3, 3, 4, 5, 6]
    runs = table_read.row_runs(256, 33)
    assert len(runs) == 33 and runs[16] == (16, 240, 16)
    assert [r[2] for r in runs] == list(range(33))
    assert table_read.row_runs(9, 7)[3] == (3, 6, 3)


@pytest.mark.parametrize("shape", [(6, 7, 9), (1, 3, 4), (16, 16, 16)])
def test_panel_plain_is_the_script_reference(shape):
    script = _script("stateless_panel_probe")
    x = _uniform(shape, seed=7)
    assert np.array_equal(
        stateless_panel.panel_plain(torch.as_tensor(x)).numpy(),
        script.reference(x))


def test_panel_program_equals_the_plain_version_through_k2():
    """The shared StencilFlow program through the port's overlap lowering
    (its plain version on the CPU) and the numpy oracle: bit-equal to the
    probe's plain version."""
    import stencilflow_tpu_torch as sft
    shape = (9, 10, 11)
    x = _uniform(shape, seed=8)
    want = stateless_panel.panel_plain(torch.as_tensor(x)).numpy()
    k2 = stateless_panel.overlap_k2(shape, device="cpu")
    assert np.array_equal(k2(torch.as_tensor(x)).numpy(), want)
    p = sft.parse_program(stateless_panel.program_spec(shape))
    assert np.array_equal(sft.run_interpreter(p, {"a": x})["s2"], want)


# -- plain versions against the scripts' Pallas kernels (interpret) --------

@pytest.mark.parametrize("mode,nops", [("dep", 0), ("dep", 4), ("dep", 16),
                                       ("indep", 8)])
def test_overlap_plain_matches_the_script_kernel(mode, nops):
    script = _script("dma_overlap_probe", J=16, K=16)
    x = _uniform((8, 16, 16), seed=9)
    got = np.asarray(jax.jit(script.build(mode, nops, 8))(jnp.asarray(x)))
    want = dma_overlap.overlap_plain(torch.as_tensor(x), mode, nops)[0]
    err = float(np.abs(got - want.numpy()).max())
    assert err <= _chain_tol(nops, want.numpy()), err


@pytest.mark.parametrize("nops", [0, 4, 16])
def test_ring_plain_matches_the_script_kernels(nops):
    script = _script("dma_manual_probe", J=16, K=16)
    x = jnp.asarray(_uniform((8, 16, 16), seed=10))
    auto = np.asarray(jax.jit(script.build_auto(nops, 8))(x))
    manual = np.asarray(jax.jit(script.build_manual(nops, 8))(x))
    assert np.array_equal(manual, auto)
    want = async_ring.ring_plain(torch.as_tensor(np.asarray(x)),
                                 nops).numpy()
    err = float(np.abs(auto - want).max())
    assert err <= _chain_tol(nops, want), err


def test_table_plain_matches_the_script_kernel():
    script = _script("smem_table_probe", ROWS=8, COLS=16)
    tab, x = table_read.inputs(script.NTAB, script.NOFF, 8, 16, seed=11)
    steps = 9
    got = np.asarray(jax.jit(script.build(steps, True))(
        jnp.asarray(tab.numpy()), jnp.asarray(x.numpy())))
    want = table_read.table_read_plain(tab, x, steps).numpy()
    err = float(np.abs(got - want).max()) / max(1e-9,
                                                float(np.abs(want).max()))
    assert err < 1e-6, err


@pytest.mark.parametrize("B", [4, 8])
def test_panel_plain_matches_the_script_kernel(B):
    script = _script("stateless_panel_probe", J=16, K=16)
    x = _uniform((16, 16, 16), seed=12)
    got = np.asarray(jax.jit(script.build(B, 16, "parallel"))(
        jnp.asarray(x)))
    want = stateless_panel.panel_plain(torch.as_tensor(x)).numpy()
    assert float(np.abs(got - want).max()) < 1e-5


@pytest.mark.parametrize("op", ["mul4", "expr_jac2d", "expr_jac2d_shift",
                                "expr_lim_sel", "expr_lim_mask",
                                "expr_lim_minmax", "selc", "maskmul"])
def test_alu_variant_plain_matches_the_script_kernel(op):
    """P1's variant bodies: the plain version (the kernel's op sequence)
    against ``scripts/vpu_ceiling.py``'s Pallas kernel on one 16 x 16
    block, ``UNROLL`` ops a grid step as the port's.  A 16 x 16 block is
    one plane of the port's expr_jac2d_shift, whose edges read
    themselves as the script's concat fill does, and expr_lim_minmax is
    held to its own formulation (it differs from the other two where dq
    == 0).  Tolerance: 2e-7 of the largest magnitude, and FLT_MIN: XLA's
    CPU compiler contracts a multiply and an add into one FMA where it
    fuses them (its ``add`` computes x + x * 0.999993 as one fma, a
    rounding fewer than the kernel's -fmad=false), and flushes denormals
    to zero (the limiter decays into them); elsewhere bit for bit."""
    from stencilflow_tpu_torch.probes import alu_ceiling
    script = _script("vpu_ceiling", ROWS=16, COLS=16)
    x = _uniform((16, 16), seed=13)
    for steps in (1, 2):
        got = np.asarray(jax.jit(script.build(op, alu_ceiling.UNROLL,
                                              steps))(jnp.asarray(x)))
        want = alu_ceiling.alu_plain(op, torch.as_tensor(x.reshape(-1)),
                                     steps).numpy().reshape(16, 16)
        err = np.abs(got.astype(np.float64) - want)
        tol = 2e-7 * float(np.abs(want).max()) + np.finfo(np.float32).tiny
        assert float(err.max()) <= tol, (steps, float(err.max()))


# -- the wrappers and the sources agree ------------------------------------

def test_sources_build_what_the_wrappers_offer():
    """The term counts, the TKs, the table limits and the tile of the
    sources are the wrappers'."""
    src = probes.source("table_read")
    noffs = re.search(r"#define SF_NOFFS\(X\) (.*)", src).group(1)
    assert tuple(int(n) for n in re.findall(r"X\((\d+)\)", noffs)) == \
        table_read.NOFFS
    assert f"#define SF_MAX_NTAB {table_read.MAX_NTAB}" in src
    assert f"#define SF_CONST_FLOATS {table_read.CONST_FLOATS}" in src
    assert re.findall(r"tk == (\d+)", probes.source("stateless_panel"))[:3] \
        == [str(t) for t in stateless_panel.TKS]
    ov = probes.source("dma_overlap")
    tj = int(re.search(r"#define SF_TJ (\d+)", ov).group(1))
    tku = int(re.search(r"#define SF_TKU (\d+)", ov).group(1))
    assert tj * tku == async_ring.THREADS
    assert re.findall(r"slots == (\d+)", ov)[:3] == \
        [str(s) for s in async_ring.SLOTS]


def test_occupancy_smem_caps_residency():
    """1 and 2 blocks fit an SM's shared memory with the 1 KB reserve,
    one more does not; 0 leaves residency to the kernel."""
    from stencilflow_tpu_torch.config import (H100_SMEM_PER_BLOCK,
                                              H100_SMEM_PER_SM)
    for bps in (1, 2, 3):
        s = probes.occupancy_smem(bps) + 1024
        assert bps * s <= H100_SMEM_PER_SM < (bps + 1) * s
        assert s - 1024 <= H100_SMEM_PER_BLOCK
    assert probes.occupancy_smem(0, 4096) == 4096
    with pytest.raises(ValueError):
        probes.occupancy_smem(8, 40000)


def test_roofline_and_leave_points():
    r = probes.roofline(8 * 2 ** 27, 16 * 2 ** 27, 1.0)
    assert r["bound_by"] == "bytes"
    assert abs(r["bound_ms"] - 8 * 2 ** 27 / 3.35e12 * 1e3) < 1e-12
    assert probes.roofline(8.0, 8e3, 1.0)["bound_by"] == "operations"
    rows = [{"mode": m, "nops": n, "blocks_per_sm": 1, "hide": h}
            for m, n, h in [("dep", 0, 1.0), ("dep", 8, 1.04),
                            ("dep", 16, 1.2), ("indep", 8, 1.06),
                            ("indep", 4, 1.0)]]
    assert dma_overlap.leave_points(rows) == {"dep 1/SM": 16,
                                              "indep 1/SM": 8}
    assert dma_overlap.work((4, 8, 8), "indep", 3, 2) == \
        (8.0 * 256 + 4.0 * 2 * 64, 3.0 * 256)
    # P2 needs x + d once per input cell and each of the 33 distinct
    # rows' sums once: bytes bound it, not the kernels' 3 NOFF per step
    nbytes, ops = table_read.work(33, 33, 256, 256, 256)
    assert ops == 33 * 256 ** 2 + 2 * 33 * 33 * 256 ** 2
    assert nbytes == 4.0 * (33 * 33 + 256 ** 2 + 256 ** 3)
    r = probes.roofline(nbytes, ops, 1.0)
    assert r["bound_by"] == "bytes"
    assert r["bound_ms"] == pytest.approx(0.0201, abs=1e-4)
    assert table_read.work(7, 5, 64, 256, 9)[1] == \
        5 * 64 * 256 + 2 * 5 * 7 * 64 * 256


def test_wrappers_raise_without_a_gpu(monkeypatch, capsys):
    """A tensor off the CPU goes to the kernel, never to the plain
    version: without a GPU the wrappers raise, and the entry points exit
    non-zero with an ``error:`` line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.empty(4, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="no GPU"):
        dma_overlap.overlap(x, "dep", 4)
    with pytest.raises(RuntimeError, match="no GPU"):
        dma_overlap.overlap(x, "indep", 4)
    with pytest.raises(RuntimeError, match="no GPU"):
        async_ring.ring(x, 4, "ring", 3)
    with pytest.raises(RuntimeError, match="no GPU"):
        table_read.table_read(torch.empty(7, 5, device="meta"),
                              torch.empty(8, 8, device="meta"), 9)
    with pytest.raises(RuntimeError, match="no GPU"):
        stateless_panel.panel(x)
    for mod in (dma_overlap, async_ring, table_read, stateless_panel):
        assert mod.main([]) == 1
        assert "error:" in capsys.readouterr().err


def test_wrappers_check_their_arguments():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        dma_overlap.overlap(x, "both", 1)
    with pytest.raises(ValueError):
        dma_overlap.overlap(torch.zeros(3, 4), "dep", 1)
    with pytest.raises(ValueError):
        async_ring.ring(x, 1, slots=5)
    with pytest.raises(ValueError):
        async_ring.ring(x, 1, mode="tma")
    with pytest.raises(ValueError):
        table_read.table_read(torch.zeros(7, 5), torch.zeros(4, 4), 9,
                              variant="immediate")
    with pytest.raises(ValueError):
        table_read.table_read(torch.zeros(7, 5), torch.zeros(4, 4), 9,
                              out=torch.zeros(4, 4))
    with pytest.raises(ValueError):
        stateless_panel.panel(x, tile=(8, 48))
    with pytest.raises(ValueError):
        stateless_panel.panel(x, walk="persist3")

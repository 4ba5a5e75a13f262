"""The port's banded-transform planner (backend/linear.py) against the JAX
package's, on the CPU.

The plans are the compile-time state the stream kernel runs from, so they
must carry across exactly: the same groups, i-offsets, term scales,
weight sums and BC values, and pool matrices / correction planes equal as
numpy arrays (exact equality: both are the same numpy computation).  Where
the JAX package pools a blocked-banded matrix (planes of 384 and up), the
port's plain band matrix must equal the blocks' dense reassembly.  The
programs are those of tests/test_mxu.py.
"""
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import linear as ref_linear
from stencilflow_tpu_torch.backend import linear
from stencilflow_tpu_torch.synthesize import synthesize_stencil

TAPS = " + ".join(f"a[i,j{o:+d},k{p:+d}]"
                  for o in (-2, -1, 0, 1) for p in (-1, 0, 1, 2))


def _affine(expr, dtype="float32", data="random:-1,1"):
    return {"inputs": {"a": {"data": data, "data_type": dtype}},
            "outputs": ["s"], "dimensions": [4, 16, 16],
            "program": {"s": {
                "computation_string": f"s = {expr}",
                "boundary_conditions": {"a": {"type": "constant",
                                              "value": 0.0}},
                "data_type": dtype}}}


PROGRAMS = {
    "box1": lambda: synthesize_stencil(num_stages=2, dimensions=(8, 12, 16),
                                       shape="box", extent=1),
    "box2_bval": lambda: synthesize_stencil(
        num_stages=2, dimensions=(10, 12, 16), shape="box", extent=2,
        boundary="constant", boundary_value=0.7),
    "cross_wide_2d": lambda: synthesize_stencil(
        num_stages=2, dimensions=(12, 16), shape="cross", extent=3),
    "cross_r2_3d": lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="cross", extent=2),
    "shrink": lambda: synthesize_stencil(
        num_stages=2, dimensions=(12, 14, 16), shape="box", extent=1,
        boundary="shrink"),
    "cancelled": lambda: _affine(f"({TAPS}) - ({TAPS}) + 5.0"),
    "f64_box": lambda: synthesize_stencil(
        num_stages=2, dimensions=(4, 16, 16), shape="box", extent=2,
        data_type="float64"),
    "int_affine": lambda: _affine(TAPS, "int32", "constant:3"),
    "rank3": lambda: _affine(" + ".join(
        f"{w}*a[i,j{o:+d},k{p:+d}]" for (o, p), w in zip(
            [(o, p) for o in (-2, -1, 0, 1) for p in (-1, 0, 1, 2)],
            (1, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)))),
}


def _plans(spec, min_footprint, plane=None):
    a, b = ref.parse_program(spec), port.parse_program(spec)
    plane = plane or tuple(a.dimensions[1:])
    rpool, ppool = ref_linear.MatrixPool(), linear.MatrixPool()
    rp = ref_linear.plan_all_stages(a, plane, a.dimensions, rpool,
                                    min_footprint)
    pp = linear.plan_all_stages(b, plane, b.dimensions, ppool,
                                min_footprint)
    return a, b, rp, pp, rpool, ppool


def _dense(rpool, key):
    """A JAX pool matrix as a plain (n, n) array (blocked ones
    reassembled)."""
    arr = rpool.items[key]
    starts = rpool.meta.get(key)
    if starts is None:
        return arr
    if key.startswith("Lb"):
        T, twin = arr.shape[1], arr.shape[2]
        full = np.zeros((T * len(starts),) * 2, arr.dtype)
        for t, s in enumerate(starts):
            full[t * T:(t + 1) * T, s:s + twin] = arr[t]
        return full
    twin, T = arr.shape[1], arr.shape[2]
    full = np.zeros((T * len(starts),) * 2, arr.dtype)
    for t, s in enumerate(starts):
        full[s:s + twin, t * T:(t + 1) * T] = arr[t]
    return full


def _same_plans(rp, pp, rpool, ppool):
    assert sorted(rp) == sorted(pp)
    for name in rp:
        r, p = rp[name], pp[name]
        assert (r.bias, r.footprint) == (p.bias, p.footprint)
        assert len(r.groups) == len(p.groups)
        for rg, pg in zip(r.groups, p.groups):
            assert (rg.field, rg.oi, rg.weight_sum, rg.bc_value) == \
                (pg.field, pg.oi, pg.weight_sum, pg.bc_value)
            assert (rg.correction_key is None) == (pg.correction_key is None)
            if rg.correction_key:
                assert rg.correction_key == pg.correction_key
                np.testing.assert_array_equal(
                    rpool.items[rg.correction_key],
                    ppool.items[pg.correction_key])
            assert len(rg.terms) == len(pg.terms)
            for rt, pt in zip(rg.terms, pg.terms):
                assert rt.scale == pt.scale
                for rk, pk in ((rt.left_key, pt.left_key),
                               (rt.right_key, pt.right_key)):
                    assert (rk is None) == (pk is None)
                    if rk is not None:
                        np.testing.assert_array_equal(_dense(rpool, rk),
                                                      ppool.items[pk])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plans_and_pool_equal(name):
    a, b, rp, pp, rpool, ppool = _plans(PROGRAMS[name](), 9)
    _same_plans(rp, pp, rpool, ppool)
    if name in ("cancelled", "f64_box", "int_affine", "rank3"):
        assert pp == {}     # the per-cell path keeps these stages
    else:
        assert pp


def test_single_stage_plans():
    """plan_linear_stage directly: the box's three i-groups are rank 1,
    the wide 2-D cross is one rank-2 group (tests/test_mxu.py)."""
    for name, groups, terms in (("box1", 3, 1), ("cross_wide_2d", 1, 2)):
        spec = PROGRAMS[name]()
        for mod, parse in ((ref_linear, ref.parse_program),
                           (linear, port.parse_program)):
            p = parse(spec)
            mp = mod.plan_linear_stage(list(p.kernels.values())[0],
                                       tuple(p.dimensions[1:]),
                                       p.dimensions, mod.MatrixPool(),
                                       min_footprint=9)
            assert len(mp.groups) == groups
            assert all(len(g.terms) == terms for g in mp.groups)


def test_blocked_band_reassembles():
    """At a 384-wide plane the JAX package pools blocked-banded matrices;
    the port keeps one global band per side, equal to their dense
    reassembly."""
    spec = synthesize_stencil(num_stages=2, dimensions=(4, 384, 16),
                              shape="box", extent=2, boundary="constant",
                              boundary_value=0.25)
    a, b, rp, pp, rpool, ppool = _plans(spec, 12)
    assert any(k.startswith("Lb") for k in rpool.items)
    _same_plans(rp, pp, rpool, ppool)


@pytest.mark.parametrize("name", ["box2_bval", "cross_r2_3d", "shrink"])
def test_finalize_pool_keys(name):
    """Referenced keys and transform-ring keys equal the JAX package's
    (less its bf16 ``__lo`` residual matrices: the port has no split).
    Under the single-pass "bf16" mode both have the same keys (no
    residual) and the same arrays: the band matrices rounded to bf16,
    correction planes exact."""
    a, b, rp, pp, rpool, ppool = _plans(PROGRAMS[name](), 9)
    rk, _ra, _rm, rt = ref_linear.finalize_pool(rp, rpool, a, "split")
    pk, pa, pt = linear.finalize_pool(pp, ppool, b, "split")
    assert pk == [k for k in rk if not k.endswith("__lo")]
    assert pt == rt
    for k, arr in zip(pk, pa):
        np.testing.assert_array_equal(arr, rpool.items[k])
    rk, ra, rm, rt = ref_linear.finalize_pool(rp, rpool, a, "bf16")
    bk, ba, bt = linear.finalize_pool(pp, ppool, b, "bf16")
    assert rm["__precision__"] == "bf16"
    assert bk == rk == pk and bt == rt
    for k, got, want in zip(bk, ba, ra):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        if k.startswith(("L", "R")):   # bf16-exact
            np.testing.assert_array_equal(got, torch.as_tensor(got).to(
                torch.bfloat16).float().numpy())
        else:
            np.testing.assert_array_equal(got, ppool.items[k])
    with pytest.raises(ValueError, match="mxu_precision"):
        linear.finalize_pool(pp, ppool, b, "fast")


def test_band_diagonals_and_flops():
    """The kernel's diagonal tables reproduce the band matrix, and the
    flop count is 2 per diagonal per side per cell."""
    rng = np.random.default_rng(0)
    m = linear._band_matrix(20, [-2, 0, 1, 3], [1.0, -2.0, 0.5, 4.0])
    p = rng.standard_normal(20).astype(np.float32)
    for side, mat in (("L", m), ("R", np.ascontiguousarray(m.T))):
        offs, coef = linear.band_diagonals(mat, side)
        assert offs == list(range(-2, 4))
        got = np.zeros(20, np.float64)
        for d in offs:
            for i in range(20):
                if 0 <= i + d < 20:
                    got[i] += coef[d + 2, i] * p[i + d]
        np.testing.assert_allclose(got, m.astype(np.float64) @ p,
                                   rtol=1e-6)
    pool = {"L_x": m, "R_y": np.ascontiguousarray(m.T)}
    assert linear.mxu_flops_per_cell(
        pool, [("a", "L_x", "R_y"), ("b", None, "R_y")]) == 2 * 6 * 3

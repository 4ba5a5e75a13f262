"""The port's affine-run composition (backend/compose.py) against the JAX
package's, on the CPU.

compose_program and plan_composed are compile-time algebra over numpy,
so the port's copies must give exactly the JAX package's results: the
same runs and segments (including the automatic segmenting at small I
and the refusals of tests/test_compose.py), the same rewritten program,
and the same composed band matrices and i-tables (np.array_equal).
"""
import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import compose as ref_compose
from stencilflow_tpu.backend import linear as ref_linear
from stencilflow_tpu_torch.backend import compose, linear
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil


def _box(stages=4, dims=(24, 24, 24), **kw):
    kw.setdefault("seed_data", "random:0.0,1.0")
    return synthesize_stencil(num_stages=stages, dimensions=dims,
                              shape="box", extent=2, **kw)


def _random_separable(seed):
    """tests/test_compose.py::test_random_separable_chains' draw."""
    rng = np.random.default_rng(seed)
    dims = (int(rng.integers(14, 26)), int(rng.integers(16, 33)),
            int(rng.integers(16, 33)))
    stages = int(rng.integers(2, 5))
    program, prev = {}, "a"
    for s in range(stages):
        ri, rj, rk = (int(rng.integers(1, 3)) for _ in range(3))
        ai = rng.uniform(-1, 1, 2 * ri + 1).round(3)
        uj = rng.uniform(-1, 1, 2 * rj + 1).round(3)
        vk = rng.uniform(-1, 1, 2 * rk + 1).round(3)
        terms = [f"({float(wi * wj * wk)!r})*{prev}[i{di:+d},j{dj:+d},"
                 f"k{dk:+d}]"
                 for di, wi in zip(range(-ri, ri + 1), ai)
                 for dj, wj in zip(range(-rj, rj + 1), uj)
                 for dk, wk in zip(range(-rk, rk + 1), vk)
                 if float(wi * wj * wk) != 0.0]
        program[f"s{s}"] = {
            "computation_string": f"s{s} = " + " + ".join(terms),
            "boundary_conditions": {prev: {"type": "constant",
                                           "value": 0.0}},
            "data_type": "float32"}
        prev = f"s{s}"
    return {"inputs": {"a": {"data": "random:0.0,1.0",
                             "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims),
            "program": program}


CANCEL = {
    "inputs": {"a": {"data": "random:0.0,1.0", "data_type": "float32"}},
    "outputs": ["s1"], "dimensions": [16, 24, 32],
    "program": {
        "s0": {"computation_string": "s0 = a[i-1,j,k] - a[i+1,j,k]",
               "boundary_conditions": {"a": {"type": "constant",
                                             "value": 0.0}},
               "data_type": "float32"},
        "s1": {"computation_string": "s1 = s0[i-1,j,k] + s0[i+1,j,k]",
               "boundary_conditions": {"s0": {"type": "constant",
                                              "value": 0.0}},
               "data_type": "float32"}}}

COMPOSING = {
    "box_full": (lambda: _box(), 0),
    "box_max_t2": (lambda: _box(), 2),
    "box_small_i": (lambda: _box(dims=(12, 24, 24)), 0),
    "box_shrink": (lambda: _box(dims=(28, 24, 24), boundary="shrink"), 0),
    "box8_256": (lambda: _box(stages=8, dims=(256, 256, 256)), 0),
    "fork": (lambda: synthesize_stencil(
        num_stages=5, dimensions=(20, 20, 20), shape="box", extent=1,
        fork_frequency=2, seed_data="random:0.0,1.0"), 0),
    "cancel": (lambda: CANCEL, 0),
    "random0": (lambda: _random_separable(0), 0),
    "random1": (lambda: _random_separable(1), 0),
    "random2": (lambda: _random_separable(2), 0),
}


def _both(spec):
    a, b = ref.parse_program(spec), port.parse_program(spec)
    return (a, ref.ChainAnalysis.run(a)), (b, port.ChainAnalysis.run(b))


@pytest.mark.parametrize("name", sorted(COMPOSING))
def test_compose_program_and_plans_equal(name):
    make, max_t = COMPOSING[name]
    (a, an), (b, bn) = _both(make())
    rgot = ref_compose.compose_program(a, an, max_t)
    pgot = compose.compose_program(b, bn, max_t)
    assert rgot is not None and pgot is not None
    (a2, rb), (b2, pb) = rgot, pgot
    assert sorted(rb) == sorted(pb)
    assert list(a2.kernels) == list(b2.kernels)
    for k in a2.kernels:
        assert repr(a2.kernels[k].statements) == \
            repr(b2.kernels[k].statements)
    dims = a.dimensions
    for seg in rb:
        r, p = rb[seg], pb[seg]
        assert (r.stages, r.field, r.shrink, r.ioffs, r.joffs, r.koffs,
                r.mask) == (p.stages, p.field, p.shrink, p.ioffs, p.joffs,
                            p.koffs, p.mask)
        rpool, ppool = ref_linear.MatrixPool(), linear.MatrixPool()
        rp = ref_compose.plan_composed(r, dims[1:], dims, rpool)
        pp = compose.plan_composed(p, dims[1:], dims, ppool)
        assert (rp.field, rp.offsets, rp.table_rows, rp.full_table, rp.D,
                rp.ilen) == (pp.field, pp.offsets, pp.table_rows,
                             pp.full_table, pp.D, pp.ilen)
        for rk, pk in ((rp.lkey, pp.lkey), (rp.rkey, pp.rkey),
                       (rp.table_key, pp.table_key)):
            assert (rk is None) == (pk is None)
            if rk is not None:
                if rk in rpool.meta:   # blocked: compare the reassembly
                    continue
                assert rk == pk
                np.testing.assert_array_equal(rpool.items[rk],
                                              ppool.items[pk])
    if name == "box_full":
        assert {k: v.stages for k, v in pb.items()} == \
            {"s3": ["s0", "s1", "s2", "s3"]}
    if name == "box_max_t2":
        assert sorted(pb) == ["s1", "s3"]
    if name == "box_small_i":
        assert all(len(v.stages) < 4 for v in pb.values())


@pytest.mark.parametrize("spec", [
    jacobi(3, 16, iterations=4),                       # cross: not rank 1
    _box(boundary_value=0.5),                          # nonzero BC
], ids=["jacobi_cross", "nonzero_bc"])
def test_refusals_equal(spec):
    (a, an), (b, bn) = _both(spec)
    assert ref_compose.find_runs(a, an)[0] == []
    assert compose.find_runs(b, bn)[0] == []
    assert compose.compose_program(b, bn) is None
    assert all((ref_compose.separable_factor(a.kernels[k]) is None)
               == (compose.separable_factor(b.kernels[k]) is None)
               for k in a.kernels)


def test_band_products_equal():
    """BandMat products (the truncated composed bands) equal the JAX
    package's and the dense matrix product."""
    profs = [{-2: 0.5, 0: 1.0, 1: -0.25}, {-1: 1.0, 1: 2.0},
             {0: 1.0, 3: 0.125}]
    r = ref_compose._compose_axis(profs, 11)
    p = compose._compose_axis(profs, 11)
    np.testing.assert_array_equal(r.window(0, 11), p.window(0, 11))
    dense = np.eye(11)
    for prof in profs:
        dense = compose.BandMat.from_profile(11, prof).window(
            0, 11, np.float64) @ dense
    np.testing.assert_allclose(p.window(0, 11, np.float64), dense,
                               rtol=1e-12)

"""The overlap streamer of the port against the JAX package's, on the CPU.

The same inputs, made once with numpy from a seed, go through the JAX
package's Pallas overlap kernel in interpret mode and through the port's
overlap wrapper on CPU tensors, which runs the kernel's plain torch version
(same plan: 3-D tiles and their halo extents).  Tolerances: the port must equal
the numpy oracle bit for bit (np.array_equal — none of these programs has
a transcendental, and the port casts every op to the oracle's dtype), and
must agree with the JAX kernel within VERIFY_RTOL, the JAX package's own
verification tolerance: its interpret-mode kernel is not always bit-exact
(one ulp off the oracle on the 2-D forked box chain, from XLA's CPU
fusion).  The CUDA kernel itself is compared with the plain version on
the card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import overlap as ref_overlap
from stencilflow_tpu_torch.backend import overlap
from stencilflow_tpu_torch.config import VERIFY_RTOL
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_fuzz import make_random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name, size):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


PROGRAMS = {
    "jacobi3d": lambda: _example("jacobi3d_32x32x32_8itr.json", 10),
    "hdiff": lambda: _example("hdiff_64x64x64.json", 12),
    "forked_box": lambda: _example("forked_box_chain.json", 12),
    "hotspot": lambda: synthesize_stencil(
        num_stages=3, dimensions=(8, 9, 10), shape="hotspot",
        seed_data="random:0,1"),
}
# fuzz draws that the JAX package's panel and overlap kernels both accept,
# covering the scalar, the (k) static and the (i, k) partial inputs
FUZZ_SEEDS = (100, 101, 122, 127, 132)
for _s in FUZZ_SEEDS:
    PROGRAMS[f"fuzz{_s}"] = (lambda s=_s: make_random_program(
        np.random.default_rng(s), s))


def _check(spec, seed, **kw):
    """Port overlap vs the oracle (exact) and the JAX overlap (VERIFY_RTOL);
    returns the port's plan."""
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=seed)
    jax_out = ref_overlap.compile_chain_overlap(p_ref, interpret=True)(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    oracle = ref.run_interpreter(p_ref, inputs)
    fn = overlap.compile_chain_overlap(p, device="cpu", **kw)
    got = fn(inputs)
    for o in oracle:
        g = got[o].numpy()
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, oracle[o])
        assert ref.arrays_are_equal(np.asarray(jax_out[o]), g, VERIFY_RTOL)
    return fn.plan


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_overlap_matches_jax_overlap(name):
    _check(PROGRAMS[name](), seed=11)


@pytest.mark.parametrize("tile", [(1, 1, 8), (2, 4, 8), (4, 2, 8)])
def test_overlap_many_tiles(tile):
    """Tiles smaller than the domain: halo re-reads across block seams."""
    spec = synthesize_stencil(num_stages=2, dimensions=(9, 10, 11),
                              seed_data="random:0,1")
    plan = _check(spec, seed=3, tile=tile)
    assert plan.tile == tile and min(plan.grid((9, 10, 11))) > 1


def test_policy_extent_is_the_reference_algebra():
    """compile_chain_best's shallow-chain test reads the reference's
    _chain_needs unchanged, so the port picks overlap exactly where the
    JAX package does; the kernel's own 3-D extents cover its i needs."""
    for name in sorted(PROGRAMS):
        spec = PROGRAMS[name]()
        a = ref.ChainAnalysis.run(ref.parse_program(spec))
        b = port.ChainAnalysis.run(port.parse_program(spec))
        assert ref_overlap._chain_needs(a.program, a) == \
            overlap._chain_needs(b.program, b)
        needs3 = overlap.chain_needs3(b.program, b)
        for f, (lo, hi) in overlap._chain_needs(b.program, b).items():
            if f in needs3:
                assert needs3[f][0][0] <= lo and needs3[f][0][1] <= hi


def test_jacobi512x2_is_shallow_and_fits():
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(512, 512, 512)))
    an = port.ChainAnalysis.run(p)
    assert overlap.shallow_extent(p, an) == 2
    plan = overlap.OverlapPlan.build(an)
    assert 0 < plan.smem_bytes(p) <= overlap.H100_SMEM_PER_BLOCK
    assert plan.needs["a"] == ((2, 2), (2, 2), (2, 2))
    assert plan.onchip == ("a", "s0")


def test_planner_refuses():
    big = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(64, 64, 64), shape="cross", extent=12))
    with pytest.raises(ValueError, match="shared memory"):
        overlap.OverlapPlan.build(port.ChainAnalysis.run(big))
    scalar_only = port.parse_program({
        "inputs": {"sc": {"data": 1.5, "data_type": "float32",
                          "input_dims": []}},
        "outputs": ["b"], "dimensions": [4, 5, 6],
        "program": {"b": {"computation_string": "b = sc * 2.0",
                          "data_type": "float32"}}})
    with pytest.raises(ValueError, match="array input"):
        overlap.OverlapPlan.build(port.ChainAnalysis.run(scalar_only))


def test_wrapper_runs_plain_only_for_cpu_tensors():
    p = port.parse_program(PROGRAMS["jacobi3d"]())
    an = port.ChainAnalysis.run(p)
    plan = overlap.OverlapPlan.build(an)
    arrays = overlap.spanned_arrays(p, port.load_input_arrays(p, seed=1))
    before = overlap.launches
    out = overlap.run_overlap(p, an, plan, arrays)
    assert overlap.launches == before
    assert out["s7"].shape == tuple(p.dimensions)
    with pytest.raises(ValueError, match="shape"):
        overlap.run_overlap(p, an, plan, {"a": arrays["a"][:, :, :4]})
    with pytest.raises(ValueError, match="contiguous"):
        overlap.run_overlap(p, an, plan,
                            {"a": arrays["a"].permute(0, 2, 1)})


"""The panel streamer of the port against the JAX package's, on the CPU.

The same inputs, made once with numpy from a seed, go through the JAX
package's Pallas panel kernel in interpret mode and through the port's
panel wrapper on CPU tensors, which runs the kernel's plain torch version
(same plan: tiles, lags, ring depths).  Tolerances: the port must equal
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
from stencilflow_tpu.backend.panel import PanelPlan as RefPanelPlan
from stencilflow_tpu.backend.panel import compile_chain_panel as ref_panel
from stencilflow_tpu_torch.backend import panel
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
    """Port panel vs the oracle (exact) and the JAX panel (VERIFY_RTOL);
    returns the port's plan."""
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=seed)
    jax_out = ref_panel(p_ref, interpret=True)(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    oracle = ref.run_interpreter(p_ref, inputs)
    fn = panel.compile_chain_panel(p, device="cpu", **kw)
    got = fn(inputs)
    for o in oracle:
        g = got[o].numpy()
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, oracle[o])
        assert ref.arrays_are_equal(np.asarray(jax_out[o]), g, VERIFY_RTOL)
    return fn.plan


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_panel_matches_jax_panel(name):
    _check(PROGRAMS[name](), seed=11)


@pytest.mark.parametrize("tile", [(1, 8), (2, 8), (4, 16)])
def test_panel_many_tiles(tile):
    """Tiles smaller than the plane: halo re-reads across block seams."""
    spec = _example("hdiff_64x64x64.json", 11)
    plan = _check(spec, seed=3, tile=tile)
    assert plan.tile == tile and plan.grid((11, 11, 11))[0] > 1


def test_lags_are_the_reference_algebra_at_b1():
    """Stage lags equal the JAX package's PanelPlan at panel size 1, and
    plane-indexed rings are never deeper than its panel-pair rings."""
    for name in ("jacobi3d", "hdiff", "fuzz100", "fuzz127"):
        spec = PROGRAMS[name]()
        a = ref.ChainAnalysis.run(ref.parse_program(spec))
        b = port.ChainAnalysis.run(port.parse_program(spec))
        rp, pp = RefPanelPlan.build(a, 1), panel.PanelPlan.build(b)
        assert {k: v for k, v in rp.lagp.items()} == pp.lag
        assert rp.lagp_max == pp.lag_max
        for f, d in pp.ring.items():
            assert d <= rp.ring[f]


def test_jacobi512_plan_fits_shared_memory():
    """The main path's default shape plans a tile within 227 KB."""
    p = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(512, 512, 512)))
    plan = panel.PanelPlan.build(port.ChainAnalysis.run(p))
    assert 0 < plan.smem_bytes(p) <= panel.H100_SMEM_PER_BLOCK
    assert plan.ring["a"] == 3 and plan.lag_max == 8
    assert plan.halo["a"] == (8, 8) and plan.halo["s7"] == (0, 0)


def test_planner_refuses():
    """Out of scope raises (compile_chain_best then goes dense): rings too
    large for shared memory and no array input.  float16 fields plan, at
    2 bytes a ring cell (the narrow path)."""
    big = port.parse_program(synthesize_stencil(
        num_stages=4, dimensions=(64, 64, 64), shape="cross", extent=12))
    with pytest.raises(ValueError, match="shared memory"):
        panel.PanelPlan.build(port.ChainAnalysis.run(big))
    spec = synthesize_stencil(num_stages=2, dimensions=(8, 8, 8))
    half = port.parse_program({**spec, "inputs": {k: {
        **v, "data_type": "float16"} for k, v in spec["inputs"].items()},
        "program": {k: {**v, "data_type": "float16"}
                    for k, v in spec["program"].items()}})
    full = port.parse_program(spec)
    hp = panel.PanelPlan.build(port.ChainAnalysis.run(half))
    fp = panel.PanelPlan.build(port.ChainAnalysis.run(full))
    assert hp.ring == fp.ring
    assert 2 * hp.plane_bytes("a", half) == fp.plane_bytes("a", full)
    scalar_only = port.parse_program({
        "inputs": {"sc": {"data": 1.5, "data_type": "float32",
                          "input_dims": []}},
        "outputs": ["b"], "dimensions": [4, 5, 6],
        "program": {"b": {"computation_string": "b = sc * 2.0",
                          "data_type": "float32"}}})
    with pytest.raises(ValueError, match="array input"):
        panel.PanelPlan.build(port.ChainAnalysis.run(scalar_only))


def test_wrapper_runs_plain_only_for_cpu_tensors():
    p = port.parse_program(PROGRAMS["jacobi3d"]())
    an = port.ChainAnalysis.run(p)
    plan = panel.PanelPlan.build(an)
    arrays = panel.spanned_arrays(p, port.load_input_arrays(p, seed=1))
    before = panel.launches_by["exact"]
    out = panel.run_panel(p, an, plan, arrays)
    assert panel.launches_by["exact"] == before
    assert out["s7"].shape == tuple(p.dimensions)
    with pytest.raises(TypeError):
        panel.run_panel(p, an, plan, {"a": arrays["a"].double()})
    with pytest.raises(ValueError, match="device"):
        panel.run_panel(p, an, plan, {"a": arrays["a"].to("meta")})


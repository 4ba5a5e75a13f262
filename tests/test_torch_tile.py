"""The overlapped-tile lowering (K6, backend/tile.py) against the JAX
package's, on the CPU.

The same inputs, made once with numpy from a seed, go through the JAX
package's fused Pallas kernel (``run_chain_pallas``) in interpret mode and
through the port's ``compile_chain_tile(device="cpu")``, which runs the
kernel's plain torch version (``tile_plain``) under the same plan.  The
generated CUDA source compiles with g++ as well (``sf_host_launch``: one
thread per block over NaN-filled shared memory); its fast (mask-free)
variant is followed by the same shell fix-up.  Tolerances: the plain
version and the g++-built kernel, in both modes, equal the numpy oracle
bit for bit (np.array_equal — no transcendental here); the port agrees
with the JAX kernel within VERIFY_RTOL, the JAX package's own
verification tolerance (its interpret-mode kernels are one ulp off the
oracle on the 2-D forked box chain, from XLA's CPU fusion).  On the card,
chip_smoke.py and tests/test_torch_cuda.py compare the CUDA kernel with
the plain version.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend.pallas import run_chain_pallas
from stencilflow_tpu_torch.backend import choose_backend, tile
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.config import H100_SMEM_PER_BLOCK, VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil
from test_torch_stream import run_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name, size):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


PROGRAMS = {
    "jacobi3d": lambda: _example("jacobi3d_32x32x32_8itr.json", 10),
    "hdiff": lambda: _example("hdiff_64x64x64.json", 12),
    "forked_box": lambda: _example("forked_box_chain.json", 12),
    # scalar, (k) and (i, k) inputs; constant / copy / shrink BCs;
    # float32, float64 and int32 fields
    "fuzz122": lambda: random_program(np.random.default_rng(122)),
    "fuzz_f64_shrink": lambda: random_program(
        np.random.default_rng(5), ndim=3, data_type="float64",
        bc_kinds=("constant", "copy", "shrink")),
    "fuzz_i32": lambda: random_program(
        np.random.default_rng(6), ndim=3, data_type="int32",
        data="random:-20,20"),
    "fuzz_2d": lambda: random_program(
        np.random.default_rng(7), ndim=2,
        bc_kinds=("constant", "copy", "shrink")),
}
# the JAX kernel computes float64 programs in float32 without jax x64
JAX_PROGRAMS = [n for n in sorted(PROGRAMS) if n != "fuzz_f64_shrink"]


def _exact(oracle, got):
    for o in oracle:
        g = np.asarray(got[o]).reshape(oracle[o].shape)
        assert g.dtype == oracle[o].dtype
        np.testing.assert_array_equal(g, oracle[o])


@pytest.mark.parametrize("mode", ["masked", "fast"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tile_plain_matches_oracle(name, mode):
    p = port.parse_program(PROGRAMS[name]())
    inputs = port.load_input_arrays(p, seed=3)
    oracle = port.run_interpreter(p, inputs)
    for t in (None, (2, 4, 8)):
        fn = tile.compile_chain_tile(p, tile=t, mode=mode, device="cpu")
        assert fn.plan.mode == mode
        _exact(oracle, {k: v.numpy() for k, v in fn(inputs).items()})


@pytest.mark.parametrize("mode", ["masked", "fast"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_generated_tile_kernel_matches_oracle(name, mode, tmp_path):
    p = port.parse_program(PROGRAMS[name]())
    plan = tile.plan_tile(p, tile=(2, 4, 8), mode=mode)
    inputs = port.load_input_arrays(p, seed=3)
    src = tile.tile_source(plan)
    assert ("_fast_kernel_body" in src) == (mode == "fast")
    got = run_source(src, p, inputs, [], tmp_path)
    if mode == "fast":
        got = tile.shell_fixup(plan, spanned_arrays(p, inputs),
                               {k: torch.from_numpy(v)
                                for k, v in got.items()})
        got = {k: v.numpy() for k, v in got.items()}
    _exact(port.run_interpreter(p, inputs), got)


@pytest.mark.parametrize("name", JAX_PROGRAMS)
def test_tile_matches_jax_pallas(name):
    spec = PROGRAMS[name]()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=5)
    # the JAX kernel takes an i-tile of 1 on a 2-D program (I = 1)
    t = (4, 8, 16) if len(p.raw_dimensions) == 3 else (1, 8, 16)
    want = run_chain_pallas(p_ref, {k: jnp.asarray(v)
                                    for k, v in inputs.items()},
                            interpret=True, tile=t)
    got = tile.run_chain_tile(p, inputs, tile=t, device="cpu")
    for o in want:
        assert ref.arrays_are_equal(np.asarray(want[o]),
                                    got[o].reshape(want[o].shape),
                                    VERIFY_RTOL)


def test_plan_fits_shared_memory_and_refuses_beyond():
    p = port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(512,) * 3, shape="diffusion"))
    plan = tile.plan_tile(p)
    assert 0 < plan.smem_bytes() <= H100_SMEM_PER_BLOCK
    assert plan.halo == (2, 2, 2) and plan.margin["s0"] == (1, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tile.plan_tile(p, tile=(32, 32, 128))
    with pytest.raises(ValueError, match="shared memory"):
        tile.plan_tile(p, smem_budget=1000)
    with pytest.raises(ValueError, match="mode"):
        tile.plan_tile(p, mode="auto")
    # a deep chain widens beyond a block at every tile
    deep = port.parse_program(synthesize_stencil(
        num_stages=32, dimensions=(512,) * 3, shape="diffusion"))
    with pytest.raises(ValueError, match="shared memory"):
        tile.plan_tile(deep)


@pytest.mark.parametrize("name", ["hdiff", "fuzz122", "fuzz_f64_shrink"])
def test_buffers_placed_by_liveness(name):
    """Buffers live at the same stage never overlap, and a stage's buffer
    never overlaps a field it reads; the footprint is below the sum."""
    p = port.parse_program(PROGRAMS[name]())
    plan = tile.plan_tile(p, tile=(2, 4, 8))
    offs = plan.smem_offsets()
    order = plan.analysis.graph.kernel_order
    last = {f: i for i, k in enumerate(order)
            for f in p.kernels[k].accesses()}
    born = {f: (order.index(f) if f in p.kernels else -1)
            for f in plan.onchip}
    size = {f: int(np.prod(plan.region(f))) * np.dtype(
        p.field_dtype(f)).itemsize for f in plan.onchip}
    for idx in range(len(order)):
        live = [f for f in plan.onchip if born[f] <= idx <= last[f]]
        spans = sorted((offs[f], offs[f] + size[f]) for f in live)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(offs[f] + size[f] <= offs[""] for f in live)
    assert offs[""] <= sum(-(-s // 16) * 16 for s in size.values())


def test_ladder_reaches_tile():
    """A chain that every streaming kernel refuses takes K6 before
    dense: hdiff3d 256^3 x 16 without the spill rung."""
    p = port.parse_program(synthesize_stencil(
        num_stages=16, dimensions=(256,) * 3, shape="hdiff"))
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda", spill="off") == "tile"
    assert choose_backend(p, an, "cpu", spill="off") == "dense"


def test_run_program_and_cli_tile(tmp_path, monkeypatch, capsys):
    spec = PROGRAMS["hdiff"]()
    res = run_program(spec, device="cpu", backend="tile",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "tile" and res.verified_against_reference
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(spec))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["run", str(path), "--device", "cpu", "--backend", "tile",
                   "--compare-to-reference"])
    out = capsys.readouterr().out
    assert rc == 0 and "backend: tile" in out
    assert "verified against reference: OK" in out


def test_entry_points_need_the_card(monkeypatch):
    """Built for the card (the default) without one: raises, and no plain
    version runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tile, "tile_plain", lambda *a, **k: ran.append(1))
    p = port.parse_program(synthesize_stencil(num_stages=2,
                                              dimensions=(8, 8, 8)))
    with pytest.raises(RuntimeError, match="no GPU"):
        tile.compile_chain_tile(p)(port.load_input_arrays(p, seed=0))
    assert ran == []

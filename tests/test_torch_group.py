"""The port's group lowering (backend/group.py) and rows rotation against
the JAX package's, on the CPU.

* Plans: the port's ``GroupPlan.build`` equals the JAX package's field by
  field (groups, ring fields, needs, lags, depths) — exact equality.
* The plain version: the same inputs, made once with numpy from a seed,
  go through the JAX package's ``run_chain_group(interpret=True)`` (its
  Pallas kernel in interpret mode) and through the port's
  ``compile_chain_group(device="cpu")``, which runs the kernel's plain
  torch version under the port's plan.  The port must equal the numpy
  oracle bit for bit (no transcendentals here) and agree with the JAX
  kernel within VERIFY_RTOL: XLA's CPU fusion contracts some mul+add
  pairs of the interpret-mode kernel (one ulp off the oracle on hdiff).
* The generated CUDA source also compiles with g++ (one thread per
  block, shared memory filled with NaN) and must equal the plain version
  and the oracle bit for bit.
* Rotation and rows: ``rotate_2d_to_rows`` gives the JAX package's
  program; ``compile_chain_rows`` and ``run_program(backend="rows")``
  give the oracle's raw (J, K) outputs.

On the card, chip_smoke.py and tests/test_torch_cuda.py compare the CUDA
kernel with the plain version.
"""
import json
import os

import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend.group import GroupPlan as RefGroupPlan
from stencilflow_tpu.backend.group import run_chain_group
from stencilflow_tpu.frontend.canonicalize import \
    rotate_2d_to_rows as ref_rotate
from stencilflow_tpu_torch.backend import codegen, compile_chain_rows, group
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.config import VERIFY_RTOL
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.synthesize import (jacobi, random_program,
                                              synthesize_stencil)
from test_torch_stream import run_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith(".json"))


def jacobi3d(size=16, iters=4, boundary="constant"):
    spec = jacobi(3, size, iterations=iters)
    for kspec in spec["program"].values():
        for bc in kspec["boundary_conditions"].values():
            bc["type"] = boundary
            bc["value"] = 0.25
    return spec


def wide_i():
    """i-offsets larger than the panel size."""
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [12, 8, 8],
        "program": {
            "m": {"computation_string": "m = a[i-3,j,k] + 0.5*a[i+2,j+1,k]",
                  "boundary_conditions": {
                      "a": {"type": "constant", "value": 0.5}},
                  "data_type": "float32"},
            "y": {"computation_string": "y = m[i,j,k] + m[i+3,j,k-1]",
                  "boundary_conditions": {
                      "m": {"type": "constant", "value": 0.5}},
                  "data_type": "float32"}}}


def multi_out():
    spec = jacobi(3, 16, iterations=6)
    spec["outputs"] = ["s1", "s3", "s5"]
    return spec


def synth(shape, dims, iters, **kw):
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0,1", **kw)


def example(name, size=8):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


# -- plans -----------------------------------------------------------------

# name: (spec, rotate to rows, B, g)
PLANS = {f"ex-{n[:-5]}": (lambda n=n: example(n), False, 2, 2)
         for n in EXAMPLES}
PLANS.update({f"jacobi3d-B{B}-g{g}": (lambda: jacobi3d(16, 8), False, B, g)
              for B in (2, 4) for g in (1, 2, 8)})
PLANS.update({
    "hdiff3d": (lambda: synth("hdiff", (8, 16, 16), 2), False, 4, 2),
    "wide-i": (wide_i, False, 2, 1),
    "multi-out": (multi_out, False, 2, 2),
    "rows-jacobi2d-8192x8": (lambda: synth("diffusion", (8192, 8192), 8),
                             True, 64, 8),
    "rows-hotspot2d-8192x8": (lambda: synth("hotspot", (8192, 8192), 8),
                              True, 64, 8),
    "rows-hdiff2d-8192x16": (lambda: synth("hdiff", (8192, 8192), 16),
                             True, 64, 8),
})
PLANS.update({f"fuzz{s}": (lambda s=s: random_program(
    np.random.default_rng(s)), False, 2, 1 + s % 3) for s in range(6)})


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_jax_plan(name):
    make, rows, B, g = PLANS[name]
    spec = make()
    a, b = ref.parse_program(spec), port.parse_program(spec)
    if rows:
        a, b = ref_rotate(a), rotate_2d_to_rows(b)
    want = RefGroupPlan.build(a, ref.ChainAnalysis.run(a), B, g)
    got = group.GroupPlan.build(b, port.ChainAnalysis.run(b), B, g)
    for key in ("groups", "group_of", "ring_fields", "needs", "lag",
                "depth", "src_lag"):
        assert getattr(got, key) == getattr(want, key), key


# -- the plain version against the oracle and the JAX kernel ---------------

# name: (spec, B, g)
PLAIN = {f"jacobi3d-{bc}": (lambda bc=bc: jacobi3d(16, 4, bc), 2, 3)
         for bc in ("constant", "copy", "shrink")}
PLAIN.update({f"g{g}": (lambda: jacobi3d(16, 8), 2, g) for g in (1, 2, 8)})
PLAIN.update({
    "hotspot-mixed-rank": (lambda: synth("hotspot", (8, 16, 16), 4), 4, 2),
    "hdiff-forks": (lambda: synth("hdiff", (8, 16, 16), 2), 4, 2),
    "wide-i-B1-g1": (wide_i, 1, 1),
    "wide-i-B2-g2": (wide_i, 2, 2),
    "wide-i-B2-g1": (wide_i, 2, 1),
    "multi-out": (multi_out, 2, 2),
})
PLAIN.update({f"fuzz{900 + s}": (lambda s=s: random_program(
    np.random.default_rng(900 + s)), 0, 1 + s % 3) for s in (0, 1, 2, 4)})


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_group_matches_oracle_and_jax_group(name):
    make, B, g = PLAIN[name]
    spec = make()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=70)
    if not B:   # fuzz: the JAX test's panel size
        B = 2 if p.dimensions[0] % 2 == 0 else 1
    jax_out = run_chain_group(p_ref, inputs, interpret=True, panel=B,
                              group=g)
    oracle = ref.run_interpreter(p_ref, inputs)
    fn = group.compile_chain_group(p, panel=B, group=g, device="cpu")
    got = fn(inputs)
    assert fn.plan.B == B
    assert len(fn.plan.groups) == -(-len(p.kernels) // g)
    for o in oracle:
        gv = got[o].numpy()
        assert gv.dtype == oracle[o].dtype
        np.testing.assert_array_equal(gv, oracle[o])
        assert ref.arrays_are_equal(np.asarray(jax_out[o]), gv, VERIFY_RTOL)


def test_rows_rotation_matches_oracle_and_jax_group():
    spec = jacobi(2, 64, iterations=4)
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=78)
    o = p.outputs[0]
    want = ref.run_interpreter(p_ref, inputs)[o]
    jax_out = run_chain_group(ref_rotate(p_ref), inputs, interpret=True,
                              panel=8, group=2)[o]
    got = group.compile_chain_group(rotate_2d_to_rows(p), panel=8, group=2,
                                    device="cpu")(inputs)[o].numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert ref.arrays_are_equal(np.asarray(jax_out).reshape(want.shape),
                                got.reshape(want.shape), VERIFY_RTOL)


# -- the generated kernel, compiled with g++ -------------------------------

# name: (spec, rotate to rows, B, g, tile)
HOST = {
    "rows-jacobi2d-shrink": (lambda: synth("diffusion", (64, 40), 8,
                                           boundary="shrink"), True, 16, 8,
                             (1, 16)),
    "rows-hotspot2d": (lambda: synth("hotspot", (32, 24), 4), True, 8, 8,
                       None),
    "hotspot3d": (lambda: synth("hotspot", (8, 12, 16), 4), False, 4, 2,
                  (2, 8)),
    "wide-i": (wide_i, False, 2, 2, (2, 8)),
    "jacobi3d-copy": (lambda: jacobi3d(8, 4, "copy"), False, 2, 3, (4, 8)),
    "fuzz122": (lambda: random_program(np.random.default_rng(122)), False,
                0, 2, None),
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_generated_kernel_matches_plain(name, tmp_path):
    make, rows, B, g, tile = HOST[name]
    p0 = port.parse_program(make())
    p = rotate_2d_to_rows(p0) if rows else p0
    an = port.ChainAnalysis.run(p)
    plan = group.plan_group(p, an, B, g, tile)
    assert plan.grid(p.dimensions)[0] * plan.grid(p.dimensions)[1] > 1
    inputs = port.load_input_arrays(p0, seed=2)
    got = run_source(codegen.group_source(p, an, plan), p, inputs, [],
                     tmp_path)
    want = group.group_plain(p, an, plan, spanned_arrays(p, inputs))
    oracle = port.run_interpreter(p0, inputs)
    for o in p.outputs:
        np.testing.assert_array_equal(got[o], want[o].numpy())
        np.testing.assert_array_equal(got[o].reshape(oracle[o].shape),
                                      oracle[o])


def test_scratch_is_reused_by_liveness():
    """One group of 8 jacobi stages keeps two blocks live at a time, so
    its scratch holds two blocks, not seven."""
    p = rotate_2d_to_rows(port.parse_program(synth("diffusion", (256, 64),
                                                   8)))
    plan = group.plan_group(p, panel=64, group=8)
    (temps,) = [plan.temps(p, g) for g in range(len(plan.groups))]
    sizes = sorted(n for _, n in temps.values())
    peak = max(o + n for o, n in temps.values())
    assert len(temps) == 7 and peak <= sizes[-1] + sizes[-2]
    rings, _, total = plan.smem_layout(p)
    assert list(rings) == ["a"] and plan.depth["a"] == 3
    assert total == rings["a"] + 3 * 64 * plan.region("a")[1] * 4 + peak


def test_planner_rules():
    p = port.parse_program(jacobi3d(16, 4))
    an = port.ChainAnalysis.run(p)
    with pytest.raises(ValueError, match="divide"):
        group.plan_group(p, an, panel=3)
    with pytest.raises(ValueError, match="group size"):
        group.plan_group(p, an, panel=2, group=0)
    big = port.parse_program(synth("diffusion", (4096, 64, 64), 8))
    with pytest.raises(ValueError, match="shared memory"):
        group.plan_group(big, panel=4096)
    # the auto rule steps B down by divisors of I until a tile fits
    plan = group.plan_group(big)
    assert plan.B < 4096 and 4096 % plan.B == 0
    assert plan.smem_bytes(big) <= group.H100_SMEM_PER_BLOCK
    # 2-D rows at the reference's g = 8, B = 64: the 10-panel coeff ring
    # of hdiff2d 8192^2 x 16 fits no tile
    hd = rotate_2d_to_rows(port.parse_program(synth("hdiff", (8192, 8192),
                                                    16)))
    assert group.GroupPlan.build(hd, port.ChainAnalysis.run(hd), 64,
                                 8).depth["coeff"] == 10
    with pytest.raises(ValueError, match="shared memory"):
        group.plan_group(hd, panel=64, group=8)


def test_wrapper_runs_plain_only_for_cpu_tensors(monkeypatch):
    p = port.parse_program(jacobi3d(8, 4))
    an = port.ChainAnalysis.run(p)
    plan = group.plan_group(p, an, panel=2)
    arrays = spanned_arrays(p, port.load_input_arrays(p, seed=1))
    before = group.launches
    out = group.run_group(p, an, plan, arrays)
    assert group.launches == before and out["s3"].shape == (8, 8, 8)
    with pytest.raises(TypeError):
        group.run_group(p, an, plan, {"a": arrays["a"].double()})
    with pytest.raises(ValueError, match="device"):
        group.run_group(p, an, plan, {"a": arrays["a"].to("meta")})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(group, "group_plain", lambda *a, **k: 1 / 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        group.compile_chain_group(p, panel=2)(port.load_input_arrays(p))
    with pytest.raises(RuntimeError, match="no GPU"):
        compile_chain_rows(port.parse_program(jacobi(2, 16, 4)), "group")


# -- rotation and rows -----------------------------------------------------

ROT = {
    "jacobi2d": lambda: jacobi(2, 24, iterations=4),
    "hotspot2d": lambda: synth("hotspot", (24, 20), 4),
    "hdiff2d": lambda: synth("hdiff", (24, 20), 2),
    "fuzz-2d": lambda: random_program(np.random.default_rng(1001), ndim=2,
                                      bc_kinds=("constant", "copy",
                                                "shrink")),
}


@pytest.mark.parametrize("name", sorted(ROT))
def test_rotation_matches_jax(name):
    spec = ROT[name]()
    a = ref_rotate(ref.parse_program(spec))
    b = rotate_2d_to_rows(port.parse_program(spec))
    assert (a.name, a.dimensions, a.raw_dimensions, a.outputs) == \
        (b.name, b.dimensions, b.raw_dimensions, b.outputs)
    assert {n: s.dim_mask for n, s in a.inputs.items()} == \
        {n: s.dim_mask for n, s in b.inputs.items()}
    for k in a.kernels:
        assert repr(a.kernels[k].statements) == repr(b.kernels[k].statements)
        assert a.kernels[k].accesses() == b.kernels[k].accesses()
    with pytest.raises(ValueError, match="2-D"):
        rotate_2d_to_rows(port.parse_program(jacobi3d(8, 2)))


@pytest.mark.parametrize("backend", ["group", "panel", "overlap", "stream",
                                     "auto"])
@pytest.mark.parametrize("name", ["jacobi2d", "hotspot2d"])
def test_compile_chain_rows_matches_oracle(name, backend):
    spec = ROT[name]()
    p = port.parse_program(spec)
    inputs = port.load_input_arrays(p, seed=9)
    fn, label = compile_chain_rows(p, backend, group=8, device="cpu")
    assert label == ("rows+dense" if backend == "auto" else
                     "rows+group_g8" if backend == "group" else
                     "rows+" + backend)
    got = fn(inputs)
    for o, want in port.run_interpreter(p, inputs).items():
        assert tuple(got[o].shape) == tuple(p.raw_dimensions)
        np.testing.assert_array_equal(got[o].numpy(), want)


def test_run_program_rows(tmp_path, monkeypatch, capsys):
    spec = ROT["fuzz-2d"]()
    res = run_program(spec, device="cpu", backend="rows",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "rows+dense" and res.verified_against_reference
    with pytest.raises(ValueError, match="2-D"):
        run_program(jacobi3d(8, 2), device="cpu", backend="rows",
                    save_results=False, log_level=0)
    with pytest.raises(ValueError, match="group kernel"):
        compile_chain_rows(port.parse_program(spec), "panel", panel=4,
                           device="cpu")
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(ROT["hotspot2d"]()))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["run", str(path), "--device", "cpu", "--backend", "rows",
                   "--compare-to-reference"])
    out = capsys.readouterr().out
    assert rc == 0 and "backend: rows+dense" in out
    assert "verified against reference: OK" in out

"""The port's ``run`` main path against the JAX package's, on the CPU.

``stencilflow_tpu_torch.driver.run_program`` on CPU tensors against
``stencilflow_tpu.driver.run_program`` (which lowers to fused XLA on a CPU
host) on the same programs and seeds.  Tolerances: the port's outputs
equal the numpy oracle bit for bit (np.array_equal, no transcendentals
here) through every lowering, and agree with the JAX run within
VERIFY_RTOL, the verification tolerance both drivers use.  The choice of
lowering on the card is checked by planning only (no build) at the main
path's full sizes.
"""
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.driver import run_program as ref_run
from stencilflow_tpu_torch.backend import choose_backend
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.config import VERIFY_RTOL
from stencilflow_tpu_torch.driver import VerificationError, run_program
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_fuzz import make_random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name, size):
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


SLICE = {
    "jacobi3d": lambda: _example("jacobi3d_32x32x32_8itr.json", 9),
    "hdiff": lambda: _example("hdiff_64x64x64.json", 10),
    "forked_box": lambda: _example("forked_box_chain.json", 12),
    "fuzz122": lambda: make_random_program(np.random.default_rng(122), 122),
}


@pytest.mark.parametrize("name", sorted(SLICE))
def test_run_program_matches_jax_run_program(name):
    spec = SLICE[name]()
    want = ref_run(ref.parse_program(spec), compare_to_reference=True,
                   save_results=False, seed=4, log_level=0)
    got = run_program(port.parse_program(spec), device="cpu",
                      compare_to_reference=True, save_results=False, seed=4,
                      log_level=0)
    assert got.verified_against_reference and got.backend == "dense"
    oracle = ref.run_interpreter(
        want.program, ref.load_input_arrays(want.program, seed=4))
    for o in want.outputs:
        np.testing.assert_array_equal(got.outputs[o], oracle[o])
        assert port.arrays_are_equal(want.outputs[o], got.outputs[o],
                                     VERIFY_RTOL)


MIXED = {
    "int8_wrap": ({"b": ("random:-120,120", "int8")},
                  "abs(b[i, j, k] * b[i, j+1, k] - b[i, j, k-1]) "
                  "if b[i, j, k] > b[i+1, j, k] else -b[i, j, k]", "int8"),
    "int_times_float": ({"n": ("random:-40000000,40000000", "int32"),
                         "x": ("random:0,1", "float32")},
                        "n[i, j, k] * x[i-1, j, k] + min(n[i, j+1, k], "
                        "x[i, j, k])", "float32"),
    "f64_shrink": ({"x": ("random:0,1", "float64")},
                   "x[i-1, j, k] * x[i+1, j-1, k] - x[i, j, k+2]",
                   "float64"),
}


def _mixed(name):
    fields, expr, dt = MIXED[name]
    bc = {"type": "shrink"} if "shrink" in name else {
        "type": "constant", "value": 3}
    return {
        "inputs": {f: {"data": d, "data_type": t}
                   for f, (d, t) in fields.items()},
        "outputs": ["t"], "dimensions": [5, 6, 7],
        "program": {
            "s": {"computation_string": f"s = {expr}",
                  "boundary_conditions": {f: bc for f in fields},
                  "data_type": dt},
            "t": {"computation_string":
                  "t = s[i+1, j, k] - s[i, j, k-1] + s[i-1, j+1, k]",
                  "boundary_conditions": {"s": {"type": "copy"}},
                  "data_type": dt}}}


@pytest.mark.parametrize("backend", ["dense", "panel", "overlap",
                                     "interpreter"])
@pytest.mark.parametrize("name", sorted(MIXED) + ["hotspot"])
def test_every_lowering_matches_oracle(name, backend):
    spec = (synthesize_stencil(num_stages=2, dimensions=(6, 7, 8),
                               shape="hotspot", seed_data="random:0,1")
            if name == "hotspot" else _mixed(name))
    res = run_program(port.parse_program(spec), device="cpu",
                      backend=backend, compare_to_reference=True,
                      save_results=False, seed=1, log_level=0)
    oracle = port.run_interpreter(res.program,
                                  port.load_input_arrays(res.program, seed=1))
    assert res.backend == backend
    for o in oracle:
        assert res.outputs[o].dtype == oracle[o].dtype
        np.testing.assert_array_equal(res.outputs[o], oracle[o])


@pytest.mark.parametrize("shape,size,iters,expected", [
    ("diffusion", 512, 8, "panel"),      # bench.py's default workload
    ("diffusion", 512, 2, "overlap"),
    ("diffusion", 256, 3, "panel"),
    ("hdiff", 256, 8, "panel"),
    ("hotspot", 256, 8, "panel"),
    ("box", 64, 2, "stream"),            # banded-transform candidate
])
def test_backend_choice_on_card(shape, size, iters, expected):
    kw = {"extent": 2} if shape == "box" else {}
    p = port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=(size,) * 3, shape=shape, **kw))
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda") == expected
    assert choose_backend(p, an, "cpu") == "dense"


@pytest.mark.parametrize("shape,iters,expected", [
    ("diffusion", 8, "rows+group_g8"),   # bench.py's jacobi2d workload
    ("hotspot", 8, "rows+group_g8"),
    ("diffusion", 2, "overlap"),         # < 4 stages: no rows+group rung
    # group_g8 refuses the 10-panel coeff ring; the panel kernel packs
    # the rings, which all live within one plane, by liveness
    ("hdiff", 16, "panel"),
])
def test_backend_choice_on_card_2d(shape, iters, expected):
    p = port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=(8192, 8192), shape=shape))
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda") == expected
    assert choose_backend(p, an, "cpu") == "dense"


def test_ladder_order(monkeypatch):
    """The reference's order, pinned by refusing one rung at a time:
    rows+group, overlap / panel, the per-cell stream kernel, the 2-D
    rescue, the overlapped-tile kernel, dense; and the deep 3-D chains,
    whose rings fit shared memory at no tile, on the stream kernel's
    spill rung."""
    import stencilflow_tpu_torch.backend as be
    p = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(8192, 8192), shape="diffusion"))
    an = port.ChainAnalysis.run(p)

    def refuse(*a, **k):
        raise ValueError("refused")

    def not_2d(real, refused):
        def fn(program, *a, **k):
            if len(program.raw_dimensions) == 2:
                return refused()
            return real(program, *a, **k)
        return fn

    assert choose_backend(p, an, "cuda") == "rows+group_g8"
    monkeypatch.setattr(be, "plan_group", refuse)
    assert choose_backend(p, an, "cuda") == "overlap"
    monkeypatch.setattr(be, "choose_stacked",
                        not_2d(be.choose_stacked, lambda: None))
    got = be._route(p, an, "cuda")
    assert got[0] == "stream" and got[1].mxu_plans == {}
    monkeypatch.setattr(be, "plan_stream", not_2d(be.plan_stream, refuse))
    assert choose_backend(p, an, "cuda") == "rows+panel"
    monkeypatch.setattr(be, "choose_stacked", lambda *a: None)
    assert choose_backend(p, an, "cuda") == "rows+stream"
    monkeypatch.setattr(be, "plan_stream", refuse)
    assert choose_backend(p, an, "cuda") == "rows+tile"
    real_tile = be.plan_tile
    monkeypatch.setattr(be, "plan_tile", lambda program, *a, **k: (
        real_tile(program, *a, **k) if len(program.raw_dimensions) == 2
        else refuse()))   # the rotated chain is 3-D
    assert choose_backend(p, an, "cuda") == "tile"
    monkeypatch.setattr(be, "plan_tile", refuse)
    assert choose_backend(p, an, "cuda") == "dense"
    # a 3-D chain that overlap and panel refuse takes the per-cell
    # stream kernel before tile and dense
    monkeypatch.undo()
    monkeypatch.setattr(be, "choose_stacked", lambda *a: None)
    q = port.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(64, 64, 64), shape="diffusion"))
    qa = port.ChainAnalysis.run(q)
    assert choose_backend(q, qa, "cuda") == "stream"
    assert choose_backend(q, qa, "cuda", spill="off") == "stream"
    monkeypatch.setattr(be, "plan_stream", refuse)
    assert choose_backend(q, qa, "cuda") == "tile"
    monkeypatch.undo()
    # deep 3-D chains: the spill rung; without it, the overlapped-tile
    # kernel where its live buffers fit (hdiff: no i-halo), else dense
    for shape, n, iters, no_spill in (("diffusion", 512, 32, "dense"),
                                      ("hdiff", 256, 16, "tile"),
                                      ("hotspot", 256, 32, "dense")):
        d = port.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape))
        da = port.ChainAnalysis.run(d)
        name, plan = be._route(d, da, "cuda")
        assert name == "stream" and plan.last_config()["packed"]
        # hdiff's rings all live within one plane step: packing alone
        assert bool(plan.last_config()["spilled"]) == (shape != "hdiff")
        assert plan.smem_bytes() <= be.stream.H100_SMEM_PER_BLOCK
        assert choose_backend(d, da, "cpu") == "dense"
        assert choose_backend(d, da, "cuda", spill="off") == no_spill


def test_verification_failure_raises(monkeypatch):
    import stencilflow_tpu_torch.driver as drv
    spec = SLICE["jacobi3d"]()
    real = drv.run_interpreter

    def off_by_one(program, inputs):
        return {k: v + 1 for k, v in real(program, inputs).items()}

    monkeypatch.setattr(drv, "run_interpreter", off_by_one)
    with pytest.raises(VerificationError):
        run_program(spec, device="cpu", compare_to_reference=True,
                    save_results=False, log_level=0)


def test_cli_run(tmp_path, monkeypatch, capsys):
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(SLICE["hdiff"]()))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["run", str(path), "--device", "cpu", "--backend",
                   "panel", "--compare-to-reference", "--repetitions", "2",
                   "--profile", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "backend: panel" in out and "host clock" in out
    assert "verified against reference: OK" in out
    assert (tmp_path / "results" / "prog").is_dir()
    summary = (tmp_path / "prof" / "summary.txt").read_text()
    assert "busy share" not in summary   # no device on a CPU run
    assert (tmp_path / "prof" / "trace.json").is_file()


def test_cuda_device_without_gpu_fails(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        run_program(SLICE["jacobi3d"](), device="cuda", save_results=False,
                    log_level=0)

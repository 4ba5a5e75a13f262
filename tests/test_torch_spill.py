"""The stream kernel's ring spill (K3c) against the JAX package's, on the
CPU.

The reconvergent 16-stage chain of the JAX package's spill tests is
rebuilt here (``reconvergent_chain``): its last stage reads the first
again, so one ring is far deeper than its read count.  A shared-memory
budget (``smem_budget``) small enough that no tile fits forces the spill
rung at these sizes; ``spill="all"`` spills every ring read at an
earlier step.  The port's spill order and read deltas equal the
JAX package's ``choose_spill`` on the same lags; the generated K3c source,
compiled with g++ (``sf_host_launch``: one thread per block, shared memory
and the spill buffer filled with NaN, bulk copies as memcpy at the point
of issue), equals ``stream_plain`` and the numpy oracle bit for bit; and
the port agrees with the JAX package's spilled streamer in interpret mode
within its own test's tolerance (``rtol=3e-5, atol=1e-6``).  The layout
and the generated code's shape are held in test_torch_spill_async.py.  On the card, chip_smoke.py and
tests/test_torch_cuda.py compare the CUDA kernel with the plain version.
"""
import ctypes
import hashlib
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.backend import stream as ref_stream
from stencilflow_tpu_torch.backend import choose_backend, stream
from stencilflow_tpu_torch.backend.dense import chain_halo
from stencilflow_tpu_torch.backend.stacked_io import (SPILL_BYTES_CAP,
                                                      spanned_arrays)
from stencilflow_tpu_torch.config import H100_SMEM_PER_BLOCK
from stencilflow_tpu_torch.cli import main as cli_main
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.outofcore import run_chunked
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_torch_cuda import reconvergent_chain
from test_torch_outofcore import _chunk_slabs
from test_torch_stream import _gxx, run_host

# a shared-memory budget no tile of the reconvergent chain fits unspilled
BUDGET = 40000


def _jacobi(bc="constant", dims=(24, 24, 24)):
    return synthesize_stencil(num_stages=3, dimensions=dims,
                              shape="diffusion", boundary=bc,
                              seed_data="random:0,1")


# name: (spec, planner options): spill="all" spills every ring read at
# an earlier step
ALL = {"spill": "all"}
PROGRAMS = {
    "reconvergent": (lambda: reconvergent_chain(), {"smem_budget": BUDGET}),
    "reconvergent_copy": (lambda: reconvergent_chain(12, bc="copy"),
                          {"smem_budget": BUDGET}),
    "jacobi3d_all": (lambda: _jacobi(), ALL),
    "jacobi3d_copy_all": (lambda: _jacobi("copy"), ALL),
    "jacobi3d_shrink_all": (lambda: _jacobi("shrink"), ALL),
    "hdiff_dag_all": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="hdiff"), ALL),
    # rings read at 3 deltas and an input ring read at 32
    "hotspot_deep_all": (lambda: synthesize_stencil(
        num_stages=32, dimensions=(36, 12, 16), shape="hotspot"), ALL),
    "jacobi3d_deep": (lambda: synthesize_stencil(
        num_stages=12, dimensions=(16, 40, 48), shape="diffusion",
        seed_data="random:0,1"), {"smem_budget": 20000}),
}


def _spillable(plan):
    """The rings ``spill="all"`` spills."""
    return sorted(f for f in plan.raw_ring if not plan.in_step(f))


def _jax_order(p_ref):
    """``choose_spill``'s selection order on the JAX StreamPlan, read off
    its selections as the budget shrinks one plane at a time."""
    an = ref.ChainAnalysis.run(p_ref)
    rp = ref_stream.StreamPlan.build(an)
    plane = rp.plane[0] * rp.plane[1] * 4
    need = rp.vmem_bytes(p_ref)
    order, sels = [], {}
    for n in range(need // plane + 1):
        got = ref_stream.choose_spill(p_ref, an, rp, need - n * plane)
        if got is None:
            continue
        for f, deltas in got[0].items():
            if f not in sels:
                order.append(f)
                sels[f] = deltas
    return rp, order, sels


@pytest.mark.parametrize("name", ["reconvergent", "reconvergent_copy",
                                  "jacobi3d_copy_all"])
def test_spill_order_and_deltas_match_choose_spill(name):
    make, kw = PROGRAMS[name]
    budget = kw.get("smem_budget", H100_SMEM_PER_BLOCK)
    spec = make()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    rp, jax_order, jax_deltas = _jax_order(p_ref)
    plan = stream.plan_stream(p, **kw)
    assert (plan.lag, plan.ring) == (rp.lag, rp.ring)
    deltas = stream.spill_deltas(plan)
    order = stream.spill_order(plan, deltas)
    # the reference skips rings no deeper than 1 + |deltas| (it keeps that
    # many planes on chip); the port keeps none, so it may spill those too
    assert [f for f in order if rp.ring[f] > 1 + len(deltas[f])] == \
        jax_order
    for f, d in jax_deltas.items():
        assert tuple(sorted(deltas[f])) == d
    assert plan.spilled and plan.smem_bytes() <= budget
    assert plan.last_config()["spilled"] == sorted(plan.spilled)
    for f, d in plan.spilled.items():
        assert d == tuple(sorted(deltas[f]))
    # spilled in order: a prefix of the candidates read at an earlier step
    cands = [f for f in order if not plan.in_step(f)]
    assert list(plan.spilled) == cands[:len(plan.spilled)]
    if name == "reconvergent":
        assert order[0] == "s0"


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_generated_spill_kernel_matches_plain_and_oracle(name, tmp_path):
    make, kw = PROGRAMS[name]
    p = port.parse_program(make())
    plan = stream.plan_stream(p, **kw)
    assert plan.packed and plan.mxu_plans == {}
    assert plan.smem_bytes() <= kw.get("smem_budget", H100_SMEM_PER_BLOCK)
    if kw is ALL:   # hdiff's rings all live within a step: none spills
        assert sorted(plan.spilled) == _spillable(plan)
    else:
        assert plan.spilled
        assert plan.smem_bytes() == plan.spill_layout().end > 0
    inputs = port.load_input_arrays(p, seed=2)
    got = run_host(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    oracle = port.run_interpreter(p, inputs)
    for o in p.outputs:
        np.testing.assert_array_equal(got[o], want[o].numpy())
        np.testing.assert_array_equal(got[o], oracle[o])


def test_spill_agrees_with_jax_interpret():
    spec = reconvergent_chain()
    p_ref, p = ref.parse_program(spec), port.parse_program(spec)
    inputs = ref.load_input_arrays(p_ref, seed=31)
    out = p.outputs[0]
    fn = ref_stream.compile_chain_stream(p_ref, interpret=True,
                                         vmem_budget=250 * 1024)
    assert ref_stream.compile_chain_stream.last_config["spilled"] == ["s0"]
    jax_out = np.asarray(fn({k: jnp.asarray(v)
                             for k, v in inputs.items()})[out])
    mine = stream.compile_chain_stream(p, device="cpu", smem_budget=BUDGET)
    assert "s0" in mine.last_config["spilled"]
    got = mine(inputs)[out].numpy()
    np.testing.assert_allclose(got, jax_out, rtol=3e-5, atol=1e-6)
    np.testing.assert_array_equal(got, ref.run_interpreter(p_ref,
                                                           inputs)[out])


def test_spill_off_raises():
    p = port.parse_program(reconvergent_chain())
    with pytest.raises(ValueError, match="shared memory"):
        stream.plan_stream(p, smem_budget=BUDGET, spill="off")
    with pytest.raises(ValueError, match="shared memory"):
        stream.compile_chain_stream(p, smem_budget=BUDGET, spill="off",
                                    device="cpu")
    with pytest.raises(ValueError, match="spill"):
        stream.plan_stream(p, spill="on")


def test_large_budget_spills_nothing():
    p = port.parse_program(reconvergent_chain())
    plan = stream.plan_stream(p)
    assert plan.spilled == {} and plan.last_config()["spilled"] == []
    assert not plan.packed and plan.spill_bytes() == 0
    assert "sf_spill" not in stream.stream_source(plan)


def test_spilled_source_reads_its_own_region():
    """The block's region of the spill buffer is a plain (coherent)
    pointer, offset in 64 bits, that only the bulk copies touch; the
    launcher takes the buffer after the arrays in ``in``."""
    p = port.parse_program(reconvergent_chain())
    plan = stream.plan_stream(p, smem_budget=BUDGET)
    src = stream.stream_source(plan)
    assert "unsigned char* const sf_spill" in src
    assert "const unsigned char* sf_spill" not in src
    assert "__restrict__ sf_spill" not in src
    region = plan.spill_offsets()["end"]
    assert f"sf_region = sf_spill + (long long)(by * {plan.grid()[1]} + " \
        f"bx) * {region}LL" in src
    assert "sf_spill = (unsigned char*)in[1]" in src
    assert plan.spill_bytes() == region * plan.grid()[0] * plan.grid()[1]


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("name", ["jacobi3d_copy_all", "hdiff_dag_all"])
def test_local_spill_matches_in_core(name, chunks, tmp_path):
    """K4 with every ring spilled, its source built by g++ and run chunk
    by chunk, equals its plain version and the in-core oracle; so does
    ``run_chunked`` with spill forced (the plain version)."""
    spec = PROGRAMS[name][0]()
    p = port.parse_program(spec)
    an = port.ChainAnalysis.run(p)
    I = p.dimensions[0]
    Ic, h = I // chunks, chain_halo(an)[0]
    plan = stream.plan_local(p, an, Ic, h, spill="all")
    assert plan.packed and sorted(plan.spilled) == _spillable(plan)
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
    from stencilflow_tpu_torch.backend.build import scalar_blob
    blob = scalar_blob(p, inputs)
    for c in range(chunks):
        lo = c * Ic - h
        slabs = _chunk_slabs(p, inputs, lo, Ic + 2 * h)
        want = stream.local_stream_plain(plan, lo, slabs)
        arrays = [slabs[n].numpy() for n, s in p.inputs.items()
                  if not s.is_scalar]
        outs = [np.zeros((Ic,) + p.dimensions[1:], p.kernels[o].dtype)
                for o in p.outputs]
        ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data
                                               for a in arrays])
        op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
        lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                           blob.ctypes.data, lo)
        for o, got in zip(p.outputs, outs):
            np.testing.assert_array_equal(got, want[o].numpy())
            np.testing.assert_array_equal(got, oracle[o][c * Ic:
                                                         (c + 1) * Ic])
    stats = {}
    got = run_chunked(p, inputs, chunks, backend="stream", device="cpu",
                      spill="all", stats=stats)
    for o in p.outputs:
        np.testing.assert_array_equal(got[o], oracle[o])


def test_local_planner_rescue_order():
    """plan_local_stream: per cell before spilled per cell; spill="all"
    takes the spill rung alone; with no budget, spill="off" leaves the
    dense body."""
    from stencilflow_tpu_torch.outofcore import compile_chunked_chain
    p = port.parse_program(_jacobi())
    _fn, plan = compile_chunked_chain(p, 2, backend="stream", device="cpu")
    assert plan.backend == "stream" and plan.config["spilled"] == []
    _fn, plan = compile_chunked_chain(p, 2, backend="stream", device="cpu",
                                      spill="all")
    assert plan.config["spilled"] == ["a", "s0", "s1"]
    _fn, plan = compile_chunked_chain(p, 2, backend="stream", device="cpu",
                                      smem_budget=0, spill="off")
    assert plan.backend == "dense"


@pytest.mark.parametrize("shape,size,iters", [
    ("diffusion", 512, 32), ("hdiff", 256, 16), ("hotspot", 256, 32)])
def test_deep_chains_route_to_spilled_stream(shape, size, iters):
    """By planning only, at full size: rings that fit shared memory at no
    tile take the spill rung, packed by liveness (hdiff's rings all live
    within a step: packing alone fits) or spilled to device memory under
    the cap."""
    p = port.parse_program(synthesize_stencil(
        num_stages=iters, dimensions=(size,) * 3, shape=shape))
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cuda") == "stream"
    assert choose_backend(p, an, "cpu") == "dense"
    with pytest.raises(ValueError, match="shared memory"):
        stream.plan_stream(p, an, mxu="off", spill="off")
    plan = stream.plan_stream(p, an, mxu="off")
    assert plan.packed and plan.last_config()["packed"]
    assert plan.smem_bytes() <= H100_SMEM_PER_BLOCK
    assert plan.spill_bytes() <= SPILL_BYTES_CAP
    assert bool(plan.spilled) == (shape != "hdiff")
    assert bool(plan.spill_bytes()) == bool(plan.spilled)


def test_run_program_and_cli_spill(tmp_path, monkeypatch, capsys):
    spec = reconvergent_chain()
    res = run_program(spec, device="cpu", backend="stream", spill="off",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "stream" and res.verified_against_reference
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(spec))
    monkeypatch.chdir(tmp_path)
    rc = cli_main(["run", str(path), "--device", "cpu", "--backend",
                   "stream", "--no-spill", "--compare-to-reference"])
    out = capsys.readouterr().out
    assert rc == 0 and "backend: stream" in out
    assert "verified against reference: OK" in out

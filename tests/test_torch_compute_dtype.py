"""The stream kernel's reduced-precision compute on the CPU:
``compile_chain_stream(compute_dtype="bfloat16")`` (K3a per-cell stages,
K3b banded stages, K3c the spill rung, every stage computed in bf16).

(a) The port's plain version against the JAX package's interpret-mode
kernel, run in a subprocess with ``--xla_allow_excess_precision=false``:
with XLA's default, its CPU compiler keeps some fused bf16 intermediates
in f32 (which ones depends on its fusion: a jacobi chain with constant BCs
differs from per-op rounding in 11 % of cells, with copy BCs in none), so
the JAX package's own result is not one function of the program.  With
the flag it rounds after every operation, and per-cell chains agree bit
for bit; banded chains (split-precision passes summed in another order)
in at least ``stream.BF16_COMPUTE_SHARE`` of the cells, every cell
within ``BF16_VERIFY_RTOL`` of the largest output.  Both stay within the JAX
package's own tolerance of the numpy oracle (rtol 3e-2, atol 1e-2).
(b) The generated CUDA source built with g++ (``sf_host_launch``, bf16
arrays as uint16 bits) against the plain version: bit for bit on
per-cell chains, by the banded rule on banded ones.  (c) Planning: rings
and io at 2 bytes a cell, ``ring_storage`` dropped, every compute type
taken, and TypeError where the JAX package raises it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_torch_compute_types import run_host_compute

BF = "bfloat16"
SEED = 61


def _diffusion(stages, boundary="constant"):
    return synthesize_stencil(num_stages=stages, dimensions=(12, 12, 12),
                              shape="diffusion", boundary=boundary,
                              seed_data="random:0,1")


CASES = {
    # name: (program spec, compile_chain_stream keywords, per cell?)
    "jacobi3d": (lambda: jacobi(3, 12, iterations=2), {}, True),
    "jacobi3d_copy": (lambda: _diffusion(2, boundary="copy"), {}, True),
    "hotspot": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="hotspot",
        seed_data="random:0,1", boundary="constant", boundary_value=0.3),
        {}, True),
    "box_r2": (lambda: synthesize_stencil(
        num_stages=2, dimensions=(10, 12, 16), shape="box", extent=2,
        seed_data="random:0,1", boundary="constant", boundary_value=0.3),
        {}, False),
    "spilled": (lambda: _diffusion(3), {"spill": "all"}, True),
    "with_rings": (lambda: jacobi(3, 12, iterations=2),
                   {"ring_storage": BF}, True),
}

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import stencilflow_tpu as ref
from stencilflow_tpu.backend.stream import compile_chain_stream
cases, raises = json.load(open(sys.argv[1]))
out = {}
for name, (spec, kw) in cases.items():
    p = ref.parse_program(spec, name=name)
    inputs = ref.load_input_arrays(p, seed=%d)
    fn = compile_chain_stream(p, interpret=True, compute_dtype="bfloat16",
                              **kw)
    got = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    for o, v in got.items():
        out[name + "/" + o] = np.asarray(v)
for name, (spec, cd) in raises.items():   # what raises, and what
    p = ref.parse_program(spec, name=name)
    inputs = ref.load_input_arrays(p, seed=%d)
    try:
        fn = compile_chain_stream(p, interpret=True, compute_dtype=cd)
        fn({k: jnp.asarray(v) for k, v in inputs.items()})
        out["raises/" + name] = np.array("")
    except Exception as e:
        out["raises/" + name] = np.array(type(e).__name__)
np.savez(sys.argv[2], **out)
""" % (SEED, SEED)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The JAX package's interpret-mode outputs of every case, computed in
    a subprocess whose XLA rounds bf16 after every operation."""
    d = tmp_path_factory.mktemp("jax_bf16")
    cases = {n: (make(), kw) for n, (make, kw, _pc) in CASES.items()}
    raises = {n: (make(), cd) for n, (make, cd, _e) in RAISES.items()}
    (d / "cases.json").write_text(json.dumps([cases, raises]))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip())
    env.pop("PYTEST_XDIST_WORKER", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(d / "cases.json"), str(d / "out.npz")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _case(name):
    make, kw, per_cell = CASES[name]
    p = port.parse_program(make(), name=name)
    return p, kw, per_cell, port.load_input_arrays(p, seed=SEED)


def _plain(p, kw, inputs):
    fn = stream.compile_chain_stream(p, device="cpu", compute_dtype=BF, **kw)
    return fn, {o: v.numpy() for o, v in fn(inputs).items()}


def _banded_agree(want, got):
    """(ok, share equal, largest difference over the largest output) by
    ``stream.bf16_compute_agree``'s banded rule."""
    ok, fig = stream.bf16_compute_agree(want, np.reshape(got, np.shape(
        want)), banded=True)
    return ok, fig["share"], fig["rel"]


# -- (a) the plain version against the JAX package ------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_interpret(name, jax_refs):
    p, kw, per_cell, inputs = _case(name)
    fn, got = _plain(p, kw, inputs)
    assert bool(fn.plan.mxu_plans) != per_cell
    for o in p.outputs:
        want = jax_refs[f"{name}/{o}"]
        g = got[o].reshape(want.shape)
        assert g.dtype == np.float32   # cast back to the program's type
        if per_cell:
            np.testing.assert_array_equal(g, want)
        else:
            ok, share, rel = _banded_agree(want, g)
            assert ok, (share, rel)


@pytest.mark.parametrize("name", sorted(CASES))
def test_within_the_jax_packages_tolerance(name, jax_refs):
    """Both the port and the JAX package within the JAX package's own
    bound of the f32 oracle (tests/test_backends.py), and rounded: not
    equal to the f32 route."""
    p, kw, _pc, inputs = _case(name)
    _fn, got = _plain(p, kw, inputs)
    f32 = stream.compile_chain_stream(p, device="cpu", **{
        k: v for k, v in kw.items() if k != "ring_storage"})(inputs)
    oracle = port.run_interpreter(p, inputs)
    for o in p.outputs:
        ref_o = np.asarray(oracle[o]).reshape(got[o].shape)
        np.testing.assert_allclose(got[o], ref_o, rtol=3e-2, atol=1e-2)
        np.testing.assert_allclose(jax_refs[f"{name}/{o}"].reshape(
            ref_o.shape), ref_o, rtol=3e-2, atol=1e-2)
        assert not np.array_equal(got[o], f32[o].numpy())


def test_ring_storage_is_dropped_under_bf16_compute():
    p, _kw, _pc, inputs = _case("with_rings")
    a = stream.plan_stream(p, compute_dtype=BF, ring_storage=BF)
    b = stream.plan_stream(p, compute_dtype=BF)
    assert a.ring_storage == "off" and a.compute_dtype == BF
    assert stream.stream_source(a) == stream.stream_source(b)


# -- (b) the generated source through g++ --------------------------------------

@pytest.mark.parametrize("name", ["jacobi3d", "hotspot", "box_r2",
                                  "spilled"])
def test_generated_source_matches_plain(name, tmp_path):
    p, kw, per_cell, inputs = _case(name)
    plan = stream.plan_stream(p, compute_dtype=BF, tile=(4, 8),
                              spill=kw.get("spill", "auto"))
    assert plan.grid()[0] * plan.grid()[1] > 1
    assert plan.packed == (name == "spilled")
    if name == "spilled":
        assert plan.spilled
    got = {o: v.numpy() for o, v in run_host_compute(
        plan, inputs, tmp_path).items()}
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    for o in p.outputs:
        w = want[o].numpy()
        if per_cell:
            np.testing.assert_array_equal(got[o], w)
        else:
            ok, share, rel = _banded_agree(w, got[o])
            assert ok, (share, rel)


def test_stage_functions_round_after_every_operation(tmp_path):
    """The emitted stage function of a per-cell stage rounds each bf16
    site (``sf_bfr``), takes a float32 scalar and float constants as
    float32, and rounds a constant BC's fill to bf16."""
    p, _kw, _pc, _inputs = _case("hotspot")
    plan = stream.plan_stream(p, compute_dtype=BF)
    src = stream.stream_source(plan)
    assert "sf_bfr(" in src and "typedef __nv_bfloat16 sf_bf16" in src
    assert src.index("sf_bfr(const float") < src.index("sf_stage_0")
    # the fill 0.3 as bf16 (0.30078125), not as f32
    assert float.hex(0.30078125) in src
    assert float.hex(float(np.float32(0.3))) not in src.split(
        "SF_DEV float sf_stage_0")[1].split("}")[0]


# -- (c) planning and refusals -------------------------------------------------

def test_plan_sizes_at_two_bytes_a_cell():
    p, _kw, _pc, _inputs = _case("jacobi3d")
    f32 = stream.plan_stream(p, tile=(4, 8))
    bf = stream.plan_stream(p, compute_dtype=BF, tile=(4, 8))
    for f in bf.raw_ring:
        assert bf.itemsize(f) == 2 and f32.itemsize(f) == 4
        assert bf.ring_bytes(f) <= (f32.ring_bytes(f) + 15) // 2 + 16
    assert bf.smem_bytes() < f32.smem_bytes()
    assert bf.io_itemsize("a") == 2 and f32.io_itemsize("a") == 4
    assert bf.last_config()["compute_dtype"] == BF
    # a band pass's source keeps f32 slots holding bf16 values
    pb = port.parse_program(CASES["box_r2"][0]())
    banded = stream.plan_stream(pb, compute_dtype=BF)
    src = {t[0] for t in banded.tkeys}
    assert src and all(banded.itemsize(f) == 4 for f in src)


def _bool_minus():
    return {"inputs": {"a": {"data": "random:-2,2", "data_type": "float32"}},
            "outputs": ["s"], "dimensions": [4, 8, 8],
            "program": {"s": {"computation_string":
                              "s = a[i,j,k] - a[i,j+1,k]",
                              "boundary_conditions": {"a": {"type": "copy"}},
                              "data_type": "float32"}}}


def _f64_jacobi():
    spec = jacobi(3, 12, iterations=2)
    spec["inputs"]["a"]["data_type"] = "float64"
    for k in spec["program"].values():
        k["data_type"] = "float64"
    return spec


# (program, compute type, the exception both packages raise, "" for none)
RAISES = {
    "bool-minus": (_bool_minus, "bool", "TypeError"),
    "f64-int32": (_f64_jacobi, "int32", ""),
    "f64-bool": (_f64_jacobi, "bool", ""),
    "f64-float16": (_f64_jacobi, "float16", ""),
}


def test_refusals(jax_refs):
    """Every compute type computes, as the JAX package canonicalises it in
    its default 32-bit mode (float64 computes in float32, int64 in int32,
    torch dtypes name their type), on a float32 program and on a float64
    one; the port raises only where the JAX package raises (bool minus:
    TypeError, at plan time, naming the kernel); tests/
    test_torch_compute_types.py holds the results to the JAX package's."""
    p, _kw, _pc, _inputs = _case("jacobi3d")
    pf = port.parse_program(_f64_jacobi())
    for dt, want in ((None, "float32"), ("float32", "float32"),
                     ("float64", "float32"), (np.float64, "float32"),
                     (torch.bfloat16, BF), ("float16", "float16"),
                     (torch.float16, "float16"), ("int32", "int32"),
                     ("int64", "int32"), (torch.int32, "int32"),
                     (np.int64, "int32"), ("bool", "bool"),
                     (torch.bool, "bool")):
        plan = stream.plan_stream(p, compute_dtype=dt)
        assert plan.compute_dtype == want
        assert (plan.compute is None) == (want == "float32")
        assert (plan.compute_narrow is None) == (want not in (BF,
                                                              "float16"))
        typed = stream.plan_stream(pf, compute_dtype=dt)
        assert typed.compute_dtype == want
        assert (typed.compute is None) == (dt is None)
    assert stream.plan_stream(pf).compute_narrow is None
    for name, (make, cd, err) in RAISES.items():
        assert str(jax_refs["raises/" + name]) == err
        prog = port.parse_program(make())
        if err:
            with pytest.raises(TypeError, match="kernel 's'.*bool"):
                stream.plan_stream(prog, compute_dtype=cd)
        else:
            stream.plan_stream(prog, compute_dtype=cd)


def test_plain_version_counts_no_launch():
    p, _kw, _pc, inputs = _case("jacobi3d")
    before = stream.launches_by["compute_bf16"]
    _plain(p, {}, inputs)   # the plain version launches nothing
    assert stream.launches_by["compute_bf16"] == before

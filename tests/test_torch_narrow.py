"""Programs typed bfloat16 and float16 in the port, against the JAX package.

The port has no ml_dtypes: its bfloat16 is ``dtypes.BFLOAT16``, a 2-byte
numpy record type whose arrays carry the raw bit patterns, so every
comparison here is of 2-byte patterns (``.view(np.uint16)``) against the
JAX package's ml_dtypes arrays, bit for bit unless a case says otherwise.

(a) Inputs: ``load_input_arrays`` for ``random:``, ``constant:``, ``.dat``
and ``.csv`` (a bf16 ``.csv``, which the JAX package's loader cannot
parse, against ml_dtypes' cast of the float64 values), float64 values
just off a bf16 tie, and the round trip of the names.
(b) The oracle: the port's ``run_interpreter`` against the JAX package's
on jacobi3d bf16 and f16, hdiff bf16, a float32 stage reading bf16, the
weak-constant program of the JAX package's simulator tests, a bf16 chain
with transcendentals (held at VERIFY_RTOL, though equal here), integers
past 2^24 meeting bf16, and hand-built weak-int sites; the bf16 x f16
pair refused at np.where and computed in float32 at a ufunc, as the JAX
oracle does.
(c) The plain versions of K1, K2, K3a, K3c and K5 against the oracle, and
against the JAX package's interpret-mode kernels run in a subprocess with
``--xla_allow_excess_precision=false`` (XLA's CPU compiler otherwise keeps
fused narrow intermediates in f32).  One JAX kernel differs from its own
oracle there: its panel kernel on hdiff typed float16 and its stream kernel
on hotspot typed float16 (pinned below).
(d) The generated CUDA sources of those kernels, built with g++
(``sf_host_launch``; bf16 in the bf16 ring macros' ``uint16_t``, float16
as a struct on the host, so a missed conversion does not compile), against
the plain versions and the oracle, with K1's loader on each of its
alignment branches (``ALIGN``); the narrow sources' loads and 2-byte
operations at the source level; the float path's rounding against the
correctly rounded result on the host (``probes/narrow_ops.py``, whose
kernel holds the card's instructions to the float path).
(e) K3b: narrow stages stay off the banded route (the JAX package's
banded kernel lands 0.07955 relative from its oracle on box3d r2 typed
bf16 at seed 3), the simulator, routing (K6's cell and K4's out-of-core
chunk plan too) and the CLI; K4, K6 and the entry points above them are
tests/test_torch_narrow_paths.py's.
"""
import json
import os
import subprocess
import sys
import warnings

import ml_dtypes
import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu_torch import dtypes
from stencilflow_tpu_torch.backend import (choose_backend, codegen, group,
                                           overlap, panel, stream)
from stencilflow_tpu_torch.backend.dense import compile_chain
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.cli import main
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
from stencilflow_tpu_torch.frontend.canonicalize import rotate_2d_to_rows
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_torch_stream import run_source

BF = np.dtype(ml_dtypes.bfloat16)
NARROW = ["bfloat16", "float16"]


def bits(x):
    """A narrow array's 2-byte patterns (any other array as it is)."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 and \
        x.dtype.kind in "fV" else x


def typed(shape, dims, iters, dt, **kw):
    return synthesize_stencil(num_stages=iters, dimensions=dims, shape=shape,
                              seed_data="random:0.0,1.0", data_type=dt, **kw)


def _spec(inputs, kernels, outputs, dims):
    return {"inputs": inputs, "outputs": outputs, "dimensions": list(dims),
            "program": kernels}


def weak_demote_spec(dims=(6, 6, 6)):
    """tests/test_simulator.py's test_weak_const_demotion_vs_bf16_field."""
    return _spec(
        {"f": {"data": "random:0,9", "data_type": "int32"},
         "b": {"data": "random:0,3", "data_type": "bfloat16"}},
        {"m": {"computation_string": "m = (f[i,j,k] > 2 and f[i,j,k-1] > 1)",
               "boundary_conditions": {"f": {"type": "constant",
                                             "value": 0}},
               "data_type": "bool"},
         "w": {"computation_string": "w = (b[i,j,k] + b[i,j+1,k]) * 0.5",
               "boundary_conditions": {"b": {"type": "constant",
                                             "value": 1.0}},
               "data_type": "bfloat16"},
         "s": {"computation_string":
               "s = ((1.0 if m[i,j,k] else 0.3) + w[i,j,k]) * 1000"
               " + (f[i,j,k] and f[i+1,j,k])",
               "boundary_conditions": {"m": {"type": "constant", "value": 0},
                                       "w": {"type": "constant",
                                             "value": 0.5},
                                       "f": {"type": "constant",
                                             "value": 0}},
               "data_type": "float32"}}, ["s"], dims)


def f32_reads_bf16_spec(dims=(6, 8, 10)):
    return _spec(
        {"b": {"data": "random:-2,3", "data_type": "bfloat16"},
         "c": {"data": "random:0,1", "data_type": "float32"}},
        {"s": {"computation_string": "s = b[i,j,k] * c[i,j,k] + b[i-1,j,k]"
               " * 0.3 - max(b[i,j+1,k], 0.25)",
               "boundary_conditions": {"b": {"type": "copy"},
                                       "c": {"type": "constant",
                                             "value": 0.1}},
               "data_type": "float32"}}, ["s"], dims)


def transcendental_spec(dt="bfloat16", dims=(6, 8, 10)):
    return _spec(
        {"b": {"data": "random:-2,3", "data_type": dt},
         "g": {"data": "random:-2,3", "data_type": dt, "input_dims": []}},
        {"u": {"computation_string": "u = exp(b[i,j,k] * 0.5) + "
               "tanh(b[i,j+1,k]) - sqrt(abs(b[i,j,k-1])) + g",
               "boundary_conditions": {"b": {"type": "shrink"}},
               "data_type": dt},
         "s": {"computation_string": "s = u[i,j,k] / (u[i+1,j,k] + 3.0) "
               "if u[i,j,k] > 1.0 else -u[i,j,k]",
               "boundary_conditions": {"u": {"type": "constant",
                                             "value": 0.7}},
               "data_type": dt},
         "z": {"computation_string": "z = s[i,j,k] + min(s[i,j,k], u[i,j,k])",
               "boundary_conditions": {}, "data_type": "int32"}},
        ["s", "z"], dims)


def bigint_spec(dims=(6, 6, 6)):
    """int32 values past 2^24 meeting bf16: each rounds to float32, then
    to bf16 (twice), as ml_dtypes' cast does."""
    return _spec(
        {"n": {"data": "random:16000000,40000000", "data_type": "int32"},
         "b": {"data": "random:0,3", "data_type": "bfloat16"}},
        {"s": {"computation_string": "s = n[i,j,k] * b[i,j,k] + n[i+1,j,k]",
               "boundary_conditions": {"n": {"type": "constant",
                                             "value": 0}},
               "data_type": "bfloat16"}}, ["s"], dims)


def f64_to_f16_spec(dims=(6, 8, 10)):
    """float64 meeting float16: the output cast rounds once (numpy's
    double -> half), not through float32."""
    return _spec(
        {"d": {"data": "random:-3,3", "data_type": "float64"},
         "h": {"data": "random:0,2", "data_type": "float16"}},
        {"s": {"computation_string": "s = d[i,j,k] * h[i,j,k] + h[i,j+1,k] "
               "/ 3.0", "boundary_conditions": {"h": {"type": "constant",
                                                       "value": 0.1}},
               "data_type": "float16"},
         "t": {"computation_string": "t = s[i,j,k] * h[i,j,k] - s[i-1,j,k]",
               "boundary_conditions": {"s": {"type": "copy"}},
               "data_type": "float16"}}, ["t"], dims)


def bf16_mix_spec():
    """tests/test_simulator.py's test_bf16_mixed_chain_falls_back."""
    return _spec(
        {"t": {"data": "random:0,3", "data_type": "bfloat16"},
         "n": {"data": "random:0,9", "data_type": "int32"}},
        {"s": {"computation_string": "s = t[i,j,k] + n[i,j,k]",
               "boundary_conditions": {"t": {"type": "constant", "value": 0},
                                       "n": {"type": "constant",
                                             "value": 0}},
               "data_type": "int32"}}, ["s"], (4, 4, 4))


def bf16_meets_f16_spec(dims=(6, 8, 10)):
    """bfloat16 meeting float16 at ufunc sites only: each pair computes in
    float32 (ml_dtypes' loops); ``t`` rounds its float32 sites to bf16."""
    return _spec(
        {"a": {"data": "random:-2,3", "data_type": "bfloat16"},
         "b": {"data": "random:-2,3", "data_type": "float16"}},
        {"s": {"computation_string": "s = a[i,j,k] + b[i,j+1,k] * 0.5 - "
               "max(a[i,j,k-1], b[i,j,k])",
               "boundary_conditions": {"a": {"type": "constant",
                                             "value": 0.3},
                                       "b": {"type": "copy"}},
               "data_type": "float32"},
         "t": {"computation_string": "t = a[i-1,j,k] * b[i,j,k] + s[i,j,k] "
               "if a[i,j,k] > b[i,j,k] else a[i,j,k] / b[i,j-1,k]",
               "boundary_conditions": {"a": {"type": "constant",
                                             "value": 0.3},
                                       "b": {"type": "constant",
                                             "value": 1.5},
                                       "s": {"type": "copy"}},
               "data_type": "bfloat16"}}, ["s", "t"], dims)


def jacobi_typed(dt, n=8, iters=2):
    spec = jacobi(3, n, iterations=iters)
    for k in spec["program"].values():
        k["data_type"] = dt
    spec["inputs"]["a"]["data_type"] = dt
    return spec


def _oracles(spec, seed=0):
    """(port program, port inputs, port oracle, JAX oracle)."""
    p = port.parse_program(spec, name="narrow")
    inputs = port.load_input_arrays(p, seed=seed)
    p_ref = ref.parse_program(spec, name="narrow")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.run_interpreter(p_ref, ref.load_input_arrays(p_ref,
                                                                seed=seed))
        got = port.run_interpreter(p, inputs)
    return p, inputs, got, want


# -- (a) data -----------------------------------------------------------------

@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("source", ["random", "constant", "list", "dat",
                                    "csv"])
def test_inputs_equal_the_jax_package(source, dt, tmp_path):
    rng = np.random.default_rng(5)
    vals = rng.random(4 * 5 * 6) * 7
    np.asarray(vals, np.float64).astype(BF if dt == "bfloat16" else
                                        np.float16).tofile(tmp_path / "a.dat")
    np.savetxt(tmp_path / "a.csv", vals.reshape(20, 6), delimiter=",",
               fmt="%.17g")
    data = {"random": "random:-1,3", "constant": "constant:1.00390625",
            "list": np.round(vals, 3).reshape(4, 5, 6).tolist(),
            "dat": "a.dat", "csv": "a.csv"}[source]
    spec = _spec({"a": {"data": data, "data_type": dt},
                  "c": {"data": "random:0,1" if source == "random" else 0.3,
                        "data_type": dt, "input_dims": []}},
                 {"s": {"computation_string": "s = a[i,j,k] * c",
                        "data_type": dt}}, ["s"], (4, 5, 6))
    p = port.parse_program(spec)
    p.path = str(tmp_path / "p.json")
    got = port.load_input_arrays(p, seed=3)
    assert got["a"].dtype == np.dtype(p.inputs["a"].dtype)
    if source == "csv" and dt == "bfloat16":
        # the JAX package's loader raises here (genfromtxt cannot parse
        # into ml_dtypes' type): the port parses float64 and rounds
        f64 = np.genfromtxt(tmp_path / "a.csv", np.float64, delimiter=",")
        np.testing.assert_array_equal(bits(got["a"]),
                                      bits(f64.reshape(4, 5, 6).astype(BF)))
        return
    p_ref = ref.parse_program(spec)
    p_ref.path = p.path
    want = ref.load_input_arrays(p_ref, seed=3)
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))


def test_bf16_rounding_equals_ml_dtypes():
    """float64 -> bf16 rounds through float32, as ml_dtypes does (values
    just off a bf16 tie round twice), int32 too; NaN becomes the quiet NaN
    of its sign; the names round-trip."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal(20000).astype(BF).astype(np.float64)
    x = np.concatenate([
        rng.standard_normal(20000) * 100,
        base + np.abs(base) * 2.0 ** -8 * (1 + 2.0 ** -30),   # off a tie
        base - np.abs(base) * 2.0 ** -8 * (1 + 2.0 ** -30),
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 3.4e38, 1e-40]])
    np.testing.assert_array_equal(bits(dtypes.cast(x, dtypes.BFLOAT16)),
                                  bits(x.astype(BF)))
    n = rng.integers(-2 ** 31, 2 ** 31 - 1, 20000).astype(np.int32)
    np.testing.assert_array_equal(bits(dtypes.cast(n, dtypes.BFLOAT16)),
                                  bits(n.astype(BF)))
    b = x.astype(BF)
    np.testing.assert_array_equal(
        dtypes.to_float32(bits(b).view(dtypes.BFLOAT16)),
        b.astype(np.float32))
    for name in ("bfloat16", "float16"):
        assert dtypes.dtype_to_str(dtypes.str_to_dtype(name)) == name
    assert dtypes.is_floating(dtypes.BFLOAT16) and \
        dtypes.BFLOAT16.itemsize == 2


# -- (b) the oracle -----------------------------------------------------------

ORACLE = {
    "jacobi3d-bf16": (lambda: jacobi_typed("bfloat16"), 0.0),
    "jacobi3d-f16": (lambda: jacobi_typed("float16"), 0.0),
    "hdiff-bf16": (lambda: typed("hdiff", (8, 10, 12), 2, "bfloat16"), 0.0),
    "f32-reads-bf16": (f32_reads_bf16_spec, 0.0),
    "weak-const-demotion": (weak_demote_spec, 0.0),
    "transcendental-bf16": (transcendental_spec, VERIFY_RTOL),
    "transcendental-f16": (lambda: transcendental_spec("float16"),
                           VERIFY_RTOL),
    "bigint-bf16": (bigint_spec, 0.0),
    "f64-to-f16": (f64_to_f16_spec, 0.0),
    "bf16-mix": (bf16_mix_spec, 0.0),
}


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_oracle_equals_the_jax_oracle(name):
    make, rtol = ORACLE[name]
    p, _inputs, got, want = _oracles(make())
    for o in want:
        w = np.asarray(want[o])
        assert got[o].itemsize == w.itemsize and got[o].shape == w.shape
        if rtol:   # numpy's float32 exp is not ml_dtypes' (C library)
            np.testing.assert_allclose(dtypes.cast(got[o], np.float64),
                                       w.astype(np.float64), rtol=rtol,
                                       atol=0)
        else:
            np.testing.assert_array_equal(bits(got[o]), bits(w))


def _weak_ir(expr_op):
    """A bf16 kernel whose float constant is replaced by a weak python
    int (only the traced frontend or hand-built IR make one)."""
    p = port.parse_program(_spec(
        {"b": {"data": "random:-2,3", "data_type": "bfloat16"}},
        {"s": {"computation_string": f"s = {expr_op}",
               "boundary_conditions": {}, "data_type": "float32"}},
        ["s"], (4, 4, 6)))
    p_ref = ref.parse_program(_spec(
        {"b": {"data": "random:-2,3", "data_type": "bfloat16"}},
        {"s": {"computation_string": f"s = {expr_op}",
               "boundary_conditions": {}, "data_type": "float32"}},
        ["s"], (4, 4, 6)))
    for q in (p, p_ref):
        for st in q.kernels["s"].statements:
            _int_consts(st.rhs)
    return p, p_ref


def _int_consts(e):
    for name in ("left", "right", "operand", "if_true", "if_false", "cond"):
        c = getattr(e, name, None)
        if c is None:
            continue
        if type(c).__name__ == "Const" and isinstance(c.value, float):
            object.__setattr__(c, "value", int(c.value))
        else:
            _int_consts(c)
    for c in getattr(e, "args", ()) or ():
        if type(c).__name__ == "Const" and isinstance(c.value, float):
            object.__setattr__(c, "value", int(c.value))
        else:
            _int_consts(c)


@pytest.mark.parametrize("expr", ["b[i,j,k] * 3.0 + 1.0",
                                  "max(b[i,j,k], 1.0)",
                                  "b[i,j,k] if b[i,j,k] > 0.0 else 2.0"])
def test_weak_int_sites_follow_ml_dtypes(expr):
    """A weak int meeting bf16: float32 at a ufunc site (ml_dtypes' loops),
    bf16 at np.where (its result_type) — the oracle, the plain version
    and the generated math all take it."""
    p, p_ref = _weak_ir(expr)
    inputs = port.load_input_arrays(p, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.run_interpreter(p_ref, ref.load_input_arrays(p_ref,
                                                                seed=1))
    got = port.run_interpreter(p, inputs)
    dense = compile_chain(p)(inputs)
    for o in want:
        np.testing.assert_array_equal(bits(got[o]), bits(want[o]))
        np.testing.assert_array_equal(
            bits(dtypes.to_numpy(dense[o]).reshape(got[o].shape)),
            bits(got[o]))


def test_bf16_meets_f16_is_refused():
    """No common type at an np.where site: the JAX oracle refuses it
    (numpy's result_type) and so does the port.  At a ufunc site (+, *,
    max, a comparison) ml_dtypes' loops compute the pair in float32: the
    port's oracle and ``dense`` equal the JAX oracle bit for bit there."""
    spec = _spec({"a": {"data": "random:0,3", "data_type": "bfloat16"},
                  "b": {"data": "random:0,3", "data_type": "float16"}},
                 {"s": {"computation_string":
                        "s = a[i,j,k] if a[i,j,k] > 1.0 else b[i,j,k]",
                        "boundary_conditions": {},
                        "data_type": "float32"}}, ["s"], (4, 4, 4))
    p = port.parse_program(spec)
    with pytest.raises(TypeError, match="bfloat16 meets float16"):
        port.run_interpreter(p, port.load_input_arrays(p))
    with pytest.raises(TypeError, match="bfloat16 meets float16"):
        compile_chain(p)(port.load_input_arrays(p))
    p_ref = ref.parse_program(spec)
    with pytest.raises(TypeError):
        ref.run_interpreter(p_ref, ref.load_input_arrays(p_ref))
    p, inputs, got, want = _oracles(bf16_meets_f16_spec(), seed=1)
    assert want["s"].dtype == got["s"].dtype == np.float32
    dense = compile_chain(p)(inputs)
    for o in want:
        np.testing.assert_array_equal(bits(got[o]), bits(want[o]))
        np.testing.assert_array_equal(
            bits(dtypes.to_numpy(dense[o]).reshape(got[o].shape)),
            bits(want[o]))


# -- (c) the plain versions against the oracle and the JAX kernels -------------

def _k5(dt):
    return typed("diffusion", (64, 48), 4, dt)


KERNELS = {
    # name: (spec, kernel, seed)
    **{f"K1-hdiff-{t}": (lambda dt=dt: typed("hdiff", (12, 14, 16), 3, dt),
                         "panel") for dt, t in zip(NARROW, ("bf16", "f16"))},
    **{f"K1-jacobi-{t}": (lambda dt=dt: typed("diffusion", (12, 14, 16), 4,
                                              dt), "panel")
       for dt, t in zip(NARROW, ("bf16", "f16"))},
    **{f"K2-{t}": (lambda dt=dt: typed("diffusion", (12, 14, 16), 2, dt),
                   "overlap") for dt, t in zip(NARROW, ("bf16", "f16"))},
    **{f"K3a-{t}": (lambda dt=dt: typed("hotspot", (12, 14, 16), 3, dt),
                    "stream") for dt, t in zip(NARROW, ("bf16", "f16"))},
    **{f"K3c-{t}": (lambda dt=dt: typed("diffusion", (12, 14, 16), 3, dt,
                                        boundary="copy"), "spill")
       for dt, t in zip(NARROW, ("bf16", "f16"))},
    **{f"K5-{t}": (lambda dt=dt: _k5(dt), "group")
       for dt, t in zip(NARROW, ("bf16", "f16"))},
    # the loader's alignment branches (ALIGN)
    "K1-oddK-bf16": (lambda: typed("diffusion", (12, 14, 15), 4,
                                   "bfloat16"), "panel"),
    "K1-oddhalo-f16": (lambda: typed("diffusion", (12, 14, 16), 3,
                                     "float16"), "panel"),
    "K1-halo8-bf16": (lambda: typed("diffusion", (10, 12, 32), 8,
                                    "bfloat16"), "panel"),
    "K1-weak-const": (weak_demote_spec, "panel"),
    "K1-bf16-meets-f16": (bf16_meets_f16_spec, "panel"),
    "K3a-f32-reads-bf16": (f32_reads_bf16_spec, "stream"),
}
SEED = 3

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import stencilflow_tpu as ref
from stencilflow_tpu.backend.group import run_chain_group
from stencilflow_tpu.backend.overlap import compile_chain_overlap
from stencilflow_tpu.backend.panel import compile_chain_panel
from stencilflow_tpu.backend.stream import compile_chain_stream
from stencilflow_tpu.frontend.canonicalize import rotate_2d_to_rows
cases = json.load(open(sys.argv[1]))
out = {}
for name, (spec, kind) in cases.items():
    p = ref.parse_program(spec, name=name)
    inputs = ref.load_input_arrays(p, seed=%d)
    if kind == "group":
        got = run_chain_group(rotate_2d_to_rows(p), inputs, interpret=True,
                              panel=16, group=2)
    else:
        fn = {"panel": lambda: compile_chain_panel(p, interpret=True),
              "overlap": lambda: compile_chain_overlap(p, interpret=True),
              "stream": lambda: compile_chain_stream(p, interpret=True,
                                                     mxu="off"),
              "spill": lambda: compile_chain_stream(p, interpret=True,
                                                    mxu="off"),
              "banded": lambda: compile_chain_stream(p, interpret=True)}[
                  kind]()
        got = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    for o, v in got.items():
        v = np.asarray(v)
        out[name + "/" + o] = v.view(np.uint16) if v.dtype.itemsize == 2 \
            else v
np.savez(sys.argv[2], **out)
""" % SEED


def _box_r2_bf16():
    return synthesize_stencil(num_stages=2, dimensions=(16, 16, 16),
                              shape="box", extent=2, data_type="bfloat16",
                              seed_data="random:0.0,1.0")


@pytest.fixture(scope="module")
def jax_kernels(tmp_path_factory):
    """The JAX package's interpret-mode kernels on every case (and its
    banded stream kernel on box3d r2 typed bf16), in a subprocess whose
    XLA rounds narrow values after every operation."""
    d = tmp_path_factory.mktemp("jax_narrow")
    cases = {n: (make(), kind) for n, (make, kind) in KERNELS.items()}
    cases["K3b-box-r2-bf16"] = (_box_r2_bf16(), "banded")
    (d / "cases.json").write_text(json.dumps(cases))
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
    """(program the kernel runs, its plan, plain outputs as numpy, the
    port's oracle, inputs, source)."""
    make, kind = KERNELS[name]
    p0 = port.parse_program(make(), name=name)
    inputs = port.load_input_arrays(p0, seed=SEED)
    oracle = port.run_interpreter(p0, inputs)
    p = rotate_2d_to_rows(p0) if kind == "group" else p0
    an = port.ChainAnalysis.run(p)
    arrays = spanned_arrays(p, inputs)
    if kind == "panel":
        plan = panel.PanelPlan.build(an)
        got = panel.panel_plain(p, an, plan, arrays)
        src = codegen.panel_source(p, an, plan)
    elif kind == "overlap":
        plan = overlap.OverlapPlan.build(an)
        got = overlap.overlap_plain(p, an, plan, arrays)
        src = codegen.overlap_source(p, an, plan)
    elif kind == "group":
        plan = group.plan_group(p, an, 16, 2)
        got = group.group_plain(p, an, plan, arrays)
        src = codegen.group_source(p, an, plan)
    else:
        plan = stream.plan_stream(p, an, mxu="off",
                                  spill="all" if kind == "spill" else "auto")
        assert plan.packed == (kind == "spill")
        got = stream.stream_plain(plan, arrays)
        src = stream.stream_source(plan)
    got = {o: dtypes.to_numpy(v).reshape(oracle[o].shape)
           for o, v in got.items()}
    return p, plan, got, oracle, inputs, src


# the JAX package's interpret-mode kernels that differ from its own oracle
# on float16, the flag set (test_jax_f16_kernels_differ_from_their_oracle)
JAX_OFF = {"K1-hdiff-f16", "K3a-f16"}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_matches_oracle_and_jax_kernel(name, jax_kernels):
    """Bit for bit against the oracle; against the JAX kernel bit for bit
    on narrow outputs, within VERIFY_RTOL on a float32 one (XLA's CPU
    compiler contracts float32 FMAs in the JAX kernels)."""
    p, _plan, got, oracle, _inputs, _src = _case(name)
    for o in oracle:
        assert got[o].dtype == oracle[o].dtype
        np.testing.assert_array_equal(bits(got[o]), bits(oracle[o]))
        if name in JAX_OFF:
            continue
        jax_out = jax_kernels[f"{name}/{o}"].reshape(oracle[o].shape)
        if oracle[o].dtype == np.float32:
            assert ref.arrays_are_equal(jax_out, got[o], VERIFY_RTOL)
        else:
            np.testing.assert_array_equal(jax_out, bits(oracle[o]))


@pytest.mark.parametrize("name", sorted(JAX_OFF))
def test_jax_f16_kernels_differ_from_their_oracle(name, jax_kernels):
    """A fault of the reference, recorded (ROADMAP Queue 3): on float16
    the JAX package's interpret-mode panel kernel (hdiff) and stream
    kernel (hotspot) keep some intermediates unrounded even with the flag
    (on bf16 they round per op), so some cells differ from its oracle;
    the port's plain versions equal the oracle bit for bit."""
    p, _plan, got, oracle, inputs, _src = _case(name)
    o = p.outputs[0]
    jax_out = jax_kernels[f"{name}/{o}"].reshape(oracle[o].shape)
    off = int((jax_out != bits(oracle[o])).sum())
    assert off > 0
    np.testing.assert_array_equal(bits(got[o]), bits(oracle[o]))
    # the float64 truth: the same program typed float64, on the same values
    spec = KERNELS[name][0]()
    for v in list(spec["inputs"].values()) + list(spec["program"].values()):
        v["data_type"] = "float64"
    truth = port.run_interpreter(port.parse_program(spec), {
        k: np.asarray(v, np.float64) for k, v in inputs.items()})[o]
    j = jax_out.view(np.float16).astype(np.float64)
    w = oracle[o].astype(np.float64)
    rel = np.abs(j - w) / (np.maximum(np.abs(j), np.abs(w)) +
                           np.finfo(np.float64).eps)
    print(f"{name}: the JAX kernel differs from its oracle in {off} of "
          f"{w.size} cells, max abs {np.abs(j - w).max():.4g}, max rel "
          f"{rel.max():.4g}; mean abs from the float64 truth: oracle "
          f"{np.abs(w - truth).mean():.4g}, JAX kernel "
          f"{np.abs(j - truth).mean():.4g}")
    assert np.abs(w - truth).mean() <= np.abs(j - truth).mean()


# K1's loader on a ring input of 2-byte cells (``stacked_io.copy_group``):
# case -> (cells a cp.async moves, the input's k-halo in the plan)
ALIGN = {"K1-oddK-bf16": (1, 4),      # odd K: synchronous stores
         "K1-oddhalo-f16": (2, 4),    # halo 3 widened to 4: groups of 2
         "K1-halo8-bf16": (8, 8),     # halo 8: groups of 8 (16 bytes)
         "K1-jacobi-bf16": (2, 4)}


@pytest.mark.parametrize("name", sorted(ALIGN))
def test_k1_loader_alignment_branches(name):
    """Each case takes its branch of the loader: the plan's group and
    widened halo, and the source's copies (``sf_cp4`` / ``sf_cp16`` of 2
    and 8 cells, the synchronous store where K is odd)."""
    p, plan, _got, _oracle, _inputs, src = _case(name)
    g, hk = ALIGN[name]
    assert plan.copy_groups.get("a", 1) == g and plan.halo["a"][1] == hk
    RJ, RK = plan.region("a")
    assert RK % g == 0 and (plan.tile[1] - hk) % g == 0
    loads = [x for x in src.splitlines() if "g_a + (long long)(t + 1)" in x]
    assert len(loads) == 1
    want = {1: "*(r_a + ", 2: "sf_cp4(r_a + ", 8: "sf_cp16(r_a + "}[g]
    assert loads[0].strip().startswith(want)


@pytest.mark.parametrize("a0", [0x0000, 0x0078, 0x3b7c, 0x3f7c, 0x7f78,
                                0x8000, 0xbf7c, 0xff7c])
def test_float_path_rounds_correctly_on_the_host(a0):
    """The theorem under the native bf16 / f16 operations, on the host:
    for first operands a0 .. a0 + 7 (zeros and subnormals, 2^-8, 1, the
    largest numbers, infinities and NaNs, both signs) and every second
    operand, the float32 operation rounded once equals the correctly
    rounded result, for + - * in bf16 and f16 (``narrow_ops_plain``; the
    card test holds the instructions to the float path over all pairs)."""
    from stencilflow_tpu_torch.probes import narrow_ops
    counts, first = narrow_ops.mismatches(a0, 8, device="cpu")
    assert sum(counts.values()) == 0, (counts, first)


def _stage_functions(src):
    """The text of a source's stage functions (``sf_stage_<n>``)."""
    out = []
    for part in src.split("sf_stage_")[1:]:
        if part.split("(")[0].isdigit() and ") {\n" in part.split("}")[0]:
            out.append(part.split("\n}\n")[0])
    return "\n".join(out)


@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("shape", ["diffusion", "hdiff"])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_narrow_sources_load_by_cp_async_and_compute_in_2_bytes(
        kernel, shape, dt):
    """The narrow K1 and K4 sources (jacobi3d x 8 and hdiff x 2 at 64
    wide) move their 2-byte ring inputs by ``cp.async`` groups and no
    synchronous store, and their stages take and return 2-byte values:
    every same-type + - * is the card's instruction (``sf_bf_add``,
    ``sf_h_mul``, ...), with no ``sf_bfr(`` / ``sf_hr(`` rounding and no
    conversion to or from float."""
    p = port.parse_program(typed(shape, (16, 24, 64),
                                 8 if shape == "diffusion" else 2, dt))
    an = port.ChainAnalysis.run(p)
    if kernel == "K1":
        plan = panel.PanelPlan.build(an)
        src = codegen.panel_source(p, an, plan)
    else:
        from stencilflow_tpu_torch.backend.dense import chain_halo
        plan = stream.plan_local(p, an, 8, chain_halo(an)[0])
        src = stream.stream_source(plan)
    ins = [n for n, sp in p.inputs.items() if not sp.is_scalar]
    assert set(plan.copy_groups) == set(ins)
    for n in ins:
        g = plan.copy_groups[n]
        loads = [x.strip() for x in src.splitlines()
                 if f"g_{n} + (long long)(t + 1)" in x]
        assert loads and all(x.startswith(f"sf_cp{2 * g}(r_{n} + ")
                             for x in loads)
        assert f"*(r_{n} + " not in src
    stages = _stage_functions(src)
    nat = "sf_bf" if dt == "bfloat16" else "sf_h"
    ops = ("_add(", "_mul(") + (("_sub(",) if shape == "hdiff" else ())
    assert all(nat + op in stages for op in ops)
    for conversion in ("sf_bfr(", "sf_hr(", "sf_f2bf(", "sf_f2h(",
                       "float "):
        assert conversion not in stages
    assert f"const {'sf_bf16' if dt == 'bfloat16' else 'sf_half'} v0 = " \
        in src


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_generated_kernel_matches_plain_and_oracle(name, tmp_path):
    """The CUDA source built with g++: 2-byte storage and values, one
    rounding per narrow op (the host twin of the card's bf16 / f16
    instructions: the float operation rounded once), ring inputs by
    ``cp.async`` groups where the plan aligns them, bit for bit."""
    p, plan, got, oracle, inputs, src = _case(name)
    assert "sf_d2hr" in src   # the narrow macros, in narrow programs only
    extra = [a for _k, a in plan.kernel_pool()] if hasattr(
        plan, "kernel_pool") else []
    host = run_source(src, p, inputs, extra, tmp_path)
    for o in oracle:
        h = host[o].reshape(oracle[o].shape)
        assert h.dtype == oracle[o].dtype
        np.testing.assert_array_equal(bits(h), bits(got[o]))


def test_k3b_keeps_narrow_stages_per_cell(jax_kernels):
    """The decision, measured: the JAX package makes narrow stages banded
    candidates, and its banded kernel on box3d r2 typed bf16 (16^3)
    lands far outside MXU_VERIFY_RTOL of the oracle (the band passes
    round once where the oracle rounds every op); the port keeps narrow
    stages per cell, equal to the oracle."""
    spec = _box_r2_bf16()
    p = port.parse_program(spec)
    inputs = port.load_input_arrays(p, seed=SEED)
    oracle = port.run_interpreter(p, inputs)
    o = p.outputs[0]
    want = dtypes.cast(oracle[o], np.float64)
    jax_out = dtypes.cast(jax_kernels[f"K3b-box-r2-bf16/{o}"].view(
        dtypes.BFLOAT16).reshape(want.shape), np.float64)
    rel = np.abs(jax_out - want) / (np.maximum(np.abs(jax_out),
                                               np.abs(want)) +
                                    np.finfo(np.float64).eps)
    print(f"JAX banded stream kernel, box3d r2 bf16 16^3: largest "
          f"relative distance from the oracle {rel.max():.4g}")
    assert rel.max() > MXU_VERIFY_RTOL
    plan = stream.plan_stream(p)
    assert not plan.mxu_plans
    got = stream.stream_plain(plan, spanned_arrays(p, inputs))[o]
    np.testing.assert_array_equal(
        bits(dtypes.to_numpy(got).reshape(oracle[o].shape)), bits(oracle[o]))
    from stencilflow_tpu_torch.backend import _any_mxu_candidate
    assert not _any_mxu_candidate(p)
    assert _any_mxu_candidate(port.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(16, 16, 16), shape="box", extent=2)))


# -- (e) the simulator, routing, entry points, CLI -----------------------------

@pytest.mark.parametrize("dt", NARROW)
def test_simulators_match_the_oracle(dt):
    """tests/test_simulator.py's narrow parity: the native core and the
    Python machine round every op like the oracle."""
    from stencilflow_tpu_torch.sim.machine import Simulator
    from stencilflow_tpu_torch.sim.native import NativeSimulator
    p = port.parse_program(jacobi_typed(dt, 6))
    inputs = port.load_input_arrays(p, seed=2)
    want = port.run_interpreter(p, inputs)
    for engine in (Simulator, NativeSimulator):
        got = engine(p).run(inputs).outputs
        for o in want:
            np.testing.assert_array_equal(bits(got[o]), bits(want[o]),
                                          err_msg=engine.__name__)


@pytest.mark.parametrize("make", [bf16_mix_spec, weak_demote_spec])
def test_mixed_bf16_falls_back_to_the_python_machine(make):
    """A mixed-dtype kernel touching bf16 raises NativeBuildError, and
    simulate() returns the oracle's answer from the Python machine."""
    from stencilflow_tpu_torch.sim import simulate
    from stencilflow_tpu_torch.sim.native import (NativeBuildError,
                                                  NativeSimulator)
    p = port.parse_program(make())
    inputs = port.load_input_arrays(p, seed=0)
    with pytest.raises(NativeBuildError):
        NativeSimulator(p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = simulate(p, inputs).outputs
    want = port.run_interpreter(p, inputs)
    for o in want:
        np.testing.assert_array_equal(bits(got[o]), bits(want[o]))


@pytest.mark.parametrize("dt", NARROW)
@pytest.mark.parametrize("shape,dims,iters,routes,kw", [
    ("diffusion", (512, 512, 512), 8, ("panel", "panel"), {}),
    ("diffusion", (512, 512, 512), 2, ("overlap", "overlap"), {}),
    ("diffusion", (8192, 8192), 8, ("rows+group_g8",) * 2, {}),
    ("hdiff", (256, 256, 256), 16, ("tile", "panel"), {"spill": "off"}),
    ("hdiff", (256, 256, 256), 24, ("dense", "tile"), {"spill": "off"})])
def test_route_plans_the_narrow_cells(shape, dims, iters, routes, kw, dt):
    """Planning only: the narrow cells take the float32 cells' kernels,
    or one rung earlier where 2-byte cells fit a kernel that 4-byte ones
    do not: without the spill rung hdiff3d 256^3 x 16 takes K6 in float32
    and K1 narrow, and x 24 falls to ``dense`` in float32 and takes K6
    narrow (the K6 cell)."""
    for t, route in zip(("float32", dt), routes):
        p = port.parse_program(typed(shape, dims, iters, t))
        assert choose_backend(p, port.ChainAnalysis.run(p), "cuda",
                              **kw) == route


@pytest.mark.parametrize("dt", NARROW)
def test_route_plans_the_narrow_chunk(dt):
    """The out-of-core cell's chunk plan (jacobi3d 1024^3 x 8 at 8
    chunks): K4 plans the narrow program where it plans the float32 one,
    on chip, its cells at 2 bytes, so the same tile takes less shared
    memory."""
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.outofcore import _fake_plan
    from stencilflow_tpu_torch.parallel.domain import plan_local_stream
    plans = {}
    for t in ("float32", dt):
        p = port.parse_program(typed("diffusion", (1024,) * 3, 8, t))
        an = port.ChainAnalysis.run(p)
        h = chain_halo(an)[0]
        got = plan_local_stream(p, an, _fake_plan(p, (128, 1024, 1024),
                                                  (h, 0, 0)))
        assert got is not None
        plans[t] = got[0]
        assert not plans[t].packed and not plans[t].mxu_plans
    at = stream.plan_local(plans[dt].program, None, 128, plans[dt].halo_i,
                           tile=plans["float32"].tile)
    assert at.smem_bytes() < plans["float32"].smem_bytes()


def test_report_counts_two_bytes_a_cell():
    from stencilflow_tpu_torch.report import Report
    f32 = Report.build(port.parse_program(typed("diffusion", (16, 16, 16),
                                                2, "float32")))
    for dt in NARROW:
        rep = Report.build(port.parse_program(typed(
            "diffusion", (16, 16, 16), 2, dt)))
        assert 2 * rep.hbm_time_s() == pytest.approx(f32.hbm_time_s())


def test_report_prices_narrow_ops_at_the_packed_rate():
    """A narrow stage's ops at twice the FP32 rate (the data sheet's
    bf16/f16 rate outside the tensor cores), so jacobi3d 512^3 x 8 typed
    bf16 or f16 is bound by its bytes, as the float32 program computed in
    bf16 is; a float32 stage keeps the FP32 rate."""
    from stencilflow_tpu_torch.report import Report
    f32 = Report.build(port.parse_program(typed("diffusion", (512,) * 3, 8,
                                                "float32")))
    for dt in NARROW:
        rep = Report.build(port.parse_program(typed(
            "diffusion", (512,) * 3, 8, dt)))
        assert 2 * rep.alu_time_s() == pytest.approx(f32.alu_time_s())
        assert rep.bound() == "hbm"
        assert rep.roofline_time_s() == pytest.approx(rep.hbm_time_s())
    assert 2 * f32.alu_time_s("bfloat16") == pytest.approx(f32.alu_time_s())
    assert f32.bound(compute_dtype="bfloat16") == "hbm"
    mixed = Report.build(port.parse_program(f32_reads_bf16_spec()))
    assert mixed.alu_time_s() == pytest.approx(
        mixed.total_ops() / mixed.hw.alu_ops)


@pytest.fixture
def bf16_json(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("p.json", "w") as f:
        json.dump(typed("hdiff", (8, 12, 16), 2, "bfloat16"), f)
    return "p.json"


def test_cli_run_compare_to_reference(bf16_json, capsys):
    assert main(["run", bf16_json, "--device", "cpu",
                 "--compare-to-reference", "--run-simulation"]) == 0
    out = capsys.readouterr().out
    assert "verified against reference: OK" in out
    assert "verified against simulation: OK" in out
    assert main(["simulate", bf16_json]) == 0
    assert main(["compile", bf16_json, "--emulation"]) == 0
    assert "lowered with backend 'panel'" in capsys.readouterr().out

"""The stream kernel under every compute type on the CPU:
``compile_chain_stream(compute_dtype=T)`` for T in float32, bfloat16,
float16, int32 and bool on programs with int32, int16, bool, float64,
bfloat16 and float16 fields and scalars (K3a per-cell stages, K3c the
spill rung).

(a) The port's plain version against the JAX package's interpret-mode
kernel, run in one subprocess in its default 32-bit mode with
``--xla_allow_excess_precision=false`` (bf16 and f16 round after every
operation) and ``--xla_cpu_max_isa=AVX`` (below AVX2 XLA's CPU compiler
emits no FMA, so a float32 ``a * b + c`` rounds twice, as the port's
kernels do under ``-fmad=false``): bit for bit, NaN and saturated
float-to-int32 cells included.  (b) The generated CUDA source built with
g++ (``sf_host_launch``, arrays of the compute type) against the plain
version, bit for bit.  (c) The plan: slots and io at the compute type's
size, the launch keys.  (d) XLA's
conversions: the port's float-to-int32 and to-bool casts against the JAX
package's on NaN, infinities and out-of-range values.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.backend.build import scalar_blob
from stencilflow_tpu_torch.backend.promotion import (COMPUTE_TYPES,
                                                     xla_convert_scalar)
from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
from stencilflow_tpu_torch.backend.tile_eval import (from_compute,
                                                     to_compute, xla_convert)
from stencilflow_tpu_torch.dtypes import to_torch_dtype
from stencilflow_tpu_torch.synthesize import (jacobi, mixed_dtype_spec,
                                              narrow_mixed_spec)
from test_torch_stream import _gxx

SEED = 61


def _wide_jacobi():
    """jacobi3d 12^3 x 2 on [-1000, 1000): inputs in [0, 1) would all
    truncate to 0 under integer compute."""
    spec = jacobi(3, 12, iterations=2)
    spec["inputs"]["a"]["data"] = "random:-1000,1000"
    return spec


def _nan_spec():
    """A division by zero (the BC's 0 and zeros of the data under integer
    compute) scaled past int32: NaN, infinities and out-of-range values
    reach a float32 stage and an int32 one."""
    return {"inputs": {"a": {"data": "random:-3,3", "data_type": "float32"},
                       "b": {"data": "random:-3,3", "data_type": "float32"}},
            "outputs": ["s", "t"], "dimensions": [6, 8, 10],
            "program": {
                "s": {"computation_string":
                      "s = a[i,j,k] / b[i,j+1,k] * 1e10",
                      "boundary_conditions": {"b": {"type": "constant",
                                                    "value": 0.0}},
                      "data_type": "float32"},
                "t": {"computation_string":
                      "t = s[i,j,k] * 3.0 + a[i-1,j,k]",
                      "boundary_conditions": {"a": {"type": "copy"}},
                      "data_type": "int32"}}}


def _scalars_spec():
    """Scalars of int32, float64 and bfloat16 beside a float16 array: each
    keeps its own 32-bit type at its sites (bf16 meets f16 in float32)."""
    return {"inputs": {"a": {"data": "random:-40,40", "data_type": "float16"},
                       "n": {"data": "random:2,9", "data_type": "int32",
                             "input_dims": []},
                       "d": {"data": "random:-2,2", "data_type": "float64",
                             "input_dims": []},
                       "g": {"data": "random:-2,3", "data_type": "bfloat16",
                             "input_dims": []}},
            "outputs": ["t"], "dimensions": [6, 8, 10],
            "program": {
                "s": {"computation_string":
                      "s = a[i,j,k] * n + d - a[i,j+1,k] * g",
                      "boundary_conditions": {"a": {"type": "constant",
                                                    "value": 0.3}},
                      "data_type": "float32"},
                "t": {"computation_string":
                      "t = s[i,j,k] / n if s[i,j-1,k] > g else "
                      "s[i+1,j,k] * 0.75",
                      "boundary_conditions": {"s": {"type": "shrink"}},
                      "data_type": "bfloat16"}}}


def _intops_spec():
    """int32 products that wrap, max and abs of int32, and an integer
    true division (float32, by zeros of the data)."""
    return {"inputs": {"a": {"data": "random:-1000,1000",
                             "data_type": "int32"},
                       "b": {"data": "random:-40,40", "data_type": "int32"}},
            "outputs": ["t", "u"], "dimensions": [6, 8, 10],
            "program": {
                "s": {"computation_string":
                      "s = a[i,j,k] * b[i,j,k] * a[i,j+1,k] * b[i,j,k+1] "
                      "- b[i-1,j,k]",
                      "boundary_conditions": {"a": {"type": "constant",
                                                    "value": 3},
                                              "b": {"type": "copy"}},
                      "data_type": "int32"},
                "t": {"computation_string":
                      "t = max(s[i,j,k], a[i,j,k-1]) + abs(s[i+1,j,k])",
                      "boundary_conditions": {"s": {"type": "constant",
                                                    "value": 1},
                                              "a": {"type": "constant",
                                                    "value": 0}},
                      "data_type": "int32"},
                "u": {"computation_string": "u = t[i,j,k] / b[i,j,k]",
                      "boundary_conditions": {},
                      "data_type": "float32"}}}


def _boolops_spec():
    """bool + and * (or and and), a comparison of bools, min of bools and
    a select of a float constant against a bool."""
    return {"inputs": {"a": {"data": "random:-2,2", "data_type": "float32"}},
            "outputs": ["t"], "dimensions": [6, 8, 10],
            "program": {
                "s": {"computation_string":
                      "s = a[i,j,k] + a[i,j+1,k] * a[i,j,k+1]",
                      "boundary_conditions": {"a": {"type": "constant",
                                                    "value": 0.0}},
                      "data_type": "float32"},
                "t": {"computation_string":
                      "t = s[i,j,k] * 2.5 + (1.0 if a[i-1,j,k] > s[i,j,k] "
                      "else min(a[i,j,k], s[i,j-1,k]))",
                      "boundary_conditions": {"a": {"type": "copy"},
                                              "s": {"type": "constant",
                                                    "value": 1.0}},
                      "data_type": "float32"}}}


def _fill_spec():
    """Constant BCs of 0.5 under bool compute on 0/1 data: a ring field's
    fill reaches bool through int32 (False), a (j, k) input's, whose plane
    the JAX package keeps of the compute type, directly (True)."""
    return {"inputs": {"a": {"data": "random:0,2", "data_type": "int32"},
                       "w": {"data": "random:0,2", "data_type": "int32",
                             "input_dims": ["j", "k"]}},
            "outputs": ["s"], "dimensions": [6, 8, 10],
            "program": {
                "s": {"computation_string":
                      "s = a[i,j+1,k] + w[j-1,k] * a[i-1,j,k+1]",
                      "boundary_conditions": {
                          "a": {"type": "constant", "value": 0.5},
                          "w": {"type": "constant", "value": 0.5}},
                      "data_type": "int32"}}}


_MIXED = mixed_dtype_spec((8, 10, 12))[0]
_SPECS = {"mixed": lambda: _MIXED,
          "narrow": lambda: narrow_mixed_spec((6, 8, 10)),
          "jacobi": _wide_jacobi, "nan": _nan_spec,
          "scalars": _scalars_spec, "intops": _intops_spec,
          "boolops": _boolops_spec, "fill": _fill_spec}

# name: (program, compile_chain_stream keywords, compute type)
CASES = {f"{prog}-{cd}": (prog, kw, cd) for prog, kw, cds in (
    ("mixed", {}, ("float32", "bfloat16", "float16", "int32", "bool")),
    ("narrow", {}, ("float32", "bfloat16", "float16", "int32")),
    ("jacobi", {}, ("int32", "bool")),
    ("nan", {}, ("float32", "int32")),
    ("scalars", {}, ("bfloat16", "float16", "int32")),
    ("intops", {}, ("int32",)),
    ("boolops", {}, ("bool",)),
    ("fill", {}, ("bool", "int32"))) for cd in cds}
CASES.update({
    "jacobi-spill-int32": ("jacobi", {"spill": "all"}, "int32"),
    "mixed-spill-bfloat16": ("mixed", {"spill": "all"}, "bfloat16"),
    "mixed-spill-bool": ("mixed", {"spill": "all"}, "bool"),
})

# what the JAX package raises at (program, compute type), the port too
RAISES = {
    "narrow-bool": ("narrow", "bool"),     # unary minus of a bool
    "minus-bool": ("minus", "bool"),       # bool - bool
}
_SPECS["minus"] = lambda: {
    "inputs": {"a": {"data": "random:-2,2", "data_type": "float32"}},
    "outputs": ["s"], "dimensions": [4, 8, 8],
    "program": {"s": {"computation_string": "s = a[i,j,k] - a[i,j+1,k]",
                      "boundary_conditions": {"a": {"type": "copy"}},
                      "data_type": "float32"}}}

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import stencilflow_tpu as ref
from stencilflow_tpu.backend.stream import compile_chain_stream
cases, raises = json.load(open(sys.argv[1]))
out, errors = {}, {}
for name, (spec, kw, cd) in list(cases.items()) + list(raises.items()):
    p = ref.parse_program(spec, name=name)
    inputs = ref.load_input_arrays(p, seed=%d)
    try:
        fn = compile_chain_stream(p, interpret=True, compute_dtype=cd, **kw)
        got = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    except Exception as e:
        errors[name] = type(e).__name__
        continue
    for o, v in got.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":   # as the bits the port compares
            v = v.view(np.uint16)
        out[name + "/" + o] = v
# XLA's conversions on the values a plain cast would get wrong
x = jnp.asarray([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0,
                 -2147483648.0, 2.7, -2.7, 0.0, -0.0, 0.3], jnp.float32)
out["convert/int32"] = np.asarray(x.astype(jnp.int32))
out["convert/bool"] = np.asarray(x.astype(jnp.bool_))
np.savez(sys.argv[2], **out)
json.dump(errors, open(sys.argv[3], "w"))
""" % SEED


def run_jax_parts(script: str, parts, d) -> list:
    """Run ``script`` (argv: its input JSON, then ``outputs`` more paths)
    on each of ``parts`` in its own subprocess, all at once: the JAX
    package in interpret mode, its default 32-bit mode, with XLA's CPU
    compiler rounding bf16 and f16 after every operation and emitting no
    FMA.  Returns each part's output directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false"
                          " --xla_cpu_max_isa=AVX").strip())
    env.pop("PYTEST_XDIST_WORKER", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, dirs = [], []
    for i, part in enumerate(parts):
        sub = d / f"part{i}"
        sub.mkdir()
        (sub / "in.json").write_text(json.dumps(part))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(sub / "in.json"),
             str(sub / "out.npz"), str(sub / "info.json")],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        dirs.append(sub)
    for proc in procs:
        _out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    return dirs


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """(outputs, exception names) of the JAX package's interpret-mode
    kernel on every case, in two subprocesses at once."""
    cases = {n: (_SPECS[prog](), kw, cd) for n, (prog, kw, cd)
             in CASES.items()}
    raises = {n: (_SPECS[prog](), {}, cd) for n, (prog, cd)
              in RAISES.items()}
    names = sorted(cases)
    parts = [[{n: cases[n] for n in names[0::2]}, raises],
             [{n: cases[n] for n in names[1::2]}, {}]]
    out, errors = {}, {}
    for sub in run_jax_parts(_JAX_SCRIPT, parts,
                             tmp_path_factory.mktemp("jax_compute")):
        out.update(np.load(sub / "out.npz"))
        errors.update(json.loads((sub / "info.json").read_text()))
    return out, errors


def _case(name):
    prog, kw, cd = CASES[name]
    p = port.parse_program(_SPECS[prog](), name=name)
    return p, kw, cd, port.load_input_arrays(p, seed=SEED)


def bits(t: torch.Tensor) -> np.ndarray:
    """An output as comparable numpy values (bf16 as its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# -- (a) the plain version against the JAX package ------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_interpret(name, jax_refs):
    p, kw, cd, inputs = _case(name)
    refs, errors = jax_refs
    assert name not in errors
    fn = stream.compile_chain_stream(p, device="cpu", compute_dtype=cd, **kw)
    assert fn.plan.compute == COMPUTE_TYPES[cd] and not fn.plan.mxu_plans
    got = fn(inputs)
    for o in p.outputs:
        want = refs[f"{name}/{o}"]
        g = bits(got[o]).reshape(want.shape)
        # the port keeps the program's type (float64 as float32 values)
        assert got[o].dtype == to_torch_dtype(p.kernels[o].dtype)
        np.testing.assert_array_equal(g.astype(want.dtype), want)


@pytest.mark.parametrize("name", sorted(RAISES))
def test_raises_where_jax_raises(name, jax_refs):
    """The JAX package raises TypeError tracing these sites; the port
    raises the same type when it plans, naming the kernel and the site."""
    prog, cd = RAISES[name]
    assert jax_refs[1][name] == "TypeError"
    p = port.parse_program(_SPECS[prog]())
    with pytest.raises(TypeError, match="jnp rejects .* bool"):
        stream.plan_stream(p, compute_dtype=cd)


def test_xla_conversions_match_jax(jax_refs):
    """Float to int32 truncates, saturates and sends NaN to 0; float to
    bool is ``!= 0`` (NaN true): as the JAX package's ``astype``, not as
    numpy's."""
    refs = jax_refs[0]
    x = torch.tensor([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0,
                      -2147483648.0, 2.7, -2.7, 0.0, -0.0, 0.3],
                     dtype=torch.float32)
    f32 = np.dtype(np.float32)
    for to, key in ((np.dtype(np.int32), "int32"), (np.dtype(np.bool_),
                                                    "bool")):
        want = refs["convert/" + key]
        np.testing.assert_array_equal(xla_convert(x, f32, to).numpy(), want)
        np.testing.assert_array_equal(
            [xla_convert_scalar(v, f32, to) for v in x.numpy()], want)


# -- (b) the generated source through g++ --------------------------------------

def run_host_compute(plan, inputs, tmp_path):
    """The generated kernel built with g++ on arrays of the plan's
    compute type (bf16 as its bits), its outputs cast to their kernel
    types as the wrapper casts them."""
    p, cd = plan.program, plan.compute
    io = to_torch_dtype(cd)
    src = stream.stream_source(plan)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cpp, so = tmp_path / f"{tag}.cpp", tmp_path / f"{tag}.so"
    cpp.write_text(src)
    proc = subprocess.run([_gxx(), "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.sf_host_launch.argtypes = [ctypes.c_void_p] * 3

    def host(t):
        t = t.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    spanned = spanned_arrays(p, inputs)
    arrays = [host(to_compute(spanned[n], s.dtype, cd).to(io))
              for n, s in p.inputs.items() if not s.is_scalar]
    arrays += [np.ascontiguousarray(a, np.float32)
               for _k, a in plan.kernel_pool()]
    outs = [torch.zeros(p.dimensions, dtype=io) for _o in p.outputs]
    obufs = [host(t) for t in outs]
    ip = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    op = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in obufs])
    lib.sf_host_launch(ctypes.addressof(ip), ctypes.addressof(op),
                       scalar_blob(p, inputs).ctypes.data)
    return {o: from_compute(t, cd, p.kernels[o].dtype)
            for o, t in zip(p.outputs, outs)}


@pytest.mark.parametrize("name", ["mixed-bfloat16", "mixed-bool",
                                  "mixed-int32", "narrow-float32",
                                  "scalars-float16", "nan-int32",
                                  "intops-int32", "boolops-bool",
                                  "fill-bool",
                                  "jacobi-spill-int32",
                                  "mixed-spill-bool"])
def test_generated_source_matches_plain(name, tmp_path):
    p, kw, cd, inputs = _case(name)
    plan = stream.plan_stream(p, compute_dtype=cd, tile=(4, 8),
                              spill=kw.get("spill", "auto"))
    assert plan.grid()[0] * plan.grid()[1] > 1
    assert plan.packed == ("spill" in name)
    got = run_host_compute(plan, inputs, tmp_path)
    want = stream.stream_plain(plan, spanned_arrays(p, inputs))
    for o in p.outputs:
        np.testing.assert_array_equal(bits(got[o]), bits(want[o]))


# -- (c) the plan -----------------------------------------------------------------

def test_plan_sizes_at_the_compute_types_size():
    """Slots and io at the compute type's bytes (int32 4, bool 1, bf16 2),
    whatever the program's types; ``ring_storage`` kept under float32
    (the stage rings then keep bf16 slots) and int32 (rounding nothing),
    dropped under bool and the narrow types."""
    p = port.parse_program(_MIXED)
    for cd, size in (("int32", 4), ("bool", 1), ("bfloat16", 2),
                     ("float16", 2), ("float32", 4)):
        plan = stream.plan_stream(p, compute_dtype=cd, tile=(4, 8))
        assert plan.compute == COMPUTE_TYPES[cd]
        for f in plan.raw_ring:
            assert plan.itemsize(f) == size
        assert plan.io_itemsize("a") == size
        assert plan.io_itemsize(p.outputs[0]) == size
        rs = stream.plan_stream(p, compute_dtype=cd, tile=(4, 8),
                                ring_storage="bfloat16")
        assert rs.ring_storage == ("bfloat16" if size == 4 else "off")
        # every ring rounds to a narrow compute type, float32 rings to
        # bf16 under float32 compute, none under int32 and bool
        assert bool(rs.rounds) == (cd not in ("int32", "bool"))
        if cd == "float32":
            assert {f for f in rs.raw_ring if rs.itemsize(f) == 2} == \
                set(p.kernels) & set(rs.raw_ring)


def test_launch_keys():
    """A plan under a compute type counts under its own key, the spill
    rung's apart; a float32 program keeps the keys it had."""
    jac = port.parse_program(_wide_jacobi())
    mixed = port.parse_program(_MIXED)
    for p, cd, key in ((jac, "bfloat16", "compute_bf16"),
                       (jac, "float16", "compute_f16"),
                       (jac, "int32", "compute_i32"),
                       (jac, "bool", "compute_bool"),
                       (mixed, "float32", "compute_f32_typed"),
                       (mixed, "bfloat16", "compute_bf16_typed"),
                       (mixed, "int32", "compute_i32_typed")):
        plan = stream.plan_stream(p, compute_dtype=cd)
        assert stream.compute_key(plan) == key
        assert stream._mode(plan) == key
        # the spill rung (K3c) counts apart from K3a
        packed = stream.plan_stream(p, compute_dtype=cd, spill="all")
        assert packed.packed
        assert stream.compute_key(packed) == "spill_" + key
        assert stream._mode(packed) == "spill_" + key
    assert stream.plan_stream(jac, compute_dtype="float32").compute is None


def test_mixed_dtype_seed_is_the_first_draw_the_simulator_runs():
    """``synthesize.MIXED_DTYPE_SEED`` is the first draw from seed 0 up
    with an int32, a bool and a floating stage whose C++ simulator core
    is generated."""
    from stencilflow_tpu_torch.sim.native import (NativeBuildError,
                                                  generate_cpp)
    from stencilflow_tpu_torch.synthesize import MIXED_DTYPE_SEED

    def runs(seed):
        spec, name = mixed_dtype_spec((8, 10, 12), seed)
        kinds = {k["data_type"] for k in spec["program"].values()}
        if not ({"int32", "bool"} <= kinds
                and kinds & {"float32", "float64"}):
            return False
        p = port.parse_program(spec, name=name)
        try:
            generate_cpp(p, port.ChainAnalysis.run(p))
        except NativeBuildError:
            return False
        return True
    assert [runs(s) for s in range(MIXED_DTYPE_SEED + 1)] == \
        [False] * MIXED_DTYPE_SEED + [True]


def test_plain_version_counts_no_launch():
    p, kw, cd, inputs = _case("jacobi-int32")
    before = sum(stream.launches_by.values())
    stream.compile_chain_stream(p, device="cpu", compute_dtype=cd)(inputs)
    assert sum(stream.launches_by.values()) == before


def test_report_prices_a_cell_at_the_compute_types_size():
    """``report.hbm_time_s``: every input and output cell at the compute
    type's bytes (4 for float32 and int32, 2 for bf16 and f16, 1 for
    bool); a float32 program under bf16 or f16 keeps its halved figure,
    and only a narrow compute prices every op at the packed rate."""
    from stencilflow_tpu_torch.report import Report
    f32 = Report.build(port.parse_program(_wide_jacobi()))
    vol = f32.analysis.minimum_communication_volume()
    bw = f32.hw.hbm_bandwidth
    for cd, size in (("float32", 4), ("int32", 4), ("int64", 4),
                     ("bfloat16", 2), ("float16", 2), ("bool", 1)):
        assert f32.hbm_time_s(cd) == pytest.approx(vol * size / 4 / bw)
    assert f32.hbm_time_s("bfloat16") == pytest.approx(vol / 2 / bw)
    typed = Report.build(port.parse_program(_scalars_spec()))
    dims = typed.program.dimensions
    cells = sum(int(np.prod(s.shape(dims))) for s in
                typed.program.inputs.values()) + typed.program.total_elements
    for cd, size in (("float32", 4), ("bfloat16", 2), ("bool", 1)):
        assert typed.hbm_time_s(cd) == pytest.approx(cells * size / bw)
    assert typed.narrow_ops_per_cell("float32") == 0.0
    assert typed.narrow_ops_per_cell("int32") == 0.0
    assert typed.narrow_ops_per_cell("bfloat16") == typed.ops_per_cell()
    assert typed.narrow_ops_per_cell() > 0   # its bf16 stage, own types

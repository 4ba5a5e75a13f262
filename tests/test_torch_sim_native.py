"""The port's generated-C++ simulator core against the JAX package's.

``stencilflow_tpu_torch/sim/native.py`` is a copy of
``stencilflow_tpu/sim/native.py``: for the same program its
``generate_cpp`` emits the same text (checked on every example and on 20
fuzz programs over int8/int32/int64/float16/float32/float64 fields and
mixed-dtype chains with bool stages; nothing is built), and where the
original refuses a program (``NativeBuildError``) the copy refuses it
with the same message.  Then a few programs are built with g++ by both
packages: outputs bit-equal to the JAX package's core, to the port's
Python machine and to the numpy oracle, with equal cycle counts and
statistics, int64 values beyond 2**53 included.  The port builds into
``stencilflow_tpu_torch/_build/sim/``, never into the JAX package's
``.simcache/``.
"""
import json
import os
import warnings

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.sim import machine as ref_machine
from stencilflow_tpu.sim import native as ref_native
from stencilflow_tpu_torch.sim import Simulator
from stencilflow_tpu_torch.sim import machine as port_machine
from stencilflow_tpu_torch.sim import native as port_native
from stencilflow_tpu_torch.synthesize import jacobi, random_program
from test_fuzz import make_mixed_dtype_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in
            sorted(os.listdir(os.path.join(ROOT, "examples")))
            if f.endswith(".json")]
BUILD_DIR = os.path.join(ROOT, "stencilflow_tpu_torch", "_build", "sim")


def _small(path, size=8):
    spec = json.load(open(path))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


def _both(spec, name):
    return (ref.parse_program(spec, name=name),
            port.parse_program(spec, name=name))


def _cpp(pkg, native, program, slack=0):
    """generate_cpp's text, or the NativeBuildError's message."""
    try:
        return "ok", native.generate_cpp(
            program, pkg.ChainAnalysis.run(program), slack)
    except native.NativeBuildError as exc:
        return "refused", str(exc)


# -- generate_cpp: text-equal, nothing built ---------------------------------

@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
@pytest.mark.parametrize("size", [8, 0], ids=["8cubed", "full"])
def test_generate_cpp_text_equal_on_example(path, size):
    spec = _small(path, size) if size else json.load(open(path))
    a, b = _both(spec, "ex")
    want = _cpp(ref, ref_native, a)
    assert want[0] == "ok"
    assert _cpp(port, port_native, b) == want


FUZZ_KINDS = [
    ("f32", dict()),
    ("f64-shrink", dict(data_type="float64",
                        bc_kinds=("constant", "copy", "shrink"))),
    ("f16", dict(data_type="float16")),
    ("i8", dict(data_type="int8", data="random:-20,20")),
    ("i32", dict(data_type="int32", data="random:-20,20")),
    ("i64", dict(data_type="int64", data="random:-20,20")),
    ("mixed", dict(nondyadic=False)),
    ("mixed-nondyadic", dict(nondyadic=True)),
    ("mixed-amplified", dict(amplified_consumer=True)),
    ("mixed-both", dict(nondyadic=True, amplified_consumer=True)),
]


def _fuzz_spec(kind, seed):
    kw = dict(FUZZ_KINDS)[kind]
    rng = np.random.default_rng(900 + seed)
    if kind.startswith("mixed"):
        return make_mixed_dtype_program(rng, **kw)
    return random_program(rng, ndim=2 + seed % 2, **kw)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", [k for k, _ in FUZZ_KINDS])
def test_generate_cpp_text_equal_on_fuzz(kind, seed):
    a, b = _both(_fuzz_spec(kind, seed), f"fuzz_{kind}")
    want = _cpp(ref, ref_native, a)
    assert _cpp(port, port_native, b) == want
    if want[0] == "ok":   # and at a slack the zero-slack proof does not use
        assert _cpp(port, port_native, b, 2) == _cpp(ref, ref_native, a, 2)


def test_fuzz_kinds_reach_every_dtype():
    """The 20 programs above hold int8/int32/int64/bool/float16/float32/
    float64 kernels, and at least one mixed chain the core runs."""
    seen, native_mixed = set(), 0
    for kind, _ in FUZZ_KINDS:
        for seed in range(2):
            b = port.parse_program(_fuzz_spec(kind, seed))
            seen |= {np.dtype(k.dtype).name for k in b.kernels.values()}
            if kind.startswith("mixed") and len(
                    {np.dtype(k.dtype) for k in b.kernels.values()}) > 1:
                native_mixed += _cpp(port, port_native, b)[0] == "ok"
    assert {"int8", "int32", "int64", "bool", "float16", "float32",
            "float64"} <= seen
    assert native_mixed >= 1


# -- built with g++: at most ten programs ------------------------------------

INT8_SPEC = {
    "inputs": {"f": {"data": "random:0,120", "data_type": "int8"}},
    "outputs": ["s"], "dimensions": [5, 5, 5],
    "program": {
        "t": {"computation_string": "t = f[i,j,k] * 7 - f[i,j,k-1] * 5",
              "boundary_conditions": {"f": {"type": "constant",
                                            "value": 3}},
              "data_type": "int8"},
        "s": {"computation_string":
              "s = t[i,j,k] + (f[i,j,k] / 2 > 20) * 4"
              " + max(t[i-1,j,k], 0 - t[i,j,k])",
              "boundary_conditions": {"t": {"type": "constant", "value": 1},
                                      "f": {"type": "constant", "value": 3}},
              "data_type": "int8"}}}

INT64_BIG_SPEC = {
    "inputs": {"f": {"data": "random:1000000000,4000000000",
                     "data_type": "int64"},
               "g": {"data": "random:1,1000000", "data_type": "int64"}},
    "outputs": ["q"], "dimensions": [4, 6, 5],
    "program": {
        "s": {"computation_string": "s = f[i,j,k] * f[i,j,k-1] + f[i+1,j,k]",
              "boundary_conditions": {"f": {"type": "constant",
                                            "value": 7}},
              "data_type": "int64"},
        "q": {"computation_string":
              "q = s[i,j,k] - s[i,j-1,k] + min(s[i,j,k], "
              "g[i,j,k] * g[i,j,k])",
              "boundary_conditions": {"s": {"type": "constant", "value": 0},
                                      "g": {"type": "constant", "value": 1}},
              "data_type": "int64"}}}

BIG = np.int64(2 ** 62 + 12345)
INT64_SCALAR_SPEC = {
    "inputs": {"f": {"data": "random:1,1000", "data_type": "int64"},
               "c": {"data": BIG, "data_type": "int64", "input_dims": []}},
    "outputs": ["s"], "dimensions": [4, 4, 4],
    "program": {"s": {
        "computation_string": "s = c + f[i,j,k] - f[i,j,k-1]",
        "boundary_conditions": {"f": {"type": "constant", "value": 2}},
        "data_type": "int64"}}}

SCALAR_SPEC = {
    "inputs": {"a": {"data": "random:0,1", "data_type": "float64"},
               "c": {"data": 2.5, "data_type": "float64",
                     "input_dims": []}},
    "outputs": ["b"], "dimensions": [8, 8],
    "program": {"b": {
        "computation_string": "b = c * a[j,k] + a[j-1,k]",
        "boundary_conditions": {"a": {"type": "constant", "value": 0.0}},
        "data_type": "float64"}}}

BUILT = {
    "hdiff": lambda: _small(os.path.join(ROOT, "examples",
                                         "hdiff_64x64x64.json")),
    "fuzz_f32": lambda: random_program(np.random.default_rng(122)),
    "mixed": lambda: make_mixed_dtype_program(np.random.default_rng(3),
                                              nondyadic=True,
                                              amplified_consumer=True),
    "int8wrap": lambda: INT8_SPEC,
    "int64big": lambda: INT64_BIG_SPEC,
    "int64sc": lambda: INT64_SCALAR_SPEC,
}


def _same_stats(ra, rb):
    assert ra.cycles == rb.cycles
    assert ra.edge_high_water == rb.edge_high_water
    assert ra.edge_mean_occupancy == rb.edge_mean_occupancy
    for k, st in ra.kernel_stats.items():
        for key in ("first_fire", "last_fire", "stall_cycles"):
            assert st[key] == rb.kernel_stats[k][key], (k, key)


@pytest.mark.parametrize("name", sorted(BUILT))
def test_native_core_matches(name):
    """Built by both packages: same outputs (bit for bit, also against
    the oracle and the port's Python machine), cycles and statistics."""
    a, b = _both(BUILT[name](), name)
    inputs = port.load_input_arrays(b, seed=4)
    if "c" in inputs and b.inputs["c"].dtype == np.int64:
        inputs["c"] = BIG
    want = ref_native.NativeSimulator(a).run(inputs)
    sim = port_native.NativeSimulator(b)
    assert os.path.dirname(sim.so_path) == BUILD_DIR
    assert sim.source == ref_native.generate_cpp(a, ref.ChainAnalysis.run(a))
    got = sim.run(inputs)
    _same_stats(want, got)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # int wraparound is on purpose
        oracle = port.run_interpreter(b, inputs)
        python = Simulator(b).run(inputs)
    _same_stats(python, got)
    for o in b.outputs:
        assert got.outputs[o].dtype == np.asarray(oracle[o]).dtype
        for other in (want.outputs[o], oracle[o], python.outputs[o]):
            np.testing.assert_array_equal(got.outputs[o], np.asarray(other))
    if name == "int64sc":   # the low bits survive no double round-trip
        assert int(got.outputs["s"].ravel()[0]) % 65536 not in (0, 8192)
    if name == "int64big":
        assert np.abs(got.outputs["q"]).max() > 2 ** 53


def test_native_shape1_scalar_reads_as_0d_scalar():
    """The port's core reads a shape-(1,) scalar input as its 0-d value,
    as the port's machine does (the one intended difference)."""
    a, b = _both(SCALAR_SPEC, "sc2d")
    inputs = port.load_input_arrays(b, seed=8)
    zero_d = dict(inputs, c=np.float64(2.5))
    want = ref_native.NativeSimulator(a).run(zero_d)
    sim = port_native.NativeSimulator(b)
    for c in (np.float64(2.5), np.array([2.5])):
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # no array-to-scalar coercion
            got = sim.run(dict(inputs, c=c))
        _same_stats(want, got)
        np.testing.assert_array_equal(got.outputs["b"], want.outputs["b"])


def _corrupt_windows(real_fn):
    def fake(program, analysis):
        w = dict(real_fn(program, analysis))
        lo, hi = w[("a", "s0")]
        w[("a", "s0")] = (lo + 1, hi)
        return w
    return fake


def test_native_stale_read_raises_alike(monkeypatch):
    """A seeded staleness bug: both cores raise SimulationError with the
    same message, and a second run of the faulted core faults again."""
    a, b = _both(jacobi(3, 8, iterations=2), "stale_cc")
    inputs = port.load_input_arrays(b, seed=0)
    for machine, native in ((ref_machine, ref_native),
                            (port_machine, port_native)):
        monkeypatch.setattr(native, "access_windows",
                            _corrupt_windows(machine.access_windows))
    msgs = []
    for native, p in ((ref_native, a), (port_native, b)):
        core = native.NativeSimulator(p)
        for _ in range(2):
            with pytest.raises(native.SimulationError) as exc:
                core.run(inputs)
            msgs.append((type(exc.value).__name__, str(exc.value)))
    assert msgs[0] == msgs[1] == msgs[2] == msgs[3]
    assert "stale/underflow read on edge" in msgs[0][1]


def test_native_deadlock_raises_alike(monkeypatch):
    """An undersized edge: both cores raise DeadlockError (the Python
    machine's type) with the same message."""
    a, b = _both(jacobi(3, 8, iterations=2), "ddlk_cc")
    inputs = port.load_input_arrays(b, seed=0)
    for machine, native in ((ref_machine, ref_native),
                            (port_machine, port_native)):
        real = machine.edge_capacities

        def undersize(program, analysis, windows=None, slack=0, real=real):
            caps = dict(real(program, analysis, windows, slack))
            caps[("a", "s0")] = 2
            return caps
        monkeypatch.setattr(native, "edge_capacities", undersize)
    msgs = []
    for machine, native, p in ((ref_machine, ref_native, a),
                               (port_machine, port_native, b)):
        with pytest.raises(machine.DeadlockError) as exc:
            native.NativeSimulator(p).run(inputs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and msgs[1].startswith("deadlock at cycle")


def test_build_dir_is_the_ports(monkeypatch, tmp_path):
    """_build compiles the generated source into the port's build
    directory, with an atomic rename, and reuses it by source hash; no
    g++ raises NativeBuildError, which simulate() falls back from."""
    monkeypatch.setattr(port_native, "_CACHE_DIR", str(tmp_path))
    src = "extern \"C\" int simulate() { return 0; }\n"
    so = port_native._build(src)
    assert os.path.dirname(so) == str(tmp_path) and os.path.isfile(so)
    assert port_native._build(src) == so
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    assert port_native._CACHE_DIR != ref_native._CACHE_DIR
    monkeypatch.setattr(port_native, "_CACHE_DIR", str(tmp_path / "x"))
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(port_native.NativeBuildError, match="g\\+\\+"):
        port_native._build(src)

"""The port's canonicalization passes against the JAX package's, on the
CPU.

``stencilflow_tpu_torch/frontend/canonicalize.py`` is a copy of the JAX
package's module.  Each pass, and ``canonicalize`` with ``constants`` and
with ``min_max_to_select``, runs on the five example programs (cut to 8
per dimension) and on fuzz programs in both packages; the results must
give the same ``program_to_json`` text, compared in order (no sorted
keys, so a difference of key or kernel order shows), and the same oracle
outputs before and after the passes (np.array_equal: both oracles are
numpy).  The op-list frontend, ``nest_dimension`` and the reference's
error cases are held to the JAX package the same way.
"""
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu.frontend.canonicalize as rc
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.frontend.canonicalize as pc
from stencilflow_tpu_torch.synthesize import jacobi, random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith(".json"))
FUZZ = [3, 11, 24, 57, 122]


def _spec(name):
    """An example program cut to 8 per dimension, or a fuzz program."""
    if isinstance(name, int):
        return random_program(np.random.default_rng(name))
    spec = json.load(open(os.path.join(ROOT, "examples", name)))
    spec["dimensions"] = [min(d, 8) for d in spec["dimensions"]]
    return spec


def _text(pkg, program):
    return json.dumps(pkg.program_to_json(program), default=str)


def _same(a, b):
    """The two packages' programs give the same JSON, in order, and the
    same oracle outputs on the same inputs."""
    assert _text(port, b) == _text(ref, a)
    ins = ref.load_input_arrays(a, seed=1)
    want = ref.run_interpreter(a, ins)
    got = port.run_interpreter(b, port.load_input_arrays(b, seed=1))
    assert list(got) == list(want)
    for o in want:
        assert np.array_equal(np.asarray(want[o]), np.asarray(got[o]),
                              equal_nan=True), o
    return want


def _scalars(program):
    return {n: 0.5 + i for i, (n, s) in enumerate(program.inputs.items())
            if s.is_scalar}


PASSES = {
    "remove_dead_kernels": lambda m, p: m.remove_dead_kernels(p),
    "specialize_constants": lambda m, p: m.specialize_constants(p),
    "specialize_constants_values": lambda m, p: m.specialize_constants(
        p, _scalars(p)),
    "predicate_min_max": lambda m, p: m.predicate_min_max(p),
    "canonicalize": lambda m, p: m.canonicalize(p),
    "canonicalize_constants": lambda m, p: m.canonicalize(
        p, constants=_scalars(p) or {"unused": 1.0}),
    "canonicalize_min_max": lambda m, p: m.canonicalize(
        p, min_max_to_select=True),
}


@pytest.mark.parametrize("name", EXAMPLES + FUZZ, ids=str)
@pytest.mark.parametrize("pass_", sorted(PASSES))
def test_pass_matches(pass_, name):
    spec = _spec(name)
    a = ref.parse_program(spec, name="prog")
    b = port.parse_program(spec, name="prog")
    before = _same(a, b)
    ra, pb = PASSES[pass_](rc, a), PASSES[pass_](pc, b)
    after = _same(ra, pb)
    if "constants" in pass_ or "values" in pass_:
        return   # new values for the scalars: new outputs
    # every other pass keeps the values of the outputs it keeps
    for o in after:
        assert np.array_equal(np.asarray(before[o]), np.asarray(after[o]),
                              equal_nan=True), o


def _kernel(mod, pkg, name, computation, fields):
    masks = {f: (True, True, True) for f in fields}
    stmts = mod.parse_computation(name, computation, masks, {}, {})
    bcs = {f: pkg.BoundaryCondition(pkg.BCKind.CONSTANT, 0.0)
           for f in fields}
    return pkg.KernelSpec(name, stmts, np.dtype("float32"), bcs, computation)


def test_version_program_matches():
    """b = f(a); b = f(b); b = f(b): __1-style versions, last write keeps
    the name (the reference's ``TestVersioning`` op list)."""
    import stencilflow_tpu.frontend.parser as rparse
    import stencilflow_tpu_torch.frontend.parser as pparse
    ops = [("b", "b = a[i,j,k] + 1.0", ["a"]),
           ("b", "b = b[i,j,k] * 2.0", ["b"]),
           ("b", "b = b[i,j,k-1] + b[i,j,k]", ["b"])]
    got = {}
    for mod, pkg, canon in ((rparse, ref, rc), (pparse, port, pc)):
        kernels = canon.version_program(
            [(t, _kernel(mod, pkg, t, c, f)) for t, c, f in ops], ["b"])
        got[pkg.__name__] = [(n, k.name, repr(k.statements),
                              sorted(k.boundary_conditions))
                             for n, k in kernels.items()]
    assert got["stencilflow_tpu_torch"] == got["stencilflow_tpu"]
    assert [n for n, *_ in got["stencilflow_tpu"]] == ["b__1", "b__2", "b"]


OPS = [
    ("lap", "lap = a[i,j-1,k] + a[i,j+1,k] + a[i,j,k-1] + "
            "a[i,j,k+1] - 4.0*a[i,j,k]",
     {"a": {"type": "constant", "value": 0.0}}),
    ("b", "b = a[i,j,k] + 0.1 * lap[i,j,k]", {}),
    ("b", "b = b[i,j,k] + 0.1 * (b[i,j-1,k] + b[i,j+1,k] "
          "- 2.0*b[i,j,k])",
     {"b": {"type": "constant", "value": 0.0}}),
    ("b", "b = b[i,j,k] * 0.5 + lap[i,j,k+1] * 0.25",
     {"lap": {"type": "constant", "value": 0.0}}, "float64"),
]
INPUTS = {"a": {"data": "random:-1,1", "data_type": "float32"},
          "c": {"data": 2.0, "data_type": "float32", "input_dims": []}}


@pytest.mark.parametrize("vectorization", [1, 2])
def test_program_from_op_list_matches(vectorization):
    """The ordered-op-list frontend (repeated writes, per-op BCs and
    dtypes) and its canonicalized form."""
    kw = dict(name="oplist", vectorization=vectorization,
              constants={"k0": 0.25})
    a = ref.program_from_op_list(OPS, (4, 8, 8), INPUTS, ["b"], **kw)
    b = port.program_from_op_list(OPS, (4, 8, 8), INPUTS, ["b"], **kw)
    assert list(b.kernels) == ["lap", "b__1", "b__2", "b"]
    _same(a, b)
    _same(ref.canonicalize(a, {"c": 3.0}, True),
          port.canonicalize(b, {"c": 3.0}, True))


@pytest.mark.parametrize("name", ["jacobi2d_128x128.json",
                                  "hotspot2d_64x64.json",
                                  "forked_box_chain.json"])
@pytest.mark.parametrize("spanning", [None, ["a"]])
def test_nest_dimension_matches(name, spanning):
    spec = _spec(name)
    a = ref.nest_dimension(ref.parse_program(spec, name="n2"), 3, spanning)
    b = port.nest_dimension(port.parse_program(spec, name="n2"), 3,
                            spanning)
    assert b.dimensions == (3, 8, 8)
    _same(a, b)


def test_rotate_2d_to_rows_matches():
    spec = jacobi(2, 8, iterations=3)
    a = rc.rotate_2d_to_rows(ref.parse_program(spec, name="r"))
    b = pc.rotate_2d_to_rows(port.parse_program(spec, name="r"))
    assert _text(port, b) == _text(ref, a)


def _raises(fn):
    """(class name, message) of what ``fn`` raises."""
    with pytest.raises(Exception) as exc:
        fn()
    return type(exc.value).__name__, str(exc.value)


ERRORS = {
    # tests/test_frontend2.py::test_op_list_read_before_write_rejected
    "read_before_write": lambda pkg: pkg.program_from_op_list(
        [("a", "a = b[i,j,k] * 2.0",
          {"b": {"type": "constant", "value": 0.0}}),
         ("b", "b = inp[i,j,k]",
          {"inp": {"type": "constant", "value": 0.0}})],
        inputs={"inp": {"data": "constant:1.0", "data_type": "float32"}},
        outputs=["a"], dimensions=[4, 4, 4], name="rbw"),
    "read_missing": lambda pkg: pkg.program_from_op_list(
        [("a", "a = missing[i,j,k]",
          {"missing": {"type": "constant", "value": 0.0}})],
        inputs={"inp": {"data": "constant:1.0", "data_type": "float32"}},
        outputs=["a"], dimensions=[4, 4, 4], name="missingread"),
    "vectorization": lambda pkg: pkg.program_from_op_list(
        [("a", "a = inp[i,j,k]",
          {"inp": {"type": "constant", "value": 0.0}})],
        inputs={"inp": {"data": "constant:1.0", "data_type": "float32"}},
        outputs=["a"], dimensions=[4, 4, 10], vectorization=3,
        name="badvec"),
    "target_is_input": lambda pkg: pkg.program_from_op_list(
        [("a", "a = a[i,j,k] + 1.0", {})], (4, 8, 8), INPUTS, ["a"]),
    "never_written": lambda pkg: pkg.program_from_op_list(
        OPS, (4, 8, 8), INPUTS, ["zzz"]),
    # tests/test_frontend2.py::test_specialize_constants_collision_rejected
    "constant_collision": lambda pkg: (
        rc if pkg is ref else pc).specialize_constants(pkg.parse_program({
            "inputs": {"c": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["o"], "dimensions": [4, 4, 4],
            "constants": {"c": 3.0},
            "program": {"o": {
                "computation_string": "o = c[i, j+1, k]",
                "boundary_conditions": {
                    "c": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}}}, name="cclash")),
    "nest_3d": lambda pkg: pkg.nest_dimension(
        pkg.parse_program(jacobi(3, 8, iterations=1), name="nk3"), 4),
    "nest_unknown_input": lambda pkg: pkg.nest_dimension(
        pkg.parse_program(jacobi(2, 8, iterations=1), name="nk4"), 4,
        inputs_spanning=["zzz"]),
    "nest_extent": lambda pkg: pkg.nest_dimension(
        pkg.parse_program(jacobi(2, 8, iterations=1), name="nk5"), 0),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match(case):
    want = _raises(lambda: ERRORS[case](ref))
    assert want[0] == "ValueError"
    assert _raises(lambda: ERRORS[case](port)) == want

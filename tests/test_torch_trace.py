"""The port's traced-Python frontend against the JAX package's, on the
CPU.

``stencilflow_tpu_torch/frontend/trace.py`` is a copy of the JAX
package's module.  The traced functions of ``tests/test_frontend2.py``,
and traces mixing Python and numpy ints and floats, run through both
packages' ``trace_program``: the programs must give the same
``program_to_json`` text, compared in order, and the same oracle outputs
on the same inputs (np.array_equal: both oracles are numpy); the
reference's ``TraceError`` cases raise the same class with the same
message in both.
"""
import json

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu.frontend.trace as rt
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.frontend.trace as pt


def jacobi2(T):
    def fn(a):
        b = 0.25 * (a[0, -1, 0] + a[0, 1, 0] + a[0, 0, -1] + a[0, 0, 1])
        c = 0.25 * (b[0, -1, 0] + b[0, 1, 0] + b[0, 0, -1] + b[0, 0, 1])
        return {"c": c}
    return fn


def lowdim(T):
    def fn(a, row, c):
        return {"u": a[0, 0, 1] * c + row[0, 0, 0]}
    return fn


def predicates(T):
    def fn(a):
        center = a[0, 0, 0]
        return {"o": (center > 0.5).where(T.maximum(center, 0.75),
                                          -center)}
    return fn


def three_d(T):
    def fn(a):
        return {"b": (a[-1, 0, 0] + a[1, 0, 0] + a[0, 0, 0]) / 3.0}
    return fn


def calls(T):
    def fn(a, b):
        s = T.sqrt(T.absolute(a[0, 0, 0]) + 1.0)
        t = T.exp(-b[0, 1, 0]) * T.sin(a[0, 0, -1]) + T.cos(b[0, 0, 0])
        u = T.tanh(s - t) + T.log(s) - T.tan(0.5 * t)
        return {"u": T.minimum(u, s), "v": (u <= t).where(u, 2 * s)}
    return fn


def mixed_numbers(T):
    """Python and numpy ints and floats mixed into one trace (each is
    lifted to a float constant, as in the reference)."""
    def fn(a, n):
        x = 2 * a[0, 0, 0] + np.int32(3) - n[0, 0, 0] * np.float64(0.5)
        y = (x >= np.float32(1.5)).where(x / 4, 7)
        z = 1 - y[0, 1, 0] + np.int64(-2) * y[0, 0, 0]
        return z      # a single value: output "out"
    return fn


def named_stage(T):
    def fn(a):
        s = (a[0, 0, 0] * 2.0).named("twice")
        return {"r": s[0, 0, 1] + s[0, 0, -1] - s, "s2": s * s}
    return fn


def shared_stage(T):
    def fn(a):
        b = a[0, 0, 1] - a[0, 0, -1]
        return {"p": b[0, 1, 0] + b[0, -1, 0], "q": b[0, 1, 0] * 3.0}
    return fn


CASES = {
    "jacobi2": (jacobi2, (16, 16), {"a": np.float32}, {}),
    "lowdim": (lowdim, (4, 8),
               {"a": np.float32,
                "row": {"dtype": np.float32, "dims": ["k"]},
                "c": {"dtype": np.float32, "dims": []}}, {}),
    "predicates": (predicates, (8, 8), {"a": np.float32}, {}),
    "three_d": (three_d, (8, 8, 8), {"a": np.float32}, {}),
    "calls": (calls, (6, 8, 8),
              {"a": np.float32, "b": {"dtype": "float32",
                                      "bc": {"type": "copy"}}},
              dict(boundary="constant", boundary_value=0.5)),
    "mixed_numbers": (mixed_numbers, (6, 8),
                      {"a": np.float64, "n": {"dtype": np.int32}},
                      dict(dtype=np.float64, name="mixed")),
    "int_program": (mixed_numbers, (4, 8),
                    {"a": np.int32, "n": np.int32},
                    dict(dtype=np.int32, boundary="copy")),
    "named_stage": (named_stage, (4, 6, 8), {"a": np.float32},
                    dict(vectorization=2)),
    "shared_stage": (shared_stage, (8, 8), {"a": np.float32},
                     dict(boundary="shrink")),
}


def _trace(pkg_trace, case):
    fn, dims, inputs, kw = CASES[case]
    return pkg_trace.trace_program(fn(pkg_trace), dims, inputs, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches(case):
    a, b = _trace(rt, case), _trace(pt, case)
    text = json.dumps(ref.program_to_json(a), default=str)
    assert json.dumps(port.program_to_json(b), default=str) == text
    ins = ref.load_input_arrays(a, seed=3)
    want = ref.run_interpreter(a, ins)
    got = port.run_interpreter(b, port.load_input_arrays(b, seed=3))
    assert list(got) == list(want)
    for o in want:
        assert np.array_equal(np.asarray(want[o]), np.asarray(got[o]),
                              equal_nan=True), o


def _bool_branch(T):
    def fn(a):
        x = a[0, 0, 1]
        return x if (a[0, 0, 0] > x) else a[0, 0, 0]   # Python control flow
    return fn


ERRORS = {
    "unspanned_offset": (lambda T: lambda r: {"o": r[0, 1, 0]}, (4, 4),
                         {"row": {"dtype": np.float32, "dims": ["k"]}}),
    "control_flow": (_bool_branch, (4, 4), {"a": np.float32}),
    "builtin_min": (lambda T: lambda a: min(a[0, 0, 0], a[0, 0, 1]),
                    (4, 4), {"a": np.float32}),
    "output_shadows_input": (lambda T: lambda a: {"a": a[0, 0, 0] * 2.0},
                             (4, 4), {"a": np.float32}),
    "rank": (lambda T: lambda a: a[0, 0, 0] + 1.0, (2, 4, 4, 4),
             {"a": np.float32}),
    "two_offsets": (lambda T: lambda a: {"o": a[0, 1]}, (4, 4),
                    {"a": np.float32}),
    "not_traced_output": (lambda T: lambda a: {"o": 1.0}, (4, 4),
                          {"a": np.float32}),
    "empty_result": (lambda T: lambda a: {}, (4, 4), {"a": np.float32}),
    "string_operand": (lambda T: lambda a: {"o": a[0, 0, 0] + "x"}, (4, 4),
                       {"a": np.float32}),
}


def _raises(pkg_trace, case):
    fn, dims, inputs = ERRORS[case]
    with pytest.raises(Exception) as exc:
        pkg_trace.trace_program(fn(pkg_trace), dims, inputs)
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_trace_errors_match(case):
    want = _raises(rt, case)
    assert want[0] == "TraceError"
    assert _raises(pt, case) == want

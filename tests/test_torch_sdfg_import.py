"""The port's SDFG importer and map-nest desugaring against the JAX
package's, on the CPU.

``stencilflow_tpu_torch/frontend/{sdfg_import,mapnest}.py`` are copies
of the JAX package's modules.  ``sdfg_to_program`` runs in both
packages on the three fixtures of ``tests/fixtures/`` (with and without
``dimensions``, ``symbols`` and ``vectorization``) and on the SDFGs the
JAX package's tests build: the programs must give the same
``program_to_json`` text, compared in order, and the same oracle outputs
(np.array_equal), or both raise the same error class with the same
message.  ``mapnest.eval_sym`` and ``order_states`` are held to the
reference on the cases of ``tests/test_mapnest.py``, and a control-flow
loop is rejected alike.
"""
import copy
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu.frontend.mapnest as rm
import stencilflow_tpu.frontend.sdfg_import as rs
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.frontend.mapnest as pm
import stencilflow_tpu_torch.frontend.sdfg_import as ps
from stencilflow_tpu_torch.examples.sdfg_roundtrip import build_sdfg
from test_mapnest import _map_sdfg
from test_sdfg_import import _cosmoish_sdfg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
SYMBOLS = {"hdiff": {"lapweight": 2.0},
           "hdiff_mapnest": {"I": 4},
           "hdiff_mapnest_dace": {"I": 4, "J": 16, "K": 16}}
OPTIONS = {
    "plain": {},
    "dimensions": {"dimensions": (4, 16, 16)},
    "symbols": "symbols",
    "vectorization": {"vectorization": 2, "input_data": "random:0,1"},
    "everything": {"dimensions": (8, 16, 32), "vectorization": 4,
                   "symbols": "symbols", "name": "renamed"},
}


def _outcome(pkg, importer, source, **kw):
    """("ok", JSON text, oracle outputs) of an import, or ("error",
    class name, message)."""
    try:
        program = importer.sdfg_to_program(copy.deepcopy(source), **kw)
    except Exception as exc:   # compared between the packages below
        return ("error", type(exc).__name__, str(exc))
    text = json.dumps(pkg.program_to_json(program), default=str)
    out = pkg.run_interpreter(program,
                              pkg.load_input_arrays(program, seed=2))
    return ("ok", text, {k: np.asarray(v) for k, v in out.items()})


def _same(source, **kw):
    want = _outcome(ref, rs, source, **kw)
    got = _outcome(port, ps, source, **kw)
    assert got[:2] == want[:2]
    if want[0] == "error":
        assert got[2] == want[2]
        return want
    assert list(got[2]) == list(want[2])
    for o in want[2]:
        assert np.array_equal(got[2][o], want[2][o], equal_nan=True), o
    return want


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("fixture", sorted(SYMBOLS))
def test_fixture_import_matches(fixture, option):
    kw = OPTIONS[option]
    if kw == "symbols":
        kw = {"symbols": SYMBOLS[fixture]}
    elif "symbols" in kw:
        kw = dict(kw, symbols=SYMBOLS[fixture])
    path = os.path.join(FIXTURES, f"{fixture}.sdfg")
    assert _same(path, **kw)[0] == "ok"
    with open(path) as f:   # a dict imports as the file does
        _same(json.load(f), **kw)


def _undecidable():
    sdfg = _map_sdfg(rng_j=(0, 7), rng_k=(0, 7))
    sdfg["nodes"].append({"type": "SDFGState", "id": 1, "nodes": [],
                          "edges": []})
    sdfg["edges"] = [{"type": "Edge", "src": "0", "dst": "1",
                      "attributes": {"data": {"attributes": {
                          "condition": {"string_data": "mystery > 0"}}}}}]
    return sdfg


def _loop():
    sdfg = _cosmoish_sdfg()
    sdfg["edges"] = [{"src": "0", "dst": "1"}, {"src": "1", "dst": "2"},
                     {"src": "2", "dst": "1"}]   # back edge 2 -> 1
    return sdfg


def _forward_edges():
    sdfg = _cosmoish_sdfg()
    sdfg["edges"] = [{"src": "0", "dst": "1"}, {"src": "1", "dst": "2"}]
    return sdfg


def _nested_loop():
    """A back edge inside a nested SDFG's state machine."""
    sdfg = _cosmoish_sdfg()
    inner = sdfg["nodes"][1]["nodes"][0]["attributes"]["sdfg"]
    inner["nodes"].append({"type": "SDFGState", "nodes": []})
    inner["edges"] = [{"src": "0", "dst": "1"}, {"src": "1", "dst": "0"}]
    return sdfg


SDFGS = {
    # tests/test_sdfg_import.py and tests/test_mapnest.py
    "cosmoish": (_cosmoish_sdfg, {}),
    "cosmoish_dims": (_cosmoish_sdfg, {"dimensions": [4, 8, 16]}),
    "interior_map": (lambda: _map_sdfg((1, 6), (1, 6)),
                     {"input_data": "random:0.0,1.0"}),
    "full_map": (lambda: _map_sdfg((0, 7), (0, 7)), {}),
    "interior_end": (lambda: _map_sdfg((0, 5), (0, 7)), {}),
    "non_affine": (lambda: _map_sdfg(
        (0, 7), (0, 7), subsets={"__a_q": "i, j * 2, k"},
        code="__o = __a_q"), {}),
    "undecidable": (_undecidable, {}),
    "undecidable_specialized": (_undecidable, {"symbols": {"mystery": 1}}),
    "state_loop": (_loop, {}),
    "nested_state_loop": (_nested_loop, {}),
    "forward_edges": (_forward_edges, {}),
    "empty": (lambda: {"type": "SDFG", "attributes": {}, "nodes": []}, {}),
    # the sdfg_roundtrip example's SDFG
    "roundtrip": (lambda: build_sdfg([4, 8, 8]),
                  {"input_data": "random:-1,1"}),
}


@pytest.mark.parametrize("case", sorted(SDFGS))
def test_sdfg_import_matches(case):
    build, kw = SDFGS[case]
    _same(build(), **kw)


def test_state_loop_rejected():
    for importer in (rs, ps):
        with pytest.raises(ValueError, match="control-flow loop"):
            importer.sdfg_to_program(_loop())
        assert importer._has_state_loop(_nested_loop())
        assert not importer._has_state_loop(_forward_edges())


EVAL = [("2 * N + 1", {"N": 4}), ("N > 3 and N < 8", {"N": 4}),
        ("not (N == 4) or N // 3 == 1", {"N": 4}), ("-N ** 2 % 5", {"N": 3}),
        ("I / 2", {"I": 7}), ("", {}), (7, {}), ("True", {}),
        ("N >= 2 and N != 2", {"N": 2}), ("Q + 1", {}), ("N < 2 < 3", {"N": 1}),
        ("f(N)", {"N": 1})]


@pytest.mark.parametrize("expr,env", EVAL, ids=str)
def test_eval_sym_matches(expr, env):
    def run(mod):
        try:
            return ("ok", mod.eval_sym(expr, dict(env)))
        except ValueError as exc:
            return ("error", str(exc))
    want = run(rm)
    got = run(pm)
    assert got == want and type(got[1]) is type(want[1])


def test_order_states_matches():
    """Assignments fold along the walk, false branches prune, each state
    sees only the assignments on its path (tests/test_mapnest.py)."""
    sdfg = {"nodes": [{"id": 0, "label": "a"}, {"id": 1, "label": "b"},
                      {"id": 2, "label": "c"}, {"id": 3, "label": "d"}],
            "edges": [
                {"src": "0", "dst": "1", "attributes": {"data": {
                    "attributes": {"assignments": {"x": "3"}}}}},
                {"src": "0", "dst": "2", "attributes": {"data": {
                    "attributes": {"condition": {
                        "string_data": "1 > 2"}}}}},
                {"src": "1", "dst": "3", "attributes": {"data": {
                    "attributes": {"condition": {"string_data": "x == 3"},
                                   "assignments": {"y": "x * 2"}}}}},
            ], "start_state": 0}
    got = {}
    for mod in (rm, pm):
        env = {"seed": 1}
        order = mod.order_states(copy.deepcopy(sdfg), env)
        got[mod.__name__] = ([(s["label"], e) for s, e in order], env)
    want = got["stencilflow_tpu.frontend.mapnest"]
    assert got["stencilflow_tpu_torch.frontend.mapnest"] == want
    assert [label for label, _ in want[0]] == ["a", "b", "d"]
    assert want[1] == {"seed": 1, "x": 3, "y": 6}

"""COSMO-style ingestion walkthrough: SDFG file -> dialect -> gradient.

The reference imports weather-model SDFGs (DaCe programs with repeated
field writes) into its JSON dialect and runs them on FPGAs.  This
example round-trips the same path:

1. a serialized DaCe SDFG (JSON on disk, Stencil library nodes across
   nested states, the diffusion field written twice) is imported WITHOUT
   a dace dependency (``sdfg_to_program`` — SSA-versioning the repeated
   writes, reference sdfg_to_stencilflow.py:590-632);
2. the program is verified against the oracle on the stream lowering;
3. because the chain is affine, its exact adjoint is built as another
   dialect program and checked against autodiff.

Port of ``examples/sdfg_roundtrip.py``: the stream kernel on ``device``
for the program and its adjoint, and torch autograd through the port's
plain lowering (``backend.dense``) in the place of ``jax.grad``.

    python -m stencilflow_tpu_torch.examples.sdfg_roundtrip [--device cpu]
"""
import json
import os
import tempfile

import numpy as np
import torch

import stencilflow_tpu_torch as sft
from stencilflow_tpu_torch.frontend.sdfg_import import sdfg_to_program

SHAPE = [8, 32, 32]
FULL = [True, True, True]


def stencil_node(label, accesses, out, bcs, code, shape=SHAPE):
    return {"type": "LibraryNode",
            "classpath": "stencilflow.stencil.stencil.Stencil",
            "attributes": {"label": label, "shape": list(shape),
                           "accesses": accesses,
                           "output_fields": {out: None},
                           "boundary_conditions": bcs,
                           "code": {"string_data": code,
                                    "language": "Python"}}}


def build_sdfg(shape=SHAPE):
    lap = stencil_node(
        "lap",
        {"u": [FULL, [[0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
                      [0, 0, 0]]]},
        "lap", {"u": {"btype": "constant", "value": 0.0}},
        "lap = u[0,-1,0] + u[0,1,0] + u[0,0,-1] + u[0,0,1] "
        "- 4.0*u[0,0,0]", shape)
    step1 = stencil_node(
        "d_step1",
        {"u": [FULL, [[0, 0, 0]]], "lap": [FULL, [[0, 0, 0]]]},
        "d", {"u": {"btype": "constant", "value": 0.0},
              "lap": {"btype": "constant", "value": 0.0}},
        "d = u[0,0,0] + 0.12 * lap[0,0,0]", shape)
    step2 = stencil_node(   # writes d AGAIN: SSA-versioned on import
        "d_step2",
        {"d": [FULL, [[0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
                      [0, 0, 0]]]},
        "d", {"d": {"btype": "constant", "value": 0.0}},
        "d = d[0,0,0] + 0.12 * (d[0,-1,0] + d[0,1,0] + d[0,0,-1] "
        "+ d[0,0,1] - 4.0*d[0,0,0])", shape)
    return {"type": "SDFG",
            "attributes": {"name": "cosmo_diffusion", "_arrays": {
                "u": {"attributes": {"dtype": "float32",
                                     "shape": list(shape)}}}},
            "nodes": [
                {"type": "SDFGState", "nodes": [lap]},
                {"type": "SDFGState", "nodes": [
                    {"type": "NestedSDFG", "attributes": {"sdfg": {
                        "type": "SDFG", "attributes": {},
                        "nodes": [{"type": "SDFGState",
                                   "nodes": [step1]}]}}}]},
                {"type": "SDFGState", "nodes": [step2]},
            ]}


def main(device="cuda", shape=SHAPE):
    from stencilflow_tpu_torch.backend import compile_chain_stream
    from stencilflow_tpu_torch.backend.dense import compile_chain

    with tempfile.NamedTemporaryFile("w", suffix=".sdfg",
                                     delete=False) as f:
        json.dump(build_sdfg(shape), f)
        path = f.name

    program = sdfg_to_program(path, input_data="random:-1,1")
    print(f"imported {program.name}: kernels {list(program.kernels)}, "
          f"outputs {program.outputs}")
    assert list(program.kernels) == ["lap", "d__1", "d"]

    inputs = sft.load_input_arrays(program, seed=0)
    oracle = sft.run_interpreter(program, inputs)

    got = compile_chain_stream(program, device=device)(inputs)
    err = float(np.max(np.abs(got["d"].cpu().numpy()
                              - np.asarray(oracle["d"]))))
    print(f"stream lowering vs oracle: max |diff| = {err:.2e}")
    assert err < 1e-5

    # exact adjoint as a dialect program, checked against autodiff
    adj, cot = sft.adjoint_program(program)
    g_fast = compile_chain_stream(adj, device=device)(
        sft.load_input_arrays(adj))["adj_u"].cpu().numpy()
    fn = compile_chain(program)
    u = torch.as_tensor(inputs["u"]).requires_grad_()
    g_ad, = torch.autograd.grad(fn({"u": u})["d"].sum(), u)
    g_ad = g_ad.numpy()
    gerr = float(np.max(np.abs(g_fast.reshape(g_ad.shape) - g_ad)))
    print(f"adjoint program vs torch autograd: max |diff| = {gerr:.2e}")
    assert gerr < 1e-5
    print("OK")
    os.unlink(path)
    return ["stream"]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

"""float16 chains on the ``dense`` lowering against the numpy oracle.

The whole-domain lowering ``dense`` (torch's elementwise ops over the
domain; the generated kernels' float16 path is tests/test_torch_narrow.py's)
on float16 programs.  numpy computes each float16 op
in float32 and rounds the result to float16, and so do torch's float16
ops on the CPU and on the card (their ``opmath`` type is float32), one
op at a time: ``dense`` must equal the port's oracle, and the JAX
package's, bit for bit (np.array_equal) on box, cross and jacobi chains
of 4 stages at 12^3.  The card leg is
``tests/test_torch_cuda.py::test_float16_dense_matches_oracle_on_card``.
"""
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import choose_backend
from stencilflow_tpu_torch.backend.dense import compile_chain
from stencilflow_tpu_torch.synthesize import synthesize_stencil

# name: (shape, extent)
CHAINS = {"box": ("box", 1), "cross": ("cross", 2), "jacobi": ("diffusion",
                                                                1)}


def float16_chain(name):
    shape, extent = CHAINS[name]
    return synthesize_stencil(num_stages=4, dimensions=(12, 12, 12),
                              shape=shape, extent=extent,
                              data_type="float16",
                              seed_data="random:0.0,1.0")


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_float16_dense_matches_oracle(name):
    spec = float16_chain(name)
    p = port.parse_program(spec)
    an = port.ChainAnalysis.run(p)
    assert choose_backend(p, an, "cpu") == "dense"
    inputs = port.load_input_arrays(p, seed=11)
    got = compile_chain(p)({k: torch.as_tensor(np.asarray(v))
                            for k, v in inputs.items()})
    want = port.run_interpreter(p, inputs)
    jax_want = ref.run_interpreter(ref.parse_program(spec), inputs)
    for o in want:
        g = got[o].numpy().reshape(want[o].shape)
        assert g.dtype == want[o].dtype == np.float16
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, want[o])
        np.testing.assert_array_equal(g, np.asarray(jax_want[o]))

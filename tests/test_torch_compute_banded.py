"""The stream kernel's banded stages (K3b) under a compute type, against
the JAX package's own two routes on box3d r2 at 10 x 12 x 16: its banded
run (``mxu="auto"``, both stages banded) and its per-cell run
(``mxu="off"``), each in a subprocess of its own, all at once, as
tests/test_torch_compute_types.py computes its references (interpret
mode, 32-bit mode, per-op rounding, no FMA).  Under int32 compute the
two JAX runs disagree, so the port keeps integer stages per cell and
equals the per-cell run (ROADMAP Queue 3); under bool they agree on this
chain; under float16 the port bands as the JAX package does (bf16's
banded route is held in tests/test_torch_compute_dtype.py).
"""
import json

import numpy as np
import pytest

import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.backend import stream
from stencilflow_tpu_torch.synthesize import synthesize_stencil
from test_torch_compute_types import run_jax_parts

SEED = 61
TYPES = ("int32", "bool", "float16")


def _box_spec():
    return synthesize_stencil(
        num_stages=2, dimensions=(10, 12, 16), shape="box", extent=2,
        seed_data="random:-1000,1000", boundary="constant",
        boundary_value=0.3)


_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import stencilflow_tpu as ref
from stencilflow_tpu.backend.stream import compile_chain_stream
spec, cd, mxu = json.load(open(sys.argv[1]))
box = ref.parse_program(spec)
inputs = ref.load_input_arrays(box, seed=%d)
fn = compile_chain_stream(box, interpret=True, compute_dtype=cd, mxu=mxu)
got = fn({k: jnp.asarray(v) for k, v in inputs.items()})
np.savez(sys.argv[2], out=np.asarray(got[box.outputs[0]]))
cfg = compile_chain_stream.last_config
json.dump(sorted(cfg["mxu_stages"]) + sorted(cfg["composed"]),
          open(sys.argv[3], "w"))
""" % SEED


@pytest.fixture(scope="module")
def jax_box(tmp_path_factory):
    """(outputs, banded stages) of both JAX routes under each type, one
    subprocess a run, all at once."""
    runs = [(cd, mxu) for cd in TYPES for mxu in ("auto", "off")]
    dirs = run_jax_parts(_JAX_SCRIPT, [[_box_spec(), cd, mxu]
                                      for cd, mxu in runs],
                         tmp_path_factory.mktemp("jax_box"))
    return ({f"{cd}/{mxu}": np.load(sub / "out.npz")["out"]
             for (cd, mxu), sub in zip(runs, dirs)},
            {f"{cd}/{mxu}": json.loads((sub / "info.json").read_text())
             for (cd, mxu), sub in zip(runs, dirs)})


@pytest.mark.parametrize("cd", TYPES)
def test_jax_banded_box_against_its_per_cell_run(cd, jax_box):
    """Under int32 the JAX package's banded run leaves 13 % of the cells
    one apart from its per-cell run (a float sum truncated): the port
    keeps the stages per cell and equals the per-cell run bit for bit.
    Under bool the two agree (positive weights: the float sum is nonzero
    where the or is true) and the port's per-cell stages equal both.
    Under float16 the banded run is 3.4e-3 of the largest output from
    the per-cell run, past MXU_VERIFY_RTOL (each per-cell op rounds); the
    port bands as the JAX package does and holds to its banded run by
    ``stream.bf16_compute_agree``'s banded rule."""
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    refs, stages = jax_box
    assert stages[f"{cd}/auto"] == ["s0", "s1"] and not stages[f"{cd}/off"]
    banded, off = refs[f"{cd}/auto"], refs[f"{cd}/off"]
    d = np.abs(banded.astype(np.float64) - off)
    p = port.parse_program(_box_spec())
    fn = stream.compile_chain_stream(p, device="cpu", compute_dtype=cd)
    got = fn(port.load_input_arrays(p, seed=SEED))[p.outputs[0]].numpy()
    got = got.reshape(off.shape)
    if cd == "int32":
        assert 0.8 < np.mean(d == 0) < 0.9 and d.max() == 1
    elif cd == "bool":
        np.testing.assert_array_equal(banded, off)
    else:
        assert d.max() > MXU_VERIFY_RTOL * np.abs(off).max()
    if cd in ("int32", "bool"):
        assert not fn.plan.mxu_plans
        np.testing.assert_array_equal(got, off)
    else:
        assert fn.plan.mxu_plans
        ok, fig = stream.bf16_compute_agree(banded, got, banded=True)
        assert ok, fig


def test_integer_and_bool_compute_keep_stages_per_cell():
    """The plan: banded under bf16 and f16 compute, every stage per cell
    under int32 and bool compute, composition included."""
    p = port.parse_program(_box_spec())
    for cd in ("bfloat16", "float16"):
        assert stream.plan_stream(p, compute_dtype=cd).mxu_plans
    for cd in ("int32", "bool"):
        plan = stream.plan_stream(p, compute_dtype=cd, compose="auto")
        assert not plan.mxu_plans and not plan.composed

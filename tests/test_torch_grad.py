"""The port's adjoints and gradients (grad.py) against the JAX package's,
on the CPU.

``adjoint_program`` builds the reference's program (``program_to_json``
compared as JSON) on every example and fuzz program it accepts, and
refuses the others with the reference's message.  ``value_and_grad`` and
``grad`` (torch.autograd through the dense lowering) match JAX's
autodiff within ``VERIFY_RTOL``, including a ``max``/``min`` tie,
``abs`` at 0 and a ternary (the subgradient conventions), the nonlinear
hdiff program and a gradient of a gradient.  ``fast_value_and_grad``
(the chain and its adjoint through ``compile_chain_best``: the kernels'
plain versions here) equals the oracle of the adjoint program on the
same cotangent bit for bit (the per-cell class) and the reference
within ``VERIFY_RTOL``, in core and out of core.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu_torch.config import VERIFY_RTOL
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_fuzz import _affine_program, make_random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in
            sorted(os.listdir(os.path.join(ROOT, "examples")))
            if f.endswith(".json")]


def _both(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                  name=name)


def _as_json(program_to_json, program) -> str:
    return json.dumps(program_to_json(program), sort_keys=True, default=str)


def _same_adjoint(a, b, wrt=None):
    """Both packages' adjoint programs as JSON, or both refusals' text."""
    try:
        want_adj, want_cot = ref.adjoint_program(a, wrt)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port.adjoint_program(b, wrt)
        assert str(got.value) == str(exc)
        return False
    got_adj, got_cot = port.adjoint_program(b, wrt)
    assert got_cot == want_cot
    assert _as_json(port.program_to_json, got_adj) == \
        _as_json(ref.program_to_json, want_adj)
    return True


def _jnp(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _oracle_adjoint(program, ct):
    """The oracle of the adjoint program on cotangents ``ct``
    ({output: array}); returns ``{adj_<input>: array}``."""
    adj, cot = port.adjoint_program(program)
    inputs = port.load_input_arrays(adj)
    inputs.update({cot[o]: np.asarray(v).reshape(tuple(adj.dimensions))
                   for o, v in ct.items()})
    return port.run_interpreter(adj, inputs)


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_adjoint_program_matches_reference_on_examples(path):
    _same_adjoint(ref.parse_program(path), port.parse_program(path))


@pytest.mark.parametrize("seed", range(6))
def test_adjoint_program_matches_reference_on_fuzz(seed):
    spec = make_random_program(np.random.default_rng(seed), seed)
    _same_adjoint(*_both(spec, f"fz{seed}"))


@pytest.mark.parametrize("seed", range(3))
def test_adjoint_program_matches_reference_on_affine_fuzz(seed):
    rng = np.random.default_rng(4000 + seed)
    spec = _affine_program(rng, int(rng.integers(2, 4)))
    assert _same_adjoint(*_both(spec, f"af{seed}"))


@pytest.mark.parametrize("nd,iters", [(3, 2), (2, 3)])
def test_adjoint_program_copy_bc_matches_reference(nd, iters):
    """Copy BCs add the same 1-D out-of-bounds indicator inputs."""
    a, b = _both(jacobi(nd, 10, iterations=iters, boundary="copy"), "cb")
    assert _same_adjoint(a, b)
    adj, _cot = port.adjoint_program(b)
    assert any(s.dim_mask.count(True) == 1 for s in adj.inputs.values())


def test_value_and_grad_custom_loss_and_wrt():
    spec = synthesize_stencil(num_stages=2, dimensions=(6, 10, 10),
                              shape="hotspot")
    a, b = _both(spec, "g2")
    inputs = ref.load_input_arrays(a, seed=1)
    out = a.outputs[0]
    rv, rg = ref.value_and_grad(a, loss=lambda o: (o[out] ** 2).sum(),
                                wrt=["a", "power"])(_jnp(inputs))
    pv, pg = port.value_and_grad(b, loss=lambda o: (o[out] ** 2).sum(),
                                 wrt=["a", "power"], device="cpu")(inputs)
    assert set(pg) == {"a", "power"}
    np.testing.assert_allclose(float(pv), float(rv), rtol=VERIFY_RTOL)
    for n in pg:
        np.testing.assert_allclose(pg[n].numpy(), np.asarray(rg[n]),
                                   rtol=VERIFY_RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="not program inputs"):
        port.value_and_grad(b, wrt=["nope"], device="cpu")


def test_value_and_grad_nonlinear_hdiff():
    """hdiff's flux limiters (min/max, ternaries): the reference's
    subgradients, and a few descent steps reduce the loss."""
    a, b = _both(synthesize_stencil(num_stages=1, dimensions=(4, 12, 12),
                                    shape="hdiff"), "g3")
    inputs = ref.load_input_arrays(a, seed=2)
    out = a.outputs[0]
    rv, rg = ref.value_and_grad(a, loss=lambda o: (o[out] ** 2).sum(),
                                wrt=["a"])(_jnp(inputs))
    f = port.value_and_grad(b, loss=lambda o: (o[out] ** 2).sum(),
                            wrt=["a"], device="cpu")
    pv, pg = f(inputs)
    np.testing.assert_allclose(float(pv), float(rv), rtol=VERIFY_RTOL)
    np.testing.assert_allclose(pg["a"].numpy(), np.asarray(rg["a"]),
                               rtol=VERIFY_RTOL, atol=1e-5)
    x = torch.as_tensor(inputs["a"])
    losses = []
    for _ in range(5):
        val, grads = f({**inputs, "a": x})
        losses.append(float(val))
        x = x - 0.5 * grads["a"]
    assert losses[-1] < losses[0]


def test_value_and_grad_subgradient_conventions():
    """At a max/min tie the gradient splits in halves, abs has gradient 1
    at 0 (JAX's ``select(x >= 0, g, -g)``), a ternary sends it down the
    branch it took: exactly JAX's."""
    rng = np.random.default_rng(9)
    x = rng.integers(-2, 3, (4, 6, 6)).astype(np.float32)
    y = rng.integers(-2, 3, (4, 6, 6)).astype(np.float32)
    assert (x == y).any() and (x == 0).any()
    bc = {f: {"type": "constant", "value": 0.0} for f in ("x", "y")}
    spec = {"inputs": {"x": {"data": x, "data_type": "float32"},
                       "y": {"data": y, "data_type": "float32"}},
            "outputs": ["r"], "dimensions": [4, 6, 6],
            "program": {"r": {
                "computation_string":
                    "r = max(x[i,j,k], y[i,j,k]) + 2.0 * min(x[i,j+1,k], "
                    "y[i,j,k]) + 3.0 * abs(x[i,j,k]) + (x[i,j,k-1] if "
                    "y[i,j,k] > 0.0 else 5.0 * y[i,j,k])",
                "boundary_conditions": bc, "data_type": "float32"}}}
    a, b = _both(spec, "sub")
    inputs = {"x": x, "y": y}
    rv, rg = ref.value_and_grad(a)(_jnp(inputs))
    pv, pg = port.value_and_grad(b, device="cpu")(inputs)
    assert float(pv) == float(rv)
    for n in ("x", "y"):
        np.testing.assert_array_equal(pg[n].numpy(), np.asarray(rg[n]))


def test_default_wrt_skips_integer_inputs():
    a_data = np.random.default_rng(0).random((4, 8, 8)).astype(np.float32)
    spec = {"inputs": {"a": {"data": a_data, "data_type": "float32"},
                       "m": {"data": np.ones((4, 8, 8), np.int32),
                             "data_type": "int32"}},
            "outputs": ["r"], "dimensions": [4, 8, 8],
            "program": {"r": {
                "computation_string": "r = a[i,j,k] if m[i,j,k] > 0 "
                                      "else 0.0",
                "boundary_conditions": {
                    "a": {"type": "constant", "value": 0.0},
                    "m": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}}}
    _a, b = _both(spec, "g6")
    _val, grads = port.value_and_grad(b, device="cpu")(
        port.load_input_arrays(b))
    assert set(grads) == {"a"}


def test_higher_order():
    """grad-of-grad: the returned grads keep their graph when the input
    requires grad; JAX's second derivative within VERIFY_RTOL."""
    a, b = _both(jacobi(2, 8, iterations=2), "g4")
    x0 = ref.load_input_arrays(a, seed=3)["a"]
    out = a.outputs[0]

    def loss(o):
        return (o[out] ** 2).sum()

    g_ref = ref.grad(a, loss=loss)
    h_ref = jax.grad(lambda x: (g_ref({"a": x})["a"] ** 2).sum())(
        jnp.asarray(x0))
    g_port = port.grad(b, loss=loss, device="cpu")
    x = torch.as_tensor(x0).requires_grad_()
    (h_port,) = torch.autograd.grad((g_port({"a": x})["a"] ** 2).sum(), x)
    assert np.isfinite(h_port.numpy()).all()
    np.testing.assert_allclose(h_port.numpy(), np.asarray(h_ref),
                               rtol=VERIFY_RTOL, atol=1e-4)


@pytest.mark.parametrize("boundary", ["constant", "copy"])
def test_fast_value_and_grad(boundary):
    """Sum loss: the gradient is the oracle of the adjoint program on a
    cotangent of ones, bit for bit; the reference's within VERIFY_RTOL."""
    a, b = _both(jacobi(3, 8, iterations=3, boundary=boundary), "fv")
    inputs = ref.load_input_arrays(a, seed=1)
    f = port.fast_value_and_grad(b, device="cpu")
    assert f.lowering == {"forward": "dense", "adjoint": "dense"}
    val, grads = f(inputs)
    out = b.outputs[0]
    want = _oracle_adjoint(b, {out: np.ones(b.raw_dimensions, np.float32)})
    np.testing.assert_array_equal(grads["a"].numpy(),
                                  want["adj_a"].reshape(8, 8, 8))
    rv, rg = ref.fast_value_and_grad(a, interpret=True)(_jnp(inputs))
    np.testing.assert_allclose(float(val), float(rv), rtol=VERIFY_RTOL)
    np.testing.assert_allclose(grads["a"].numpy(), np.asarray(rg["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)


def test_fast_value_and_grad_random_cotangent():
    """A weighted loss: the cotangent is the weight; bit for bit with the
    adjoint's oracle on it, and autodiff within VERIFY_RTOL."""
    rng = np.random.default_rng(4001)
    spec = _affine_program(rng, 3)
    _a, b = _both(spec, "rc")
    out = b.outputs[0]
    w = rng.random(tuple(b.raw_dimensions)).astype(np.float32)
    tw = torch.as_tensor(w)

    def loss(o):
        return (o[out] * tw).sum()

    inputs = port.load_input_arrays(b, seed=0)
    _val, grads = port.fast_value_and_grad(b, loss=loss, wrt=["a"],
                                           device="cpu")(inputs)
    want = _oracle_adjoint(b, {out: w})
    np.testing.assert_array_equal(
        grads["a"].numpy(), want["adj_a"].reshape(grads["a"].shape))
    _v2, g2 = port.value_and_grad(b, loss=loss, wrt=["a"],
                                  device="cpu")(inputs)
    np.testing.assert_allclose(grads["a"].numpy(), g2["a"].numpy(),
                               rtol=VERIFY_RTOL, atol=1e-5)


def test_fast_value_and_grad_composes_with_autograd():
    """``f.function`` is the chain as a torch.autograd.Function: its
    backward is the compiled adjoint, inside a larger graph."""
    _a, b = _both(jacobi(3, 8, iterations=2), "fn")
    f = port.fast_value_and_grad(b, device="cpu")
    x = torch.as_tensor(port.load_input_arrays(b, seed=2)["a"])
    x.requires_grad_()
    (y,) = f.function.apply({}, 2.0 * x)
    (g,) = torch.autograd.grad(y.sum(), x)
    _v, want = f({"a": x.detach()})
    np.testing.assert_array_equal(g.numpy(), 2.0 * want["a"].numpy())


@pytest.mark.parametrize("boundary", ["constant", "copy"])
def test_fast_value_and_grad_host_chunks(boundary):
    """Out of core: the in-core gradient bit for bit, the reference's
    chunked gradient within VERIFY_RTOL."""
    a, b = _both(jacobi(3, 8, iterations=2, boundary=boundary), "fc")
    inputs = ref.load_input_arrays(a, seed=3)
    val, grads = port.fast_value_and_grad(b, host_chunks=2,
                                          device="cpu")(inputs)
    v_in, g_in = port.fast_value_and_grad(b, device="cpu")(inputs)
    np.testing.assert_array_equal(grads["a"], g_in["a"].numpy())
    np.testing.assert_allclose(val, float(v_in), rtol=VERIFY_RTOL)
    rv, rg = ref.fast_value_and_grad(a, host_chunks=2,
                                     interpret=True)(inputs)
    np.testing.assert_allclose(grads["a"], np.asarray(rg["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)


def test_rejections():
    """The reference's error types and messages."""
    a, b = _both(jacobi(3, 8, iterations=2, boundary="shrink"), "sh")
    with pytest.raises(ValueError, match="shrink"):
        port.adjoint_program(b)
    a, b = _both(synthesize_stencil(num_stages=1, dimensions=(4, 8, 8),
                                    shape="hdiff"), "nl")
    with pytest.raises(ValueError, match="not affine"):
        port.fast_value_and_grad(b, device="cpu")
    _a, b = _both(jacobi(2, 8, iterations=1), "wr")
    with pytest.raises(ValueError, match="not a program input"):
        port.adjoint_program(b, wrt=["zzz"])
    with pytest.raises(ValueError, match="mesh requires dim_axes"):
        port.value_and_grad(b, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh requires dim_axes"):
        port.fast_value_and_grad(b, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="incompatible with mesh"):
        port.fast_value_and_grad(b, mesh=object(), host_chunks=2)


def test_cli_adjoint(tmp_path, capsys):
    """The subcommand writes the reference's JSON and prints its line."""
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(3, 8, iterations=2, boundary="copy"),
                               default=str))
    assert ref_main(["adjoint", str(path), "-o",
                     str(tmp_path / "ref.json")]) == 0
    want = capsys.readouterr().out
    assert main(["adjoint", str(path), "-o",
                 str(tmp_path / "mine.json")]) == 0
    got = capsys.readouterr().out
    assert got == want.replace("ref.json", "mine.json")
    assert json.load(open(tmp_path / "mine.json")) == \
        json.load(open(tmp_path / "ref.json"))


@pytest.mark.parametrize("boundary,shape,names,axes", [
    ("constant", (2, 2), ("x", "y"), (None, "x", "y")),
    ("copy", (2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))])
def test_grads_on_a_mesh(boundary, shape, names, axes):
    """value_and_grad and fast_value_and_grad over a CPU mesh of virtual
    shards: the fast gradient bit for bit with the single-device one,
    the autograd one within VERIFY_RTOL of it (autograd sums the halo
    slabs' contributions in another order), both within VERIFY_RTOL of
    the JAX package's fast_value_and_grad(mesh=)."""
    from jax.sharding import Mesh as JaxMesh
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    a, b = _both(jacobi(3, 8, iterations=3, boundary=boundary), "gm")
    inputs = ref.load_input_arrays(a, seed=1)
    mesh = make_mesh(["cpu"], shape, names)
    v1, g1 = port.fast_value_and_grad(b, device="cpu")(inputs)
    f = port.fast_value_and_grad(b, mesh=mesh, dim_axes=axes)
    assert f.lowering == {"forward": "sharded[xla]",
                          "adjoint": "sharded[xla]"}
    assert f.plan.block == tuple(8 // n for n in (
        [1] * (3 - len(shape)) + list(shape)))
    v2, g2 = f(inputs)
    assert float(v2) == float(v1)
    np.testing.assert_array_equal(g2["a"].numpy(), g1["a"].numpy())
    v3, g3 = port.value_and_grad(b, mesh=mesh, dim_axes=axes)(inputs)
    np.testing.assert_allclose(float(v3), float(v1), rtol=VERIFY_RTOL)
    np.testing.assert_allclose(g3["a"].numpy(), g1["a"].numpy(),
                               rtol=VERIFY_RTOL, atol=1e-6)
    n = int(np.prod(shape))
    jmesh = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    rv, rg = ref.fast_value_and_grad(a, interpret=True, mesh=jmesh,
                                     dim_axes=axes)(_jnp(inputs))
    np.testing.assert_allclose(float(v2), float(rv), rtol=VERIFY_RTOL)
    np.testing.assert_allclose(g2["a"].numpy(), np.asarray(rg["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)

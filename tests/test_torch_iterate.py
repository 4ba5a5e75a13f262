"""The port's time-stepping (iterate.py) against the JAX package's,
on the CPU.

``compose_iterations`` builds the same program as the reference
(``program_to_json`` compared as JSON) on every example program it
accepts and on fuzz programs; ``iterate`` on the CPU (the kernels' plain
versions, the dense lowering) equals oracle stepping bit for bit and the
JAX package's ``iterate`` (``interpret=True``) within ``VERIFY_RTOL``,
through chunk and fuse splits, two-field feeds, ``host_chunks`` and a
resume from a checkpoint the JAX package wrote; the rejections raise the
reference's error types; the ``iterate`` subcommand writes the
reference's state.
"""
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.iterate import IterateError as RefIterateError
from stencilflow_tpu.iterate import iterate as ref_iterate
from stencilflow_tpu_torch.config import VERIFY_RTOL
from stencilflow_tpu_torch.iterate import IterateError
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
from test_fuzz import make_random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in
            sorted(os.listdir(os.path.join(ROOT, "examples")))
            if f.endswith(".json")]


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                  name=name)


def _as_json(program_to_json, program) -> str:
    return json.dumps(program_to_json(program), sort_keys=True, default=str)


def _oracle_steps(program, inputs, feed, steps):
    """Oracle stepping: the numpy interpreter, outputs fed back."""
    state = dict(inputs)
    for _ in range(steps):
        out = port.run_interpreter(program, state)
        state.update({k: np.asarray(out[o]) for k, o in feed.items()})
    return state


def _small(path, size=8):
    spec = json.load(open(path))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_compose_matches_reference_on_examples(path, n):
    """Exact: the same program as JSON, or the same refusal."""
    a, b = ref.parse_program(path), port.parse_program(path)
    try:
        want = _as_json(ref.program_to_json,
                        ref.compose_iterations(a, n))
    except RefIterateError as exc:
        with pytest.raises(IterateError, match="ambiguous feedback"):
            port.compose_iterations(b, n)
        assert "ambiguous feedback" in str(exc)
        return
    assert _as_json(port.program_to_json,
                    port.compose_iterations(b, n)) == want


@pytest.mark.parametrize("seed", range(6))
def test_compose_matches_reference_on_fuzz(seed):
    """Exact, with the first full-rank input fed by the first output."""
    spec = make_random_program(np.random.default_rng(seed), seed)
    a, b = _both(spec, f"fz{seed}")
    raw = tuple(a.raw_dimensions)
    full = [n for n, s in a.inputs.items()
            if not s.is_scalar and tuple(s.shape(a.dimensions)) == raw]
    feed = {full[0]: a.outputs[0]}
    assert _as_json(port.program_to_json,
                    port.compose_iterations(b, 3, feed)) == \
        _as_json(ref.program_to_json, ref.compose_iterations(a, 3, feed))


@pytest.mark.parametrize("dims,steps,chunk,fuse", [
    (2, 5, 16, 1), (2, 5, 2, 1), (2, 8, 3, 2), (3, 8, 1, 4)])
def test_iterate_matches_oracle_and_reference(dims, steps, chunk, fuse):
    """Bit for bit with oracle stepping; VERIFY_RTOL with the JAX
    package's iterate."""
    spec = jacobi(dims, 12 if dims == 2 else 8, iterations=1)
    a, b = _both(spec, f"it{dims}")
    inputs = ref.load_input_arrays(a, seed=3)
    got = port.iterate(b, inputs, steps, chunk=chunk, fuse=fuse,
                       device="cpu")
    want = _oracle_steps(b, inputs, {"a": b.outputs[0]}, steps)
    np.testing.assert_array_equal(got["a"], want["a"])
    theirs = ref_iterate(a, inputs, steps, chunk=chunk, fuse=fuse,
                         interpret=True)
    np.testing.assert_allclose(got["a"], np.asarray(theirs["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)


@pytest.mark.parametrize("fuse", [1, 2])
def test_wave_two_field_feed(fuse):
    """The wave example's leapfrog feed {p: pn, pm: pcur}."""
    wave = _load_example("wave_propagation")
    a = wave.build_program(n=16)
    b = port.parse_program(ref.program_to_json(a), name="wave2d")
    inputs = ref.load_input_arrays(a)
    got = port.iterate(b, inputs, 6, feed=wave.FEED, fuse=fuse, chunk=2,
                       device="cpu")
    want = _oracle_steps(b, inputs, wave.FEED, 6)
    theirs = ref_iterate(a, inputs, 6, feed=wave.FEED, fuse=fuse, chunk=2,
                         interpret=True)
    for k in wave.FEED:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got[k], np.asarray(theirs[k]),
                                   rtol=VERIFY_RTOL, atol=1e-6)


def test_gray_scott_two_field_feed():
    """Nonlinear two-field feed with copy BCs, fused by 4."""
    gs = _load_example("gray_scott")
    a = gs.build_program(n=16)
    b = port.parse_program(ref.program_to_json(a), name="gray_scott")
    inputs = ref.load_input_arrays(a)
    feed = {"u": "u1", "v": "v1"}
    got = port.iterate(b, inputs, 8, feed=feed, fuse=4, device="cpu")
    want = _oracle_steps(b, inputs, feed, 8)
    for k in feed:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fuse", [1, 2])
def test_host_chunks(fuse):
    """Out-of-core stepping equals in-core stepping bit for bit and the
    JAX package's out-of-core iterate within VERIFY_RTOL."""
    spec = jacobi(3, 8, iterations=1)
    a, b = _both(spec, "hc")
    inputs = ref.load_input_arrays(a, seed=5)
    got = port.iterate(b, inputs, 4, fuse=fuse, host_chunks=2,
                       device="cpu")
    incore = port.iterate(b, inputs, 4, fuse=fuse, device="cpu")
    np.testing.assert_array_equal(got["a"], incore["a"])
    theirs = ref_iterate(a, inputs, 4, fuse=fuse, host_chunks=2,
                         interpret=True)
    np.testing.assert_allclose(got["a"], np.asarray(theirs["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)


def test_checkpoint_and_resume(tmp_path):
    """The reference's files, keys and resume rule: the last checkpoint
    deleted, a resumed run continues from the one before and ignores the
    inputs it is given."""
    b = port.parse_program(jacobi(2, 12, iterations=1), name="ck")
    inputs = port.load_input_arrays(b, seed=2)
    ckpt = str(tmp_path / "ck")
    full = port.iterate(b, inputs, 6, chunk=2, checkpoint_every=2,
                        checkpoint_dir=ckpt, device="cpu")
    names = sorted(os.listdir(ckpt))
    assert names == ["step_2.npz", "step_4.npz", "step_6.npz"]
    with np.load(os.path.join(ckpt, "step_4.npz")) as data:
        assert set(data.files) == set(b.inputs)
    os.remove(os.path.join(ckpt, "step_6.npz"))
    junk = {k: np.zeros_like(v) for k, v in inputs.items()}
    resumed = port.iterate(b, junk, 6, chunk=2, checkpoint_every=2,
                           checkpoint_dir=ckpt, device="cpu")
    np.testing.assert_array_equal(full["a"], resumed["a"])


def test_resume_from_a_reference_checkpoint(tmp_path):
    """A checkpoint the JAX package's iterate wrote resumes here: the
    port continues from its state (bit for bit with oracle stepping from
    it) and ends within VERIFY_RTOL of the reference's full run."""
    a, b = _both(jacobi(2, 12, iterations=1), "rk")
    inputs = ref.load_input_arrays(a, seed=4)
    ckpt = str(tmp_path / "ck")
    ref_iterate(a, inputs, 4, checkpoint_every=4, checkpoint_dir=ckpt,
                interpret=True)
    with np.load(os.path.join(ckpt, "step_4.npz")) as data:
        mid = {k: data[k] for k in data.files}
    got = port.iterate(b, inputs, 8, checkpoint_every=4,
                       checkpoint_dir=ckpt, device="cpu")
    want = _oracle_steps(b, mid, {"a": b.outputs[0]}, 4)
    np.testing.assert_array_equal(got["a"], want["a"])
    theirs = ref_iterate(a, inputs, 8, interpret=True)
    np.testing.assert_allclose(got["a"], np.asarray(theirs["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)
    assert sorted(os.listdir(ckpt)) == ["step_4.npz", "step_8.npz"]


def test_make_step_routes_and_carries():
    """A step feeds the output back and carries every other input."""
    spec = synthesize_stencil(num_stages=2, dimensions=(6, 8, 8),
                              shape="hotspot")
    b = port.parse_program(spec, name="hs")
    inputs = port.load_input_arrays(b, seed=1)
    step, feed = port.make_step(b, {"a": b.outputs[0]}, device="cpu")
    assert step.backend == "dense"
    new = step(inputs)
    assert set(new) == set(inputs)
    assert new["power"] is inputs["power"]
    np.testing.assert_array_equal(
        np.asarray(new["a"]), port.run_interpreter(b, inputs)[b.outputs[0]])


def test_rejections():
    """The reference's error types and messages; orbax names its
    ROADMAP item."""
    p = port.parse_program(jacobi(2, 16, iterations=1), name="rj")
    inputs = port.load_input_arrays(p, seed=0)
    with pytest.raises(IterateError, match="chunk"):
        port.iterate(p, inputs, steps=4, chunk=0, device="cpu")
    p3 = port.parse_program(jacobi(3, 8, iterations=1), name="hcb")
    with pytest.raises(IterateError, match="out-of-core"):
        port.iterate(p3, port.load_input_arrays(p3), steps=2,
                     host_chunks=2, backend="pallas", device="cpu")
    with pytest.raises(IterateError, match="multiple of fuse"):
        port.iterate(p, inputs, steps=5, fuse=2, device="cpu")
    with pytest.raises(IterateError, match="fuse must be"):
        port.iterate(p, inputs, steps=4, fuse=0, device="cpu")
    with pytest.raises(IterateError, match="checkpoint_dir"):
        port.iterate(p, inputs, steps=4, checkpoint_every=2, device="cpu")
    with pytest.raises(IterateError, match="Queue 1 item 8"):
        port.iterate(p, inputs, steps=4, checkpoint_every=2,
                     checkpoint_dir="x", checkpoint_format="orbax",
                     device="cpu")
    with pytest.raises(IterateError, match="mesh requires dim_axes"):
        port.iterate(p, inputs, steps=2, mesh=object(), device="cpu")
    with pytest.raises(IterateError, match="incompatible with mesh"):
        port.iterate(p3, port.load_input_arrays(p3), steps=2,
                     host_chunks=2, mesh=object(), dim_axes=("x", None,
                                                              None))
    two = port.parse_program(ref.program_to_json(
        _load_example("wave_propagation").build_program(n=8)), name="w")
    with pytest.raises(IterateError, match="ambiguous"):
        port.make_step(two, device="cpu")
    with pytest.raises(IterateError, match="bad feed"):
        port.make_step(p, {"a": "nope"}, device="cpu")


def test_cli_iterate(tmp_path, capsys):
    """The subcommand's lines and state: the reference's a.dat within
    VERIFY_RTOL, the oracle's bit for bit."""
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(2, 8, iterations=1), default=str))
    assert ref_main(["iterate", str(path), "--steps", "3", "--output-dir",
                     str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert main(["iterate", str(path), "--steps", "3", "--output-dir",
                 str(tmp_path / "out"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want.replace(str(tmp_path / "ref"), str(tmp_path / "out"))
    mine = np.fromfile(tmp_path / "out" / "a.dat", np.float32)
    theirs = np.fromfile(tmp_path / "ref" / "a.dat", np.float32)
    np.testing.assert_allclose(mine, theirs, rtol=VERIFY_RTOL, atol=1e-6)
    b = port.parse_program(str(path))
    oracle = _oracle_steps(b, port.load_input_arrays(b), {"a": "s0"}, 3)
    np.testing.assert_array_equal(mine, oracle["a"].ravel())


def test_cli_iterate_refuses_orbax(tmp_path, capsys):
    from stencilflow_tpu_torch.cli import main
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(2, 8, iterations=1), default=str))
    assert main(["iterate", str(path), "--steps", "2",
                 "--checkpoint-format", "orbax", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "ROADMAP Queue 1 item 8" in err


def test_cli_parses_every_reference_iterate_argument():
    import argparse
    from stencilflow_tpu.cli import build_parser as ref_parser
    from stencilflow_tpu_torch.cli import build_parser

    def sub(parser, name):
        act = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return act.choices[name]

    for name, argv in (("iterate", ["p.json", "--steps", "2"]),
                       ("solve", ["p.json", "--rhs", "constant:1"]),
                       ("adjoint", ["p.json"])):
        theirs = {a.dest for a in sub(ref_parser(), name)._actions}
        mine = {a.dest for a in sub(build_parser(), name)._actions}
        assert theirs <= mine, (name, theirs - mine)
        build_parser().parse_args([name] + argv)


def test_solver_cells_gray_scott_is_the_example():
    """The full-width phase's Gray-Scott program is the example's, rebuilt
    without the JAX package (the same JSON, data included)."""
    from stencilflow_tpu_torch.solver_cells import GRAY_SCOTT_FEED, gray_scott
    gs = _load_example("gray_scott")
    assert _as_json(port.program_to_json, gray_scott(24)) == \
        _as_json(ref.program_to_json, gs.build_program(n=24))
    assert GRAY_SCOTT_FEED == {"u": "u1", "v": "v1"}


@pytest.mark.parametrize("shape,names,axes,fuse", [
    ((2, 2), ("x", "y"), (None, "x", "y"), 2),
    ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"), 1)])
def test_iterate_on_a_mesh(shape, names, axes, fuse, tmp_path):
    """The sharded step (CPU mesh of virtual shards): bit for bit with
    oracle stepping and the port's single-device iterate; within
    VERIFY_RTOL of the JAX package's iterate(mesh=) on its virtual CPU
    devices; npz checkpoints gathered under the reference's keys, and a
    resume from them."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    spec = jacobi(3, 8, iterations=1, boundary="copy")
    a, b = _both(spec, "itmesh")
    inputs = ref.load_input_arrays(a, seed=3)
    mesh = make_mesh(["cpu"], shape, names)
    stats = {}
    got = port.iterate(b, inputs, 4, fuse=fuse, mesh=mesh, dim_axes=axes,
                       checkpoint_every=2, checkpoint_dir=str(tmp_path),
                       stats=stats)
    assert stats["backend"] == "sharded[xla]"
    want = _oracle_steps(b, inputs, {"a": b.outputs[0]}, 4)
    np.testing.assert_array_equal(got["a"], want["a"])
    with np.load(tmp_path / "step_2.npz") as ck:
        assert set(ck.files) == set(inputs)
    resumed = port.iterate(b, inputs, 6, fuse=fuse, mesh=mesh,
                           dim_axes=axes, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path))
    np.testing.assert_array_equal(
        resumed["a"], port.iterate(b, inputs, 6, device="cpu")["a"])
    n = int(np.prod(shape))
    jmesh = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    theirs = ref_iterate(a, inputs, 4, fuse=fuse, interpret=True,
                         mesh=jmesh, dim_axes=axes)
    np.testing.assert_allclose(got["a"], np.asarray(theirs["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)

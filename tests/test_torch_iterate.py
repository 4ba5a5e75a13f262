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
reference's state.  ``checkpoint_format="orbax"`` writes a directory a
step in ``torch.distributed.checkpoint``'s format, one entry a shard,
and resumes bit for bit on one device, on a 2 x 2 mesh and across
layouts, skipping incomplete directories.
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
    """The reference's error types and messages."""
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
    with pytest.raises(IterateError, match="unknown checkpoint_format"):
        port.iterate(p, inputs, steps=4, checkpoint_every=2,
                     checkpoint_dir="x", checkpoint_format="zarr",
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


def _layout(name):
    """iterate's keywords for one state layout: one CPU device, or a mesh
    of virtual CPU shards."""
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    if name == "one device":
        return dict(device="cpu")
    if name == "2 x 2":
        return dict(mesh=make_mesh(["cpu"], (2, 2), ("x", "y")),
                    dim_axes=(None, "x", "y"))
    assert name == "4 shards of i"
    return dict(mesh=make_mesh(["cpu"], (4,), ("x",)),
                dim_axes=("x", None, None))


def _orbax_case(layout):
    """(program, inputs, iterate keywords) of the orbax tests: jacobi3d
    16^3 on one of ``_layout``'s layouts."""
    a, b = _both(jacobi(3, 16, iterations=1), "ock")
    return a, b, ref.load_input_arrays(a, seed=8), _layout(layout)


def _step_dirs(ckpt):
    return sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())


@pytest.mark.parametrize("layout", ["one device", "2 x 2"])
def test_orbax_checkpoint_and_resume(tmp_path, layout):
    """One directory a step (2, 4, 6); with the newest removed, a resume
    equal to the uninterrupted run bit for bit, and to the JAX package's
    iterate at the same steps within VERIFY_RTOL."""
    import shutil
    a, b, inputs, kw = _orbax_case(layout)
    ckpt = str(tmp_path / "ock")
    ck = dict(steps=6, chunk=2, checkpoint_every=2, checkpoint_dir=ckpt,
              checkpoint_format="orbax", **kw)
    stats = {}
    full = port.iterate(b, inputs, stats=stats, **ck)
    assert _step_dirs(ckpt) == [2, 4, 6]
    assert not [d for d in os.listdir(ckpt) if d.endswith(".tmp")]
    assert len(stats["save_s"]) == 3 and stats["save_wait_s"] >= 0
    shutil.rmtree(os.path.join(ckpt, "6"))
    resumed = port.iterate(b, inputs, **ck)
    np.testing.assert_array_equal(resumed["a"], full["a"])
    np.testing.assert_array_equal(
        full["a"], _oracle_steps(b, inputs, {"a": b.outputs[0]}, 6)["a"])
    theirs = ref_iterate(a, inputs, 6, interpret=True)
    np.testing.assert_allclose(resumed["a"], np.asarray(theirs["a"]),
                               rtol=VERIFY_RTOL, atol=1e-6)


@pytest.mark.parametrize("layout,blocks", [("2 x 2", (1, 2, 2)),
                                           ("4 shards of i", (4, 1, 1)),
                                           ("one device", None)])
def test_orbax_entries_are_shards(tmp_path, layout, blocks):
    """A sharded field is saved one entry a block, never whole: no entry
    has the global shape; state on one device is one entry a field."""
    import torch.distributed.checkpoint as dcp
    _a, b, inputs, kw = _orbax_case(layout)
    ckpt = str(tmp_path / "ent")
    port.iterate(b, inputs, steps=2, checkpoint_every=2,
                 checkpoint_dir=ckpt, checkpoint_format="orbax", **kw)
    md = dcp.FileSystemReader(os.path.join(ckpt, "2")).read_metadata()
    sizes = {k: tuple(m.size) for k, m in md.state_dict_metadata.items()}
    if blocks is None:
        assert sizes == {"a": (16, 16, 16)}
        return
    n = int(np.prod(blocks))
    assert len(sizes) == n
    want = tuple(16 // k for k in blocks)
    for key, size in sizes.items():
        assert key.startswith("a/shard_") and key.endswith(
            "_of_" + "_".join(map(str, blocks)))
        assert size == want != (16, 16, 16)


@pytest.mark.parametrize("saved,resumed", [("one device", "2 x 2"),
                                           ("2 x 2", "one device"),
                                           ("2 x 2", "4 shards of i")])
def test_orbax_resume_across_layouts(tmp_path, saved, resumed):
    """A checkpoint resumes onto another layout (each saved block's
    overlap copied into each new shard), bit for bit."""
    import shutil
    _a, b, inputs, kw = _orbax_case(saved)
    ckpt = str(tmp_path / "lay")
    ck = dict(steps=4, chunk=2, checkpoint_every=2, checkpoint_dir=ckpt,
              checkpoint_format="orbax")
    full = port.iterate(b, inputs, **ck, **kw)
    shutil.rmtree(os.path.join(ckpt, "4"))
    got = port.iterate(b, inputs, **ck, **_layout(resumed))
    np.testing.assert_array_equal(got["a"], full["a"])


def test_orbax_skips_incomplete_directories(tmp_path):
    """A ``<step>.tmp`` directory and a step directory without DCP's
    metadata are never resumed: the run continues from the newest whole
    one, and a junk input shows that it did restore."""
    import shutil
    _a, b, inputs, kw = _orbax_case("one device")
    ckpt = str(tmp_path / "inc")
    ck = dict(steps=6, chunk=2, checkpoint_every=2, checkpoint_dir=ckpt,
              checkpoint_format="orbax", **kw)
    full = port.iterate(b, inputs, **ck)
    os.rename(os.path.join(ckpt, "6"), os.path.join(ckpt, "6.tmp"))
    shutil.copytree(os.path.join(ckpt, "4"), os.path.join(ckpt, "8"))
    os.remove(os.path.join(ckpt, "8", ".metadata"))
    junk = {"a": np.zeros_like(inputs["a"])}
    got = port.iterate(b, junk, **ck)
    np.testing.assert_array_equal(got["a"], full["a"])
    assert _step_dirs(ckpt) == [2, 4, 6, 8]


def test_cli_iterate_orbax(tmp_path, capsys):
    """``iterate --checkpoint-format orbax``: rc 0, a directory a
    checkpoint, and a resumed run writing the uninterrupted state."""
    import shutil
    from stencilflow_tpu_torch.cli import main
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(2, 8, iterations=1), default=str))
    ckpt = tmp_path / "ck"
    argv = ["iterate", str(path), "--steps", "4", "--checkpoint-every", "2",
            "--checkpoint-dir", str(ckpt), "--checkpoint-format", "orbax",
            "--device", "cpu", "--output-dir"]
    assert main(argv + [str(tmp_path / "full")]) == 0
    assert "ran 4 steps" in capsys.readouterr().out
    assert _step_dirs(ckpt) == [2, 4]
    shutil.rmtree(ckpt / "4")
    assert main(argv + [str(tmp_path / "again")]) == 0
    assert (tmp_path / "full" / "a.dat").read_bytes() == \
        (tmp_path / "again" / "a.dat").read_bytes()

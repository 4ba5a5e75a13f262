"""The port's mesh-scaling model against the JAX package's, on the CPU.

On ``tests/test_mesh_model.py``'s configurations and its multi-input
program, every count term of ``Report.mesh_scaling`` (devices, mesh,
axes, local block, halo, exchanged bytes, the overlap's interior and
strip cells) equals the JAX package's exactly, and the key sets are its
own.  ``ici_bytes_per_device`` is the bytes the port's exchange
(``parallel/domain.py _exchange_halo``) writes into one position: both
faces of every sharded dim, a zero slab at a global edge in place of a
neighbour's.  The time terms are the port's: the roofline's compute
scaled to the widened block (at P = 1 the roofline itself) and the
exchange at ``config.H100_NVLINK_BANDWIDTH``.  ``report --mesh [--json]
[--comm-overlap]`` prints the JAX package's keys and lines, NVLink where
it says ICI, and exits 2 where it does.
"""
import json

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
from stencilflow_tpu.report import Report as RefReport
from stencilflow_tpu.synthesize import jacobi as ref_jacobi
from stencilflow_tpu.synthesize import synthesize_stencil
from stencilflow_tpu_torch.config import H100_NVLINK_BANDWIDTH
from stencilflow_tpu_torch.parallel.domain import (compile_sharded_chain,
                                                   place_global_inputs)
from stencilflow_tpu_torch.parallel.mesh import make_mesh
from stencilflow_tpu_torch.report import Report

CONFIGS = [
    (dict(nd=3, size=32, iters=2), (2, 2), (None, "x", "y")),
    (dict(nd=3, size=32, iters=4), (4, 2), (None, "x", "y")),
    (dict(nd=3, size=16, iters=2), (2, 2), ("x", "y", None)),
    (dict(nd=2, size=64, iters=3), (2, 4), (None, "x", "y")),
]
COUNT_TERMS = ("devices", "mesh", "dim_axes", "local_dims", "halo",
               "ici_bytes_per_device")


def _programs(spec, name):
    return ref.parse_program(spec, name=name), port.parse_program(spec,
                                                                  name=name)


def _cases():
    out = [(f"jacobi{pa['nd']}d_{pa['size']}x{pa['iters']}",
            ref_jacobi(pa["nd"], pa["size"], iterations=pa["iters"]),
            mshape, axes) for pa, mshape, axes in CONFIGS]
    out.append(("hotspot", synthesize_stencil(
        num_stages=2, dimensions=(8, 32, 32), shape="hotspot"), (2, 2),
        (None, "x", "y")))
    return out


def _exchanged_bytes(p, mshape, axes) -> int:
    """The bytes the port's exchange writes into the first position: its
    widened tiles less its own blocks, over every array input."""
    mesh = make_mesh(["cpu"], mshape, ("x", "y"))
    fn, plan = compile_sharded_chain(p, mesh, axes, local_backend="xla")
    placed = place_global_inputs(p, plan, port.load_input_arrays(p, seed=0))
    per = fn.exchange(placed)
    c = mesh.coords()[0]
    return sum((per[c][n].numel() - placed[n].shards[c].numel())
               * per[c][n].element_size()
               for n in p.inputs if not p.inputs[n].is_scalar)


@pytest.mark.parametrize("name,spec,mshape,axes", _cases())
def test_count_terms_match_the_reference(name, spec, mshape, axes):
    a, b = _programs(spec, name)
    mesh = {"x": mshape[0], "y": mshape[1]}
    want = RefReport.build(a).mesh_scaling(mesh, dim_axes=axes)
    got = Report.build(b).mesh_scaling(mesh, dim_axes=axes)
    assert set(got) == set(want)
    assert set(got["comm_overlap"]) == set(want["comm_overlap"])
    for key in COUNT_TERMS:
        assert got[key] == want[key], key
    for key in ("interior_cells", "strip_cells"):
        assert got["comm_overlap"][key] == want["comm_overlap"][key], key
    assert got["t_ici_s"] == got["ici_bytes_per_device"] / \
        H100_NVLINK_BANDWIDTH


@pytest.mark.parametrize("name,spec,mshape,axes", _cases())
def test_ici_bytes_are_what_the_exchange_writes(name, spec, mshape, axes):
    _a, b = _programs(spec, name)
    model = Report.build(b).mesh_scaling(
        {"x": mshape[0], "y": mshape[1]}, dim_axes=axes)
    assert _exchanged_bytes(b, mshape, axes) == \
        model["ici_bytes_per_device"] > 0


@pytest.mark.parametrize("name,spec,mshape,axes", _cases()[:2])
def test_comm_overlap_model_terms(name, spec, mshape, axes):
    """The overlap body's geometry (a 3h strip per sharded face spanning
    the widened extents of the other dims; the interior the unwidened
    block) and the model's cost identities."""
    _a, b = _programs(spec, name)
    mesh = make_mesh(["cpu"], mshape, ("x", "y"))
    _fn, plan = compile_sharded_chain(b, mesh, axes, comm_overlap=True)
    model = Report.build(b).mesh_scaling(
        {"x": mshape[0], "y": mshape[1]}, dim_axes=axes)
    ov = model["comm_overlap"]
    strips = 0.0
    for d in range(3):
        if not plan.halo[d]:
            continue
        face = 1.0
        for o in range(3):
            if o != d:
                face *= plan.block[o] + 2 * plan.halo[o]
        strips += 2 * 3 * plan.halo[d] * face
    assert ov["strip_cells"] == pytest.approx(strips)
    assert ov["interior_cells"] == pytest.approx(float(np.prod(plan.block)))
    assert ov["t_step_s"] == pytest.approx(
        max(ov["t_interior_s"], model["t_ici_s"]) + ov["t_strips_s"])
    assert ov["break_even_ici_s"] == pytest.approx(max(
        0.0, ov["t_interior_s"] + ov["t_strips_s"] - model["t_compute_s"]))
    assert ov["wins"] == (ov["t_step_s"] < model["t_step_s"])


@pytest.mark.parametrize("nd,size,iters", [(3, 32, 2), (2, 64, 3)])
def test_compute_term_reduces_to_roofline_at_p1(nd, size, iters):
    p = port.parse_program(ref_jacobi(nd, size, iterations=iters),
                           name="mm_p1")
    rep = Report.build(p)
    model = rep.mesh_scaling({"x": 1, "y": 1})
    assert model["t_ici_s"] == 0 == model["ici_bytes_per_device"]
    assert model["t_compute_s"] == pytest.approx(rep.roofline_time_s())
    assert model["parallel_efficiency"] == pytest.approx(1.0)


def test_rejections_match_the_reference():
    a, b = _programs(ref_jacobi(3, 16, iterations=1), "rj")
    for mesh, axes in (({"x": 2}, (None, "x", "x")),
                       ({"x": 2}, (None, "x", "y")),
                       ({"x": 3}, (None, "x", None))):
        with pytest.raises(ValueError) as theirs:
            RefReport.build(a).mesh_scaling(mesh, axes)
        with pytest.raises(ValueError) as mine:
            Report.build(b).mesh_scaling(mesh, axes)
        assert str(mine.value) == str(theirs.value)


@pytest.fixture
def prog(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(ref_jacobi(3, 32, iterations=2),
                               default=str))
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--comm-overlap"]])
def test_report_mesh_json_keys(prog, capsys, extra):
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    argv = ["report", prog, "--mesh", "x=2,y=2", "--json"] + extra
    assert ref_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert set(got["mesh_scaling"]) == set(want["mesh_scaling"])
    assert set(got["mesh_scaling"]["comm_overlap"]) == \
        set(want["mesh_scaling"]["comm_overlap"])
    for key in COUNT_TERMS:
        assert got["mesh_scaling"][key] == want["mesh_scaling"][key], key


@pytest.mark.parametrize("overlap", [False, True])
def test_report_mesh_text(prog, capsys, overlap):
    """The JAX package's lines after the report, NVLink for ICI."""
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    argv = ["report", prog, "--mesh", "x=2,y=2"] + (
        ["--comm-overlap"] if overlap else [])
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    got = capsys.readouterr().out
    tail = "\nmesh scaling ["
    assert tail in got
    want_lines = want.split(tail, 1)[1].splitlines()
    got_lines = got.split(tail, 1)[1].splitlines()
    assert len(got_lines) == len(want_lines) == (5 if overlap else 3)
    assert got_lines[0] == want_lines[0]
    assert got_lines[1].split("NVLink")[0] == want_lines[1].split("ICI")[0]
    assert "ICI" not in got and "NVLink" in got_lines[2]
    if overlap:
        assert got_lines[3].startswith("  --comm-overlap: interior")
        assert got_lines[4].startswith("  verdict: overlap ")


@pytest.mark.parametrize("extra", [["--mesh", "x=0"], ["--mesh", "x"],
                                   ["--mesh", "x=2", "--mesh-axes", "x,y"],
                                   ["--mesh", "x=2", "--mesh-axes",
                                    "none,x,q"]])
def test_report_mesh_bad_arguments(prog, capsys, extra):
    from stencilflow_tpu.cli import main as ref_main
    from stencilflow_tpu_torch.cli import main
    try:
        theirs = ref_main(["report", prog] + extra)
    except ValueError:
        theirs = 2
    capsys.readouterr()
    assert main(["report", prog] + extra) == theirs == 2
    assert capsys.readouterr().err

"""The port's command line against the JAX package's, on the CPU.

Every ``run`` argument the reference parser accepts parses in the port;
the reference's spellings map to the port's lowerings (``--no-mxu``,
``--backend pallas|xla|interpreter``, the ``emulation``/``hardware``
mode).  ``report --json`` prints the reference's keys with the same
hardware-independent numbers.
``autotune`` parses the reference's arguments and prints its JSON keys,
``run --backend autotuned`` runs the cached winner, ``partition`` prints
the reference's lines, and ``run-distributed
--parallel-mode pipeline`` runs on virtual CPU positions with the
reference's rc-2 checks.  ``synthesize`` prints and writes the
reference's bytes, ``canonicalize`` and ``import-sdfg`` write its JSON,
``compile --emulation`` writes the CUDA C++ of the program's route
(each rung's source is what its compile entry point's plan gives), and
``report --plot`` writes the reference's graphs or, without matplotlib,
exits with ``error:`` and rc 2.
"""
import argparse
import json
import os
import re

import pytest

from stencilflow_tpu.cli import build_parser as ref_parser
from stencilflow_tpu.cli import main as ref_main
from stencilflow_tpu_torch.cli import build_parser, main
from stencilflow_tpu_torch.synthesize import synthesize_stencil


def _subparser(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


def _argvs(sub):
    """One argv per value of every optional argument of ``sub``: each
    choice, or a value of the argument's type."""
    for act in sub._actions:
        if not act.option_strings or act.dest == "help":
            continue
        opt = act.option_strings[-1]
        if act.nargs == 0:
            yield [opt]
        elif act.choices:
            for c in act.choices:
                yield [opt, str(c)]
        elif act.type in (int, float):
            yield [opt, "2"]
        else:
            yield [opt, "x"]


REF_RUN = list(_argvs(_subparser(ref_parser(), "run")))
REF_REPORT = list(_argvs(_subparser(ref_parser(), "report")))
REF_AUTOTUNE = list(_argvs(_subparser(ref_parser(), "autotune")))


@pytest.mark.parametrize("extra", REF_RUN + [["emulation"], ["hardware"]],
                         ids=" ".join)
def test_run_parses_every_reference_argument(extra):
    ref_parser().parse_args(["run", "prog.json"] + extra)
    args = build_parser().parse_args(["run", "prog.json"] + extra)
    assert args.stencil_file == "prog.json"


@pytest.mark.parametrize("extra", REF_REPORT, ids=" ".join)
def test_report_parses_every_reference_argument(extra):
    build_parser().parse_args(["report", "prog.json"] + extra)


@pytest.fixture
def prog(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=2, dimensions=(8, 10, 12), shape="box", extent=2)))
    return str(path)


@pytest.mark.parametrize("extra,backend", [
    (["emulation", "--backend", "xla"], "dense"),
    (["hardware", "--backend", "pallas"], "tile"),
    (["--backend", "interpreter"], "interpreter"),
    (["--no-mxu", "--backend", "stream"], "stream"),
])
def test_run_reference_spellings(prog, capsys, extra, backend):
    assert main(["run", prog, "--device", "cpu", "--compare-to-reference"]
                + extra) == 0
    out = capsys.readouterr().out
    assert f"backend: {backend}\n" in out
    assert "verified against reference: OK" in out
    assert "roofline" in out and "[h100-sxm]" in out


def test_no_mxu_is_mxu_off(monkeypatch, prog):
    import stencilflow_tpu_torch.driver as drv
    seen = {}

    def fake(*a, **k):
        seen.update(k)
        raise ValueError("stop")
    monkeypatch.setattr(drv, "run_program", fake)
    assert main(["run", prog, "--no-mxu"]) == 2
    assert seen["mxu"] == "off" and seen["backend"] == "auto"


@pytest.mark.parametrize("backend", ["panel", "stream", "rows"])
def test_run_ring_storage_bfloat16(jprog, tmp_path, capsys, backend):
    """bf16 rings (f32 compute) verify at BF16_VERIFY_RTOL: the same run
    held to VERIFY_RTOL fails, so the rounding is really there.  ``rows``
    (a 2-D program) takes rows+stream, as the JAX package's does."""
    prog = jprog
    if backend == "rows":
        prog = str(tmp_path / "prog2d.json")
        with open(prog, "w") as f:
            json.dump(synthesize_stencil(
                num_stages=3, dimensions=(24, 40), shape="diffusion",
                seed_data="random:0,1"), f)
    argv = ["run", prog, "--device", "cpu", "--backend", backend,
            "--ring-storage", "bfloat16", "--compare-to-reference"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    want = "rows+stream" if backend == "rows" else backend
    assert f"backend: {want}\n" in out
    assert "verified against reference: OK" in out
    assert main(argv + ["--tolerance", "1e-5"]) == 1


def test_run_mxu_precision_bf16(prog, capsys):
    """Single-pass bf16 band transforms on a box chain: banded stages,
    verified at BF16_VERIFY_RTOL and not at MXU_VERIFY_RTOL."""
    argv = ["run", prog, "--device", "cpu", "--backend", "stream",
            "--mxu-precision", "bf16", "--compare-to-reference"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "backend: stream\n" in out
    assert "verified against reference: OK" in out
    assert main(argv + ["--tolerance", "3e-5"]) == 1


def test_run_ring_storage_refused_elsewhere(jprog, capsys):
    assert main(["run", jprog, "--device", "cpu", "--backend", "overlap",
                 "--ring-storage", "bfloat16"]) == 2
    assert "--ring-storage requires" in capsys.readouterr().err


@pytest.mark.parametrize("shape,extent", [("box", 2), ("hdiff", 1),
                                          ("diffusion", 1)])
def test_report_json_matches_reference(tmp_path, capsys, shape, extent):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=3, dimensions=(8, 12, 16), shape=shape, extent=extent)))
    assert ref_main(["report", str(path), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["report", str(path), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["hardware"] == "h100-sxm"
    for key in ("dimensions", "kernels", "vectorization", "ops_per_cell",
                "critical_path_cycles", "runtime_lower_bound_cycles",
                "min_communication_volume_bytes", "fast_memory_bytes",
                "hbm_footprint_bytes", "suggested_host_chunks"):
        assert got[key] == want[key], key
    assert (got["mxu_model"] or {}).get("stages") == \
        (want["mxu_model"] or {}).get("stages")


def test_report_verbose_and_optimize_ratio(prog, capsys):
    assert ref_main(["report", prog, "--verbose", "--optimize-ratio",
                     "0.5"]) == 0
    want = capsys.readouterr().out
    assert main(["report", prog, "--verbose", "--optimize-ratio",
                 "0.5"]) == 0
    got = capsys.readouterr().out
    tail = "\n\nkernels:"
    assert got.split(tail, 1)[1] == want.split(tail, 1)[1]
    assert "memory placement at slow/fast ratio 0.5" in got


@pytest.fixture
def dprog(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "dprog.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=2, dimensions=(8, 12, 16), shape="diffusion",
        boundary="copy")))
    return str(path)


@pytest.mark.parametrize("axes", [None, "x,y,none", "x,none,none"])
def test_run_distributed_on_host_devices(dprog, capsys, axes):
    """run-distributed --force-host-devices: four virtual CPU shards on a
    2 x 2 mesh, checked against the oracle, as the JAX package's
    subcommand prints it."""
    extra = ["--dim-axes", axes] if axes else []
    argv = ["run-distributed", dprog, "--devices", "4",
            "--force-host-devices", "--compare-to-reference"] + extra
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "ran domain over 4 devices (mesh {'x': 2, 'y': 2})" in out
    assert "verified against reference: OK" in out


@pytest.mark.parametrize("axes", ["x,none,none", None])
def test_run_distributed_comm_overlap(dprog, capsys, axes):
    """--comm-overlap on four virtual CPU shards (a 2 x 2 mesh; the tile
    body, CPU shards' auto body), sharding i or the default (j, k),
    checked against the oracle; pipeline mode still refuses it."""
    extra = ["--dim-axes", axes] if axes else []
    argv = ["run-distributed", dprog, "--devices", "4",
            "--force-host-devices", "--comm-overlap",
            "--compare-to-reference"] + extra
    assert main(argv) == 0
    assert "verified against reference: OK" in capsys.readouterr().out
    assert main(["run-distributed", dprog, "--devices", "2",
                 "--force-host-devices", "--comm-overlap",
                 "--parallel-mode", "pipeline"]) == 2
    assert "domain mode only" in capsys.readouterr().err


def test_run_distributed_needs_its_devices(dprog, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main(["run-distributed", dprog, "--devices", "4"]) == 2
    assert "only 1 devices available" in capsys.readouterr().err
    assert main(["run-distributed", dprog, "--devices", "4",
                 "--force-host-devices", "--dim-axes", "x,q,none"]) == 2
    assert "unknown mesh axis ['q']" in capsys.readouterr().err


@pytest.fixture
def pprog(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "pprog.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=4, dimensions=(8, 12, 16), shape="diffusion",
        boundary="copy")))
    return str(path)


@pytest.mark.parametrize("extra", [
    [], ["--at", "s0"], ["--cut", "s0,s1"], ["--optimize", "--devices", "3"],
    ["--devices", "4", "--enumerate-cuts"]], ids=" ".join)
def test_partition_prints_the_reference_lines(pprog, capsys, extra):
    """The diffusion chain has only adds and multiplies, which cost the
    same in the JAX package's table and the port's H100 table."""
    assert ref_main(["partition", pprog] + extra) == 0
    want = capsys.readouterr().out
    assert main(["partition", pprog] + extra) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("extra,mesh", [
    ([], "{'p': 4}"), (["--split-at", "s0,s1,s2"], "{'p': 4}"),
    (["--optimize-cuts"], "{'p': 4}"),
    (["--pipeline-domain", "j=2"], "{'p': 2, 'x': 2}"),
    (["--num-chunks", "8"], "{'p': 4}")], ids=lambda v: " ".join(v)
    if isinstance(v, list) else "")
def test_run_distributed_pipeline_on_host_devices(pprog, capsys, extra,
                                                  mesh):
    """run-distributed --parallel-mode pipeline --force-host-devices: four
    virtual CPU positions, checked against the oracle, printing the JAX
    package's lines."""
    argv = ["run-distributed", pprog, "--parallel-mode", "pipeline",
            "--devices", "4", "--force-host-devices",
            "--compare-to-reference"] + extra
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert f"ran pipeline over 4 devices (mesh {mesh})" in out
    assert "backend: pipeline[xla x" in out
    assert "verified against reference: OK" in out


@pytest.mark.parametrize("extra,message", [
    (["--parallel-mode", "pipeline", "--dim-axes", "none,x,y"],
     "--dim-axes applies to domain mode only"),
    (["--parallel-mode", "pipeline", "--comm-overlap"],
     "--comm-overlap applies to domain mode only"),
    (["--split-at", "s0"], "--split-at/--cut/--optimize-cuts/"
     "--pipeline-domain apply to pipeline mode only"),
    (["--parallel-mode", "pipeline", "--pipeline-domain", "q=2"],
     "--pipeline-domain: expected 'j=N[,k=M]'"),
    (["--parallel-mode", "pipeline", "--pipeline-domain", "j=3"],
     "--devices 4 not divisible by the domain factor 3")])
def test_run_distributed_pipeline_rc2_checks(pprog, capsys, extra,
                                             message):
    """The JAX package's rc-2 checks of misdirected flags."""
    argv = ["run-distributed", pprog, "--devices", "4",
            "--force-host-devices"] + extra
    assert main(argv) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("backend,warns", [("xla", True),
                                            ("stream", False)])
def test_run_distributed_pipeline_names_its_backend(pprog, capsys,
                                                    monkeypatch, backend,
                                                    warns):
    """On CUDA positions the segments' body is printed, and the dense
    tile body taken because no K4 plan fits a segment warns on stderr."""
    import torch
    from stencilflow_tpu_torch.parallel import pipeline

    def fake_compile(program, mesh, axis, **kw):
        def fn(inputs):
            return {o: torch.zeros(program.dimensions)
                    for o in program.outputs}
        fn.last_config = {"backend": backend, "io": "sharded"}
        return fn, None

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pipeline, "compile_pipeline_split", fake_compile)
    assert main(["run-distributed", pprog, "--parallel-mode", "pipeline",
                 "--devices", "4"]) == 0
    got = capsys.readouterr()
    assert f"backend: pipeline[{backend} x4 segments, sharded io]" in got.out
    assert ("fits no K4 plan" in got.err) == warns


def test_run_distributed_pipeline_needs_its_devices(pprog, capsys,
                                                    monkeypatch):
    """One H100 has one CUDA device: pipeline mode over 2 refuses as
    domain mode does (a mesh repeating the card is built from Python)."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main(["run-distributed", pprog, "--parallel-mode", "pipeline",
                 "--devices", "2"]) == 2
    assert "only 1 devices available" in capsys.readouterr().err


@pytest.mark.parametrize("extra", REF_AUTOTUNE, ids=" ".join)
def test_autotune_parses_every_reference_argument(extra):
    ref_parser().parse_args(["autotune", "prog.json"] + extra)
    args = build_parser().parse_args(["autotune", "prog.json"] + extra)
    assert args.stencil_file == "prog.json"


@pytest.fixture
def jprog(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "jprog.json"
    path.write_text(json.dumps(synthesize_stencil(
        num_stages=2, dimensions=(8, 10, 12), shape="diffusion")))
    return str(path)


@pytest.mark.parametrize("flag", ["--device", "--emulation"])
def test_autotune_json_prints_the_reference_keys(jprog, tmp_path, capsys,
                                                 flag):
    cache = str(tmp_path / "at.json")
    argv = ["autotune", jprog, "--no-sweep", "--trials", "1", "--cache",
            cache, "--json"] + (["--device", "cpu"] if flag == "--device"
                                else ["--emulation"])
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"winner", "seconds_per_run", "gcell_s", "timings",
                        "skipped", "cache"}
    assert got["winner"] in got["timings"] and got["cache"] == cache
    assert got["seconds_per_run"] == min(got["timings"].values()) > 0
    entry, = json.load(open(cache)).values()
    assert entry["label"] == got["winner"] and entry["device"] == "cpu:cpu"


def test_autotune_prints_the_reference_lines(jprog, capsys):
    assert main(["autotune", jprog, "--no-sweep", "--trials", "1",
                 "--device", "cpu", "--no-cache"]) == 0
    out = capsys.readouterr().out
    assert "winner: " in out and " ms/run, " in out
    assert "cached -> " not in out
    assert " ms " in out and "GCell/s" in out


def test_run_backend_autotuned(jprog, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    argv = ["run", jprog, "--backend", "autotuned", "--device", "cpu",
            "--compare-to-reference"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    label = re.search(r"^backend: autotuned:(\S+)$", out, re.M).group(1)
    assert "verified against reference: OK" in out
    entry, = json.load(open(tmp_path / "at.json")).values()
    assert entry["label"] == label
    assert main(argv) == 0      # the cached winner
    assert f"backend: autotuned:{label}\n" in capsys.readouterr().out


def test_autotune_allow_reduced_precision(jprog, tmp_path, capsys):
    cache = str(tmp_path / "at.json")
    assert main(["autotune", jprog, "--device", "cpu", "--no-sweep",
                 "--trials", "1", "--allow-reduced-precision", "--json",
                 "--cache", cache]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"stream:rings=bf16", "panel:rings=bf16"} <= set(got["timings"])
    entry, = json.load(open(cache)).values()
    assert entry["reduced_precision"] == (":rings=bf16" in got["winner"])


def test_autotune_mxu_precision_bf16(prog, tmp_path, capsys):
    cache = str(tmp_path / "at.json")
    assert main(["autotune", prog, "--device", "cpu", "--no-sweep",
                 "--trials", "1", "--mxu-precision", "bf16", "--json",
                 "--cache", cache]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "stream" in got["timings"]
    assert not {"stream:rings=bf16", "panel:rings=bf16"} & set(
        got["timings"])


def test_run_autotuned_bf16_rings_winner(jprog, tmp_path, capsys,
                                         monkeypatch):
    """A cached ``:rings=bf16`` winner (tuned on that label alone) runs
    and verifies at the widened tolerance."""
    from stencilflow_tpu_torch import autotune as at
    from stencilflow_tpu_torch.frontend.parser import parse_program
    path = str(tmp_path / "at.json")
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", path)
    p = parse_program(jprog)
    res = at.autotune(p, labels=["panel:rings=bf16"], device="cpu",
                      trials=1)
    at.save_result(p, res, device="cpu", mxu="auto", mxu_precision="split",
                   spill="auto")
    argv = ["run", jprog, "--backend", "autotuned", "--device", "cpu",
            "--compare-to-reference"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "backend: autotuned:panel:rings=bf16\n" in out
    assert "verified against reference: OK" in out
    assert main(argv + ["--tolerance", "1e-5"]) == 1


NEW_COMMANDS = ("canonicalize", "import-sdfg", "compile", "synthesize")


@pytest.mark.parametrize("command,extra", [
    (c, e) for c in NEW_COMMANDS
    for e in [[]] + list(_argvs(_subparser(ref_parser(), c)))],
    ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_new_subcommands_parse_every_reference_argument(command, extra):
    argv = [command] + ([] if command == "synthesize" else ["f.json"]) \
        + extra
    want = vars(ref_parser().parse_args(argv))
    got = vars(build_parser().parse_args(argv))
    assert {k: v for k, v in got.items() if k != "fn"} == \
        {k: v for k, v in want.items() if k != "fn"}


@pytest.mark.parametrize("extra", [
    [], ["--shape", "box", "--extent", "2"], ["--shape", "diffusion"],
    ["--shape", "hotspot", "--dimensions", "8", "16"],
    ["--shape", "hdiff", "--num-stages", "2", "--data-type", "float64"],
    ["--fork-frequency", "2", "--fork-length", "2", "--input-frequency",
     "3", "--boundary", "copy", "--vectorization", "2"]], ids=" ".join)
def test_synthesize_matches_reference_bytes(tmp_path, capsys, extra):
    assert ref_main(["synthesize"] + extra) == 0
    want = capsys.readouterr().out
    assert main(["synthesize"] + extra) == 0
    assert capsys.readouterr().out == want
    ref_out, out = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    assert ref_main(["synthesize", "-o", ref_out] + extra) == 0
    assert main(["synthesize", "-o", out] + extra) == 0
    assert open(out, "rb").read() == open(ref_out, "rb").read()
    assert capsys.readouterr().out == f"wrote {ref_out}\nwrote {out}\n"


EXAMPLE_JSON = sorted(f for f in os.listdir(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples")) if f.endswith(".json"))


def _both_write(argv_of, capsys):
    """Run the reference CLI, then the port's, each writing to its own
    file; return (want, got) JSON and check the printed lines agree."""
    assert ref_main(argv_of("ref.json")) == 0
    want_out = capsys.readouterr().out
    assert main(argv_of("port.json")) == 0
    got_out = capsys.readouterr().out
    assert got_out == want_out.replace("ref.json", "port.json")
    return json.load(open("ref.json")), json.load(open("port.json"))


@pytest.mark.parametrize("extra", [[], ["--predicate-min-max"],
                                   ["--symbols", "cap=1.5,ct=2"]],
                         ids=" ".join)
@pytest.mark.parametrize("name", EXAMPLE_JSON)
def test_canonicalize_matches_reference(tmp_path, monkeypatch, capsys,
                                        name, extra):
    monkeypatch.chdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = json.load(open(os.path.join(root, "examples", name)))
    spec["dimensions"] = [min(d, 8) for d in spec["dimensions"]]
    with open("prog.json", "w") as f:
        json.dump(spec, f)
    want, got = _both_write(
        lambda out: ["canonicalize", "prog.json", "-o", out] + extra, capsys)
    assert got == want


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.mark.parametrize("extra", [
    [], ["--dimensions", "4,16,16"], ["--symbols", "I=4,J=16,K=16"],
    ["--vector-length", "2", "--input-data", "random:0,1"]], ids=" ".join)
@pytest.mark.parametrize("fixture", ["hdiff", "hdiff_mapnest",
                                     "hdiff_mapnest_dace"])
def test_import_sdfg_matches_reference(tmp_path, monkeypatch, capsys,
                                       fixture, extra):
    monkeypatch.chdir(tmp_path)
    path = os.path.join(FIXTURES, f"{fixture}.sdfg")
    want, got = _both_write(
        lambda out: ["import-sdfg", path, "-o", out] + extra, capsys)
    assert got == want


@pytest.mark.parametrize("symbols", ["I", "=3", "I=x", "I=4,J"])
def test_import_sdfg_bad_symbols(capsys, symbols):
    path = os.path.join(FIXTURES, "hdiff_mapnest.sdfg")
    argv = ["import-sdfg", path, "--symbols", symbols, "-o", "unused.json"]
    assert ref_main(argv) == 2
    want = capsys.readouterr().err
    assert main(argv) == 2
    assert capsys.readouterr().err == want
    assert want.startswith("bad --symbols entry")
    assert not os.path.exists("unused.json")


def _route_programs():
    """{route: program spec} with one small program per kernel route."""
    return {
        "overlap": synthesize_stencil(num_stages=1, dimensions=(8, 12, 16),
                                      shape="diffusion"),
        "panel": synthesize_stencil(num_stages=4, dimensions=(8, 12, 16),
                                    shape="diffusion"),
        "stream": synthesize_stencil(num_stages=2, dimensions=(8, 12, 16),
                                     shape="box", extent=2),
        "rows+group_g8": synthesize_stencil(num_stages=4,
                                            dimensions=(64, 16),
                                            shape="diffusion"),
    }


def _entry_source(program, route):
    """The source of ``route``'s kernel from the plan its compile entry
    point makes on the CPU, through the source function its build
    compiles."""
    from stencilflow_tpu_torch.backend import (codegen, group, overlap,
                                               panel, stream, tile)
    from stencilflow_tpu_torch.frontend.analysis import ChainAnalysis
    from stencilflow_tpu_torch.frontend.canonicalize import \
        rotate_2d_to_rows
    if route.startswith("rows+"):
        program = rotate_2d_to_rows(program)
        route = route[len("rows+"):]
    an = ChainAnalysis.run(program)
    if route == "group_g8":
        plan = group.compile_chain_group(program, panel=64, group=8,
                                         device="cpu").plan
        return codegen.group_source(program, an, plan)
    if route == "panel":
        plan = panel.compile_chain_panel(program, device="cpu").plan
        return codegen.panel_source(program, an, plan)
    if route == "overlap":
        plan = overlap.compile_chain_overlap(program, device="cpu").plan
        return codegen.overlap_source(program, an, plan)
    if route == "stream":
        return stream.stream_source(
            stream.compile_chain_stream(program, device="cpu").plan)
    assert route == "tile"
    return tile.tile_source(tile.compile_chain_tile(program,
                                                    device="cpu").plan)


@pytest.mark.parametrize("route", sorted(_route_programs()))
def test_compile_emulation_writes_the_routes_source(tmp_path, monkeypatch,
                                                    capsys, route):
    from stencilflow_tpu_torch.backend import route_source
    from stencilflow_tpu_torch.frontend.parser import parse_program
    monkeypatch.chdir(tmp_path)
    with open("prog.json", "w") as f:
        json.dump(_route_programs()[route], f)
    assert main(["compile", "prog.json", "--emulation"]) == 0
    program = parse_program("prog.json")
    written = open(f"{program.name}.cu").read()
    assert capsys.readouterr().out == (
        f"lowered with backend '{route}' -> {program.name}.cu "
        f"({len(written.encode())} bytes)\n")
    assert route_source(program) == (route, written,
                                     route.split("+")[-1].split("_")[0])
    assert written == _entry_source(program, route)
    assert not os.path.isdir("_build")


@pytest.mark.parametrize("route,shape,extent", [
    ("tile", "diffusion", 1), ("rows+overlap", "diffusion", 1),
    ("rows+panel", "cross", 2), ("rows+stream", "box", 2)])
def test_route_source_rungs_off_the_small_ladder(monkeypatch, route, shape,
                                                 extent):
    """The rungs that small programs do not reach (``tile`` and the 2-D
    rescue ``rows+<lowering>``), with the route forced: each gives the
    source of its compile entry point's plan."""
    import stencilflow_tpu_torch.backend as be
    from stencilflow_tpu_torch.frontend.parser import parse_program
    program = parse_program(synthesize_stencil(
        num_stages=2, dimensions=(12, 16), shape=shape, extent=extent))
    real = be._route

    def forced(p, *args):
        if p is program:
            return route, None
        got = real(p, *args)
        inner = route.split("+")[-1]
        assert got[0] == inner   # the rotated program's own route
        return got
    monkeypatch.setattr(be, "_route", forced)
    name, source, _lib = be.route_source(program)
    assert name == route and source == _entry_source(program, route)


def test_compile_refuses_dense_and_missing_nvcc(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.chdir(tmp_path)
    # no array input: the kernels refuse it, so it routes to dense (a
    # float16 program lowers onto a kernel now)
    with open("scalar.json", "w") as f:
        json.dump({"inputs": {"sc": {"data": 1.5, "data_type": "float32",
                                     "input_dims": []}},
                   "outputs": ["b"], "dimensions": [4, 5, 6],
                   "program": {"b": {"computation_string": "b = sc * 2.0",
                                     "data_type": "float32"}}}, f)
    for extra in ([], ["--emulation"]):
        assert main(["compile", "scalar.json"] + extra) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: ") and "routes to dense" in err
    with open("f16.json", "w") as f:
        json.dump(synthesize_stencil(num_stages=2, dimensions=(8, 8, 8),
                                     shape="diffusion",
                                     data_type="float16"), f)
    assert main(["compile", "f16.json", "--emulation"]) == 0
    assert "lowered with backend 'overlap'" in capsys.readouterr().out
    with open("prog.json", "w") as f:
        json.dump(_route_programs()["panel"], f)
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert main(["compile", "prog.json", "-o", "k.cu"]) != 0
    assert "nvcc not found" in capsys.readouterr().err
    assert os.path.getsize("k.cu") > 0   # the source is written first


def test_report_plot_writes_the_graphs(prog, capsys):
    from stencilflow_tpu_torch.frontend.parser import parse_program
    assert main(["report", prog, "--plot"]) == 0
    out = capsys.readouterr().out
    p = parse_program(prog)
    names = [f"{p.name}_chain.png"] + [f"{p.name}_{k}_compute.png"
                                       for k in p.kernels]
    assert out.splitlines()[:len(names)] == [f"wrote {n}" for n in names]
    for n in names:
        assert open(n, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_report_plot_without_matplotlib(prog, capsys, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert main(["report", prog, "--plot"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "needs matplotlib" in err
    assert not [f for f in os.listdir(".") if f.endswith(".png")]

"""The port's command line against the JAX package's, on the CPU.

Every ``run`` argument the reference parser accepts parses in the port;
the reference's spellings map to the port's lowerings (``--no-mxu``,
``--backend pallas|xla|interpreter``, the ``emulation``/``hardware``
mode), and the options whose engines are not ported exit with ``error:``
and rc 2, naming their ROADMAP item.  ``report --json`` prints the
reference's keys with the same hardware-independent numbers.
"""
import argparse
import json
import os
import re

import pytest

from stencilflow_tpu.cli import build_parser as ref_parser
from stencilflow_tpu.cli import main as ref_main
from stencilflow_tpu_torch.cli import NOT_PORTED, build_parser, main
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


@pytest.mark.parametrize("extra,item", [
    # the cases keep the ids they were first collected under
    pytest.param(["--ring-storage", "bfloat16"], "item 11",
                 id="extra1-item 11"),
    pytest.param(["--mxu-precision", "bf16"], "item 11",
                 id="extra2-item 11"),
    pytest.param(["--backend", "autotuned"], "item 7", id="extra3-item 7"),
])
def test_run_refuses_unported_options(prog, capsys, extra, item):
    assert main(["run", prog, "--device", "cpu"] + extra) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and f"ROADMAP Queue 1 {item}" in err


@pytest.mark.parametrize("extra,item", [(["--plot"], "item 10"),
                                        (["--mesh", "x=2"], "item 8")])
def test_report_refuses_unported_options(prog, capsys, extra, item):
    assert main(["report", prog] + extra) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and f"ROADMAP Queue 1 {item}" in err


def _queue1_items():
    """{number: title} of ROADMAP.md's Queue 1."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "ROADMAP.md")).read()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    return {int(n): title for n, title in
            re.findall(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M)}


@pytest.mark.parametrize("option", sorted(NOT_PORTED))
def test_refusals_name_items_of_roadmap_queue_1(option):
    """Each refusal names an item of ROADMAP Queue 1 whose title carries
    the milestone (or bf16) the refusal gives."""
    m = re.fullmatch(r"Queue 1 item (\d+) \(([^,;)]+).*\)",
                     NOT_PORTED[option])
    assert m, NOT_PORTED[option]
    items = _queue1_items()
    n, code = int(m.group(1)), m.group(2)
    assert n in items, (option, n)
    assert re.search(rf"\b{code}\b", items[n]), (option, items[n])


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

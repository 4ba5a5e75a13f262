"""``run --run-simulation`` and ``simulate`` in the port, on the CPU.

``run_program(..., run_simulation=True)`` runs the dataflow simulator on
the host inputs before the lowering and holds the outputs against it at
the verification tolerance (``device="cpu"``: the ``dense`` lowering);
its cycle count is the JAX package's.  ``cli simulate`` prints the JAX
CLI's lines for the same program, and the files written by ``--trace``,
``--trace-chrome`` and ``--output-dir`` are byte-equal to the JAX
CLI's.
"""
import argparse
import json
import os

import numpy as np
import pytest

import stencilflow_tpu.driver as ref_driver
import stencilflow_tpu_torch.sim as port_sim
from stencilflow_tpu.cli import build_parser as ref_parser
from stencilflow_tpu.cli import main as ref_main
from stencilflow_tpu_torch.cli import build_parser, main
from stencilflow_tpu_torch.driver import VerificationError, run_program
from stencilflow_tpu_torch.synthesize import random_program, synthesize_stencil


def _write(tmp_path, spec, name="prog.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


PROGRAMS = {
    "box": lambda: synthesize_stencil(num_stages=2, dimensions=(8, 10, 12),
                                      shape="box", extent=2),
    "jacobi2d": lambda: synthesize_stencil(num_stages=3, dimensions=(12, 16),
                                           shape="diffusion",
                                           seed_data="random:0.0,1.0"),
    "hdiff": lambda: synthesize_stencil(num_stages=2, dimensions=(6, 10, 12),
                                        shape="hdiff"),
    "fuzz": lambda: random_program(np.random.default_rng(122)),
    "fuzz_i32": lambda: random_program(np.random.default_rng(6), ndim=3,
                                       data_type="int32",
                                       data="random:-20,20"),
}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # results/ lands here


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_run_program_verifies_against_simulation(tmp_path, name):
    spec = PROGRAMS[name]()
    res = run_program(spec, device="cpu", run_simulation=True,
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert res.backend == "dense"
    assert res.verified_against_simulation is True
    assert res.verified_against_reference is True
    want = ref_driver.run_program(spec, run_simulation=True,
                                  skip_execution=True, save_results=False,
                                  log_level=0)
    assert res.simulation_cycles == want.simulation_cycles > 0


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_skip_execution_returns_the_simulators_outputs(tmp_path, name):
    spec = PROGRAMS[name]()
    res = run_program(spec, device="cpu", run_simulation=True,
                      skip_execution=True, compare_to_reference=True,
                      save_results=False, log_level=0)
    want = ref_driver.run_program(spec, run_simulation=True,
                                  skip_execution=True,
                                  compare_to_reference=True,
                                  save_results=False, log_level=0)
    assert res.backend == want.backend == "simulator"
    assert res.wall_time_s is None
    assert res.verified_against_simulation is None
    assert res.verified_against_reference is want.verified_against_reference
    assert res.simulation_cycles == want.simulation_cycles
    for o in want.outputs:
        np.testing.assert_array_equal(res.outputs[o], want.outputs[o])


def test_without_run_simulation_nothing_is_simulated(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("simulated without run_simulation")
    monkeypatch.setattr(port_sim, "simulate", boom)
    res = run_program(PROGRAMS["box"](), device="cpu", save_results=False,
                      log_level=0)
    assert res.simulation_cycles is None
    assert res.verified_against_simulation is None


def _wrong_simulator(monkeypatch, scale):
    real = port_sim.simulate

    def wrong(program, inputs, **kw):
        res = real(program, inputs, **kw)
        res.outputs = {o: v * scale for o, v in res.outputs.items()}
        return res
    monkeypatch.setattr(port_sim, "simulate", wrong)


def test_wrong_simulator_output_raises(monkeypatch):
    _wrong_simulator(monkeypatch, 1.5)
    with pytest.raises(VerificationError, match="simulation mismatch on "
                                                "output"):
        run_program(PROGRAMS["box"](), device="cpu", run_simulation=True,
                    save_results=False, log_level=0)


def test_wrong_simulator_output_without_raising(monkeypatch, capsys):
    _wrong_simulator(monkeypatch, 1.5)
    res = run_program(PROGRAMS["box"](), device="cpu", run_simulation=True,
                      compare_to_reference=True, raise_on_mismatch=False,
                      save_results=False, log_level=0)
    assert res.verified_against_simulation is False
    assert res.verified_against_reference is True
    assert "simulation mismatch on output" in capsys.readouterr().out


def test_simulation_tolerance_is_the_runs(monkeypatch):
    """The cross-check uses the run's rtol: a relative change of 2e-6 is
    within VERIFY_RTOL, and fails an explicit tolerance of 1e-7."""
    _wrong_simulator(monkeypatch, 1 + 2e-6)
    res = run_program(PROGRAMS["jacobi2d"](), device="cpu",
                      run_simulation=True, save_results=False, log_level=0)
    assert res.verified_against_simulation is True
    with pytest.raises(VerificationError):
        run_program(PROGRAMS["jacobi2d"](), device="cpu",
                    run_simulation=True, tolerance=1e-7,
                    save_results=False, log_level=0)


def test_halo_prunes_the_simulation_check(monkeypatch):
    """A difference confined to the outer shell passes with --halo 1."""
    real = port_sim.simulate

    def shell(program, inputs, **kw):
        res = real(program, inputs, **kw)
        for v in res.outputs.values():
            v[0] += 1.0
        return res
    monkeypatch.setattr(port_sim, "simulate", shell)
    spec = PROGRAMS["jacobi2d"]()
    res = run_program(spec, device="cpu", run_simulation=True, halo=1,
                      save_results=False, log_level=0)
    assert res.verified_against_simulation is True
    with pytest.raises(VerificationError):
        run_program(spec, device="cpu", run_simulation=True,
                    save_results=False, log_level=0)


# -- the command line ----------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--backend", "interpreter"],
                                   ["--no-mxu", "--backend", "stream"]],
                         ids=["auto", "interpreter", "stream"])
def test_cli_run_with_simulation(tmp_path, capsys, extra):
    prog = _write(tmp_path, PROGRAMS["box"]())
    assert main(["run", prog, "--device", "cpu", "--compare-to-reference",
                 "--run-simulation"] + extra) == 0
    out = capsys.readouterr().out
    assert ref_main(["run", prog, "--skip-execution",
                     "--run-simulation"]) == 0
    cycles = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("simulated cycles: ")]
    assert cycles and f"{cycles[0]}\n" in out
    assert "verified against reference: OK\n" in out
    assert "verified against simulation: OK\n" in out
    assert out.index("simulated cycles") < out.index("verified against "
                                                     "reference")


def test_cli_run_simulation_mismatch_exits_1(tmp_path, capsys, monkeypatch):
    _wrong_simulator(monkeypatch, 2.0)
    prog = _write(tmp_path, PROGRAMS["box"]())
    assert main(["run", prog, "--device", "cpu", "--run-simulation"]) == 1
    assert "VERIFICATION FAILED: simulation mismatch" in \
        capsys.readouterr().err


def test_cli_run_skip_execution_prints_the_jax_lines(tmp_path, capsys):
    prog = _write(tmp_path, PROGRAMS["hdiff"]())
    argv = ["run", prog, "--skip-execution", "--run-simulation",
            "--log-level", "0"]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def _sub_argvs(sub):
    for act in sub._actions:
        if not act.option_strings or act.dest == "help":
            continue
        opt = act.option_strings[-1]
        yield [opt] if act.nargs == 0 else [opt, "2" if act.type is int
                                            else "x"]


def _subparser(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


REF_SIMULATE = list(_sub_argvs(_subparser(ref_parser(), "simulate")))


@pytest.mark.parametrize("extra", REF_SIMULATE, ids=" ".join)
def test_simulate_parses_every_reference_argument(extra):
    want = ref_parser().parse_args(["simulate", "p.json"] + extra)
    got = build_parser().parse_args(["simulate", "p.json"] + extra)
    assert {k: v for k, v in vars(got).items() if k != "fn"} == \
        {k: v for k, v in vars(want).items() if k != "fn"}


def test_simulate_takes_no_device():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["simulate", "p.json", "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("engine", [[], ["--no-native"]],
                         ids=["native", "python"])
def test_cli_simulate_prints_the_jax_lines(tmp_path, capsys, name, engine):
    prog = _write(tmp_path, PROGRAMS[name]())
    argv = ["simulate", prog, "--seed", "3"] + engine
    assert ref_main(argv + ["--output-dir", str(tmp_path / "a")]) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--output-dir", str(tmp_path / "b")]) == 0
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "b"), "D") == \
        want.replace(str(tmp_path / "a"), "D")
    assert got.startswith("cycles: ")
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b"))
    for f in os.listdir(tmp_path / "a"):
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes()


@pytest.mark.parametrize("every", [1, 7])
def test_cli_traces_are_byte_equal(tmp_path, capsys, every):
    prog = _write(tmp_path, PROGRAMS["jacobi2d"]())
    files = {}
    for tag, fn in (("a", ref_main), ("b", main)):
        csv, chrome = tmp_path / f"{tag}.csv", tmp_path / f"{tag}.json"
        assert fn(["simulate", prog, "--trace", str(csv), "--trace-chrome",
                   str(chrome), "--trace-every", str(every)]) == 0
        files[tag] = (csv.read_bytes(), chrome.read_bytes())
        out = capsys.readouterr().out
        assert f"per-cycle trace written to {csv}" in out
        assert f"chrome trace written to {chrome}" in out
    assert files["a"] == files["b"]
    events = json.loads(files["b"][1])["traceEvents"]
    assert any(e["ph"] == "X" for e in events)


def test_cli_trace_chrome_alone_leaves_no_csv(tmp_path, capsys):
    """--trace-chrome without --trace: the CSV goes to a temporary
    directory that is removed; the trace equals the JAX CLI's."""
    prog = _write(tmp_path, PROGRAMS["box"]())
    assert ref_main(["simulate", prog, "--trace-chrome",
                     str(tmp_path / "a.json")]) == 0
    assert main(["simulate", prog, "--trace-chrome",
                 str(tmp_path / "b.json")]) == 0
    out = capsys.readouterr().out
    assert "per-cycle trace written" not in out
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["a.json", "b.json", "prog.json"]

"""Command-line interface of the port: the ``run``, ``simulate``,
``report``, ``iterate``, ``solve`` and ``adjoint`` subcommands.

    python -m stencilflow_tpu_torch.cli run <prog.json> [emulation|hardware] --compare-to-reference [--run-simulation] --device cuda
    python -m stencilflow_tpu_torch.cli simulate <prog.json> [--no-native] [--trace CSV] [--trace-chrome JSON] [--output-dir D]
    python -m stencilflow_tpu_torch.cli report <prog.json> [--json] [--verbose] [--optimize-ratio R]
    python -m stencilflow_tpu_torch.cli iterate <prog.json> --steps N [--fuse-steps F] [--host-chunks C] [--checkpoint-every E --checkpoint-dir D] [--device cuda]
    python -m stencilflow_tpu_torch.cli solve <prog.json> --rhs random:0,1 [--method cg|cgnr] [--tol T] [--device cuda]
    python -m stencilflow_tpu_torch.cli adjoint <prog.json> [-o adj.json] [--wrt a,b]

Port of the same subcommands of ``stencilflow_tpu/cli.py``: the JAX
package's own usage parses here too and prints the same lines.  Its
spellings map to the port's (``--no-mxu`` is ``--mxu off``, ``--backend
pallas`` is ``tile``, ``--backend xla`` is ``dense``, ``solve
--emulation`` is ``--device cpu``; the ``run`` mode is accepted and
ignored, as there); options whose engines are not ported yet exit with
``error:`` and rc 2, naming the ROADMAP item that ports them.  The
simulator (``run --run-simulation``, ``simulate``) runs on the host:
``simulate`` takes no ``--device``, and ``run`` keeps its device for the
kernels.  The other subcommands are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys

# option (as given) -> the ROADMAP item that ports it
NOT_PORTED = {
    "--ring-storage bfloat16": "Queue 1 item 11 (bf16)",
    "--mxu-precision bf16": "Queue 1 item 11 (bf16)",
    "--backend autotuned": "Queue 1 item 7 (M14, autotune)",
    "--plot": "Queue 1 item 10 (M15; the card's machine has no "
              "matplotlib)",
    "--mesh": "Queue 1 item 8 (M12, the mesh-scaling model with the "
              "sharded engine)",
    "--checkpoint-format orbax": "Queue 1 item 8 (M12, the sharded "
                                 "engine's asynchronous checkpoints; the "
                                 "card's machine has no orbax)",
}


def _refuse(option: str) -> int:
    print(f"error: {option} is not ported to stencilflow_tpu_torch yet "
          f"(ROADMAP {NOT_PORTED[option]})", file=sys.stderr)
    return 2


def _cmd_run(args) -> int:
    from .driver import BACKEND_ALIASES, VerificationError, run_program
    for given, option in ((args.ring_storage == "bfloat16",
                           "--ring-storage bfloat16"),
                          (args.mxu_precision == "bf16",
                           "--mxu-precision bf16"),
                          (args.backend == "autotuned",
                           "--backend autotuned")):
        if given:
            return _refuse(option)
    try:
        res = run_program(
            args.stencil_file, device=args.device,
            run_simulation=args.run_simulation,
            compare_to_reference=args.compare_to_reference,
            generate_input=args.generate_input,
            synthetic_reads=args.synthetic_reads,
            input_directory=args.input_directory,
            skip_execution=args.skip_execution,
            halo=args.halo, repetitions=args.repetitions,
            backend=BACKEND_ALIASES.get(args.backend, args.backend),
            print_result=args.print_result,
            log_level=args.log_level, profile_dir=args.profile,
            seed=args.seed, tolerance=args.tolerance,
            mxu="off" if args.no_mxu else args.mxu,
            mxu_precision=args.mxu_precision, host_chunks=args.host_chunks,
            spill="off" if args.no_spill else "auto")
    except VerificationError as exc:
        print(f"VERIFICATION FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"backend: {res.backend}")
    if res.wall_time_s is not None:
        from .report import Report
        rep = Report.build(res.program, analysis=res.analysis)
        gcell = res.program.total_elements / res.wall_time_s / 1e9
        clock = "CUDA events" if res.device.startswith("cuda") \
            else "host clock"
        moved = ("included" if res.backend.startswith("outofcore")
                 else "excluded")
        print(f"wall time: {res.wall_time_s * 1e3:.3f} ms/run on "
              f"{res.device} (~{gcell:.3g} GCell/s, {clock} over the "
              f"repetitions, transfers {moved}; roofline "
              f"{rep.roofline_gcell_s():.1f} GCell/s [{rep.hw.name}] — "
              f"python -m stencilflow_tpu_torch.bench times the device "
              f"loop)")
    if res.simulation_cycles is not None:
        print(f"simulated cycles: {res.simulation_cycles}")
    if res.verified_against_reference is not None:
        print("verified against reference: "
              f"{'OK' if res.verified_against_reference else 'FAIL'}")
    if res.verified_against_simulation is not None:
        print("verified against simulation: "
              f"{'OK' if res.verified_against_simulation else 'FAIL'}")
    if res.results_dir:
        print(f"results written to {res.results_dir}/")
    return 0


def _cmd_simulate(args) -> int:
    """Cycle-accurate dataflow simulation on the host (sim/)."""
    import os

    from .data import load_input_arrays, save_output_arrays
    from .frontend.parser import parse_program
    from .sim import simulate
    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    trace, tmp_dir = args.trace, None
    if args.trace_chrome and not trace:
        import tempfile
        tmp_dir = tempfile.mkdtemp(prefix="sft_trace_")
        trace = os.path.join(tmp_dir, "trace.csv")
    try:
        res = simulate(program, inputs, native=not args.no_native,
                       trace=trace)
        if args.trace:
            print(f"per-cycle trace written to {args.trace}")
        if args.trace_chrome:
            from .sim.trace import csv_to_chrome
            n = csv_to_chrome(trace, args.trace_chrome,
                              every=args.trace_every)
            print(f"chrome trace written to {args.trace_chrome} "
                  f"({n} events; open in Perfetto / chrome://tracing)")
    finally:
        if tmp_dir is not None:
            import shutil
            shutil.rmtree(tmp_dir, ignore_errors=True)
    print(f"cycles: {res.cycles} (elements: {program.total_elements})")
    for (src, dst), high in res.edge_high_water.items():
        mean = res.edge_mean_occupancy.get((src, dst))
        mean_s = f", mean occupancy {mean:.2f}" if mean is not None else ""
        print(f"  edge {src}->{dst}: high water {high}{mean_s}")
    for k, st in res.kernel_stats.items():
        print(f"  kernel {k}: first fire {st['first_fire']}, last fire "
              f"{st['last_fire']}, stalls {st['stall_cycles']}")
    if args.output_dir:
        save_output_arrays(res.outputs, args.output_dir)
        print(f"results written to {args.output_dir}/")
    return 0


def _cmd_report(args) -> int:
    from .frontend.analysis import ChainAnalysis
    from .frontend.parser import parse_program
    from .report import Report
    for given, option in ((args.plot, "--plot"), (args.mesh, "--mesh")):
        if given:
            return _refuse(option)
    program = parse_program(args.stencil_file)
    analysis = ChainAnalysis.run(program)
    report = Report.build(program, analysis)
    if args.json:
        print(json.dumps(report.as_dict(), indent=2, default=str))
    elif args.verbose:
        print(report.full_dump())
    else:
        print(report)
    if args.optimize_ratio is not None:
        from .optimizer import Optimizer
        opt = Optimizer(program, analysis)
        opt.optimize_to_ratio(args.optimize_ratio)
        print(f"\nmemory placement at slow/fast ratio "
              f"{args.optimize_ratio}:")
        print(opt.summary())
    return 0


def _cmd_iterate(args) -> int:
    """Time-step a chain with device-resident state and checkpoints."""
    from .data import load_input_arrays, save_output_arrays
    from .frontend.parser import parse_program
    from .iterate import iterate
    if args.checkpoint_format == "orbax":
        return _refuse("--checkpoint-format orbax")
    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    state = iterate(program, inputs, args.steps,
                    device=args.device,
                    chunk=args.chunk,
                    fuse=args.fuse_steps,
                    host_chunks=args.host_chunks,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_dir=args.checkpoint_dir,
                    resume=not args.no_resume)
    print(f"ran {args.steps} steps")
    if args.output_dir:
        save_output_arrays(state, args.output_dir)
        print(f"state written to {args.output_dir}/")
    return 0


def _cmd_solve(args) -> int:
    """Implicit solve: find x with fn(x) = rhs, the chain as matrix-free
    linear operator (CG / CGNR; out-of-core with --host-chunks)."""
    import numpy as np

    from .data import load_array, save_array
    from .frontend.parser import parse_program
    from .ir import InputSpec
    from .solve import make_solver
    program = parse_program(args.stencil_file)
    raw = tuple(program.raw_dimensions)
    dt = np.dtype(program.kernels[args.out or program.outputs[0]].dtype)
    if args.rhs.startswith(("constant:", "random:")):
        mask = (False,) * (3 - len(raw)) + (True,) * len(raw)
        rhs = load_array(InputSpec("rhs", dt, mask, args.rhs),
                         program.dimensions,
                         rng=np.random.default_rng(args.seed))
    else:
        rhs = np.fromfile(args.rhs, dt).reshape(raw)
    solver = make_solver(program, field=args.field, out=args.out,
                         method=args.method, tol=args.tol,
                         maxiter=args.maxiter,
                         device="cpu" if args.emulation else args.device,
                         host_chunks=args.host_chunks)
    x, info = solver(rhs)
    print(f"converged in {info['iterations']} iterations; "
          f"true relative residual {info['residual']:.3e}")
    if args.output:
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        save_array(x.reshape(raw), args.output)
        print(f"x written to {args.output}")
    return 0 if info["residual"] <= args.tol * 100 else 1


def _cmd_adjoint(args) -> int:
    """Transpose an affine chain into its adjoint program (grad.py) and
    emit it in the JSON dialect: the backward pass then runs through any
    lowering or CLI command like a forward chain."""
    from .frontend.export import program_to_json
    from .frontend.parser import parse_program
    from .grad import adjoint_program
    program = parse_program(args.stencil_file)
    wrt = ([w.strip() for w in args.wrt.split(",")] if args.wrt else None)
    adj, cot = adjoint_program(program, wrt)
    spec = program_to_json(adj)
    out = args.output or f"{program.name}_adjoint.json"
    with open(out, "w") as f:
        json.dump(spec, f, indent=2)
    print(f"wrote {out} (cotangent inputs: {cot}; "
          f"outputs: {adj.outputs})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .driver import BACKEND_ALIASES, BACKENDS
    ap = argparse.ArgumentParser(prog="stencilflow_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("run", help="run a program end to end")
    p.add_argument("stencil_file")
    p.add_argument("mode", nargs="?", default="emulation",
                   choices=["emulation", "hardware"],
                   help="accepted for the JAX package's usage; ignored")
    p.add_argument("--run-simulation", action="store_true",
                   help="also run the cycle-accurate dataflow simulator "
                        "on the host and check the outputs against it")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--compare-to-reference", action="store_true")
    p.add_argument("--input-directory")
    p.add_argument("--skip-execution", action="store_true")
    p.add_argument("--halo", type=int, default=0)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--backend", default="auto",
                   choices=list(BACKENDS) + list(BACKEND_ALIASES)
                   + ["autotuned"],
                   help="pallas = tile, xla = dense (the JAX package's "
                        "names); autotuned is not ported yet")
    p.add_argument("--tolerance", type=float, default=None,
                   help="relative verification tolerance (default: "
                        "config.VERIFY_RTOL, MXU_VERIFY_RTOL for a stream "
                        "run with banded stages)")
    p.add_argument("--mxu", default="auto", choices=["auto", "off"],
                   help="auto: wide affine stages run as banded transforms "
                        "on the stream lowering; off: per cell")
    p.add_argument("--no-mxu", action="store_true",
                   help="the JAX package's spelling of --mxu off")
    p.add_argument("--no-spill", action="store_true",
                   help="keep every stream ring in shared memory (no ring "
                        "spill to device memory when rings exceed it)")
    p.add_argument("--mxu-precision", default="split",
                   choices=["split", "exact", "bf16"],
                   help="band transform precision (split and exact both "
                        "compute in f32 on the card; bf16 is not ported "
                        "yet)")
    p.add_argument("--ring-storage", default="off",
                   choices=["off", "bfloat16"],
                   help="bfloat16 is not ported yet (exits with rc 2)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core: stream N host i-chunks (+ the "
                        "chain's i-halo) through the chunk kernel; "
                        "overrides --backend (default 0: in-core)")
    p.add_argument("--print-result", action="store_true")
    p.add_argument("--generate-input", action="store_true",
                   help="replace file-backed inputs with constant data")
    p.add_argument("--synthetic-reads", action="store_true",
                   help="replace ALL inputs with constants")
    p.add_argument("--log-level", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler chrome trace of the run")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("simulate", help="cycle-accurate dataflow simulation "
                                        "(on the host)")
    p.add_argument("stencil_file")
    p.add_argument("--input-directory")
    p.add_argument("--output-dir")
    p.add_argument("--no-native", action="store_true",
                   help="use the Python machine instead of the C++ core")
    p.add_argument("--trace", metavar="CSV",
                   help="write a per-cycle CSV (kernel PCs + FIFO "
                        "occupancies; uses the Python engine)")
    p.add_argument("--trace-chrome", metavar="JSON",
                   help="write a Chrome/Perfetto trace (counter tracks "
                        "per FIFO and kernel + activity spans; implies "
                        "the Python engine)")
    p.add_argument("--trace-every", type=int, default=1,
                   help="decimation for --trace-chrome counter samples "
                        "(change points always kept)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_simulate)

    p = sub.add_parser("report", help="analytic performance report on the "
                                      "H100 hardware model")
    p.add_argument("stencil_file")
    p.add_argument("--json", action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="full analysis dump (buffers, accesses, paths)")
    p.add_argument("--optimize-ratio", type=float, default=None,
                   help="also print the fast/slow placement at this ratio")
    p.add_argument("--plot", action="store_true",
                   help="not ported yet (exits with rc 2)")
    p.add_argument("--mesh", default=None,
                   help="not ported yet (exits with rc 2)")
    p.add_argument("--mesh-axes", default="none,x,y",
                   help="with --mesh (not ported yet)")
    p.add_argument("--comm-overlap", action="store_true",
                   help="with --mesh (not ported yet)")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("iterate",
                       help="time-step a chain with checkpoint/resume")
    p.add_argument("stencil_file")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--chunk", type=int, default=16,
                   help="steps a CUDA graph replays at once")
    p.add_argument("--fuse-steps", type=int, default=1,
                   help="compose this many time steps into one deeper "
                        "chain before compiling (multiplies arithmetic "
                        "intensity; steps must be a multiple)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core time-stepping: state stays in host "
                        "memory, each step streams the domain through "
                        "the device in N i-chunks (combine with "
                        "--fuse-steps to amortize host-device traffic)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=["npz", "orbax"],
                   help="npz: one host file per checkpoint; orbax is not "
                        "ported yet (exits with rc 2)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--output-dir")
    p.add_argument("--input-directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_iterate)

    p = sub.add_parser("solve",
                       help="implicit solve fn(x) = rhs with the chain "
                            "as matrix-free linear operator (CG/CGNR)")
    p.add_argument("stencil_file")
    p.add_argument("--rhs", required=True,
                   help=".dat file, constant:<v>, or random:<a>,<b>")
    p.add_argument("--method", default="cg", choices=["cg", "cgnr"])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--field", help="solve input (default: first input)")
    p.add_argument("--out", help="solve output (default: first output)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core solve: chunked operator sweeps, "
                        "host-resident CG vectors")
    p.add_argument("--emulation", action="store_true",
                   help="the JAX package's spelling of --device cpu")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("-o", "--output", help="write x to this .dat file")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_solve)

    p = sub.add_parser("adjoint",
                       help="transpose an affine chain into its adjoint "
                            "program (JSON dialect)")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output")
    p.add_argument("--wrt", help="comma-separated input names "
                                 "(default: all floating field inputs)")
    p.set_defaults(fn=_cmd_adjoint)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

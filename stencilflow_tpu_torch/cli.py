"""Command-line interface of the port: the ``run`` and ``report``
subcommands.

    python -m stencilflow_tpu_torch.cli run <prog.json> [emulation|hardware] --compare-to-reference --device cuda
    python -m stencilflow_tpu_torch.cli report <prog.json> [--json] [--verbose] [--optimize-ratio R]

Port of ``stencilflow_tpu/cli.py`` ``run`` and ``report``: the JAX
package's own usage parses here too.  Its spellings map to the port's
(``--no-mxu`` is ``--mxu off``, ``--backend pallas`` is ``tile``,
``--backend xla`` is ``dense``; the ``mode`` is accepted and ignored, as
there); options whose engines are not ported yet exit with ``error:``
and rc 2, naming the ROADMAP item that ports them.  The other
subcommands are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys

# option (as given) -> the ROADMAP item that ports it
NOT_PORTED = {
    "--run-simulation": "Queue 1 item 5 (M1, the simulator)",
    "--ring-storage bfloat16": "Queue 1 item 10 (bf16)",
    "--mxu-precision bf16": "Queue 1 item 10 (bf16)",
    "--backend autotuned": "Queue 1 item 6 (M14, autotune)",
    "--plot": "Queue 1 item 9 (M15; the card's machine has no matplotlib)",
    "--mesh": "Queue 1 item 7 (M12, the mesh-scaling model with the "
              "sharded engine)",
}


def _refuse(option: str) -> int:
    print(f"error: {option} is not ported to stencilflow_tpu_torch yet "
          f"(ROADMAP {NOT_PORTED[option]})", file=sys.stderr)
    return 2


def _cmd_run(args) -> int:
    from .driver import BACKEND_ALIASES, VerificationError, run_program
    for given, option in ((args.run_simulation, "--run-simulation"),
                          (args.ring_storage == "bfloat16",
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
    if res.verified_against_reference is not None:
        print("verified against reference: "
              f"{'OK' if res.verified_against_reference else 'FAIL'}")
    if res.results_dir:
        print(f"results written to {res.results_dir}/")
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
                   help="not ported yet (exits with rc 2)")
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

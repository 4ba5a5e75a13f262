"""Command-line interface of the port: the ``run`` subcommand.

    python -m stencilflow_tpu_torch.cli run <prog.json> --compare-to-reference --device cuda

Port of ``stencilflow_tpu/cli.py`` ``run``; the other subcommands are not
ported yet.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_run(args) -> int:
    from .driver import VerificationError, run_program
    try:
        res = run_program(
            args.stencil_file, device=args.device,
            compare_to_reference=args.compare_to_reference,
            generate_input=args.generate_input,
            synthetic_reads=args.synthetic_reads,
            input_directory=args.input_directory,
            skip_execution=args.skip_execution,
            halo=args.halo, repetitions=args.repetitions,
            backend=args.backend, print_result=args.print_result,
            log_level=args.log_level, profile_dir=args.profile,
            seed=args.seed, tolerance=args.tolerance, mxu=args.mxu,
            mxu_precision=args.mxu_precision, host_chunks=args.host_chunks,
            spill="off" if args.no_spill else "auto")
    except VerificationError as exc:
        print(f"VERIFICATION FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"backend: {res.backend}")
    if res.wall_time_s is not None:
        gcell = res.program.total_elements / res.wall_time_s / 1e9
        clock = "CUDA events" if res.device.startswith("cuda") \
            else "host clock"
        moved = ("included" if res.backend.startswith("outofcore")
                 else "excluded")
        print(f"wall time: {res.wall_time_s * 1e3:.3f} ms/run on "
              f"{res.device} (~{gcell:.3g} GCell/s, {clock} over the "
              f"repetitions, transfers {moved})")
    if res.verified_against_reference is not None:
        print("verified against reference: "
              f"{'OK' if res.verified_against_reference else 'FAIL'}")
    if res.results_dir:
        print(f"results written to {res.results_dir}/")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .driver import BACKENDS
    ap = argparse.ArgumentParser(prog="stencilflow_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("run", help="run a program end to end")
    p.add_argument("stencil_file")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--compare-to-reference", action="store_true")
    p.add_argument("--input-directory")
    p.add_argument("--skip-execution", action="store_true")
    p.add_argument("--halo", type=int, default=0)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--backend", default="auto", choices=list(BACKENDS))
    p.add_argument("--tolerance", type=float, default=None,
                   help="relative verification tolerance (default: "
                        "config.VERIFY_RTOL, MXU_VERIFY_RTOL for a stream "
                        "run with banded stages)")
    p.add_argument("--mxu", default="auto", choices=["auto", "off"],
                   help="auto: wide affine stages run as banded transforms "
                        "on the stream lowering; off: per cell")
    p.add_argument("--no-spill", action="store_true",
                   help="keep every stream ring in shared memory (no ring "
                        "spill to device memory when rings exceed it)")
    p.add_argument("--mxu-precision", default="split",
                   choices=["split", "exact"],
                   help="band transform precision (both compute in f32 "
                        "on the card)")
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

"""Command-line interface of the port: the ``run``, ``autotune``,
``simulate``, ``report``, ``iterate``, ``solve``, ``adjoint``,
``canonicalize``, ``import-sdfg``, ``compile``, ``synthesize``,
``partition`` and ``run-distributed`` subcommands.

    python -m stencilflow_tpu_torch.cli run <prog.json> [emulation|hardware] --compare-to-reference [--run-simulation] [--backend autotuned] --device cuda
    python -m stencilflow_tpu_torch.cli autotune <prog.json> [--no-sweep] [--trials N] [--cache F | --no-cache] [--json] [--device cuda | --emulation]
    python -m stencilflow_tpu_torch.cli simulate <prog.json> [--no-native] [--trace CSV] [--trace-chrome JSON] [--output-dir D]
    python -m stencilflow_tpu_torch.cli report <prog.json> [--json] [--verbose] [--optimize-ratio R] [--plot] [--mesh x=2,y=2 [--mesh-axes none,x,y] [--comm-overlap]]
    python -m stencilflow_tpu_torch.cli iterate <prog.json> --steps N [--fuse-steps F] [--host-chunks C] [--checkpoint-every E --checkpoint-dir D [--checkpoint-format npz|orbax]] [--device cuda]
    python -m stencilflow_tpu_torch.cli solve <prog.json> --rhs random:0,1 [--method cg|cgnr] [--tol T] [--device cuda]
    python -m stencilflow_tpu_torch.cli adjoint <prog.json> [-o adj.json] [--wrt a,b]
    python -m stencilflow_tpu_torch.cli canonicalize <prog.json> [-o out.json] [--symbols C=1.5,D=2] [--predicate-min-max]
    python -m stencilflow_tpu_torch.cli import-sdfg <prog.sdfg> [-o out.json] [--dimensions I,J,K] [--symbols I=128] [--input-data SPEC] [--vector-length V]
    python -m stencilflow_tpu_torch.cli compile <prog.json> [-o out.cu] [--emulation]
    python -m stencilflow_tpu_torch.cli synthesize [-o out.json] [--num-stages N] [--dimensions I J K] [--shape cross|box|diffusion|hotspot|hdiff]
    python -m stencilflow_tpu_torch.cli partition <prog.json> --devices N [--at K | --cut K,.. | --optimize] [--enumerate-cuts]
    python -m stencilflow_tpu_torch.cli run-distributed <prog.json> --devices N [--dim-axes none,x,y] [--force-host-devices] --compare-to-reference
    python -m stencilflow_tpu_torch.cli run-distributed <prog.json> --parallel-mode pipeline --devices N [--split-at K | --cut K,.. | --optimize-cuts] [--pipeline-domain j=N[,k=M]] [--num-chunks C]
    python -m stencilflow_tpu_torch.cli run-distributed <prog.json> --devices N --coordinator HOST:PORT --num-hosts H --host-id R [--force-host-devices] --compare-to-reference

Port of ``stencilflow_tpu/cli.py``: the JAX package's usage parses here
too and prints the same lines.  Its spellings map to the port's
(``--no-mxu`` is ``--mxu off``, ``--backend pallas`` is ``tile``,
``--backend xla`` is ``dense``, ``solve --emulation`` and ``autotune
--emulation`` are ``--device cpu``; the ``run`` mode is accepted and
ignored, as there).  The simulator (``run --run-simulation``,
``simulate``) runs on the host:
``simulate`` takes no ``--device``, and ``run`` keeps its device for the
kernels.  ``compile`` writes the port's artifact where the JAX package
writes StableHLO text: the CUDA C++ of the kernel ``compile_chain_best``
builds for the program on the card, then builds it with nvcc
(``--emulation``: the source only).  ``report --plot`` needs matplotlib
and exits with ``error:`` and rc 2 where it cannot be imported.
"""
from __future__ import annotations

import argparse
import json
import sys

def _cmd_run(args) -> int:
    from .driver import BACKEND_ALIASES, VerificationError, run_program
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
            spill="off" if args.no_spill else "auto",
            ring_storage=args.ring_storage)
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
              f"{rep.roofline_gcell_s(args.mxu_precision):.1f} GCell/s "
              f"[{rep.hw.name}] — "
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


def _cmd_autotune(args) -> int:
    """Time every applicable lowering on the device and cache the winner
    (``run --backend autotuned`` takes it)."""
    from .autotune import autotune, save_result
    from .frontend.parser import parse_program
    program = parse_program(args.stencil_file)
    device = "cpu" if args.emulation else args.device
    settings = dict(mxu="off" if args.no_mxu else "auto",
                    mxu_precision=args.mxu_precision,
                    spill="off" if args.no_spill else "auto")
    res = autotune(program, sweep=args.sweep, trials=args.trials,
                   seed=args.seed, device=device, verbose=not args.json,
                   allow_reduced_precision=args.allow_reduced_precision,
                   **settings)
    path = None
    if not args.no_cache:
        path = save_result(program, res, args.cache, device=device,
                           allow_reduced_precision=(
                               args.allow_reduced_precision), **settings)
    if args.json:
        print(json.dumps({
            "winner": res.label,
            "seconds_per_run": res.seconds,
            "gcell_s": program.total_elements / res.seconds / 1e9,
            "timings": res.timings,
            "skipped": res.skipped,
            "cache": path,
        }))
    else:
        for label, why in res.skipped.items():
            print(f"  {label:16s} skipped: {why.splitlines()[0][:60]}")
        gc = program.total_elements / res.seconds / 1e9
        print(f"winner: {res.label} ({res.seconds * 1e3:.3f} ms/run, "
              f"{gc:.2f} GCell/s)")
        if path:
            print(f"cached -> {path}")
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
    program = parse_program(args.stencil_file)
    analysis = ChainAnalysis.run(program)
    if args.plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError as exc:
            print(f"error: report --plot needs matplotlib, which cannot be "
                  f"imported ({exc})", file=sys.stderr)
            return 2
        from .utils import plot_chain_graph, plot_compute_graph
        print("wrote " + plot_chain_graph(program,
                                          f"{program.name}_chain.png"))
        for kname, kspec in program.kernels.items():
            print("wrote " + plot_compute_graph(
                kspec, f"{program.name}_{kname}_compute.png"))
    report = Report.build(program, analysis)
    mesh_scaling = None
    if args.mesh:
        mesh_dims = _parse_mesh(args.mesh)
        axes = _parse_axes(args.mesh_axes)
        if mesh_dims is None or axes is None:
            return 2
        mesh_scaling = report.mesh_scaling(mesh_dims, axes)
    if args.json:
        d = report.as_dict()
        if mesh_scaling:
            d["mesh_scaling"] = mesh_scaling
        print(json.dumps(d, indent=2, default=str))
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
    if mesh_scaling is not None and not args.json:
        s = mesh_scaling
        print(f"\nmesh scaling [{s['devices']} devices, "
              f"mesh {s['mesh']}, dims->axes {s['dim_axes']}]:")
        print(f"  local block {s['local_dims']}  "
              f"halo {s['halo']}  "
              f"NVLink {s['ici_bytes_per_device']/2**20:.2f} MiB/device")
        print(f"  step: compute {s['t_compute_s']*1e6:.1f} us + "
              f"NVLink {s['t_ici_s']*1e6:.1f} us = "
              f"{s['t_step_s']*1e6:.1f} us  "
              f"-> {s['scaled_gcell_s']:.1f} GCell/s, "
              f"efficiency {s['parallel_efficiency']:.2f}")
        if args.comm_overlap:
            o = s["comm_overlap"]
            print(f"  --comm-overlap: interior {o['t_interior_s']*1e6:.1f}"
                  f" us (hides {o['hidden_ici_s']*1e6:.1f} us of NVLink, "
                  f"{o['exposed_ici_s']*1e6:.1f} us exposed) + strips "
                  f"{o['t_strips_s']*1e6:.1f} us "
                  f"({o['strip_cells']/1e6:.2f} Mcell overcompute) = "
                  f"{o['t_step_s']*1e6:.1f} us -> "
                  f"{o['scaled_gcell_s']:.1f} GCell/s")
            be = o["break_even_ici_s"]
            print(f"  verdict: overlap "
                  f"{'WINS' if o['wins'] else 'loses'} at this topology "
                  f"(pays above {be*1e6:.1f} us exchange; modeled "
                  f"{s['t_ici_s']*1e6:.1f} us)")
    return 0


def _cmd_iterate(args) -> int:
    """Time-step a chain with device-resident state and checkpoints."""
    from .data import load_input_arrays, save_output_arrays
    from .frontend.parser import parse_program
    from .iterate import iterate
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
                    checkpoint_format=args.checkpoint_format,
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
    from .dtypes import to_numpy
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
        x = to_numpy(x)
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


def _cmd_canonicalize(args) -> int:
    """Canonicalization passes + JSON re-export — the analogue of
    bin/canonicalize_sdfg.py (cleanup) + bin/sdfg_to_stencilflow.py
    (dialect emission)."""
    from .frontend.canonicalize import canonicalize
    from .frontend.export import program_to_json
    from .frontend.parser import parse_program
    program = parse_program(args.stencil_file)
    constants = {}
    if args.symbols:
        for kv in args.symbols.split(","):
            k, v = kv.split("=")
            constants[k.strip()] = float(v)
    program = canonicalize(program, constants=constants or None,
                           min_max_to_select=args.predicate_min_max)
    spec = program_to_json(program)
    out = args.output or f"{program.name}_canonical.json"
    with open(out, "w") as f:
        json.dump(spec, f, indent=2)
    print(f"wrote {out} ({len(program.kernels)} kernels)")
    return 0


def _cmd_import_sdfg(args) -> int:
    """Serialized-DaCe-SDFG ingestion (bin/sdfg_to_stencilflow.py's import
    direction, without a dace dependency — .sdfg files are JSON)."""
    from .frontend.export import program_to_json
    from .frontend.sdfg_import import sdfg_to_program
    dims = ([int(x) for x in args.dimensions.split(",")]
            if args.dimensions else None)
    symbols = None
    if args.symbols:
        symbols = {}
        for part in args.symbols.split(","):
            name, sep, val = part.partition("=")
            try:
                v = float(val)
            except ValueError:
                sep = ""
            if not sep or not name.strip():
                print(f"bad --symbols entry {part!r} "
                      "(want NAME=NUMBER)", file=sys.stderr)
                return 2
            symbols[name.strip()] = int(v) if v == int(v) else v
    program = sdfg_to_program(args.sdfg_file, dimensions=dims,
                              input_data=args.input_data,
                              vectorization=args.vector_length,
                              symbols=symbols)
    spec = program_to_json(program)
    out = args.output or f"{program.name}.json"
    with open(out, "w") as f:
        json.dump(spec, f, indent=2)
    print(f"wrote {out} ({len(program.kernels)} kernels, "
          f"inputs {sorted(program.inputs)}, outputs {program.outputs})")
    return 0


def _cmd_compile(args) -> int:
    """Write the CUDA C++ of the kernel ``compile_chain_best(device=
    "cuda")`` builds for the program (routed by planning only) and build
    it with nvcc into ``_build/``; ``--emulation`` writes the source
    only."""
    import time

    from .backend import build, route_source
    from .frontend.parser import parse_program
    program = parse_program(args.stencil_file)
    backend, source, lib_name = route_source(program)
    out = args.output or f"{program.name}.cu"
    with open(out, "w") as f:
        f.write(source)
    print(f"lowered with backend '{backend}' -> {out} "
          f"({len(source.encode())} bytes)")
    if args.emulation:
        return 0
    t0 = time.perf_counter()
    built = len(build.build_log)
    build.load_library(source, lib_name)
    nvcc = (f"nvcc {build.build_log[-1][1]:.1f} s"
            if len(build.build_log) > built else "cached")
    print(f"built {build.library_path(source, lib_name)} ({nvcc}; "
          f"{time.perf_counter() - t0:.1f} s)")
    return 0


def _cmd_synthesize(args) -> int:
    from .synthesize import synthesize_stencil
    spec = synthesize_stencil(
        num_stages=args.num_stages,
        dimensions=tuple(args.dimensions),
        shape=args.shape,
        extent=args.extent,
        data_type=args.data_type,
        vectorization=args.vectorization,
        fork_frequency=args.fork_frequency,
        fork_length=args.fork_length,
        input_frequency=args.input_frequency,
        boundary=args.boundary,
    )
    text = json.dumps(spec, indent=2, default=str)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _cmd_partition(args) -> int:
    from .frontend.analysis import ChainAnalysis
    from .frontend.parser import parse_program
    from .parallel.pipeline import split_kernels
    program = parse_program(args.stencil_file)
    analysis = ChainAnalysis.run(program)
    graph = analysis.graph
    print(f"kernels (topological): {graph.kernel_order}")
    if args.at:
        from .parallel.pipeline import split_kernels_at
        segments = split_kernels_at(
            graph, [k.strip() for k in args.at.split(",")])
        if len(segments) != args.devices:
            print(f"note: {len(segments)} segments from --at; pass "
                  f"--devices {len(segments)} to run-distributed")
    elif args.cut:
        from .parallel.pipeline import split_kernels_at_cut
        segments = split_kernels_at_cut(
            graph, [k.strip() for k in args.cut.split(",")])
    elif args.optimize:
        from .parallel.pipeline import optimize_split
        segments, stats = optimize_split(program, graph, args.devices)
        print(f"optimized cuts: segment loads {stats['segment_loads']} "
              f"(weighted ops/cell), crossing "
              f"{stats['cut_bytes_per_cell']} B/cell per cut")
    else:
        segments = split_kernels(graph, args.devices)
    for i, seg in enumerate(segments):
        print(f"  device {i}: {seg}")
    if args.enumerate_cuts:
        print("all valid pipeline cuts (downward-closed subsets):")
        for cut in graph.enumerate_cuts():
            print(f"  {sorted(cut)}")
    return 0


def _pipeline_mesh(devices, n: int, spec: str):
    """The pipeline mode's mesh: ``("p",)`` over the devices, or with
    ``--pipeline-domain`` ("j=2" / "j=2,k=2") the named domain dims over
    extra axes of the given sizes and the pipeline over the rest.
    Returns (mesh, domain_axes), or None (after printing to stderr) on a
    malformed spec."""
    import numpy as np
    from .parallel.mesh import Mesh
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    if not spec:
        return Mesh(arr, ("p",)), None
    domain_axes, dshape, dnames = {}, [], []
    for part in spec.split(","):
        dim_name, _, size = part.partition("=")
        d = {"j": 1, "k": 2}.get(dim_name.strip())
        if d is None or not size.strip().isdigit():
            print(f"--pipeline-domain: expected 'j=N[,k=M]', got {spec!r}",
                  file=sys.stderr)
            return None
        ax = "x" if not dnames else "y"
        domain_axes[d] = ax
        dnames.append(ax)
        dshape.append(int(size.strip()))
    dn = int(np.prod(dshape))
    if n % dn:
        print(f"--devices {n} not divisible by the domain factor {dn}",
              file=sys.stderr)
        return None
    return Mesh(arr.reshape((n // dn, *dshape)), ("p", *dnames)), domain_axes


def _make_mesh_2d(devices, n):
    """Near-square 2-D ('x', 'y') mesh over n devices."""
    import numpy as np
    from .parallel.mesh import Mesh, mesh_shape_2d
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(mesh_shape_2d(n)), ("x", "y"))


def _parse_axes(text: str):
    """'none,x,y' -> (None, 'x', 'y'); exactly one entry per padded dim.
    Returns None (and prints to stderr) on malformed input."""
    axes = tuple(None if t.strip().lower() in ("none", "-") else t.strip()
                 for t in text.split(","))
    if len(axes) != 3:
        print(f"axis list needs 3 entries (i,j,k), got {len(axes)}",
              file=sys.stderr)
        return None
    return axes


def _parse_mesh(text: str):
    """'x=2,y=4' -> {'x': 2, 'y': 4}; None on malformed input."""
    mesh = {}
    for part in text.split(","):
        ax, sep, n = part.partition("=")
        if (not sep or not ax.strip() or not n.strip().isdigit()
                or int(n) < 1):
            print(f"bad --mesh entry {part!r} (want axis=N, N >= 1)",
                  file=sys.stderr)
            return None
        mesh[ax.strip()] = int(n)
    return mesh


def _multihost_checks(args) -> bool:
    """The multi-host launch's checks beyond the JAX package's, each
    before any rendezvous (a lone process would wait for its peers
    there); prints to stderr and returns False on the first that
    fails."""
    if args.num_hosts < 1 or not 0 <= args.host_id < args.num_hosts:
        print(f"--host-id {args.host_id} is not a rank of --num-hosts "
              f"{args.num_hosts}", file=sys.stderr)
        return False
    if args.devices % args.num_hosts:
        print(f"--devices {args.devices} not divisible by --num-hosts "
              f"{args.num_hosts}", file=sys.stderr)
        return False
    if args.pipeline_domain:
        print("--pipeline-domain does not run with --coordinator (the "
              "multi-host pipeline is a bare ('p',) mesh)", file=sys.stderr)
        return False
    return True


def _verify_local_shards(program, inputs, out, host) -> bool:
    """Each output shard this process holds against the oracle's block."""
    import numpy as np

    from .data import arrays_are_equal
    from .dtypes import to_numpy
    from .interpreter import run_interpreter
    ref = run_interpreter(program, inputs)
    ok = True
    for o in program.outputs:
        expected = np.asarray(ref[o]).reshape(program.raw_dimensions)
        arr = out[o]
        for c, t in arr.shards.items():
            idx = arr.block_slices(c)
            if not arrays_are_equal(expected[idx], to_numpy(t)):
                print(f"host {host}: MISMATCH on {o} shard {c}",
                      file=sys.stderr)
                ok = False
    print(f"host {host}: verified local shards: " + ("OK" if ok else "FAIL"))
    return ok


def _run_distributed_multihost(args, program, inputs, devices,
                               axes) -> int:
    """One process of a multi-host launch: join the gloo group, build the
    global mesh over every process's positions (this process's on
    ``devices``), run one sharded evaluation (domain mode, or the
    pipeline split over a ``("p",)`` mesh) and check the output shards
    this process holds against the oracle, as the JAX package's
    multi-host body does.  Besides its lines, each process prints its
    local body and the K4 launches it made."""
    import torch.distributed as dist

    from .backend import stream
    from .parallel.mesh import make_host_mesh, mesh_shape_2d
    from .parallel.transport import TRANSPORT, init_hosts
    host, n = args.host_id, args.devices
    init_hosts(args.coordinator, args.num_hosts, host)
    try:
        stream.launches_by.clear()
        if args.parallel_mode == "pipeline":
            from .parallel.pipeline import compile_pipeline_split
            mesh = make_host_mesh(devices, (n,), ("p",), host,
                                  args.num_hosts)
            fn, _plan = compile_pipeline_split(
                program, mesh, "p", num_chunks=args.num_chunks,
                split_at=([k.strip() for k in args.split_at.split(",")]
                          if args.split_at else None),
                cut=([k.strip() for k in args.cut.split(",")]
                     if args.cut else None),
                optimize_cuts=args.optimize_cuts)
            out = fn(inputs)
            cfg = fn.last_config
            body = (f"pipeline[{cfg['backend']} x{n} segments, "
                    f"{cfg['io']} io]")
            what = f"io={cfg['io']}, "
        else:
            from .parallel.domain import (compile_sharded_chain,
                                          run_sharded_chain)
            mesh = make_host_mesh(devices, mesh_shape_2d(n), ("x", "y"),
                                  host, args.num_hosts)
            out = run_sharded_chain(program, mesh, axes, inputs,
                                    as_numpy=False,
                                    comm_overlap=args.comm_overlap)
            cfg = compile_sharded_chain.last_config
            body = (f"sharded[{cfg['backend']}"
                    f"{', comm_overlap' if cfg['comm_overlap'] else ''}]")
            what = ""
        print(f"host {host}: backend: {body}, K4 launches "
              f"{sum(stream.launches_by.values())}")
        print(f"host {host}: ran {args.parallel_mode} over {n} global "
              f"devices (mesh {dict(mesh.shape)}, {what}"
              f"{len(mesh.local_coords())} local, exchange over "
              f"{TRANSPORT})", flush=True)
        rc = 0
        if args.compare_to_reference:
            rc = 0 if _verify_local_shards(program, inputs, out, host) else 1
        dist.barrier()
        return rc
    finally:
        dist.destroy_process_group()


def _cmd_run_distributed(args) -> int:
    """Domain decomposition (or, ``--parallel-mode pipeline``, the
    wavefront pipeline split) over ``--devices`` devices in one process:
    the CUDA devices, or with ``--force-host-devices`` that many virtual
    CPU positions (the reference's meaning).  With ``--coordinator``,
    ``--num-hosts`` and ``--host-id`` this is one process of a multi-host
    launch holding ``--devices // --num-hosts`` of the positions."""
    import numpy as np
    import torch

    from .data import arrays_are_equal, load_input_arrays
    from .frontend.parser import parse_program
    from .interpreter import run_interpreter
    from .parallel.domain import run_sharded_chain

    multihost = args.coordinator is not None
    if multihost and (args.num_hosts is None or args.host_id is None):
        print("--coordinator requires --num-hosts and --host-id",
              file=sys.stderr)
        return 2
    # misdirected flags are rejected before anything runs (and before any
    # rendezvous), as the reference's subcommand rejects them
    if args.parallel_mode == "pipeline" and args.dim_axes:
        print("--dim-axes applies to domain mode only", file=sys.stderr)
        return 2
    if args.parallel_mode == "pipeline" and args.comm_overlap:
        print("--comm-overlap applies to domain mode only",
              file=sys.stderr)
        return 2
    if args.parallel_mode == "domain" and (args.split_at or args.cut or
                                           args.optimize_cuts or
                                           args.pipeline_domain):
        print("--split-at/--cut/--optimize-cuts/--pipeline-domain apply "
              "to pipeline mode only (pass --parallel-mode pipeline)",
              file=sys.stderr)
        return 2
    if multihost and not _multihost_checks(args):
        return 2
    axes = (None, "x", "y")
    if args.parallel_mode == "domain" and args.dim_axes:
        axes = _parse_axes(args.dim_axes)
        if axes is None:
            return 2
        names = ("x", "y")
        bad = [a for a in axes if a and a not in names]
        if bad:
            from .parallel.mesh import mesh_shape_2d
            shape = dict(zip(names, mesh_shape_2d(args.devices)))
            print(f"unknown mesh axis {bad} (mesh has {list(shape)})",
                  file=sys.stderr)
            return 2
    local = args.devices // args.num_hosts if multihost else args.devices
    if args.force_host_devices:
        devices = [torch.device("cpu")] * local
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:local]
    if len(devices) < local:
        print(f"only {len(devices)} devices available", file=sys.stderr)
        return 2
    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    if multihost:
        return _run_distributed_multihost(args, program, inputs, devices,
                                          axes)
    if args.parallel_mode == "pipeline":
        from .parallel.pipeline import compile_pipeline_split
        got = _pipeline_mesh(devices, args.devices, args.pipeline_domain)
        if got is None:
            return 2
        mesh, domain_axes = got
        fn, _plan = compile_pipeline_split(
            program, mesh, "p", num_chunks=args.num_chunks,
            split_at=([k.strip() for k in args.split_at.split(",")]
                      if args.split_at else None),
            cut=([k.strip() for k in args.cut.split(",")]
                 if args.cut else None),
            optimize_cuts=args.optimize_cuts,
            domain_axes=domain_axes)
        outputs = {k: v.numpy() for k, v in fn(inputs).items()}
        cfg = fn.last_config
        print(f"backend: pipeline[{cfg['backend']} x{mesh.shape['p']} "
              f"segments, {cfg['io']} io]")
        if (cfg["backend"] == "xla" and not domain_axes
                and devices[0].type == "cuda"):
            # the rescue: some segment fits no K4 plan
            print("warning: a segment fits no K4 plan; every segment ran "
                  "the dense tile body on the card", file=sys.stderr)
    else:
        mesh = _make_mesh_2d(devices, args.devices)
        outputs = run_sharded_chain(program, mesh, axes, inputs,
                                    comm_overlap=args.comm_overlap)
    print(f"ran {args.parallel_mode} over {args.devices} devices "
          f"(mesh {dict(mesh.shape)})")

    if args.compare_to_reference:
        ref = run_interpreter(program, inputs)
        ok = True
        for o in program.outputs:
            if not arrays_are_equal(np.asarray(ref[o]), outputs[o]):
                print(f"MISMATCH on {o}", file=sys.stderr)
                ok = False
        print("verified against reference: " + ("OK" if ok else "FAIL"))
        return 0 if ok else 1
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
                   choices=list(BACKENDS) + list(BACKEND_ALIASES),
                   help="pallas = tile, xla = dense (the JAX package's "
                        "names); autotuned: the winner `autotune` cached "
                        "for this program and device (tuned on a miss)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="relative verification tolerance (default: "
                        "config.VERIFY_RTOL, MXU_VERIFY_RTOL for a stream "
                        "run with banded stages, BF16_VERIFY_RTOL under "
                        "--mxu-precision bf16 or --ring-storage bfloat16)")
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
                        "compute in f32 on the card; bf16: single-pass "
                        "bf16 passes, operands and bands rounded to bf16, "
                        "f32 sums; verified at BF16_VERIFY_RTOL)")
    p.add_argument("--ring-storage", default="off",
                   choices=["off", "bfloat16"],
                   help="bfloat16: the rings of --backend stream, panel or "
                        "rows hold bf16 (f32 compute, half the shared "
                        "memory; verified at BF16_VERIFY_RTOL)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core: stream N host i-chunks (+ the "
                        "chain's i-halo) through the chunk kernel; "
                        "overrides --backend and takes --mxu-precision "
                        "bf16 (default 0: in-core)")
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

    p = sub.add_parser("autotune",
                       help="time every applicable lowering on this "
                            "device and cache the winner for "
                            "`run --backend autotuned`")
    p.add_argument("stencil_file")
    p.add_argument("--sweep", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also time the explicit overlap / group block "
                        "sizes and the second rows group; --no-sweep "
                        "times the default candidates only")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to tune on (default: cuda)")
    p.add_argument("--emulation", action="store_true",
                   help="the JAX package's spelling of --device cpu")
    p.add_argument("--no-mxu", action="store_true")
    p.add_argument("--no-spill", action="store_true")
    p.add_argument("--mxu-precision", default="split",
                   choices=["split", "bf16", "exact"],
                   help="the stream candidates' band transform precision")
    p.add_argument("--allow-reduced-precision", action="store_true",
                   help="also time the bf16-ring candidates "
                        "(stream:rings=bf16, panel:rings=bf16); the cache "
                        "key carries the flag")
    p.add_argument("--cache", help="cache file (default: "
                                   "$SFT_AUTOTUNE_CACHE, else ~/.cache/"
                                   "stencilflow_tpu_torch/autotune.json)")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_autotune)

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
                   help="write chain/compute graph PNGs (needs matplotlib)")
    p.add_argument("--mesh", default=None,
                   help="project domain-decomposition scaling over a "
                        "device mesh, e.g. --mesh x=2,y=4 (the exchange "
                        "priced at the H100's NVLink data-sheet rate, "
                        "config.H100_NVLINK_BANDWIDTH)")
    p.add_argument("--mesh-axes", default="none,x,y",
                   help="mesh axis sharding each padded dim (i,j,k); "
                        "'none' leaves a dim unsharded")
    p.add_argument("--comm-overlap", action="store_true",
                   help="with --mesh: print the comm/compute-overlap "
                        "tradeoff (hidden exchange vs strip overcompute) "
                        "and the per-topology break-even")
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
                   help="npz: one host file per checkpoint; orbax (the "
                        "JAX package's name): one directory per step, "
                        "each shard saved asynchronously in "
                        "torch.distributed.checkpoint's format (neither "
                        "package reads the other's)")
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

    p = sub.add_parser("canonicalize",
                       help="cleanup passes + JSON dialect re-export")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output")
    p.add_argument("--symbols", help='e.g. "C=1.5,D=2"')
    p.add_argument("--predicate-min-max", action="store_true")
    p.set_defaults(fn=_cmd_canonicalize)

    p = sub.add_parser("import-sdfg",
                       help="ingest a serialized DaCe SDFG with Stencil "
                            "library nodes into the JSON dialect "
                            "(no dace dependency)")
    p.add_argument("sdfg_file")
    p.add_argument("-o", "--output")
    p.add_argument("--dimensions",
                   help="override domain dims, e.g. '64,64,64' (required "
                        "when the SDFG shapes are symbolic)")
    p.add_argument("--input-data", default="constant:1.0",
                   help="data spec for imported inputs (reference: "
                        "-data-directory; default constant:1.0)")
    p.add_argument("--vector-length", type=int, default=1)
    p.add_argument("--symbols",
                   help="specialize free SDFG symbols, e.g. 'I=128,J=64'"
                        " (the reference's bin/canonicalize_sdfg.py "
                        "-symbols; seeds the interstate-edge symbol "
                        "environment)")
    p.set_defaults(fn=_cmd_import_sdfg)

    p = sub.add_parser("compile",
                       help="write the CUDA C++ of the program's route "
                            "and build it with nvcc")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output", help="source file (default: "
                                          "<name>.cu)")
    p.add_argument("--emulation", action="store_true",
                   help="write the source only (no nvcc, no card)")
    p.set_defaults(fn=_cmd_compile)

    p = sub.add_parser("synthesize", help="generate a benchmark program")
    p.add_argument("-o", "--output")
    p.add_argument("--num-stages", type=int, default=4)
    p.add_argument("--dimensions", type=int, nargs="+",
                   default=[64, 64, 64])
    p.add_argument("--shape", default="cross",
                   choices=["cross", "box", "diffusion", "hotspot",
                            "hdiff"])
    p.add_argument("--extent", type=int, default=1)
    p.add_argument("--data-type", default="float32")
    p.add_argument("--vectorization", type=int, default=1)
    p.add_argument("--fork-frequency", type=int, default=0)
    p.add_argument("--fork-length", type=int, default=1)
    p.add_argument("--input-frequency", type=int, default=0)
    p.add_argument("--boundary", default="constant")
    p.set_defaults(fn=_cmd_synthesize)

    p = sub.add_parser("partition",
                       help="plan a pipeline split across devices")
    p.add_argument("stencil_file")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--at", default=None,
                   help="comma-separated kernel names to cut after "
                        "(named-stream split) instead of auto-balancing")
    p.add_argument("--cut", default=None,
                   help="comma-separated kernel names forming one "
                        "downward-closed cut set (may be non-prefix on "
                        "forked chains; see --enumerate-cuts)")
    p.add_argument("--optimize", action="store_true",
                   help="search cuts minimizing the bottleneck segment "
                        "load (H100 op costs), tie-breaking on "
                        "inter-device traffic")
    p.add_argument("--enumerate-cuts", action="store_true")
    p.set_defaults(fn=_cmd_partition)

    p = sub.add_parser("run-distributed",
                       help="multi-device run (domain or pipeline split)")
    p.add_argument("stencil_file")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--parallel-mode", default="domain",
                   choices=["domain", "pipeline"])
    p.add_argument("--num-chunks", type=int, default=None,
                   help="pipeline mode's microbatches (domain mode "
                        "ignores it, as the JAX package does)")
    p.add_argument("--split-at", default=None,
                   help="pipeline mode: comma-separated kernel names to "
                        "cut after (the reference's split at a named "
                        "stream); cuts+1 must equal --devices")
    p.add_argument("--cut", default=None,
                   help="pipeline mode (2 devices): comma-separated "
                        "kernel names forming a downward-closed cut set "
                        "(any 'partition --enumerate-cuts' member, "
                        "non-prefix fork cuts included)")
    p.add_argument("--optimize-cuts", action="store_true",
                   help="pipeline mode: search cuts minimizing the "
                        "bottleneck segment load")
    p.add_argument("--pipeline-domain", default=None, metavar="SPEC",
                   help="pipeline mode: ALSO shard the domain over extra "
                        "mesh axes, e.g. 'j=4' or 'j=2,k=2'; --devices "
                        "must be divisible by the product")
    p.add_argument("--dim-axes", default=None,
                   help="domain mode: mesh axis per padded dim (i,j,k), "
                        "e.g. 'x,y,none' to shard (i, j); default "
                        "'none,x,y'")
    p.add_argument("--compare-to-reference", action="store_true")
    p.add_argument("--input-directory")
    p.add_argument("--force-host-devices", action="store_true",
                   help="simulate the mesh with virtual CPU devices")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: the rendezvous of the "
                        "torch.distributed process group (gloo; slabs "
                        "staged through host buffers)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="multi-host: processes in the launch; each holds "
                        "--devices / --num-hosts positions")
    p.add_argument("--host-id", type=int, default=None,
                   help="multi-host: this process's rank (0-based)")
    p.add_argument("--comm-overlap", action="store_true",
                   help="domain mode: compute each shard's interior while "
                        "the halo exchange runs on a side stream")
    p.set_defaults(fn=_cmd_run_distributed)
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

"""End-to-end driver: parse → analyse → (simulate) → compile → execute
→ verify → save.

Port of ``stencilflow_tpu/driver.py`` ``run_program`` for one device:
the same flow, flags and verification (the numpy oracle and, with
``run_simulation``, the cycle-accurate dataflow simulator run on the
host (``sim/``), both at ``VERIFY_RTOL`` after optional halo pruning),
with the lowering chosen by ``backend.compile_chain_best`` for a torch
``device``; a run whose stream lowering has banded stages verifies at
``MXU_VERIFY_RTOL``, as the JAX package's driver does.  ``spill``
("auto"/"off") is the stream kernel's ring spill to device memory
(K3c), as ``spill`` is in the JAX package.  The opt-in reduced
precisions verify at ``BF16_VERIFY_RTOL``, as there: a stream run with
banded stages under ``mxu_precision="bf16"`` (single-pass bf16 band
transforms), and ``ring_storage="bfloat16"`` (bf16 rings, f32 compute;
``stream``, ``panel`` and ``rows`` only, ``rows`` then taking
rows+stream) or an autotuned ``:rings=bf16`` winner.  ``backend="rows"``
streams a 2-D program's rows (``compile_chain_rows``, the auto lowering
of the rotated program), as ``--backend rows`` does in the JAX package;
``backend="tile"`` forces the overlapped-tile kernel (K6), the JAX
package's ``pallas``; its ``xla`` is ``dense`` here.
``backend="autotuned"`` takes the lowering ``autotune.py`` measured
fastest for this program on this device (cached; tuned on a miss), named
``autotuned:<label>``.  ``host_chunks=N``
(N > 1) runs out-of-core (``outofcore.py``): inputs stay on the host and
i-chunks stream through the chunk kernel K4 (``outofcore[stream xN
chunks]``) or, on the CPU or where K4's planner refuses, the dense tile
body (``outofcore[dense xN chunks]``); it overrides ``backend``, and its
time includes the host-device transfers.  With ``mxu_precision="bf16"``
the chunks run K4's single-pass bf16 band passes (its plain version on
the CPU) and verify at ``BF16_VERIFY_RTOL``; the dense body refuses the
request, and ``ring_storage`` does not reach the chunks (refused).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import ir
from .backend import (compile_chain, compile_chain_best,
                      compile_chain_rows)
from .backend.overlap import compile_chain_overlap
from .backend.panel import compile_chain_panel
from .backend.stream import compile_chain_stream
from .backend.tile import compile_chain_tile
from .config import BF16_VERIFY_RTOL, MXU_VERIFY_RTOL, VERIFY_RTOL
from .data import (arrays_are_equal, load_input_arrays, prune_halo,
                   save_output_arrays)
from .dtypes import cast, to_numpy, to_torch
from .frontend.analysis import ChainAnalysis
from .frontend.parser import parse_program
from .interpreter import run_interpreter

BACKENDS = ("auto", "autotuned", "stream", "rows", "panel", "overlap",
            "tile", "dense", "interpreter")
# the JAX package's names for the port's lowerings (its ``--backend``)
BACKEND_ALIASES = {"pallas": "tile", "xla": "dense"}


class VerificationError(RuntimeError):
    pass


@dataclasses.dataclass
class RunResult:
    program: ir.Program
    outputs: Dict[str, np.ndarray]
    backend: str
    device: str = "cpu"
    verified_against_reference: Optional[bool] = None
    verified_against_simulation: Optional[bool] = None
    simulation_cycles: Optional[int] = None
    wall_time_s: Optional[float] = None
    results_dir: Optional[str] = None
    analysis: Optional[ChainAnalysis] = None
    # out of core: host seconds of the last call's slab fill and drain
    host_staging: Optional[Dict[str, float]] = None


def _compile(program, analysis, backend: str, device, mxu, mxu_precision,
             spill, ring_storage="off"):
    if backend == "auto":
        return compile_chain_best(program, analysis, device=device, mxu=mxu,
                                  mxu_precision=mxu_precision, spill=spill)
    if backend == "autotuned":
        # the measured winner, from the cache or tuned now on ``device``
        from .autotune import compile_chain_autotuned
        fn, label = compile_chain_autotuned(program, analysis, device=device,
                                            mxu=mxu,
                                            mxu_precision=mxu_precision,
                                            spill=spill)
        return fn, f"autotuned:{label}"
    if backend == "stream":
        return (compile_chain_stream(program, analysis, mxu=mxu,
                                     mxu_precision=mxu_precision,
                                     device=device, spill=spill,
                                     ring_storage=ring_storage), "stream")
    if backend == "rows":
        return compile_chain_rows(
            program, "stream" if ring_storage != "off" else "auto",
            device=device, mxu=mxu, mxu_precision=mxu_precision,
            spill=spill, ring_storage=ring_storage)
    if backend == "tile":
        return compile_chain_tile(program, analysis, device=device), "tile"
    if backend == "panel":
        return (compile_chain_panel(program, analysis, device=device,
                                    ring_storage=ring_storage), "panel")
    if backend == "overlap":
        return (compile_chain_overlap(program, analysis, device=device),
                "overlap")
    if backend == "dense":
        return compile_chain(program, analysis), "dense"
    if backend == "interpreter":
        def oracle(xs):
            host = {k: to_numpy(v) if torch.is_tensor(v) else v
                    for k, v in xs.items()}
            return {k: to_torch(v) for k, v in
                    run_interpreter(program, host).items()}
        return oracle, "interpreter"
    raise ValueError(f"unknown backend: {backend} (choose from {BACKENDS})")


def _write_profile(prof, profile_dir: str, window_s: float,
                   cuda: bool) -> None:
    """Chrome trace plus a summary: time by kernel and, on a CUDA device,
    the device's busy share of the timed window (device time / window
    time)."""
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    events = prof.key_averages()
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(profile_dir, "summary.txt"), "w") as f:
        f.write(events.table(sort_by=sort, row_limit=15))
        if cuda:
            dev_us = sum(e.self_device_time_total for e in events)
            f.write(f"\ndevice time {dev_us / 1e3:.3f} ms of a "
                    f"{window_s * 1e3:.3f} ms window: busy share "
                    f"{dev_us / 1e6 / window_s:.3f}\n")
    print(f"profile written to {profile_dir}/ (trace.json, summary.txt)")


def run_program(stencil_file, device="cuda",
                run_simulation: bool = False,
                compare_to_reference: bool = False,
                generate_input: bool = False,
                synthetic_reads: bool = False,
                input_directory: Optional[str] = None,
                skip_execution: bool = False,
                halo: int = 0,
                repetitions: int = 1,
                backend: str = "auto",
                save_results: bool = True,
                results_base: str = "results",
                seed: int = 0,
                print_result: bool = False,
                log_level: int = 1,
                profile_dir: Optional[str] = None,
                raise_on_mismatch: bool = True,
                tolerance: Optional[float] = None,
                mxu: str = "auto",
                mxu_precision: str = "split",
                host_chunks: int = 0,
                spill: str = "auto",
                ring_storage: str = "off") -> RunResult:
    """Run one stencil program end to end on ``device``.  ``stencil_file``
    may be a path, a JSON dict, or an already-parsed Program.
    ``run_simulation`` runs the dataflow simulator on the host inputs
    first and checks the outputs against it (with ``skip_execution``, its
    outputs are the result, backend ``"simulator"``).
    ``tolerance`` overrides the relative verification tolerance (default:
    config.VERIFY_RTOL, or MXU_VERIFY_RTOL for a stream run with banded
    stages; BF16_VERIFY_RTOL under the reduced precisions below).
    ``mxu`` ("auto"/"off"), ``mxu_precision`` ("split"/"exact"/"bf16")
    and ``spill`` ("auto"/"off") forward to the stream lowering;
    ``ring_storage`` ("off"/"bfloat16") to the stream, panel and rows
    lowerings, and any other backend refuses it.  ``host_chunks`` > 1
    runs out-of-core in that many i-chunks (overrides ``backend``; the
    timing includes the transfers; ``mxu_precision`` reaches the chunk
    kernel, ``ring_storage`` is refused there)."""
    if ring_storage != "off" and backend not in ("stream", "panel",
                                                 "rows"):
        raise ValueError(
            "--ring-storage requires --backend stream, panel, or rows "
            "(other backends have no ring state; refusing to widen "
            "verification for an f32 run)")
    if host_chunks and host_chunks > 1 and ring_storage != "off":
        raise ValueError("--ring-storage does not reach the chunk kernel: "
                         "the JAX package's driver never passes it there "
                         "(its chunks keep f32 rings); refusing to widen "
                         "verification for an f32 run")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU")
    program = stencil_file if isinstance(stencil_file, ir.Program) \
        else parse_program(stencil_file)
    analysis = ChainAnalysis.run(program)
    if log_level >= 1:
        print(f"[{program.name}] {len(program.kernels)} kernels, "
              f"dims {list(program.raw_dimensions)}, "
              f"critical path {analysis.critical_path_cycles} cycles")
    if generate_input or synthetic_reads:
        # generate_input: constant data for file-backed inputs;
        # synthetic_reads: constant data for every input
        new_inputs = dict(program.inputs)
        for name, spec in program.inputs.items():
            file_backed = (isinstance(spec.data, str) and
                           not spec.data.startswith(("constant:",
                                                     "random:")))
            if synthetic_reads or file_backed:
                new_inputs[name] = dataclasses.replace(
                    spec, data="constant:1.0")
        program = dataclasses.replace(program, inputs=new_inputs)
    inputs = load_input_arrays(program, prefix=input_directory, seed=seed)

    sim_outputs = None
    sim_cycles = None
    if run_simulation:
        from .sim import simulate
        sim_res = simulate(program, inputs, analysis=analysis)
        sim_outputs = sim_res.outputs
        sim_cycles = sim_res.cycles

    result = RunResult(program=program, outputs={}, backend="none",
                       device=str(device), simulation_cycles=sim_cycles,
                       analysis=analysis)
    banded = False

    if skip_execution:
        if sim_outputs is not None:
            result.outputs = sim_outputs
            result.backend = "simulator"
    else:
        if host_chunks and host_chunks > 1:
            # out-of-core: inputs stay host-resident, i-chunks stream
            # through one built chunk kernel into host outputs allocated
            # once for every repetition (outofcore.py)
            from .outofcore import compile_chunked_chain, run_chunked
            compiled = compile_chunked_chain(
                program, host_chunks, analysis, device=device, mxu=mxu,
                mxu_precision=mxu_precision, spill=spill)
            host_out = {o: np.empty(tuple(program.raw_dimensions),
                                    np.dtype(program.kernels[o].dtype))
                        for o in program.outputs}
            result.host_staging = {}
            fn = functools.partial(run_chunked, program, chunks=host_chunks,
                                   analysis=analysis, compiled=compiled,
                                   out=host_out, stats=result.host_staging)
            banded = bool(compiled[1].config.get("mxu_stages"))
            result.backend = (f"outofcore[{compiled[1].backend}"
                              f" x{host_chunks} chunks]")
            dev_inputs = inputs
        else:
            fn, result.backend = _compile(program, analysis, backend,
                                          device, mxu, mxu_precision, spill,
                                          ring_storage)
            banded = bool(getattr(fn, "last_config", {}).get("mxu_stages"))
            dev_inputs = {k: (to_torch(v, device)
                              if not program.inputs[k].is_scalar else v)
                          for k, v in inputs.items()}
        fn(dev_inputs)   # warm-up: first-call work stays out of the timing
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        prof = contextlib.nullcontext()
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        reps = max(1, repetitions)
        with prof:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    out = fn(dev_inputs)
                stop.record()
                torch.cuda.synchronize(device)
                result.wall_time_s = start.elapsed_time(stop) / 1e3 / reps
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = fn(dev_inputs)
                result.wall_time_s = (time.perf_counter() - t0) / reps
        if profile_dir:
            _write_profile(prof, profile_dir, result.wall_time_s * reps,
                           cuda)
        result.outputs = {k: v if isinstance(v, np.ndarray)
                          else to_numpy(v) for k, v in out.items()}

    if save_results and result.outputs:
        result.results_dir = os.path.join(results_base, program.name)
        save_output_arrays(result.outputs, result.results_dir)

    raw = program.raw_dimensions
    rtol = tolerance if tolerance is not None else VERIFY_RTOL
    if tolerance is None and banded:
        # banded transforms re-associate f32 sums: the JAX package's
        # driver verifies such runs at this envelope, and single-pass
        # bf16 transforms at the bf16 one
        rtol = BF16_VERIFY_RTOL if mxu_precision == "bf16" \
            else MXU_VERIFY_RTOL
    if tolerance is None and (ring_storage == "bfloat16"
                              or ":rings=bf16" in result.backend):
        # bf16 rings round each stage's output once: about one bf16 ulp
        # a stage (an autotuned reduced-precision winner too)
        rtol = max(rtol, BF16_VERIFY_RTOL)

    def check(kind: str, expected) -> bool:
        ok = True
        for o in program.outputs:
            got = prune_halo(result.outputs[o], raw, halo)
            exp = prune_halo(np.asarray(expected[o]), raw, halo)
            if not arrays_are_equal(exp, got, rtol):
                ok = False
                diff = np.max(np.abs(cast(exp, np.float64) -
                                     cast(got, np.float64)))
                msg = (f"{kind} mismatch on output '{o}' "
                       f"(max abs diff {diff:.3e}, halo={halo})")
                if raise_on_mismatch:
                    raise VerificationError(msg)
                print(msg)
        return ok

    if compare_to_reference and result.outputs:
        result.verified_against_reference = check(
            "reference", run_interpreter(program, inputs))
    if sim_outputs is not None and result.outputs and not skip_execution:
        result.verified_against_simulation = check("simulation",
                                                   sim_outputs)

    if print_result:
        for o, arr in result.outputs.items():
            print(f"{o} =\n{arr}")
    return result

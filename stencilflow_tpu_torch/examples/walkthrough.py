"""End-to-end walkthrough of the port's surfaces: parse -> report ->
oracle -> simulate -> compile -> optimize -> trace -> mesh scaling ->
iterate -> grad -> out-of-core -> autotune.

Port of ``examples/walkthrough.py`` on ``device`` (the card by default;
``--device cpu`` takes the plain versions).  Step 8 projects the 2 x 2
mesh's scaling with the exchange over NVLink (``Report.mesh_scaling``,
at the data sheet's rate).

    python -m stencilflow_tpu_torch.examples.walkthrough [--device cpu]
"""
import json
import os

import numpy as np

import stencilflow_tpu_torch as sft
from stencilflow_tpu_torch.backend import compile_chain_best
from stencilflow_tpu_torch.examples import EXAMPLES_DIR
from stencilflow_tpu_torch.optimizer import Optimizer
from stencilflow_tpu_torch.report import Report
from stencilflow_tpu_torch.sim import simulate


def main(device="cuda", size=None):
    """``size`` cuts every dimension of the example program to at most
    ``size`` (default: its own 32³)."""
    # 1. parse a program from the JSON dialect
    spec = json.load(open(os.path.join(EXAMPLES_DIR,
                                       "jacobi3d_32x32x32_8itr.json")))
    if size:
        spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    program = sft.parse_program(spec, name="jacobi3d_32x32x32_8itr")
    inputs = sft.load_input_arrays(program, seed=0)

    # 2. static analysis + analytic report (the H100 model)
    print(Report.build(program), "\n")

    # 3. the whole-domain oracle
    oracle = sft.run_interpreter(program, inputs)

    # 4. cycle-accurate dataflow simulation (C++ core), proving buffer sizes
    res = simulate(program, inputs)
    out_name = program.outputs[0]
    assert np.array_equal(res.outputs[out_name], np.asarray(oracle[out_name]))
    print(f"simulated {res.cycles} cycles for {program.total_elements} "
          "elements; buffer bounds held\n")

    # 5. the compiled path (the route's CUDA kernel on the card, the dense
    #    torch lowering on the CPU)
    fn, backend = compile_chain_best(program, device=device)
    out = fn(inputs)
    err = np.abs(out[out_name].cpu().numpy() -
                 np.asarray(oracle[out_name])).max()
    print(f"backend '{backend}': max abs error vs oracle = {err}\n")

    # 6. memory placement under a shared-memory budget
    opt = Optimizer(program)
    opt.optimize_to_ratio(1.0)
    print(opt.summary())

    # 7. the traced-Python frontend
    def model(a):
        b = 0.25 * (a[0, -1, 0] + a[0, 1, 0] + a[0, 0, -1] + a[0, 0, 1])
        return {"b": b}

    traced = sft.trace_program(model, dimensions=(64, 64),
                               inputs={"a": np.float32}, name="traced_demo")
    print(f"\ntraced program: kernels={list(traced.kernels)}")

    # 8. projected multi-card scaling (halo exchange over NVLink vs
    #    compute)
    s = Report.build(program).mesh_scaling({"x": 2, "y": 2})
    print(f"\n2x2 mesh: {s['scaled_gcell_s']:.1f} GCell/s projected, "
          f"efficiency {s['parallel_efficiency']:.2f} "
          f"(NVLink {s['ici_bytes_per_device']/2**10:.0f} KiB/device/step)")

    # 9. time-stepping with temporal fusion (iterate.py; add
    #    checkpoint_every/checkpoint_dir for crash-resumable runs)
    stats = {}
    state = sft.iterate(program, inputs, steps=8, fuse=4, device=device,
                        stats=stats)
    total = float(np.asarray(state["a"]).sum())
    print(f"iterated 8 steps (fuse=4, {stats['backend']}): state "
          f"sum={total:.3f}")

    # 10. adjoints: gradient of a loss on the outputs w.r.t. any input
    val, grads = sft.value_and_grad(program, device=device)(
        {k: np.asarray(v) for k, v in inputs.items()})
    c = tuple(d // 2 for d in program.raw_dimensions)
    print(f"d(sum outputs)/d a: interior value "
          f"{float(grads['a'].cpu()[c]):.3f} (exact 1.0)")

    # 11. out-of-core: domains larger than device memory stream in
    #     i-chunks from host arrays/memmaps (run/iterate/solve/grad all
    #     take host_chunks=; report suggests the chunk count)
    compiled = sft.compile_chunked_chain(program, 2, device=device)
    oc = sft.run_chunked(program, inputs, 2, compiled=compiled)
    err = float(np.abs(oc[program.outputs[0]]
                       - np.asarray(oracle[program.outputs[0]])).max())
    print(f"out-of-core 2-chunk sweep ({compiled[1].backend} body): max abs "
          f"error vs oracle = {err}")

    # 12. measured backend selection: time every applicable lowering on
    #     the device, cache the winner (run --backend autotuned)
    from stencilflow_tpu_torch.autotune import autotune
    res = autotune(program, device=device, trials=1)
    print(f"autotune winner: {res.label} "
          f"({res.seconds * 1e3:.2f} ms/run; "
          f"{len(res.timings)} candidates timed)")
    return [backend, stats["backend"], f"outofcore[{compiled[1].backend}]"]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

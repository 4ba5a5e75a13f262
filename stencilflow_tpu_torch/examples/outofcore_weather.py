"""Out-of-core time-stepping: a domain that never fits device memory.

A COSMO-style horizontal-diffusion block (hdiff: lap -> flux-limited
flx/fly -> out) is time-stepped over a domain held in memory-mapped host
files.  Nothing but one i-chunk (+ halo) is ever resident on the device,
and with ``fuse`` > 1 each host<->device sweep advances several steps:

    state (np.memmap) --chunk0+halo--> [device: fused F-step chain] --+
          ^                                                           |
          +--------------------- chunk outputs <----------------------+

At production scale the same script time-steps a 2048 x 4096 x 4096 grid
(128 GiB per field, past the H100's 80 GB) by raising ``size``; `report`
prints the footprint and the suggested chunk count:

    python -m stencilflow_tpu_torch.cli report <program.json>

Port of ``examples/outofcore_weather.py``: each chunk runs K4, the stream
kernel's local mode, on the card (its plain version with ``--device
cpu``).

    python -m stencilflow_tpu_torch.examples.outofcore_weather [--device cpu]
"""
import os
import tempfile

import numpy as np

import stencilflow_tpu_torch as sft
from stencilflow_tpu_torch.report import Report
from stencilflow_tpu_torch.synthesize import synthesize_stencil

SIZE = (16, 32, 32)      # raise to (2048, 4096, 4096) for a real domain
CHUNKS = 4
STEPS = 4
FUSE = 2                 # chain two hdiff applications per sweep


def main(device="cuda", size=SIZE, chunks: int = CHUNKS,
         steps: int = STEPS, fuse: int = FUSE):
    program = sft.parse_program(
        synthesize_stencil(num_stages=1, dimensions=size, shape="hdiff"),
        name="hdiff_outofcore")

    rep = Report.build(program)
    print(f"in-core footprint: {rep.hbm_footprint_bytes() / 2**20:.1f} "
          f"MiB; suggested host chunks on the {rep.hw.name} model: "
          f"{rep.suggested_host_chunks()}")

    with tempfile.TemporaryDirectory() as tmp:
        # the working set lives in memory-mapped files — neither device
        # memory NOR host RAM needs to hold a full field
        state = {}
        rng = np.random.default_rng(0)
        for name, spec in program.inputs.items():
            shape = spec.shape(program.dimensions)
            if not shape:
                state[name] = np.float32(0.025)
                continue
            mm = np.memmap(os.path.join(tmp, f"{name}.dat"),
                           dtype=np.float32, mode="w+", shape=shape)
            mm[:] = rng.random(shape, dtype=np.float32)
            mm.flush()
            state[name] = mm

        # one chunked sweep == one chain application; verify vs the oracle
        ref = sft.run_interpreter(program, state)
        compiled = sft.compile_chunked_chain(program, chunks, device=device)
        got = sft.run_chunked(program, state, chunks, compiled=compiled)
        out = program.outputs[0]
        np.testing.assert_allclose(got[out], np.asarray(ref[out]),
                                   rtol=2e-5, atol=1e-6)
        sweep = f"outofcore[{compiled[1].backend} x{chunks} chunks]"
        print(f"single sweep over {chunks} chunks ({sweep}) matches the "
              "oracle")

        # out-of-core time-stepping with temporal fusion: steps steps in
        # steps/fuse sweeps; checkpoint/resume works unchanged (npz)
        stats = {}
        final = sft.iterate(program, state, steps=steps, fuse=fuse,
                            host_chunks=chunks, device=device,
                            feed={"a": out},   # the diffused field feeds back
                            checkpoint_every=2,
                            checkpoint_dir=os.path.join(tmp, "ckpt"),
                            stats=stats)
        print(f"{steps} steps in {steps // fuse} sweeps "
              f"({stats['backend']}); final field mean = "
              f"{float(final['a'].mean()):.6f}")
        print("checkpoints:",
              sorted(os.listdir(os.path.join(tmp, "ckpt"))))
    return [sweep, stats["backend"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

"""Acoustic wave propagation + time-reversal refocusing (seismic).

Second-order-in-time leapfrog for the 2-D acoustic wave equation — the
model family spatial stencil pipelines are classically built for —
expressed as a two-time-level coupled chain and stepped with
``iterate``'s multi-entry feed:

    pn = 2 p - pm + r^2 lap(p)        (r = c dt/dx, stable for r <= 1/sqrt(2))

The discrete leapfrog map (p, pm) -> (pn, p) is exactly invertible by
the SAME chain with the two time levels swapped:

    2 p[t] - p[t+1] + r^2 lap(p[t]) = p[t-1]

so after T forward steps and T-1 steps on the swapped state the
wavefield refocuses onto the original source to floating-point
roundoff — the principle behind reverse-time migration, asserted
numerically here.  Rigid (constant-0) boundaries keep the map
invertible even after reflections.

Port of ``examples/wave_propagation.py``: ``iterate`` on ``device``.

    python -m stencilflow_tpu_torch.examples.wave_propagation [--device cpu]
"""
import numpy as np

import stencilflow_tpu_torch as sft

N, T, R2 = 96, 200, 0.4   # grid edge, forward steps, (c dt/dx)^2


def build_program(n=N, r2=R2):
    bc = {"p": {"type": "constant", "value": 0.0},
          "pm": {"type": "constant", "value": 0.0}}
    y, x = np.mgrid[:n, :n].astype(np.float32)
    p0 = np.exp(-((y - n / 3) ** 2 + (x - n / 2) ** 2) / 12.0
                ).astype(np.float32)
    return sft.parse_program({
        "inputs": {
            # zero initial velocity: both time levels start at the pulse
            "p": {"data": p0, "data_type": "float32"},
            "pm": {"data": p0.copy(), "data_type": "float32"},
        },
        "outputs": ["pn", "pcur"],
        "dimensions": [n, n],
        "program": {
            "pn": {"computation_string":
                   f"pn = 2.0 * p[j, k] - pm[j, k] + {r2} * "
                   "(p[j-1, k] + p[j+1, k] + p[j, k-1] + p[j, k+1]"
                   " - 4.0 * p[j, k])",
                   "boundary_conditions": bc, "data_type": "float32"},
            # carry the current level so feed can shift time: p->pm
            "pcur": {"computation_string": "pcur = p[j, k]",
                     "boundary_conditions": bc, "data_type": "float32"},
        },
    }, name="wave2d")


FEED = {"p": "pn", "pm": "pcur"}


def main(device="cuda", n: int = N, steps: int = T):
    program = build_program(n)
    inputs = sft.load_input_arrays(program)
    p0 = np.asarray(inputs["p"])

    # forward T steps (temporal fusion: 4 leapfrog updates per compiled
    # chain — one read + one write of each field per 4 steps)
    fwd_stats, rec_stats = {}, {}
    fwd = sft.iterate(program, inputs, steps=steps, feed=FEED, fuse=4,
                      device=device, stats=fwd_stats)
    p_T, p_Tm1 = np.asarray(fwd["p"]), np.asarray(fwd["pm"])
    spread = float(np.abs(p_T).max())
    print(f"after {steps} forward steps ({fwd_stats['backend']}): max|p| "
          f"= {spread:.4f} (pulse dispersed + reflected)")

    # time reversal: swap the two levels, step T-1 times -> p[0]
    rec = sft.iterate(program, {"p": p_Tm1, "pm": p_T},
                      steps=steps - 1, feed=FEED, fuse=1,
                      device=device, stats=rec_stats)
    p_rec = np.asarray(rec["p"])

    err = float(np.abs(p_rec - p0).max())
    corr = float(np.corrcoef(p_rec.ravel(), p0.ravel())[0, 1])
    print(f"refocused after {steps - 1} reversed steps "
          f"({rec_stats['backend']}): max|err| = {err:.2e}, "
          f"correlation {corr:.6f}")
    assert corr > 0.999 and err < 1e-2, (err, corr)
    print("OK — leapfrog time reversal is exact to roundoff")
    return [fwd_stats["backend"], rec_stats["backend"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

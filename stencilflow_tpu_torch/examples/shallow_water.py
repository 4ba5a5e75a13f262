"""Linearized shallow-water equations: a coupled multi-field system.

Demonstrates what single-output demos don't: one chain producing THREE
outputs (h, u, v updates read each other), and ``iterate`` with a
multi-entry ``feed`` stepping all three fields at once — with temporal
fusion composing the whole coupled system across time steps.

Lax-Friedrichs update (stable for c·dt/dx < 1):

    h' = avg4(h) - 0.5 r H ((u_E - u_W) + (v_N - v_S))
    u' = avg4(u) - 0.5 r g (h_E - h_W)
    v' = avg4(v) - 0.5 r g (h_N - h_S)

Port of ``examples/shallow_water.py``: ``iterate`` on ``device``.

    python -m stencilflow_tpu_torch.examples.shallow_water [--device cpu]
"""
import numpy as np

import stencilflow_tpu_torch as sft

N = 64
G, H, R = 9.81, 10.0, 0.01   # gravity, depth, dt/dx


def build_program(n: int = N):
    def avg4(f):
        return (f"0.25 * ({f}[j-1, k] + {f}[j+1, k] + "
                f"{f}[j, k-1] + {f}[j, k+1])")

    bc = {t: {"type": "constant", "value": 0.0} for t in ("h", "u", "v")}
    rng = np.random.default_rng(0)
    h0 = np.exp(-(((np.arange(n) - n / 2)[:, None]) ** 2 +
                  ((np.arange(n) - n / 2)[None, :]) ** 2) / 50.0)
    h0 = (h0 + 0.01 * rng.random((n, n))).astype(np.float32)
    zeros = np.zeros((n, n), np.float32)
    return sft.parse_program({
        "inputs": {
            "h": {"data": h0, "data_type": "float32"},
            "u": {"data": zeros, "data_type": "float32"},
            "v": {"data": zeros, "data_type": "float32"},
        },
        "outputs": ["h1", "u1", "v1"],
        "dimensions": [n, n],
        "program": {
            "h1": {"computation_string":
                   f"h1 = {avg4('h')} - {0.5 * R * H} * "
                   f"((u[j+1, k] - u[j-1, k]) + (v[j, k+1] - v[j, k-1]))",
                   "boundary_conditions": bc, "data_type": "float32"},
            "u1": {"computation_string":
                   f"u1 = {avg4('u')} - {0.5 * R * G} * "
                   f"(h[j+1, k] - h[j-1, k])",
                   "boundary_conditions": bc, "data_type": "float32"},
            "v1": {"computation_string":
                   f"v1 = {avg4('v')} - {0.5 * R * G} * "
                   f"(h[j, k+1] - h[j, k-1])",
                   "boundary_conditions": bc, "data_type": "float32"},
        },
    }, name="shallow_water")


def main(device="cuda", n: int = N, steps: int = 200):
    program = build_program(n)
    inputs = sft.load_input_arrays(program)
    feed = {"h": "h1", "u": "u1", "v": "v1"}

    stats = {}
    state = sft.iterate(program, inputs, steps=steps, feed=feed, fuse=4,
                        device=device, stats=stats)
    h = np.asarray(state["h"])
    energy = float((h ** 2).sum() + (np.asarray(state["u"]) ** 2).sum()
                   + (np.asarray(state["v"]) ** 2).sum())
    print(f"after {steps} steps (fuse=4, {stats['backend']}): "
          f"energy={energy:.4f}  h range [{h.min():.4f}, {h.max():.4f}]")

    # cross-check the fused run against plain stepping via the oracle
    ref = {k: np.asarray(v) for k, v in inputs.items()}
    for _ in range(steps):
        out = sft.run_interpreter(program,
                                  {**inputs, **{k: ref[k] for k in feed}})
        ref = {k: np.asarray(out[o]) for k, o in feed.items()}
    np.testing.assert_allclose(h, ref["h"], rtol=1e-4, atol=1e-5)
    print(f"matches {steps} oracle steps")
    return [stats["backend"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

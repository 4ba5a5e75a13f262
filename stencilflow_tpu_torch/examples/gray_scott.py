"""Gray–Scott reaction–diffusion: a NONLINEAR coupled two-field system.

Complements the linear demos (shallow_water, wave_propagation): the
reaction term ``u*v*v`` is a product of *different* fields, so the chain
is genuinely nonlinear — it exercises the expression frontend beyond
affine stencils, ``copy`` boundary conditions as zero-flux (Neumann)
walls, and ``iterate``'s multi-entry feed with temporal fusion on a
system whose dynamics amplify any engine mismatch exponentially.

Forward-Euler update on a 2-D grid (lap = 5-point Laplacian):

    u' = u + Du·lap(u) - u·v² + F·(1 - u)
    v' = v + Dv·lap(v) + u·v² - (F + K)·v

With the classic parameters below (F=0.0545, K=0.062) a centered square
seed of v grows into spot/stripe patterns ("mitosis" regime).

Port of ``examples/gray_scott.py``: ``iterate`` on ``device``.

    python -m stencilflow_tpu_torch.examples.gray_scott [--device cpu]
"""
import numpy as np

import stencilflow_tpu_torch as sft

N = 96
DU, DV = 0.16, 0.08       # diffusion rates (dt/dx² folded in)
F, K = 0.0545, 0.062      # feed / kill rates


def build_program(n: int = N):
    def lap(f):
        return (f"({f}[j-1, k] + {f}[j+1, k] + {f}[j, k-1] + "
                f"{f}[j, k+1] - 4.0 * {f}[j, k])")

    # copy BC = edge clamp = zero normal derivative: no-flux walls, the
    # physically correct closure for a sealed reactor
    bc = {t: {"type": "copy"} for t in ("u", "v")}
    rng = np.random.default_rng(7)
    u0 = np.ones((n, n), np.float32)
    v0 = np.zeros((n, n), np.float32)
    s = slice(n // 2 - n // 12, n // 2 + n // 12)
    u0[s, s] = 0.50
    v0[s, s] = 0.25
    u0 += (0.02 * rng.random((n, n))).astype(np.float32)
    return sft.parse_program({
        "inputs": {
            "u": {"data": u0, "data_type": "float32"},
            "v": {"data": v0, "data_type": "float32"},
        },
        "outputs": ["u1", "v1"],
        "dimensions": [n, n],
        "program": {
            "u1": {"computation_string":
                   f"u1 = u[j, k] + {DU} * {lap('u')} "
                   f"- u[j, k] * v[j, k] * v[j, k] "
                   f"+ {F} * (1.0 - u[j, k])",
                   "boundary_conditions": bc, "data_type": "float32"},
            "v1": {"computation_string":
                   f"v1 = v[j, k] + {DV} * {lap('v')} "
                   f"+ u[j, k] * v[j, k] * v[j, k] "
                   f"- {F + K} * v[j, k]",
                   "boundary_conditions": bc, "data_type": "float32"},
        },
    }, name="gray_scott")


def main(device="cuda", n: int = N, steps: int = 400):
    program = build_program(n)
    inputs = sft.load_input_arrays(program)
    feed = {"u": "u1", "v": "v1"}

    stats = {}
    state = sft.iterate(program, inputs, steps=steps, feed=feed, fuse=4,
                        device=device, stats=stats)
    u = np.asarray(state["u"])
    v = np.asarray(state["v"])
    # the reaction keeps both concentrations in [0, 1]; the v seed must
    # have spread well beyond its initial square (pattern formation)
    active = float((v > 0.1).mean())
    print(f"after {steps} steps (fuse=4, {stats['backend']}): u range "
          f"[{u.min():.4f}, {u.max():.4f}]  v range "
          f"[{v.min():.4f}, {v.max():.4f}]  active area {active:.1%}")
    assert 0.0 <= u.min() and u.max() <= 1.2 and v.max() <= 1.0
    assert active > (1 / 6) ** 2, "v never spread beyond the seed square"

    # cross-check the fused run against plain oracle stepping
    ref = {k: np.asarray(x) for k, x in inputs.items()}
    for _ in range(steps):
        out = sft.run_interpreter(program, ref)
        ref = {k: np.asarray(out[o]) for k, o in feed.items()}
    np.testing.assert_allclose(u, ref["u"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v, ref["v"], rtol=1e-4, atol=1e-5)
    print(f"matches {steps} oracle steps")
    return [stats["backend"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))

"""Implicit (backward-Euler) diffusion: stable far beyond the explicit limit.

Explicit 2-D diffusion requires ``dt <= dx²/4``; backward Euler
``(I - dt·L) x⁺ = x`` is unconditionally stable but needs a solve per
step.  ``sft.make_solver`` compiles the chain once as a matrix-free CG
operator (the operator's kernel on the card, CG's vectors there too) —
here one step at 40x the explicit limit, where the explicit scheme
detonates.

Port of ``examples/implicit_diffusion.py``: ``make_solver`` on
``device``.

    python -m stencilflow_tpu_torch.examples.implicit_diffusion [--device cpu]
"""
import numpy as np

import stencilflow_tpu_torch as sft

N, DT = 96, 10.0      # dx = 1: explicit limit is dt = 0.25


def main(device="cuda", n: int = N):
    implicit = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [n, n],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] - {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="be_diffusion")

    explicit = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [n, n],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] + {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="fe_diffusion")

    y, x = np.mgrid[:n, :n]
    state = (np.exp(-((y - n / 2) ** 2 + (x - n / 2) ** 2) / 40.0)
             + 1e-3 * np.random.default_rng(0).random((n, n))
             ).astype(np.float32)   # noise seeds the unstable modes

    solver = sft.make_solver(implicit, tol=1e-6, device=device)
    s_im = state
    for step in range(5):
        s_im, info = solver(s_im)
    s_im = s_im.cpu().numpy()
    print(f"implicit, dt=40x explicit limit, 5 steps "
          f"({solver.lowering['operator']}): max={s_im.max():.4f} "
          f"(CG {info['iterations']} iters/step, residual "
          f"{info['residual']:.1e})")

    s_ex = state
    for step in range(5):
        s_ex = np.asarray(
            sft.run_interpreter(explicit, {"x": s_ex})["y"])
    print(f"explicit at the same dt: max={np.abs(s_ex).max():.3e} "
          "(unstable, as the CFL bound predicts)")

    assert np.isfinite(s_im).all() and s_im.max() < state.max()
    assert np.abs(s_ex).max() > 1e3
    print("OK")
    return [solver.lowering["operator"]]


if __name__ == "__main__":
    from stencilflow_tpu_torch.examples import device_from_argv
    main(device_from_argv(__doc__))
